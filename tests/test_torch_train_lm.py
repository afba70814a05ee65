"""The port's GPT-2 LM training (``parallel.train.make_lm_train_step``,
``pipelines/train_lm.py``, GPT-2 dropout and the checkpointed chunked loss,
``convert.to_jax_params``) against the JAX package on the CPU.

One train step on the same weights and batch (every dropout off, ragged
lengths), dense and flash attention x chunked and dense loss: loss to rtol
1e-5, every gradient and every parameter after one AdamW step to atol
1e-5.  Also: ``grad_accum``, inert padding, the flash ``attn_pdrop``
warning, the dropout sites' keep rates and scaling, the trainer's batches
against JAX's, and the CLI (checkpoints the JAX ``load_npz`` reads,
``--resume``, the refusals, the GPU default)."""

import dataclasses
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import optax

from loco_asr_tpu.models.gpt2 import model as jg
from loco_asr_tpu.parallel import mesh as jmesh
from loco_asr_tpu.parallel import train as jtrain
from loco_asr_tpu.pipelines import train_lm as jtrain_lm
from loco_asr_tpu.utils import checkpoint as jckpt
from loco_asr_tpu.utils.pytree import flatten_with_paths
from loco_asr_tpu_torch.models.gpt2 import convert
from loco_asr_tpu_torch.models.gpt2 import model as tg
from loco_asr_tpu_torch.ops import layers as tlayers
from loco_asr_tpu_torch.parallel import train as ttrain
from loco_asr_tpu_torch.pipelines import train_lm as ttrain_lm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_TEXT = os.path.join(ROOT, "exp", "loco", "lm_corpus", "dev.txt")
QUIET = dict(embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """A tiny GPT-2 with head dim 64 and two heads (kernel B6's route under
    flash), JAX weights, and a batch with ragged lengths (one row of 1
    token, which scores nothing)."""
    jcfg = jg.tiny_gpt2_config(vocab_size=61, n_positions=32, n_embd=128, n_layer=2,
                               n_head=2, **QUIET)
    params = jg.gpt2_init(jax.random.PRNGKey(0), jcfg)
    flat = {k: np.asarray(v) for k, v in flatten_with_paths(params).items()}
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 61, (4, 24)).astype(np.int32)
    lengths = np.asarray([24, 17, 1, 9], np.int32)
    return jcfg, params, flat, {"ids": ids, "lengths": lengths}


def _port_model(jcfg, flat):
    cfg = tg.GPT2Config(**jcfg.__dict__)
    model = tg.GPT2Model(cfg)
    model.load_state_dict(convert.from_jax_params(flat, cfg), strict=True)
    return model


def _tbatch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("loss_impl", ["chunked", "dense"])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_lm_train_step_matches_jax(setup, impl, loss_impl):
    jcfg, params, flat, batch = setup
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    # an identity optimizer returns params + grads: one compiled step gives
    # the gradients, and the JAX AdamW is applied to them
    jstep = jtrain.make_lm_train_step(jcfg, jmesh.make_mesh(data=1), optax.identity(),
                                      donate=False, attn_impl=impl, loss_impl=loss_impl)
    p_plus_g, _, jmet = jstep(params, (), jb, jax.random.PRNGKey(1))
    jgrads = jax.tree_util.tree_map(lambda a, b: a - b, p_plus_g, params)
    jtx = jtrain.adamw(1e-3)
    upd, _ = jtx.update(jgrads, jtx.init(params), params)
    jp2 = {k: np.asarray(v) for k, v in
           flatten_with_paths(optax.apply_updates(params, upd)).items()}
    jgrads = {k: np.asarray(v) for k, v in flatten_with_paths(jgrads).items()}

    model = _port_model(jcfg, flat)
    tx = ttrain.adamw(1e-3)
    opt = tx.init(dict(model.named_parameters()))
    step = ttrain.make_lm_train_step(model.cfg, tx, attn_impl=impl, loss_impl=loss_impl)
    met = step(model, opt, _tbatch(batch))

    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-5)
    assert int(met["ntokens"]) == int(jmet["ntokens"]) == 23 + 16 + 8
    for name, p in model.named_parameters():
        key = _jax_key(name)
        np.testing.assert_allclose(p.grad.numpy(), jgrads[key], atol=1e-5, rtol=0,
                                   err_msg=f"grad {key}")
    back = convert.to_jax_params(model)
    assert sorted(back) == sorted(jp2) == sorted(jgrads)
    for key, want in jp2.items():
        # Adam's first step is lr * g / (|g| + 1e-8): where the gradient is
        # rounding noise (the key biases', which the softmax cancels
        # exactly) it normalises the noise, so there each side need only
        # move by at most lr (+ weight decay)
        live = np.abs(jgrads[key]) >= 1e-6
        np.testing.assert_allclose(back[key][live], want[live], atol=1e-5, rtol=0,
                                   err_msg=f"param {key}")
        p0 = flat[key][~live]
        for moved in (back[key][~live], want[~live]):
            assert np.all(np.abs(moved - p0) <= 1e-3 * (1 + 0.01 * np.abs(p0)) + 1e-9), key
    n_dead = sum(int((np.abs(g) < 1e-6).sum()) for g in jgrads.values())
    assert n_dead <= 0.01 * sum(g.size for g in jgrads.values())


def _jax_key(name):
    parts = name.split(".")
    if parts[-1] == "weight" and parts[0] not in ("wte", "wpe"):
        parts[-1] = "scale" if parts[-2].startswith("ln_") else "kernel"
    return ".".join(parts)


def test_grad_accum_two_equals_full_batch(setup):
    jcfg, _, flat, batch = setup
    out = {}
    for accum in (1, 2):
        model = _port_model(jcfg, flat)
        tx = ttrain.adamw(1e-3)
        opt = tx.init(dict(model.named_parameters()))
        met = ttrain.make_lm_train_step(model.cfg, tx, grad_accum=accum)(
            model, opt, _tbatch(batch))
        out[accum] = (float(met["loss"]), int(met["ntokens"]),
                      {k: p.grad.clone() for k, p in model.named_parameters()})
    np.testing.assert_allclose(out[2][0], out[1][0], rtol=1e-6)
    assert out[2][1] == out[1][1]
    for k, g in out[1][2].items():
        np.testing.assert_allclose(out[2][2][k].numpy(), g.numpy(), atol=1e-7, rtol=1e-5,
                                   err_msg=k)
    with pytest.raises(ValueError, match="divisible"):
        ttrain.make_lm_train_step(model.cfg, ttrain.adamw(1e-3), grad_accum=3)(
            model, opt, _tbatch(batch))


def test_ragged_padding_is_inert(setup):
    """Tokens past a row's length change neither the loss nor any
    gradient (causality keeps them out of every scored position)."""
    jcfg, _, flat, batch = setup
    noisy = dict(batch, ids=batch["ids"].copy())
    for r, n in enumerate(batch["lengths"]):
        noisy["ids"][r, n:] = (noisy["ids"][r, n:] * 7 + 3) % 61
    assert not np.array_equal(noisy["ids"], batch["ids"])
    out = []
    for b in (batch, noisy):
        model = _port_model(jcfg, flat)
        tx = ttrain.adamw(1e-3)
        met = ttrain.make_lm_train_step(model.cfg, tx)(
            model, tx.init(dict(model.named_parameters())), _tbatch(b))
        out.append((float(met["loss"]), {k: p.grad.clone() for k, p in model.named_parameters()}))
    assert out[0][0] == out[1][0]
    for k, g in out[0][1].items():
        torch.testing.assert_close(out[1][1][k], g, rtol=0, atol=0, msg=k)


def test_flash_zeroes_attn_pdrop_with_the_jax_warning(setup):
    jcfg, _, flat, batch = setup
    model = _port_model(jcfg, flat)
    cfg = dataclasses.replace(model.cfg, attn_pdrop=0.1)
    tx = ttrain.adamw(1e-3)
    with pytest.warns(UserWarning, match=r"attn_pdrop=0.1 is zeroed"):
        step = ttrain.make_lm_train_step(cfg, tx, attn_impl="flash")
    with pytest.warns(UserWarning, match="zeroed"):
        jtrain.make_lm_train_step(jg.GPT2Config(**{**jcfg.__dict__, "attn_pdrop": 0.1}),
                                  jmesh.make_mesh(data=1), optax.identity(), attn_impl="flash")
    met = step(model, tx.init(dict(model.named_parameters())), _tbatch(batch),
               torch.Generator().manual_seed(0))
    assert math.isfinite(float(met["loss"])) and model.cfg.attn_pdrop == 0.0
    # the model itself still refuses flash with attention dropout in training
    model.cfg = cfg
    with pytest.raises(ValueError, match="attn_pdrop"):
        tg.gpt2_forward(model, torch.from_numpy(batch["ids"]), deterministic=False,
                        attn_impl="flash")
    with pytest.raises(ValueError, match="loss_impl"):
        ttrain.make_lm_train_step(cfg, tx, loss_impl="fused")


def test_dropout_identity_without_rate_or_generator(setup):
    jcfg, _, flat, batch = setup
    model = _port_model(jcfg, flat)
    ids = torch.from_numpy(batch["ids"])
    want, _ = tg.gpt2_forward(model, ids)
    got, _ = tg.gpt2_forward(model, ids, deterministic=False,
                             generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(got, want, rtol=0, atol=0)   # every rate 0
    model.cfg = dataclasses.replace(model.cfg, embd_pdrop=0.5, attn_pdrop=0.5,
                                    resid_pdrop=0.5)
    got, _ = tg.gpt2_forward(model, ids, deterministic=False)   # no generator
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_dropout_sites_keep_rate_and_scale(setup, monkeypatch):
    """embd_pdrop once after the tables, then per layer attn_pdrop on the
    dense probabilities and resid_pdrop on the attention and MLP outputs:
    each site keeps 1 - p of its entries (within 5 binomial standard
    deviations) and scales them by 1 / (1 - p)."""
    jcfg, _, flat, batch = setup
    model = _port_model(jcfg, flat)
    model.cfg = dataclasses.replace(model.cfg, embd_pdrop=0.1, attn_pdrop=0.25,
                                    resid_pdrop=0.4)
    calls = []
    real = tlayers.dropout

    def spy(x, p, generator, training):
        y = real(x, p, generator, training)
        calls.append((p, x.detach(), y.detach()))
        return y

    monkeypatch.setattr(tlayers, "dropout", spy)
    tg.gpt2_forward(model, torch.from_numpy(batch["ids"]), deterministic=False,
                    generator=torch.Generator().manual_seed(0))
    n_layer = model.cfg.n_layer
    assert [p for p, _, _ in calls] == [0.1] + [0.25, 0.4, 0.4] * n_layer
    for p, x, y in calls:
        live = x != 0
        kept = (y != 0) & live
        n = int(live.sum())
        rate = float(kept.sum()) / n
        assert abs(rate - (1 - p)) <= 5 * math.sqrt(p * (1 - p) / n), (p, rate, n)
        torch.testing.assert_close(y[kept], x[kept] / (1 - p))
        assert bool((y[~kept] == 0).all())


def test_checkpointed_chunks_equal_the_dense_loss():
    """Values and gradients (hidden states and the tied table) of the
    chunked head with recompute against ``token_nll`` of the full logits,
    with a ragged last chunk; the recompute keeps no [B, chunk, V] logits
    for the backward."""
    g = torch.Generator().manual_seed(0)
    b, t, d, v = 3, 23, 16, 50
    hidden = torch.randn(b, t, d, generator=g)
    w = torch.randn(v, d, generator=g) * 0.3
    ids = torch.randint(0, v, (b, t), generator=g)
    h1, w1 = hidden.clone().requires_grad_(), w.clone().requires_grad_()
    h2, w2 = hidden.clone().requires_grad_(), w.clone().requires_grad_()
    def saved_shapes(checkpoint_chunks):
        shapes = []

        def pack(x):
            shapes.append(tuple(x.shape))
            return x

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            out = tg.token_nll_from_hidden(w1, h1, ids, chunk=5,
                                           checkpoint_chunks=checkpoint_chunks)
        return out, shapes

    _, kept = saved_shapes(False)
    got, saved = saved_shapes(True)
    want = tg.token_nll(torch.matmul(h2, w2.t()), ids)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    gout = torch.randn(got.shape, generator=g)
    got.backward(gout)
    want.backward(gout)
    torch.testing.assert_close(h1.grad, h2.grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(w1.grad, w2.grad, rtol=1e-5, atol=1e-6)
    # autograd keeps a chunk's [B, chunk, V] logits without the recompute
    assert (b, 5, v) in kept and (b, 5, v) not in saved and (b, 2, v) not in saved
    with torch.no_grad():   # outside autograd nothing is recomputed
        torch.testing.assert_close(
            tg.token_nll_from_hidden(w, hidden, ids, chunk=5, checkpoint_chunks=True), want)


def test_stream_chunks_and_epoch_batches_equal_jax(tmp_path, monkeypatch):
    """``_stream_chunks`` and the trainer's batches of two epochs equal the
    JAX trainer's (recorded by a stand-in step), with ``--eos_id``."""
    from loco_asr_tpu.data import lm_datasets as jlm
    from loco_asr_tpu.data.tokenizer import load_tokenizer as jload
    from loco_asr_tpu_torch.data import lm_datasets as tlm
    from loco_asr_tpu_torch.data.tokenizer import load_tokenizer as tload

    text = tmp_path / "text"
    lines = open(LM_TEXT).read().splitlines()[:90]
    text.write_text("\n".join(lines) + "\n")
    jt, tt = jload("char"), tload("char")
    for tok in (jt, tt):
        tok.vocab_size, tok.eos_token_id = 256, 2
    jds = jlm.MaxLenTextDataset(str(text), jt, max_len=40)
    tds = tlm.MaxLenTextDataset(str(text), tt, max_len=40)
    for seed in (None, 3):
        want = jtrain_lm._stream_chunks(jds.rec_id2tokens, 40, 2, shuffle_seed=seed)
        got = ttrain_lm._stream_chunks(tds.rec_id2tokens, 40, 2, shuffle_seed=seed)
        assert len(got) == len(want) > 10
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)

    seen = []

    def recorder(*a, **kw):
        def step(params, opt_state, batch, rng):
            seen.append({k: np.asarray(v) for k, v in batch.items()})
            return params, opt_state, {"loss": jnp.float32(0.0), "grad_norm": jnp.float32(0.0)}
        return step

    monkeypatch.setattr(jtrain, "make_lm_train_step", recorder)
    monkeypatch.setattr(jckpt.Checkpointer, "save", lambda *a, **k: None)
    steps = len(list(ttrain_lm.epoch_batches(tds.rec_id2tokens, 40, 2, 8, 5, 0))) + 3
    assert jtrain_lm.main(["--train_file", str(text), "--out_dir", str(tmp_path / "j"),
                           "--model", "tiny", "--seq_len", "40", "--batch_size", "8",
                           "--steps", str(steps), "--eos_id", "2", "--seed", "5",
                           "--rng_impl", "threefry", "--log_every", "1000",
                           "--eval_every", "1000"]) == 0
    ours = [b for e in (0, 1) for b in ttrain_lm.epoch_batches(tds.rec_id2tokens, 40, 2,
                                                               8, 5, e)][:steps]
    assert len(seen) == len(ours) == steps
    for a, b in zip(ours, seen):
        # the JAX step's batch is padded to its mesh's data-parallel width
        # (rows of no token, as pad_rows does for grad_accum)
        for k in ("ids", "lengths"):
            np.testing.assert_array_equal(a[k], b[k][:len(a[k])])
            assert not b[k][len(a[k]):].any()


def _cli(out, *flags):
    return ttrain_lm.main(["--train_file", LM_TEXT, "--dev_file", LM_TEXT, "--out_dir",
                           str(out), "--model", "tiny", "--seq_len", "48",
                           "--batch_size", "8", "--log_every", "2", "--eval_every", "2",
                           "--device", "cpu", *flags])


def test_cli_checkpoint_reads_in_jax_and_resumes(tmp_path):
    out = tmp_path / "lm"
    assert _cli(out, "--steps", "4", "--save_every", "2", "--attn_impl", "flash",
                "--grad_accum", "3", "--tiny_n_embd", "16", "--tiny_n_head", "2") == 0
    ckpt = out / "ckpt"
    assert json.loads((ckpt / "status.json").read_text())["latest"] == 4
    with open(out / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert {"loss", "grad_norm", "steps_per_sec"} <= set(recs[0])
    assert any("dev_ppl" in r and "dev_tokens" in r for r in recs)
    state = jckpt.load_npz(str(ckpt / "step_4.npz"))
    jcfg = jg.tiny_gpt2_config(vocab_size=256, n_positions=64, n_embd=16, n_layer=2,
                               n_head=2)
    want = jg.gpt2_init(jax.random.PRNGKey(0), jcfg)
    assert (sorted(flatten_with_paths(state["params"]))
            == sorted(flatten_with_paths(want)))
    for k, v in flatten_with_paths(want).items():
        assert flatten_with_paths(state["params"])[k].shape == v.shape
    assert int(state["opt_state"]["count"]) == 4
    assert _cli(out, "--steps", "6", "--save_every", "100", "--resume",
                "--tiny_n_embd", "16", "--tiny_n_head", "2") == 0
    assert json.loads((ckpt / "status.json").read_text())["latest"] == 6
    resumed = jckpt.load_npz(str(ckpt / "step_6.npz"))
    assert int(resumed["opt_state"]["count"]) == 6


@pytest.mark.parametrize("flags", [["--optimizer", "adafactor"],
                                   ["--opt_mu_dtype", "bfloat16"],
                                   ["--compute_dtype", "bfloat16"],
                                   ["--remat"], ["--nan_recovery"],
                                   ["--nan_inject_step", "3"], ["--mesh", "2,1,1"],
                                   ["--attn_impl", "ring"], ["--attn_impl", "ulysses"],
                                   ["--sp_devices", "2"]])
def test_cli_refuses_unported_flags(flags, tmp_path):
    with pytest.raises(SystemExit, match="not supported by this package yet: "
                                         + flags[0].split()[0]):
        _cli(tmp_path, "--steps", "1", *flags)


def test_cli_needs_a_gpu_unless_asked_for_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain_lm.main(["--train_file", LM_TEXT, "--out_dir", str(tmp_path), "--model",
                        "tiny", "--steps", "1"])
    assert _cli(tmp_path, "--steps", "1", "--rng_impl", "threefry") == 0


def test_to_jax_params_inverts_from_jax_params():
    jcfg = jg.tiny_gpt2_config(n_layer=3)
    params = jg.gpt2_init(jax.random.PRNGKey(7), jcfg)
    flat = {k: np.asarray(v) for k, v in flatten_with_paths(params).items()}
    back = convert.to_jax_params(_port_model(jcfg, flat))
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], v)
