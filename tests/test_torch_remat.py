"""The port's rematerialization policies (``loco_asr_tpu_torch.ops.remat``)
are exact, as ``tests/test_remat_policies.py`` holds the JAX ones: with
dropout active, every policy gives the ``remat="none"`` loss and gradients
(loss rtol 1e-6, gradients rtol 1e-5 + atol 1e-6) for the SpeechT5 ASR
loss and GPT-2, under dense and flash attention (the kernels' plain
versions on the CPU); the train steps under "hybrid" make "none"'s update
(rtol 1e-3, atol 2e-5); the live generator ends where a "none" step
leaves it; "full", "dots" and "hybrid" run the encoder's attention again
in the backward and "lite" does not; with dropout off each policy gives
JAX's ``asr_loss(remat=spec)`` on the same weights (loss 1e-5, gradients
atol 1e-5 + rtol 1e-4, as ``tests/test_torch_train_asr.py``); and
``train_asr --remat lite`` and ``train_lm --remat hybrid`` run on the
CPU."""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from loco_asr_tpu.models.speecht5 import model as jm
from loco_asr_tpu.models.speecht5.config import SpeechT5Config as JConfig
from loco_asr_tpu.utils.pytree import flatten_with_paths
from loco_asr_tpu_torch.models.gpt2 import model as tg
from loco_asr_tpu_torch.models.speecht5 import convert
from loco_asr_tpu_torch.models.speecht5 import model as tm
from loco_asr_tpu_torch.models.speecht5.config import tiny_config
from loco_asr_tpu_torch.ops import remat
from loco_asr_tpu_torch.ops.cuda import flash_attention as fa
from loco_asr_tpu_torch.parallel import train as ttrain
from loco_asr_tpu_torch.pipelines import train_asr, train_lm

SPECS = ("full", "dots", "hybrid", "lite")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "exp", "loco", "asr_corpus")
LM_TEXT = os.path.join(ROOT, "exp", "loco", "lm_corpus", "dev.txt")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_canonicalize():
    assert remat.canonicalize(False) == "none"
    assert remat.canonicalize(None) == "none"
    assert remat.canonicalize(True) == "full"
    assert remat.canonicalize("Lite") == "lite"
    with pytest.raises(ValueError):
        remat.canonicalize("sometimes")


def _asr_cfg(impl):
    # dropout ON (tiny_config keeps the HF rates); flash has no
    # attention-prob dropout, as the train step zeroes it
    cfg = dataclasses.replace(tiny_config(), apply_spec_augment=False)
    assert cfg.hidden_dropout > 0 and cfg.activation_dropout > 0
    return cfg if impl == "dense" else dataclasses.replace(cfg, attention_dropout=0.0)


def _asr_batch(cfg):
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal((2, 1600)) * 0.1).astype(np.float32)
    mask = np.ones((2, 1600), np.int32)
    mask[1, 1200:] = 0
    labels = rng.integers(3, cfg.vocab_size, (2, 7))
    labels[1, 5:] = -100
    return {"input_values": torch.from_numpy(wav), "attention_mask": torch.from_numpy(mask),
            "labels": torch.from_numpy(labels)}


def _asr_value_grad(model, batch, impl, spec, seed=7):
    for p in model.parameters():
        p.grad = None
    gen = torch.Generator().manual_seed(seed)
    loss, _ = tm.asr_loss(model, batch["input_values"], batch["attention_mask"],
                          batch["labels"], attn_impl=impl, generator=gen, remat=spec)
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    return loss.item(), grads, gen.get_state()


def _same(l1, g1, l0, g0):
    np.testing.assert_allclose(l1, l0, rtol=1e-6, atol=1e-7)
    assert g1.keys() == g0.keys()
    for k in g0:
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("spec", SPECS)
def test_asr_grads_exact_under_policy_with_dropout(spec, impl):
    cfg = _asr_cfg(impl)
    model = tm.AsrModel(cfg, torch.Generator().manual_seed(0)).train()
    batch = _asr_batch(cfg)
    l0, g0, s0 = _asr_value_grad(model, batch, impl, "none")
    l1, g1, s1 = _asr_value_grad(model, batch, impl, spec)
    _same(l1, g1, l0, g0)
    # the recompute drew from a copy: the live generator is where "none" left it
    assert torch.equal(s1, s0)


@pytest.mark.parametrize("spec,recomputed", [("none", 0), ("full", 1), ("dots", 1),
                                             ("hybrid", 1), ("lite", 0)])
def test_flash_forward_runs_again_only_where_the_policy_recomputes(spec, recomputed,
                                                                   monkeypatch):
    """B1 (its plain version here) runs once per encoder layer and decoder
    cross-attention in the forward; "full", "dots" and "hybrid" run the
    encoder's once more in the backward (its output is not a product),
    "lite" keeps it."""
    cfg = _asr_cfg("flash")
    model = tm.AsrModel(cfg, torch.Generator().manual_seed(0)).train()
    calls = []
    real = fa.flash_rel_forward_plain

    def spy(*a, **k):
        calls.append(torch.is_grad_enabled())
        return real(*a, **k)

    monkeypatch.setattr(fa, "flash_rel_forward_plain", spy)
    _asr_value_grad(model, _asr_batch(cfg), "flash", spec)
    n_enc, n_dec = cfg.encoder_layers, cfg.decoder_layers
    assert len(calls) == n_enc + n_dec + recomputed * n_enc


def _gpt2(impl):
    cfg = tg.tiny_gpt2_config(n_positions=32, n_embd=16, n_head=2)
    assert cfg.attn_pdrop > 0 and cfg.resid_pdrop > 0
    if impl == "flash":
        cfg = dataclasses.replace(cfg, attn_pdrop=0.0)
    return tg.gpt2_init(cfg, seed=0, device="cpu")


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("spec", SPECS)
def test_gpt2_grads_exact_under_policy_with_dropout(spec, impl):
    model = _gpt2(impl)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, model.cfg.vocab_size, (2, 32)))

    def value_grad(spec):
        for p in model.parameters():
            p.grad = None
        gen = torch.Generator().manual_seed(3)
        logits, _ = tg.gpt2_logits(model, ids, deterministic=False, generator=gen,
                                   attn_impl=impl, remat=spec)
        loss = tg.token_nll(logits, ids).mean()
        loss.backward()
        return loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()}, \
            gen.get_state()

    l0, g0, s0 = value_grad("none")
    l1, g1, s1 = value_grad(spec)
    _same(l1, g1, l0, g0)
    assert torch.equal(s1, s0)


def _updates_equal(after_none, after_spec):
    # AdamW amplifies eps-dominated leaves by lr/eps (the JAX test's note):
    # only the update is held, at the JAX test's limits
    assert after_spec.keys() == after_none.keys()
    for k in after_none:
        np.testing.assert_allclose(after_spec[k].numpy(), after_none[k].numpy(),
                                   rtol=1e-3, atol=2e-5, err_msg=k)


def test_asr_train_step_under_hybrid_makes_none_s_update():
    cfg = _asr_cfg("flash")
    batch = _asr_batch(cfg)
    out, states = {}, {}
    for spec in ("none", "hybrid"):
        model = tm.AsrModel(cfg, torch.Generator().manual_seed(0))
        tx = ttrain.adamw(1e-3)
        opt = tx.init(ttrain.trainable_params(model))
        gen = torch.Generator().manual_seed(1)
        met = ttrain.make_asr_train_step(cfg, tx, attn_impl="flash", remat=spec)(
            model, opt, batch, gen)
        out[spec] = (float(met["loss"]), {k: p.detach().clone()
                                          for k, p in model.named_parameters()})
        states[spec] = gen.get_state()
    np.testing.assert_allclose(out["hybrid"][0], out["none"][0], rtol=1e-6, atol=1e-7)
    _updates_equal(out["none"][1], out["hybrid"][1])
    assert torch.equal(states["hybrid"], states["none"])


def test_lm_train_step_under_hybrid_makes_none_s_update():
    rng = np.random.default_rng(0)
    batch = {"ids": torch.from_numpy(rng.integers(0, 61, (2, 32))),
             "lengths": torch.tensor([32, 20], dtype=torch.int32)}
    out, states = {}, {}
    for spec in ("none", "hybrid"):
        model = _gpt2("dense")
        tx = ttrain.adamw(1e-3)
        opt = tx.init(dict(model.named_parameters()))
        gen = torch.Generator().manual_seed(1)
        met = ttrain.make_lm_train_step(model.cfg, tx, remat=spec)(model, opt, batch, gen)
        out[spec] = (float(met["loss"]), {k: p.detach().clone()
                                          for k, p in model.named_parameters()})
        states[spec] = gen.get_state()
    np.testing.assert_allclose(out["hybrid"][0], out["none"][0], rtol=1e-6, atol=1e-7)
    _updates_equal(out["none"][1], out["hybrid"][1])
    assert torch.equal(states["hybrid"], states["none"])


@pytest.fixture(scope="module")
def jax_setup():
    cfg = dataclasses.replace(
        tiny_config(), positional_dropout=0.0, hidden_dropout=0.0, attention_dropout=0.0,
        activation_dropout=0.0, feat_proj_dropout=0.0, apply_spec_augment=False)
    jcfg = JConfig(**dataclasses.asdict(cfg))
    params = jm.asr_init(jax.random.PRNGKey(0), jcfg)
    flat = {k: np.asarray(v) for k, v in flatten_with_paths(params).items()}
    return cfg, jcfg, params, flat, _asr_batch(cfg)


@pytest.mark.parametrize("spec", SPECS)
def test_policy_matches_jax_remat_without_dropout(jax_setup, spec):
    cfg, jcfg, params, flat, batch = jax_setup
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}

    def f(p):
        return jm.asr_loss(p, jcfg, jb["input_values"], jb["attention_mask"], jb["labels"],
                           deterministic=True, remat=spec, attn_impl="flash")[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(f))(params)
    jgrads = {k: np.asarray(v) for k, v in flatten_with_paths(jgrads).items()}
    model = tm.AsrModel(cfg)
    model.load_state_dict(convert.asr_from_jax_params(flat, cfg))
    model.train()
    loss, grads, _ = _asr_value_grad(model, batch, "flash", spec)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    names = convert.jax_names(model)
    for name, p in model.named_parameters():
        key, transpose = names[name]
        g = grads.get(name, torch.zeros_like(p))
        g = g.t() if transpose else g
        np.testing.assert_allclose(g.numpy(), jgrads[key], atol=1e-5, rtol=1e-4,
                                   err_msg=f"grad {key}")


def _relocated_dev(tmp_path):
    """The committed dev corpus with wav.scp pointing at this checkout."""
    src, dst = os.path.join(CORPUS, "dev"), tmp_path / "dev"
    dst.mkdir()
    for name in ("text", "segments"):
        (dst / name).write_bytes(open(os.path.join(src, name), "rb").read())
    with open(os.path.join(src, "wav.scp")) as f, open(dst / "wav.scp", "w") as out:
        for line in f:
            key, path = line.split(None, 1)
            out.write(f"{key} {os.path.join(src, 'wav', os.path.basename(path.strip()))}\n")
    return str(dst)


def test_train_asr_cli_runs_remat_lite(tmp_path):
    dev_dir = _relocated_dev(tmp_path)
    conv = tmp_path / "conv.json"
    conv.write_text(json.dumps(dict(conv_dim=[16] * 7, conv_stride=[5, 2, 2, 2, 2, 2, 2],
                                    conv_kernel=[10, 3, 3, 3, 3, 2, 2])))
    out = tmp_path / "run"
    assert train_asr.main(["--train_dir", dev_dir, "--dev_dir", dev_dir, "--out_dir", str(out),
                           "--tiny", "--config_json", str(conv), "--device", "cpu",
                           "--batch_size", "4", "--conversation_seconds", "3",
                           "--attn_impl", "flash", "--remat", "lite", "--steps", "2",
                           "--save_every", "2", "--eval_every", "2", "--eval_batches", "1",
                           "--decode_max_len", "6"]) == 0
    assert json.loads((out / "ckpt" / "status.json").read_text())["latest"] == 2
    lines = [json.loads(l) for l in (out / "metrics.jsonl").read_text().splitlines()]
    assert lines and all(np.isfinite(r["dev_loss"]) for r in lines)


def test_train_lm_cli_runs_remat_hybrid(tmp_path):
    out = tmp_path / "lm"
    assert train_lm.main(["--train_file", LM_TEXT, "--dev_file", LM_TEXT, "--out_dir", str(out),
                          "--model", "tiny", "--seq_len", "48", "--batch_size", "8",
                          "--log_every", "2", "--eval_every", "2", "--device", "cpu",
                          "--steps", "2", "--save_every", "2", "--remat", "hybrid",
                          "--tiny_n_embd", "16", "--tiny_n_head", "2"]) == 0
    with open(out / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert any("loss" in r and np.isfinite(r["loss"]) for r in recs)
    assert any("dev_ppl" in r and np.isfinite(r["dev_ppl"]) for r in recs)
