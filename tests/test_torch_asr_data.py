"""The port's ASR data, checkpoint, decoding and training pipeline against
the JAX package: ``KaldiAsrDataset`` / ``ConversationAsrDataset`` batches
equal the JAX ones for the same seed on the committed dev corpus; the JAX
``Checkpointer(use_orbax=False)`` reads the port's checkpoints; greedy
decoding gives JAX's tokens at ``tiny_config``; SpecAugment spans obey
the count, min-mask and length rules; ``train_asr`` runs on the CPU with
save and ``--resume``, runs its mixed-precision flags as JAX's CLI does,
refuses what is not ported and needs a GPU unless ``--device cpu`` is
given."""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from loco_asr_tpu.data import asr_dataset as jds
from loco_asr_tpu.data.tokenizer import load_tokenizer as jtok
from loco_asr_tpu.decode.beam import greedy_decode as jgreedy
from loco_asr_tpu.models.speecht5 import model as jm
from loco_asr_tpu.models.speecht5.config import SpeechT5Config as JConfig
from loco_asr_tpu.utils.checkpoint import Checkpointer as JCheckpointer
from loco_asr_tpu.utils.pytree import assert_trees_match, flatten_with_paths
from loco_asr_tpu_torch.data import asr_dataset as tds
from loco_asr_tpu_torch.data.tokenizer import load_tokenizer as ttok
from loco_asr_tpu_torch.decode.beam import greedy_decode as tgreedy
from loco_asr_tpu_torch.models.speecht5 import convert
from loco_asr_tpu_torch.models.speecht5 import model as tm
from loco_asr_tpu_torch.models.speecht5.config import tiny_config
from loco_asr_tpu_torch.ops.audio import compute_mask_indices
from loco_asr_tpu_torch.pipelines import train_asr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "exp", "loco", "asr_corpus")
# the tiny config with the full 7-layer conv stride (320x), so that seconds
# of corpus audio give a few hundred frames
CONV = dict(conv_dim=[16] * 7, conv_stride=[5, 2, 2, 2, 2, 2, 2],
            conv_kernel=[10, 3, 3, 3, 3, 2, 2])


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _relocated(tmp_path, split):
    """A copy of the committed Kaldi dir whose wav.scp points at this
    checkout's wav files (the committed one holds absolute paths)."""
    src, dst = os.path.join(CORPUS, split), tmp_path / split
    dst.mkdir()
    for name in ("text", "segments"):
        (dst / name).write_bytes(open(os.path.join(src, name), "rb").read())
    with open(os.path.join(src, "wav.scp")) as f, open(dst / "wav.scp", "w") as out:
        for line in f:
            key, path = line.split(None, 1)
            out.write(f"{key} {os.path.join(src, 'wav', os.path.basename(path.strip()))}\n")
    return str(dst)


@pytest.fixture(scope="module")
def dev_dir(tmp_path_factory):
    return _relocated(tmp_path_factory.mktemp("corpus"), "dev")


def _same_batches(jbatches, tbatches):
    n = 0
    for jb, tb in zip(jbatches, tbatches, strict=True):
        assert jb.keys() == tb.keys()
        for k in jb:
            if isinstance(jb[k], np.ndarray):
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
            else:
                assert tb[k] == jb[k], k
        n += 1
    assert n > 1


@pytest.mark.parametrize("kind", ["utterances", "conversations"])
def test_batches_equal_jax(dev_dir, kind):
    kw = dict(max_label_len=96, shuffle=True, seed=3, eos_id=2)
    if kind == "utterances":
        j, t = jds.KaldiAsrDataset(dev_dir), tds.KaldiAsrDataset(dev_dir)
        kw["max_seconds"] = 1.5
    else:
        j = jds.ConversationAsrDataset(dev_dir, window_seconds=6)
        t = tds.ConversationAsrDataset(dev_dir, window_seconds=6)
        kw["max_seconds"] = 5
    assert len(j) == len(t)
    _same_batches(j.batches(jtok("char"), 4, **kw), t.batches(ttok("char"), 4, **kw))


def test_spec_augment_span_rules():
    b, t, span, prob, min_masks = 64, 400, 10, 0.05, 2
    lengths = torch.tensor([400, 300, 37, 12, 11] * 12 + [400] * 4)
    gen = torch.Generator().manual_seed(0)
    m = compute_mask_indices(gen, (b, t), prob, span, lengths, min_masks)
    assert m.shape == (b, t) and m.dtype == torch.bool
    for row, n in zip(m, lengths.tolist()):
        assert not row[n:].any()                    # inside the valid length
        most = max(int(prob * n / span + 1), min_masks) * span
        assert span <= int(row.sum()) <= min(most, n)
        # every span starts before len - span, so one lies wholly inside
        starts = torch.nonzero(row[1:] & ~row[:-1]).flatten().tolist()
        assert starts or row[0]


def test_jax_checkpointer_reads_the_port_checkpoint(tmp_path):
    cfg = tiny_config(**{k: tuple(v) for k, v in CONV.items()})
    model = tm.AsrModel(cfg)
    from loco_asr_tpu_torch.utils.checkpoint import Checkpointer
    Checkpointer(str(tmp_path)).save(3, {"params": convert.asr_to_jax_params(model),
                                         "step": np.asarray(3)})
    state = JCheckpointer(str(tmp_path), use_orbax=False).restore()
    want = jm.asr_init(jax.random.PRNGKey(0), JConfig(**dataclasses.asdict(cfg)))
    assert_trees_match(want, state["params"])
    flat = flatten_with_paths(state["params"])
    np.testing.assert_array_equal(flat["text_decoder_postnet.lm_head.kernel"],
                                  model.text_decoder_postnet.lm_head.weight.detach().t())
    assert int(state["step"]) == 3


def test_greedy_decode_matches_jax():
    cfg = tiny_config()
    jcfg = JConfig(**dataclasses.asdict(cfg))
    params = jm.asr_init(jax.random.PRNGKey(2), jcfg)
    flat = {k: np.asarray(v) for k, v in flatten_with_paths(params).items()}
    model = tm.AsrModel(cfg).eval()
    model.load_state_dict(convert.asr_from_jax_params(flat, cfg))
    rng = np.random.default_rng(1)
    enc = (rng.standard_normal((3, 17, cfg.hidden_size))).astype(np.float32)
    mask = np.ones((3, 17), np.int32)
    mask[2, 11:] = 0
    jt, jl = jax.jit(lambda e, m: jgreedy(params, jcfg, e, m, max_len=12))(
        jnp.asarray(enc), jnp.asarray(mask))
    tt, tl = tgreedy(model, torch.from_numpy(enc), torch.from_numpy(mask), max_len=12)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def _cli(dev_dir, out_dir, tmp_path, *extra):
    cfg_json = tmp_path / "conv.json"
    cfg_json.write_text(json.dumps(CONV))
    return ["--train_dir", dev_dir, "--dev_dir", dev_dir, "--out_dir", str(out_dir),
            "--tiny", "--config_json", str(cfg_json), "--device", "cpu",
            "--batch_size", "4", "--conversation_seconds", "3", "--attn_impl", "flash",
            "--eval_batches", "1", "--decode_max_len", "6", "--warmup_steps", "1",
            *extra]


def test_train_asr_pipeline_saves_and_resumes(dev_dir, tmp_path, capsys):
    out = tmp_path / "run"
    assert train_asr.main(_cli(dev_dir, out, tmp_path, "--steps", "2",
                               "--save_every", "2", "--eval_every", "2")) == 0
    ckpt = out / "ckpt"
    assert json.loads((ckpt / "status.json").read_text())["latest"] == 2
    with np.load(ckpt / "step_2.npz") as z:
        assert int(z["step"]) == 2 and int(z["opt_state.count"]) == 2
        assert any(k.startswith("opt_state.mu.decoder.") for k in z.files)
    lines = [json.loads(l) for l in (out / "metrics.jsonl").read_text().splitlines()]
    assert all(np.isfinite(r["dev_loss"]) and 0.0 <= r["dev_wer"] for r in lines)
    capsys.readouterr()
    # lr 0 and no decay: step 3 moves no parameter, so its params are
    # step 2's only if the resume restored them
    assert train_asr.main(_cli(dev_dir, out, tmp_path, "--steps", "3", "--resume",
                               "--save_every", "10", "--eval_every", "10",
                               "--lr", "0", "--weight_decay", "0")) == 0
    assert "resumed at step 2" in capsys.readouterr().err
    assert json.loads((ckpt / "status.json").read_text())["latest"] == 3
    with np.load(ckpt / "step_2.npz") as z2, np.load(ckpt / "step_3.npz") as z3:
        assert int(z3["opt_state.count"]) == 3
        params = [k for k in z2.files if k.startswith("params.")]
        assert len(params) > 50
        for k in params:
            np.testing.assert_array_equal(z3[k], z2[k], err_msg=k)


def test_train_asr_starts_from_a_jax_params_npz(dev_dir, tmp_path):
    """``--checkpoint`` takes the JAX ``save_npz`` of ``asr_init``'s params
    through the bridge: with lr 0 and no decay, the saved step holds them
    unchanged."""
    from loco_asr_tpu.utils.checkpoint import save_npz

    cfg = tiny_config(vocab_size=256, hidden_size=32, encoder_attention_heads=4,
                      decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64,
                      **{k: tuple(v) for k, v in CONV.items()})
    params = jm.asr_init(jax.random.PRNGKey(7), JConfig(**dataclasses.asdict(cfg)))
    save_npz(str(tmp_path / "init.npz"), params)
    out = tmp_path / "run"
    assert train_asr.main(_cli(dev_dir, out, tmp_path, "--steps", "1", "--lr", "0",
                               "--weight_decay", "0", "--eval_every", "5",
                               "--eval_batches", "0",
                               "--checkpoint", str(tmp_path / "init.npz"))) == 0
    with np.load(out / "ckpt" / "step_1.npz") as z:
        for key, want in flatten_with_paths(params).items():
            np.testing.assert_array_equal(z[f"params.{key}"], np.asarray(want), err_msg=key)


# each mixed-precision flag: (the params' atol port against JAX after two
# steps -- the JAX train-step test's 2e-4, or for bf16 weights one bf16
# spacing of the value, a rounding flip --, the share of entries held to
# it -- less for bf16 weights, whose Adam arithmetic XLA and PyTorch round
# at other points --, the checkpoint entries both store in bf16, and each
# leaf's limit on |port - JAX| over |JAX - init|, its two steps' movement:
# 7x and 2.3x the largest readings, 1.4e-3 in f32 compute and 0.098 / 0.109
# under bf16 compute / weights, where a wrong update to a leaf reads ~1)
PRECISION_FLAGS = {
    "--opt_mu_dtype": (2e-4, 0.99, ("opt_state.mu.",), 1e-2),
    "--dtype": (0.0, 0.98, ("params.", "opt_state.mu.", "opt_state.nu."), 0.25),
    "--compute_dtype": (2e-4, 0.99, (), 0.25),
}


@pytest.mark.parametrize("flag", sorted(PRECISION_FLAGS))
def test_train_asr_precision_flags_match_jax(flag, dev_dir, tmp_path):
    """``train_asr`` with a mixed-precision flag, port against JAX's CLI
    under the same flag, two steps from one JAX init with dropout and
    SpecAugment off (the batches are equal for one seed; no dev set: the
    JAX CLI's dev decode fails under ``--dtype bfloat16``, ROADMAP.md §C):
    the checkpoints hold the same entries in bf16, and the parameters
    agree."""
    from loco_asr_tpu.pipelines import train_asr as jtrain_asr
    from loco_asr_tpu.utils.checkpoint import save_npz

    atol, share, bf16_prefix, leaf_rel = PRECISION_FLAGS[flag]
    over = dict(CONV, hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                feat_proj_dropout=0.0, positional_dropout=0.0, apply_spec_augment=False)
    cfg = tiny_config(vocab_size=256, hidden_size=32, encoder_attention_heads=4,
                      decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64,
                      **{k: tuple(v) if isinstance(v, list) else v for k, v in over.items()})
    init = jm.asr_init(jax.random.PRNGKey(7), JConfig(**dataclasses.asdict(cfg)))
    save_npz(str(tmp_path / "init.npz"), init)
    init = {f"params.{k}": np.asarray(v, np.float32) for k, v in flatten_with_paths(init).items()}
    (tmp_path / "cfg.json").write_text(json.dumps(over))
    common = ["--train_dir", dev_dir, "--tiny", "--config_json", str(tmp_path / "cfg.json"),
              "--batch_size", "4", "--conversation_seconds", "3", "--attn_impl", "flash",
              "--warmup_steps", "1", "--lr", "1e-3", "--steps", "2", "--save_every", "2",
              "--eval_every", "10", "--checkpoint", str(tmp_path / "init.npz"),
              flag, "bfloat16"]
    assert jtrain_asr.main([*common, "--out_dir", str(tmp_path / "jax")]) == 0
    assert train_asr.main([*common, "--out_dir", str(tmp_path / "port"),
                           "--device", "cpu"]) == 0
    restored = JCheckpointer(str(tmp_path / "jax" / "ckpt")).restore()
    adam = restored["opt_state"][0]     # optax's ScaleByAdamState, as a dict
    want = {f"params.{k}": v for k, v in flatten_with_paths(restored["params"]).items()}
    want.update({f"opt_state.{m}.{k}": v for m in ("mu", "nu")
                 for k, v in flatten_with_paths(adam[m]).items()})
    with np.load(tmp_path / "port" / "ckpt" / "step_2.npz") as z:
        got = {k: z[k] for k in z.files}
    assert int(got["step"]) == int(restored["step"]) == 2
    # the port keys its moments by its own parameter names, JAX by its paths
    bf16 = lambda keys, d, is_bf16: sorted(k.split(".", 2)[1] if k.startswith("opt_state")
                                           else "params" for k in keys if is_bf16(d[k]))
    assert (bf16(got, got, lambda v: v.dtype == np.dtype("V2"))
            == bf16(want, want, lambda v: v.dtype == jnp.bfloat16))
    assert ({k for k, v in got.items() if v.dtype == np.dtype("V2")}
            == {k for k in got if k.startswith(bf16_prefix)})
    # ``share`` of the entries within the bound; every entry within what two
    # Adam steps of lr 1e-3 can move apart; and each leaf within
    # ``leaf_rel`` of its movement, but the attention key biases: their
    # exact gradient is 0 (the softmax cancels a per-query shift), so each
    # package steps them by the signs of its rounding noise, which JAX's
    # second moment shows: below 2^-8 of the same block's value bias's
    as_f32 = lambda k: np.asarray(want[k], np.float32)
    err, lim = [], []
    for key, w in want.items():
        if not key.startswith("params."):
            continue
        g, w = got[key], np.asarray(w, np.float32).ravel()
        if g.dtype == np.dtype("V2"):
            g = np.asarray(jnp.asarray(g.view(np.uint16)).view(jnp.bfloat16), np.float32)
            lim.append(np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126))) - 7))
        else:
            lim.append(np.full(w.shape, atol))
        err.append(np.abs(g.ravel() - w))
        if key.endswith("k_proj.bias"):
            nu = "opt_state.nu." + key[len("params."):]
            noise, signal = (np.sqrt(as_f32(n)).max() for n in (nu, nu.replace("k_proj", "v_proj")))
            assert noise <= 2.0 ** -8 * signal, (key, noise, signal)
            continue
        moved = np.linalg.norm(w - init[key].ravel())
        assert np.linalg.norm(err[-1]) <= leaf_rel * moved, (key, np.linalg.norm(err[-1]), moved)
    err, lim = np.concatenate(err), np.concatenate(lim)
    assert (err <= lim).mean() >= share, (err <= lim).mean()
    assert (err <= lim + 2 * 2 * 1e-3).all(), err.max()


@pytest.mark.parametrize("flags", [
    ["--mesh", "2,1,1", "--sp_devices", "2"], ["--attn_impl", "ring"],
    ["--attn_impl", "ulysses"], ["--sp_devices", "2"],
    ["--mesh", "1,2,1", "--attn_impl", "ring"]])
def test_unported_flags_are_refused(flags):
    """Sequence parallelism waits for ROADMAP A9 (a mesh trains sharded)."""
    with pytest.raises(SystemExit, match="not supported by this package yet"):
        train_asr.main(["--train_dir", "unused", "--device", "cpu", *flags])


def test_train_asr_needs_a_gpu_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_asr.main(["--train_dir", "unused", "--tiny"])
