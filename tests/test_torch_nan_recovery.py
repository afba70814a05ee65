"""``--nan_recovery`` / ``--nan_inject_step`` and ``--optimizer adafactor``
of the port's trainers against the JAX trainers' CLIs on the CPU, tiny
widths, from one JAX init, every dropout and SpecAugment off: ``train_asr``
(the injected step's waveform is NaN) and ``train_lm`` (the parameters
are multiplied by NaN), each with a checkpoint saved before the injected
step (the rollback restores it) and with none (the starting state is
restored).  The ``nan_rollback`` events and their steps equal JAX's
``metrics.jsonl``'s, and the final parameters equal JAX's within the
train-step tests' atol 2e-4 (rtol 2e-3), the entries that step by the
signs of rounding noise aside (the attention key biases, whose exact
gradient is 0: at most 1 % of the entries, each within the steps' lr of
the init on both sides).  Without ``--nan_recovery`` both runs carry the
NaN to the end."""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from loco_asr_tpu.models.gpt2 import model as jg
from loco_asr_tpu.models.speecht5 import model as jm
from loco_asr_tpu.models.speecht5.config import SpeechT5Config as JConfig
from loco_asr_tpu.pipelines import train_asr as jtrain_asr
from loco_asr_tpu.pipelines import train_lm as jtrain_lm
from loco_asr_tpu.utils.checkpoint import Checkpointer as JCheckpointer
from loco_asr_tpu.utils.checkpoint import save_npz
from loco_asr_tpu.utils.pytree import flatten_with_paths
from loco_asr_tpu_torch.models.gpt2 import model as tg
from loco_asr_tpu_torch.models.speecht5.config import tiny_config
from loco_asr_tpu_torch.pipelines import train_asr, train_lm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "exp", "loco", "asr_corpus", "dev")
LM_TEXT = os.path.join(ROOT, "exp", "loco", "lm_corpus", "dev.txt")
LR = 1e-3
QUIET_ASR = dict(conv_dim=[16] * 7, conv_stride=[5, 2, 2, 2, 2, 2, 2],
                 conv_kernel=[10, 3, 3, 3, 3, 2, 2], hidden_dropout=0.0,
                 attention_dropout=0.0, activation_dropout=0.0, feat_proj_dropout=0.0,
                 positional_dropout=0.0, apply_spec_augment=False)
QUIET_LM = dict(embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _quiet_tiny_lm(monkeypatch):
    """Both trainers' ``--model tiny`` without dropout (no flag sets it)."""
    for mod in (jg, tg):
        make = mod.tiny_gpt2_config
        monkeypatch.setattr(mod, "tiny_gpt2_config",
                            lambda _make=make, **kw: _make(**{**kw, **QUIET_LM}))


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """The relocated dev corpus, the ASR config overrides and the JAX inits
    of both models as ``.npz``."""
    root = tmp_path_factory.mktemp("nan")
    dev = root / "dev"
    dev.mkdir()
    for name in ("text", "segments"):
        (dev / name).write_bytes(open(os.path.join(CORPUS, name), "rb").read())
    with open(os.path.join(CORPUS, "wav.scp")) as f, open(dev / "wav.scp", "w") as out:
        for line in f:
            key, path = line.split(None, 1)
            out.write(f"{key} {os.path.join(CORPUS, 'wav', os.path.basename(path.strip()))}\n")
    (root / "cfg.json").write_text(json.dumps(QUIET_ASR))
    cfg = tiny_config(vocab_size=256, hidden_size=32, encoder_attention_heads=4,
                      decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64,
                      **{k: tuple(v) if isinstance(v, list) else v
                         for k, v in QUIET_ASR.items()})
    asr = jm.asr_init(jax.random.PRNGKey(7), JConfig(**dataclasses.asdict(cfg)))
    save_npz(str(root / "asr.npz"), asr)
    lm_cfg = jg.tiny_gpt2_config(vocab_size=256, n_positions=64, n_embd=32, n_layer=2,
                                 n_head=4)
    lm = jg.gpt2_init(jax.random.PRNGKey(3), lm_cfg)
    save_npz(str(root / "lm.npz"), lm)
    flat = lambda t: {k: np.asarray(v, np.float32) for k, v in flatten_with_paths(t).items()}
    return dict(root=root, dev=str(dev), asr=flat(asr), lm=flat(lm))


def _flags(kind, assets, save_every, extra):
    common = ["--steps", "4", "--save_every", str(save_every), "--eval_every", "10",
              "--mesh", "1,1,1",
              "--lr", str(LR), "--warmup_steps", "0", *extra]
    if kind == "asr":
        return ["--train_dir", assets["dev"], "--tiny", "--config_json",
                str(assets["root"] / "cfg.json"), "--batch_size", "4",
                "--conversation_seconds", "3", "--checkpoint", str(assets["root"] / "asr.npz"),
                *common]
    return ["--train_file", LM_TEXT, "--model", "tiny", "--seq_len", "64", "--batch_size", "4",
            "--log_every", "1", "--checkpoint", str(assets["root"] / "lm.npz"), *common]


def _run(kind, assets, name, save_every, extra):
    """Both packages' CLI -> {package: (metrics lines, final params)}."""
    out = {}
    for pkg, main in (("jax", {"asr": jtrain_asr, "lm": jtrain_lm}[kind].main),
                      ("port", {"asr": train_asr, "lm": train_lm}[kind].main)):
        out_dir = assets["root"] / f"{name}_{pkg}"
        argv = [*_flags(kind, assets, save_every, extra), "--out_dir", str(out_dir)]
        assert main(argv + (["--device", "cpu"] if pkg == "port" else [])) == 0
        log = out_dir / "metrics.jsonl"    # train_asr logs every 50 steps only
        lines = ([json.loads(l) for l in log.read_text().splitlines()]
                 if log.exists() else [])
        state = JCheckpointer(str(out_dir / "ckpt"), use_orbax=pkg == "jax").restore()
        assert int(state["step"]) == 4
        params = {k: np.asarray(v, np.float32)
                  for k, v in flatten_with_paths(state["params"]).items()}
        out[pkg] = (lines, params)
    return out


def _events(lines):
    return [(r["step"], r["event"]) for r in lines if "event" in r]


def _same_params(got, want, init, steps=4):
    assert sorted(got) == sorted(want)
    bad_total = size = 0
    for key, w in want.items():
        g = got[key]
        bad = ~np.isclose(g, w, atol=2e-4, rtol=2e-3)
        bad_total += int(bad.sum())
        size += w.size
        for side in (g[bad], w[bad]):
            assert np.all(np.abs(side - init[key][bad])
                          <= steps * LR * (1 + 0.01 * np.abs(init[key][bad])) + 1e-7), key
    assert bad_total <= 0.01 * size, bad_total


@pytest.mark.parametrize("saved", ["checkpoint", "no_checkpoint"])
@pytest.mark.parametrize("kind", ["asr", "lm"])
def test_nan_rollback_matches_jax(assets, kind, saved):
    """Injected at step 2; ``--save_every 1`` saves step 1 first, 10 saves
    nothing before the end.  The LM runs under adafactor."""
    extra = ["--nan_recovery", "--nan_inject_step", "2"]
    if kind == "lm":
        extra += ["--optimizer", "adafactor"]
    res = _run(kind, assets, f"{kind}_{saved}", 1 if saved == "checkpoint" else 10, extra)
    (jlines, jparams), (lines, params) = res["jax"], res["port"]
    assert _events(lines) == _events(jlines) == [(2, "nan_rollback")]
    if kind == "lm":
        losses = lambda ls: [(r["step"], r["loss"]) for r in ls if "loss" in r]
        assert [s for s, _ in losses(lines)] == [s for s, _ in losses(jlines)] == [1, 2, 3, 4]
        np.testing.assert_allclose([l for _, l in losses(lines)],
                                   [l for _, l in losses(jlines)], rtol=1e-4)
    for p in (params, jparams):
        assert all(np.isfinite(v).all() for v in p.values())
    _same_params(params, jparams, assets[kind])


@pytest.mark.parametrize("kind", ["asr", "lm"])
def test_without_recovery_the_nan_stays_as_in_jax(assets, kind):
    res = _run(kind, assets, f"{kind}_carry", 10, ["--nan_inject_step", "2"])
    (jlines, jparams), (lines, params) = res["jax"], res["port"]
    assert _events(lines) == _events(jlines) == []
    for key, want in jparams.items():
        np.testing.assert_array_equal(np.isnan(params[key]), np.isnan(want), err_msg=key)
    # every entry the poisoned step reached: all but those of no gradient
    # (the SpecAugment embedding, the embedding rows of tokens not seen)
    n_nan = sum(int(np.isnan(v).sum()) for v in params.values())
    assert n_nan >= 0.5 * sum(v.size for v in params.values())
