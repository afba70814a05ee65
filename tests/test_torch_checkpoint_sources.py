"""``train_asr --checkpoint`` from HF and fairseq weights, and checkpoint
averaging, in the port against the JAX package on the CPU (tiny widths,
the full 7-layer conv stride, every dropout and SpecAugment off).

* HF ``.safetensors`` of a random ``transformers`` SpeechT5 ASR model: both
  trainers start from the same weights (the file covers the whole model);
  one step at lr 0 leaves them in the saved step, and that step's loss
  equals JAX's within 1e-5.
* fairseq ``speecht5_base.pt`` (the construction of
  ``tests/test_fairseq_import.py``): the file carries the encoder and its
  prenet, which both trainers graft over their own seeded init (the
  decoder's numbers differ between the packages' generators); the grafted
  leaves equal JAX's, and JAX's trainer started from the port's saved
  weights gives the port's first loss within 1e-5.
* ``average_checkpoints`` / ``average_last_k`` against JAX's on the same
  ``.npz`` directory: equal to float32 rounding, dtypes kept."""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax

from loco_asr_tpu.models.speecht5 import model as jm
from loco_asr_tpu.models.speecht5.config import SpeechT5Config as JConfig
from loco_asr_tpu.parallel import train as jtrain
from loco_asr_tpu.pipelines import common as jcommon
from loco_asr_tpu.pipelines import train_asr as jtrain_asr
from loco_asr_tpu.utils import checkpoint as jckpt
from loco_asr_tpu.utils.pytree import flatten_with_paths
from loco_asr_tpu_torch.models.speecht5.config import tiny_config
from loco_asr_tpu_torch.parallel import train as ttrain
from loco_asr_tpu_torch.pipelines import train_asr
from loco_asr_tpu_torch.utils import checkpoint as tckpt
from test_torch_import_torch import to_fairseq_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "exp", "loco", "asr_corpus", "dev")
OVER = dict(conv_dim=[16] * 7, conv_stride=[5, 2, 2, 2, 2, 2, 2],
            conv_kernel=[10, 3, 3, 3, 3, 2, 2], hidden_dropout=0.0, attention_dropout=0.0,
            activation_dropout=0.0, feat_proj_dropout=0.0, positional_dropout=0.0,
            apply_spec_augment=False)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg():
    return tiny_config(vocab_size=256, hidden_size=32, encoder_attention_heads=4,
                       decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64,
                       **{k: tuple(v) if isinstance(v, list) else v for k, v in OVER.items()})


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """The relocated dev corpus, the config overrides, an HF ``.safetensors``
    of a random tiny ``SpeechT5ForSpeechToText`` and a fairseq checkpoint."""
    from safetensors.torch import save_file
    from transformers import SpeechT5Config as HFConfig
    from transformers.models.speecht5.modeling_speecht5 import SpeechT5ForSpeechToText

    root = tmp_path_factory.mktemp("sources")
    dev = root / "dev"
    dev.mkdir()
    for name in ("text", "segments"):
        (dev / name).write_bytes(open(os.path.join(CORPUS, name), "rb").read())
    with open(os.path.join(CORPUS, "wav.scp")) as f, open(dev / "wav.scp", "w") as out:
        for line in f:
            key, path = line.split(None, 1)
            out.write(f"{key} {os.path.join(CORPUS, 'wav', os.path.basename(path.strip()))}\n")
    (root / "cfg.json").write_text(json.dumps(OVER))
    cfg = _cfg()
    hf_cfg = HFConfig(**{k: (list(v) if isinstance(v, tuple) else v)
                         for k, v in dataclasses.asdict(cfg).items()
                         if k in HFConfig().to_dict()},
                      encoder_layerdrop=0.0, decoder_layerdrop=0.0)
    torch.manual_seed(0)
    hf = SpeechT5ForSpeechToText(hf_cfg).eval()
    save_file({k: v.clone().contiguous() for k, v in hf.state_dict().items()},
              str(root / "asr.safetensors"))
    src = jm.asr_init(jax.random.PRNGKey(11), JConfig(**dataclasses.asdict(cfg)))
    state = to_fairseq_state(src)
    state["text_encoder_prenet.encoder_prenet.0.weight"] = torch.from_numpy(
        np.random.default_rng(4).standard_normal((256, 32)).astype(np.float32))
    torch.save({"model": state, "cfg": {}}, root / "speecht5_base.pt")
    return root, str(dev)


def _train(train_mod, pipeline, root, dev, name, checkpoint, port, monkeypatch):
    """One step at lr 0 from ``checkpoint`` -> (its loss, saved params).  The
    trainers log losses every 50 steps, so the step function is wrapped to
    keep the first step's."""
    losses = []
    make = train_mod.make_asr_train_step

    def recording(*args, **kw):
        step = make(*args, **kw)

        def wrapped(*a, **k):
            out = step(*a, **k)
            losses.append(float((out[-1] if isinstance(out, tuple) else out)["loss"]))
            return out
        return wrapped

    monkeypatch.setattr(train_mod, "make_asr_train_step", recording)
    out = root / name
    argv = ["--train_dir", dev, "--out_dir", str(out), "--tiny",
            "--config_json", str(root / "cfg.json"), "--batch_size", "4",
            "--conversation_seconds", "3", "--steps", "1", "--lr", "0",
            "--weight_decay", "0", "--warmup_steps", "0", "--mesh", "1,1,1",
            "--checkpoint", checkpoint]
    assert pipeline.main(argv + (["--device", "cpu"] if port else [])) == 0
    state = jckpt.Checkpointer(str(out / "ckpt"), use_orbax=not port).restore()
    return losses[0], {k: np.asarray(v, np.float32)
                       for k, v in flatten_with_paths(state["params"]).items()}


def test_train_asr_from_hf_safetensors_matches_jax(assets, monkeypatch):
    root, dev = assets
    path = str(root / "asr.safetensors")
    loss, params = _train(ttrain, train_asr, root, dev, "hf_port", path, True, monkeypatch)
    jloss, jparams = _train(jtrain, jtrain_asr, root, dev, "hf_jax", path, False, monkeypatch)
    assert sorted(params) == sorted(jparams)
    for key, want in jparams.items():
        np.testing.assert_array_equal(params[key], want, err_msg=key)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)


def test_train_asr_from_a_fairseq_checkpoint_matches_jax(assets, monkeypatch):
    from loco_asr_tpu.utils.checkpoint import save_npz

    root, dev = assets
    path = str(root / "speecht5_base.pt")
    loss, params = _train(ttrain, train_asr, root, dev, "fs_port", path, True, monkeypatch)
    grafted = {k: np.asarray(v, np.float32) for k, v in flatten_with_paths(
        jcommon.load_speecht5_params(path, "asr", JConfig(**dataclasses.asdict(_cfg())))).items()}
    enc = [k for k in grafted if k.startswith("encoder.")]
    assert len(enc) > 30
    for key in enc:
        np.testing.assert_array_equal(params[key], grafted[key], err_msg=key)
    save_npz(str(root / "fs_port_init.npz"), {k: v for k, v in params.items()})
    jloss, _ = _train(jtrain, jtrain_asr, root, dev, "fs_jax",
                      str(root / "fs_port_init.npz"), False, monkeypatch)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)


def test_checkpoint_averaging_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    shapes = {"a.kernel": (5, 3), "a.bias": (3,), "b.scale": (7,)}
    for step in (1, 2, 3, 4):
        tree = {"params": {k: (rng.standard_normal(s) * step).astype(np.float32)
                           for k, s in shapes.items()},
                "step": np.asarray(step)}
        tree["params"]["count"] = np.asarray(step, np.int32)
        tckpt.Checkpointer(str(tmp_path)).save(step, tckpt.unflatten(
            {f"params.{k}": v for k, v in tree["params"].items()} | {"step": tree["step"]}))
    ckpt = tckpt.Checkpointer(str(tmp_path))
    assert ckpt.steps() == [1, 2, 3, 4]
    jc = jckpt.Checkpointer(str(tmp_path), use_orbax=False)
    got = tckpt.flatten(tckpt.average_last_k(ckpt, k=3))
    want = flatten_with_paths(jckpt.average_last_k(jc, k=3))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert got[key].dtype == np.asarray(w).dtype, key
        np.testing.assert_array_equal(got[key], np.asarray(w), err_msg=key)
    states = [ckpt.restore(s)["params"] for s in (1, 4)]
    two = tckpt.flatten(tckpt.average_checkpoints(states))
    jtwo = flatten_with_paths(jckpt.average_checkpoints([jc.restore(s)["params"]
                                                         for s in (1, 4)]))
    for key, w in jtwo.items():
        np.testing.assert_array_equal(two[key], np.asarray(w), err_msg=key)
    assert tckpt.average_last_k(tckpt.Checkpointer(str(tmp_path / "empty"))) is None
    with pytest.raises(ValueError, match="no states"):
        tckpt.average_checkpoints([])
