"""The port's ``decode_asr`` pipeline against the JAX one on the CPU: with
the same ``.npz`` ASR and tiny-LM checkpoints, on a relocated copy of the
committed dev corpus, a static beam run and a ``--continuous
--conversation`` run write the same ``hyp.text`` and the same ``wer.json``
(all but the wall-clock RTFx); ``--continuous`` gives the static
hypotheses; the pipeline needs a GPU unless ``--device cpu`` is given and,
as JAX's, refuses ``--data_parallel`` with ``--continuous``."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from loco_asr_tpu.models.gpt2 import model as jg
from loco_asr_tpu.models.speecht5 import model as jm
from loco_asr_tpu.models.speecht5.config import tiny_config as jtiny
from loco_asr_tpu.pipelines import decode_asr as jdecode
from loco_asr_tpu.utils.checkpoint import save_npz
from loco_asr_tpu_torch.pipelines import decode_asr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "exp", "loco", "asr_corpus", "dev")
COMMON = ["--tiny", "--max_decode_len", "12", "--max_seconds", "1", "--batch_size", "4",
          "--limit_batches", "2", "--lm_weight", "0.5"]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """The relocated dev corpus (its wav.scp points at this checkout's wav
    files) and seeded ASR and LM checkpoints of the JAX package."""
    root = tmp_path_factory.mktemp("decode")
    dev = root / "dev"
    dev.mkdir()
    for name in ("text", "segments"):
        (dev / name).write_bytes(open(os.path.join(CORPUS, name), "rb").read())
    with open(os.path.join(CORPUS, "wav.scp")) as f, open(dev / "wav.scp", "w") as out:
        for line in f:
            key, path = line.split(None, 1)
            out.write(f"{key} {os.path.join(CORPUS, 'wav', os.path.basename(path.strip()))}\n")
    asr = str(root / "asr.npz")
    save_npz(asr, jm.asr_init(jax.random.PRNGKey(5),
                              jtiny(vocab_size=256, apply_spec_augment=False)))
    lm = str(root / "lm.npz")
    save_npz(lm, jg.gpt2_init(jax.random.PRNGKey(3), jg.tiny_gpt2_config(
        vocab_size=256, n_embd=32, n_head=4, n_positions=128)))
    return dict(root=root, data=str(dev), flags=COMMON + ["--checkpoint", asr,
                                                          "--lm_checkpoint", lm])


def _run(main, assets, name, extra):
    out = str(assets["root"] / name)
    assert main(["--data_dir", assets["data"], "--out_dir", out, *assets["flags"],
                 *extra]) == 0
    with open(os.path.join(out, "hyp.text")) as f:
        lines = f.read().splitlines()
    with open(os.path.join(out, "wer.json")) as f:
        details = json.load(f)
    assert os.path.exists(os.path.join(out, "metrics.jsonl"))
    return lines, details


def _same_outputs(port, jax_run):
    (lines, details), (jlines, jdetails) = port, jax_run
    assert len(lines) == 8
    assert lines == jlines
    assert details.keys() == jdetails.keys()
    for key in details:
        if key != "rtfx":
            assert details[key] == jdetails[key], key
    assert np.isfinite(details["wer"]) and details["rtfx"] > 0


@pytest.mark.parametrize("mode", ["static_beam", "conversation_beam"])
def test_decode_asr_matches_jax(assets, mode):
    extra = (["--beam_size", "3"] if mode == "static_beam"
             else ["--continuous", "--conversation", "--beam_size", "2"])
    port = _run(decode_asr.main, assets, f"port_{mode}", [*extra, "--device", "cpu"])
    _same_outputs(port, _run(jdecode.main, assets, f"jax_{mode}", extra))


def test_continuous_greedy_equals_static_greedy(assets):
    """Utterances of <= 1 s padded to one 1 s bucket in both modes, so that
    each encodes the same input."""
    static = _run(decode_asr.main, assets, "static1", ["--beam_size", "1", "--device", "cpu"])
    cont = _run(decode_asr.main, assets, "cont1",
                ["--continuous", "--beam_size", "1", "--device", "cpu"])
    assert static == (cont[0], {**cont[1], "rtfx": static[1]["rtfx"]})


def test_decode_asr_needs_a_gpu_and_refuses_data_parallel(assets, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(decode_asr.main, assets, "nogpu", [])
    with pytest.raises(SystemExit, match="mutually exclusive"):   # JAX's refusal
        _run(decode_asr.main, assets, "dp", ["--data_parallel", "2", "--continuous",
                                             "--device", "cpu"])
    with pytest.raises(SystemExit, match="requires --continuous"):
        _run(decode_asr.main, assets, "conv", ["--conversation", "--device", "cpu"])
