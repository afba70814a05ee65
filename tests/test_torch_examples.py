"""The port's examples (``loco_asr_tpu_torch/examples/01-04``) at ``--tiny
--device cpu``: each prints the lines the JAX script of the same number
prints (the same labels in the same order; shapes where random weights do
not set them, and 04's leaf count), and 02's PCA and KMeans equal the JAX
script's helpers on the same input."""

import contextlib
import importlib
import importlib.util
import io
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# each JAX script's output at --tiny, its numbers masked (a run of the
# scripts in examples/ on the CPU)
EXPECTED = {
    "01_speecht5_demo": [r"ASR beam tokens: \[[\d ]+\]", r"TTS mel: \(1, 20, 8\) frames: \d+",
                         r"Vocoder waveform: \(1, \d+\)", r"VC mel: \(1, 8, 8\)"],
    "02_shared_embedding_space": [
        r"speech x text cosine similarity matrix:", *[r"\s*\[*\[[-\d. e]+\]\]?"] * 4,
        r"per-frame PCA: speech \(6396, 3\), text \(20, 3\); speech PC1 var [\d.]+, "
        r"text PC1 var [\d.]+",
        r"pooled PCA coordinates \(first 4 rows = speech, last 4 = text\):",
        *[r"\s*\[*\[[-\d. e]+\]\]?"] * 8,
        r"kmeans\(k=2\) over pooled space: assignments \[[01, ]+\], modality purity [\d.]+ "
        r"\(1.0 = clusters are the modalities, i.e. NOT a shared space\)"],
    "03_slurp_embeddings": [r"dataset: 8 utterances, 3 intents",
                            r"  slurp_id=0 frames=639 intent=alarm_set \(class 3\)",
                            r"  slurp_id=1 frames=639 intent=play_music \(class 66\)",
                            r"  slurp_id=2 frames=639 intent=weather_query \(class 98\)",
                            r"  slurp_id=3 frames=639 intent=alarm_set \(class 3\)"],
    "04_checkpoint_mapping": [r"HF import: strict key\+shape match, 101 leaves",
                              r"fairseq encoder import: strict key\+shape match, \d+ leaves"],
}


def run_example(name: str, *argv: str) -> list:
    module = importlib.import_module(f"loco_asr_tpu_torch.examples.{name}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert module.main(["--tiny", *argv]) == 0
    return out.getvalue().splitlines()


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_example_prints_the_jax_scripts_lines(name):
    lines = run_example(name, "--device", "cpu")
    assert len(lines) == len(EXPECTED[name]), lines
    for line, pattern in zip(lines, EXPECTED[name]):
        assert re.fullmatch(pattern, line), (line, pattern)


def test_examples_need_a_gpu_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_example("01_speecht5_demo")


def _jax_example(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(ROOT, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_pca_and_kmeans_equal_the_jax_scripts():
    port = importlib.import_module("loco_asr_tpu_torch.examples.02_shared_embedding_space")
    jax_script = _jax_example("02_shared_embedding_space")
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.standard_normal((20, 16)) + 3, rng.standard_normal((25, 16)) - 3])
    np.testing.assert_array_equal(port.pca(x), jax_script.pca(x))
    np.testing.assert_array_equal(port.pca(x, 5), jax_script.pca(x, 5))
    for k, seed in ((2, 0), (3, 1), (4, 7)):
        a, ca = port.kmeans(x.copy(), k=k, seed=seed)
        b, cb = jax_script.kmeans(x.copy(), k=k, seed=seed)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ca, cb)
