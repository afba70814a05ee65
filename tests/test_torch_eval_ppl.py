"""The port's eval_ppl pipeline against the JAX one: both score the same
text with the same ``.npz`` weights (``--device cpu`` on the port's side)
and must write the same recordings, PPLs within rtol 1e-5 and NLL lists
within atol 1e-4, in every context type and under both attention paths;
plus the committed trained LM on the committed dev corpus, and the options
the port refuses."""

import json
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from loco_asr_tpu.models.gpt2 import model as jg
from loco_asr_tpu.pipelines import eval_ppl as jeval
from loco_asr_tpu.utils.checkpoint import Checkpointer, save_npz
from loco_asr_tpu_torch.pipelines import eval_ppl as teval

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV_TEXT = os.path.join(ROOT, "exp", "loco", "lm_corpus", "dev.txt")
LM_CKPT = os.path.join(ROOT, "exp", "loco", "lm", "ckpt")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fisher_text(tmp_path_factory):
    """Two recordings of 12 utterances each, Kaldi ``utt_id text`` lines."""
    p = tmp_path_factory.mktemp("fisher") / "text"
    rng = np.random.default_rng(0)
    words = ["yeah", "so", "the", "topic", "is", "music", "i", "think",
             "right", "well", "um", "okay"]
    lines = []
    for rec in ("fe_03_00001", "fe_03_00002"):
        t = 100
        for u in range(12):
            text = " ".join(rng.choice(words, int(rng.integers(3, 9))))
            lines.append(f"{rec}-{'AB'[u % 2]}-{t:06d}-{t + 80:06d} {text}")
            t += 100
    p.write_text("\n".join(lines) + "\n")
    return str(p)


@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory):
    cfg = jg.tiny_gpt2_config(vocab_size=256, n_positions=64, n_embd=32, n_head=4)
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.npz")
    save_npz(path, jg.gpt2_init(jax.random.PRNGKey(0), cfg))
    return path


def _run(main, out, in_file, flags, port: bool):
    argv = ["-i", in_file, "-o", str(out), *flags]
    if port:
        argv += ["--device", "cpu"]
    assert main(argv) == 0
    with open(out / "rec_id2ppl.json") as f:
        ppl = json.load(f)
    with open(out / "rec_id2nlls.pkl", "rb") as f:
        nlls = pickle.load(f)
    logs = [n for n in os.listdir(out) if ".log_" in n]
    assert len(logs) == 1
    with open(out / logs[0]) as f:
        assert "Avg. PPL of recordings:" in f.read()
    return ppl, nlls


def _assert_same(got, want):
    (ppl, nlls), (wppl, wnlls) = got, want
    assert list(ppl) == list(wppl) and list(nlls) == list(wnlls)
    for rec in wppl:
        np.testing.assert_allclose(ppl[rec], wppl[rec], rtol=1e-5)
        assert len(nlls[rec]) == len(wnlls[rec])
        np.testing.assert_allclose(nlls[rec], wnlls[rec], atol=1e-4, rtol=0)


MODES = {
    "indep": ["--context_type", "indep", "--bsize", "8"],
    "max_len": ["--context_type", "max_len", "--bsize", "7", "--max_len", "24"],
    "streaming": ["--context_type", "streaming", "--bsize", "3", "--max_len", "32"],
}


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_eval_ppl_matches_jax(mode, impl, fisher_text, tiny_npz, tmp_path):
    flags = ["--model", "tiny", "--checkpoint", tiny_npz, "--attn_impl", impl, *MODES[mode]]
    want = _run(jeval.main, tmp_path / "jax", fisher_text, flags, port=False)
    got = _run(teval.main, tmp_path / "port", fisher_text, flags, port=True)
    _assert_same(got, want)


def test_eval_ppl_trained_lm_on_dev_corpus(tmp_path):
    """The committed trained LM (64 wide, 3 layers, 4 heads) on the first
    5 recordings of the committed dev corpus, max_len mode at the model's
    own window: the port's dense and flash paths against JAX dense."""
    state = Checkpointer(LM_CKPT).restore()
    npz = str(tmp_path / "lm.npz")
    save_npz(npz, state["params"])
    flags = ["--model", "tiny", "--checkpoint", npz, "--context_type", "max_len",
             "--bsize", "64", "--limit_recordings", "5"]
    want = _run(jeval.main, tmp_path / "jax", DEV_TEXT, flags, port=False)
    assert len(want[0]) == 5
    for impl in ("dense", "flash"):
        got = _run(teval.main, tmp_path / impl, DEV_TEXT, [*flags, "--attn_impl", impl],
                   port=True)
        _assert_same(got, want)


@pytest.mark.parametrize("flags", [["--compute_dtype", "bfloat16"],
                                   ["--data_parallel", "2"],
                                   ["--sequence_parallel", "2"],
                                   ["--checkpoint", LM_CKPT]])
def test_unported_options_raise(flags, fisher_text, tmp_path):
    with pytest.raises(SystemExit, match="not ported yet"):
        teval.main(["-i", fisher_text, "-o", str(tmp_path), "--model", "tiny",
                    "--device", "cpu", *flags])


def test_eval_ppl_needs_a_gpu_unless_asked_for_cpu(fisher_text, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        teval.main(["-i", fisher_text, "-o", str(tmp_path / "gpu"), "--model", "tiny"])
    assert teval.main(["-i", fisher_text, "-o", str(tmp_path / "cpu"), "--model", "tiny",
                       "--no_cuda", "--context_type", "indep", "--bsize", "16"]) == 0


def test_hf_checkpoint_file_scores_like_the_npz(fisher_text, tiny_npz, tmp_path):
    """A torch ``pytorch_model.bin`` in HF naming loads through
    ``load_hf_gpt2`` and scores exactly like the ``.npz`` it was made from."""
    with np.load(tiny_npz) as z:
        sd = {}
        for k in z.files:
            parts = k.split(".")
            if parts[-1] in ("kernel", "scale"):
                parts[-1] = "weight"
            sd["transformer." + ".".join(parts)] = torch.from_numpy(z[k])
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    hf_dir = tmp_path / "hf"
    hf_dir.mkdir()
    torch.save(sd, hf_dir / "pytorch_model.bin")
    flags = ["--model", "tiny", *MODES["indep"]]
    want = _run(teval.main, tmp_path / "npz", fisher_text,
                [*flags, "--checkpoint", tiny_npz], port=True)
    got = _run(teval.main, tmp_path / "bin", fisher_text,
               [*flags, "--checkpoint", str(hf_dir)], port=True)
    _assert_same(got, want)


def test_tokenizers_match_jax(tmp_path):
    from loco_asr_tpu.data import tokenizer as jtok
    from loco_asr_tpu_torch.data import tokenizer as ttok

    text = "yeah so the topic is music, i think the thesis—ok 123"
    for vocab_size in (256, 258):
        assert (ttok.CharTokenizer(vocab_size=vocab_size)(text)
                == jtok.CharTokenizer(vocab_size=vocab_size)(text))
    # a toy byte-level BPE vocabulary: every byte symbol plus a few merges
    vocab = {c: i for i, c in enumerate(sorted(jtok.bytes_to_unicode().values()))}
    merges = [("t", "h"), ("th", "e"), ("Ġ", "t"), ("Ġt", "he"), ("i", "s")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab["<|endoftext|>"] = len(vocab)
    (tmp_path / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges), encoding="utf-8")
    want = jtok.load_tokenizer(str(tmp_path))
    got = ttok.load_tokenizer(str(tmp_path))
    ids = got(text)["input_ids"]
    assert ids == want(text)["input_ids"] and len(ids) < len(text.encode("utf-8"))
    assert got.decode(ids) == want.decode(ids) == text
    assert (got.bos_token_id, got.eos_token_id) == (want.bos_token_id, want.eos_token_id)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ttok.load_tokenizer("spm.model")
