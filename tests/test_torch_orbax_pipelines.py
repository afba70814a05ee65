"""The pipelines on orbax training directories, read by the port without
orbax: ``eval_ppl``, ``train_lm --checkpoint``, the SpeechT5
``--checkpoint`` of the pipelines, and ``--resume``'s refusal of a JAX run.

``eval_ppl`` on the committed LoCo LM (``exp/loco/lm/ckpt``, step 4000)
with the LoCo LM stage's flags (``--model tiny --tokenizer char --max_len
256 --bsize 32`` on ``exp/loco/lm_corpus/dev.txt``), ``indep`` and
``max_len``: the port (dense and flash) against the JAX ``eval_ppl`` on
the same directory, per-token NLLs within 1e-4 and every recording's
perplexity within 1e-4 relative.  The committed ``exp/loco/ppl_*/
rec_id2ppl.json`` were written by another run (the JAX LM stage on its
own device): the JAX pipeline here misses them by ~2e-3 relative (indep)
and ~1.3e-3 (max_len), so both packages are held to the JAX run here.
Its perplexities are ``fixtures/loco_reference/lm_ppl.json``, which
``chip_smoke.py`` holds the card to; the test pins the fixture to the JAX
run.  Rewrite it with ``python tests/test_torch_orbax_pipelines.py``
(needs JAX and orbax); ``... --precision-gap`` prints the JAX run's gap to
the committed files at f32, bf16 compute and bf16 matmul operands."""

import json
import os
import pickle
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = os.path.join(ROOT, "exp", "loco")
LM_CKPT = os.path.join(EXP, "lm", "ckpt")
DEV_TEXT = os.path.join(EXP, "lm_corpus", "dev.txt")
FIXTURE = os.path.join(ROOT, "fixtures", "loco_reference", "lm_ppl.json")
LM_FLAGS = ["--model", "tiny", "--tokenizer", "char", "--max_len", "256", "--bsize", "32",
            "--checkpoint", LM_CKPT]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _read(out):
    with open(os.path.join(out, "rec_id2ppl.json")) as f:
        ppl = json.load(f)
    with open(os.path.join(out, "rec_id2nlls.pkl"), "rb") as f:
        nlls = pickle.load(f)
    return ppl, nlls


def run_jax(out: str, context: str):
    from loco_asr_tpu.pipelines import eval_ppl as jeval

    assert jeval.main(["-i", DEV_TEXT, "-o", out, *LM_FLAGS, "--context_type", context]) == 0
    return _read(out)


def _rel(got: dict, want: dict) -> float:
    assert sorted(got) == sorted(want)
    return max(abs(got[k] - want[k]) / want[k] for k in want)


@pytest.mark.parametrize("context", ["indep", "max_len"])
def test_eval_ppl_on_the_committed_orbax_lm(tmp_path, context):
    from loco_asr_tpu_torch.pipelines import eval_ppl as teval

    want_ppl, want_nlls = run_jax(str(tmp_path / "jax"), context)
    with open(FIXTURE) as f:
        assert _rel(json.load(f)[context], want_ppl) <= 1e-6
    with open(os.path.join(EXP, f"ppl_{context}", "rec_id2ppl.json")) as f:
        committed = json.load(f)
    assert 1e-4 < _rel(committed, want_ppl) < 5e-3          # the other run's gap
    impls = ["dense", "flash"] if context == "indep" else ["dense"]
    for impl in impls:
        out = str(tmp_path / impl)
        assert teval.main(["-i", DEV_TEXT, "-o", out, *LM_FLAGS, "--context_type", context,
                           "--attn_impl", impl, "--device", "cpu"]) == 0
        got_ppl, got_nlls = _read(out)
        assert len(got_ppl) == 40 and _rel(got_ppl, want_ppl) <= 1e-4
        for rec in want_nlls:
            a = np.concatenate([np.ravel(u) for u in got_nlls[rec]])
            b = np.concatenate([np.ravel(u) for u in want_nlls[rec]])
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=rec)


def test_train_lm_starts_from_an_orbax_checkpoint(tmp_path):
    """``train_lm --checkpoint`` on the committed orbax LM: its weights are
    the start (lr 0 keeps them), and the step saved is a ``.npz`` whose
    params equal the orbax step's."""
    from loco_asr_tpu_torch.pipelines import train_lm
    from loco_asr_tpu_torch.utils.checkpoint import flatten, load_npz
    from loco_asr_tpu_torch.utils.orbax import restore_step

    out = tmp_path / "lm"
    assert train_lm.main(["--train_file", DEV_TEXT, "--out_dir", str(out), "--model", "tiny",
                          "--checkpoint", LM_CKPT, "--tiny_n_embd", "64", "--tiny_n_layer", "3",
                          "--seq_len", "256", "--batch_size", "2",
                          "--steps", "1", "--save_every", "1", "--lr", "0",
                          "--weight_decay", "0", "--device", "cpu"]) == 0
    got = flatten(load_npz(str(out / "ckpt" / "step_1.npz"))["params"])
    want = flatten(restore_step(os.path.join(LM_CKPT, "step_4000"))["params"])
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    shutil.copytree(os.path.join(LM_CKPT, "step_4000"), out / "ckpt" / "step_4000")
    (out / "ckpt" / "status.json").write_text(json.dumps({"latest": 4000}))
    with pytest.raises(SystemExit, match="--resume continues this package's own runs"):
        train_lm.main(["--train_file", DEV_TEXT, "--out_dir", str(out), "--model", "tiny",
                       "--seq_len", "64", "--batch_size", "4", "--steps", "2", "--resume",
                       "--device", "cpu"])


@pytest.mark.parametrize("name", ["asr", "asr_lm"])
def test_speecht5_and_gpt2_loaders_read_the_orbax_steps_as_the_fixture(name):
    """The SpeechT5 ``--checkpoint`` loader (``common.load_speecht5_params``)
    and the GPT-2 one (``eval_ppl.load_gpt2``) give the same weights from
    the committed orbax step as from its ``.npz`` fixture."""
    import dataclasses

    from loco_asr_tpu_torch.models.gpt2 import model as g
    from loco_asr_tpu_torch.models.speecht5.config import tiny_config
    from loco_asr_tpu_torch.pipelines import common
    from loco_asr_tpu_torch.pipelines.eval_ppl import load_gpt2

    orbax_dir = os.path.join(EXP, name, "ckpt")
    npz_dir = os.path.join(ROOT, "fixtures", "loco_reference", name)
    if name == "asr":
        cfg = tiny_config(vocab_size=256, hidden_size=32, encoder_attention_heads=4,
                          decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64)
        cfg = dataclasses.replace(cfg, conv_dim=(64, 64, 64), conv_stride=(5, 4, 2),
                                  conv_kernel=(10, 8, 4), max_speech_positions=2048)
        models = [common.load_speecht5_params(d, cfg, device="cpu", variant="asr")
                  for d in (orbax_dir, npz_dir)]
    else:
        cfg = g.tiny_gpt2_config(vocab_size=256, n_positions=512, n_embd=64, n_layer=3)
        models = [load_gpt2(d, cfg, "cpu", tiny=True) for d in (orbax_dir, npz_dir)]
    a, b = (m.state_dict() for m in models)
    assert sorted(a) == sorted(b) and len(a) > 20
    for k in a:
        assert torch.equal(a[k], b[k]), k


def write_fixture(path: str = FIXTURE) -> None:
    """The JAX ``eval_ppl``'s perplexities on the committed LM, both modes."""
    import tempfile

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for context in ("indep", "max_len"):
            out[context] = run_jax(os.path.join(tmp, context), context)[0]
    with open(path, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")


def precision_gap() -> dict:
    """The JAX ``eval_ppl``'s largest relative gap to the committed
    ``rec_id2ppl.json``, both modes, at three precisions on the CPU: f32,
    ``--compute_dtype bfloat16``, and f32 with every matmul's operands
    rounded to bfloat16 and their products summed in f32 (one bf16 pass,
    as XLA's default matmul precision runs on a TPU)."""
    import tempfile

    from jax._src.lax import lax as lax_impl

    def gaps(extra):
        out = {}
        with tempfile.TemporaryDirectory() as tmp:
            for context in ("indep", "max_len"):
                from loco_asr_tpu.pipelines import eval_ppl as jeval
                d = os.path.join(tmp, context)
                assert jeval.main(["-i", DEV_TEXT, "-o", d, *LM_FLAGS,
                                   "--context_type", context, *extra]) == 0
                with open(os.path.join(EXP, f"ppl_{context}", "rec_id2ppl.json")) as f:
                    out[context] = _rel(json.load(f), _read(d)[0])
        return out

    result = {"f32": gaps([]), "compute_dtype_bfloat16": gaps(["--compute_dtype", "bfloat16"])}
    dot_general = lax_impl.dot_general

    def one_bf16_pass(lhs, rhs, dimension_numbers, precision=None,
                      preferred_element_type=None, **kw):
        if lhs.dtype == rhs.dtype == np.float32:
            return dot_general(lhs.astype(jax.numpy.bfloat16), rhs.astype(jax.numpy.bfloat16),
                               dimension_numbers, preferred_element_type=np.float32, **kw)
        return dot_general(lhs, rhs, dimension_numbers, precision=precision,
                           preferred_element_type=preferred_element_type, **kw)

    lax_impl.dot_general = one_bf16_pass
    jax.clear_caches()                  # retrace the pipeline's jitted functions
    try:
        result["bf16_matmul_operands"] = gaps([])
    finally:
        lax_impl.dot_general = dot_general
        jax.clear_caches()
    return result


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    sys.path.insert(0, ROOT)
    if sys.argv[1:] == ["--precision-gap"]:
        print(json.dumps(precision_gap()))
    else:
        write_fixture(sys.argv[1] if len(sys.argv) > 1 else FIXTURE)
