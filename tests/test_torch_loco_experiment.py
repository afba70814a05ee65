"""The port's LoCo experiment (``loco_asr_tpu_torch.pipelines.loco_experiment``)
and the training directories it hands ``eval_ppl``, against the JAX
package on the CPU.

* ASR stage: both pipelines decode the same dev conversations with the
  same seeded random weights (JAX-initialised, saved as ``.npz`` steps
  under ``asr/ckpt`` and ``asr_lm/ckpt``, ``--skip_training``) at two
  fusion weights: ``asr_hyps.json`` identical, the ``results.json`` ASR
  keys equal.  The oracle pass primes the fusion LM's cache in place from
  a left-aligned [1, P] buffer; pinned here by its hypotheses.
* LM stage: the port's ``eval_ppl`` on a directory ``train_lm`` wrote
  equals the JAX ``eval_ppl`` on it within 1e-4, and ``read_checkpoint``
  reads what the JAX ``load_gpt2_params`` reads there and in a directory of
  the JAX ``.npz`` backend; orbax step directories are refused by name.

The JAX ``Checkpointer`` defaults to orbax where orbax is installed; the
tests that have the JAX side read ``.npz`` steps set ``use_orbax=False``
on it for their duration."""

import dataclasses
import json
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from loco_asr_tpu.models.gpt2 import model as jg
from loco_asr_tpu.models.speecht5 import model as jst5
from loco_asr_tpu.models.speecht5.config import tiny_config as jtiny
from loco_asr_tpu.pipelines import eval_ppl as jeval
from loco_asr_tpu.pipelines import loco_experiment as jloco
from loco_asr_tpu.utils import checkpoint as jckpt
from loco_asr_tpu.utils.pytree import flatten_with_paths
from loco_asr_tpu_torch.pipelines import eval_ppl as teval
from loco_asr_tpu_torch.pipelines import loco_experiment as tloco
from loco_asr_tpu_torch.pipelines import train_lm as ttrain_lm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_CKPT = os.path.join(ROOT, "exp", "loco", "lm", "ckpt")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_npz_checkpointer(monkeypatch):
    """The JAX ``Checkpointer`` on its ``.npz`` backend for this test."""
    init = jckpt.Checkpointer.__init__

    def npz_init(self, directory, use_orbax=None):
        init(self, directory, use_orbax=False)

    monkeypatch.setattr(jckpt.Checkpointer, "__init__", npz_init)


ASR_FLAGS = ["--stage", "asr", "--skip_training", "--seed", "3",
             "--asr_convs", "1", "--asr_dev_convs", "2", "--asr_utts", "3",
             "--asr_lm_convs", "4", "--asr_lm_seq_len", "64", "--lm_n_embd", "32",
             "--lm_n_layer", "2", "--decode_max_len", "12", "--fusion_weights", "0.4,2"]


def _seed_checkpoints(out):
    """Seeded random JAX weights of the experiment's tiny ASR model and
    fusion LM, saved as step 1 of ``out/asr/ckpt`` and ``out/asr_lm/ckpt``
    by the JAX ``.npz`` checkpointer."""
    cfg = jtiny(vocab_size=256, hidden_size=32, encoder_attention_heads=4,
                decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64)
    # the experiment's conv override (loco_experiment.py's conv_over)
    cfg = dataclasses.replace(cfg, conv_dim=(64, 64, 64), conv_stride=(5, 4, 2),
                              conv_kernel=(10, 8, 4), max_speech_positions=2048)
    asr = jst5.asr_init(jax.random.PRNGKey(5), cfg)
    lm_cfg = jg.tiny_gpt2_config(vocab_size=256, n_positions=64, n_embd=32, n_layer=2,
                                 n_head=4)
    lm = jg.gpt2_init(jax.random.PRNGKey(6), lm_cfg)
    for name, params in (("asr", asr), ("asr_lm", lm)):
        jckpt.Checkpointer(os.path.join(out, name, "ckpt"), use_orbax=False).save(
            1, {"params": params, "step": np.asarray(1)})


def test_asr_stage_on_shared_checkpoints_matches_jax(tmp_path, jax_npz_checkpointer):
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    for out in (jout, tout):
        _seed_checkpoints(out)
    assert jloco.main(["--out_dir", jout, *ASR_FLAGS]) == 0
    assert tloco.main(["--out_dir", tout, *ASR_FLAGS, "--device", "cpu"]) == 0
    with open(os.path.join(jout, "asr_hyps.json")) as f:
        want_hyps = json.load(f)
    with open(os.path.join(tout, "asr_hyps.json")) as f:
        got_hyps = json.load(f)
    assert len(want_hyps) == 6
    assert got_hyps == want_hyps
    labels = {"nofusion", "carry", "nocarry", "oracle", "carry_w2", "nocarry_w2",
              "oracle_w2"}
    assert all(set(h) == labels | {"ref"} for h in got_hyps.values())
    with open(os.path.join(jout, "results.json")) as f:
        want = json.load(f)
    with open(os.path.join(tout, "results.json")) as f:
        got = json.load(f)
    assert set(got) == set(want) == {"asr"}
    assert set(got["asr"]) == set(want["asr"]) == labels | {"wer_gain_degraded"}
    for key, value in want["asr"].items():
        if isinstance(value, dict):
            assert got["asr"][key].keys() == value.keys()
            for k, v in value.items():
                assert got["asr"][key][k] == pytest.approx(v, abs=1e-12), (key, k)
        else:
            assert got["asr"][key] == pytest.approx(value, abs=1e-12)
    # the corpus the ASR stage generated is the JAX one, byte for byte
    for rel in ("asr_corpus/dev/text", "asr_corpus/dev/degraded.txt",
                "asr_corpus/lm_text.txt", "asr_config.json"):
        with open(os.path.join(jout, rel), "rb") as a, open(os.path.join(tout, rel), "rb") as b:
            assert a.read() == b.read(), rel


def test_skip_training_refuses_an_orbax_step(tmp_path):
    ckpt = tmp_path / "asr" / "ckpt"
    (ckpt / "step_5").mkdir(parents=True)
    (ckpt / "status.json").write_text(json.dumps({"latest": 5}))
    with pytest.raises(SystemExit, match="step_5.npz"):
        tloco.main(["--out_dir", str(tmp_path), *ASR_FLAGS, "--device", "cpu"])


@pytest.fixture(scope="module")
def trained_lm(tmp_path_factory):
    """A port-trained tiny LM directory (train_lm, 6 steps) on a synthetic
    LM corpus, and its dev text."""
    from loco_asr_tpu_torch.data.synthetic_conversations import make_lm_corpus

    root = tmp_path_factory.mktemp("lm")
    train_txt, dev_txt = make_lm_corpus(str(root / "corpus"), n_train=12, n_dev=3,
                                        n_utts=4, seed=1)
    out = root / "lm"
    assert ttrain_lm.main(["--train_file", train_txt, "--dev_file", dev_txt,
                           "--out_dir", str(out), "--model", "tiny", "--seq_len", "64",
                           "--batch_size", "4", "--steps", "6", "--save_every", "3",
                           "--eval_every", "6", "--tiny_n_embd", "32",
                           "--tiny_n_layer", "2", "--device", "cpu"]) == 0
    return str(out / "ckpt"), dev_txt


@pytest.mark.parametrize("ctx", ["indep", "max_len", "streaming"])
def test_eval_ppl_on_a_trained_directory_matches_jax(ctx, trained_lm, tmp_path,
                                                     jax_npz_checkpointer):
    ckpt, dev_txt = trained_lm
    flags = ["--in_file", dev_txt, "--model", "tiny", "--tokenizer", "char",
             "--checkpoint", ckpt, "--context_type", ctx, "--max_len", "64",
             "--bsize", "8"]
    assert jeval.main([*flags, "--out_dir", str(tmp_path / "jax")]) == 0
    assert teval.main([*flags, "--out_dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    with open(tmp_path / "jax" / "rec_id2nlls.pkl", "rb") as f:
        want = pickle.load(f)
    with open(tmp_path / "port" / "rec_id2nlls.pkl", "rb") as f:
        got = pickle.load(f)
    assert list(got) == list(want) and len(got) == 3
    for rec in want:
        a = np.concatenate([np.ravel(u) for u in got[rec]])
        b = np.concatenate([np.ravel(u) for u in want[rec]])
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=rec)


def test_read_checkpoint_reads_what_jax_reads(trained_lm, tmp_path, jax_npz_checkpointer):
    """The latest step of a port-trained directory and of one the JAX
    ``.npz`` checkpointer wrote: the flat params of ``read_checkpoint``
    equal the JAX ``load_gpt2_params`` tree; orbax steps are refused by
    name."""
    ckpt, _ = trained_lm
    jdir = str(tmp_path / "jax_ckpt")
    cfg = jg.tiny_gpt2_config(vocab_size=256, n_positions=64, n_embd=32, n_layer=2,
                              n_head=4)
    jckpt.Checkpointer(jdir).save(7, {"params": jg.gpt2_init(jax.random.PRNGKey(2), cfg),
                                      "step": np.asarray(7)})
    for directory in (ckpt, jdir):
        kind, flat = teval.read_checkpoint(directory)
        want = {k: np.asarray(v) for k, v in
                flatten_with_paths(jeval.load_gpt2_params(directory, cfg)).items()}
        assert kind == "jax" and sorted(flat) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(flat[k], v, err_msg=k)
    with open(os.path.join(ckpt, "status.json")) as f:
        assert json.load(f)["latest"] == 6
    with pytest.raises(SystemExit, match=r"step_4000: orbax step directories"):
        teval.read_checkpoint(LM_CKPT)


def test_loco_experiment_needs_a_gpu_unless_asked_for_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tloco.main(["--out_dir", str(tmp_path), "--stage", "lm", "--lm_convs", "2",
                    "--lm_dev_convs", "1", "--lm_utts", "2", "--lm_steps", "1"])


@pytest.mark.parametrize("hist_len", [0, 17])
def test_oracle_priming_pads_stay_hidden(hist_len):
    """The oracle primes a history of length L left-aligned in a [1, P]
    buffer, in place: positions L..P-1 of the cache then hold the pads'
    keys and values.  Each decode step at L + t attends positions up to its
    own only, and writes it first, so the steps' log-probs equal those after
    priming exactly the L history tokens into a zero cache."""
    from loco_asr_tpu_torch.decode.fusion import FusionLM
    from loco_asr_tpu_torch.models.gpt2 import model as tg

    lm = tg.gpt2_init(tg.tiny_gpt2_config(vocab_size=256, n_positions=64, n_embd=32,
                                          n_head=4), seed=0, device="cpu")
    fusion = FusionLM(lm, weight=1.0)
    rng = np.random.default_rng(hist_len)
    P, zero = 44, torch.zeros(1, dtype=torch.int64)
    hist = rng.integers(3, 256, hist_len)
    padded = np.zeros((1, P), np.int64)
    padded[0, :hist_len] = hist
    garbage = fusion.init_cache(1, 64)
    fusion.prime(torch.from_numpy(padded), garbage, zero)
    clean = fusion.init_cache(1, 64)
    if hist_len:
        fusion.prime(torch.from_numpy(hist[None]), clean, zero)
    assert garbage["0"]["k"][0, :, hist_len:P].abs().sum() > 0   # the pads' keys
    for t, tok in enumerate(rng.integers(3, 256, 10)):
        pos = torch.tensor([hist_len + t])
        tok = torch.tensor([[int(tok)]])
        got, _ = fusion.step(tok, pos, garbage)
        want, _ = fusion.step(tok, pos, clean)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_lm_stage_context_gain_is_positive(tmp_path):
    """The LM stage at the JAX test's own scale
    (``tests/test_loco_experiment.py``), through the port's train_lm and
    eval_ppl on the CPU, with that test's assertions: history beats
    per-utterance scoring on held-out conversations, streaming too."""
    out = tmp_path / "loco"
    assert tloco.main([
        "--out_dir", str(out), "--stage", "lm",
        "--lm_convs", "60", "--lm_dev_convs", "10", "--lm_utts", "8",
        "--lm_steps", "400", "--lm_batch", "8", "--seq_len", "128",
        "--lm_n_embd", "64", "--lm_n_layer", "3",
        "--rng_impl", "threefry", "--seed", "0", "--device", "cpu"]) == 0
    with open(out / "results.json") as f:
        lm = json.load(f)["lm"]
    assert lm["nll_indep"] - lm["nll_max_len"] > 0.02, lm
    assert lm["ppl_max_len"] < lm["ppl_indep"], lm
    assert lm["ppl_streaming"] < lm["ppl_indep"], lm
