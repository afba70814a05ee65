"""The port's multi-rank pipelines on gloo CPU ranks against the JAX
pipelines at the same flags (on the virtual CPU devices of
``tests/conftest.py``):

* ``train_asr --mesh 1,2,2`` (the command starts its 4 ranks itself) and
  ``train_lm --mesh 2,1,2`` (ranks started beforehand, as ``torchrun``
  does), two steps from one JAX init with dropout off (the warmup makes
  step 1's rate 0): each saved parameter's update from the init against
  JAX's, within 1e-6 on all but 1 % of the entries and within 2 lr
  everywhere (the first AdamW step's sign bound where a gradient is
  rounding-level), the same dev PPL for the LM; the mesh run
  ``--resume``s, its dev evaluation (each rank's share of the dev batches)
  equals the single-device trainer's on the same resumed step;
* ``decode_asr``, ``extract_embeddings -m audio`` and ``eval_ppl
  --context_type max_len`` at ``--data_parallel 2``: the same ``hyp.text``
  and WER as JAX's, embeddings within 1e-5, per-recording PPLs within
  1e-5 relative, and ``eval_ppl`` under ``torch.distributed.run`` equal to
  the spawned run;
* ``dryrun_multichip(4)`` and ``(8)`` on the CPU: each sharded step within
  the JAX dry run's bounds of the single-device step, dropout on, and its
  sequence-parallel sections (ring and Ulysses scoring, DP x SP, the ASR
  ring step) within theirs."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import torch_dist_worker as worker
from loco_asr_tpu.models.gpt2 import model as jg
from loco_asr_tpu.models.speecht5 import model as jm
from loco_asr_tpu.models.speecht5.config import SpeechT5Config as JConfig
from loco_asr_tpu.models.speecht5.config import tiny_config as jtiny
from loco_asr_tpu.utils.checkpoint import save_npz
from loco_asr_tpu_torch.models.speecht5.config import tiny_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "exp", "loco", "asr_corpus", "dev")
LM_TEXT = os.path.join(ROOT, "exp", "loco", "lm_corpus", "dev.txt")
CONV = dict(conv_dim=[16] * 7, conv_stride=[5, 2, 2, 2, 2, 2, 2],
            conv_kernel=[10, 3, 3, 3, 3, 2, 2])
LR = 1e-4
UPD_TOL, OFF_SHARE = 1e-6, 0.01   # measured: 0.076 % (ASR), 0.036 % (LM) off


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """The relocated dev corpus and seeded JAX checkpoints: a dropout-free
    tiny ASR model with the 7-layer conv stride (training), the tiny ASR
    model and LM of ``decode_asr``'s tests (decoding)."""
    root = tmp_path_factory.mktemp("dp")
    dev = root / "dev"
    dev.mkdir()
    for name in ("text", "segments"):
        (dev / name).write_bytes(open(os.path.join(CORPUS, name), "rb").read())
    with open(os.path.join(CORPUS, "wav.scp")) as f, open(dev / "wav.scp", "w") as out:
        for line in f:
            key, path = line.split(None, 1)
            out.write(f"{key} {os.path.join(CORPUS, 'wav', os.path.basename(path.strip()))}\n")
    over = dict(CONV, hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                feat_proj_dropout=0.0, positional_dropout=0.0, apply_spec_augment=False)
    (root / "cfg.json").write_text(json.dumps(over))
    cfg = tiny_config(vocab_size=256, hidden_size=32, encoder_attention_heads=4,
                      decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64,
                      **{k: tuple(v) if isinstance(v, list) else v for k, v in over.items()})
    save_npz(str(root / "train_init.npz"),
             jm.asr_init(jax.random.PRNGKey(7), JConfig(**dataclasses.asdict(cfg))))
    save_npz(str(root / "asr.npz"), jm.asr_init(jax.random.PRNGKey(5), jtiny(
        vocab_size=256, apply_spec_augment=False)))
    save_npz(str(root / "lm.npz"), jg.gpt2_init(jax.random.PRNGKey(3), jg.tiny_gpt2_config(
        vocab_size=256, n_embd=32, n_head=4, n_positions=128)))
    save_npz(str(root / "lm_init.npz"), jg.gpt2_init(jax.random.PRNGKey(4), jg.tiny_gpt2_config(
        vocab_size=256, n_positions=64, n_embd=32, n_layer=2, n_head=4)))
    return root


def _params(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k.startswith("params.")}


def _jax_params(run_dir):
    """The JAX trainer's latest saved parameters (orbax or .npz)."""
    from loco_asr_tpu.utils.checkpoint import Checkpointer
    from loco_asr_tpu.utils.pytree import flatten_with_paths

    restored = Checkpointer(os.path.join(run_dir, "ckpt")).restore()
    return {f"params.{k}": np.asarray(v, np.float64)
            for k, v in flatten_with_paths(restored["params"]).items()}


def _updates_match(got, want, init_path):
    """The run's update of every saved parameter (saved - init) against
    JAX's: every entry within 2 lr (AdamW steps a rounding-level gradient
    by the sign of its noise, on each side its own), and all but
    ``OFF_SHARE`` of the entries within ``UPD_TOL``; each of those updates
    is about lr, so a run that skips or flips the update fails."""
    with np.load(init_path) as z:
        init = {f"params.{k}": z[k].astype(np.float64) for k in z.files}
    assert got.keys() == want.keys() == init.keys()
    off = total = 0
    for k, w in want.items():
        upd, jupd = got[k].astype(np.float64) - init[k], w - init[k]
        assert np.abs(upd - jupd).max() <= 2 * LR + 1e-6, k
        off += int((np.abs(upd - jupd) > UPD_TOL).sum())
        total += upd.size
    assert off <= OFF_SHARE * total, (off, total)


def test_train_asr_mesh_matches_jax_and_resumes(assets, tmp_path, capfd):
    from loco_asr_tpu.pipelines import train_asr as jtrain_asr
    from loco_asr_tpu_torch.pipelines import train_asr

    common = ["--train_dir", str(assets / "dev"), "--tiny", "--config_json",
              str(assets / "cfg.json"), "--batch_size", "4", "--conversation_seconds", "3",
              "--warmup_steps", "1", "--lr", str(LR), "--save_every", "2",
              "--eval_every", "10", "--checkpoint", str(assets / "train_init.npz")]
    mesh = ["--mesh", "1,2,2"]
    assert jtrain_asr.main([*common, *mesh, "--steps", "2",
                            "--out_dir", str(tmp_path / "jax")]) == 0
    port = tmp_path / "port"
    assert train_asr.main([*common, *mesh, "--steps", "2", "--out_dir", str(port),
                           "--device", "cpu"]) == 0
    _updates_match(_params(port / "ckpt" / "step_2.npz"), _jax_params(tmp_path / "jax"),
                   assets / "train_init.npz")
    capfd.readouterr()
    # the mesh run resumes to step 3 and evaluates (each rank decodes its
    # share of the dev batches on gathered weights), then the single-device
    # trainer resumes step 3 and evaluates the same weights: same numbers
    dev = ["--dev_dir", str(assets / "dev"), "--eval_batches", "2", "--decode_max_len", "6",
           "--out_dir", str(port), "--device", "cpu", "--resume", "--steps", "3"]
    assert train_asr.main([*common, *mesh, *dev, "--save_every", "3"]) == 0
    assert train_asr.main([*common, *dev]) == 0
    err = capfd.readouterr().err
    assert "resumed at step 2" in err and "resumed at step 3" in err
    with np.load(port / "ckpt" / "step_3.npz") as z3:
        assert int(z3["opt_state.count"]) == 3
    lines = [json.loads(l) for l in (port / "metrics.jsonl").read_text().splitlines()]
    mesh_eval, single_eval = [r for r in lines if "dev_loss" in r][-2:]
    assert mesh_eval["step"] == single_eval["step"] == 3
    np.testing.assert_allclose(mesh_eval["dev_loss"], single_eval["dev_loss"], rtol=1e-6)
    assert mesh_eval["dev_wer"] == single_eval["dev_wer"]


def test_train_lm_mesh_matches_jax(assets, tmp_path, monkeypatch):
    from loco_asr_tpu.pipelines import train_lm as jtrain_lm

    real = jg.tiny_gpt2_config
    monkeypatch.setattr(jg, "tiny_gpt2_config", lambda **kw: real(
        **{**kw, "embd_pdrop": 0.0, "attn_pdrop": 0.0, "resid_pdrop": 0.0}))
    common = ["--train_file", LM_TEXT, "--dev_file", LM_TEXT, "--model", "tiny",
              "--seq_len", "48", "--batch_size", "6", "--steps", "2", "--lr", str(LR),
              "--warmup_steps", "1", "--log_every", "1", "--eval_every", "100",
              "--save_every", "2", "--tiny_n_embd", "32", "--tiny_n_head", "4",
              "--checkpoint", str(assets / "lm_init.npz"), "--mesh", "2,1,2"]
    assert jtrain_lm.main([*common, "--out_dir", str(tmp_path / "jax")]) == 0
    worker.spawn(str(tmp_path), 4, [("pipeline", dict(
        module="loco_asr_tpu_torch.pipelines.train_lm",
        argv=[*common, "--out_dir", str(tmp_path / "port"), "--device", "cpu"],
        patch="gpt2_no_dropout"))])
    _updates_match(_params(tmp_path / "port" / "ckpt" / "step_2.npz"),
                   _jax_params(tmp_path / "jax"), assets / "lm_init.npz")

    def dev_ppl(run):
        with open(tmp_path / run / "metrics.jsonl") as f:
            return [json.loads(line) for line in f if "dev_ppl" in line][-1]["dev_ppl"]

    np.testing.assert_allclose(dev_ppl("port"), dev_ppl("jax"), rtol=1e-4)


def test_decode_asr_data_parallel_matches_jax(assets, tmp_path):
    from loco_asr_tpu.pipelines import decode_asr as jdecode
    from loco_asr_tpu_torch.pipelines import decode_asr

    flags = ["--data_dir", str(assets / "dev"), "--tiny", "--max_decode_len", "12",
             "--max_seconds", "1", "--batch_size", "5", "--limit_batches", "2",
             "--lm_weight", "0.5", "--beam_size", "2", "--checkpoint", str(assets / "asr.npz"),
             "--lm_checkpoint", str(assets / "lm.npz"), "--data_parallel", "2"]
    assert jdecode.main([*flags, "--out_dir", str(tmp_path / "jax")]) == 0
    assert decode_asr.main([*flags, "--out_dir", str(tmp_path / "port"),
                            "--device", "cpu"]) == 0
    read = lambda run, name: (tmp_path / run / name).read_text()
    assert read("port", "hyp.text") == read("jax", "hyp.text")
    assert len(read("port", "hyp.text").splitlines()) == 10
    got, want = (json.loads(read(r, "wer.json")) for r in ("port", "jax"))
    assert {k: v for k, v in got.items() if k != "rtfx"} == \
        {k: v for k, v in want.items() if k != "rtfx"}


def test_extract_embeddings_data_parallel_matches_jax(tmp_path, monkeypatch):
    """The tiny config in both pipelines (the port's ranks patch theirs)."""
    from test_torch_pipelines import N_UTT, _write_wav
    from loco_asr_tpu.models.speecht5 import config as jconfig
    from loco_asr_tpu.pipelines import extract_embeddings as jextract
    from loco_asr_tpu_torch.data.embedding_store import EmbeddingStore

    root = tmp_path / "slurp"
    (root / "dataset/slurp").mkdir(parents=True)
    (root / "audio/slurp_real").mkdir(parents=True)
    with open(root / "dataset/slurp/train.jsonl", "w") as f:
        for i in range(N_UTT):
            _write_wav(root / "audio/slurp_real" / f"t{i}.wav", 0.3 + 0.2 * i, seed=i)
            f.write(json.dumps({"slurp_id": 100 + i, "sentence": f"sentence {i}",
                                "intent": "alarm_set", "recordings": [{"file": f"t{i}.wav"}]})
                    + "\n")
    full, tiny = jconfig.SpeechT5Config, jconfig.tiny_config()
    monkeypatch.setattr(jconfig, "SpeechT5Config",
                        lambda *a, **kw: full(*a, **kw) if a or kw else tiny)
    save_npz(str(tmp_path / "init.npz"), jm.asr_init(jax.random.PRNGKey(5), tiny))
    flags = ["-m", "audio", "-s", "train", "--data_path", str(root), "--batch_size", "3",
             "--checkpoint", str(tmp_path / "init.npz"), "--data_parallel", "2"]
    monkeypatch.chdir(tmp_path)
    assert jextract.main([*flags, "--out_dir", str(tmp_path / "jax")]) == 0
    worker.spawn(str(tmp_path), 2, [("pipeline", dict(
        module="loco_asr_tpu_torch.pipelines.extract_embeddings",
        argv=[*flags, "--out_dir", str(tmp_path / "port"), "--device", "cpu"],
        patch="tiny_speecht5"))])
    want, got = EmbeddingStore(str(tmp_path / "jax")), EmbeddingStore(str(tmp_path / "port"))
    assert len(got) == len(want) == N_UTT
    for i in range(N_UTT):
        (wid, wemb, wtgt), (gid, gemb, gtgt) = want[i], got[i]
        assert int(gid) == int(wid) and gemb.shape == wemb.shape
        np.testing.assert_array_equal(gtgt, wtgt)
        np.testing.assert_allclose(gemb, wemb, atol=1e-5, rtol=1e-5)


def _ppl(path):
    with open(os.path.join(path, "rec_id2ppl.json")) as f:
        return json.load(f)


def test_eval_ppl_data_parallel_matches_jax_and_torchrun(assets, tmp_path):
    from loco_asr_tpu.pipelines import eval_ppl as jeval
    from loco_asr_tpu_torch.pipelines import eval_ppl

    flags = ["-i", LM_TEXT, "--model", "tiny", "--max_len", "64", "--bsize", "5",
             "--context_type", "max_len", "--limit_recordings", "3",
             "--checkpoint", str(assets / "lm.npz"), "--data_parallel", "2"]
    assert jeval.main([*flags, "-o", str(tmp_path / "jax")]) == 0
    assert eval_ppl.main([*flags, "-o", str(tmp_path / "port"), "--device", "cpu"]) == 0
    want, got = _ppl(tmp_path / "jax"), _ppl(tmp_path / "port")
    assert got.keys() == want.keys() and len(got) == 3
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2", "-m", "loco_asr_tpu_torch.pipelines.eval_ppl", *flags,
         "-o", str(tmp_path / "torchrun"), "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "backend gloo" in run.stderr
    assert _ppl(tmp_path / "torchrun") == got


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_on_the_cpu(n):
    from loco_asr_tpu_torch.parallel.dryrun import dryrun_multichip, mesh_dims

    res = dryrun_multichip(n, device="cpu")
    assert tuple(res["mesh"]) == mesh_dims(n) == ((1, 2, 2) if n == 4 else (2, 2, 2))
    assert res["sharded"]["d_loss"] < 1e-4 and res["sharded"]["d_grad_norm_rel"] < 1e-3
    assert ("multislice" in res) == (n >= 8)
    # the sequence-parallel sections: ring scoring over 4 ranks, Ulysses and
    # DP x SP (2, 2) within 1e-4 of it, the ASR ring step over 2 ranks
    assert res["sp_devices"] == 4 and np.isfinite(res["ring_mean_nll"])
    for key in ("ulysses_mean_nll", "dp_sp_mean_nll"):
        assert abs(res[key] - res["ring_mean_nll"]) < 1e-4, key
    assert res["asr_ring"]["d_loss"] < 1e-4 and res["asr_ring"]["d_grad_norm_rel"] < 1e-3


def test_dryrun_runs_on_the_card_unless_asked_for_the_cpu():
    """Like every entry point, the dry run defaults to the card: without
    one it raises before starting a rank, and its command exits non-zero."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from loco_asr_tpu_torch.parallel.dryrun import dryrun_multichip

    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(4)
    run = subprocess.run([sys.executable, "-m", "loco_asr_tpu_torch.parallel.dryrun", "4"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert run.returncode != 0 and "no CUDA device" in run.stderr
