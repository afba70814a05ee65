"""The LoCo ASR experiment on the reference's own trained weights.

``fixtures/loco_reference/`` holds the committed orbax checkpoints
``exp/loco/asr/ckpt`` (step 4000) and ``exp/loco/asr_lm/ckpt`` (step 8000)
as ``.npz`` training directories, parameters only: ``status.json`` and
``step_N.npz`` with ``params.<JAX flat key>`` entries, the layout both
packages' ``.npz`` checkpointers write and ``eval_ppl.training_dir_params``
reads.  The port also reads the orbax steps themselves, without orbax
(``utils/orbax.py``); the decodes run from both.

* The fixture equals what the JAX ``Checkpointer`` restores from the orbax
  steps, array for array (pins where it came from); its ``asr_init.npz``
  is the JAX ``asr_init(PRNGKey(0))`` of the experiment's ASR config, the
  shared start of ``scripts/loco_trainer_seeds.py``.
* The port's ``loco_experiment --stage asr --skip_training
  --fusion_weights 1.0 --device cpu`` on the fixture, its dev corpus cut to
  two recordings on the test side (keeping the decodes' padding bucket),
  gives the hypotheses of ``exp/loco/asr_hyps.json`` for their 20
  utterances; so does the same on copies of the orbax steps.
* The experiment's ASR training recipe gives the same parameters in both
  packages' ``train_asr`` from one init once dropout and SpecAugment are
  off: the trainers part only in the random streams.
* Those streams, dropout and SpecAugment at the recipe's config and
  corpus, agree between the packages in distribution: the same sites and
  rates, keep rates, masked share, runs and run lengths.
* ``slow``: the same on all 12 recordings gives the ``nofusion``,
  ``carry``, ``nocarry`` and ``oracle`` entries of ``exp/loco/results.json``
  exactly (about a minute of CPU).  One hypothesis of the 120 parts from
  the recorded (TPU) file there, in the ``nofusion`` decode of a degraded
  name (``devconv0001-A-002400-002650``: "onmnm" against "onmkn"), at an
  equal word error, so the file-level check is the results' entries.

Rewrite the fixture with ``python tests/test_torch_loco_reference.py``
(needs JAX and orbax)."""

import json
import os
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "fixtures", "loco_reference")
EXP = os.path.join(ROOT, "exp", "loco")
STEPS = {"asr": 4000, "asr_lm": 8000}
LABELS = ("nofusion", "carry", "nocarry", "oracle")


def restore_orbax(name: str) -> dict:
    """The params of ``exp/loco/<name>/ckpt``'s latest step, through the JAX
    ``Checkpointer`` on its orbax backend, as a flat numpy dict."""
    from loco_asr_tpu.utils.checkpoint import Checkpointer
    from loco_asr_tpu.utils.pytree import flatten_with_paths

    state = Checkpointer(os.path.join(EXP, name, "ckpt"), use_orbax=True).restore()
    assert int(np.asarray(state["step"])) == STEPS[name]
    return {k: np.asarray(v) for k, v in flatten_with_paths(state["params"]).items()}


def loco_asr_config(tiny_config):
    """The experiment's ASR config (``train_asr --tiny`` with the 3-layer
    conv front end), from either package's ``tiny_config``."""
    import dataclasses

    cfg = tiny_config(vocab_size=256, hidden_size=32, encoder_attention_heads=4,
                      decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64)
    return dataclasses.replace(cfg, conv_dim=(64, 64, 64), conv_stride=(5, 4, 2),
                               conv_kernel=(10, 8, 4), max_speech_positions=2048)


def loco_asr_init() -> dict:
    """The JAX ``asr_init`` of ``PRNGKey(0)`` under the experiment's ASR
    config."""
    import jax

    from loco_asr_tpu.models.speecht5 import model as st5
    from loco_asr_tpu.models.speecht5.config import tiny_config

    return st5.asr_init(jax.random.PRNGKey(0), loco_asr_config(tiny_config))


def write_fixture(root: str) -> None:
    """The orbax steps as ``.npz`` training directories under ``root``,
    written by the JAX ``.npz`` checkpointer, and ``asr_init.npz``: the
    start that ``scripts/loco_trainer_seeds.py`` gives both trainers."""
    from loco_asr_tpu.utils.checkpoint import Checkpointer, save_npz
    from loco_asr_tpu.utils.pytree import unflatten_from_paths

    for name, step in STEPS.items():
        params = unflatten_from_paths(restore_orbax(name))
        Checkpointer(os.path.join(root, name), use_orbax=False).save(step, {"params": params})
    save_npz(os.path.join(root, "asr_init.npz"), loco_asr_init())


def test_fixture_equals_the_committed_orbax_steps():
    pytest.importorskip("orbax.checkpoint")
    for name, step in STEPS.items():
        with open(os.path.join(FIXTURE, name, "status.json")) as f:
            assert json.load(f)["latest"] == step
        want = restore_orbax(name)
        with np.load(os.path.join(FIXTURE, name, f"step_{step}.npz"),
                     allow_pickle=False) as z:
            got = {k: z[k] for k in z.files}
        assert set(got) == {f"params.{k}" for k in want}, name
        for key, value in want.items():
            assert got[f"params.{key}"].dtype == value.dtype, key
            np.testing.assert_array_equal(got[f"params.{key}"], value, err_msg=key)


def test_shared_init_is_the_jax_init():
    from loco_asr_tpu.utils.pytree import flatten_with_paths

    want = flatten_with_paths(loco_asr_init())
    with np.load(os.path.join(FIXTURE, "asr_init.npz"), allow_pickle=False) as z:
        assert set(z.files) == set(want)
        for key, value in want.items():
            np.testing.assert_array_equal(z[key], np.asarray(value), err_msg=key)


def _stage_out(tmp_path, source: str = "fixture") -> str:
    """An experiment directory whose ``asr/ckpt`` and ``asr_lm/ckpt`` are
    copies of the fixture's training directories (``.npz``) or, for
    ``source="orbax"``, of the committed orbax ones."""
    out = str(tmp_path / "loco")
    for name in STEPS:
        src = os.path.join(FIXTURE, name) if source == "fixture" else \
            os.path.join(EXP, name, "ckpt")
        shutil.copytree(src, os.path.join(out, name, "ckpt"))
    return out


def _two_recordings(monkeypatch) -> None:
    """Cut the dev corpus that ``make_asr_corpus`` writes to two recordings:
    the first, and the first that holds an utterance of the corpus's
    longest length.  The decodes pad every utterance to that length (the
    pipeline's bucket), and the feature encoder's group norm runs over the
    padded waveform, so a cut that changed the bucket would change the
    encoder's output.  The corpus itself is generated in full, so train and
    dev names stay those of the recorded run."""
    from loco_asr_tpu_torch.data import synthetic_conversations as sc
    from loco_asr_tpu_torch.data.asr_dataset import KaldiAsrDataset

    make = sc.make_asr_corpus

    def cut(*args, **kwargs):
        tr_dir, dev_dir = make(*args, **kwargs)
        lengths = {}
        dev = KaldiAsrDataset(dev_dir)
        for ex in dev.examples:
            lengths.setdefault(ex.reco_id, []).append(len(dev.load_waveform(ex)))
        longest = max(max(v) for v in lengths.values())
        recos = list(lengths)
        keep_recos = {recos[0], next(r for r in recos if max(lengths[r]) == longest)}
        with open(os.path.join(dev_dir, "segments")) as f:
            keep_utts = {line.split()[0] for line in f if line.split()[1] in keep_recos}
        for fname in ("segments", "text", "wav.scp", "degraded.txt"):
            path = os.path.join(dev_dir, fname)
            with open(path) as f:
                lines = f.readlines()
            ids = keep_recos if fname == "wav.scp" else keep_utts
            with open(path, "w") as f:
                f.writelines(line for line in lines
                             if line.strip() and line.split()[0] in ids)
        return tr_dir, dev_dir

    monkeypatch.setattr(sc, "make_asr_corpus", cut)


def _run_port(out: str) -> None:
    from loco_asr_tpu_torch.pipelines import loco_experiment

    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        assert loco_experiment.main(["--out_dir", out, "--stage", "asr", "--skip_training",
                                     "--fusion_weights", "1.0", "--device", "cpu"]) == 0
    finally:
        torch.set_num_threads(n)


def test_decode_of_two_recordings_gives_the_recorded_hypotheses(tmp_path, monkeypatch):
    _decode_two_recordings(tmp_path, monkeypatch, "fixture")


def test_decode_of_two_recordings_from_the_orbax_steps(tmp_path, monkeypatch):
    _decode_two_recordings(tmp_path, monkeypatch, "orbax")


def _decode_two_recordings(tmp_path, monkeypatch, source: str) -> None:
    _two_recordings(monkeypatch)
    out = _stage_out(tmp_path, source)
    _run_port(out)
    with open(os.path.join(out, "asr_hyps.json")) as f:
        got = json.load(f)
    with open(os.path.join(EXP, "asr_hyps.json")) as f:
        recorded = json.load(f)
    assert len(got) == 20
    assert len({uid.split("-")[0] for uid in got}) == 2
    for uid, hyps in got.items():
        assert hyps["ref"] == recorded[uid]["ref"], uid
        for label in LABELS:
            assert hyps[label] == recorded[uid][label], (uid, label)


def test_trainers_match_without_random_streams(tmp_path):
    """The experiment's ASR recipe (``train_asr --tiny``, its conv front end,
    lr 1e-3, AdamW with warmup and cosine decay) in both packages from the
    shared init, with dropout and SpecAugment off: the same parameters
    after 12 steps over 4 epochs of a small corpus.  The packages part only
    in the random streams those two draw from."""
    from loco_asr_tpu.pipelines import train_asr as jtrain
    from loco_asr_tpu_torch.data.synthetic_conversations import make_asr_corpus
    from loco_asr_tpu_torch.pipelines import train_asr as ttrain

    tr_dir, _ = make_asr_corpus(str(tmp_path / "corpus"), n_train=3, n_dev=1, n_utts=3,
                                seed=0)
    over = {"conv_dim": [64, 64, 64], "conv_stride": [5, 4, 2], "conv_kernel": [10, 8, 4],
            "max_speech_positions": 2048, "hidden_dropout": 0.0, "attention_dropout": 0.0,
            "activation_dropout": 0.0, "positional_dropout": 0.0,
            "apply_spec_augment": False}
    (tmp_path / "cfg.json").write_text(json.dumps(over))
    argv = ["--config_json", str(tmp_path / "cfg.json"), "--train_dir", tr_dir, "--tiny",
            "--tokenizer", "char", "--batch_size", "4", "--steps", "12",
            "--warmup_steps", "4", "--max_seconds", "4.0", "--eval_every", "100",
            "--save_every", "12", "--lr", "1e-3", "--seed", "0", "--mesh", "1,1,1",
            "--checkpoint", os.path.join(FIXTURE, "asr_init.npz")]
    assert jtrain.main([*argv, "--out_dir", str(tmp_path / "jax")]) == 0
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        assert ttrain.main([*argv, "--out_dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    finally:
        torch.set_num_threads(n)
    from loco_asr_tpu.utils.checkpoint import Checkpointer
    from loco_asr_tpu.utils.pytree import flatten_with_paths

    want = flatten_with_paths(Checkpointer(str(tmp_path / "jax" / "ckpt")).restore(12)["params"])
    assert len(want) == 102
    with np.load(tmp_path / "port/ckpt/step_12.npz") as got, \
            np.load(os.path.join(FIXTURE, "asr_init.npz")) as init:
        assert max(float(np.abs(np.asarray(v) - init[k]).max()) for k, v in want.items()) > 1e-3
        for k, v in want.items():
            if k.endswith("k_proj.bias"):
                # the softmax cancels a key bias: its gradient is rounding
                # noise, which Adam normalises; both stay within lr a step
                for p in (got[f"params.{k}"], np.asarray(v)):
                    assert float(np.abs(p - init[k]).max()) <= 12 * 1e-3, k
                continue
            np.testing.assert_allclose(got[f"params.{k}"], np.asarray(v), atol=1e-5, rtol=1e-4,
                                       err_msg=k)


def _close_means(a, b, what: str) -> None:
    """Two samples' means within 5 standard errors of their difference."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    se = np.sqrt(a.var() / a.size + b.var() / b.size)
    assert abs(a.mean() - b.mean()) <= 5 * se, (what, a.mean(), b.mean(), se)


def _mask_stats(mask: np.ndarray, lengths: np.ndarray) -> dict:
    """Per-row SpecAugment statistics of [rows, T] masks: the masked share
    of the valid frames, the number of masked runs (overlapping spans
    merge), the first masked frame over the length, and every run's
    length."""
    edges = np.diff(np.pad(mask.astype(np.int8), ((0, 0), (1, 1))), axis=1)
    starts, ends = edges == 1, edges == -1
    first = np.where(mask.any(1), mask.argmax(1), lengths) / lengths
    return dict(share=mask.sum(1) / lengths, runs=starts.sum(1), first=first,
                run_len=np.nonzero(ends.ravel())[0] - np.nonzero(starts.ravel())[0])


def test_random_streams_match_in_distribution(tmp_path, monkeypatch):
    """The streams the two trainers do not share, at the experiment's ASR
    recipe: a batch of 8 of its corpus, its config, dense attention.

    * Two training forwards (``asr_loss``) a package, from the shared
      init and each package's per-step streams (the JAX rbg key split a
      step, as ``train_asr`` splits it; one seeded ``torch.Generator``):
      the same dropout sites (rate and size), each site's keep rate within
      5 binomial standard errors of 1 - rate and its kept entries scaled by
      1 / (1 - rate); one SpecAugment draw a step at the same arguments, a
      new mask every step.
    * SpecAugment at those arguments over 40000 rows a package: the masked
      share, runs a row, first masked frame and run lengths agree in mean
      within 5 standard errors, and the run-length histogram bin by bin."""
    import jax
    import jax.numpy as jnp
    from loco_asr_tpu.models.speecht5 import model as jst5
    from loco_asr_tpu.models.speecht5 import prenets as jprenets
    from loco_asr_tpu.models.speecht5.config import tiny_config as jtiny
    from loco_asr_tpu.ops import audio as jaudio
    from loco_asr_tpu.ops import layers as jlayers
    from loco_asr_tpu.utils.pytree import unflatten_from_paths
    from loco_asr_tpu_torch.data.asr_dataset import KaldiAsrDataset
    from loco_asr_tpu_torch.data.synthetic_conversations import make_asr_corpus
    from loco_asr_tpu_torch.models.speecht5 import convert
    from loco_asr_tpu_torch.models.speecht5 import model as tst5
    from loco_asr_tpu_torch.models.speecht5 import prenets as tprenets
    from loco_asr_tpu_torch.models.speecht5.config import tiny_config as ttiny
    from loco_asr_tpu_torch.ops import audio as taudio
    from loco_asr_tpu_torch.ops import layers as tlayers

    tr_dir, _ = make_asr_corpus(str(tmp_path / "corpus"), n_train=3, n_dev=1, n_utts=3,
                                seed=0)
    ds = KaldiAsrDataset(tr_dir)
    wavs = [ds.load_waveform(e)[:64000] for e in ds.examples[:8]]
    wav = np.zeros((8, max(len(w) for w in wavs)), np.float32)
    mask = np.zeros(wav.shape, np.int32)
    for i, w in enumerate(wavs):
        wav[i, :len(w)], mask[i, :len(w)] = w, 1
    labels = np.random.default_rng(0).integers(4, 100, (8, 40))
    labels[:, 30:] = -100
    init = os.path.join(FIXTURE, "asr_init.npz")
    jcfg, tcfg = loco_asr_config(jtiny), loco_asr_config(ttiny)
    assert tcfg.mask_time_prob > 0 and tcfg.hidden_dropout > 0

    draws = {"jax": [], "port": []}
    specs = {"jax": [], "port": []}

    def record(pkg, rate, kept, nonzero, scale_err):
        draws[pkg].append((rate, int(nonzero), int(kept), float(scale_err)))

    def jdropout(rng, x, rate, deterministic):
        out = real_jdropout(rng, x, rate, deterministic)
        if out is not x:
            keep = 1.0 - rate
            jax.debug.callback(lambda *a: record("jax", rate, *a), jnp.sum(out != 0),
                               jnp.sum(x != 0),
                               jnp.max(jnp.where(out != 0, jnp.abs(out * keep - x), 0.0)))
        return out

    def tdropout(x, p, generator, training):
        out = real_tdropout(x, p, generator, training)
        if out is not x:
            keep = 1.0 - p
            record("port", p, (out != 0).sum(), (x != 0).sum(),
                   torch.where(out != 0, (out * keep - x).abs(), 0.0).max())
        return out

    def jmask(rng, shape, prob, length, lengths=None, min_masks=0):
        m = real_jmask(rng, shape, prob, length, lengths, min_masks)
        jax.debug.callback(lambda mm, ll: specs["jax"].append(
            ((tuple(shape), prob, length, min_masks), np.asarray(ll), np.asarray(mm))),
            m, lengths)
        return m

    def tmask(generator, shape, prob, length, lengths=None, min_masks=0, **kw):
        m = real_tmask(generator, shape, prob, length, lengths, min_masks, **kw)
        specs["port"].append(((tuple(shape), prob, length, min_masks),
                              lengths.numpy(), m.numpy()))
        return m

    real_jdropout, real_tdropout = jlayers.dropout, tlayers.dropout
    real_jmask, real_tmask = jprenets.compute_mask_indices, tprenets.compute_mask_indices
    monkeypatch.setattr(jlayers, "dropout", jdropout)
    monkeypatch.setattr(tlayers, "dropout", tdropout)
    monkeypatch.setattr(jprenets, "compute_mask_indices", jmask)
    monkeypatch.setattr(tprenets, "compute_mask_indices", tmask)

    steps = 2
    with np.load(init) as z:
        jparams = unflatten_from_paths({k: jnp.asarray(z[k]) for k in z.files})
    jloss = jax.jit(lambda p, w, m, y, r: jst5.asr_loss(p, jcfg, w, m, y, deterministic=False,
                                                        rng=r, attn_impl="dense"))
    rng = jax.random.key(0, impl="rbg")
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        jax.block_until_ready(jloss(jparams, wav, mask, labels, sub))
    jax.effects_barrier()
    model = tst5.asr_model_init(tcfg, device="cpu")
    with np.load(init) as z:
        model.load_state_dict(convert.asr_from_jax_params(dict(z), tcfg), strict=True)
    model.train()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for _ in range(steps):
            tst5.asr_loss(model, torch.from_numpy(wav), torch.from_numpy(mask),
                          torch.from_numpy(labels), generator=gen, attn_impl="dense")

    # dropout: the same sites, keep rates and scaling
    sites = {pkg: sorted((r, n) for r, n, _, _ in d) for pkg, d in draws.items()}
    assert len(draws["port"]) == len(draws["jax"]) > 0
    assert sites["port"] == sites["jax"]
    for pkg, d in draws.items():
        for rate, nonzero, kept, scale_err in d:
            keep = 1.0 - rate
            se = np.sqrt(keep * rate / nonzero)
            assert abs(kept / nonzero - keep) <= 5 * se, (pkg, rate, nonzero, kept)
            assert scale_err <= 1e-5, (pkg, rate, scale_err)
    # SpecAugment: one draw a step at the same arguments, a new one each step
    for pkg in specs:
        assert len(specs[pkg]) == steps, pkg
        masks = [m for _, _, m in specs[pkg]]
        assert all(not np.array_equal(masks[i], masks[i + 1]) for i in range(steps - 1)), pkg
    (args, lengths, _), (targs, tlengths, _) = specs["jax"][0], specs["port"][0]
    assert args == targs
    np.testing.assert_array_equal(lengths, tlengths)

    # SpecAugment's distribution over 40000 rows at those arguments, drawn
    # 4000 rows at a time
    (b, t), prob, length, min_masks = args
    rows = np.tile(lengths, 500)
    jstats, tstats = [], []
    for chunk in range(1, 11):
        jm = np.asarray(real_jmask(jax.random.key(chunk, impl="rbg"), (rows.size, t), prob,
                                   length, jnp.asarray(rows), min_masks))
        tm = real_tmask(torch.Generator().manual_seed(chunk), (rows.size, t), prob, length,
                        torch.from_numpy(rows), min_masks).numpy()
        jstats.append(_mask_stats(jm, rows))
        tstats.append(_mask_stats(tm, rows))
    js, ts = ({k: np.concatenate([s[k] for s in stats]) for k in stats[0]}
              for stats in (jstats, tstats))
    for key in js:
        _close_means(js[key], ts[key], key)
    assert 0.5 * prob < js["share"].mean() < 2 * prob
    bins = [length, length + 1, 2 * length, 3 * length, t + 1]
    jh, _ = np.histogram(js["run_len"], bins)
    th, _ = np.histogram(ts["run_len"], bins)
    jp, tp = jh / jh.sum(), th / th.sum()
    se = np.sqrt(jp * (1 - jp) / jh.sum() + tp * (1 - tp) / th.sum())
    assert (np.abs(jp - tp) <= 5 * se + 1e-12).all(), (jp, tp)


@pytest.mark.slow
@pytest.mark.parametrize("source", ["fixture", "orbax"])
def test_decode_of_all_recordings_reproduces_the_recorded_results(tmp_path, source):
    out = _stage_out(tmp_path, source)
    _run_port(out)
    with open(os.path.join(out, "results.json")) as f:
        got = json.load(f)["asr"]
    with open(os.path.join(EXP, "results.json")) as f:
        want = json.load(f)["asr"]
    for label in LABELS:
        assert got[label].keys() == want[label].keys(), label
        for key, value in want[label].items():
            assert got[label][key] == pytest.approx(value, abs=1e-12), (label, key)
    with open(os.path.join(out, "asr_hyps.json")) as f:
        assert len(json.load(f)) == 120


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    write_fixture(sys.argv[1] if len(sys.argv) > 1 else FIXTURE)
