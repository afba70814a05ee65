"""Sequence parallelism through the port's models, training steps and
command lines (``parallel/sp.py``), on gloo CPU ranks against the JAX
package on its virtual CPU devices, from numpy-seeded inputs and one JAX
init carried across by the converters:

* the SpeechT5 encoder (each rank's layers on its block of the frames)
  under ring and Ulysses over 2 and 4 ranks: within 2e-5 of JAX's on the
  valid frames; GPT-2 scoring (each rank's block of the window, its
  ``wpe`` rows from its offset, the NLLs across block edges): within 1e-5,
  and on a (data, sequence) = (2, 2) mesh within 1e-4 of the ring's (the
  JAX dry run's bound);
* the ASR and LM training steps under ring and Ulysses against JAX's
  sequence-parallel steps (dropout off): the loss and grad norm within
  1e-5 relative, the token count equal and every parameter's gradient
  within 1e-5, so a replicated part (the prenet, the decoder, the loss)
  counted n times shows; also on (2, 2), with ``grad_accum`` and the dense
  LM loss.  With dropout and SpecAugment on, the step draws the
  single-device step's masks: within 1e-5 of the port's single-device
  flash step, under remat too;
* ``eval_ppl --sequence_parallel 2`` against JAX's CLI (the shrink of a
  ``--max_len`` that 2 does not divide, the pad of short windows, both
  schemes): per-recording PPLs within 1e-5 relative; ``train_asr`` /
  ``train_lm --attn_impl ring|ulysses --sp_devices 2`` against JAX's
  trainers at ``--mesh 2,1,1`` (the mesh JAX needs: the sequence axis's
  devices): each saved parameter's update within 1e-6 on all but 1 % of
  the entries and within 2 lr everywhere (AdamW's first step is the sign
  of a rounding-level gradient), the LM's dev PPL within 1e-4;
* the ("data", "sequence") mesh and the trainers' layout rule."""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh

import torch_dist_worker as dist_worker
import torch_sp_worker as worker
from loco_asr_tpu.models.gpt2 import model as jg
from loco_asr_tpu.models.speecht5 import model as jm
from loco_asr_tpu.models.speecht5.config import SpeechT5Config as JConfig
from loco_asr_tpu.parallel import train as jtrain
from loco_asr_tpu.utils.checkpoint import save_npz
from loco_asr_tpu.utils.pytree import flatten_with_paths
from loco_asr_tpu_torch.models.gpt2 import convert as gconvert, model as tg
from loco_asr_tpu_torch.models.speecht5 import convert, model as tm
from loco_asr_tpu_torch.models.speecht5.config import tiny_config
from loco_asr_tpu_torch.parallel import train as ttrain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "exp", "loco", "asr_corpus", "dev")
LM_TEXT = os.path.join(ROOT, "exp", "loco", "lm_corpus", "dev.txt")
# the 320x conv stride with a last kernel of 1: 50 frames a second, so a
# whole-second window's frame count divides 2 (the base stack's is odd)
CONV = dict(conv_dim=[16] * 7, conv_stride=[5, 2, 2, 2, 2, 2, 2],
            conv_kernel=[10, 3, 3, 3, 3, 2, 1])
LR = 1e-4
UPD_TOL, OFF_SHARE = 1e-6, 0.01

MODEL_CASES = [  # name, kind, impl, (data, sequence)
    ("enc_ring_2", "encoder", "ring", (1, 2)), ("enc_ulysses_2", "encoder", "ulysses", (1, 2)),
    ("enc_ring_4", "encoder", "ring", (1, 4)), ("enc_ulysses_4", "encoder", "ulysses", (1, 4)),
    ("gpt2_ring_2", "gpt2", "ring", (1, 2)), ("gpt2_ulysses_2", "gpt2", "ulysses", (1, 2)),
    ("gpt2_ring_4", "gpt2", "ring", (1, 4)), ("gpt2_ulysses_4", "gpt2", "ulysses", (1, 4)),
    ("gpt2_ring_2x2", "gpt2", "ring", (2, 2)), ("gpt2_ulysses_2x2", "gpt2", "ulysses", (2, 2)),
]
JAX_STEPS = [  # name, kind, (data, sequence), step kwargs
    ("asr_ring_2", "asr", (1, 2), dict(attn_impl="ring")),
    ("asr_ulysses_2", "asr", (1, 2), dict(attn_impl="ulysses")),
    ("asr_ring_4", "asr", (1, 4), dict(attn_impl="ring")),
    ("asr_ring_2x2", "asr", (2, 2), dict(attn_impl="ring")),   # JAX's asr_ring_2
    ("asr_ulysses_accum", "asr", (1, 2), dict(attn_impl="ulysses", grad_accum=2)),
    ("lm_ring_2", "lm", (1, 2), dict(attn_impl="ring")),
    ("lm_ulysses_2", "lm", (1, 2), dict(attn_impl="ulysses")),
    ("lm_ring_4", "lm", (1, 4), dict(attn_impl="ring")),
    ("lm_ulysses_2x2_dense_loss", "lm", (2, 2), dict(attn_impl="ulysses", loss_impl="dense")),
]
DROPOUT_STEPS = [
    ("asr_drop_ring_lite", "asr", (1, 2), dict(attn_impl="ring", remat="lite")),
    ("asr_drop_ulysses_2x2", "asr", (2, 2), dict(attn_impl="ulysses")),
    ("lm_drop_ring_full", "lm", (1, 4), dict(attn_impl="ring", remat="full")),
    ("lm_drop_ulysses_2x2", "lm", (2, 2), dict(attn_impl="ulysses")),
]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The inputs (JAX inits, numpy batches) and the port's records: four
    gloo ranks started once for every model and step case."""
    out = str(tmp_path_factory.mktemp("sp"))
    asr_cfg = dist_worker._tiny_asr_cfg()
    lm_cfg = dist_worker._tiny_gpt2_cfg()
    rng = np.random.default_rng(0)
    n = 1610                                      # 160 frames (the tiny 2-layer stack)
    wav = (rng.standard_normal((4, n)) * 0.1).astype(np.float32)
    mask = np.ones((4, n), np.int32)
    mask[1, 1100:] = 0
    mask[3, 700:] = 0
    labels = rng.integers(3, asr_cfg.vocab_size, (4, 7))
    labels[1, 4:] = -100
    asr_params = {k: np.asarray(v) for k, v in flatten_with_paths(
        jm.asr_init(jax.random.PRNGKey(0), JConfig(**dataclasses.asdict(asr_cfg)))).items()}
    lm_params = {k: np.asarray(v) for k, v in flatten_with_paths(
        jg.gpt2_init(jax.random.PRNGKey(1), jg.GPT2Config(**dataclasses.asdict(lm_cfg)))).items()}
    data = {"asr_params": asr_params, "enc_params": asr_params,
            "enc_batch": {"wav": wav[:2], "mask": mask[:2]},
            "asr_batch": {"input_values": wav, "attention_mask": mask, "labels": labels},
            "lm_params": lm_params, "gpt2_params": lm_params, "gpt2_cfg": lm_cfg,
            "gpt2_ids": rng.integers(0, lm_cfg.vocab_size, (4, 32)),
            "lm_batch": {"ids": rng.integers(0, lm_cfg.vocab_size, (4, 32)),
                         "lengths": np.asarray([32, 20, 9, 32])}}
    path = os.path.join(out, "inputs.pt")
    torch.save(data, path)
    steps = JAX_STEPS + [(name, kind, dims, {**kw, "dropout": True})
                         for name, kind, dims, kw in DROPOUT_STEPS]
    worker.spawn(out, 4, [("sp_models", dict(inputs=path, cases=MODEL_CASES)),
                          ("sp_steps", dict(inputs=path, cases=steps))])
    load = lambda name, r=0: torch.load(os.path.join(out, f"{name}.rank{r}.pt"),
                                        weights_only=False)
    steps_by_rank = [load("sp_steps", r) for r in range(4)]
    for rec in steps_by_rank[1:]:       # every rank ends with the same parameters
        for name in rec:
            for k, v in rec[name]["params"].items():
                assert torch.equal(v, steps_by_rank[0][name]["params"][k]), (name, k)
    return dict(data=data, models=load("sp_models"), steps=steps_by_rank[0],
                asr_cfg=asr_cfg, lm_cfg=lm_cfg)


def _tree(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v)
    return tree


def _sp_mesh(n: int) -> Mesh:
    return Mesh(np.asarray(jax.devices()[:n]), ("sequence",))


@pytest.mark.parametrize("case", [c for c in MODEL_CASES if c[1] == "encoder"],
                         ids=lambda c: c[0])
def test_encoder_matches_jax(results, case):
    name, _, impl, (_, seq) = case
    cfg = JConfig(**dataclasses.asdict(results["asr_cfg"]))
    x = results["data"]["enc_batch"]
    ring = (_sp_mesh(seq), "sequence")
    want, want_mask = jax.jit(lambda p, w, m: jm.encode_speech(
        p, cfg, w, m, attn_impl=impl, ring=ring))(
        _tree(results["data"]["enc_params"]), jnp.asarray(x["wav"]), jnp.asarray(x["mask"]))
    got = results["models"][name]
    valid = np.asarray(want_mask).astype(bool)
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want_mask))
    assert valid.sum() < valid.size             # padded frames in row 1
    np.testing.assert_allclose(got["hidden"].numpy()[valid], np.asarray(want)[valid],
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("case", [c for c in MODEL_CASES if c[1] == "gpt2"],
                         ids=lambda c: c[0])
def test_gpt2_nll_matches_jax(results, case):
    name, _, impl, (_, seq) = case
    cfg = jg.GPT2Config(**dataclasses.asdict(results["lm_cfg"]))
    ids = jnp.asarray(results["data"]["gpt2_ids"])
    ring = (_sp_mesh(seq), "sequence")
    want = jax.jit(lambda p, i: jg.token_nll(jg.gpt2_logits(
        p, cfg, i, attn_impl=impl, ring=ring)[0], i))(_tree(results["data"]["gpt2_params"]), ids)
    got = results["models"][name]["nll"].numpy()
    assert got.shape == want.shape == (4, 31)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


def test_dp_x_sp_scoring_equals_ring(results):
    """DP x SP on one ("data", "sequence") mesh: the rows over data, each
    window over sequence; the NLLs are the ring's over the sequence axis
    alone within 1e-4 (the JAX dry run's bound; measured far below)."""
    ring = results["models"]["gpt2_ring_2"]["nll"].numpy()
    for name in ("gpt2_ring_2x2", "gpt2_ulysses_2x2"):
        np.testing.assert_allclose(results["models"][name]["nll"].numpy(), ring, atol=1e-4)
        assert np.abs(results["models"][name]["nll"].numpy() - ring).max() < 1e-5


_JAX_STEPS: dict = {}


def _jax_sp_step(results, kind, seq, kw):
    """JAX's sequence-parallel step with an identity optimizer: (metrics,
    flat gradients); one run a distinct step (the data axis of the port's
    mesh changes no JAX number)."""
    key = (kind, seq, tuple(sorted(kw.items())))
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = _jax_sp_step_run(results, kind, seq, kw)
    return _JAX_STEPS[key]


def _jax_sp_step_run(results, kind, seq, kw):
    data = results["data"]
    mesh = _sp_mesh(seq)
    common = dict(donate=False, attn_impl=kw["attn_impl"], ring=(mesh, "sequence"),
                  grad_accum=kw.get("grad_accum", 1))
    if kind == "asr":
        params = _tree(data["asr_params"])
        step = jtrain.make_asr_train_step(JConfig(**dataclasses.asdict(results["asr_cfg"])),
                                          mesh, optax.identity(), **common)
        batch = data["asr_batch"]
    else:
        params = _tree(data["lm_params"])
        step = jtrain.make_lm_train_step(jg.GPT2Config(**dataclasses.asdict(results["lm_cfg"])),
                                         mesh, optax.identity(),
                                         loss_impl=kw.get("loss_impl", "chunked"), **common)
        batch = data["lm_batch"]
    p_plus_g, _, m = step(params, (), {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.PRNGKey(1))
    grads = jax.tree_util.tree_map(lambda a, c: a - c, p_plus_g, params)
    return m, {k: np.asarray(v) for k, v in flatten_with_paths(grads).items()}


def _names(results, kind):
    with torch.device("meta"):
        if kind == "asr":
            return convert.jax_names(tm.AsrModel(results["asr_cfg"]))
        return gconvert.jax_names(tg.GPT2Model(results["lm_cfg"]))


@pytest.mark.parametrize("case", JAX_STEPS, ids=lambda c: c[0])
def test_sp_step_matches_jax_sp_step(results, case):
    name, kind, (_, seq), kw = case
    got = results["steps"][name]
    m, grads = _jax_sp_step(results, kind, seq, kw)
    np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], float(m["grad_norm"]), rtol=1e-5)
    assert got["ntokens"] == int(m["ntokens"])
    for pname, (key, transpose) in _names(results, kind).items():
        g = got["grads"][pname]
        g = g.t() if transpose else g
        np.testing.assert_allclose(g.numpy(), grads[key], atol=1e-5, rtol=0, err_msg=key)


@pytest.mark.parametrize("case", DROPOUT_STEPS, ids=lambda c: c[0])
def test_sp_step_equals_single_device_step_with_dropout(results, case):
    """Dropout and SpecAugment on: the sequence-parallel step against the
    port's single-device flash step on the same init, batch and generator
    (flash zeroes the attention-prob dropout as ring and Ulysses do)."""
    name, kind, _, kw = case
    data = results["data"]
    if kind == "asr":
        cfg = dist_worker._tiny_asr_cfg(dropout=True)
        model = tm.AsrModel(cfg)
        model.load_state_dict(convert.asr_from_jax_params(data["asr_params"], cfg))
        make, batch = ttrain.make_asr_train_step, data["asr_batch"]
    else:
        cfg = dist_worker._tiny_gpt2_cfg(dropout=True)
        model = tg.GPT2Model(cfg)
        model.load_state_dict(gconvert.from_jax_params(data["lm_params"], cfg))
        make, batch = ttrain.make_lm_train_step, data["lm_batch"]
    tx = dist_worker.sgd(0.0)
    step = make(cfg, tx, attn_impl="flash")
    m = step(model, tx.init(dict(model.named_parameters())),
             {k: torch.as_tensor(v) for k, v in batch.items()}, torch.Generator().manual_seed(11))
    got = results["steps"][name]
    np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], float(m["grad_norm"]), rtol=1e-5)
    for k, p in model.named_parameters():
        want = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got["grads"][k].numpy(), want.numpy(), atol=1e-5, rtol=0,
                                   err_msg=k)


def test_sp_mesh_and_trainer_layout():
    """``make_sp_mesh`` lays the sequence axis innermost and lets data
    absorb the ranks left over; the trainers' layout follows JAX's."""
    from loco_asr_tpu_torch.parallel import mesh as M
    from loco_asr_tpu_torch.pipelines import common

    m = M.make_sp_mesh(4, devices=range(8))
    assert m.shape == {"data": 2, "sequence": 4}
    np.testing.assert_array_equal(m.devices, np.arange(8).reshape(2, 4))
    assert M.make_sp_mesh(2, 1, devices=range(4)).devices.tolist() == [[0, 1]]
    with pytest.raises(ValueError, match="not divisible by 3"):
        M.make_sp_mesh(3, devices=range(8))
    assert common.sp_layout([-1, 1, 1], 0, 8) == (1, 8)
    assert common.sp_layout([-1, 1, 1], 2, 8) == (4, 2)
    assert common.sp_layout([-1, 1, 1], 2, None) == (1, 2)
    assert common.sp_layout([1, 1, 2], 2, 2) == (1, 2)
    assert common.sp_layout([-1, 2, 1], 2, None) == (1, 2)
    for dims, n, world in (([1, 2, 1], 4, None), ([2, 1, 1], 2, 4), ([-1, 2, 1], 2, 8)):
        with pytest.raises(SystemExit, match="the JAX trainer fails on this combination"):
            common.sp_layout(dims, n, world)


# -- the command lines --------------------------------------------------------

@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("sp_cli")
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
    save_npz(str(root / "asr_init.npz"),
             jm.asr_init(jax.random.PRNGKey(7), JConfig(**dataclasses.asdict(cfg))))
    save_npz(str(root / "lm_init.npz"), jg.gpt2_init(jax.random.PRNGKey(4), jg.tiny_gpt2_config(
        vocab_size=256, n_positions=64, n_embd=32, n_layer=2, n_head=4)))
    save_npz(str(root / "score.npz"), jg.gpt2_init(jax.random.PRNGKey(0), jg.tiny_gpt2_config(
        vocab_size=256, n_positions=64, n_embd=32, n_head=4)))
    return root


def _params(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k.startswith("params.")}


def _jax_params(run_dir):
    from loco_asr_tpu.utils.checkpoint import Checkpointer

    restored = Checkpointer(os.path.join(run_dir, "ckpt")).restore()
    return {f"params.{k}": np.asarray(v, np.float64)
            for k, v in flatten_with_paths(restored["params"]).items()}


def _updates_match(got, want, init_path):
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


@pytest.mark.parametrize("flags", [["--context_type", "indep", "--sp_impl", "ring"],
                                   ["--context_type", "max_len", "--max_len", "63",
                                    "--sp_impl", "ulysses"],
                                   ["--context_type", "streaming", "--max_len", "32"]],
                         ids=["indep_pad_ring", "max_len_shrink_ulysses", "streaming_ring"])
def test_eval_ppl_sequence_parallel_matches_jax(assets, tmp_path, flags, caplog):
    from loco_asr_tpu.pipelines import eval_ppl as jeval
    from loco_asr_tpu_torch.pipelines import eval_ppl as teval

    common = ["-i", LM_TEXT, "--model", "tiny", "--checkpoint", str(assets / "score.npz"),
              "--bsize", "8", "--limit_recordings", "2", "--sequence_parallel", "2", *flags]
    assert jeval.main([*common, "-o", str(tmp_path / "jax")]) == 0
    assert teval.main([*common, "-o", str(tmp_path / "port"), "--device", "cpu"]) == 0
    want, got = (json.loads((tmp_path / run / "rec_id2ppl.json").read_text())
                 for run in ("jax", "port"))
    assert got.keys() == want.keys() and len(got) == 2
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
    if "63" in flags:
        logs = [n for n in os.listdir(tmp_path / "port") if ".log_" in n]
        text = (tmp_path / "port" / logs[0]).read_text()
        assert "--max_len 63 not divisible by --sequence_parallel 2; using 62" in text


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_train_asr_sequence_parallel_matches_jax(assets, tmp_path, impl):
    """Two steps at the tiny size on 3 s windows (150 frames): the port's
    plain command starts its two ranks; JAX trains at ``--mesh 2,1,1``."""
    from loco_asr_tpu.pipelines import train_asr as jtrain_asr
    from loco_asr_tpu_torch.pipelines import train_asr

    common = ["--train_dir", str(assets / "dev"), "--tiny", "--config_json",
              str(assets / "cfg.json"), "--batch_size", "4", "--conversation_seconds", "3",
              "--warmup_steps", "1", "--lr", str(LR), "--save_every", "2", "--steps", "2",
              "--eval_every", "10", "--checkpoint", str(assets / "asr_init.npz"),
              "--attn_impl", impl, "--sp_devices", "2"]
    assert jtrain_asr.main([*common, "--mesh", "2,1,1", "--out_dir", str(tmp_path / "jax")]) == 0
    assert train_asr.main([*common, "--out_dir", str(tmp_path / "port"),
                           "--device", "cpu"]) == 0
    _updates_match(_params(tmp_path / "port" / "ckpt" / "step_2.npz"),
                   _jax_params(tmp_path / "jax"), assets / "asr_init.npz")


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_train_lm_sequence_parallel_matches_jax(assets, tmp_path, monkeypatch, impl):
    """Two steps of the tiny LM, dropout off on both sides; the port's two
    ranks started beforehand, as ``torchrun`` does (the data axis absorbs
    no rank: ``--sp_devices 2`` of 2)."""
    from loco_asr_tpu.pipelines import train_lm as jtrain_lm

    real = jg.tiny_gpt2_config
    monkeypatch.setattr(jg, "tiny_gpt2_config", lambda **kw: real(
        **{**kw, "embd_pdrop": 0.0, "attn_pdrop": 0.0, "resid_pdrop": 0.0}))
    common = ["--train_file", LM_TEXT, "--dev_file", LM_TEXT, "--model", "tiny",
              "--seq_len", "48", "--batch_size", "6", "--steps", "2", "--lr", str(LR),
              "--warmup_steps", "1", "--log_every", "1", "--eval_every", "100",
              "--save_every", "2", "--tiny_n_embd", "32", "--tiny_n_head", "4",
              "--checkpoint", str(assets / "lm_init.npz"), "--attn_impl", impl,
              "--sp_devices", "2"]
    assert jtrain_lm.main([*common, "--mesh", "2,1,1", "--out_dir", str(tmp_path / "jax")]) == 0
    dist_worker.spawn(str(tmp_path), 2, [("pipeline", dict(
        module="loco_asr_tpu_torch.pipelines.train_lm",
        argv=[*common, "--out_dir", str(tmp_path / "port"), "--device", "cpu"],
        patch="gpt2_no_dropout"))])
    _updates_match(_params(tmp_path / "port" / "ckpt" / "step_2.npz"),
                   _jax_params(tmp_path / "jax"), assets / "lm_init.npz")

    def dev_ppl(run):
        with open(tmp_path / run / "metrics.jsonl") as f:
            return [json.loads(line) for line in f if "dev_ppl" in line][-1]["dev_ppl"]

    np.testing.assert_allclose(dev_ppl("port"), dev_ppl("jax"), rtol=1e-4)
