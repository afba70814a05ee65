"""The port's sharded training steps (``make_asr_train_step`` /
``make_lm_train_step`` with ``mesh=``) on 4 gloo ranks against the JAX
package's sharded steps on 4 of the virtual CPU devices, from the same
JAX init and batch, dropout off:

* ASR under (2, 1, 2) with ``grad_accum`` 2 and ``freeze_feature_encoder``
  and under (1, 2, 2) plain, each with AdamW and Adafactor; LM (GPT-2,
  tensor-parallel ``c_attn``) under both meshes.  Loss within 1e-5
  (relative), ``grad_norm`` within 1e-5 (relative), every gathered
  gradient within atol 1e-5 (rtol 1e-4), the same token count, and every
  gathered parameter's update (new - old) against JAX's update of the same
  parameter: within 1e-6 wherever |gradient| > 1e-6 (measured: 1.2e-7
  under AdamW, 1.5e-8 under Adafactor; these entries are at least 90% of
  the model's, and each of their updates is about lr = 1e-4, so a step
  that applies no update or the wrong sign fails by ~1e-4), and within
  2e-4 elsewhere: AdamW's and Adafactor's first update is lr * g / (|g| +
  eps) per entry, within lr of zero whatever g is, so where a gradient is
  rounding-level two correct steps differ by up to 2 lr (the JAX sharded
  tests' own bound; measured 1.3e-5 under AdamW, 1.0e-4 under
  Adafactor).  The attention key biases, whose exact gradient is 0, are
  held to a rounding-level gradient instead (each side steps them by the
  sign of its noise).
* The port's sharded step against its own single-device step with dropout
  and SpecAugment on (the same generator draws the same masks, at their
  global shapes), dense and flash, ASR and LM, ``remat`` too, with plain
  gradient descent (lr 1e-2): loss within 1e-5 (relative), gradients and
  parameters after the step within 1e-5.
* bf16 compute (LM, (1, 2, 2)): the sharded step as close to the float32
  step as the single-device bf16 step is.
* Adafactor's factored row / column statistics and block RMS on sharded
  matrices equal the single-device optimizer's."""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import optax

import torch_dist_worker as worker
from loco_asr_tpu.models.gpt2 import model as jg
from loco_asr_tpu.models.speecht5 import model as jm
from loco_asr_tpu.models.speecht5.config import SpeechT5Config as JConfig
from loco_asr_tpu.parallel import mesh as jmesh, partition as jpart, train as jtrain
from loco_asr_tpu.utils.pytree import flatten_with_paths
from loco_asr_tpu_torch.models.gpt2 import model as tg
from loco_asr_tpu_torch.models.speecht5 import convert
from loco_asr_tpu_torch.models.speecht5 import model as tm
from loco_asr_tpu_torch.parallel import train as ttrain

JAX_CASES = [  # name, kind, mesh, port step kwargs
    ("asr_212_adamw", "asr", (2, 1, 2), dict(grad_accum=2, freeze_feature_encoder=True)),
    ("asr_212_adafactor", "asr", (2, 1, 2),
     dict(grad_accum=2, freeze_feature_encoder=True, optimizer="adafactor")),
    ("asr_122_adamw", "asr", (1, 2, 2), dict()),
    ("asr_122_adafactor", "asr", (1, 2, 2), dict(optimizer="adafactor")),
    ("lm_212", "lm", (2, 1, 2), dict()),
    ("lm_122", "lm", (1, 2, 2), dict()),
]
DROPOUT_CASES = [
    ("asr_drop_122_flash", "asr", (1, 2, 2), dict(attn_impl="flash")),
    ("asr_drop_212_dense", "asr", (2, 1, 2), dict(grad_accum=2)),
    ("asr_drop_212_remat", "asr", (2, 1, 2), dict(attn_impl="flash", remat="full")),
    ("lm_drop_122_flash", "lm", (1, 2, 2), dict(attn_impl="flash")),
    ("lm_drop_212_dense", "lm", (2, 1, 2), dict(grad_accum=2)),
]
# mixed precision: the LM step with bf16 compute (kernel B6's bf16 form's
# plain version on the CPU), dropout on
BF16_CASE = ("lm_bf16_122_flash", "lm", (1, 2, 2),
             dict(attn_impl="flash", compute_dtype=torch.bfloat16))
LR = 1e-4
G_FLOOR = 1e-6     # |gradient| above which its sign is the same on both sides
UPD_TOL = 1e-6     # measured: 1.2e-7 (AdamW), 1.5e-8 (Adafactor)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """JAX inits and batches (6 ASR rows, padded to 8 under dp x accum 4;
    5 LM rows, padded to 6 under dp 2), and the port's results."""
    out = str(tmp_path_factory.mktemp("sharded"))
    asr_cfg = worker._tiny_asr_cfg()
    jcfg = JConfig(**dataclasses.asdict(asr_cfg))
    lm_cfg = worker._tiny_gpt2_cfg()
    jlm_cfg = jg.GPT2Config(**dataclasses.asdict(lm_cfg))
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal((6, 1600)) * 0.1).astype(np.float32)
    mask = np.ones((6, 1600), np.int32)
    mask[1, 1100:] = 0
    mask[4, 700:] = 0
    labels = rng.integers(3, asr_cfg.vocab_size, (6, 7))
    labels[1, 4:] = -100
    labels[5, 2:] = -100
    ids = rng.integers(0, lm_cfg.vocab_size, (5, 32))
    data = {"asr_params": {k: np.asarray(v) for k, v in flatten_with_paths(
                jm.asr_init(jax.random.PRNGKey(0), jcfg)).items()},
            "asr_batch": {"input_values": wav, "attention_mask": mask, "labels": labels},
            "lm_params": {k: np.asarray(v) for k, v in flatten_with_paths(
                jg.gpt2_init(jax.random.PRNGKey(1), jlm_cfg)).items()},
            "lm_batch": {"ids": ids, "lengths": np.asarray([32, 20, 9, 32, 2])}}
    path = os.path.join(out, "inputs.pt")
    torch.save(data, path)
    cases = JAX_CASES + [(n, k, d, {**kw, "dropout": True, "lr": 1e-2, "optimizer": "sgd"})
                         for n, k, d, kw in DROPOUT_CASES + [BF16_CASE]]
    worker.spawn(out, 4, [("sharded_steps", dict(inputs=path, cases=cases)),
                          ("adafactor_factored", {})])
    port = torch.load(os.path.join(out, "sharded_steps.rank0.pt"), weights_only=False)
    for r in (1, 2, 3):      # every rank ends with the same gathered state
        other = torch.load(os.path.join(out, f"sharded_steps.rank{r}.pt"), weights_only=False)
        for name in port:
            assert other[name]["loss"] == port[name]["loss"]
            for k, v in port[name]["params"].items():
                assert torch.equal(other[name]["params"][k], v), (r, name, k)
    return dict(data=data, jcfg=jcfg, jlm_cfg=jlm_cfg, port=port, out=out)


def _jax_step(inputs, kind, dims, kw):
    """JAX's sharded step with an identity optimizer: (metrics, grads)."""
    data = inputs["data"]
    mesh = jmesh.make_mesh(*dims, devices=jax.devices()[:4])
    tree = lambda flat: jax.tree_util.tree_map(jnp.asarray, _unflatten(flat))
    accum = kw.get("grad_accum", 1)
    if kind == "asr":
        params = tree(data["asr_params"])
        step = jtrain.make_asr_train_step(
            inputs["jcfg"], mesh, optax.identity(), donate=False, grad_accum=accum,
            freeze_feature_encoder=kw.get("freeze_feature_encoder", False))
        batch = data["asr_batch"]
    else:
        params = tree(data["lm_params"])
        step = jtrain.make_lm_train_step(inputs["jlm_cfg"], mesh, optax.identity(),
                                         donate=False, grad_accum=accum)
        batch = data["lm_batch"]
    sharded = jpart.shard_params(params, mesh)
    b = jtrain.shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh,
                           grad_accum=accum)
    p_plus_g, _, m = step(sharded, (), b, jax.random.PRNGKey(1))
    grads = jax.tree_util.tree_map(lambda a, c: a - c, jax.device_get(p_plus_g),
                                   jax.device_get(params))
    return params, m, grads


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _names(kind):
    if kind == "asr":
        with torch.device("meta"):
            return convert.jax_names(tm.AsrModel(worker._tiny_asr_cfg()))
    from loco_asr_tpu_torch.models.gpt2 import convert as gconvert
    with torch.device("meta"):
        return gconvert.jax_names(tg.GPT2Model(worker._tiny_gpt2_cfg()))


@pytest.mark.parametrize("case", range(len(JAX_CASES)))
def test_sharded_step_matches_jax_sharded_step(inputs, case):
    name, kind, dims, kw = JAX_CASES[case]
    got = inputs["port"][name]
    params, m, grads = _jax_step(inputs, kind, dims, kw)
    np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], float(m["grad_norm"]), rtol=1e-5)
    assert got["ntokens"] == int(m["ntokens"])
    jtx = jtrain.adafactor(LR) if kw.get("optimizer") == "adafactor" else jtrain.adamw(LR)
    updates, _ = jtx.update(grads, jtx.init(params), params)
    if kw.get("freeze_feature_encoder"):
        updates = jtrain._zero_feature_encoder_updates(updates)
    new = {k: np.asarray(v) for k, v in flatten_with_paths(
        optax.apply_updates(params, updates)).items()}
    grads = {k: np.asarray(v) for k, v in flatten_with_paths(grads).items()}
    olds = {k: np.asarray(v) for k, v in flatten_with_paths(params).items()}
    held = total = 0
    for pname, (key, transpose) in _names(kind).items():
        g, p = got["grads"][pname], got["params"][pname]
        g, p = (g.t(), p.t()) if transpose else (g, p)
        np.testing.assert_allclose(g.numpy(), grads[key], atol=1e-5, rtol=1e-4,
                                   err_msg=f"grad {key}")
        if key.endswith("k_proj.bias"):
            # exact gradient 0 (the softmax cancels a per-query shift): both
            # step it by the sign of their rounding noise
            assert np.abs(grads[key]).max() <= 1e-8 and g.abs().max() <= 1e-8, key
            continue
        # the step's update (new - old) against JAX's: within UPD_TOL where
        # the gradient is above rounding level (there each update is about
        # lr, so a missing or sign-flipped update misses by ~lr), within
        # 2 lr elsewhere (each side steps by the sign of its own noise)
        upd, jupd = p.numpy() - olds[key], new[key] - olds[key]
        big = np.abs(grads[key]) > G_FLOOR
        np.testing.assert_allclose(upd[big], jupd[big], atol=UPD_TOL, rtol=0,
                                   err_msg=f"update {key}")
        np.testing.assert_allclose(upd, jupd, atol=2 * LR, rtol=0, err_msg=f"update {key}")
        held += int(big.sum())
        total += big.size
    assert held >= 0.9 * total, (held, total)


def _single_step(inputs, kind, kw):
    """The port's single-device step on the same init, batch and generator
    (dropout on)."""
    data = inputs["data"]
    kw = dict(kw)
    accum = kw.get("grad_accum", 1)
    if kind == "asr":
        cfg = worker._tiny_asr_cfg(dropout=True)
        model = tm.AsrModel(cfg)
        model.load_state_dict(convert.asr_from_jax_params(data["asr_params"], cfg))
        make, batch, multiple = ttrain.make_asr_train_step, data["asr_batch"], 2 * accum
    else:
        from loco_asr_tpu_torch.models.gpt2 import convert as gconvert
        cfg = worker._tiny_gpt2_cfg(dropout=True)
        model = tg.GPT2Model(cfg)
        model.load_state_dict(gconvert.from_jax_params(data["lm_params"], cfg))
        make, batch, multiple = ttrain.make_lm_train_step, data["lm_batch"], 2 * accum
    kw.pop("remat", None)        # remat changes no number: held to the plain step
    tx = worker.sgd(1e-2)
    opt_state = tx.init(ttrain.trainable_params(model))
    batch = {k: torch.as_tensor(v) for k, v in ttrain.pad_batch(batch, multiple).items()}
    m = make(cfg, tx, **kw)(model, opt_state, batch, torch.Generator().manual_seed(11))
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()}
    return m, grads, model.state_dict()


@pytest.mark.parametrize("case", range(len(DROPOUT_CASES)))
def test_sharded_step_equals_single_device_step_with_dropout(inputs, case):
    name, kind, dims, kw = DROPOUT_CASES[case]
    got = inputs["port"][name]
    m, grads, params = _single_step(inputs, kind, kw)
    np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], float(m["grad_norm"]), rtol=1e-5)
    for k, g in grads.items():
        np.testing.assert_allclose(got["grads"][k].numpy(), g.numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=k)
    for k, p in params.items():
        np.testing.assert_allclose(got["params"][k].numpy(), p.numpy(), atol=1e-5, rtol=0,
                                   err_msg=k)


def test_sharded_bf16_step_is_as_close_to_f32_as_the_single_device_one(inputs):
    """bf16 compute rounds at other points on the mesh (a row-parallel
    layer rounds each rank's partial sum before the all-reduce adds them,
    one device rounds the whole sum once), so the sharded and the
    single-device bf16 steps are two bf16 approximations of the same
    float32 step.  Held: the loss within 1e-4 relative of the single bf16
    step's, and each gradient no farther from the float32 step's than twice
    the single bf16 step's distance (L2 per leaf; measured at most 1.77x)."""
    name, kind, dims, kw = BF16_CASE
    got = inputs["port"][name]
    m, grads, _ = _single_step(inputs, kind, kw)
    _, f32, _ = _single_step(inputs, kind, {k: v for k, v in kw.items()
                                            if k != "compute_dtype"})
    np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-4)
    for k, g in grads.items():
        near = float((got["grads"][k] - f32[k]).norm())
        assert near <= 2 * float((g - f32[k]).norm()), k


def test_adafactor_factored_statistics_match_single_device(inputs):
    rec = torch.load(os.path.join(inputs["out"], "adafactor_factored.rank0.pt"),
                     weights_only=False)
    params = {k: v.clone() for k, v in rec["whole"].items()}
    tx = ttrain.adafactor(1e-2, clip_norm=1.0)
    state = tx.init(params)
    assert {k: v.shape for k, v in state["v_row"].items()} == {
        k: v.shape for k, v in rec["state"]["v_row"].items()}
    for g in rec["grads"]:
        tx.update(params, g, state)
    for key in ("v_row", "v_col", "v"):
        for k, v in state[key].items():
            np.testing.assert_allclose(rec["state"][key][k].numpy(), v.numpy(), rtol=1e-5,
                                       err_msg=f"{key} {k}")
    for k, p in params.items():
        np.testing.assert_allclose(rec["params"][k].numpy(), p.numpy(), atol=1e-6, rtol=1e-5,
                                   err_msg=k)
