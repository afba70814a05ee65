"""The port's Adafactor (``loco_asr_tpu_torch.parallel.train.adafactor``)
against the JAX package's ``adafactor`` (optax) on the CPU.

Ten steps on factored leaves ([130, 200], [200, 130], [3, 128, 160]) and whole ones
([8, 4], [64], [127, 300]), over the schedule, clipping and weight-decay
settings: parameters and second-moment statistics within 1e-6.  Two ASR
steps (dense attention) and two LM steps (flash: kernel B6's plain
version), every dropout off, against the JAX steps with the same
optimizer: losses rtol 1e-5, parameters atol
1e-5 where the gradient is live (the attention key biases' exact gradient
is 0, so their first updates normalise rounding noise; there each side
need only move by at most lr a step, the rule of
``test_torch_train_lm.py``).  ``grad_accum`` 2 against the full batch, and
the state's ``.npz`` round trip through both packages' ``load_npz``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import optax

from loco_asr_tpu.models.gpt2 import model as jg
from loco_asr_tpu.models.speecht5 import model as jm
from loco_asr_tpu.models.speecht5.config import SpeechT5Config as JConfig
from loco_asr_tpu.parallel import mesh as jmesh
from loco_asr_tpu.parallel import train as jtrain
from loco_asr_tpu.utils import checkpoint as jckpt
from loco_asr_tpu.utils.pytree import flatten_with_paths
from loco_asr_tpu_torch.models.gpt2 import convert as gconvert
from loco_asr_tpu_torch.models.gpt2 import model as tg
from loco_asr_tpu_torch.models.speecht5 import convert
from loco_asr_tpu_torch.models.speecht5 import model as tm
from loco_asr_tpu_torch.models.speecht5.config import tiny_config
from loco_asr_tpu_torch.parallel import train as ttrain
from loco_asr_tpu_torch.utils import checkpoint as tckpt

SHAPES = {"factored": (130, 200), "factored_t": (200, 130), "factored3": (3, 128, 160),
          "small": (8, 4), "vector": (64,), "narrow": (127, 300)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_state_leaves(jst):
    """optax's FactoredState inside the JAX chain, as {stat: {name: array}}."""
    found = []

    def walk(x):
        if hasattr(x, "v_row") and hasattr(x, "v_col"):
            found.append(x)
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
    walk(jst)
    (state,) = found
    return {k: {n: np.asarray(v) for n, v in getattr(state, k).items()}
            for k in ("v_row", "v_col", "v")}


@pytest.mark.parametrize("kw", [
    dict(learning_rate=1e-2),
    dict(learning_rate=1e-2, weight_decay=0.1, warmup_steps=3, total_steps=10),
    dict(learning_rate=3e-2, weight_decay=0.0, clip_norm=1.0, total_steps=10),
], ids=["constant", "warmup_decay", "clip_no_decay"])
def test_adafactor_matches_optax_over_ten_steps(kw):
    rng = np.random.default_rng(0)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * (3.0 if i % 3 == 1 else 0.05)).astype(np.float32)
              for k, s in SHAPES.items()} for i in range(10)]
    jtx = jtrain.adafactor(**kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jst = jtx.init(jp)
    tx = ttrain.adafactor(**kw)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    tst = tx.init(tp)
    assert [ttrain.Adafactor.factored_dims(s) for s in SHAPES.values()] == \
        [(0, 1), (1, 0), (1, 2), None, None, None]
    for g in grads:
        upd, jst = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
        jp = optax.apply_updates(jp, upd)
        tx.update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, tst)
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6,
                                       rtol=1e-6, err_msg=k)
    assert tst["count"] == 10
    for stat, leaves in _jax_state_leaves(jst).items():
        for k, want in leaves.items():
            assert tst[stat][k].shape == want.shape, (stat, k)
            np.testing.assert_allclose(tst[stat][k].numpy(), want, rtol=1e-5, atol=1e-30,
                                       err_msg=f"{stat} {k}")


def _hold_params(got, want, init, live, lr, what):
    """``got`` to ``want`` at atol 1e-5 where ``live``, else each side within
    two steps of lr (plus the decay's share) of the init."""
    np.testing.assert_allclose(got[live], want[live], atol=1e-5, rtol=0, err_msg=what)
    for moved in (got[~live], want[~live]):
        assert np.all(np.abs(moved - init[~live])
                      <= 2 * lr * (1 + 0.01 * np.abs(init[~live])) + 1e-7), what


def _asr_setup():
    cfg = dataclasses.replace(tiny_config(), positional_dropout=0.0, hidden_dropout=0.0,
                              attention_dropout=0.0, activation_dropout=0.0,
                              feat_proj_dropout=0.0, apply_spec_augment=False)
    jcfg = JConfig(**dataclasses.asdict(cfg))
    params = jm.asr_init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal((4, 1600)) * 0.1).astype(np.float32)
    mask = np.ones((4, 1600), np.int32)
    mask[1, 1100:] = 0
    labels = rng.integers(3, cfg.vocab_size, (4, 7))
    labels[1, 4:] = -100
    return cfg, jcfg, params, {"input_values": wav, "attention_mask": mask, "labels": labels}


def _lm_setup():
    jcfg = jg.tiny_gpt2_config(vocab_size=61, n_positions=32, n_embd=128, n_layer=2,
                               n_head=2, embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)
    params = jg.gpt2_init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 61, (4, 24)).astype(np.int32)
    return jcfg, params, {"ids": ids, "lengths": np.asarray([24, 17, 5, 9], np.int32)}


@pytest.mark.parametrize("model_kind", ["asr", "lm"])
def test_train_step_with_adafactor_matches_jax(model_kind):
    lr = 1e-3
    kw = dict(learning_rate=lr, weight_decay=0.01, warmup_steps=1, total_steps=4)
    mesh = jmesh.make_mesh(data=1)
    tx = ttrain.adafactor(**kw)
    if model_kind == "asr":
        cfg, jcfg, params, batch = _asr_setup()
        make_j = lambda tx: jtrain.make_asr_train_step(jcfg, mesh, tx, donate=False)
        model = tm.AsrModel(cfg)
        flat = {k: np.asarray(v) for k, v in flatten_with_paths(params).items()}
        model.load_state_dict(convert.asr_from_jax_params(flat, cfg), strict=True)
        step = ttrain.make_asr_train_step(cfg, tx)
        to_jax = convert.asr_to_jax_params
        tparams = ttrain.trainable_params(model)
    else:
        jcfg, params, batch = _lm_setup()
        make_j = lambda tx: jtrain.make_lm_train_step(jcfg, mesh, tx, donate=False,
                                                      attn_impl="flash")
        flat = {k: np.asarray(v) for k, v in flatten_with_paths(params).items()}
        cfg = tg.GPT2Config(**jcfg.__dict__)
        model = tg.GPT2Model(cfg)
        model.load_state_dict(gconvert.from_jax_params(flat, cfg), strict=True)
        step = ttrain.make_lm_train_step(cfg, tx, attn_impl="flash")
        to_jax = gconvert.to_jax_params
        tparams = dict(model.named_parameters())
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    # the live entries: where the first step's gradient is not rounding noise
    p_plus_g, _, _ = make_j(optax.identity())(params, (), jb, jax.random.PRNGKey(1))
    moved = flatten_with_paths(p_plus_g)
    live = {k: np.abs(np.asarray(moved[k]) - v) >= 1e-6 for k, v in flat.items()}
    jtx = jtrain.adafactor(**kw)
    jstep, jp, jst = make_j(jtx), params, jtx.init(params)
    tx_state = tx.init(tparams)
    for _ in range(2):
        jp, jst, jmet = jstep(jp, jst, jb, jax.random.PRNGKey(1))
        met = step(model, tx_state, {k: torch.from_numpy(np.asarray(v))
                                     for k, v in batch.items()})
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-5)
    assert tx_state["count"] == 2
    got, want = to_jax(model), {k: np.asarray(v) for k, v in flatten_with_paths(jp).items()}
    assert sorted(got) == sorted(want)
    for key in want:
        _hold_params(got[key], want[key], flat[key], live[key], lr, key)
    n_dead = sum(int((~m).sum()) for m in live.values())
    assert n_dead <= 0.05 * sum(m.size for m in live.values())


def test_grad_accum_two_equals_full_batch_under_adafactor():
    cfg, jcfg, params, batch = _asr_setup()
    flat = {k: np.asarray(v) for k, v in flatten_with_paths(params).items()}
    out = []
    for accum in (1, 2):
        model = tm.AsrModel(cfg)
        model.load_state_dict(convert.asr_from_jax_params(flat, cfg), strict=True)
        tx = ttrain.adafactor(1e-3)
        state = tx.init(ttrain.trainable_params(model))
        step = ttrain.make_asr_train_step(cfg, tx, grad_accum=accum)
        met = step(model, state, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
        out.append((float(met["loss"]), convert.asr_to_jax_params(model)))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-6)
    for key, want in out[0][1].items():
        if key.endswith("k_proj.bias"):   # steps by the signs of rounding noise
            continue
        np.testing.assert_allclose(out[1][1][key], want, atol=2e-6, err_msg=key)


def test_adafactor_state_npz_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    tp = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for k, s in SHAPES.items()}
    tx = ttrain.adafactor(1e-2)
    state = tx.init(tp)
    for _ in range(3):
        tx.update(tp, {k: torch.randn(p.shape) for k, p in tp.items()}, state)
    path = str(tmp_path / "step_3.npz")
    tckpt.save_npz(path, {"opt_state": state})
    jread = jckpt.load_npz(path)["opt_state"]
    assert int(jread["count"]) == 3
    for stat in ("v_row", "v_col", "v"):
        for k, t in state[stat].items():
            np.testing.assert_array_equal(np.asarray(jread[stat][k]), t.numpy())
    back = tx.init(tp)
    ttrain.load_opt_state(back, tckpt.load_npz(path)["opt_state"])
    assert back["count"] == 3
    for stat in ("v_row", "v_col", "v"):
        for k, t in state[stat].items():
            assert torch.equal(back[stat][k], t), (stat, k)
