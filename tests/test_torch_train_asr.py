"""The port's ASR training step (loco_asr_tpu_torch.parallel.train) against
the JAX package's ``make_asr_train_step`` on the same weights (carried by
the bridge) and batch, with every dropout off, under dense and flash
attention: loss to 1e-5, gradients to atol 1e-5 / rtol 1e-4, updated
parameters to the JAX test's rtol 2e-3 / atol 2e-4 (sums run in another
order on the two sides).  Also: sum-form ``grad_accum``, the frozen feature
encoder, the attention-dropout warning, the decoder's flash refusals, and
the port's AdamW against optax."""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import optax

from loco_asr_tpu.models.speecht5 import model as jm
from loco_asr_tpu.models.speecht5.config import SpeechT5Config as JConfig
from loco_asr_tpu.parallel import mesh as jmesh
from loco_asr_tpu.parallel import train as jtrain
from loco_asr_tpu.utils.pytree import flatten_with_paths
from loco_asr_tpu_torch.models.speecht5 import convert
from loco_asr_tpu_torch.models.speecht5 import decoder as tdec
from loco_asr_tpu_torch.models.speecht5 import model as tm
from loco_asr_tpu_torch.models.speecht5.config import tiny_config
from loco_asr_tpu_torch.parallel import train as ttrain


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_dropout(cfg):
    return dataclasses.replace(
        cfg, positional_dropout=0.0, hidden_dropout=0.0, attention_dropout=0.0,
        activation_dropout=0.0, feat_proj_dropout=0.0, apply_spec_augment=False)


@pytest.fixture(scope="module")
def setup():
    cfg = _no_dropout(tiny_config())
    jcfg = JConfig(**dataclasses.asdict(cfg))
    params = jm.asr_init(jax.random.PRNGKey(0), jcfg)
    flat = {k: np.asarray(v) for k, v in flatten_with_paths(params).items()}
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal((4, 1600)) * 0.1).astype(np.float32)
    mask = np.ones((4, 1600), np.int32)
    mask[1, 1100:] = 0
    mask[3, 1300:] = 0
    labels = rng.integers(3, cfg.vocab_size, (4, 7))
    labels[1, 4:] = -100
    labels[2, 6:] = -100
    batch = {"input_values": wav, "attention_mask": mask, "labels": labels}
    return cfg, jcfg, params, flat, batch


def _port_model(cfg, flat):
    model = tm.AsrModel(cfg)
    model.load_state_dict(convert.asr_from_jax_params(flat, cfg))
    return model


def _tbatch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_train_step_matches_jax(setup, impl):
    cfg, jcfg, params, flat, batch = setup
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    # JAX's step with an identity optimizer returns params + grads, so one
    # compiled step gives the gradients; AdamW is then applied to them
    jstep = jtrain.make_asr_train_step(jcfg, jmesh.make_mesh(data=1), optax.identity(),
                                       donate=False, attn_impl=impl)
    p_plus_g, _, jmet = jstep(params, (), jb, jax.random.PRNGKey(1))
    jgrads = jax.tree_util.tree_map(lambda a, b: a - b, p_plus_g, params)
    jtx = jtrain.adamw(1e-3)
    upd, _ = jtx.update(jgrads, jtx.init(params), params)
    jp2 = {k: np.asarray(v) for k, v in
           flatten_with_paths(optax.apply_updates(params, upd)).items()}
    jgrads = {k: np.asarray(v) for k, v in flatten_with_paths(jgrads).items()}

    model = _port_model(cfg, flat)
    tx = ttrain.adamw(1e-3)
    opt = tx.init(ttrain.trainable_params(model))
    step = ttrain.make_asr_train_step(cfg, tx, attn_impl=impl)
    met = step(model, opt, _tbatch(batch))

    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]),
                               rtol=1e-4)
    assert int(met["ntokens"]) == int(jmet["ntokens"])
    names = convert.jax_names(model)
    for name, p in model.named_parameters():
        key, transpose = names[name]
        g = torch.zeros_like(p) if p.grad is None else p.grad   # unused: JAX gives 0
        g = g.t() if transpose else g
        np.testing.assert_allclose(g.numpy(), jgrads[key], atol=1e-5, rtol=1e-4,
                                   err_msg=f"grad {key}")
    back = convert.asr_to_jax_params(model)
    for key, want in jp2.items():
        np.testing.assert_allclose(back[key], want, rtol=2e-3, atol=2e-4,
                                   err_msg=f"param {key}")


def test_grad_accum_two_equals_full_batch(setup):
    cfg, _, _, flat, batch = setup
    out = {}
    for accum in (1, 2):
        model = _port_model(cfg, flat)
        tx = ttrain.adamw(1e-3)
        opt = tx.init(ttrain.trainable_params(model))
        met = ttrain.make_asr_train_step(cfg, tx, grad_accum=accum)(
            model, opt, _tbatch(batch))
        out[accum] = (float(met["loss"]), {k: p.grad.clone() for k, p in
                                           model.named_parameters()
                                           if p.grad is not None})
    np.testing.assert_allclose(out[2][0], out[1][0], rtol=1e-6)
    for k, g in out[1][1].items():
        np.testing.assert_allclose(out[2][1][k].numpy(), g.numpy(), atol=1e-6,
                                   rtol=1e-5, err_msg=k)


def test_frozen_feature_encoder_neither_moves_nor_decays(setup):
    cfg, _, _, flat, batch = setup
    model = _port_model(cfg, flat)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    tx = ttrain.adamw(1e-2, weight_decay=0.5)
    params = ttrain.trainable_params(model, freeze_feature_encoder=True)
    assert not any(k.startswith(ttrain.FROZEN_PREFIX) for k in params)
    opt = tx.init(params)
    ttrain.make_asr_train_step(cfg, tx, attn_impl="flash",
                               freeze_feature_encoder=True)(model, opt, _tbatch(batch))
    for k, p in model.named_parameters():
        moved = not torch.equal(p.detach(), before[k])
        assert moved != k.startswith(ttrain.FROZEN_PREFIX), k
        if k.startswith(ttrain.FROZEN_PREFIX):
            assert p.grad is None


def test_attention_dropout_is_zeroed_with_a_warning_for_flash():
    cfg = tiny_config()
    tx = ttrain.adamw(1e-3)
    with pytest.warns(UserWarning, match="attention_dropout=0.1 is zeroed"):
        ttrain.make_asr_train_step(cfg, tx, attn_impl="flash")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ttrain.make_asr_train_step(cfg, tx, attn_impl="dense")


def test_decoder_flash_refusals():
    cfg = tiny_config()
    module = tdec.Decoder(cfg, None).train()
    x, enc = torch.randn(2, 5, cfg.hidden_size), torch.randn(2, 9, cfg.hidden_size)
    with pytest.raises(ValueError, match="attention-prob dropout"):
        tdec.decoder(module, x, enc, attn_impl="flash")
    module = tdec.Decoder(dataclasses.replace(cfg, attention_dropout=0.0), None).eval()
    left_padded = torch.tensor([[0, 1, 1, 1, 1], [1, 1, 1, 1, 1]])
    with pytest.raises(ValueError, match="right-padded"):
        tdec.decoder(module, x, enc, attention_mask=left_padded, attn_impl="flash")
    right_padded = torch.tensor([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]])
    tdec.decoder(module, x, enc, attention_mask=right_padded, attn_impl="flash")


def test_adamw_matches_optax_over_five_steps():
    rng = np.random.default_rng(3)
    shapes = {"a": (5, 3), "b.c": (4,), "d": (2, 2, 2)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * (3.0 if i % 2 else 0.05)).astype(np.float32)
              for k, s in shapes.items()} for i in range(5)]
    jtx = jtrain.adamw(1e-2, weight_decay=0.1, warmup_steps=2, total_steps=5,
                       clip_norm=1.0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jst = jtx.init(jp)
    tx = ttrain.adamw(1e-2, weight_decay=0.1, warmup_steps=2, total_steps=5,
                      clip_norm=1.0)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    tst = tx.init(tp)
    for g in grads:
        upd, jst = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
        jp = optax.apply_updates(jp, upd)
        tx.update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, tst)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6,
                                       rtol=1e-6, err_msg=k)
