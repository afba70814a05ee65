"""Mixed precision in the port (loco_asr_tpu_torch) against the JAX
package on the CPU, on the same weights and batch:

* ``make_asr_train_step(compute_dtype=bfloat16)`` (dense and flash) and
  ``make_lm_train_step(compute_dtype=bfloat16)`` against JAX's: loss within
  rtol 5e-3, global gradient norm within 2 %; master parameters and
  optimizer state stay float32; each package against its own float32 step
  under the JAX test's contract (loss rtol 5e-2, norm within 15 %);
* ``adamw(mu_dtype=bfloat16)``: the first moment is stored in bf16 and the
  parameters stay within 1e-6 of optax's over 5 steps;
* the result dtype of each encoder submodule, port against JAX, with
  bfloat16 parameters and a float32 waveform (``extract_embeddings --dtype
  bfloat16``, where JAX promotes to float32) and under the compute dtype
  (both bfloat16), and which kernel form each attention call reaches;
* GPT-2 scoring with bfloat16 parameters (``eval_ppl --compute_dtype
  bfloat16``): per-token NLL mean |d| <= 5e-3 against JAX, < 5e-2 against
  float32;
* the bfloat16 ``.npz`` convention: the JAX ``load_npz`` reads the port's
  file, and both writers give the same bytes."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import optax

from loco_asr_tpu.models.gpt2 import model as jg
from loco_asr_tpu.models.speecht5 import encoder as jenc
from loco_asr_tpu.models.speecht5 import model as jm
from loco_asr_tpu.models.speecht5 import prenets as jpre
from loco_asr_tpu.models.speecht5.config import SpeechT5Config as JConfig
from loco_asr_tpu.parallel import mesh as jmesh
from loco_asr_tpu.parallel import train as jtrain
from loco_asr_tpu.utils import checkpoint as jckpt
from loco_asr_tpu.utils.pytree import cast_floating, flatten_with_paths
from loco_asr_tpu_torch.models.gpt2 import convert as gconvert
from loco_asr_tpu_torch.models.gpt2 import model as tg
from loco_asr_tpu_torch.models.speecht5 import convert
from loco_asr_tpu_torch.models.speecht5 import model as tm
from loco_asr_tpu_torch.models.speecht5.config import tiny_config
from loco_asr_tpu_torch.ops import layers
from loco_asr_tpu_torch.ops.cuda import flash_attention as tfa
from loco_asr_tpu_torch.ops.cuda import flash_causal as tfc
from loco_asr_tpu_torch.parallel import train as ttrain
from loco_asr_tpu_torch.utils import checkpoint as tckpt

BF16 = torch.bfloat16


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
def asr_setup():
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


def _asr_model(cfg, flat):
    model = tm.AsrModel(cfg)
    model.load_state_dict(convert.asr_from_jax_params(flat, cfg))
    return model


def _tbatch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _jax_step(make, cfg, params, batch, **kw):
    """(loss, grad norm) of one JAX step (identity optimizer: params + grads)."""
    step = make(cfg, jmesh.make_mesh(data=1), optax.identity(), donate=False, **kw)
    _, _, met = step(params, (), {k: jnp.asarray(v) for k, v in batch.items()},
                     jax.random.PRNGKey(1))
    return float(met["loss"]), float(met["grad_norm"])


def _assert_f32_state(model, opt):
    for name, p in model.named_parameters():
        assert p.dtype is torch.float32, name
        assert p.grad is None or p.grad.dtype is torch.float32, name
    for key in ("mu", "nu"):
        assert all(t.dtype is torch.float32 for t in opt[key].values()), key


def _assert_steps_agree(port16, port32, jax16, jax32):
    """bf16 port against bf16 JAX (loss rtol 5e-3, norm 2 %), and each
    against its own f32 step (loss rtol 5e-2, norm 15 %)."""
    np.testing.assert_allclose(port16[0], jax16[0], rtol=5e-3)
    assert abs(port16[1] - jax16[1]) <= 0.02 * jax16[1]
    for b16, f32 in ((port16, port32), (jax16, jax32)):
        np.testing.assert_allclose(b16[0], f32[0], rtol=5e-2)
        assert abs(b16[1] - f32[1]) <= 0.15 * f32[1] + 1e-3


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_asr_step_bf16_matches_jax(asr_setup, impl):
    cfg, jcfg, params, flat, batch = asr_setup
    jax16 = _jax_step(jtrain.make_asr_train_step, jcfg, params, batch, attn_impl=impl,
                      compute_dtype=jnp.bfloat16)
    jax32 = _jax_step(jtrain.make_asr_train_step, jcfg, params, batch, attn_impl=impl)
    out = {}
    for name, dtype in (("bf16", BF16), ("f32", None)):
        model = _asr_model(cfg, flat)
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        tx = ttrain.adamw(1e-3)
        opt = tx.init(ttrain.trainable_params(model))
        met = ttrain.make_asr_train_step(cfg, tx, attn_impl=impl, compute_dtype=dtype)(
            model, opt, _tbatch(batch))
        out[name] = (float(met["loss"]), float(met["grad_norm"]))
        _assert_f32_state(model, opt)
        assert any(not torch.equal(before[k], p) for k, p in model.named_parameters())
    _assert_steps_agree(out["bf16"], out["f32"], jax16, jax32)


def _lm_setup():
    cfg = tg.tiny_gpt2_config(n_positions=32, n_embd=16, n_head=2, embd_pdrop=0.0,
                              attn_pdrop=0.0, resid_pdrop=0.0)
    jcfg = jg.GPT2Config(**dataclasses.asdict(cfg))
    params = jg.gpt2_init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    batch = {"ids": rng.integers(0, cfg.vocab_size, (2, 32)),
             "lengths": np.asarray([32, 20], np.int32)}
    return cfg, jcfg, params, batch


def _lm_model(cfg, params):
    model = tg.GPT2Model(cfg)
    model.load_state_dict(gconvert.from_jax_params(flatten_with_paths(params), cfg))
    return model


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_lm_step_bf16_matches_jax(impl):
    cfg, jcfg, params, batch = _lm_setup()
    jax16 = _jax_step(jtrain.make_lm_train_step, jcfg, params, batch, attn_impl=impl,
                      compute_dtype=jnp.bfloat16)
    jax32 = _jax_step(jtrain.make_lm_train_step, jcfg, params, batch, attn_impl=impl)
    out = {}
    for name, dtype in (("bf16", BF16), ("f32", None)):
        model = _lm_model(cfg, params)
        tx = ttrain.adamw(1e-3)
        opt = tx.init(dict(model.named_parameters()))
        met = ttrain.make_lm_train_step(cfg, tx, attn_impl=impl, compute_dtype=dtype)(
            model, opt, _tbatch(batch))
        out[name] = (float(met["loss"]), float(met["grad_norm"]))
        _assert_f32_state(model, opt)
    _assert_steps_agree(out["bf16"], out["f32"], jax16, jax32)


def test_adamw_bf16_first_moment_follows_optax():
    """mu stored in bf16, nu and the parameters in f32, the parameters
    within 1e-6 of optax.adamw(mu_dtype=bfloat16) over 5 steps of the same
    gradients."""
    rng = np.random.default_rng(3)
    shapes = {"a": (7, 5), "b": (11,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    jtx = jtrain.adamw(1e-2, 0.01, mu_dtype=jnp.bfloat16)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jst = jtx.init(jp)
    tx = ttrain.adamw(1e-2, 0.01, mu_dtype=BF16)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    st = tx.init(tp)
    assert all(m.dtype is BF16 for m in st["mu"].values())
    for g in grads:
        upd, jst = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
        jp = optax.apply_updates(jp, upd)
        tx.update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, st)
        assert all(m.dtype is BF16 for m in st["mu"].values())
        assert all(v.dtype is torch.float32 for v in st["nu"].values())
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0)
    jmu = jst[0].mu
    for k in shapes:
        np.testing.assert_array_equal(st["mu"][k].float().numpy(),
                                      np.asarray(jmu[k].astype(jnp.float32)))


def _flash_forms(monkeypatch):
    """The operand dtype of every attention kernel call, by kernel."""
    seen = []
    for mod, name in ((tfa, "flash_rel_forward"), (tfc, "flash_forward")):
        real = getattr(mod, name)

        def spy(q, *a, _real=real, _name=name, **kw):
            seen.append((_name, q.dtype))
            return _real(q, *a, **kw)

        monkeypatch.setattr(mod, name, spy)
    return seen


@pytest.mark.parametrize("mode", ["extraction", "compute"])
def test_encoder_submodule_dtypes_match_jax(asr_setup, mode, monkeypatch):
    """bf16 parameters with a float32 waveform (``extract_embeddings --dtype
    bfloat16``): JAX promotes every op to float32, so the encoder runs in
    float32 on bf16-rounded weights and returns float32, and B1 is called
    in its f32 form.  Both cast (the compute dtype): every stage is bf16 and
    B1 is called in its bf16 form."""
    cfg, jcfg, params, flat, batch = asr_setup
    jp = cast_floating(params, jnp.bfloat16)
    wav = batch["input_values"]
    if mode == "compute":
        wav = np.array(jnp.asarray(wav).astype(jnp.bfloat16).astype(jnp.float32))
    jwav = jnp.asarray(wav).astype(jnp.bfloat16 if mode == "compute" else jnp.float32)
    pre = jp["encoder"]["prenet"]
    jfeats = jpre.feature_encoder_fused(pre["feature_encoder"], jcfg, jwav)
    jhid, jmask = jpre.speech_prenet(pre, jcfg, jwav, jnp.asarray(batch["attention_mask"]))
    jout = jenc.encoder(jp["encoder"]["wrapped_encoder"], jcfg, jhid, jmask,
                        attn_impl="flash")
    want = [str(x.dtype) for x in (jfeats, jhid, jout)]

    enc = tm.asr_init(cfg, device="cpu")
    enc.load_state_dict(convert.from_jax_params(flat, cfg))
    enc = layers.cast_parameters(enc, BF16)
    twav = torch.from_numpy(wav).to(BF16 if mode == "compute" else torch.float32)
    seen = _flash_forms(monkeypatch)
    with torch.no_grad():
        feats = enc.prenet.feature_encoder(twav)
        hid, mask = enc.prenet(twav, torch.from_numpy(batch["attention_mask"]))
        out = enc.wrapped_encoder(hid, mask, attn_impl="flash")
    got = [str(x.dtype).replace("torch.", "") for x in (feats, hid, out)]
    assert got == want == ([("float32")] * 3 if mode == "extraction" else ["bfloat16"] * 3)
    form = torch.float32 if mode == "extraction" else BF16
    assert seen == [("flash_rel_forward", form)] * cfg.encoder_layers
    tol = 1e-4 if mode == "extraction" else 5e-2
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jout.astype(jnp.float32)),
                               atol=tol, rtol=tol)


def test_gpt2_scoring_bf16_matches_jax():
    """bf16 parameters (``eval_ppl --compute_dtype bfloat16``): the port's
    per-token NLLs within a mean |d| of 5e-3 of JAX's, and within 5e-2 of
    the float32 ones (the JAX test's bound), both in float32."""
    cfg = tg.tiny_gpt2_config(n_positions=64, n_embd=32, n_head=4)
    jcfg = jg.GPT2Config(**dataclasses.asdict(cfg))
    params = jg.gpt2_init(jax.random.PRNGKey(2), jcfg)
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 64))
    jp16 = cast_floating(params, jnp.bfloat16)
    for impl in ("dense", "flash"):
        hid, _ = jg.gpt2_forward(jp16, jcfg, jnp.asarray(ids), attn_impl=impl)
        jnll = np.asarray(jg.token_nll_from_hidden(jp16["wte"]["weight"], hid,
                                                   jnp.asarray(ids)))
        model = _lm_model(cfg, params)
        with torch.no_grad():
            f32 = tg.score_tokens(model, torch.from_numpy(ids), attn_impl=impl)
            nll = tg.score_tokens(layers.cast_parameters(model, BF16), torch.from_numpy(ids), attn_impl=impl)
        assert nll.dtype is torch.float32 and jnll.dtype == np.float32
        assert np.abs(nll.numpy() - jnll).mean() <= 5e-3
        assert np.abs(nll.numpy() - f32.numpy()).mean() < 5e-2


def test_bf16_npz_round_trip(tmp_path):
    """A bf16 leaf is saved as the JAX writer saves it (raw 2-byte void
    values): the JAX ``load_npz`` reads the port's file as the JAX file's
    bytes, and the port reads both back as the same bf16 tensor."""
    rng = np.random.default_rng(5)
    x32 = rng.standard_normal((3, 4)).astype(np.float32)
    tree_t = {"mu": {"w": torch.from_numpy(x32).to(BF16)}, "count": np.asarray(3)}
    tree_j = {"mu": {"w": jnp.asarray(x32).astype(jnp.bfloat16)}, "count": np.asarray(3)}
    tckpt.save_npz(str(tmp_path / "port.npz"), tree_t)
    jckpt.save_npz(str(tmp_path / "jax.npz"), tree_j)
    with np.load(tmp_path / "port.npz") as zp, np.load(tmp_path / "jax.npz") as zj:
        assert zp["mu.w"].dtype == zj["mu.w"].dtype == np.dtype("V2")
        assert zp["mu.w"].tobytes() == zj["mu.w"].tobytes()
    from_port = jckpt.load_npz(str(tmp_path / "port.npz"))
    from_jax = jckpt.load_npz(str(tmp_path / "jax.npz"))
    assert from_port["mu"]["w"].tobytes() == from_jax["mu"]["w"].tobytes()
    for name in ("port.npz", "jax.npz"):
        back = tckpt.load_npz(str(tmp_path / name))
        assert back["mu"]["w"].dtype is BF16
        assert torch.equal(back["mu"]["w"], tree_t["mu"]["w"])
        assert int(back["count"]) == 3
