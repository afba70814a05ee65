"""The port's SpeechT5 ASR model pieces against the JAX package on the same
weights (carried by the bridge) and inputs, at ``tiny_config``: the
differentiable gram form of the first conv layer, the text decoder prenet
(with scalar and per-row ``past_length``), teacher-forced logits under
dense and flash attention, incremental decode steps with per-row cache
offsets, SpecAugment in the prenet, dropout, the weight bridge's round
trip and the WER copy.  Tolerances 1e-5 (float32 sums in another order)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from loco_asr_tpu.models.speecht5 import decoder as jdec
from loco_asr_tpu.models.speecht5 import model as jm
from loco_asr_tpu.models.speecht5 import prenets as jpre
from loco_asr_tpu.models.speecht5.config import SpeechT5Config as JConfig
from loco_asr_tpu.utils import wer as jwer
from loco_asr_tpu.utils.pytree import flatten_with_paths
from loco_asr_tpu_torch.models.speecht5 import convert
from loco_asr_tpu_torch.models.speecht5 import decoder as tdec
from loco_asr_tpu_torch.models.speecht5 import model as tm
from loco_asr_tpu_torch.models.speecht5 import prenets as tpre
from loco_asr_tpu_torch.models.speecht5.config import tiny_config
from loco_asr_tpu_torch.ops.cuda import conv_frontend as cf
from loco_asr_tpu_torch.utils import wer as twer

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    cfg = dataclasses.replace(tiny_config(), scale_embedding=True)
    jcfg = JConfig(**dataclasses.asdict(cfg))
    params = jm.asr_init(jax.random.PRNGKey(4), jcfg)
    flat = {k: np.asarray(v) for k, v in flatten_with_paths(params).items()}
    model = tm.AsrModel(cfg).eval()
    model.load_state_dict(convert.asr_from_jax_params(flat, cfg))
    return cfg, jcfg, params, flat, model


def test_gram_form_matches_jax_and_the_plain_version():
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal((3, 1234)) * 0.1).astype(np.float32)
    w = (rng.standard_normal((16, 1, 10)) * 0.3).astype(np.float32)
    sc = (1.0 + rng.standard_normal(16) * 0.1).astype(np.float32)
    bi = (rng.standard_normal(16) * 0.1).astype(np.float32)
    want = np.asarray(jpre.conv1_instance_norm_gelu_gram(*map(jnp.asarray, (wav, w, sc, bi))))
    args = [torch.from_numpy(a) for a in (wav, w, sc, bi)]
    got = tpre.conv1_instance_norm_gelu_gram(*args)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(cf.conv1_instance_norm_gelu_plain(*args).numpy(), want,
                               atol=1e-4, rtol=1e-4)
    w_t = args[1].clone().requires_grad_()
    tpre.conv1_instance_norm_gelu_gram(args[0], w_t, *args[2:]).sum().backward()
    assert w_t.grad is not None and torch.isfinite(w_t.grad).all()


def test_feature_encoder_takes_the_gram_form_only_under_grad(pair, monkeypatch):
    model = pair[4]
    taken = []
    for mod, name in ((tpre, "conv1_instance_norm_gelu_gram"),
                      (cf, "conv1_instance_norm_gelu")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=real, _n=name, **k:
                            (taken.append(_n), _f(*a, **k))[1])
    wav = torch.zeros(1, 800)
    model.encoder.prenet.feature_encoder(wav)
    with torch.no_grad():
        model.encoder.prenet.feature_encoder(wav)
    assert taken == ["conv1_instance_norm_gelu_gram", "conv1_instance_norm_gelu"]


@pytest.mark.parametrize("past", [0, 5, "rows"])
def test_text_decoder_prenet_matches_jax(pair, past):
    cfg, jcfg, params, _, model = pair
    ids = np.array([[2, 5, 9, 1, 1], [2, 7, 3, 4, 8]])
    if past == "rows":
        ids = ids[:, :1]
        past_j, past_t = jnp.asarray([3, 11]), torch.tensor([3, 11])
    else:
        past_j = past_t = past
    want = jpre.text_decoder_prenet(params["decoder"]["prenet"], jcfg, jnp.asarray(ids),
                                    past_length=past_j)
    got = tpre.text_decoder_prenet(model.decoder.prenet, torch.from_numpy(ids),
                                   past_length=past_t)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_teacher_forced_logits_match_jax(pair, impl):
    cfg, jcfg, params, _, model = pair
    rng = np.random.default_rng(1)
    wav = (rng.standard_normal((2, 2000)) * 0.1).astype(np.float32)
    mask = np.ones_like(wav, np.int32)
    mask[1, 1500:] = 0
    ids = rng.integers(3, cfg.vocab_size, (2, 6))
    want = jm.asr_forward(params, jcfg, jnp.asarray(wav), jnp.asarray(ids),
                          jnp.asarray(mask), attn_impl=impl)
    with torch.no_grad():
        got = tm.asr_forward(model, torch.from_numpy(wav), torch.from_numpy(ids),
                             torch.from_numpy(mask), attn_impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


def test_decode_steps_with_per_row_offsets_match_jax(pair):
    cfg, jcfg, params, _, model = pair
    rng = np.random.default_rng(2)
    enc = rng.standard_normal((2, 9, cfg.hidden_size)).astype(np.float32)
    emask = np.ones((2, 9), np.int32)
    emask[0, 6:] = 0
    jcache = jdec.init_decode_cache(jcfg, 2, 8)
    jcross = jm.asr_cross_cache(params, jcfg, jnp.asarray(enc))
    tcache = tdec.init_decode_cache(cfg, 2, 8)
    enc_t, emask_t = torch.from_numpy(enc), torch.from_numpy(emask)
    with torch.no_grad():
        tcross = tm.asr_cross_cache(model, enc_t)
    offsets = np.array([0, 2])
    for t in range(4):
        tok = rng.integers(3, cfg.vocab_size, (2, 1))
        step = offsets + t
        want, jcache = jm.asr_decode_step(params, jcfg, jnp.asarray(tok), jnp.asarray(step),
                                          jnp.asarray(enc), jnp.asarray(emask), jcache,
                                          cross_caches=jcross)
        with torch.no_grad():
            got = tm.asr_decode_step(model, torch.from_numpy(tok), torch.from_numpy(step),
                                     enc_t, emask_t, tcache, cross_caches=tcross)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


def test_spec_augment_masks_frames_with_the_learned_vector(pair):
    """With the positional conv's gain zeroed, the prenet output of a frame
    moves only if SpecAugment replaced it, and then by exactly
    ``masked_spec_embed - projection``; the frames are those of
    ``compute_mask_indices`` drawn from the same seed."""
    from loco_asr_tpu_torch.ops.audio import compute_mask_indices

    cfg = dataclasses.replace(pair[0], mask_time_prob=0.3, mask_time_length=3)
    prenet = tpre.SpeechPrenet(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        prenet.pos_conv_embed.conv.weight_g.zero_()
    wav = torch.randn(2, 6400) * 0.1
    mask = torch.ones(2, 6400, dtype=torch.int32)
    mask[1, 4000:] = 0
    with torch.no_grad():
        ref, fmask = prenet.eval()(wav, mask)
        untouched, _ = prenet.train()(wav, mask)            # no generator
        aug, _ = prenet.train()(wav, mask, generator=torch.Generator().manual_seed(1))
        fp = prenet.feature_projection
        proj = fp.projection(torch.nn.functional.layer_norm(
            prenet.feature_encoder(wav), (cfg.conv_dim[-1],), fp.layer_norm.weight,
            fp.layer_norm.bias, cfg.layer_norm_eps))
    m = compute_mask_indices(torch.Generator().manual_seed(1), tuple(ref.shape[:2]),
                             cfg.mask_time_prob, cfg.mask_time_length, fmask.sum(-1),
                             cfg.mask_time_min_masks)
    torch.testing.assert_close(untouched, ref)
    assert m.any() and not (m & ~fmask.bool()).any()
    torch.testing.assert_close(aug[~m], ref[~m])
    torch.testing.assert_close(aug[m] - ref[m], prenet.masked_spec_embed - proj[m],
                               atol=1e-5, rtol=1e-5)


def test_dropout_draws_from_the_generator_in_training_only(pair):
    model = pair[4]
    wav = torch.randn(2, 3200) * 0.1
    cfg = dataclasses.replace(pair[0], apply_spec_augment=False)
    enc = tm.SpeechEncoder(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        a, _ = enc.eval()(wav, generator=torch.Generator().manual_seed(1))
        b, _ = enc.eval()(wav)
        c, _ = enc.train()(wav, generator=torch.Generator().manual_seed(1))
        d, _ = enc.train()(wav, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b)
    torch.testing.assert_close(c, d)
    assert not torch.allclose(b, c)
    del model


def test_bridge_round_trip_and_strictness(pair):
    cfg, _, _, flat, model = pair
    back = convert.asr_to_jax_params(model)
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    broken = dict(flat)
    broken.pop("decoder.wrapped_decoder.layers.0.self_attn.q_proj.kernel")
    with pytest.raises(KeyError, match="missing"):
        convert.asr_from_jax_params(broken, cfg)
    with pytest.raises(KeyError, match="unexpected"):
        convert.asr_from_jax_params(dict(flat, **{"decoder.extra.kernel": np.zeros(1)}), cfg)


def test_wer_copy_matches_jax():
    refs = ["the cat sat", "a b c d", "", "hello there world"]
    hyps = ["the cat sat down", "a c d", "x", "hello world"]
    assert twer.wer(refs, hyps) == jwer.wer(refs, hyps)
    assert twer.cer(refs, hyps) == jwer.cer(refs, hyps)
    assert twer.wer_details(refs, hyps) == jwer.wer_details(refs, hyps)
