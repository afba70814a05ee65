"""The port's SpeechT5 TTS and voice-conversion models against the JAX
package on the same weights (carried by the bridge) and inputs, at
``tiny_config`` with SpecAugment and the prenet dropout off: the text
encoder prenet, the speech decoder prenet (sequence and single step), the
speech postnet, ``encode_text``, ``tts_forward``, ``s2s_forward`` (kernel
and plain routes), ``tts_generate`` at B=1 and ragged B=2 (lengths exactly
equal, every refined frame within 1e-4), a teacher-forced forward on the
port's own log-mel of a waveform, HF's prenet keep-mask rule and the
bridge's round trip.  Tolerances: 1e-4 (float32 sums in another order),
2e-4 for ``s2s_forward`` as in the JAX package's own test."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from loco_asr_tpu.models.speecht5 import model as jm
from loco_asr_tpu.models.speecht5 import prenets as jpre
from loco_asr_tpu.models.speecht5.config import SpeechT5Config as JConfig
from loco_asr_tpu.ops import audio as jaudio
from loco_asr_tpu.utils.pytree import flatten_with_paths, unflatten_from_paths
from loco_asr_tpu_torch.models.speecht5 import convert
from loco_asr_tpu_torch.models.speecht5 import model as tm
from loco_asr_tpu_torch.models.speecht5 import prenets as tpre
from loco_asr_tpu_torch.models.speecht5.config import tiny_config
from loco_asr_tpu_torch.ops.cuda import logmel as lm

TOL = dict(atol=1e-4, rtol=1e-4)
CFG = tiny_config(apply_spec_augment=False, mask_time_prob=0.0,
                  speech_decoder_prenet_dropout=0.0)
IDS = np.array([[4, 7, 9, 12, 30, 5, 2], [5, 6, 11, 2, 1, 1, 1]], np.int64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturbed(flat, seed):
    """Non-trivial values for what init leaves at 1 or 0 (the position
    scales, batch-norm statistics and affines, biases), so the comparison
    sees them."""
    rng = np.random.default_rng(seed)
    out = dict(flat)
    for k, v in flat.items():
        leaf = k.rsplit(".", 1)[-1]
        if leaf == "alpha":
            out[k] = np.float32(0.7 + 0.5 * rng.random())
        elif leaf in ("mean", "bias"):
            out[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif leaf in ("var", "scale") and "batch_norm" in k:
            out[k] = (0.8 + 0.4 * rng.random(v.shape)).astype(np.float32)
    return out


def _pair(init, cls, from_jax, seed):
    jcfg = JConfig(**dataclasses.asdict(CFG))
    flat = {k: np.asarray(v) for k, v in flatten_with_paths(init(jax.random.PRNGKey(seed), jcfg)).items()}
    flat = _perturbed(flat, seed)
    model = cls(CFG).eval()
    model.load_state_dict(from_jax(flat, CFG))
    return jcfg, unflatten_from_paths({k: jnp.asarray(v) for k, v in flat.items()}), flat, model


@pytest.fixture(scope="module")
def tts():
    return _pair(jm.tts_init, tm.TtsModel, convert.tts_from_jax_params, 0)


@pytest.fixture(scope="module")
def s2s():
    return _pair(jm.s2s_init, tm.S2sModel, convert.s2s_from_jax_params, 1)


def _inputs(b=2, t=6, seed=0):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((b, t, CFG.num_mel_bins)).astype(np.float32)
    spk = rng.standard_normal((b, CFG.speaker_embedding_dim)).astype(np.float32)
    return mel, spk


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def test_text_encoder_prenet(tts):
    jcfg, params, _, model = tts
    want = jpre.text_encoder_prenet(params["encoder"]["prenet"], jcfg, jnp.asarray(IDS))
    _close(tpre.text_encoder_prenet(model.encoder.prenet, torch.from_numpy(IDS)), want)


@pytest.mark.parametrize("with_speaker", [True, False])
def test_speech_decoder_prenet_and_its_step(tts, with_speaker):
    jcfg, params, _, model = tts
    mel, spk = _inputs()
    spk_j, spk_t = (jnp.asarray(spk), torch.from_numpy(spk)) if with_speaker else (None, None)
    p_j, p_t = params["decoder"]["prenet"], model.decoder.prenet
    want = jpre.speech_decoder_prenet(p_j, jcfg, jnp.asarray(mel), spk_j)
    got = tpre.speech_decoder_prenet(p_t, torch.from_numpy(mel), spk_t)
    _close(got, want)
    for idx in (0, 3, 5):
        step = tpre.speech_decoder_prenet_step(p_t, torch.from_numpy(mel[:, idx]), idx, spk_t)
        torch.testing.assert_close(step, got[:, idx], atol=1e-6, rtol=1e-6)
        _close(step, jpre.speech_decoder_prenet_step(p_j, jcfg, jnp.asarray(mel[:, idx]),
                                                     jnp.asarray(idx), spk_j))


def test_speech_decoder_postnet(tts):
    jcfg, params, _, model = tts
    hidden = np.random.default_rng(2).standard_normal((2, 5, CFG.hidden_size)).astype(np.float32)
    want = jpre.speech_decoder_postnet(params["speech_decoder_postnet"], jcfg, jnp.asarray(hidden))
    got = tpre.speech_decoder_postnet(model.speech_decoder_postnet, torch.from_numpy(hidden))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)


def test_encode_text_and_tts_forward(tts):
    jcfg, params, _, model = tts
    mask = (IDS != CFG.pad_token_id).astype(np.int32)
    want = jm.encode_text(params, jcfg, jnp.asarray(IDS), jnp.asarray(mask))
    got = tm.encode_text(model, torch.from_numpy(IDS), torch.from_numpy(mask))
    _close(got[mask.astype(bool)], np.asarray(want)[mask.astype(bool)])
    mel, spk = _inputs()
    want = jm.tts_forward(params, jcfg, jnp.asarray(IDS), jnp.asarray(mel), jnp.asarray(spk),
                          jnp.asarray(mask))
    got = tm.tts_forward(model, torch.from_numpy(IDS), torch.from_numpy(mel),
                         torch.from_numpy(spk), torch.from_numpy(mask))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_s2s_forward(s2s, use_kernels):
    jcfg, params, _, model = s2s
    rng = np.random.default_rng(3)
    wav = (rng.standard_normal((2, 1600)) * 0.1).astype(np.float32)
    am = np.ones_like(wav, np.int32)
    am[1, 1100:], wav[1, 1100:] = 0, 0.0
    mel, spk = _inputs(t=5, seed=4)
    want = jm.s2s_forward(params, jcfg, *map(jnp.asarray, (wav, mel, spk, am)))
    with torch.no_grad():
        got = tm.s2s_forward(model, *map(torch.from_numpy, (wav, mel, spk, am)),
                             use_kernels=use_kernels)
    for g, w in zip(got, want):
        _close(g, w, dict(atol=2e-4, rtol=2e-4))


@pytest.mark.parametrize("rows,threshold,minlenratio", [(1, 0.5, 0.0), (1, 1.1, 0.0),
                                                        (2, 1.0, 0.0), (2, 1.1, 1.0)])
def test_tts_generate(tts, rows, threshold, minlenratio):
    jcfg, params, _, model = tts
    ids = IDS[:rows]
    _, spk = _inputs(b=rows, seed=5)
    kw = dict(threshold=threshold, minlenratio=minlenratio, maxlenratio=4.0)
    want, want_len = jm.tts_generate(params, jcfg, jnp.asarray(ids), jnp.asarray(spk), **kw)
    got, got_len = tm.tts_generate(model, torch.from_numpy(ids), torch.from_numpy(spk), **kw)
    assert got_len.dtype == torch.int32
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert tuple(got.shape) == want.shape
    _close(got, want)


def test_teacher_forced_tts_on_the_ports_log_mel(tts):
    jcfg, params, _, model = tts
    wav = (np.random.default_rng(6).standard_normal((2, 2500)) * 0.1).astype(np.float32)
    kw = dict(num_mel_bins=CFG.num_mel_bins)
    target = lm.fused_log_mel(torch.from_numpy(wav), **kw)
    dec_in = tm.shift_spectrograms_right(target, CFG.reduction_factor)
    want_in = jm.shift_spectrograms_right(jaudio.log_mel_spectrogram(jnp.asarray(wav), **kw),
                                          CFG.reduction_factor)
    _close(dec_in, want_in, dict(atol=2e-4, rtol=2e-4))
    _, spk = _inputs(seed=7)
    want = jm.tts_forward(params, jcfg, jnp.asarray(IDS), want_in, jnp.asarray(spk))
    got = tm.tts_forward(model, torch.from_numpy(IDS), dec_in, torch.from_numpy(spk))
    assert tuple(got[1].shape) == (2, 2 * dec_in.shape[1], CFG.num_mel_bins)
    for g, w in zip(got, want):
        _close(g, w, dict(atol=2e-4, rtol=2e-4))


def test_prenet_dropout_keeps_with_probability_p_and_shares_the_mask(tts):
    """HF's ``_consistent_dropout``: bernoulli(p) is the keep mask, one
    mask for the batch, kept entries scaled by 1 / (1 - p)."""
    p = 0.3
    cfg = dataclasses.replace(CFG, speech_decoder_prenet_dropout=p,
                              speech_decoder_prenet_layers=1)
    prenet = tpre.SpeechDecoderPrenet(cfg, torch.Generator().manual_seed(0)).eval()
    prenet.final_layer = torch.nn.Identity()
    frame = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (1, 400, cfg.num_mel_bins)).astype(np.float32)).expand(2, -1, -1)
    clean = torch.relu(prenet.layers[0](frame))
    got = tpre._bottleneck(prenet, frame, torch.Generator().manual_seed(1))
    torch.testing.assert_close(got[0], got[1], atol=0, rtol=0)          # one mask
    live = clean[0] > 0
    kept = got[0][live] != 0
    assert abs(kept.float().mean().item() - p) < 0.02
    torch.testing.assert_close(got[0][live][kept], clean[0][live][kept] / (1 - p))
    torch.testing.assert_close(tpre._bottleneck(prenet, frame, None), clean)


def test_bridge_round_trip(tts, s2s):
    for (_, _, flat, model), back in ((tts, convert.tts_to_jax_params),
                                      (s2s, convert.s2s_to_jax_params)):
        out = back(model)
        assert sorted(out) == sorted(flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(out[k], v, err_msg=k)
    bad = dict(tts[2])
    bad["speech_decoder_postnet.layers.0.batch_norm.mean"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="batch_norm.mean"):
        convert.tts_from_jax_params(bad, CFG)


def test_shift_spectrograms_right():
    mel = np.random.default_rng(9).standard_normal((2, 7, 3)).astype(np.float32)
    for r in (1, 2, 3):
        np.testing.assert_array_equal(
            tm.shift_spectrograms_right(torch.from_numpy(mel), r).numpy(),
            np.asarray(jm.shift_spectrograms_right(jnp.asarray(mel), r)))
