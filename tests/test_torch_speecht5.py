"""The port's speech prenet, encoder and encode_speech against the JAX
package on the same weights (through convert.from_jax_params) and inputs:
tiny config and full width (768, 12 heads, FFN 3072, the 7-layer
512-channel conv stack) cut to 2 encoder layers; padded and unpadded,
judged on valid frames at atol/rtol 1e-4 as the JAX parity tests."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from loco_asr_tpu.models.speecht5 import encoder as jenc
from loco_asr_tpu.models.speecht5 import model as jm
from loco_asr_tpu.models.speecht5 import prenets as jpre
from loco_asr_tpu.models.speecht5.config import SpeechT5Config as JConfig
from loco_asr_tpu.utils.pytree import flatten_with_paths
from loco_asr_tpu_torch.models.speecht5 import convert, encoder as tenc
from loco_asr_tpu_torch.models.speecht5 import model as tm
from loco_asr_tpu_torch.models.speecht5 import prenets as tpre
from loco_asr_tpu_torch.models.speecht5.config import SpeechT5Config, tiny_config

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(cfg):
    jcfg = JConfig(**dataclasses.asdict(cfg))
    params = jm.asr_init(jax.random.PRNGKey(0), jcfg)
    flat = {k: np.asarray(v) for k, v in flatten_with_paths(params).items()}
    model = tm.SpeechEncoder(cfg).eval()
    model.load_state_dict(convert.from_jax_params(flat, cfg))
    return params, jcfg, model, cfg


@pytest.fixture(scope="module")
def tiny():
    return _pair(tiny_config())


@pytest.fixture(scope="module")
def wide():
    return _pair(SpeechT5Config(encoder_layers=2))


def _batch(b, t, padded, seed=0):
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal((b, t)) * 0.1).astype(np.float32)
    mask = np.ones((b, t), np.int32)
    if padded:
        cut = int(t * 0.6)
        wav[1, cut:] = 0.0
        mask[1, cut:] = 0
    return wav, mask


def _assert_valid_close(got, want, mask):
    valid = np.ones(want.shape[:2], bool) if mask is None else np.asarray(mask).astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], **TOL)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_speech_prenet(tiny, padded, use_kernels):
    params, jcfg, model, _ = tiny
    wav, mask = _batch(2, 900, padded)
    m = mask if padded else None
    want, want_mask = jpre.speech_prenet(params["encoder"]["prenet"], jcfg, jnp.asarray(wav),
                                         None if m is None else jnp.asarray(m))
    with torch.no_grad():
        got, got_mask = tpre.speech_prenet(model.prenet, torch.from_numpy(wav),
                                           None if m is None else torch.from_numpy(m),
                                           use_kernels=use_kernels)
    if padded:
        np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    else:
        assert got_mask is None and want_mask is None
    _assert_valid_close(got.numpy(), np.asarray(want), want_mask)


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
@pytest.mark.parametrize("padded", [False, True])
def test_encoder(tiny, attn_impl, padded):
    params, jcfg, model, cfg = tiny
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((2, 50, cfg.hidden_size)).astype(np.float32)
    mask = np.ones((2, 50), np.int32)
    if padded:
        mask[1, 31:] = 0
    m = mask if padded else None
    want = jenc.encoder(params["encoder"]["wrapped_encoder"], jcfg, jnp.asarray(hidden),
                        None if m is None else jnp.asarray(m), attn_impl=attn_impl)
    with torch.no_grad():
        got = tenc.encoder(model.wrapped_encoder, torch.from_numpy(hidden),
                           None if m is None else torch.from_numpy(m), attn_impl=attn_impl)
    _assert_valid_close(got.numpy(), np.asarray(want), m)


def _check_encode_speech(pair, b, t, padded):
    params, jcfg, model, _ = pair
    wav, mask = _batch(b, t, padded, seed=t)
    m = mask if padded else None
    wants = [jm.encode_speech(params, jcfg, jnp.asarray(wav),
                              None if m is None else jnp.asarray(m), attn_impl=impl)
             for impl in ("dense", "flash")]
    for use_kernels in (False, True):
        got, got_mask = tm.encode_speech(model, wav, m, use_kernels=use_kernels)
        for want, want_mask in wants:
            assert got.shape == want.shape
            if padded:
                np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
            _assert_valid_close(got.numpy(), np.asarray(want), want_mask)


@pytest.mark.parametrize("padded", [False, True])
def test_encode_speech_tiny(tiny, padded):
    _check_encode_speech(tiny, 2, 1200, padded)


def test_encode_speech_full_width_two_layers(wide):
    _check_encode_speech(wide, 2, 16000, padded=True)


def test_reduce_attention_mask():
    cfg = SpeechT5Config()
    lengths = [16000, 12345, 400, 401, 9]
    mask = np.zeros((len(lengths), 16000), np.int32)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1
    frames = cfg.feat_extract_output_length(16000)
    want = jpre.reduce_attention_mask(JConfig(), frames, jnp.asarray(mask))
    got = tpre.reduce_attention_mask(cfg, frames, torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
