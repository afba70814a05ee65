"""The port's log-mel front end (``ops/audio.log_mel_spectrogram`` and
kernel B7's plain version ``ops/cuda/logmel.fused_log_mel_plain``) against
the JAX package's Pallas ``fused_log_mel`` in interpret mode and its XLA
``audio.log_mel_spectrogram``, at the JAX test's atol/rtol 2e-4, including
rows of at most 512 samples, where the reflect pad is longer than the row
and numpy's rule reflects again; the float64-built constants, exactly
equal to JAX's; the sparse bank the kernel reads; and, on a CUDA device
only, the wrapper's refusals."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from loco_asr_tpu.ops import audio as jaudio
from loco_asr_tpu.ops.pallas.logmel import fused_log_mel as pallas_b7
from loco_asr_tpu_torch.ops import audio as taudio
from loco_asr_tpu_torch.ops.cuda import logmel as lm

TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wav(shape, seed):
    wav = (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(np.float32)
    if len(shape) == 2 and shape[-1] > 4000:
        wav[-1, shape[-1] // 2:] = 0.0     # a zero-padded row: the end reflects its tail
    return wav


@pytest.mark.parametrize("num_mel_bins", [80, 8])
@pytest.mark.parametrize("shape", [(2, 8000), (3, 16001), (300,), (2, 3, 6400)])
def test_port_matches_pallas_and_xla(shape, num_mel_bins):
    wav = _wav(shape, seed=sum(shape) + num_mel_bins)
    kw = dict(num_mel_bins=num_mel_bins)
    want_pallas = np.asarray(pallas_b7(jnp.asarray(wav), interpret=True, **kw))
    want_xla = np.asarray(jaudio.log_mel_spectrogram(jnp.asarray(wav), **kw))
    assert want_pallas.shape == (*shape[:-1], 1 + shape[-1] // 256, num_mel_bins)
    for fn in (lm.fused_log_mel_plain, taudio.log_mel_spectrogram):
        got = fn(torch.from_numpy(wav), **kw).numpy()
        assert got.shape == want_pallas.shape
        np.testing.assert_allclose(got, want_pallas, **TOL)
        np.testing.assert_allclose(got, want_xla, **TOL)


def test_all_zero_frames_sit_exactly_at_the_floor():
    wav = np.zeros((2, 4000), np.float32)
    wav[0, :1000] = _wav((1000,), seed=1)
    want = np.asarray(jaudio.log_mel_spectrogram(jnp.asarray(wav)))
    got = lm.fused_log_mel_plain(torch.from_numpy(wav)).numpy()
    floor = want == want.min()
    assert floor[1].all() and abs(want.min() + 10.0) < 1e-5
    np.testing.assert_array_equal(got[floor], want[floor])


@pytest.mark.parametrize("length", [1, 2, 5, 300, 512, 513])
def test_frame_signal_reflects_like_numpy(length):
    x = np.arange(length, dtype=np.float32)
    for pad in (0, 3, 7, 512, 1500):
        src = taudio.reflect_indices(length, -pad, length + pad)
        np.testing.assert_array_equal(x[src], np.pad(x, pad, mode="reflect"))
    got = taudio.frame_signal(torch.from_numpy(x)[None], 1024, 256).numpy()
    want = np.asarray(jaudio.frame_signal(jnp.asarray(x)[None], 1024, 256))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("args", [(513, 80, 80.0, 7600.0, 16000), (513, 8, 80.0, 7600.0, 16000),
                                  (257, 40, 0.0, 8000.0, 16000)])
def test_window_and_mel_bank_equal_jax(args):
    np.testing.assert_array_equal(taudio.mel_filter_bank(*args), jaudio.mel_filter_bank(*args))
    for n, periodic in ((1024, True), (400, False)):
        np.testing.assert_array_equal(taudio.hann_window(n, periodic),
                                      jaudio.hann_window(n, periodic))


@pytest.mark.parametrize("num_mel_bins,fft_length", [(80, 1024), (8, 1024), (40, 512)])
def test_kernel_constants_rebuild_the_dense_bank(num_mel_bins, fft_length):
    window, twiddle, ranges, weights = lm._host_constants(
        16000, fft_length, fft_length, num_mel_bins, 80.0, 7600.0)
    dense = taudio.mel_filter_bank(fft_length // 2 + 1, num_mel_bins, 80.0, 7600.0, 16000)
    rebuilt = np.zeros_like(dense)
    for j, (lo, n) in enumerate(ranges):
        rebuilt[lo:lo + n, j] = weights[j, :n]
        assert not weights[j, n:].any()
    np.testing.assert_array_equal(rebuilt, dense)
    # the twiddle table: each FFT pass (r, p) holds W_{rp}^{s k} at
    # p - 1 + (s - 1) p + k, then the post-pass's W_N^k, k = 0..N/2, at N/2 - 1
    m = fft_length // 2
    assert twiddle.shape == (2 * m, 2)
    for r, p in lm.fft_plan(m):
        s_, k = np.meshgrid(np.arange(1, r), np.arange(p), indexing="ij")
        w = np.exp(-2j * np.pi * s_ * k / (r * p)).ravel()
        np.testing.assert_array_equal(twiddle[p - 1:p - 1 + (r - 1) * p],
                                      np.stack([w.real, w.imag], -1).astype(np.float32))
    w = np.exp(-2j * np.pi * np.arange(m + 1) / fft_length)
    np.testing.assert_array_equal(twiddle[m - 1:],
                                  np.stack([w.real, w.imag], -1).astype(np.float32))
    np.testing.assert_array_equal(window, jaudio.hann_window(fft_length).astype(np.float32))
    assert ranges[:, 1].sum() <= 2 * (fft_length // 2 + 1)   # a bin lies in <= 2 triangles


def test_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    wav = torch.from_numpy(_wav((2, 5000), seed=3))
    before = lm.fused_log_mel.launches
    got = lm.fused_log_mel(wav, num_mel_bins=8)
    assert lm.fused_log_mel.launches == before
    torch.testing.assert_close(got, lm.fused_log_mel_plain(wav, num_mel_bins=8), atol=0, rtol=0)


@pytest.mark.cuda
def test_cuda_wrapper_refuses_grad_and_other_dtypes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    wav = torch.zeros(2, 4000, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        lm.fused_log_mel(wav.clone().requires_grad_())
    with pytest.raises(ValueError, match="float32"):
        lm.fused_log_mel(wav.double())
    got = lm.fused_log_mel(wav + 0.1 * torch.randn_like(wav))
    assert got.shape == (2, 16, 80) and torch.isfinite(got).all()
