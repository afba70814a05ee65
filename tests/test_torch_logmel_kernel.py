"""Kernel B7 (``csrc/logmel.cu``) and its wrapper without JAX: the warp
FFT's schedule (:func:`fft_plan`) and twiddle table (:func:`twiddle_table`)
modelled in numpy against ``np.fft.rfft`` at every ``fft_length`` the
wrapper takes, the kernel's shared-memory swizzle, the split between frames
read straight from the row and edge frames (``interior_frames`` here)
against ``frame_signal``'s indices, and, on a CUDA device (marker
``cuda``), the kernel against its plain version: every ``fft_length``, 8,
80 and 128 mel bins, rows shorter than the reflect pad, leading dims.

This file imports no JAX, so on a GPU machine without it run:
``python -m pytest --noconftest tests/test_torch_logmel_kernel.py -m cuda``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from loco_asr_tpu_torch.ops import audio
from loco_asr_tpu_torch.ops.cuda import logmel as lm

FFT_LENGTHS = [64, 128, 256, 512, 1024, 2048, 4096]
TOL = 2e-4    # atol and rtol, the JAX package's own fused_log_mel test


def interior_frames(t, frame_length, hop):
    """[n_frames] bool: the frames the kernel reads straight from the row
    (``fr.interior`` in logmel.cu: base >= 0 and base + frame_length <= t,
    base = f hop - frame_length // 2); the others take the reflect index."""
    pad = frame_length // 2
    base = np.arange(1 + (t + 2 * pad - frame_length) // hop) * hop - pad
    return (base >= 0) & (base + frame_length <= t)


def log10_split(s):
    """The kernel's log10 (``log10_split`` in logmel.cu) in float32 numpy:
    s = m 2^e, m in [sqrt(1/2), sqrt(2)), e log10(2) as a hi + lo pair; numpy's
    log10 of m stands in for log10f, and each fma rounds once."""
    s = np.asarray(s, np.float32)
    m, e = np.frexp(s)
    low = m < np.float32(0.70710678)
    m, e = np.where(low, m * np.float32(2), m), np.where(low, e - 1, e)
    fe = e.astype(np.float64)
    inner = np.float32(fe * np.float64(np.float32(-1.4320989e-08))
                       + np.log10(m).astype(np.float32))
    return np.float32(fe * np.float64(np.float32(0.30103001)) + inner)


def _swz(n):
    """The kernel's shared-memory slot of point n (``swz`` in logmel.cu)."""
    return n ^ (((n >> 4) & 7) | ((n >> 3) & 8))


def _model_rfft(x, fft_length):
    """|rfft| of a real frame as the warp kernel computes it, in complex64:
    the samples packed as m complex points, the Stockham passes of
    ``fft_plan`` with the twiddles read from ``twiddle_table`` and the
    points kept at their swizzled slots, then the real post-pass, bins k
    and m - k from the same two points."""
    m = fft_length // 2
    tw = lm.twiddle_table(fft_length)
    tw = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    z = (x[0::2] + 1j * x[1::2]).astype(np.complex64)
    buf = np.zeros(m, np.complex64)
    buf[_swz(np.arange(m))] = z
    for r, p in lm.fft_plan(m):
        nb = m // r
        i = np.arange(nb)
        k = i % p
        v = buf[_swz(i[:, None] + np.arange(r)[None, :] * nb)]
        if p > 1:
            v[:, 1:] *= tw[p - 1 + (np.arange(1, r)[None, :] - 1) * p + k[:, None]]
        dft = np.exp(-2j * np.pi * np.outer(np.arange(r), np.arange(r)) / r)
        v = (v @ dft.astype(np.complex64)).astype(np.complex64)
        buf[_swz(((i - k) * r + k)[:, None] + np.arange(r)[None, :] * p)] = v
    # bins k and m - k, k <= m / 2, from Z[k] and Z[m - k]
    kk = np.arange(m // 2 + 1)
    a, c = buf[_swz(kk % m)], np.conj(buf[_swz((m - kk) % m)])
    even, odd = 0.5 * (a + c), -0.5j * (a - c)
    t = tw[m - 1 + kk] * odd
    x = np.empty(m + 1, np.complex64)
    x[m - kk] = np.conj(even - t)
    x[kk] = even + t
    return x


@pytest.mark.parametrize("fft_length", FFT_LENGTHS)
def test_fft_schedule_matches_numpy_rfft(fft_length):
    x = np.random.default_rng(fft_length).standard_normal(fft_length).astype(np.float32)
    want = np.fft.rfft(x.astype(np.float64))
    got = _model_rfft(x, fft_length)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("fft_length", FFT_LENGTHS)
def test_twiddle_table_layout(fft_length):
    m = fft_length // 2
    tw = lm.twiddle_table(fft_length)
    assert tw.shape == (2 * m, 2)
    plan = lm.fft_plan(m)
    assert np.prod([r for r, _ in plan]) == m and plan[0][1] == 1
    assert sum(p * (r - 1) for r, p in plan) == m - 1      # the passes fill [0, m - 1)
    post = np.exp(-2j * np.pi * np.arange(m + 1) / fft_length)
    np.testing.assert_array_equal(tw[m - 1:], np.stack([post.real, post.imag], -1)
                                  .astype(np.float32))


@pytest.mark.parametrize("m", [32, 64, 128, 256, 512])
def test_swizzle_is_a_permutation_and_free_of_bank_conflicts(m):
    """Within each 16 points (8-byte slots: 16 a bank cycle), and for the
    512-point plan the first two passes' writes and every read touch 16
    distinct slots a half-warp."""
    n = np.arange(m)
    assert sorted(_swz(n)) == list(n)
    if m != 512:
        return
    for r, p in lm.fft_plan(m):
        for half in range(0, m // r, 16):
            i = np.arange(half, half + 16)
            k = i % p
            for s in range(r):
                assert len(set(_swz(i + s * (m // r)) % 16)) == 16     # reads
                assert len(set(_swz((i - k) * r + k + s * p) % 16)) == 16   # writes


@pytest.mark.parametrize("t", [511, 512, 513, 300, 16001, 160000])
def test_interior_frames_read_no_reflected_sample(t):
    """A frame is interior exactly when ``frame_signal`` takes it from the
    row without reflection: its sources are base .. base + L - 1."""
    src = audio.reflect_indices(t, -512, t + 512)
    interior = interior_frames(t, 1024, 256)
    assert len(interior) == 1 + t // 256
    for f, inside in enumerate(interior):
        idx = src[f * 256:f * 256 + 1024]
        straight = f * 256 - 512 + np.arange(1024)
        assert inside == bool(np.array_equal(idx, straight)), (t, f)
    if t >= 2048:
        assert interior[2:-4].all() and not interior[:2].any()


@pytest.mark.parametrize("lo,hi", [(1e-10, 1e-6), (1e-6, 1e-2), (1e-2, 2.0), (2.0, 1e4)])
def test_split_log10_is_within_one_ulp(lo, hi):
    """The kernel's log10 over mel energies: within 0.5 ulp of the output
    plus 4e-8 of float64 (log10f's error on m, < 3e-8, and the inner fma's
    rounding, < 7.5e-9), where log10f alone may be 2 ulps off; and the mel
    floor's -10 exactly, as torch's float32 log10 gives it."""
    s = np.geomspace(lo, hi, 20001).astype(np.float32)
    got = log10_split(s).astype(np.float64)
    want = np.log10(s.astype(np.float64))
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    assert (np.abs(got - want) <= 0.5 * ulp + 4e-8).all()
    floor = np.float32(1e-10)
    assert log10_split(floor) == torch.log10(torch.tensor(floor)).item() == -10.0


def test_constants_bank_range_and_window():
    window, twiddle, ranges, weights = lm._host_constants(16000, 400, 512, 80, 80.0, 7600.0)
    assert window.shape == (512,) and not window[400:].any()
    np.testing.assert_array_equal(window[:400], audio.hann_window(400).astype(np.float32))
    lo, hi = lm.bin_range(ranges)
    bank = audio.mel_filter_bank(257, 80, 80.0, 7600.0, 16000)
    rows = np.flatnonzero(bank.any(axis=1))
    assert (lo, hi) == (rows[0], rows[-1] + 1)
    assert lm.bin_range(np.zeros((4, 2), np.int32)) == (0, 0)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check(got, want):
    diff = (got - want).abs()
    assert torch.isfinite(got).all()
    assert (diff <= TOL * (1.0 + want.abs())).all(), diff.max().item()
    floor = want == torch.log10(torch.tensor(1e-10, device=want.device))
    assert torch.equal(got[floor], want[floor])


@pytest.mark.cuda
@pytest.mark.parametrize("fft_length", FFT_LENGTHS)
def test_cuda_kernel_matches_plain_at_every_fft_length(fft_length, cuda_dev):
    g = torch.Generator().manual_seed(fft_length)
    wav = (torch.randn(3, 9001, generator=g) * 0.1).to(cuda_dev)
    wav[2, 4000:] = 0.0
    kw = dict(frame_length=min(fft_length, 1024) - 24, hop=fft_length // 4,
              fft_length=fft_length, num_mel_bins=40 if fft_length >= 256 else 8)
    with torch.no_grad():
        got = lm.fused_log_mel(wav, **kw)
    torch.cuda.synchronize()
    _check(got, lm.fused_log_mel_plain(wav, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("num_mel_bins", [8, 80, 128])
@pytest.mark.parametrize("shape", [(8, 160000), (2, 300), (3, 16001), (2, 3, 8000), (1, 700)])
def test_cuda_kernel_matches_plain(shape, num_mel_bins, cuda_dev):
    g = torch.Generator().manual_seed(sum(shape) + num_mel_bins)
    wav = (torch.randn(*shape, generator=g) * 0.1).to(cuda_dev)
    before = lm.fused_log_mel.launches
    got = lm.fused_log_mel(wav, num_mel_bins=num_mel_bins)
    torch.cuda.synchronize()
    assert lm.fused_log_mel.launches == before + 1
    assert got.shape == (*shape[:-1], 1 + shape[-1] // 256, num_mel_bins)
    _check(got, lm.fused_log_mel_plain(wav, num_mel_bins=num_mel_bins))


@pytest.mark.cuda
def test_cuda_kernel_reads_unaligned_rows_and_views(cuda_dev):
    """Odd T puts every other row off 8 bytes; a sliced view is copied."""
    g = torch.Generator().manual_seed(7)
    base = (torch.randn(4, 12001, generator=g) * 0.1).to(cuda_dev)
    for wav in (base, base[:, 1:], base[1:3, :-1]):
        _check(lm.fused_log_mel(wav), lm.fused_log_mel_plain(wav))


def _out_pos(i, logp, logr):
    """Where a pass writes output 0 of butterfly i (``out_pos`` in logmel.cu)."""
    return ((i >> logp) << (logp + logr)) | (i & ((1 << logp) - 1))


@pytest.mark.parametrize("m", [32, 64, 128, 256, 512])
def test_exchange_addresses_split_into_lane_and_constant(m):
    """The kernel forms each slot as swz(lane part) ^ swz(constant part):
    right because swz is linear over GF(2) and the parts share no bit."""
    a, b = np.meshgrid(np.arange(1024), np.arange(1024))
    np.testing.assert_array_equal(_swz(a ^ b), _swz(a) ^ _swz(b))
    for r, p in lm.fft_plan(m):
        logr, logp, nb = r.bit_length() - 1, p.bit_length() - 1, m // r
        for lane in range(min(32, nb)):
            for bb in range(-(-nb // 32)):
                i = lane + 32 * bb
                for s in range(r):
                    assert _swz(i + s * nb) == _swz(lane) ^ _swz(32 * bb + s * nb)
                    want = (i - i % p) * r + i % p + s * p
                    got = (_swz(_out_pos(lane, logp, logr))
                           ^ _swz(_out_pos(32 * bb, logp, logr) | (s << logp)))
                    assert got == _swz(want)
