"""Kernel B2 (``csrc/conv_frontend.cu``) and its wrapper without JAX: the
statistics' chunk geometry (:func:`stat_chunk`), the kernel's arithmetic
(chunked f32 tap sums and gram, folded into one gain and offset a channel,
the Abramowitz-Stegun GELU, ``gelu_as`` here) modelled in numpy against the
plain version, including zero-padded rows and a DC offset, and, on a CUDA
device (marker ``cuda``), the kernel against its plain version at B 1, 3,
16 and F 1, 127, 128, 129, 15999, with odd T, and its guards.

This file imports no JAX, so on a GPU machine without it run:
``python -m pytest --noconftest tests/test_torch_conv_frontend_kernel.py -m cuda``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from loco_asr_tpu_torch.ops.cuda import conv_frontend as cf
from loco_asr_tpu_torch.ops.layers import gelu

H100_SMS = 132
STAT_THREADS = 256    # threads of a statistics block (STAT_THREADS in conv_frontend.cu)


def gelu_as(z: torch.Tensor) -> torch.Tensor:
    """The kernel's GELU (``gelu_as`` in conv_frontend.cu): 0.5 z (1 +
    erf(z / sqrt 2)) with the TPU kernel's Abramowitz-Stegun 7.1.26 erf
    (|err| <= 1.5e-7), written as max(z, 0) - |z|/2 P(t) exp(-z^2 / 2),
    t = 1 / (1 + 0.3275911 |z| / sqrt 2)."""
    a = z.abs()
    t = 1.0 / (1.0 + (0.3275911 * 0.70710678118654752) * a)
    p = 0.5 * (0.254829592 + t * (-0.284496736 + t * (1.421413741
               + t * (-1.453152027 + t * 1.061405429))))
    return torch.clamp(z, min=0.0) - (a * t) * p * torch.exp(-0.5 * z * z)


def _inputs(b, t, c=512, seed=0, dc=0.0):
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal((b, t)) * 0.1 + dc).astype(np.float32)
    w = (rng.standard_normal((c, 1, 10)) * 0.3).astype(np.float32)
    scale = (rng.standard_normal(c) * 0.2 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return wav, w, scale, bias


@pytest.mark.parametrize("f", [1, 127, 128, 129, 4689, 12799, 15999, 31999, 192000])
def test_chunks_count_every_frame_once(f):
    for b in range(1, 17):
        chunk = cf.stat_chunk(b, f, H100_SMS)
        assert chunk % 32 == 0 and 128 <= chunk <= cf.MAX_CHUNK
        assert (chunk * 5 + 5) * 4 + (STAT_THREADS // 32 + 1) * cf.N_STATS * 4 <= 48 * 1024
        chunks = -(-f // chunk)
        seen = np.zeros(f, np.int64)
        for q in range(chunks):
            seen[q * chunk:min(f, (q + 1) * chunk)] += 1
        assert (seen == 1).all()
        # the statistics fill the card, a block an SM at least, unless the
        # rows are short, and run in one wave of two blocks an SM
        assert b * chunks >= min(H100_SMS, b * -(-f // 128))
        assert b * chunks <= 2 * H100_SMS or chunk in (128, cf.MAX_CHUNK)


def _model_b2(wav, w, scale, bias, chunk):
    """The kernel's float32 arithmetic: per chunk its 10 tap sums and the
    gram of its centred taps, the chunks combined in order by Chan et al.'s
    rule (about chunk 0's means) into the row's tap means and covariance, each channel's mean and
    variance folded into gain and offset, y = sum_i (w_i gain) t_i + off,
    then the A-S GELU."""
    b, t = wav.shape
    f = (t - 10) // 5 + 1
    taps = np.stack([wav[:, i:i + 5 * (f - 1) + 1:5] for i in range(10)], -1)   # [B, F, 10]
    wc = w[:, 0, :]
    out = np.empty((b, w.shape[0], f), np.float32)
    for r in range(b):
        parts = []
        for q in range(0, f, chunk):
            x = taps[r, q:q + chunk]
            s = x.sum(0, dtype=np.float32)
            c = x - s / np.float32(len(x))
            # each chunk's sums rounded once to f32, as the kernel's tree
            # of shuffles keeps them to a few ulp
            parts.append((np.float32(len(x)), s,
                          np.einsum("fi,fj->ij", c, c, dtype=np.float64).astype(np.float32)))
        m0 = parts[0][1] / parts[0][0]          # the pivot: chunk 0's tap means
        mean = sum(s for _, s, _ in parts) / np.float32(f)
        cov = sum(g + n * np.outer(s / n - m0, s / n - m0) for n, s, g in parts)
        cov = (cov / np.float32(f) - np.outer(mean - m0, mean - m0)).astype(np.float32)
        ymean = wc @ mean
        var = np.einsum("ci,ij,cj->c", wc, cov, wc, dtype=np.float32)
        gain = (scale / np.sqrt(var + np.float32(cf.EPS))).astype(np.float32)
        off = bias - ymean * gain
        z = np.einsum("fi,ci->cf", taps[r], wc * gain[:, None]) + off[:, None]
        out[r] = gelu_as(torch.from_numpy(z.astype(np.float32))).numpy()
    return out


@pytest.mark.parametrize("case", ["plain", "padded_rows", "dc_offset"])
def test_chunked_statistics_and_fold_match_plain(case):
    wav, w, scale, bias = _inputs(3, 6003, c=64, seed=1, dc=0.5 if case == "dc_offset" else 0.0)
    if case == "padded_rows":
        wav[1, 2000:] = 0.0
        wav[2, 300:] = 0.0
    f = (wav.shape[1] - 10) // 5 + 1
    got = _model_b2(wav, w, scale, bias, cf.stat_chunk(3, f, H100_SMS))
    plain = cf.conv1_instance_norm_gelu_plain(*map(torch.from_numpy, (wav, w, scale, bias)))
    exact = cf.conv1_instance_norm_gelu_plain(*(torch.from_numpy(a).double()
                                                for a in (wav, w, scale, bias)))
    err, plain_err = (np.abs(x - exact.numpy()).max() for x in (got, plain.numpy()))
    # within 2e-5 of float64 and of the plain version (whose own E[y^2] -
    # mean^2 in float32 loses more to a DC offset); each bound reported
    # alone, with the entry and its three values, should it fail again
    at = np.unravel_index(np.abs(got - exact.numpy()).argmax(), got.shape)
    assert err <= 2e-5, (err, at, got[at], plain.numpy()[at], exact.numpy()[at],
                         torch.get_num_threads())
    assert np.abs(got - plain.numpy()).max() <= 2e-5 + plain_err, (err, plain_err)


def test_abramowitz_stegun_gelu_matches_erf_gelu():
    z = torch.linspace(-12.0, 12.0, 240001, dtype=torch.float64)
    want = gelu(z)
    got = gelu_as(z.float()).double()
    assert (got - want).abs().max().item() <= 1e-6
    assert gelu_as(torch.tensor([0.0, -30.0, 30.0])).tolist() == [0.0, -0.0, 30.0]


def test_wrapper_on_cpu_needs_no_chunking():
    wav, w, scale, bias = _inputs(2, 3001, c=16)
    args = tuple(map(torch.from_numpy, (wav, w, scale, bias)))
    before = cf.conv1_instance_norm_gelu.launches
    got = cf.conv1_instance_norm_gelu(*args)
    assert cf.conv1_instance_norm_gelu.launches == before
    assert got.shape == (2, 16, 599)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False     # the plain version's conv in f32
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = old


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("f,extra", [(1, 0), (127, 3), (128, 0), (129, 4), (15999, 0),
                                     (15999, 2)])
def test_cuda_kernel_matches_plain(b, f, extra, cuda_dev):
    t = 5 * (f - 1) + 10 + extra
    args = [torch.from_numpy(a).to(cuda_dev) for a in _inputs(b, t, seed=f + b)]
    if b > 1:
        args[0][-1, t // 3:] = 0.0        # a zero-padded row
    before = cf.conv1_instance_norm_gelu.launches
    with torch.no_grad():
        got = cf.conv1_instance_norm_gelu(*args)
    torch.cuda.synchronize()
    assert cf.conv1_instance_norm_gelu.launches == before + 1
    want = cf.conv1_instance_norm_gelu_plain(*args)
    assert got.shape == want.shape == (b, 512, f)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_cuda_kernel_with_dc_offset_and_few_channels(cuda_dev):
    """A DC offset: the kernel stays within 1e-4 of float64, and no further
    from it than the plain version in float32."""
    args = [torch.from_numpy(a).to(cuda_dev) for a in _inputs(4, 64000, c=200, seed=3, dc=0.5)]
    got = cf.conv1_instance_norm_gelu(*args)
    exact = cf.conv1_instance_norm_gelu_plain(*(a.double() for a in args))
    plain_err = (cf.conv1_instance_norm_gelu_plain(*args) - exact).abs().max().item()
    err = (got - exact).abs().max().item()
    assert err <= 1e-4 and err <= plain_err + 1e-5


@pytest.mark.cuda
def test_cuda_guards(cuda_dev):
    wav, w, scale, bias = (torch.from_numpy(a).to(cuda_dev) for a in _inputs(2, 4000))
    with pytest.raises(RuntimeError, match="no backward"):
        cf.conv1_instance_norm_gelu(wav, w.clone().requires_grad_(), scale, bias)
    with pytest.raises(ValueError, match="k=10"):
        cf.conv1_instance_norm_gelu(wav, w[:, :, :8].contiguous(), scale, bias, stride=4)
