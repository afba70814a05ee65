"""Kernel B1 (``csrc/flash_rel.cu``) and its wrappers without JAX: the
kernel's numerics (three TF32 passes per product, the band included)
emulated on the CPU, the direct launch under ``no_grad`` against the
autograd path, the build's hash of the headers, and, on a CUDA device
(marker ``cuda``), the kernel against its plain version: rel-pos, causal,
mask-only, Tq != Tk, ragged lengths, ``valid_len`` 0, head dims 8 to 128
(the LoCo experiment's tiny encoder runs 8), and q/k/v given as
``split_heads``-style transposed views and as GPT-2 qkv column views.

This file imports no JAX, so on a GPU machine without it run:
``python -m pytest --noconftest tests/test_torch_flash_rel_kernel.py -m cuda``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from loco_asr_tpu_torch.ops.cuda import _build
from loco_asr_tpu_torch.ops.cuda import flash_attention as tfa
from loco_asr_tpu_torch.ops.cuda import flash_causal as tfc

LOG2E = np.float32(np.log2(np.e))


def _tf32(x):
    """float32 -> the nearest TF32 value, ties away from zero (the
    kernel's big part: low 13 mantissa bits cleared after adding 0x1000)."""
    i = np.ascontiguousarray(x, np.float32).view(np.int32)
    return ((i + 0x1000) & ~0x1FFF).view(np.float32)


def _tf32_trunc(x):
    """float32 -> TF32 by dropping the low 13 mantissa bits, as the mma
    reads the small part."""
    i = np.ascontiguousarray(x, np.float32).view(np.int32)
    return (i & ~0x1FFF).view(np.float32)


def _mm_tf32(a, b, passes):
    """a @ b as the kernel forms it: k-steps of 8, each product exact into
    an f32 accumulator; three passes (small.big, big.small, big.big) or
    one (big.big)."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32_trunc(a - a_big), _tf32_trunc(b - b_big)
    terms = ([(a_small, b_big), (a_big, b_small), (a_big, b_big)] if passes == 3
             else [(a_big, b_big)])
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    for c in range(0, a.shape[-1], 8):
        for x, y in terms:
            acc = (acc + np.matmul(x[..., c:c + 8].astype(np.float64),
                                   y[..., c:c + 8, :].astype(np.float64))).astype(np.float32)
    return acc


def _band(t, two_l):
    i = np.arange(t)
    return np.clip(i[:, None] - i[None, :], -(two_l // 2), two_l // 2 - 1) + two_l // 2


def _emulated_b1(q, k, v, pe, scale, band_passes, passes=3):
    """B1's f32 arithmetic on unpadded rows: the table scale*log2e *
    q.pe^T gathered at clip(i - j) + L, plus scale*log2e * q.k^T, softmax
    in base 2, out = p.v / sum p.  ``band_passes`` applies to q.pe^T,
    ``passes`` to the two other products."""
    c2 = np.float32(scale) * LOG2E
    tab = _mm_tf32(q, pe.T, band_passes) * c2
    s = _mm_tf32(q, np.swapaxes(k, -1, -2), passes) * c2
    s = s + np.take_along_axis(tab, np.broadcast_to(_band(q.shape[-2], pe.shape[0]),
                                                    s.shape), axis=-1)
    m = s.max(axis=-1, keepdims=True)
    p = np.exp2(s - m).astype(np.float32)
    return _mm_tf32(p, v, passes) / p.sum(axis=-1, keepdims=True, dtype=np.float32)


def test_three_tf32_passes_keep_the_band_f32_accurate():
    """At [1, 2, 256, 64], L = 160, with a large rel table (the band term
    dominates the scores): three TF32 passes for every product stay within
    2e-6 of float64; one pass for the band product alone misses the
    kernels' 1e-4 tolerance."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 2, 256, 64)).astype(np.float32) * 0.5
               for _ in range(3))
    pe = rng.standard_normal((320, 64)).astype(np.float32) * 2.0
    scale = 0.125
    qd = q.astype(np.float64)
    s = (qd @ np.swapaxes(k, -1, -2).astype(np.float64)
         + np.take_along_axis(qd @ pe.T.astype(np.float64),
                              np.broadcast_to(_band(256, 320), (1, 2, 256, 256)), -1)) * scale
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    want = p @ v.astype(np.float64) / p.sum(axis=-1, keepdims=True)
    assert np.abs(_emulated_b1(q, k, v, pe, scale, band_passes=3) - want).max() <= 2e-6
    assert np.abs(_emulated_b1(q, k, v, pe, scale, band_passes=1) - want).max() > 1e-4


def _inputs(b, h, tq, tk, two_l, seed, device="cpu", d=64):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, h, t, d, generator=g) * 0.3 for t in (tq, tk, tk))
    pe = torch.randn(two_l, d, generator=g) * 0.3
    return [x.to(device) for x in (q, k, v, pe)]


@pytest.mark.parametrize("mask_only", [False, True])
def test_no_grad_launch_matches_autograd_path(mask_only, monkeypatch):
    """Without grad the wrapper skips the autograd Function and returns
    the same numbers; with grad it goes through it and out has a
    grad_fn.  On the CPU neither counts a launch."""
    q, k, v, pe = _inputs(2, 3, 30, 30, 8, seed=1)
    pe = None if mask_only else pe
    vl = torch.tensor([30, 11], dtype=torch.int32)
    applied = []
    real = tfa._FlashRel.apply
    monkeypatch.setattr(tfa._FlashRel, "apply",
                        lambda *a: (applied.append(1), real(*a))[1])
    before = tfa.flash_rel_forward.launches
    with torch.no_grad():
        out0, lse0 = tfa.flash_rel_forward(q, k, v, pe, vl, causal=True, scale=0.5)
    out1, lse1 = tfa.flash_rel_forward(q, k, v, pe, vl, causal=True, scale=0.5)
    assert applied == [] and out0.grad_fn is None and out1.grad_fn is None
    qg = q.clone().requires_grad_()
    out2, lse2 = tfa.flash_rel_forward(qg, k, v, pe, vl, causal=True, scale=0.5)
    assert applied == [1] and out2.grad_fn is not None
    for o, l in ((out1, lse1), (out2, lse2)):
        torch.testing.assert_close(o, out0, rtol=0, atol=0)
        torch.testing.assert_close(l, lse0, rtol=0, atol=0)
    assert tfa.flash_rel_forward.launches == before


def test_flash_attention_mask_only_equals_zero_table():
    """flash_attention without rel_pe is the zero-table forward, and
    flash_rel_forward(pe=None) too; both allocate their constants once."""
    q, k, v, _ = _inputs(2, 2, 24, 40, 2, seed=2)
    vl = torch.tensor([40, 17], dtype=torch.int32)
    want, _ = tfa.flash_rel_forward(q, k, v, torch.zeros(2, 64), vl, causal=False, scale=1.0)
    got = tfa.flash_attention(q, k, v, causal=False, scale=1.0, kv_valid_len=vl)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with torch.inference_mode():   # made here, still fit for autograd to save
        got = tfa.flash_attention(q[:, :, :5], k[:, :, :7], v[:, :, :7], causal=False,
                                  scale=1.0, rel_pe=torch.zeros(2, 64))
    ones = tfa._full_lengths(2, 7, q.device)
    assert ones.tolist() == [7, 7] and not ones.is_inference()
    assert tfa._full_lengths(2, 7, q.device) is ones
    assert tfa._zero_table(64, q.dtype, q.device) is tfa._zero_table(64, q.dtype, q.device)


def test_b5_no_grad_launch_matches_autograd_path(monkeypatch):
    q, k, v, _ = _inputs(1, 2, 20, 20, 2, seed=3)
    applied = []
    real = tfc._FlashCausal.apply
    monkeypatch.setattr(tfc._FlashCausal, "apply",
                        lambda *a: (applied.append(1), real(*a))[1])
    with torch.inference_mode():
        out0, _ = tfc.flash_forward(q, k, v, causal=True, scale=0.3)
    out1, _ = tfc.flash_forward_nhd(*(x.transpose(1, 2) for x in (q, k, v)),
                                    causal=True, scale=0.3)
    assert applied == []
    out2, _ = tfc.flash_forward(q.requires_grad_(), k, v, causal=True, scale=0.3)
    assert applied == [1] and out2.grad_fn is not None
    torch.testing.assert_close(out1.transpose(1, 2), out0, rtol=0, atol=0)
    torch.testing.assert_close(out2, out0, rtol=0, atol=0)


def test_library_path_hashes_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh changes the library's name, so a stale build
    is never loaded; an unrelated file does not."""
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    first = _build.library_path()
    (tmp_path / "notes.txt").write_text("not a source")
    assert _build.library_path() == first
    (tmp_path / "h.cuh").write_text("// v2\n")
    assert _build.library_path() != first


@pytest.fixture
def cuda_f32():
    """The card, with TF32 off for the plain version's matmuls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


def _kernel_vs_plain(q, k, v, pe, vl, causal):
    """Max abs error of the kernel against the plain version, out and lse,
    through the wrapper (one launch counted)."""
    table = torch.zeros(2, q.shape[-1], device=q.device) if pe is None else pe
    before = tfa.flash_rel_forward.launches
    with torch.no_grad():
        out, lse = tfa.flash_rel_forward(q, k, v, pe, vl, causal=causal, scale=1.0)
    assert tfa.flash_rel_forward.launches == before + 1
    torch.cuda.synchronize()
    pout, plse = tfa.flash_rel_forward_plain(q, k, v, table, vl, causal=causal, scale=1.0)
    assert out.shape == pout.shape and lse.shape == plse.shape
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    # out is a [B, H, Tq, D] view of a [B, Tq, H, D] buffer
    assert out.transpose(1, 2).is_contiguous()
    return max((out - pout).abs().max().item(), (lse - plse).abs().max().item())


# (B, Tq, Tk, 2L or 0 for mask-only, causal, valid lengths)
CUDA_CASES = {
    "rel": (3, 249, 249, 320, False, [249, 230, 17]),
    "rel_causal": (2, 249, 249, 320, True, [249, 100]),
    "mask_only": (3, 249, 249, 0, False, [249, 150, 40]),
    "mask_only_causal": (2, 200, 200, 0, True, [200, 131]),
    "cross_160x500": (2, 160, 500, 0, False, [500, 310]),
    "cross_rel": (2, 160, 500, 320, False, [500, 310]),
    "ragged": (2, 77, 77, 8, False, [77, 1]),
    "ragged_causal": (2, 65, 65, 40, True, [65, 64]),
    "long": (1, 1100, 1100, 320, False, [1037]),
    "vl0": (3, 100, 100, 320, False, [100, 0, 37]),
    "vl0_mask_only_causal": (3, 100, 100, 0, True, [0, 100, 0]),
    "tq1": (2, 1, 70, 320, False, [70, 0]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_cuda_kernel_matches_plain(case, cuda_f32):
    b, tq, tk, two_l, causal, vls = CUDA_CASES[case]
    q, k, v, pe = _inputs(b, 4, tq, tk, max(two_l, 2), seed=tq + tk, device=cuda_f32)
    vl = torch.tensor(vls, dtype=torch.int32, device=cuda_f32)
    err = _kernel_vs_plain(q, k, v, pe if two_l else None, vl, causal)
    assert err <= 1e-4, f"{case}: max abs err {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["split_heads", "qkv_columns"])
def test_cuda_kernel_reads_strided_views(layout, cuda_f32):
    """q, k, v as the encoder hands them (``split_heads``: transposed views
    of [B, T, H*64] projections) and as a padded GPT-2 batch does (column
    views of one qkv projection, transposed), read in place."""
    b, t, h = 3, 130, 4
    g = torch.Generator().manual_seed(t)
    if layout == "split_heads":
        q, k, v = (torch.randn(b, t, h * 64, generator=g).to(cuda_f32)
                   .reshape(b, t, h, 64).transpose(1, 2) for _ in range(3))
        pe, causal = torch.randn(320, 64, generator=g).to(cuda_f32) * 0.3, False
    else:
        x = torch.randn(b, t, 3 * h * 64, generator=g).to(cuda_f32)
        q, k, v = (y.reshape(b, t, h, 64).transpose(1, 2) for y in x.split(h * 64, dim=-1))
        pe, causal = None, True
    assert not q.is_contiguous()
    vl = torch.tensor([t, 99, 0], dtype=torch.int32, device=cuda_f32)
    assert _kernel_vs_plain(q * 0.3, k, v, pe, vl, causal) <= 1e-4
    assert _kernel_vs_plain(q, k, v, pe, vl, causal) <= 1e-4


@pytest.mark.cuda
def test_cuda_no_grad_and_autograd_launch_alike(cuda_f32):
    """Under no_grad the direct launch counts one launch and matches the
    autograd path bit for bit; with grad, out carries a grad_fn."""
    q, k, v, pe = _inputs(2, 4, 90, 90, 320, seed=5, device=cuda_f32)
    vl = torch.tensor([90, 61], dtype=torch.int32, device=cuda_f32)
    n0 = tfa.flash_rel_forward.launches
    with torch.no_grad():
        out0, lse0 = tfa.flash_rel_forward(q, k, v, pe, vl, causal=False, scale=1.0)
    n1 = tfa.flash_rel_forward.launches
    out1, lse1 = tfa.flash_rel_forward(q.requires_grad_(), k, v, pe, vl, causal=False,
                                       scale=1.0)
    assert n1 - n0 == 1 and tfa.flash_rel_forward.launches - n1 == 1
    assert out0.grad_fn is None and out1.grad_fn is not None
    torch.testing.assert_close(out1, out0, rtol=0, atol=0)
    torch.testing.assert_close(lse1, lse0, rtol=0, atol=0)


# (B, H, Tq, Tk, D, 2L or 0 for mask-only, causal, valid lengths); the LoCo
# experiment's ASR encoder is [4 slots, 4 heads, T, 8] with L = 20
HEAD_DIM_CASES = {
    "loco_encoder_d8": (4, 4, 509, 509, 8, 40, False, [509, 431, 120, 0]),
    "loco_mask_only_d8": (4, 4, 509, 509, 8, 0, False, [509, 431, 120, 0]),
    "causal_d8": (2, 4, 130, 130, 8, 40, True, [130, 67]),
    "loco_encoder_d32": (4, 4, 509, 509, 32, 40, False, [509, 431, 120, 0]),
    "mask_only_d32": (4, 4, 509, 509, 32, 0, False, [509, 431, 120, 0]),
    "cross_d32": (2, 4, 70, 300, 32, 320, False, [300, 211]),
    "rel_d16": (2, 4, 249, 249, 16, 320, False, [249, 100]),
    "rel_d128": (2, 2, 249, 249, 128, 320, True, [249, 0]),
    "mask_only_d128": (2, 2, 249, 249, 128, 0, False, [249, 188]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(HEAD_DIM_CASES))
def test_cuda_kernel_head_dims_match_plain(case, cuda_f32):
    """B1 at every head dim it is built for, with the band and mask-only,
    padded rows and a row of valid length 0."""
    b, h, tq, tk, d, two_l, causal, vls = HEAD_DIM_CASES[case]
    q, k, v, pe = _inputs(b, h, tq, tk, max(two_l, 2), seed=tq + d, device=cuda_f32, d=d)
    vl = torch.tensor(vls, dtype=torch.int32, device=cuda_f32)
    err = _kernel_vs_plain(q, k, v, pe if two_l else None, vl, causal)
    assert err <= 1e-4, f"{case}: max abs err {err}"


@pytest.mark.cuda
def test_cuda_refuses_head_dims_not_built(cuda_f32):
    """A head dim without an instantiation up to 128 (24 here) runs the
    next one up on zero-padded operands, forward and backward, with the
    plain version's numbers; above 128 nothing is built and the wrappers
    raise before any launch."""
    q, k, v, pe = _inputs(1, 2, 20, 20, 8, seed=0, device=cuda_f32, d=24)
    vl = torch.tensor([20], dtype=torch.int32, device=cuda_f32)
    out, lse = tfa.flash_rel_forward(q, k, v, pe, vl, causal=False, scale=1.0)
    pout, plse = tfa.flash_rel_forward_plain(q, k, v, pe, vl, causal=False, scale=1.0)
    assert out.shape == pout.shape
    assert max((out - pout).abs().max().item(), (lse - plse).abs().max().item()) <= 1e-4
    got = tfa.flash_rel_backward(q, k, v, pe, vl, out, lse, torch.ones_like(out),
                                 causal=False, scale=1.0)
    assert [tuple(x.shape) for x in got] == [tuple(q.shape)] * 3 + [tuple(pe.shape)]
    q, k, v, pe = _inputs(1, 2, 20, 20, 8, seed=0, device=cuda_f32, d=136)
    with pytest.raises(ValueError, match="head dims up to 128"):
        tfa.flash_rel_forward(q, k, v, pe, vl, causal=False, scale=1.0)
    out, lse = tfa.flash_rel_forward_plain(q, k, v, pe, vl, causal=False, scale=1.0)
    with pytest.raises(ValueError, match="head dims up to 128"):
        tfa.flash_rel_backward(q, k, v, pe, vl, out, lse, torch.ones_like(out),
                               causal=False, scale=1.0)
