"""Kernels B3 + B4 (``csrc/flash_rel_bwd.cu``, the gradient of B1) and
their wrapper without JAX: the mask-only backward against the explicit
zero-table path, strided ``split_heads`` views against contiguous copies,
the three-pass TF32 split of the ds.k and p^T.g products emulated on the
CPU, and, on a CUDA device (marker ``cuda``), the kernels through
``flash_rel_backward`` against its plain version: the rel band with
padded rows, causal, mask-only through autograd, Tq != Tk, ``valid_len``
0, T not a tile multiple, and q/k/v/g as ``split_heads`` views.

This file imports no JAX, so on a GPU machine without it run:
``python -m pytest --noconftest tests/test_torch_flash_rel_bwd_kernel.py -m cuda``."""

import pytest

torch = pytest.importorskip("torch")

from loco_asr_tpu_torch.ops import attention as tattn
from loco_asr_tpu_torch.ops.cuda import flash_attention as tfa

TOL = 1e-4   # each gradient; dpe relative to its max


def _inputs(b, h, tq, tk, two_l, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, h, t, 64, generator=g) * 0.3 for t in (tq, tk, tk))
    pe = torch.randn(two_l, 64, generator=g) * 0.3
    cot = torch.randn(b, h, tq, 64, generator=g)
    return [x.to(device) for x in (q, k, v, pe, cot)]


def _grads(q, k, v, pe, vl, cot, causal):
    """Gradients of flash_attention's output under ``cot`` w.r.t. q, k, v
    (and pe when given)."""
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    if pe is not None:
        pe = pe.detach().clone().requires_grad_()
        leaves.append(pe)
    out = tfa.flash_attention(*leaves[:3], causal=causal, scale=0.125, rel_pe=pe,
                              kv_valid_len=vl)
    return torch.autograd.grad(out, leaves, cot)


@pytest.mark.parametrize("causal", [False, True])
def test_mask_only_backward_equals_zero_table_path(causal, monkeypatch):
    """flash_attention without rel_pe gives the dq, dk, dv of the explicit
    zero table; its backward runs as mask-only and computes no pe
    gradient."""
    q, k, v, _, cot = _inputs(2, 3, 37, 90, 2, seed=1)
    vl = torch.tensor([90, 41], dtype=torch.int32)
    calls = []
    real = tfa.flash_rel_backward
    monkeypatch.setattr(tfa, "flash_rel_backward",
                        lambda *a, **kw: (calls.append(kw), real(*a, **kw))[1])
    got = _grads(q, k, v, None, vl, cot, causal)
    assert [c["mask_only"] for c in calls] == [True]
    want = _grads(q, k, v, torch.zeros(2, 64), vl, cot, causal)
    assert calls[-1]["mask_only"] is False and len(want) == 4
    for a, w in zip(got, want[:3]):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    out, lse = tfa.flash_rel_forward(q, k, v, None, vl, causal=causal, scale=0.125)
    grads = real(q, k, v, torch.zeros(2, 64), vl, out, lse, cot, causal=causal,
                 scale=0.125, mask_only=True)
    assert grads[3] is None


@pytest.mark.parametrize("rel", [True, False])
def test_split_heads_views_and_contiguous_copies_agree(rel):
    """q, k, v as ``split_heads`` views of [B, T, H*64] projections (and the
    cotangent as the [B, T, H, 64] layout merge_heads hands back) give the
    gradients of contiguous copies."""
    b, t, h = 2, 45, 3
    g = torch.Generator().manual_seed(4)
    xs = [torch.randn(b, t, h * 64, generator=g) * 0.3 for _ in range(4)]
    pe = torch.randn(40, 64, generator=g) * 0.3 if rel else None
    vl = torch.tensor([t, 29], dtype=torch.int32)
    views = [tattn.split_heads(x, h) for x in xs]
    assert not views[0].is_contiguous()
    got = _grads(*views[:3], pe, vl, views[3], causal=False)
    want = _grads(*(x.contiguous() for x in views[:3]), pe, vl, views[3].contiguous(),
                  causal=False)
    assert len(got) == (4 if rel else 3)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-6, atol=1e-6)


def _tf32(x):
    """float32 -> the nearest TF32 value, ties away from zero (the kernels'
    big part: the low 13 mantissa bits cleared after adding 0x1000)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x):
    """float32 -> TF32 by dropping the low 13 mantissa bits, as the mma
    reads the small part."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a, b, passes):
    """a @ b as the kernels form it: k-steps of 8, each step's products
    exact into an f32 accumulator; three passes (small.big, big.small,
    big.big) or one (big.big)."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32_trunc(a - a_big), _tf32_trunc(b - b_big)
    terms = ([(a_small, b_big), (a_big, b_small), (a_big, b_big)] if passes == 3
             else [(a_big, b_big)])
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for c in range(0, a.shape[-1], 8):
        for x, y in terms:
            acc = (acc.double() + x[..., c:c + 8].double() @ y[..., c:c + 8, :].double()
                   ).float()
    return acc


@pytest.mark.parametrize("product", ["ds_k", "pt_g"])
def test_three_tf32_passes_keep_the_backward_products_f32_accurate(product):
    """dq = ds.k (B3) and dv = p^T.g (B4) at [1, 2, 256, 64] with the rel
    band, from the plain version's p and ds: three TF32 passes stay within
    1e-4 (and 1e-6 relative to the largest entry) of the float64 product;
    one pass is at least 30 times worse."""
    q, k, v, pe, cot = _inputs(1, 2, 256, 256, 320, seed=6)
    pe = pe * 6.0   # a band term that dominates the scores
    vl = torch.tensor([256], dtype=torch.int32)
    s = tfa._scores(q, k, pe, 0.125)
    out, lse = tfa.flash_rel_forward_plain(q, k, v, pe, vl, causal=False, scale=0.125)
    p = torch.exp(s - lse[..., None])
    delta = (cot * out).sum(-1)
    ds = p * (cot @ v.transpose(-1, -2) - delta[..., None])
    a, b = (ds, k) if product == "ds_k" else (p.transpose(-1, -2).contiguous(), cot)
    want = a.double() @ b.double()
    err3 = (_mm_tf32(a, b, 3).double() - want).abs().max().item()
    err1 = (_mm_tf32(a, b, 1).double() - want).abs().max().item()
    assert err3 <= TOL and err3 <= 1e-6 * want.abs().max().item()
    assert err1 >= 30 * err3


@pytest.fixture
def cuda_f32():
    """The card, with TF32 off for the plain version's matmuls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


def _plain(q, k, v, pe, vl, out, lse, cot, causal):
    """(dq, dk, dv, dpe) of the plain version, band matmuls included."""
    dq, dk, dv, dqpe = tfa.flash_rel_backward_plain(q, k, v, pe, vl, out, lse, cot,
                                                    causal=causal, scale=1.0)
    return dq + dqpe @ pe, dk, dv, torch.einsum("bhim,bhid->md", dqpe, q)


def _errors(got, want):
    errs = {n: (a - w).abs().max().item() for n, a, w in zip("qkv", got, want)}
    if got[3] is not None:
        errs["pe"] = (got[3] - want[3]).abs().max().item() / want[3].abs().max().item()
    return errs


def _kernels_vs_plain(q, k, v, pe, vl, cot, causal):
    """Errors of B3 + B4 through flash_rel_backward against the plain
    version (one launch counted; dq, dk, dv are views of [B, T, H, 64]
    buffers)."""
    out, lse = tfa.flash_rel_forward(q, k, v, pe, vl, causal=causal, scale=1.0)
    before = tfa.flash_rel_backward.launches
    got = tfa.flash_rel_backward(q, k, v, pe, vl, out, lse, cot, causal=causal, scale=1.0)
    torch.cuda.synchronize()
    assert tfa.flash_rel_backward.launches == before + 1
    for x in got:
        assert torch.isfinite(x).all()
    for x in got[:3]:
        assert x.transpose(1, 2).is_contiguous()
    return _errors(got, _plain(q, k, v, pe, vl, out, lse, cot, causal))


# (B, Tq, Tk, 2L, causal, valid lengths)
CUDA_CASES = {
    "rel_padded": (3, 249, 249, 320, False, [249, 230, 17]),
    "causal": (2, 249, 249, 320, True, [249, 100]),
    "tq_ne_tk": (2, 160, 500, 320, False, [500, 310]),
    "tq_gt_tk_causal": (2, 300, 70, 320, True, [70, 33]),
    "vl0": (3, 100, 100, 320, False, [100, 0, 37]),
    "t90": (2, 90, 90, 320, True, [90, 61]),
    "t61": (2, 61, 61, 8, False, [61, 33]),
    "l1": (2, 70, 70, 2, False, [70, 50]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_cuda_kernels_match_plain(case, cuda_f32):
    b, tq, tk, two_l, causal, vls = CUDA_CASES[case]
    q, k, v, pe, cot = _inputs(b, 4, tq, tk, two_l, seed=tq + tk, device=cuda_f32)
    vl = torch.tensor(vls, dtype=torch.int32, device=cuda_f32)
    errs = _kernels_vs_plain(q, k, v, pe, vl, cot, causal)
    assert max(errs.values()) <= TOL, f"{case}: {errs}"


@pytest.mark.cuda
def test_cuda_split_heads_views_read_in_place(cuda_f32):
    """q, k, v as split_heads views and the cotangent in merge_heads'
    layout, read in place by the kernels."""
    b, t, h = 3, 130, 4
    g = torch.Generator().manual_seed(t)
    q, k, v, cot = (tattn.split_heads(torch.randn(b, t, h * 64, generator=g).to(cuda_f32), h)
                    for _ in range(4))
    pe = torch.randn(320, 64, generator=g).to(cuda_f32) * 0.3
    vl = torch.tensor([t, 99, 0], dtype=torch.int32, device=cuda_f32)
    assert not q.is_contiguous() and not cot.is_contiguous()
    errs = _kernels_vs_plain(q * 0.3, k, v, pe, vl, cot, causal=False)
    assert max(errs.values()) <= TOL, errs


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_mask_only_through_autograd(causal, cuda_f32, monkeypatch):
    """pe=None through the autograd Function: the backward launches the
    mask-only kernels once and matches the plain version's dq, dk, dv."""
    q, k, v, _, cot = _inputs(2, 4, 160, 500, 2, seed=9, device=cuda_f32)
    vl = torch.tensor([500, 310], dtype=torch.int32, device=cuda_f32)
    modes = []
    real = tfa._launch_backward
    monkeypatch.setattr(tfa, "_launch_backward",
                        lambda *a, **kw: (modes.append(kw["mask_only"]), real(*a, **kw))[1])
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out, lse = tfa.flash_rel_forward(*leaves, None, vl, causal=causal, scale=1.0)
    got = torch.autograd.grad(out, leaves, cot)
    torch.cuda.synchronize()
    assert modes == [True]
    want = _plain(q, k, v, torch.zeros(2, 64, device=cuda_f32), vl, out.detach(), lse,
                  cot, causal)
    errs = _errors(list(got) + [None], want)
    assert max(errs.values()) <= TOL, errs
