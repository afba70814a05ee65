"""Kernels B5 and B6's plain versions (loco_asr_tpu_torch.ops.cuda.flash_causal)
against the JAX Pallas kernels in interpret mode, out and lse, atol/rtol
2e-5 as the JAX package's own kernel tests; the public dispatch of
``flash_attention_nhd`` and ``flash_attention``; the wrappers' rules for
CPU tensors; the kernel's numerics (three TF32 products per f32 product)
emulated on the CPU; and, on a CUDA device (marker ``cuda``), the kernel
against its plain version.

On a GPU machine without JAX, run the kernel tests alone:
``python -m pytest --noconftest tests/test_torch_flash_causal.py -m cuda``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax.numpy as jnp

    from loco_asr_tpu.ops.pallas.flash_attention import (_flash_forward, _flash_forward_nhd,
                                                         flash_attention, flash_attention_nhd)
except ImportError:   # only the tests marked ``cuda`` run without JAX
    jnp = None

from loco_asr_tpu_torch.ops.cuda import flash_attention as tfa
from loco_asr_tpu_torch.ops.cuda import flash_causal as tfc

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(shape_q, tk, seed):
    """q [B, H, Tq, D] and k/v with Tk keys, float32 from numpy."""
    rng = np.random.default_rng(seed)
    b, h, tq, d = shape_q
    q = rng.standard_normal((b, h, tq, d)).astype(np.float32) * 0.5
    k, v = (rng.standard_normal((b, h, tk, d)).astype(np.float32) * 0.5 for _ in range(2))
    return q, k, v


# (q shape [B, H, Tq, D], Tk, causal); non-causal Tk needs an 8-aligned
# block divisor for the JAX kernel
CASES = {
    "causal_d64": ((2, 2, 128, 64), 128, True),
    "noncausal_d64": ((2, 2, 96, 64), 96, False),
    "causal_ragged": ((1, 3, 77, 64), 77, True),
    "causal_t1": ((2, 2, 1, 64), 1, True),
    "causal_d8": ((2, 4, 40, 8), 40, True),
    "noncausal_d8": ((1, 2, 24, 8), 40, False),
    "tq_ne_tk_causal": ((2, 4, 100, 8), 128, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_b5_plain_matches_pallas_interpret(case):
    shape_q, tk, causal = CASES[case]
    q, k, v = _qkv(shape_q, tk, seed=len(case))
    scale = shape_q[-1] ** -0.5
    want_out, want_lse = _flash_forward(
        *map(jnp.asarray, (q, k, v)), causal=causal, scale=scale, block_q=512,
        block_k=512, interpret=True)
    out, lse = tfc.flash_forward(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal, scale=scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)


NHD_CASES = {k: c for k, c in CASES.items() if c[0][-1] == 64 and c[0][1] % 2 == 0}


@pytest.mark.parametrize("case", sorted(NHD_CASES))
def test_b6_plain_matches_pallas_interpret(case):
    shape_q, tk, causal = NHD_CASES[case]
    q, k, v = (x.transpose(0, 2, 1, 3).copy() for x in _qkv(shape_q, tk, seed=len(case)))
    scale = 0.125
    want_out, want_lse = _flash_forward_nhd(
        *map(jnp.asarray, (q, k, v)), causal=causal, scale=scale, block_q=512,
        block_k=512, interpret=True)
    out, lse = tfc.flash_forward_nhd(*map(torch.from_numpy, (q, k, v)),
                                     causal=causal, scale=scale)
    assert out.shape == q.shape and lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)


def test_causal_mask_is_top_left_aligned_like_sdpa():
    q, k, v = map(torch.from_numpy, _qkv((2, 4, 100, 8), 160, seed=11))
    out, _ = tfc.flash_forward(q, k, v, causal=True, scale=0.3)
    want = torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                            scale=0.3)
    np.testing.assert_allclose(out.numpy(), want.numpy(), **TOL)


def test_causal_tq_above_tk_masks_keys_past_tk():
    """Causal with Tq > Tk: rows i >= Tk see all Tk keys and nothing more,
    as in scaled_dot_product_attention.  The JAX kernel pads k/v with zeros
    to a block multiple and its causal mask lets those zero keys into rows
    i >= Tk (flash_attention.py:118-123; lse off by up to ~0.2 here), so
    the two agree on rows i < Tk only.  The scoring path never meets it
    (Tq == Tk there)."""
    q, k, v = _qkv((1, 2, 20, 8), 13, seed=4)
    want_out, want_lse = _flash_forward(*map(jnp.asarray, (q, k, v)), causal=True,
                                        scale=0.3, block_q=512, block_k=512,
                                        interpret=True)
    tq_, tk_, tv_ = map(torch.from_numpy, (q, k, v))
    out, lse = tfc.flash_forward(tq_, tk_, tv_, causal=True, scale=0.3)
    np.testing.assert_allclose(out.numpy()[:, :, :13], np.asarray(want_out)[:, :, :13], **TOL)
    np.testing.assert_allclose(lse.numpy()[:, :, :13], np.asarray(want_lse)[:, :, :13], **TOL)
    ref = torch.nn.functional.scaled_dot_product_attention(tq_, tk_, tv_, is_causal=True,
                                                           scale=0.3)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)


@pytest.mark.parametrize("heads,d", [(3, 64), (4, 8), (2, 32)])
def test_flash_attention_nhd_matches_jax_dispatch(heads, d, monkeypatch):
    """Odd head counts and D != 64 take B5 on transposed views, as the JAX
    dispatch does; D == 64 with even heads takes B6."""
    rng = np.random.default_rng(heads * d)
    q, k, v = (rng.standard_normal((2, 48, heads, d)).astype(np.float32) for _ in range(3))
    want = flash_attention_nhd(*map(jnp.asarray, (q, k, v)), causal=True, interpret=True)
    calls = []
    for name in ("flash_forward", "flash_forward_nhd"):
        real = getattr(tfc, name)
        monkeypatch.setattr(tfc, name, lambda *a, _f=real, _n=name, **kw:
                            (calls.append(_n), _f(*a, **kw))[1])
    got = tfc.flash_attention_nhd(*map(torch.from_numpy, (q, k, v)), causal=True)
    expected = "flash_forward_nhd" if d == 64 and heads % 2 == 0 else "flash_forward"
    assert calls == [expected]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("rel_pe,valid_len,route", [
    (False, False, "B5"), (False, True, "B1"), (True, False, "B1"), (True, True, "B1")])
def test_flash_attention_routes_like_jax(rel_pe, valid_len, route, monkeypatch):
    """Without rel_pe and kv_valid_len the public flash_attention is kernel
    B5, as in the JAX package; with either it is kernel B1."""
    q, k, v = _qkv((2, 2, 40, 64), 40, seed=5)
    pe = np.random.default_rng(1).standard_normal((8, 64)).astype(np.float32) * 0.3
    vl = np.asarray([40, 23], np.int32)
    kw = dict(causal=True, scale=0.125)
    jkw = dict(kw, rel_pe=jnp.asarray(pe) if rel_pe else None,
               kv_valid_len=jnp.asarray(vl) if valid_len else None)
    want = flash_attention(*map(jnp.asarray, (q, k, v)), interpret=True, **jkw)
    ran = []
    for mod, name, tag in ((tfc, "flash_forward", "B5"), (tfa, "flash_rel_forward", "B1")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=real, _t=tag, **k2:
                            (ran.append(_t), _f(*a, **k2))[1])
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              rel_pe=torch.from_numpy(pe) if rel_pe else None,
                              kv_valid_len=torch.from_numpy(vl) if valid_len else None,
                              **kw)
    assert ran == [route]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_wrappers_on_cpu_count_no_launch():
    q, k, v = map(torch.from_numpy, _qkv((1, 2, 20, 64), 20, seed=2))
    before = (tfc.flash_forward.launches, tfc.flash_forward_nhd.launches)
    tfc.flash_forward(q, k, v, causal=True, scale=0.1)
    tfc.flash_forward_nhd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          causal=False, scale=0.1)
    assert (tfc.flash_forward.launches, tfc.flash_forward_nhd.launches) == before


def test_nhd_plain_equals_flat_plain_on_transposed_views():
    q, k, v = map(torch.from_numpy, _qkv((2, 4, 33, 16), 33, seed=9))
    out, lse = tfc.flash_forward(q, k, v, causal=True, scale=0.25)
    tr = lambda x: x.transpose(1, 2)
    out_n, lse_n = tfc.flash_forward_nhd(tr(q), tr(k), tr(v), causal=True, scale=0.25)
    torch.testing.assert_close(tr(out_n), out, rtol=0, atol=0)
    torch.testing.assert_close(lse_n, lse, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["k_heads", "v_shape", "empty"])
def test_wrappers_reject_bad_shapes(bad):
    q, k, v = map(torch.from_numpy, _qkv((1, 2, 8, 8), 8, seed=0))
    if bad == "k_heads":
        k = k[:, :1]
    elif bad == "v_shape":
        v = v[:, :, :4]
    else:
        q = q[:, :, :0]
    with pytest.raises(ValueError):
        tfc.flash_forward(q, k, v, causal=True, scale=1.0)


def _tf32(x):
    """float32 -> the nearest TF32 value, ties away from zero, as
    ``cvt.rna.tf32.f32`` rounds (the low 13 mantissa bits cleared)."""
    i = np.ascontiguousarray(x, np.float32).view(np.int32)
    return ((i + 0x1000) & ~0x1FFF).view(np.float32)


def _tf32_trunc(x):
    """float32 -> TF32 by dropping the low 13 mantissa bits, as the mma
    reads an operand that is not a TF32 value."""
    i = np.ascontiguousarray(x, np.float32).view(np.int32)
    return (i & ~0x1FFF).view(np.float32)


def _mm_tf32(a, b, passes):
    """a @ b over the last two axes as the kernel forms it: k-steps of 8,
    each an m16n8k8 TF32 product (exact inside, one f32 rounding into the
    accumulator), x split into big = rna(x) and small = x - big, which the
    mma truncates; ``passes=3`` adds small.big and big.small before
    big.big (csrc/flash_causal.cu), ``passes=1`` is big.big alone."""
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


def _emulated_kernel(q, k, v, scale, passes):
    """Causal forward with the kernel's f32 arithmetic: scores times
    scale * log2 e, the -1e30 mask, p = exp2(s - max), out = p.v / sum p,
    lse = (max + log2 sum p) ln 2."""
    log2e = np.float32(np.log2(np.e))
    s = _mm_tf32(q, np.swapaxes(k, -1, -2), passes) * np.float32(scale * log2e)
    t = q.shape[-2]
    s = np.where(np.arange(t)[None, :] > np.arange(t)[:, None], np.float32(-1e30) * log2e, s)
    m = s.max(axis=-1, keepdims=True)
    p = np.exp2(s - m).astype(np.float32)
    l = p.sum(axis=-1, keepdims=True, dtype=np.float32)
    out = _mm_tf32(p, v, passes) / l
    lse = (m + np.log2(l))[..., 0] * np.float32(np.log(2.0))
    return out, lse


def test_three_tf32_products_keep_f32_accuracy():
    """Pins the kernel's numerics choice at [1, 4, 1024, 64] causal: three
    TF32 products per f32 product stay within 2e-6 of float64 on out and
    lse, a single TF32 product misses the kernels' 1e-4 tolerance on out."""
    q, k, v = _qkv((1, 4, 1024, 64), 1024, seed=0)
    scale = 0.125
    s = np.matmul(q.astype(np.float64), np.swapaxes(k, -1, -2).astype(np.float64)) * scale
    s = np.where(np.triu(np.ones((1024, 1024), bool), 1), -np.inf, s)
    m = s.max(axis=-1, keepdims=True)
    p = np.exp(s - m)
    want_out = np.matmul(p, v.astype(np.float64)) / p.sum(axis=-1, keepdims=True)
    want_lse = (m + np.log(p.sum(axis=-1, keepdims=True)))[..., 0]
    out3, lse3 = _emulated_kernel(q, k, v, scale, passes=3)
    assert np.abs(out3 - want_out).max() <= 2e-6
    assert np.abs(lse3 - want_lse).max() <= 2e-6
    out1, _ = _emulated_kernel(q, k, v, scale, passes=1)
    assert np.abs(out1 - want_out).max() > 1e-4


@pytest.fixture
def cuda_f32():
    """The card, with TF32 off for the plain versions' matmuls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


def _kernel_vs_plain(q, k, v, causal, t_axis=2, scale=None):
    """Max abs error of the kernel against its plain version, out and lse,
    after checking that exactly one launch was counted."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    fn, plain = ((tfc.flash_forward, tfc.flash_forward_plain) if t_axis == 2
                 else (tfc.flash_forward_nhd, tfc.flash_forward_nhd_plain))
    before = fn.launches
    out, lse = fn(q, k, v, causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    pout, plse = plain(q, k, v, causal=causal, scale=scale)
    assert out.shape == pout.shape and lse.shape == plse.shape
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    return max((out - pout).abs().max().item(), (lse - plse).abs().max().item())


def _cuda_qkv(shape_q, tk, seed, dev):
    return [torch.from_numpy(x).to(dev) for x in _qkv(shape_q, tk, seed)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", tfc.HEAD_DIMS)
def test_cuda_kernel_matches_plain(d, cuda_f32):
    """Every head dim, ragged and tile-sized lengths, causal and not, and
    Tq != Tk both ways: within 1e-4 of the plain version (f32, TF32 off)."""
    cases = [(t, t, causal) for t in (1, 27, 63, 64, 65, 160, 1000)
             for causal in (True, False)]
    cases += [(tq, tk, causal) for tq, tk in ((100, 160), (160, 100), (65, 1000), (1000, 65))
              for causal in (True, False)]
    errs = {}
    for tq, tk, causal in cases:
        q, k, v = _cuda_qkv((2, 3, tq, d), tk, seed=tq + 7 * tk, dev=cuda_f32)
        errs[(tq, tk, causal)] = _kernel_vs_plain(q, k, v, causal)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-4, f"worst case (Tq, Tk, causal) {worst}: {errs[worst]}"


@pytest.mark.cuda
@pytest.mark.parametrize("t", [27, 1024])
def test_cuda_kernel_reads_qkv_column_views(t, cuda_f32):
    """B6 and B5 on [B, T, H, D] column views of one qkv projection output
    (the GPT-2 layer's operands), read in place."""
    rng = np.random.default_rng(t)
    x = torch.from_numpy(rng.standard_normal((2, t, 3 * 4 * 64)).astype(np.float32) * 0.5)
    q, k, v = (y.reshape(2, t, 4, 64) for y in x.to(cuda_f32).split(4 * 64, dim=-1))
    assert not q.is_contiguous()
    assert _kernel_vs_plain(q, k, v, True, t_axis=1) <= 1e-4
    tr = lambda y: y.transpose(1, 2)
    assert _kernel_vs_plain(tr(q), tr(k), tr(v), True, t_axis=2) <= 1e-4


@pytest.mark.cuda
def test_cuda_kernel_rows_with_every_other_key_masked(cuda_f32):
    """A row always sees key 0, so the nearest to a fully masked row is one
    whose every other key is masked: with Tk = 1 each row weighs key 0
    alone against 63 masked keys of its tile (-1e30 above the diagonal,
    -inf past Tk); the output is v[0] and lse is row . k0 * scale."""
    q, k, v = _cuda_qkv((2, 3, 130, 32), 1, seed=3, dev=cuda_f32)
    for causal in (True, False):
        assert _kernel_vs_plain(q, k, v, causal) <= 1e-4
        out, lse = tfc.flash_forward(q, k, v, causal=causal, scale=0.5)
        torch.testing.assert_close(out, v.expand_as(out), atol=1e-6, rtol=0)
        torch.testing.assert_close(lse, (q @ k.transpose(-1, -2))[..., 0] * 0.5,
                                   atol=1e-5, rtol=0)
