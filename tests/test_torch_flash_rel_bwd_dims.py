"""Kernels B3 + B4 (``csrc/flash_rel_bwd.cu``) at every head dim, and the
flash wrappers at head dims without an instantiation.

On the CPU: the plain B3 + B4 (``flash_rel_backward``'s CPU route) at
D = 8, 12 and 32 against the JAX package's Pallas backward in interpret
mode (atol 3e-5 / rtol 1e-4, as ``tests/test_torch_flash_rel_backward.py``),
with the LoCo model's band (L = 20) and Tq != Tk; ``kernel_head_dim``'s
rounding; and the launch paths of B1, B3 + B4 and B5 at D = 12 with a
library that runs the plain versions on the raw operands it is handed
(pointers, strides, the head dim it is told) in place of the built one:
the padded launches give the unpadded plain versions' numbers.  On a CUDA
device (marker ``cuda``): B3 + B4 at D = 8, 16, 32, 64, 128 and 12, f32
and bf16, with the band and mask-only, against their plain versions (f32
within 1e-4, dpe relative to its max; bf16 within 2^-7 max|plain|), and
B1 and B5 at D = 12.

JAX is imported only by the tests that compare with it, so on a GPU
machine without JAX run:
``python -m pytest --noconftest tests/test_torch_flash_rel_bwd_dims.py -m cuda``."""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from loco_asr_tpu_torch.ops.cuda import _build
from loco_asr_tpu_torch.ops.cuda import flash_attention as tfa
from loco_asr_tpu_torch.ops.cuda import flash_causal as tfc

TOL = dict(atol=3e-5, rtol=1e-4)
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, h, tq, tk, two_l, d, seed, scale=0.3):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(b, h, tq, d, generator=gen) * scale
    k, v = (torch.randn(b, h, tk, d, generator=gen) * scale for _ in range(2))
    pe = torch.randn(two_l, d, generator=gen) * scale
    g = torch.randn(b, h, tq, d, generator=gen)
    return q, k, v, pe, g


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [8, 12, 32])
def test_plain_backward_matches_jax_pallas(d, causal):
    jnp = pytest.importorskip("jax.numpy")
    from loco_asr_tpu.ops.pallas.flash_attention import (_flash_rel_backward_pallas,
                                                         _flash_rel_forward)

    tq, tk = (150, 150) if causal else (150, 230)
    q, k, v, pe, g = _inputs(2, 2, tq, tk, 40, d, seed=d)
    vl = torch.tensor([tk, tk - 37], dtype=torch.int32)
    scale = d ** -0.5
    jq, jk, jv, jpe, jvl, jg = (jnp.asarray(x.numpy()) for x in (q, k, v, pe, vl, g))
    out, lse = _flash_rel_forward(jq, jk, jv, jpe, jvl, causal=causal, scale=scale,
                                  block_q=128, block_k=1024, interpret=True)
    want = _flash_rel_backward_pallas(jq, jk, jv, jpe, jvl, out, lse, jg, causal=causal,
                                      scale=scale, block_q=64, interpret=True)
    got = tfa.flash_rel_backward(q, k, v, pe, vl, torch.from_numpy(np.array(out)),
                                 torch.from_numpy(np.array(lse)), g, causal=causal,
                                 scale=scale)
    for name, a, w in zip("q k v pe".split(), got, want[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL, err_msg=f"d{name}")


def test_kernel_head_dim_rounds_up_to_an_instantiation():
    assert [tfc.kernel_head_dim(d, "x") for d in (1, 8, 12, 16, 24, 48, 64, 80, 96, 128)] == \
        [8, 8, 16, 16, 32, 64, 64, 128, 128, 128]
    with pytest.raises(ValueError, match="up to 128"):
        tfc.kernel_head_dim(129, "x")


# ---- the launch paths at D = 12, with the plain versions as the "kernels"


def _view(ptr, dtype, shape, strides):
    """A numpy view of the operand at address ``ptr`` (element strides;
    the (batch, head, time) strides of a [B, H, T, D] operand, whose head
    dim is contiguous)."""
    ct = {torch.float32: ctypes.c_float, torch.int32: ctypes.c_int32}[dtype]
    strides = list(strides) + [1] * (len(shape) - len(strides))
    extent = 1 + sum((n - 1) * s for n, s in zip(shape, strides))
    base = np.ctypeslib.as_array((ct * extent).from_address(ptr))
    item = base.itemsize
    return np.lib.stride_tricks.as_strided(base, shape, [s * item for s in strides])


def _strides(ptr, n):
    return list(np.ctypeslib.as_array((ctypes.c_longlong * n).from_address(ptr)))


class _PlainLibrary:
    """The built library's B1, B3 + B4 and B5 entry points, run as their
    plain versions on the operands at the addresses they are given, in
    float32; records the head dim of each call."""

    def __init__(self, plain_fwd, plain_bwd, plain_b5):
        self.plain_fwd, self.plain_bwd, self.plain_b5 = plain_fwd, plain_bwd, plain_b5
        self.head_dims = []

    def loco_flash_rel_smem_bytes(self, *a):
        return 1024

    loco_flash_rel_bwd_smem_bytes = loco_flash_rel_smem_bytes

    def loco_flash_rel_fwd(self, q, k, v, pe, vl, out, lse, strides, B, H, Tq, Tk, D,
                           two_l, causal, mask_only, scale, form, bf16, stream):
        self.head_dims.append(D)
        st = _strides(strides, 12)
        qv, kv, vv = (torch.from_numpy(_view(p, torch.float32, (B, H, T, D), st[3 * i:3 * i + 3])
                                       .copy())
                      for i, (p, T) in enumerate(((q, Tq), (k, Tk), (v, Tk))))
        pev = torch.from_numpy(_view(pe, torch.float32, (two_l, D), (D, 1)).copy())
        vlv = torch.from_numpy(_view(vl, torch.int32, (B,), (1,)).copy())
        o, l = self.plain_fwd(qv, kv, vv, pev, vlv, causal=bool(causal), scale=scale)
        _view(out, torch.float32, (B, H, Tq, D), st[9:12])[...] = o.numpy()
        _view(lse, torch.float32, (B, H, Tq), (H * Tq, Tq, 1))[...] = l.numpy()
        return 0

    def loco_flash_rel_bwd(self, q, k, v, pe, vl, lse, delta, g, dq, dqpe, dk, dv, strides,
                           B, H, Tq, Tk, D, two_l, causal, mask_only, scale, form, bf16,
                           stream):
        self.head_dims.append(D)
        st = _strides(strides, 21)
        ins = [torch.from_numpy(_view(p, torch.float32, (B, H, T, D), st[3 * i:3 * i + 3])
                                .copy())
               for i, (p, T) in enumerate(((q, Tq), (k, Tk), (v, Tk), (g, Tq)))]
        pev = torch.from_numpy(_view(pe, torch.float32, (two_l, D), (D, 1)).copy())
        vlv = torch.from_numpy(_view(vl, torch.int32, (B,), (1,)).copy())
        lsev = torch.from_numpy(_view(lse, torch.float32, (B, H, Tq), (H * Tq, Tq, 1)).copy())
        # out only enters through delta, which the caller computed: any out
        # with rowsum(g * out) = delta serves; the plain version takes out
        # to form delta, so hand it g-scaled to match
        deltav = torch.from_numpy(_view(delta, torch.float32, (B, H, Tq),
                                        (H * Tq, Tq, 1)).copy())
        gq = ins[3]
        norm = (gq * gq).sum(-1)
        out = gq * torch.where(norm > 0, deltav / norm, torch.zeros_like(norm))[..., None]
        dqc, dkc, dvc, dqpec = self.plain_bwd(ins[0], ins[1], ins[2], pev, vlv, out, lsev, gq,
                                             causal=bool(causal), scale=scale)
        for i, (p, T, x) in enumerate(((dq, Tq, dqc), (dk, Tk, dkc), (dv, Tk, dvc))):
            _view(p, torch.float32, (B, H, T, D), st[12 + 3 * i:15 + 3 * i])[...] = x.numpy()
        if not mask_only:
            _view(dqpe, torch.float32, (B, H, Tq, two_l),
                  (H * Tq * two_l, Tq * two_l, two_l, 1))[...] = dqpec.numpy()
        return 0

    def loco_flash_causal_fwd(self, q, k, v, out, lse, strides, B, H, Tq, Tk, D, causal,
                              scale, form, bf16, stream):
        self.head_dims.append(D)
        st = _strides(strides, 12)
        qv, kv, vv = (torch.from_numpy(_view(p, torch.float32, (B, H, T, D), st[3 * i:3 * i + 3])
                                       .copy())
                      for i, (p, T) in enumerate(((q, Tq), (k, Tk), (v, Tk))))
        o, l = self.plain_b5(qv, kv, vv, causal=bool(causal), scale=scale)
        _view(out, torch.float32, (B, H, Tq, D), st[9:12])[...] = o.numpy()
        _view(lse, torch.float32, (B, H, Tq), (H * Tq, Tq, 1))[...] = l.numpy()
        return 0


@pytest.fixture
def plain_library(monkeypatch):
    lib = _PlainLibrary(tfa.flash_rel_forward_plain, tfa.flash_rel_backward_plain,
                        tfc.flash_forward_plain)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "require_cuda", lambda t, what: None)
    monkeypatch.setattr(_build, "call_on_stream", lambda fn, dev, *a: fn(*a, None))
    tfa._smem_bytes.cache_clear()
    yield lib
    tfa._smem_bytes.cache_clear()


@pytest.mark.parametrize("mask_only", [False, True])
def test_padded_launch_paths_give_the_unpadded_plain_numbers(plain_library, mask_only):
    d, scale = 12, 12 ** -0.5
    q, k, v, pe, g = _inputs(2, 3, 70, 90, 40, d, seed=5)
    if mask_only:
        pe = torch.zeros(2, d)
    vl = torch.tensor([90, 41], dtype=torch.int32)
    out, lse = tfa._launch_forward(q, k, v, pe, vl, False, scale, mask_only=mask_only)
    want, want_lse = tfa.flash_rel_forward_plain(q, k, v, pe, vl, causal=False, scale=scale)
    assert out.shape == q.shape
    torch.testing.assert_close(out, want, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(lse, want_lse, atol=1e-6, rtol=1e-5)
    delta = (g * out).sum(-1)
    got = tfa._launch_backward(q, k, v, pe, vl, lse, delta, g, False, scale,
                               mask_only=mask_only)
    ref = tfa.flash_rel_backward_plain(q, k, v, pe, vl, want, want_lse, g, causal=False,
                                       scale=scale)
    for name, a, w in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape == w.shape, name
        torch.testing.assert_close(a, w, atol=1e-5, rtol=1e-4, msg=name)
    if not mask_only:
        torch.testing.assert_close(got[3], ref[3], atol=1e-5, rtol=1e-4)
    b5, b5_lse = tfc._launch(q, k, k, (2, 3, 70, 90, d), t_axis=2, causal=True, scale=scale,
                             what="flash_forward")
    want5, want5_lse = tfc.flash_forward_plain(q, k, k, causal=True, scale=scale)
    torch.testing.assert_close(b5, want5, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(b5_lse, want5_lse, atol=1e-6, rtol=1e-5)
    assert plain_library.head_dims == [16, 16, 16]


# ---- on the card: each form against its plain version


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


def _card_grads(d, dtype, mask_only, causal, dev):
    b, h, tq, tk, two_l = 2, 3, 150, 110, 40
    q, k, v, pe, g = (x.to(dev, dtype) for x in _inputs(b, h, tq, tk, two_l, d, seed=d,
                                                         scale=0.6))
    vl = torch.tensor([tk, 61], dtype=torch.int32, device=dev)
    table = torch.zeros(2, d, dtype=dtype, device=dev) if mask_only else pe
    scale = d ** -0.5
    with torch.no_grad():
        out, lse = tfa.flash_rel_forward_plain(q, k, v, table, vl, causal=causal, scale=scale)
    before = tfa.flash_rel_backward.launches
    got = tfa.flash_rel_backward(q, k, v, table, vl, out, lse, g, causal=causal, scale=scale,
                                 mask_only=mask_only)
    torch.cuda.synchronize()
    assert tfa.flash_rel_backward.launches == before + 1
    dq, dk, dv, dqpe = tfa.flash_rel_backward_plain(q, k, v, table, vl, out, lse, g,
                                                    causal=causal, scale=scale)
    want = [dq, dk, dv, None]
    if not mask_only:
        want[0] = dq + torch.matmul(dqpe, table.float()) * scale
        want[3] = torch.einsum("bhim,bhid->md", dqpe, q.float()) * scale
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask_only", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128, 12])
def test_cuda_b34_match_plain_at_every_head_dim(cuda, d, dtype, mask_only, causal):
    got, want = _card_grads(d, dtype, mask_only, causal, cuda)
    for name, a, w in zip(("dq", "dk", "dv", "dpe"), got, want):
        if w is None:
            assert a is None
            continue
        assert a.shape == w.shape and a.dtype == dtype, name
        a, w = a.float(), w.float()
        assert torch.isfinite(a).all(), name
        err = (a - w).abs().max().item()
        if dtype is torch.float32:
            lim = 1e-4 * (w.abs().max().item() if name == "dpe" else 1.0)
        else:
            lim = 2.0 ** -7 * w.abs().max().item()
        assert err <= lim, f"D={d} {dtype} mask_only={mask_only} {name}: {err} > {lim}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_cuda_b1_b5_at_head_dim_12(cuda, dtype):
    d = 12
    q, k, v, pe, _ = (x.to(cuda, dtype) for x in _inputs(2, 3, 150, 110, 40, d, seed=3,
                                                         scale=0.6))
    vl = torch.tensor([110, 61], dtype=torch.int32, device=cuda)
    with torch.no_grad():
        n1, n5 = tfa.flash_rel_forward.launches, tfc.flash_forward.launches
        out, lse = tfa.flash_rel_forward(q, k, v, pe, vl, causal=False, scale=d ** -0.5)
        out5, lse5 = tfc.flash_forward(q, k, v, causal=False, scale=d ** -0.5)
        torch.cuda.synchronize()
        assert (tfa.flash_rel_forward.launches, tfc.flash_forward.launches) == (n1 + 1, n5 + 1)
    want, want_lse = tfa.flash_rel_forward_plain(q, k, v, pe, vl, causal=False, scale=d ** -0.5)
    want5, want5_lse = tfc.flash_forward_plain(q, k, v, causal=False, scale=d ** -0.5)
    lim = 1e-4 if dtype is torch.float32 else None
    for what, a, w, l, wl in (("B1", out, want, lse, want_lse), ("B5", out5, want5, lse5,
                                                                  want5_lse)):
        assert a.shape == w.shape, what
        err = (a.float() - w.float()).abs().max().item()
        assert err <= (lim or 2.0 ** -7 * w.float().abs().max().item()), f"{what}: {err}"
        torch.testing.assert_close(l, wl, atol=1e-3, rtol=0)
