"""The bf16 forms of kernels B1-B6.

On the CPU: the plain bf16 versions (loco_asr_tpu_torch.ops.cuda) against
the JAX Pallas kernels run on bf16 inputs in interpret mode -- B1 with the
rel band, mask-only and ``valid_len = 0`` rows, its gradient B3/B4, B5
causal and non-causal with its blockwise backward, B6 on qkv column views,
B2 -- with equal dtypes, outputs and gradients within one bf16 ulp
(``|d| <= 2^-8 |jax| + 1e-6``) and lse within 1e-5; the launch paths with
a recording library in place of the built one (a bf16 operand reaches the
bf16 form, allocates bf16 outputs and never a plain version).  On a CUDA
device (marker ``cuda``): each bf16 kernel against its plain version,
``max|d| <= 2^-7 max|plain|`` and lse within 1e-3.

On a GPU machine without JAX, run the kernel tests alone:
``python -m pytest --noconftest tests/test_torch_bf16_kernels.py -m cuda``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax.numpy as jnp

    from loco_asr_tpu.ops.pallas.conv_frontend import conv1_instance_norm_gelu as jax_b2
    from loco_asr_tpu.ops.pallas.flash_attention import (_flash_backward, _flash_forward,
                                                         _flash_forward_nhd,
                                                         _flash_rel_backward_pallas,
                                                         _flash_rel_forward)
except ImportError:   # only the tests marked ``cuda`` run without JAX
    jnp = None

from loco_asr_tpu_torch.ops.cuda import _build
from loco_asr_tpu_torch.ops.cuda import conv_frontend as tcf
from loco_asr_tpu_torch.ops.cuda import flash_attention as tfa
from loco_asr_tpu_torch.ops.cuda import flash_causal as tfc

BF16 = torch.bfloat16
ULP = 2.0 ** -8        # one bf16 ulp relative to the JAX value
LSE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(rng, shape, scale=0.5):
    """A bf16 tensor drawn from numpy, and the same values as a JAX bf16
    array (exact: both hold the rounded f32 values)."""
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to(BF16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(x.astype(jnp.float32))


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at ``x``: 2^(e - 7) for |x| in [2^e,
    2^(e+1)).  2^-8 |x| is that spacing at the top of a binade and half of
    it at the bottom, where a rounding flip of the last cast is one ulp."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def p_flip_scale(q, k, v, causal: bool, scale: float, t_axis: int = 2) -> np.ndarray:
    """2^-8 max_j p_ij |v_jd|: how far one bf16 rounding flip of p moves
    out[i, d].  XLA's and torch's float32 exp differ in the last bits, which
    now and then flips the bf16 rounding of one p on one side (ROADMAP.md
    §C); where an output is a small difference of larger terms that is
    more than its own ulp."""
    if t_axis == 1:
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        tq, tk = s.shape[-2:]
        s = s.masked_fill(torch.ones(tq, tk, dtype=torch.bool).triu(1), -1e30)
    p = torch.softmax(s, dim=-1)
    flip = ULP * (p[..., None] * v.float().abs()[..., None, :, :]).amax(dim=-2)
    return (flip.transpose(1, 2) if t_axis == 1 else flip).numpy()


def assert_bf16_close(got, want, what: str, flip=0.0) -> None:
    """Equal dtypes and every element within one bf16 ulp of the JAX value
    (plus ``flip``, the reach of one p rounding flip, for attention
    outputs)."""
    assert got.dtype is BF16 and want.dtype == jnp.bfloat16, (what, got.dtype, want.dtype)
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err = np.abs(g - w)
    lim = np.maximum(ULP * np.abs(w), bf16_ulp(w)) + flip + 1e-6
    bad = err > lim
    assert not bad.any(), (f"{what}: {bad.sum()} of {bad.size} elements beyond one ulp, "
                           f"worst {err.max():.3g}")


def assert_lse_close(got, want, what: str) -> None:
    assert got.dtype is torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LSE_TOL, rtol=0,
                               err_msg=what)


# (q shape [B, H, Tq, D], Tk, L or None for mask-only, valid lengths, causal)
B1_CASES = {
    "band": ((2, 2, 40, 64), 40, 8, [40, 23], False),
    "band_causal": ((1, 3, 70, 64), 70, 12, [70], True),
    "mask_only": ((2, 2, 33, 64), 48, None, [48, 17], False),
    "valid_len_0": ((2, 2, 40, 64), 40, 8, [0, 31], False),
    "band_d8": ((2, 4, 45, 8), 45, 6, [45, 20], False),
}


def _b1_inputs(case, seed):
    (b, h, tq, d), tk, L, vl, causal = B1_CASES[case]
    rng = np.random.default_rng(seed)
    q, jq = _bf16(rng, (b, h, tq, d), 0.6)
    k, jk = _bf16(rng, (b, h, tk, d), 0.6)
    v, jv = _bf16(rng, (b, h, tk, d))
    pe, jpe = _bf16(rng, (2 * L if L else 2, d), 0.6)
    if L is None:
        pe, jpe = torch.zeros_like(pe), jnp.zeros_like(jpe)
    vl = np.asarray(vl, np.int32)
    return (q, k, v, pe, torch.from_numpy(vl)), (jq, jk, jv, jpe, jnp.asarray(vl)), causal, L


@pytest.mark.parametrize("case", sorted(B1_CASES))
def test_b1_plain_bf16_matches_jax(case):
    t, j, causal, _ = _b1_inputs(case, seed=1)
    scale = t[0].shape[-1] ** -0.5
    jout, jlse = _flash_rel_forward(*j, causal=causal, scale=scale, block_q=128,
                                    block_k=1024, interpret=True)
    out, lse = tfa.flash_rel_forward_plain(*t, causal=causal, scale=scale)
    assert_bf16_close(out, jout, f"B1 {case} out")
    assert_lse_close(lse, jlse, f"B1 {case} lse")


@pytest.mark.parametrize("case", ["band", "band_causal", "mask_only", "valid_len_0"])
def test_b34_plain_bf16_matches_jax(case):
    t, j, causal, L = _b1_inputs(case, seed=2)
    scale = 0.125
    rng = np.random.default_rng(3)
    g, jg = _bf16(rng, t[0].shape, 1.0)
    jout, jlse = _flash_rel_forward(*j, causal=causal, scale=scale, block_q=128,
                                    block_k=1024, interpret=True)
    want = _flash_rel_backward_pallas(*j, jout, jlse, jg, causal=causal, scale=scale,
                                      block_q=128, interpret=True)
    got = tfa.flash_rel_backward(*t, torch.from_numpy(_np(jout)).to(BF16),
                                 torch.from_numpy(np.array(jlse)), g, causal=causal,
                                 scale=scale, mask_only=L is None)
    rows = slice(None)
    if case == "valid_len_0":
        # a row with no valid key: JAX's p = 1 for every key is a reference
        # fault the port does not copy (ROADMAP.md §C); its gradients are 0,
        # and the other rows are held to JAX's (dpe sums over every row)
        rows = slice(1, None)
        for a in got[:3]:
            assert not a[0].any()
        got, want = got[:3], want[:3]
    for name, a, w in zip(("dq", "dk", "dv", "dpe"), got, want):
        if a is None:          # mask-only: no table, no table gradient
            assert L is None and name == "dpe"
            continue
        if name != "dpe":
            a, w = a[rows], w[rows]
        assert_bf16_close(a, w, f"B3/B4 {case} {name}")


# (q shape [B, H, Tq, D], Tk, causal); non-causal Tk needs an 8-aligned
# block divisor for the JAX kernel
B5_CASES = {
    "causal_d64": ((2, 2, 96, 64), 96, True),
    "noncausal_d64": ((1, 3, 64, 64), 80, False),
    "causal_ragged_d32": ((2, 2, 77, 32), 77, True),
    "causal_d8": ((2, 4, 40, 8), 40, True),
}


def _b5_inputs(case, seed):
    (b, h, tq, d), tk, causal = B5_CASES[case]
    rng = np.random.default_rng(seed)
    q, jq = _bf16(rng, (b, h, tq, d), 0.6)
    k, jk = _bf16(rng, (b, h, tk, d), 0.6)
    v, jv = _bf16(rng, (b, h, tk, d))
    return (q, k, v), (jq, jk, jv), causal


@pytest.mark.parametrize("case", sorted(B5_CASES))
def test_b5_plain_bf16_matches_jax(case):
    t, j, causal = _b5_inputs(case, seed=4)
    scale = t[0].shape[-1] ** -0.5
    jout, jlse = _flash_forward(*j, causal=causal, scale=scale, block_q=512, block_k=512,
                                interpret=True)
    out, lse = tfc.flash_forward_plain(*t, causal=causal, scale=scale)
    assert_bf16_close(out, jout, f"B5 {case} out", p_flip_scale(*t, causal, scale))
    assert_lse_close(lse, jlse, f"B5 {case} lse")


@pytest.mark.parametrize("case", ["causal_d64", "noncausal_d64"])
def test_b5_blockwise_backward_bf16_matches_jax(case):
    t, j, causal = _b5_inputs(case, seed=5)
    scale = 0.125
    rng = np.random.default_rng(6)
    g, jg = _bf16(rng, t[0].shape, 1.0)
    jout, jlse = _flash_forward(*j, causal=causal, scale=scale, block_q=512, block_k=512,
                                interpret=True)
    want = _flash_backward(*j, jout, jlse, jg, causal=causal, scale=scale, block_k=32)
    got = tfc.flash_backward_blockwise(*t, torch.from_numpy(_np(jout)).to(BF16),
                                       torch.from_numpy(np.array(jlse)), g,
                                       causal=causal, scale=scale, block_k=32)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert_bf16_close(a, w, f"B5 backward {case} {name}")


def test_b6_plain_bf16_on_qkv_views_matches_jax():
    """B6 reads q, k, v as column views of one [B, T, 3*H*D] projection."""
    b, t, h, d = 2, 72, 4, 64
    rng = np.random.default_rng(7)
    qkv, jqkv = _bf16(rng, (b, t, 3 * h * d), 0.6)
    views = [qkv[..., i * h * d:(i + 1) * h * d].view(b, t, h, d) for i in range(3)]
    jviews = [jqkv[..., i * h * d:(i + 1) * h * d].reshape(b, t, h, d) for i in range(3)]
    assert not views[0].is_contiguous()
    jout, jlse = _flash_forward_nhd(*jviews, causal=True, scale=0.125, block_q=512,
                                    block_k=512, interpret=True)
    out, lse = tfc.flash_forward_nhd_plain(*views, causal=True, scale=0.125)
    assert_bf16_close(out, jout, "B6 out", p_flip_scale(*views, True, 0.125, t_axis=1))
    assert_lse_close(lse, jlse, "B6 lse")


@pytest.mark.parametrize("t_len", [8000, 5003])
def test_b2_plain_bf16_matches_jax(t_len):
    rng = np.random.default_rng(t_len)
    c = 64
    wav, jwav = _bf16(rng, (3, t_len), 0.3)
    w, jw = _bf16(rng, (c, 1, 10), 0.3)
    scale = torch.from_numpy(rng.standard_normal(c).astype(np.float32) * 0.2 + 1.0).to(BF16)
    bias = torch.from_numpy(rng.standard_normal(c).astype(np.float32) * 0.1).to(BF16)
    jscale, jbias = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (scale, bias))
    want = jax_b2(jwav, jw, jscale, jbias, chunk_frames=256, interpret=True)
    got = tcf.conv1_instance_norm_gelu_plain(wav, w, scale, bias)
    assert_bf16_close(got, want, f"B2 T={t_len}")


# ---- the launch paths, with a recording library in place of the built one


class _Recorder:
    """Stands in for the built library: each entry point records its
    arguments and reports success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.endswith(("smem_bytes", "blocks_per_sm")):
            return lambda *a: 1024
        return lambda *a: (self.calls.append((name, a)), 0)[1]


@pytest.fixture
def recorder(monkeypatch):
    """CPU tensors pass the launch paths' CUDA guard, the library is the
    recorder, and every plain version raises: what runs is the launch path
    alone."""
    rec = _Recorder()
    monkeypatch.setattr(_build, "library", lambda: rec)
    monkeypatch.setattr(_build, "require_cuda", lambda t, what: None)
    monkeypatch.setattr(_build, "call_on_stream", lambda fn, dev, *a: fn(*a, None))
    monkeypatch.setattr(tcf, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for mod, names in ((tfc, ("flash_forward_plain", "flash_forward_nhd_plain")),
                       (tfa, ("flash_rel_forward_plain", "flash_rel_backward_plain")),
                       (tcf, ("conv1_instance_norm_gelu_plain",))):
        for name in names:
            monkeypatch.setattr(mod, name, lambda *a, **k: pytest.fail("plain version ran"))
    return rec


@pytest.mark.parametrize("dtype,flag", [(torch.float32, 0), (BF16, 1)])
def test_launch_paths_pass_the_operand_type_and_allocate_it(recorder, dtype, flag):
    q, k, v = (torch.zeros(2, 3, 40, 64, dtype=dtype) for _ in range(3))
    out, lse = tfc._launch(q, k, v, (2, 3, 40, 40, 64), t_axis=2, causal=True, scale=0.125,
                           what="flash_forward")
    assert out.dtype is dtype and lse.dtype is torch.float32
    pe = torch.zeros(16, 64, dtype=dtype)
    vl = torch.tensor([40, 20], dtype=torch.int32)
    out, lse = tfa._launch_forward(q, k, v, pe, vl, False, 0.125, mask_only=False)
    assert out.dtype is dtype and lse.dtype is torch.float32
    dq, dk, dv, dqpe = tfa._launch_backward(q, k, v, pe, vl, lse, lse, q, False, 0.125,
                                            mask_only=False)
    assert all(x.dtype is torch.float32 for x in (dq, dk, dv, dqpe))
    wav = torch.zeros(2, 4000, dtype=dtype)
    w = torch.zeros(8, 1, 10, dtype=dtype)
    y = tcf._launch(wav, w, torch.ones(8, dtype=dtype), torch.zeros(8, dtype=dtype), 10, 5)
    assert y.dtype is dtype
    names = [n for n, _ in recorder.calls]
    assert names == ["loco_flash_causal_fwd", "loco_flash_rel_fwd", "loco_flash_rel_bwd",
                     "loco_conv_frontend"]
    # the operand type is the argument before the stream
    assert [a[-2] for _, a in recorder.calls] == [flag] * 4


def test_launch_paths_refuse_other_types_and_mixed_operands(recorder):
    q = torch.zeros(1, 2, 16, 64, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfc._launch(q, q, q, (1, 2, 16, 16, 64), t_axis=2, causal=True, scale=1.0,
                    what="flash_forward")
    qb = torch.zeros(1, 2, 16, 64, dtype=BF16)
    with pytest.raises(ValueError, match="k must be torch.bfloat16"):
        tfc._launch(qb, qb.float(), qb, (1, 2, 16, 16, 64), t_axis=2, causal=True,
                    scale=1.0, what="flash_forward")
    with pytest.raises(ValueError, match="float32 rel-pos table"):
        tfa._launch_forward(qb, qb, qb, torch.zeros(4, 64), torch.tensor([16]), False,
                            1.0, mask_only=False)
    with pytest.raises(ValueError, match="must be torch.bfloat16"):
        tcf._launch(torch.zeros(1, 4000, dtype=BF16), torch.zeros(8, 1, 10), torch.ones(8),
                    torch.zeros(8), 10, 5)
    assert recorder.calls == []


# ---- on the card: each bf16 kernel against its plain version


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def assert_kernel_close(got, want, what):
    assert got.dtype == want.dtype, what
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    assert err <= 2.0 ** -7 * w.abs().max().item(), f"{what}: max |d| {err}"


def _card_inputs(shape_q, tk, two_l, seed, dev):
    gen = torch.Generator().manual_seed(seed)
    b, h, tq, d = shape_q
    q = torch.randn(b, h, tq, d, generator=gen) * 0.6
    k, v = (torch.randn(b, h, tk, d, generator=gen) * 0.6 for _ in range(2))
    pe = torch.randn(two_l, d, generator=gen) * 0.6
    g = torch.randn(b, h, tq, d, generator=gen)
    return [x.to(dev, BF16) for x in (q, k, v, pe, g)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("case", ["band", "mask_only", "valid_len_0", "causal"])
def test_b1_bf16_kernel_matches_plain(cuda, case, d):
    q, k, v, pe, _ = _card_inputs((2, 3, 150, d), 130, 40, seed=d, dev=cuda)
    vl = torch.tensor([0 if case == "valid_len_0" else 130, 77], dtype=torch.int32,
                      device=cuda)
    table = None if case == "mask_only" else pe
    causal = case == "causal"
    before = tfa.flash_rel_forward.launches
    with torch.no_grad():
        out, lse = tfa.flash_rel_forward(q, k, v, table, vl, causal=causal, scale=0.125)
    assert tfa.flash_rel_forward.launches == before + 1
    zero = torch.zeros(2, d, dtype=BF16, device=cuda)
    want, want_lse = tfa.flash_rel_forward_plain(q, k, v, zero if table is None else pe, vl,
                                                 causal=causal, scale=0.125)
    assert_kernel_close(out, want, f"B1 {case} D={d}")
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["band", "mask_only", "valid_len_0", "causal"])
def test_b34_bf16_kernels_match_plain(cuda, case):
    q, k, v, pe, g = _card_inputs((2, 3, 140, 64), 90, 40, seed=11, dev=cuda)
    vl = torch.tensor([0 if case == "valid_len_0" else 90, 61], dtype=torch.int32,
                      device=cuda)
    mask_only = case == "mask_only"
    table = torch.zeros(2, 64, dtype=BF16, device=cuda) if mask_only else pe
    causal = case == "causal"
    with torch.no_grad():
        out, lse = tfa.flash_rel_forward_plain(q, k, v, table, vl, causal=causal, scale=0.125)
    before = tfa.flash_rel_backward.launches
    got = tfa.flash_rel_backward(q, k, v, table, vl, out, lse, g, causal=causal, scale=0.125,
                                 mask_only=mask_only)
    assert tfa.flash_rel_backward.launches == before + 1
    dq, dk, dv, dqpe = tfa.flash_rel_backward_plain(q, k, v, table, vl, out, lse, g,
                                                    causal=causal, scale=0.125)
    if not mask_only:
        dq = dq + torch.matmul(dqpe, table.float()) * 0.125
    for name, a, w in zip(("dq", "dk", "dv"), got, (dq, dk, dv)):
        assert_kernel_close(a, w.to(BF16), f"B3/B4 {case} {name}")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_b5_bf16_kernel_matches_plain(cuda, causal, d):
    q, k, v, _, _ = _card_inputs((2, 3, 150, d), 150 if causal else 97, 2, seed=d, dev=cuda)
    before = tfc.flash_forward.launches
    with torch.no_grad():
        out, lse = tfc.flash_forward(q, k, v, causal=causal, scale=d ** -0.5)
    assert tfc.flash_forward.launches == before + 1
    want, want_lse = tfc.flash_forward_plain(q, k, v, causal=causal, scale=d ** -0.5)
    assert_kernel_close(out, want, f"B5 causal={causal} D={d}")
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_b6_bf16_kernel_on_qkv_views_matches_plain(cuda):
    b, t, h, d = 2, 300, 12, 64
    qkv = (torch.randn(b, t, 3 * h * d, generator=torch.Generator().manual_seed(5)) * 0.6
           ).to(cuda, BF16)
    views = [qkv[..., i * h * d:(i + 1) * h * d].view(b, t, h, d) for i in range(3)]
    before = tfc.flash_forward_nhd.launches
    with torch.no_grad():
        out, lse = tfc.flash_forward_nhd(*views, causal=True, scale=0.125)
    assert tfc.flash_forward_nhd.launches == before + 1
    want, want_lse = tfc.flash_forward_nhd_plain(*views, causal=True, scale=0.125)
    assert_kernel_close(out, want, "B6")
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t_len", [(4, 16000), (3, 8003)])
def test_b2_bf16_kernel_matches_plain(cuda, b, t_len):
    gen = torch.Generator().manual_seed(t_len)
    c = 512
    wav = (torch.randn(b, t_len, generator=gen) * 0.3).to(cuda, BF16)
    w = (torch.randn(c, 1, 10, generator=gen) * 0.3).to(cuda, BF16)
    scale = (torch.randn(c, generator=gen) * 0.2 + 1.0).to(cuda, BF16)
    bias = (torch.randn(c, generator=gen) * 0.1).to(cuda, BF16)
    before = tcf.conv1_instance_norm_gelu.launches
    with torch.no_grad():
        got = tcf.conv1_instance_norm_gelu(wav, w, scale, bias)
    assert tcf.conv1_instance_norm_gelu.launches == before + 1
    assert_kernel_close(got, tcf.conv1_instance_norm_gelu_plain(wav, w, scale, bias), "B2")
