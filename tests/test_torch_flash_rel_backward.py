"""The gradient of kernel B1: the plain version of kernels B3 + B4
(loco_asr_tpu_torch.ops.cuda.flash_attention.flash_rel_backward) against
the JAX package's Pallas backward in interpret mode and its XLA oracle, at
reduced forms of the JAX test's cases, atol 3e-5 / rtol 1e-4 as there;
and autograd through every flash route of the port (rel, mask-only, B5,
B6) against autograd through dense attention.  Also: outputs of the
kernel wrappers carry a ``grad_fn`` when an input requires grad."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from loco_asr_tpu.ops.pallas.flash_attention import (
    _flash_rel_backward_pallas, _flash_rel_backward_xla, _flash_rel_forward)
from loco_asr_tpu_torch.ops import attention as tattn
from loco_asr_tpu_torch.ops.cuda import flash_attention as tfa
from loco_asr_tpu_torch.ops.cuda import flash_causal as tfc

TOL = dict(atol=3e-5, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(tq, tk, L, seed, b=2, h=2, d=64):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, tq, d).astype(np.float32) * 0.3
    k, v = (rng.randn(b, h, tk, d).astype(np.float32) * 0.3 for _ in range(2))
    pe = rng.randn(2 * L, d).astype(np.float32) * 0.3
    vl = np.array([tk, max(1, tk - 37)], np.int32)[:b]
    g = rng.randn(b, h, tq, d).astype(np.float32)
    return q, k, v, pe, vl, g


# (tq, tk, L, causal, block_q): several key blocks with the band wider than
# one (clip columns carry weight), Tq != Tk with ragged tails, causal block
# skipping, one partial block -- the JAX test's cases at reduced sizes
CASES = {
    "clip_columns": (300, 300, 64, False, 128),
    "tq_ne_tk": (150, 230, 32, False, 64),
    "causal": (200, 200, 20, True, 64),
    "single_block": (40, 40, 4, False, 128),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_jax_pallas_and_xla(case):
    tq, tk, L, causal, bq = CASES[case]
    q, k, v, pe, vl, g = _inputs(tq, tk, L, seed=7)
    scale = 64 ** -0.5
    jq, jk, jv, jpe, jvl, jg = map(jnp.asarray, (q, k, v, pe, vl, g))
    out, lse = _flash_rel_forward(jq, jk, jv, jpe, jvl, causal=causal, scale=scale,
                                  block_q=128, block_k=1024, interpret=True)
    want_pallas = _flash_rel_backward_pallas(jq, jk, jv, jpe, jvl, out, lse, jg,
                                             causal=causal, scale=scale,
                                             block_q=bq, interpret=True)
    want_xla = _flash_rel_backward_xla(jq, jk, jv, jpe, jvl, out, lse, jg,
                                       causal=causal, scale=scale, block_k=64)
    got = tfa.flash_rel_backward(
        *map(torch.from_numpy, (q, k, v, pe, vl, np.array(out), np.array(lse), g)),
        causal=causal, scale=scale)
    for name, a, wp, wx in zip("q k v pe".split(), got, want_pallas[:4], want_xla[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(wp), **TOL, err_msg=f"d{name}")
        np.testing.assert_allclose(a.numpy(), np.asarray(wx), **TOL, err_msg=f"d{name}")


def _dense(q, k, v, pe, vl, causal, scale):
    """Dense softmax attention with the rel band (autograd reference)."""
    tq, tk = q.shape[2], k.shape[2]
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if pe is not None:
        s = s + tfa.relative_position_scores(torch.matmul(q, pe.t()) * scale, tk)
    j = torch.arange(tk)
    masked = torch.zeros(1, 1, tq, tk, dtype=torch.bool)
    if vl is not None:
        masked = masked | (j[None, None, None, :] >= vl[:, None, None, None].long())
    if causal:
        masked = masked | (j[None, :] > torch.arange(tq)[:, None])[None, None]
    return torch.matmul(torch.softmax(s.masked_fill(masked, -1e30), -1), v)


@pytest.mark.parametrize("route", ["rel", "rel_causal", "mask_only", "b5_causal",
                                   "b5_cross"])
def test_autograd_through_flash_matches_dense(route):
    tq, tk = (37, 90) if route in ("mask_only", "b5_cross") else (80, 80)
    q, k, v, pe, vl, g = _inputs(tq, tk, 12, seed=3)
    causal = route in ("rel_causal", "b5_causal")
    t = {n: torch.from_numpy(a).requires_grad_(n != "vl")
         for n, a in zip(("q", "k", "v", "pe", "vl"), (q, k, v, pe, vl))}
    pe_t = t["pe"] if route.startswith("rel") else None
    vl_t = None if route.startswith("b5") else t["vl"]
    out = tfa.flash_attention(t["q"], t["k"], t["v"], causal=causal, scale=0.125,
                              rel_pe=pe_t, kv_valid_len=vl_t)
    ref = _dense(t["q"], t["k"], t["v"], pe_t, vl_t, causal, 0.125)
    wrt = [t["q"], t["k"], t["v"]] + ([pe_t] if pe_t is not None else [])
    got = torch.autograd.grad(out, wrt, torch.from_numpy(g))
    want = torch.autograd.grad(ref, wrt, torch.from_numpy(g))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), **TOL)


def test_b6_backward_matches_autograd_through_plain():
    rng = np.random.default_rng(0)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((2, 50, 4, 64)).astype(np.float32))
                  for _ in range(4))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out, _ = tfc.flash_forward_nhd(*leaves, causal=True, scale=0.125)
    got = torch.autograd.grad(out, leaves, g)
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    ref, _ = tfc.flash_forward_nhd_plain(*plain, causal=True, scale=0.125)
    want = torch.autograd.grad(ref, plain, g)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), **TOL)


@pytest.mark.parametrize("block_k", [16, 512])
def test_blockwise_backward_is_independent_of_the_key_block(block_k):
    rng = np.random.default_rng(1)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((1, 2, 70, 32)).astype(np.float32))
                  for _ in range(4))
    out, lse = tfc.flash_forward_plain(q, k, v, causal=True, scale=0.2)
    got = tfc.flash_backward_blockwise(q, k, v, out, lse, g, causal=True, scale=0.2,
                                       block_k=block_k)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref, _ = tfc.flash_forward_plain(*leaves, causal=True, scale=0.2)
    want = torch.autograd.grad(ref, leaves, g)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), **TOL)


@pytest.mark.parametrize("route", ["rel", "mask_only", "b5", "b6"])
def test_kernel_outputs_keep_the_graph(route):
    """Repair check: the flash wrappers never return a detached output when
    an input requires grad (on the CPU here; chip_smoke.py checks CUDA)."""
    q, k, v, pe, vl, _ = _inputs(24, 24, 4, seed=5)
    q_t = torch.from_numpy(q).requires_grad_()
    k_t, v_t = torch.from_numpy(k), torch.from_numpy(v)
    if route == "rel":
        out = tfa.flash_attention(q_t, k_t, v_t, causal=False, scale=1.0,
                                  rel_pe=torch.from_numpy(pe),
                                  kv_valid_len=torch.from_numpy(vl))
    elif route == "mask_only":
        out = tfa.flash_attention(q_t, k_t, v_t, causal=False, scale=1.0,
                                  kv_valid_len=torch.from_numpy(vl))
    elif route == "b5":
        out, _ = tfc.flash_forward(q_t, k_t, v_t, causal=True, scale=1.0)
    else:
        tr = lambda x: x.transpose(1, 2)
        out, _ = tfc.flash_forward_nhd(tr(q_t), tr(k_t), tr(v_t), causal=True, scale=1.0)
    assert out.grad_fn is not None and out.requires_grad


def test_backward_on_cpu_counts_no_launch():
    q, k, v, pe, vl, g = map(torch.from_numpy, _inputs(30, 30, 4, seed=1))
    before = (tfa.flash_rel_backward.launches, tfc.flash_backward.launches)
    q.requires_grad_()
    out = tfa.flash_attention(q, k, v, causal=False, scale=1.0, rel_pe=pe, kv_valid_len=vl)
    out.backward(g)
    out, _ = tfc.flash_forward(q, k, v, causal=True, scale=1.0)
    out.backward(g)
    assert (tfa.flash_rel_backward.launches, tfc.flash_backward.launches) == before


def test_fully_masked_row_gets_zero_gradient_not_nan():
    q, k, v, pe, _, g = map(torch.from_numpy, _inputs(20, 20, 4, seed=2))
    vl = torch.tensor([20, 0], dtype=torch.int32)
    out, lse = tfa.flash_rel_forward(q, k, v, pe, vl, causal=False, scale=0.125)
    dq, dk, dv, dpe = tfa.flash_rel_backward(q, k, v, pe, vl, out, lse, g,
                                             causal=False, scale=0.125)
    for t in (dq, dk, dv, dpe):
        assert torch.isfinite(t).all()
    assert float(dq[1].abs().max()) == 0.0 and float(dv[1].abs().max()) == 0.0


def test_dense_mha_dropout_only_when_training():
    module = tattn.MultiHeadAttention(16, 2)
    x = torch.randn(2, 5, 16)
    gen = torch.Generator().manual_seed(0)
    a = tattn.multi_head_attention(module, x, attn_impl="dense", dropout_p=0.5,
                                   generator=gen, training=False)
    b = tattn.multi_head_attention(module, x, attn_impl="dense")
    c = tattn.multi_head_attention(module, x, attn_impl="dense", dropout_p=0.5,
                                   generator=gen, training=True)
    torch.testing.assert_close(a, b)
    assert not torch.allclose(b, c)
