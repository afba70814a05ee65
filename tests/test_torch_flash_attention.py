"""Kernel B1's plain version (loco_asr_tpu_torch.ops.cuda.flash_attention)
against the JAX Pallas kernel in interpret mode, out and lse, atol/rtol
1e-5 as the JAX package's own test; and the port's multi-head attention
(dense and flash paths) against the JAX one."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from loco_asr_tpu.ops import attention as jattn
from loco_asr_tpu.ops.pallas.flash_attention import _flash_rel_forward, flash_attention
from loco_asr_tpu_torch.ops import attention as tattn
from loco_asr_tpu_torch.ops.cuda import flash_attention as tfa

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(tq, L, seed, b=2, h=3, d=64):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, tq, d).astype(np.float32) * 0.3 for _ in range(3))
    pe = (rng.randn(2 * L, d).astype(np.float32) * 0.3 if L > 1
          else np.zeros((2, d), np.float32))
    return q, k, v, pe


def _jax_forward(q, k, v, pe, vl, causal, scale):
    tk = k.shape[2]
    out, lse = _flash_rel_forward(
        *map(jnp.asarray, (q, k, v, pe, vl)), causal=causal, scale=scale,
        block_q=256, block_k=min(-(-tk // 128) * 128, 1024), interpret=True)
    return np.asarray(out), np.asarray(lse)


# unmasked, padded, several tiles (T > 256 > 64), causal, mask-only (L=1,
# zero table)
CASES = {
    "unmasked": (256, 160, False, lambda t: [t, t]),
    "padded": (200, 160, False, lambda t: [t, t - 37]),
    "multi_tile": (300, 20, False, lambda t: [t, 131]),
    "causal": (256, 160, True, lambda t: [t, t - 37]),
    "mask_only": (200, 1, False, lambda t: [t, 153]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_interpret(case):
    tq, L, causal, vls = CASES[case]
    q, k, v, pe = _qkv(tq, L, seed=len(case))
    vl = np.asarray(vls(tq), np.int32)
    scale = 64 ** -0.5
    want_out, want_lse = _jax_forward(q, k, v, pe, vl, causal, scale)
    out, lse = tfa.flash_rel_forward(*map(torch.from_numpy, (q, k, v, pe, vl)),
                                     causal=causal, scale=scale)
    np.testing.assert_allclose(out.numpy(), want_out, **TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, **TOL)


def test_public_flash_attention_matches_jax():
    q, k, v, pe = _qkv(120, 20, seed=7)
    vl = np.asarray([120, 77], np.int32)
    want = np.asarray(flash_attention(*map(jnp.asarray, (q, k, v)), causal=False,
                                          scale=1.0, rel_pe=jnp.asarray(pe),
                                          kv_valid_len=jnp.asarray(vl), interpret=True))
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False, scale=1.0,
                              rel_pe=torch.from_numpy(pe), kv_valid_len=torch.from_numpy(vl))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_wrapper_on_cpu_counts_no_launch():
    q, k, v, pe = _qkv(70, 20, seed=3)
    before = tfa.flash_rel_forward.launches
    tfa.flash_rel_forward(*map(torch.from_numpy, (q, k, v, pe)),
                          torch.tensor([70, 9], dtype=torch.int32),
                          causal=False, scale=0.125)
    assert tfa.flash_rel_forward.launches == before


@pytest.mark.parametrize("rows", [0, 3])
def test_wrapper_rejects_table_without_two_l_rows(rows):
    q, k, v, _ = _qkv(16, 1, seed=5)
    pe = torch.zeros(rows, 64)
    with pytest.raises(ValueError, match="pe must be"):
        tfa.flash_rel_forward(*map(torch.from_numpy, (q, k, v)), pe,
                              torch.tensor([16, 9], dtype=torch.int32),
                              causal=False, scale=1.0)


def test_zero_valid_len_row_averages_over_exactly_tk():
    """A row with valid_len 0: the port's plain version (and its kernel)
    weighs all Tk keys equally, as the JAX dense multi_head_attention does
    (every score -1e9), within 1e-5.  The JAX Pallas kernel pads k/v with
    zeros to its key block (Tk 20 -> 24) and masks the padding like the
    rest, so its empty row averages v over 24 keys: 20/24 of the port's
    answer (loco_asr_tpu/ops/pallas/flash_attention.py:582, :619-628).
    The port keeps the answer that depends on the inputs alone."""
    b, h, t, d, L = 2, 2, 20, 64, 4
    rng = np.random.default_rng(20)
    x = (rng.standard_normal((b, t, h * d)) * 0.3).astype(np.float32)
    w_v = (rng.standard_normal((h * d, h * d)) * (h * d) ** -0.5).astype(np.float32)
    pe = (rng.standard_normal((2 * L, d)) * 0.3).astype(np.float32)
    eye, zero = jnp.eye(h * d), jnp.zeros(h * d)
    params = {"q_proj": {"kernel": eye, "bias": zero}, "k_proj": {"kernel": eye, "bias": zero},
              "v_proj": {"kernel": jnp.asarray(w_v), "bias": zero},
              "out_proj": {"kernel": eye, "bias": zero}}
    vl = np.asarray([t, 0], np.int32)
    want, _ = jattn.multi_head_attention(params, jnp.asarray(x), num_heads=h,
                                         rel_pe=jnp.asarray(pe), rel_max=L,
                                         kv_valid_len=jnp.asarray(vl), attn_impl="dense")
    split = lambda y: y.reshape(b, t, h, d).transpose(0, 2, 1, 3)
    q, k, v = split(x) * np.float32(d ** -0.5), split(x), split(x @ w_v)
    out, _ = tfa.flash_rel_forward_plain(*map(torch.from_numpy, (q, k, v, pe, vl)),
                                         causal=False, scale=1.0)
    got = out.numpy().transpose(0, 2, 1, 3).reshape(b, t, h * d)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    uniform = v[1].mean(axis=1).reshape(1, h * d)   # every key weighs 1/Tk
    np.testing.assert_allclose(got[1], np.broadcast_to(uniform, got[1].shape), **TOL)
    jout, _ = _flash_rel_forward(*map(jnp.asarray, (q, k, v, pe, vl)), causal=False,
                                 scale=1.0, block_q=256, block_k=128, interpret=True)
    jout = np.asarray(jout)
    np.testing.assert_allclose(jout[0], out.numpy()[0], **TOL)
    np.testing.assert_allclose(jout[1], out.numpy()[1] * (20 / 24), **TOL)
    assert np.abs(jout[1] - out.numpy()[1]).max() > 1e-3


@pytest.mark.cuda
def test_cuda_kernel_zero_valid_len_matches_plain():
    """The kernel keeps the plain version's answer on rows with valid_len
    0, with the rel band and mask-only, causal or not (lse included:
    -1e30 + log Tk)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    for L, causal in ((160, False), (160, True), (1, False), (1, True)):
        q, k, v, pe = (torch.from_numpy(x).to(dev) for x in _qkv(90, L, seed=L))
        vl = torch.tensor([0, 61], dtype=torch.int32, device=dev)
        table = pe if L > 1 else None
        with torch.no_grad():
            out, lse = tfa.flash_rel_forward(q, k, v, table, vl, causal=causal, scale=0.125)
        pout, plse = tfa.flash_rel_forward_plain(q, k, v, pe, vl, causal=causal, scale=0.125)
        err = max((out - pout).abs().max().item(), (lse - plse).abs().max().item())
        assert err <= 1e-4, f"L {L}, causal {causal}: {err}"


def _mha_pair(d=48, heads=4, seed=0):
    rng = np.random.default_rng(seed)
    jp, module = {}, tattn.MultiHeadAttention(d, heads)
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        w = (rng.standard_normal((d, d)) * d ** -0.5).astype(np.float32)
        b = (rng.standard_normal(d) * 0.1).astype(np.float32)
        jp[name] = {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}
        lin = getattr(module, name)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(w.T.copy()))
            lin.bias.copy_(torch.from_numpy(b))
    return jp, module


@pytest.mark.parametrize("padded", [False, True])
def test_multi_head_attention_matches_jax(padded):
    d, heads, t, L = 48, 4, 40, 10
    jp, module = _mha_pair(d, heads)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, t, d)).astype(np.float32)
    pe = (rng.standard_normal((2 * L, d // heads)) * 0.3).astype(np.float32)
    mask = np.ones((2, t), np.int32)
    if padded:
        mask[1, 25:] = 0
    vl = mask.sum(-1).astype(np.int32)
    bias = jattn.padding_attention_bias(jnp.asarray(mask)) if padded else None
    tvl = torch.from_numpy(vl) if padded else None
    pos = jattn.relative_position_bias_table(jnp.asarray(pe), t, L)
    want_dense, _ = jattn.multi_head_attention(jp, jnp.asarray(x), num_heads=heads,
                                               attention_bias=bias, position_bias=pos)
    want_flash, _ = jattn.multi_head_attention(jp, jnp.asarray(x), num_heads=heads,
                                               rel_pe=jnp.asarray(pe), rel_max=L,
                                               kv_valid_len=jnp.asarray(vl),
                                               attn_impl="flash")
    with torch.no_grad():
        got_dense = tattn.multi_head_attention(module, torch.from_numpy(x),
                                               rel_pe=torch.from_numpy(pe),
                                               kv_valid_len=tvl, attn_impl="dense")
        got_flash = tattn.multi_head_attention(module, torch.from_numpy(x),
                                               rel_pe=torch.from_numpy(pe),
                                               kv_valid_len=torch.from_numpy(vl),
                                               attn_impl="flash")
    valid = mask.astype(bool)
    for got in (got_dense, got_flash):
        for want in (want_dense, want_flash):
            np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                                       atol=1e-5, rtol=1e-5)


def test_multi_head_attention_rejects_unknown_impl():
    _, module = _mha_pair()
    with pytest.raises(ValueError, match="attn_impl"):
        tattn.multi_head_attention(module, torch.zeros(1, 4, 48), attn_impl="ring")
