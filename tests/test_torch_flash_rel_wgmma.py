"""The wgmma form of kernel B1 (loco_asr_tpu_torch.ops.cuda.flash_attention).

On the CPU: the forward's form by operand type and kernel head dim
(``flash_causal.kernel_form``, padded head dims included); the form that the
launch path hands the C entry before the operand type (a recording library
in place of the built one) and ``flash_rel_forward.launches_by_form``; a
mirror of the form's
host-side plan, kept here (:func:`wgmma_forward_plan`), against a plain
enumeration of the (query, key) pairs: the key tiles of each block under
``valid_len`` and ``causal``, the tiles that load a band window, each
tensor map's dims and byte strides against the element addresses of
[B, H, T, D], ``split_heads``, Ulysses head-block, tensor-parallel and
cross-attention views, and the shared memory of a block within the limit
and the same at L = 160, 512 and 2048; a bf16 band launch at L = 512
reaching ``loco_flash_rel_fwd`` and ``loco_flash_rel_bwd`` at head dims 64
and 128 without a shared-memory limit; and at L = 512 the port's plain
bf16 forward and backward against the JAX package's ``flash_attention``
(``rel_pe=``, ``kv_valid_len=``) in Pallas interpret mode, on numpy inputs
from a seed, within the bf16 tolerances of
``tests/test_torch_bf16_kernels.py``: one bf16 ulp of the JAX value
(``|d| <= max(2^-8 |jax|, ulp(jax)) + 1e-6``), plus the reach of one bf16
rounding flip of p or ds (``2^-8 max_j p_ij |v_jd|`` for out, alike for
the gradients), and lse within 1e-5.

On a CUDA device (marker ``cuda``): the form against the plain version
within ``2^-7 max|plain|`` (lse within 1e-3), with the band and mask-only,
causal and not, head dims 64 and 128, Tq != Tk, ragged T, ``valid_len`` 0
rows, strided views, at L = 512 with B3/B4 beside it; three full-width
launches bit for bit alike; the C plan against the mirror; the C entry
refusing a form it has no kernel for.

On a GPU machine without JAX, run the kernel tests alone:
``python -m pytest --noconftest tests/test_torch_flash_rel_wgmma.py -m cuda``."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
    import jax.numpy as jnp

    from loco_asr_tpu.ops.pallas.flash_attention import flash_attention as jax_flash_attention
except ImportError:   # only the tests marked ``cuda`` run without JAX
    jax = None

from loco_asr_tpu_torch.ops.cuda import _build
from loco_asr_tpu_torch.ops.cuda import flash_attention as tfa
from loco_asr_tpu_torch.ops.cuda import flash_causal as tfc

BF16 = torch.bfloat16
BF16_REL = 2.0 ** -7   # max |d| <= 2^-7 max |plain| on the card (chip_smoke.py phase 16)
LSE_CARD = 1e-3        # lse on the card (chip_smoke.py phase 16)
ULP = 2.0 ** -8        # one bf16 ulp relative to the JAX value (test_torch_bf16_kernels.py)
LSE_TOL = 1e-5         # lse against JAX (test_torch_bf16_kernels.py)
SMEM_LIMIT = 232448    # bytes of shared memory one block may use on an H100


# ---- the form of a launch ---------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("d", [8, 12, 16, 32, 33, 64, 80, 128])
def test_forward_form_by_type_and_head_dim(dtype, d):
    """bf16 at kernel head dims 64 and 128 (33-128 padded up to them) takes
    the wgmma form; f32 and bf16 below stay on mma.sync."""
    kd = tfc.kernel_head_dim(d, "t")
    want = "wgmma" if dtype is BF16 and kd in (64, 128) else "mma_sync"
    assert tfc.kernel_form(dtype, kd) == want
    assert (want == "wgmma") == (dtype is BF16 and d > 32)


class _Recorder:
    """Stands in for the built library: each entry point records its
    arguments and reports success (0, also as shared-memory bytes)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *a: (self.calls.append((name, a)), 0)[1]


@pytest.fixture
def recorder(monkeypatch):
    """The library is the recorder, tensors off the CPU pass the CUDA guard,
    and the plain versions raise: what runs is the launch path alone."""
    rec = _Recorder()
    monkeypatch.setattr(_build, "library", lambda: rec)
    monkeypatch.setattr(_build, "require_cuda", lambda t, what: None)
    monkeypatch.setattr(_build, "call_on_stream", lambda fn, dev, *a: fn(*a, None))
    for name in ("flash_rel_forward_plain", "flash_rel_backward_plain"):
        monkeypatch.setattr(tfa, name, lambda *a, **k: pytest.fail("plain version ran"))
    for fn in (tfa.flash_rel_forward, tfa.flash_rel_backward):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "launches_by_form", dict.fromkeys(tfc.FORMS, 0))
    tfa._smem_bytes.cache_clear()
    yield rec
    tfa._smem_bytes.cache_clear()


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("d", [8, 32, 64, 80, 128])
@pytest.mark.parametrize("mask_only", [False, True])
def test_launch_passes_the_form_before_the_operand_type(recorder, dtype, d, mask_only):
    q, k, v = (torch.zeros(2, 3, 40, d, dtype=dtype) for _ in range(3))
    pe = torch.zeros(2 if mask_only else 16, d, dtype=dtype)
    out, lse = tfa._launch_forward(q, k, v, pe, torch.tensor([40, 20]), True, 0.125,
                                   mask_only=mask_only)
    assert out.shape == q.shape and out.dtype is dtype and lse.shape == (2, 3, 40)
    name, args = recorder.calls[-1]
    assert name == "loco_flash_rel_fwd"
    kd = tfc.kernel_head_dim(d, "t")
    form = tfc.FORMS.index(tfc.kernel_form(dtype, kd))
    # (..., D, two_l, causal, mask_only, scale, form, operand type, stream)
    assert args[-8:-1] == (kd, pe.shape[0], 1, int(mask_only), 0.125, form, int(dtype is BF16))
    assert form == int(dtype is BF16 and d >= 64)
    # the wgmma form asks no shared memory of the library: it does not depend on L
    asked = [n for n, _ in recorder.calls if n.endswith("smem_bytes")]
    assert asked == ([] if form else ["loco_flash_rel_smem_bytes"])
    assert tfa.flash_rel_forward.launches_by_form == {"mma_sync": 1 - form, "wgmma": form}


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_forward_counts_launches_by_form(recorder, dtype):
    """The launch path on the encoder's band at [B, 12, T, 64], the
    cross-attention's mask-only 16 queries over 40 keys, and head dims 8
    and 128 (L = 512 there)."""

    def call(b, h, tq, tk, d, two_l):
        q = torch.zeros(b, h, tq, d, dtype=dtype)
        k, v = (torch.zeros(b, h, tk, d, dtype=dtype) for _ in range(2))
        pe = torch.zeros(two_l or 2, d, dtype=dtype)
        vl = torch.full((b,), tk, dtype=torch.int32)
        out, lse = tfa._launch_forward(q, k, v, pe, vl, False, 0.125, mask_only=two_l is None)
        assert out.shape == q.shape and lse.shape == (b, h, tq)

    call(2, 12, 40, 40, 64, 32)
    call(2, 12, 16, 40, 64, None)
    call(2, 4, 40, 40, 8, 20)
    call(2, 6, 40, 40, 128, 1024)
    bf16 = dtype is BF16
    assert tfa.flash_rel_forward.launches == 4
    assert tfa.flash_rel_forward.launches_by_form == {
        "mma_sync": 1 if bf16 else 4, "wgmma": 3 if bf16 else 0}
    assert [a[-3] for n, a in recorder.calls if n == "loco_flash_rel_fwd"] == (
        [1, 1, 0, 1] if bf16 else [0] * 4)


@pytest.mark.parametrize("d", [64, 128])
def test_band_launch_at_l512_reaches_the_forward_and_backward(recorder, d):
    """A bf16 step's B1 and B3 + B4 at L = 512 (2L = 1024 pe rows), with
    the band: both reach their C entries in the wgmma form, and no limit on
    L is checked (the mma.sync forms' table of 1024 rows would not fit)."""
    q, k, v, g = (torch.zeros(2, 3, 600, d, dtype=BF16) for _ in range(4))
    pe = torch.zeros(1024, d, dtype=BF16)
    vl = torch.tensor([600, 555])
    out, lse = tfa._launch_forward(q, k, v, pe, vl, False, 0.125, mask_only=False)
    tfa._launch_backward(q, k, v, pe, vl, lse, lse, g, False, 0.125, mask_only=False)
    assert [n for n, _ in recorder.calls] == ["loco_flash_rel_fwd", "loco_flash_rel_bwd"]
    wgmma = tfc.FORMS.index("wgmma")
    assert [a[-3] for _, a in recorder.calls] == [wgmma, wgmma]
    assert [a[-7] for _, a in recorder.calls] == [1024] * 2   # two_l
    assert tfa.flash_rel_forward.launches_by_form["wgmma"] == 1
    assert tfa.flash_rel_backward.launches_by_form["wgmma"] == 1


# ---- the wgmma form's launch plan -----------------------------------------------


# The mirror of the wgmma form's host-side plan (csrc/flash_rel.cu, namespace
# wg, ``fwd_plan``; hopper.cuh's band window): a block per (b*h, 64 query
# rows), 64-key tiles, two consumer warpgroups; a tile's band window is the
# 128 pe rows from the first its pairs reach, none for a tile whose every
# pair is past one clip edge.
TILE = 64
BAND_ROWS = 128
BAND_LD = 136   # f32 row stride of a warpgroup's window


def _clip(d: int, half: int) -> int:
    return min(max(d, -half), half - 1)


def band_clipped(q0: int, k0: int, half: int) -> bool:
    """Every pair of the tile of queries from ``q0`` and keys from ``k0``
    past one clip edge (``band_clipped`` in hopper.cuh)."""
    return q0 - (k0 + TILE - 1) >= half - 1 or q0 + TILE - 1 - k0 <= -half


def wgmma_forward_key_tiles(q0: int, vl: int, tk: int, causal: bool) -> int:
    """Key tiles of the block at query row ``q0`` (``wg::key_tiles``): every
    one below ``tk`` when ``vl`` is 0 (every key counts), else those below
    ``vl`` and, under ``causal``, none wholly above the block's last row."""
    n = -(-tk // TILE)
    if vl > 0:
        n = min(n, -(-vl // TILE))
        if causal:
            n = min(n, (q0 + TILE - 1) // TILE + 1)
    return n


def wgmma_forward_plan(b: int, h: int, tq: int, tk: int, kd: int, two_l: int, causal: bool,
                       mask_only: bool, valid_len, strides) -> dict:
    """The wgmma form's launch as the C code plans it (``fwd_plan`` and the
    tiles its blocks take), from the dims, the host's ``valid_len`` and the
    element strides the wrapper passes (batch, head, time of q, k, v, then
    out's): the blocks ((b, h) x query tiles) with their key tiles and band
    windows, the tensor maps of q, k, v and pe (dims innermost first, byte
    strides of the outer three; an axis of size 1 takes the packed stride:
    it is never stepped), and the block's threads, stages, consumer
    warpgroups and dynamic shared memory (Q, the ring of K, V and windows,
    the warpgroups' f32 windows, the barriers, 1024 bytes to align)."""
    nq = -(-tq // TILE)
    half = two_l // 2
    blocks = []
    for bi in range(b):
        vl = max(0, min(int(valid_len[bi]), tk))
        for y in range(nq):
            nk = wgmma_forward_key_tiles(y * TILE, vl, tk, causal)
            windows = 0 if mask_only else sum(not band_clipped(y * TILE, i * TILE, half)
                                              for i in range(nk))
            blocks.append(dict(b=bi, q0=y * TILE, key_tiles=nk, windows=windows))
    maps = {}
    for i, (name, t) in enumerate((("q", tq), ("k", tk), ("v", tk))):
        sb, sh, st = (2 * x for x in strides[3 * i:3 * i + 3])
        s_t = 2 * kd if t == 1 else st
        s_h = s_t * t if h == 1 else sh
        s_b = s_h * h if b == 1 else sb
        maps[name] = dict(dims=(kd, t, h, b), strides=(s_t, s_h, s_b))
    maps["pe"] = dict(dims=(kd, two_l, 1, 1), strides=(2 * kd, 2 * kd * two_l, 2 * kd * two_l))
    halves = kd // 64
    tile = halves * TILE * 64 * 2                   # one 64-row tile of bf16
    stages = 4 if kd == 64 else 2
    pe_bytes = halves * 8 * 64 * 2 if mask_only else stages * 2 * tile
    band_bytes = 8 if mask_only else 2 * TILE * BAND_LD * 4
    smem = 1024 + tile + 2 * stages * tile + pe_bytes + band_bytes + 8 * (1 + 2 * stages)
    return dict(blocks=blocks, grid=(b * h, nq), maps=maps, threads=384, stages=stages,
                consumers=2, smem_bytes=smem,
                key_tiles=h * sum(x["key_tiles"] for x in blocks),
                windows=h * sum(x["windows"] for x in blocks))


def _enumerated(b_vls, tq, tk, two_l, causal, mask_only):
    """Each block's key tiles and band windows from its pairs: a key tile
    is read when one of its keys meets one of the block's 64 rows unmasked
    (every key below Tk when the valid length is 0); a read tile loads a
    window when its pairs reach more than one table column."""
    half = two_l // 2
    out = []
    for vl in b_vls:
        vl = min(vl, tk)
        for q0 in range(0, tq, TILE):
            rows = range(q0, q0 + TILE)
            read = [any((vl == 0 and j < tk) or (j < vl and (not causal or j <= i))
                        for i in rows for j in range(k0, k0 + TILE))
                    for k0 in range(0, tk, TILE)]
            assert read == sorted(read, reverse=True)   # a prefix of the key tiles
            nk = sum(read)
            cols = [{_clip(i - j, half) + half for i in rows for j in range(k0, k0 + TILE)}
                    for k0 in range(0, nk * TILE, TILE)]
            out.append((nk, 0 if mask_only else sum(len(c) > 1 for c in cols)))
    return out


PLAN_CASES = [  # (Tq, Tk, valid lengths, 2L)
    (249, 249, [249, 230, 17, 0], 320), (160, 500, [500, 310, 0, 77], 2),
    (61, 61, [61, 30, 1, 0], 20), (90, 90, [90, 64, 63, 65], 8), (1, 1, [1, 0], 2),
    (130, 70, [70, 69, 1, 40], 400), (600, 600, [600, 555], 1024), (200, 300, [300, 300], 64),
]


@pytest.mark.parametrize("tq,tk,vls,two_l", PLAN_CASES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask_only", [False, True])
def test_plan_tiles_match_enumeration(tq, tk, vls, two_l, causal, mask_only):
    """The key tiles the wgmma B1 skips past valid_len and the diagonal
    (none when the valid length is 0) and the tiles that load a band window,
    from the formulas as from the pairs themselves."""
    plan = wgmma_forward_plan(len(vls), 3, tq, tk, 64, two_l, causal, mask_only, vls, [0] * 12)
    assert plan["grid"] == (3 * len(vls), -(-tq // TILE))
    assert [(x["key_tiles"], x["windows"]) for x in plan["blocks"]] == _enumerated(
        vls, tq, tk, two_l, causal, mask_only)
    assert all(x["key_tiles"] >= 1 for x in plan["blocks"])
    assert plan["key_tiles"] == 3 * sum(x["key_tiles"] for x in plan["blocks"])


def test_plan_windows_reach_every_column_their_pairs_read():
    """A window's 128 rows from band_first hold every table column its
    tile's pairs read (at most 127), and start at a row >= 0, so the TMA
    copy of a window never starts before the table."""
    for two_l in (2, 8, 20, 320, 1024):
        half = two_l // 2
        for q0, k0 in itertools.product(range(0, 640, TILE), repeat=2):
            if band_clipped(q0, k0, half):
                continue
            first = _clip(q0 - (k0 + TILE - 1), half) + half
            cols = {_clip(i - j, half) + half
                    for i in range(q0, q0 + TILE) for j in range(k0, k0 + TILE)}
            assert 0 <= first == min(cols) and max(cols) - first < BAND_ROWS


def _views(kind, d=64):
    """(q, k, v) [B, H, T, D] views of each layout the form reads, small."""
    b, t, h = 2, 33, 3
    if kind == "bhtd":
        return tuple(torch.zeros(b, h, t, d, dtype=BF16) for _ in range(3))
    if kind == "split_heads":   # [B, T, H * D] projections viewed as heads
        return tuple(torch.zeros(b, t, h * d, dtype=BF16).reshape(b, t, h, d).transpose(1, 2)
                     for _ in range(3))
    if kind == "ulysses":       # [B, H/sp, T, D] head blocks of [B, T, 12, D]
        x = torch.zeros(b, t, 12, d, dtype=BF16)
        return tuple(x[:, :, 3 * i:3 * i + 3].transpose(1, 2) for i in range(3))
    if kind == "tp_local":      # a rank's 2 heads of a [B, T, 2 * 3 * D] qkv block
        x = torch.zeros(b, t, 3 * 2 * d, dtype=BF16)
        return tuple(y.reshape(b, t, 2, d).transpose(1, 2) for y in x.split(2 * d, dim=-1))
    if kind == "cross":         # 16 queries over 40 keys
        q = torch.zeros(b, h, 16, d, dtype=BF16)
        k, v = (torch.zeros(b, t + 7, h * d, dtype=BF16).reshape(b, t + 7, h, d).transpose(1, 2)
                for _ in range(2))
        return q, k, v
    if kind == "size_one":      # B = H = 1, Tq = 1
        return (torch.zeros(1, 1, 1, d, dtype=BF16),
                *(torch.zeros(1, 1, 5, d, dtype=BF16) for _ in range(2)))
    raise ValueError(kind)


VIEWS = ["bhtd", "split_heads", "ulysses", "tp_local", "cross", "size_one"]


def _strides(q, k, v):
    strides = tfc.operand_strides((("q", q), ("k", k), ("v", v)), 2, "t")
    out = tfa._heads_view_buffer(q.shape[0], q.shape[1], q.shape[2], q.shape[3], "cpu")
    return strides + list(out.stride()[:3])


@pytest.mark.parametrize("kind", VIEWS)
@pytest.mark.parametrize("d", [64, 128])
def test_plan_maps_address_every_element(kind, d):
    q, k, v = _views(kind, d)
    b, h, tq, _ = q.shape
    tk = k.shape[2]
    plan = wgmma_forward_plan(b, h, tq, tk, d, 40, False, False, [tk] * b, _strides(q, k, v))
    for name, x in (("q", q), ("k", k), ("v", v)):
        m = plan["maps"][name]
        t = x.shape[2]
        assert m["dims"] == (d, t, h, b)
        s_t, s_h, s_b = m["strides"]
        assert all(s % 16 == 0 and s > 0 for s in m["strides"])
        for bi, hi, ti in itertools.product(range(b), range(h), range(t)):
            offset = x[bi, hi, ti].data_ptr() - x.data_ptr()
            assert offset == ti * s_t + hi * s_h + bi * s_b, (name, bi, hi, ti)
        assert x.stride(3) == 1   # a box row is 64 neighbouring elements
    assert plan["maps"]["pe"] == dict(dims=(d, 40, 1, 1), strides=(2 * d, 80 * d, 80 * d))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("mask_only", [False, True])
def test_plan_shared_memory_is_the_same_at_every_l(d, mask_only):
    """A block's tiles, ring and windows fit the 227 KB a block may opt in
    to on an H100, and take the same bytes at L = 160, 512 and 2048: the
    band comes in by tile, not as a table of the whole 2L rows."""
    plans = [wgmma_forward_plan(1, 1, 600, 600, d, 2 * L, False, mask_only, [600], [0] * 12)
             for L in (160, 512, 2048)]
    smem = {p["smem_bytes"] for p in plans}
    assert len(smem) == 1 and smem.pop() <= SMEM_LIMIT
    p = plans[0]
    assert (p["threads"], p["stages"], p["consumers"]) == (384, 4 if d == 64 else 2, 2)
    assert p["stages"] % p["consumers"] == 0   # each stage serves one warpgroup
    tile = d * TILE * 2
    windows = 0 if mask_only else 2 * TILE * BAND_LD * 4 + p["stages"] * 2 * tile
    assert p["smem_bytes"] >= tile + 2 * p["stages"] * tile + windows


def test_plan_strides_of_size_one_axes_are_packed():
    plan = wgmma_forward_plan(1, 1, 1, 1, 128, 2, False, True, [1], [0] * 12)
    for name in "qkv":
        assert plan["maps"][name]["strides"] == (256, 256, 256)


# ---- the port's plain path against the JAX package at L = 512 --------------------


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at ``x``: 2^(e - 7) for |x| in [2^e, 2^(e+1))."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def _flips(q, k, v, pe, vl, out, lse, g, scale: float) -> dict:
    """How far one bf16 rounding flip of an operand that the JAX kernels
    round before a product moves each output (``test_torch_bf16_kernels.py``'s
    ``p_flip_scale``, there for B5/B6's out): p before p.v (out) and p^T.g
    (dv), ds before ds.k (dq) and ds^T.q (dk), each 2^-8 of the largest
    term of the sum, with p and ds of B1's scores (the band and the key mask
    in).  XLA's and torch's float32 exp and sums differ in the last bits,
    which now and then flips the rounding of one p or ds; where an output is
    a small difference of larger terms that is more than its own ulp."""
    s = tfa._scores(q.float(), k.float(), pe.float(), scale)
    masked = tfa._masked(vl, q.shape[2], k.shape[2], False, q.device)
    p = torch.exp(s - lse[..., None]).masked_fill(masked, 0.0)
    delta = (g.float() * out.float()).sum(-1)
    ds = (p * (g.float() @ v.float().transpose(-1, -2) - delta[..., None])).abs()

    def reach(w, x):   # 2^-8 max_j w_ij |x_jd|
        return (ULP * (w[..., None] * x.float().abs()[..., None, :, :]).amax(dim=-2)).numpy()

    p_soft = torch.softmax(s.masked_fill(masked, -1e30), dim=-1)
    return dict(out=reach(p_soft, v), dv=reach(p.transpose(-1, -2), g),
                dq=reach(ds, k) * scale, dk=reach(ds.transpose(-1, -2), q) * scale)


def _assert_bf16_close(got: torch.Tensor, want, what: str, flip=0.0) -> None:
    """Equal dtypes and every element within one bf16 ulp of the JAX value,
    plus ``flip`` for attention outputs (``test_torch_bf16_kernels.py``'s
    rule)."""
    assert got.dtype is BF16 and want.dtype == jnp.bfloat16, (what, got.dtype, want.dtype)
    g, w = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err = np.abs(g - w)
    bad = err > np.maximum(ULP * np.abs(w), _bf16_ulp(w)) + flip + 1e-6
    assert not bad.any(), (f"{what}: {bad.sum()} of {bad.size} elements beyond one ulp, "
                           f"worst {err.max():.3g}")


@pytest.mark.skipif(jax is None, reason="needs the JAX package")
def test_plain_bf16_matches_jax_at_l512():
    """At L = 512, past the 272 that the mma.sync forms' table left B3 at
    head dim 64: [1, 2, 600, 64] q, k, v, a [1024, 64] table, valid length
    555, non-causal.  The JAX ``flash_attention(rel_pe=, kv_valid_len=)``
    in interpret mode and its VJP against the port's plain bf16 forward and
    backward (``flash_rel_forward`` / ``flash_rel_backward`` on CPU
    tensors): out, dq, dk, dv and dpe within one bf16 ulp, out, dq, dk and dv
    also within the reach of one rounding flip of p or ds (:func:`_flips`),
    lse (the JAX forward's) within 1e-5."""
    from loco_asr_tpu.ops.pallas.flash_attention import _flash_rel_forward

    rng = np.random.default_rng(512)

    def draw(shape, sc):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * sc).to(BF16)
        return x, jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)

    (q, jq), (k, jk), (v, jv) = (draw((1, 2, 600, 64), 0.6) for _ in range(3))
    pe, jpe = draw((1024, 64), 0.6)
    g, jg = draw((1, 2, 600, 64), 1.0)
    vl = np.asarray([555], np.int32)
    scale = 0.125

    def jax_attn(a, b_, c, p):
        return jax_flash_attention(a, b_, c, causal=False, scale=scale, rel_pe=p,
                                   kv_valid_len=jnp.asarray(vl), interpret=True)

    jout, vjp = jax.vjp(jax_attn, jq, jk, jv, jpe)
    jgrads = vjp(jg)
    _, jlse = _flash_rel_forward(jq, jk, jv, jpe, jnp.asarray(vl), causal=False, scale=scale,
                                 block_q=256, block_k=640, interpret=True)
    out, lse = tfa.flash_rel_forward_plain(q, k, v, pe, torch.from_numpy(vl), causal=False,
                                           scale=scale)
    jout_t = torch.from_numpy(np.array(jout.astype(jnp.float32))).to(BF16)
    jlse_t = torch.from_numpy(np.array(jlse))
    flips = _flips(q, k, v, pe, torch.from_numpy(vl), jout_t, jlse_t, g, scale)
    _assert_bf16_close(out, jout, "B1 out at L = 512", flips["out"])
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=LSE_TOL, rtol=0)
    got = tfa.flash_rel_backward(q, k, v, pe, torch.from_numpy(vl), jout_t, jlse_t, g,
                                 causal=False, scale=scale)
    for name, a, w in zip(("dq", "dk", "dv", "dpe"), got, jgrads):
        _assert_bf16_close(a, w, f"B3/B4 {name} at L = 512", flips.get(name, 0.0))


# ---- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


def _bf16(rng, shape, dev, sc=0.5):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * sc).to(dev, BF16)


def _held(q, k, v, pe, vl, causal, mask_only, scale=0.125):
    """The wrapper's forward (one launch of the wgmma form, counted) against
    the plain version on the same inputs: out's error over 2^-7 max|plain|
    and lse's over 1e-3, as ratios."""
    table = torch.zeros(2, q.shape[-1], dtype=BF16, device=q.device) if mask_only else pe
    before = dict(tfa.flash_rel_forward.launches_by_form)
    with torch.no_grad():
        out, lse = tfa.flash_rel_forward(q, k, v, None if mask_only else pe, vl, causal=causal,
                                         scale=scale)
    torch.cuda.synchronize()
    assert tfa.flash_rel_forward.launches_by_form == {**before, "wgmma": before["wgmma"] + 1}
    want, want_lse = tfa.flash_rel_forward_plain(q, k, v, table, vl, causal=causal, scale=scale)
    assert out.dtype is BF16 and out.shape == want.shape
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    err = (out.float() - want.float()).abs().max().item()
    lse_err = (lse - want_lse).abs().max().item()
    return out, lse, [err / max(BF16_REL * want.float().abs().max().item(), 1e-30),
                      lse_err / LSE_CARD]


CUDA_CASES = [  # (B, H, Tq, Tk, valid lengths, L)
    (2, 3, 249, 249, [249, 120], 160), (2, 3, 160, 500, [500, 431], 160),
    (3, 2, 61, 61, [61, 0, 30], 20), (2, 2, 90, 90, [90, 1], 8), (2, 2, 130, 70, [70, 69], 150),
    (1, 2, 600, 600, [555], 512), (2, 2, 300, 300, [300, 0], 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask_only", [False, True])
def test_cuda_wgmma_matches_plain(d, causal, mask_only, cuda):
    rng = np.random.default_rng(d + 2 * causal + 4 * mask_only)
    bad = {}
    for b, h, tq, tk, vls, L in CUDA_CASES:
        q = _bf16(rng, (b, h, tq, d), cuda)
        k, v = _bf16(rng, (b, h, tk, d), cuda), _bf16(rng, (b, h, tk, d), cuda)
        pe = _bf16(rng, (2 * L, d), cuda)
        vl = torch.tensor(vls, dtype=torch.int32, device=cuda)
        *_, ratios = _held(q, k, v, pe, vl, causal, mask_only)
        if max(ratios) > 1:
            bad[(tq, tk, tuple(vls), L)] = ratios
    assert not bad, f"(Tq, Tk, valid lengths, L): errors over their limits {bad}"


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_wgmma_valid_len_0_rows_average_every_key(d, cuda):
    """A batch row of valid length 0 weighs its Tk keys equally (the plain
    version's -1e30 mask), with or without the band, causal or not; its
    lse is -1e30 + log Tk."""
    rng = np.random.default_rng(30 + d)
    q, k, v = (_bf16(rng, (2, 2, 100, d), cuda) for _ in range(3))
    pe = _bf16(rng, (40, d), cuda)
    vl = torch.tensor([0, 37], dtype=torch.int32, device=cuda)
    for causal, mask_only in itertools.product((False, True), repeat=2):
        out, lse, ratios = _held(q, k, v, pe, vl, causal, mask_only)
        assert max(ratios) <= 1, (causal, mask_only, ratios)
        mean = v[0].float().mean(dim=1, keepdim=True).expand(2, 100, d)
        assert (out[0].float() - mean).abs().max().item() <= BF16_REL * mean.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_wgmma_at_full_width_is_repeatable(d, cuda):
    """The encoder's shape ([16, 12, 249, 64], L = 160; [16, 6, 249, 128] at
    D = 128): a grid of several waves; three launches give the same bits
    and hold to the plain version."""
    rng = np.random.default_rng(60 + d)
    h = 12 if d == 64 else 6
    q, k, v = (_bf16(rng, (16, h, 249, d), cuda, sc=0.3) for _ in range(3))
    pe = _bf16(rng, (320, d), cuda, sc=0.3)
    vl = torch.tensor([249] * 10 + [230, 200, 180, 120, 60, 17], dtype=torch.int32, device=cuda)
    runs = [_held(q, k, v, pe, vl, False, False) for _ in range(3)]
    for out, lse, ratios in runs:
        assert max(ratios) <= 1, ratios
        assert torch.equal(out, runs[0][0]) and torch.equal(lse, runs[0][1])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["split_heads", "ulysses", "tp_local", "cross"])
def test_cuda_wgmma_reads_strided_views(kind, cuda):
    """q, k and v read in place through their strides."""
    rng = np.random.default_rng(len(kind))
    q, k, v = (x.to(cuda) for x in _views(kind))
    q, k, v = (x.copy_(_bf16(rng, x.shape, cuda)) for x in (q, k, v))
    vl = torch.tensor([k.shape[2], k.shape[2] - 9], dtype=torch.int32, device=cuda)
    for mask_only in (False, True):
        *_, ratios = _held(q, k, v, _bf16(rng, (40, 64), cuda), vl, False, mask_only)
        assert max(ratios) <= 1, (mask_only, ratios)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_band_at_l512_forward_and_backward(d, cuda):
    """C4: a bf16 step's forward and backward with the band at L = 512, past
    the mma.sync forms' table: B1 and B3 + B4 in the wgmma form, each held
    to its plain version (gradients with the band's matmuls, dpe too)."""
    rng = np.random.default_rng(512 + d)
    q, k, v = (_bf16(rng, (2, 3, 600, d), cuda) for _ in range(3))
    pe = _bf16(rng, (1024, d), cuda)
    g = _bf16(rng, (2, 3, 600, d), cuda, sc=1.0)
    vl = torch.tensor([600, 555], dtype=torch.int32, device=cuda)
    out, lse, ratios = _held(q, k, v, pe, vl, False, False)
    assert max(ratios) <= 1, ratios
    before = tfa.flash_rel_backward.launches_by_form["wgmma"]
    got = tfa.flash_rel_backward(q, k, v, pe, vl, out, lse, g, causal=False, scale=0.125)
    torch.cuda.synchronize()
    assert tfa.flash_rel_backward.launches_by_form["wgmma"] == before + 1
    dq, dk, dv, dqpe = tfa.flash_rel_backward_plain(q, k, v, pe, vl, out, lse, g,
                                                    causal=False, scale=0.125)
    want = (dq + (dqpe @ pe.float()) * 0.125, dk, dv,
            torch.einsum("bhim,bhid->md", dqpe, q.float()) * 0.125)
    for name, a, w in zip(("dq", "dk", "dv", "dpe"), got, want):
        assert a.dtype is BF16 and torch.isfinite(a.float()).all(), name
        err = (a.float() - w.to(BF16).float()).abs().max().item()
        assert err <= BF16_REL * w.abs().max().item(), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", VIEWS)
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_plan_equals_the_c_plan(kind, d, cuda):
    """The mirror against the plan the launch encodes
    (``loco_flash_rel_fwd_wgmma_plan``), on the same strides."""
    import ctypes

    q, k, v = _views(kind, d)
    b, h, tq, _ = q.shape
    tk = k.shape[2]
    strides = _strides(q, k, v)
    for causal, mask_only, two_l in itertools.product((False, True), (False, True),
                                                      (8, 320, 1024)):
        vls = [tk, max(0, tk - 40)][:b]
        got = (ctypes.c_longlong * 35)()
        _build.library().loco_flash_rel_fwd_wgmma_plan(
            tfc.stride_buffer(tuple(strides)), b, h, tq, tk, d, two_l, int(causal),
            int(mask_only), (ctypes.c_int * b)(*vls), ctypes.addressof(got))
        plan = wgmma_forward_plan(b, h, tq, tk, d, two_l, causal, mask_only, vls, strides)
        want = [plan["grid"][0] * plan["grid"][1], plan["key_tiles"], plan["windows"]]
        for name in ("q", "k", "v", "pe"):
            want += [*plan["maps"][name]["dims"], *plan["maps"][name]["strides"]]
        want += [plan["smem_bytes"], plan["threads"], plan["stages"], plan["consumers"]]
        assert list(got) == want, (causal, mask_only, two_l)


@pytest.mark.cuda
@pytest.mark.parametrize("form,dtype,d", [(1, torch.float32, 64), (1, BF16, 32),
                                          (0, BF16, 64), (0, BF16, 128)])
def test_cuda_c_entry_refuses_a_form_it_has_no_kernel_for(form, dtype, d, cuda):
    """The wgmma form exists for bf16 at head dims 64 and 128 only, and the
    mma.sync form no longer for bf16 there: the C entry returns
    cudaErrorNotSupported, which ``_build.check`` raises, and writes
    nothing."""
    q = torch.zeros(1, 2, 16, d, dtype=dtype, device=cuda)
    pe = torch.zeros(8, d, dtype=dtype, device=cuda)
    vl = torch.full((1,), 16, dtype=torch.int32, device=cuda)
    out = torch.full_like(q, 7.0)
    lse = torch.full((1, 2, 16), 7.0, device=cuda)
    strides = tfc.operand_strides((("q", q), ("k", q), ("v", q)), 2, "t")
    strides += list(out.stride()[:3])
    code = _build.call_on_stream(
        _build.library().loco_flash_rel_fwd, cuda, q.data_ptr(), q.data_ptr(), q.data_ptr(),
        pe.data_ptr(), vl.data_ptr(), out.data_ptr(), lse.data_ptr(),
        tfc.stride_buffer(tuple(strides)), 1, 2, 16, 16, d, 8, 0, 0, 0.25, form,
        int(dtype is BF16))
    torch.cuda.synchronize()
    assert code == 801   # cudaErrorNotSupported
    with pytest.raises(RuntimeError, match="not supported"):
        _build.check(code, "flash_rel_forward")
    assert bool((out == 7.0).all()) and bool((lse == 7.0).all())
