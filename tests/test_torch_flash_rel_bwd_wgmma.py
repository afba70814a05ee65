"""The wgmma form of kernels B3 and B4 (loco_asr_tpu_torch.ops.cuda.flash_attention).

On the CPU: the backward's form by operand type and kernel head dim
(``flash_causal.kernel_form``, padded head dims included); the form that
the launch path hands the C entry (a recording library in place of the
built one) and ``flash_rel_backward.launches_by_form`` (``meta`` tensors
through the public wrapper); a mirror of the form's host-side plan, kept
here (:func:`wgmma_backward_plan`), against a plain enumeration of the
(query, key) pairs: grids, the key tiles of each B3 block and the query
tiles of each B4 block under ``valid_len`` and ``causal``, the key tiles
of a B3 block that load a band window, the pe rows a B4 tile pair's band
needs, each tensor map's dims and byte strides against the element
addresses of [B, H, T, D], [B, T, H, D]-buffer, Ulysses head-block and
tensor-parallel views, each kernel's shared memory within one block's
limit and the same at L = 160, 512 and 2048, and the wgmma launch at L
past the 272 (head dim 64) and 242 (128) that B3's former table allowed,
while the mma.sync form still raises past its own.  On a CUDA device
(marker ``cuda``): the form against the
plain version within ``2^-7 max|plain|`` (dq, dk, dv, dpe) with the band
and mask-only, causal and not, head dims 64 and 128, Tq != Tk, ragged T,
``valid_len`` 0 (whose rows get zero gradients), strided views, L past
the former table's limit; the C plan against the mirror; the C entry
refusing a form it has no kernel for.

On a GPU machine without JAX, run the kernel tests alone:
``python -m pytest --noconftest tests/test_torch_flash_rel_bwd_wgmma.py -m cuda``."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from loco_asr_tpu_torch.ops.cuda import _build
from loco_asr_tpu_torch.ops.cuda import flash_attention as tfa
from loco_asr_tpu_torch.ops.cuda import flash_causal as tfc

BF16 = torch.bfloat16
BF16_REL = 2.0 ** -7   # max |d| <= 2^-7 max |plain| (chip_smoke.py phase 16)
SMEM_LIMIT = 232448    # bytes of shared memory one block may use on an H100


# ---- the form of a launch ---------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("d", [8, 12, 16, 32, 33, 64, 80, 128])
def test_backward_form_by_type_and_head_dim(dtype, d):
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
    monkeypatch.setattr(tfa, "flash_rel_backward_plain",
                        lambda *a, **k: pytest.fail("plain version ran"))
    monkeypatch.setattr(tfa.flash_rel_backward, "launches", 0)
    monkeypatch.setattr(tfa.flash_rel_backward, "launches_by_form",
                        dict.fromkeys(tfc.FORMS, 0))
    return rec


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("d", [8, 32, 64, 80, 128])
@pytest.mark.parametrize("mask_only", [False, True])
def test_launch_passes_the_form_before_the_operand_type(recorder, dtype, d, mask_only):
    q, k, v, g = (torch.zeros(2, 3, 40, d, dtype=dtype) for _ in range(4))
    pe = torch.zeros(2 if mask_only else 16, d, dtype=dtype)
    lse = torch.zeros(2, 3, 40)
    dq, dk, dv, dqpe = tfa._launch_backward(q, k, v, pe, torch.tensor([40, 20]), lse, lse, g,
                                            True, 0.125, mask_only=mask_only)
    assert dq.shape == dk.shape == dv.shape == q.shape
    assert (dqpe is None) == mask_only
    name, args = recorder.calls[-1]
    assert name == "loco_flash_rel_bwd"
    kd = tfc.kernel_head_dim(d, "t")
    form = tfc.FORMS.index(tfc.kernel_form(dtype, kd))
    # (..., D, two_l, causal, mask_only, scale, form, operand type, stream)
    assert args[-8:-1] == (kd, pe.shape[0], 1, int(mask_only), 0.125, form, int(dtype is BF16))
    assert form == int(dtype is BF16 and d >= 64)
    assert tfa.flash_rel_backward.launches_by_form == {
        "mma_sync": 1 - form, "wgmma": form}


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_backward_counts_launches_by_form(recorder, dtype):
    """The public wrapper on ``meta`` tensors: the encoder's band at
    [B, 12, T, 64], the cross-attention's mask-only 16 queries over 40
    keys, and head dims 8 and 128."""
    meta = dict(device="meta", dtype=dtype)

    def call(b, h, tq, tk, d, two_l, mask_only):
        q, g = (torch.empty(b, h, tq, d, **meta) for _ in range(2))
        k, v = (torch.empty(b, h, tk, d, **meta) for _ in range(2))
        pe = torch.zeros(2 if mask_only else two_l, d, **meta)
        vl = torch.full((b,), tk, dtype=torch.int32, device="meta")
        lse = torch.empty(b, h, tq, device="meta")
        out = torch.empty(b, h, tq, d, **meta)
        got = tfa.flash_rel_backward(q, k, v, pe, vl, out, lse, g, causal=False, scale=0.125,
                                     mask_only=mask_only)
        assert got[0].shape == q.shape and got[1].shape == k.shape

    call(2, 12, 40, 40, 64, 32, False)
    call(2, 12, 16, 40, 64, 2, True)
    call(2, 4, 40, 40, 8, 20, False)
    call(2, 6, 40, 40, 128, 32, False)
    bf16 = dtype is BF16
    assert tfa.flash_rel_backward.launches == 4
    assert tfa.flash_rel_backward.launches_by_form == {
        "mma_sync": 1 if bf16 else 4, "wgmma": 3 if bf16 else 0}
    assert [a[-3] for n, a in recorder.calls if n == "loco_flash_rel_bwd"] == (
        [1, 1, 0, 1] if bf16 else [0] * 4)


# ---- the wgmma form's launch plan -----------------------------------------------


# The mirror of the wgmma form's host-side plan (csrc/flash_rel_bwd.cu,
# namespace wg, ``bwd_plan``): B3 takes
# 64 query rows a block over 64-key tiles, B4 64 keys a block over 64-query
# tiles; each reads the 128 pe rows a tile pair's band reaches (hopper.cuh),
# B3's consumer warpgroup into an f32 window [64][136] ([64][130] at head
# dim 128, for room; none for a tile whose pairs are all past one clip
# edge), B4's into its band [64][132].
TILE = 64
BAND_ROWS = 128
WINDOW_STRIDE = {64: 136, 128: 130}
BAND_STRIDE = BAND_ROWS + 4


def _clip(d: int, half: int) -> int:
    return min(max(d, -half), half - 1)


def wgmma_dq_tiles(q0: int, vl: int, two_l: int, causal: bool, mask_only: bool):
    """(key tiles, band windows) of the wgmma B3 block at query row ``q0``
    (``wg::dq_key_tiles``): every key tile below ``vl`` and, under
    ``causal``, none past the block's last row; of those, the tiles not
    wholly past one clip edge (``band_clipped`` in hopper.cuh) load a
    window (none for the mask-only variant)."""
    n = TILE
    nk = -(-vl // n)
    if causal:
        nk = min(nk, (q0 + n - 1) // n + 1)
    half = two_l // 2
    windows = 0 if mask_only else sum(
        not (q0 - (k0 + n - 1) >= half - 1 or q0 + n - 1 - k0 <= -half)
        for k0 in range(0, nk * n, n))
    return nk, windows


def wgmma_dkv_tiles(k0: int, vl: int, tq: int, causal: bool):
    """(first query tile, query tiles) of the wgmma B4 block at key ``k0``
    (``wg::dkv_tiles``): from the diagonal's tile under ``causal``, none
    when every key of the block is at or past ``vl``."""
    n = TILE
    qt0 = k0 // n if causal else 0
    return qt0, 0 if k0 >= vl else max(0, -(-tq // n) - qt0)


def wgmma_band(q0: int, k0: int, two_l: int):
    """(first pe row, pe rows) that the B4 tile pair of queries from ``q0``
    and keys from ``k0`` reaches (``wg::band_first``, ``wg::band_rows``)."""
    half, n = two_l // 2, TILE
    first = _clip(q0 - (k0 + n - 1), half) + half
    return first, _clip(q0 + n - 1 - k0, half) + half - first + 1


def wgmma_backward_plan(b: int, h: int, tq: int, tk: int, kd: int, two_l: int, causal: bool,
                        mask_only: bool, valid_len, strides) -> dict:
    """The wgmma form's launch as the C code plans it (``bwd_plan`` and the
    tiles its blocks take), from the dims, the host's ``valid_len`` and the
    element strides the wrapper passes (batch, head, time of q, k, v, g,
    then dq, dk, dv): B3's blocks ((b, h) x query tiles) with their key
    tiles and pe tiles, B4's blocks ((b, h) x key blocks) with their query
    tiles and each tile pair's pe rows, the tensor maps of q, k, v, g and pe
    (dims innermost first, byte strides of the outer three; an axis of size
    1 takes the packed stride: it is never stepped), and each kernel's
    threads, stages and dynamic shared memory."""
    n = TILE
    nq, nkb = -(-tq // n), -(-tk // n)
    dq_blocks, dkv_blocks = [], []
    for bi in range(b):
        vl = max(0, min(int(valid_len[bi]), tk))
        for y in range(nq):
            nk, windows = wgmma_dq_tiles(y * n, vl, two_l, causal, mask_only)
            dq_blocks.append(dict(b=bi, q0=y * n, key_tiles=nk, windows=windows))
        for y in range(nkb):
            qt0, nt = wgmma_dkv_tiles(y * n, vl, tq, causal)
            bands = [] if mask_only else [wgmma_band((qt0 + i) * n, y * n, two_l)
                                          for i in range(nt)]
            dkv_blocks.append(dict(b=bi, k0=y * n, qt0=qt0, query_tiles=nt, bands=bands))
    maps = {}
    for i, (name, t) in enumerate((("q", tq), ("k", tk), ("v", tk), ("g", tq))):
        sb, sh, st = (2 * x for x in strides[3 * i:3 * i + 3])
        s_t = 2 * kd if t == 1 else st
        s_h = s_t * t if h == 1 else sh
        s_b = s_h * h if b == 1 else sb
        maps[name] = dict(dims=(kd, t, h, b), strides=(s_t, s_h, s_b))
    maps["pe"] = dict(dims=(kd, two_l, 1, 1), strides=(2 * kd, 2 * kd * two_l, 2 * kd * two_l))
    halves = kd // 64
    tile = halves * n * 64 * 2                      # one 64-row tile of bf16
    dq_stages = 4 if kd == 64 else 2
    dq_windows = (halves * 8 * 64 * 2 + 8 if mask_only
                  else dq_stages * 2 * tile + 2 * n * WINDOW_STRIDE[kd] * 4)
    dq_smem = 1024 + 2 * tile + 2 * dq_stages * tile + dq_windows + 8 * (1 + 2 * dq_stages)
    dkv_w, dkv_stages = (2, 4) if kd == 64 else (1, 2)
    pe_bytes = halves * 8 * 64 * 2 if mask_only else dkv_stages * 2 * tile
    band_bytes = 16 if mask_only else dkv_w * n * BAND_STRIDE * 4
    dkv_smem = 1024 + (2 * tile + 2 * dkv_stages * tile + pe_bytes + 2 * dkv_stages * n * 4
                       + band_bytes + 8 * (1 + 2 * dkv_stages))
    return dict(dq_blocks=dq_blocks, dkv_blocks=dkv_blocks, maps=maps,
                dq=dict(grid=(b * h, nq), threads=384, stages=dq_stages, smem_bytes=dq_smem),
                dkv=dict(grid=(b * h, nkb), threads=128 * (dkv_w + 1), stages=dkv_stages,
                         smem_bytes=dkv_smem),
                key_tiles=h * sum(x["key_tiles"] for x in dq_blocks),
                windows=h * sum(x["windows"] for x in dq_blocks),
                query_tiles=h * sum(x["query_tiles"] for x in dkv_blocks),
                band_rows=h * sum(r for x in dkv_blocks for _, r in x["bands"]))


def _pairs(tq, tk, vl, causal, rows, keys):
    """The (query, key) pairs of a tile pair that the backward computes:
    keys below the valid length (and Tk), at or below the row under causal."""
    return [(i, j) for i in rows for j in keys
            if j < min(vl, tk) and (not causal or j <= i)]


def _enumerated(b_vls, tq, tk, two_l, causal, mask_only):
    """B3's key tiles and band windows (the tiles whose pairs reach more
    than one table column), and B4's query tiles and tile pairs' pe rows,
    of each block from its pairs.  B3 takes the rows of its whole 64-row
    tile (padding rows past Tq get zero gradients, as in form 0); B4 the
    queries below Tq."""
    half = two_l // 2
    dq, dkv = [], []
    for vl in b_vls:
        for q0 in range(0, tq, TILE):
            rows = range(q0, q0 + TILE)
            tiles = [bool(_pairs(tq, tk, vl, causal, rows, range(k0, k0 + TILE)))
                     for k0 in range(0, tk, TILE)]
            nk = sum(tiles)
            assert tiles == sorted(tiles, reverse=True)   # a prefix of the key tiles
            cols = [{min(max(i - j, -half), half - 1) + half
                     for i in rows for j in range(k0, k0 + TILE)}
                    for k0 in range(0, nk * TILE, TILE)]
            dq.append((nk, 0 if mask_only else sum(len(c) > 1 for c in cols)))
        for k0 in range(0, tk, TILE):
            keys = range(k0, k0 + TILE)
            tiles = [bool(_pairs(tq, tk, vl, causal, range(q0, min(q0 + TILE, tq)), keys))
                     for q0 in range(0, tq, TILE)]
            first = tiles.index(True) if any(tiles) else len(tiles)
            assert all(tiles[first:])   # a suffix from the first tile that meets a key
            bands = []
            for q0 in range(first * TILE, tq, TILE):
                rows = {min(max(i - j, -half), half - 1) + half
                        for i in range(q0, q0 + TILE) for j in keys}
                bands.append((min(rows), max(rows) - min(rows) + 1))
            n = len(tiles) - first
            dkv.append((first if n else None, n, [] if mask_only else bands))
    return dq, dkv


PLAN_CASES = [  # (Tq, Tk, valid lengths, 2L)
    (500, 500, [500, 500, 430, 310], 320), (160, 500, [500, 310, 0, 77], 320),
    (61, 61, [61, 30, 1, 0], 20), (90, 90, [90, 64, 63, 65], 8), (1, 1, [1, 0], 2),
    (130, 70, [70, 69, 1, 40], 400), (200, 300, [300, 300], 64),
]


@pytest.mark.parametrize("tq,tk,vls,two_l", PLAN_CASES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask_only", [False, True])
def test_plan_tiles_match_enumeration(tq, tk, vls, two_l, causal, mask_only):
    """The key tiles the wgmma B3 skips past valid_len and the diagonal,
    the query tiles B4 skips, the band windows B3 loads and the pe rows of
    B4's band: from the formulas as from the pairs themselves (a
    valid_len of 0, or a key block at or past it, takes no tile)."""
    plan = wgmma_backward_plan(len(vls), 3, tq, tk, 64, two_l, causal, mask_only, vls,
                                   [0] * 21)
    dq, dkv = _enumerated(vls, tq, tk, two_l, causal, mask_only)
    assert plan["dq"]["grid"] == (3 * len(vls), -(-tq // TILE))
    assert plan["dkv"]["grid"] == (3 * len(vls), -(-tk // TILE))
    assert [(x["key_tiles"], x["windows"]) for x in plan["dq_blocks"]] == dq
    assert [(x["qt0"] if x["query_tiles"] else None, x["query_tiles"], x["bands"])
            for x in plan["dkv_blocks"]] == dkv
    for x in plan["dkv_blocks"]:
        for first, rows in x["bands"]:
            assert rows <= BAND_ROWS and first + rows <= two_l
    assert plan["key_tiles"] == 3 * sum(t[0] for t in dq)
    assert plan["band_rows"] == 3 * sum(r for t in dkv for _, r in t[2])
    if any(v == 0 for v in vls):
        assert any(x["key_tiles"] == 0 and x["windows"] == 0 for x in plan["dq_blocks"])


def _views(kind, d=64):
    """(q, k, v, g) [B, H, T, D] views of each layout the form reads, small."""
    b, t, h = 2, 33, 3
    if kind == "bhtd":
        return tuple(torch.zeros(b, h, t, d, dtype=BF16) for _ in range(4))
    if kind == "split_heads":   # [B, T, H * D] projections viewed as heads
        return tuple(torch.zeros(b, t, h * d, dtype=BF16).reshape(b, t, h, d).transpose(1, 2)
                     for _ in range(4))
    if kind == "ulysses":       # [B, H/sp, T, D] head blocks of [B, T, 12, D]
        x = torch.zeros(b, t, 12, d, dtype=BF16)
        return tuple(x[:, :, 3 * i:3 * i + 3].transpose(1, 2) for i in range(4))
    if kind == "tp_local":      # a rank's 2 heads of a [B, T, 2 * 3 * D] qkv block
        x = torch.zeros(b, t, 3 * 2 * d, dtype=BF16)
        q, k, v = (y.reshape(b, t, 2, d).transpose(1, 2) for y in x.split(2 * d, dim=-1))
        return q, k, v, torch.zeros(b, t, 2, d, dtype=BF16).transpose(1, 2)
    if kind == "cross":         # 16 queries over 40 keys
        q, g = (torch.zeros(b, h, 16, d, dtype=BF16) for _ in range(2))
        k, v = (torch.zeros(b, t + 7, h * d, dtype=BF16).reshape(b, t + 7, h, d).transpose(1, 2)
                for _ in range(2))
        return q, k, v, g
    if kind == "size_one":      # B = H = 1, Tq = 1
        q, g = (torch.zeros(1, 1, 1, d, dtype=BF16) for _ in range(2))
        k, v = (torch.zeros(1, 1, 5, d, dtype=BF16) for _ in range(2))
        return q, k, v, g
    raise ValueError(kind)


VIEWS = ["bhtd", "split_heads", "ulysses", "tp_local", "cross", "size_one"]


def _strides(q, k, v, g):
    strides = tfc.operand_strides((("q", q), ("k", k), ("v", v), ("g", g)), 2, "t")
    for x in (q, k, k):   # dq, dk, dv: the wrapper's [B, T, H, D] buffers
        buf = tfa._heads_view_buffer(x.shape[0], x.shape[1], x.shape[2], x.shape[3], "cpu")
        strides += buf.stride()[:3]
    return strides


@pytest.mark.parametrize("kind", VIEWS)
@pytest.mark.parametrize("d", [64, 128])
def test_plan_maps_address_every_element(kind, d):
    q, k, v, g = _views(kind, d)
    b, h, tq, _ = q.shape
    tk = k.shape[2]
    plan = wgmma_backward_plan(b, h, tq, tk, d, 40, False, False, [tk] * b,
                                   _strides(q, k, v, g))
    for name, x in (("q", q), ("k", k), ("v", v), ("g", g)):
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
@pytest.mark.parametrize("L", [160, 512, 2048])
def test_plan_shared_memory_fits_a_block(d, mask_only, L):
    """B3's tiles, ring and f32 windows, B4's tiles, rings and bands,
    within the 227 KB a block may opt in to on an H100 and the same at
    every L (B3 held a table of the whole 2L rows until the windows came);
    with the threads and stages each kernel takes."""
    plan = wgmma_backward_plan(1, 1, 500, 500, d, 2 * L, False, mask_only, [500], [0] * 21)
    at_160 = wgmma_backward_plan(1, 1, 500, 500, d, 320, False, mask_only, [500], [0] * 21)
    for kernel in ("dq", "dkv"):
        assert plan[kernel]["smem_bytes"] == at_160[kernel]["smem_bytes"]
    tile = d * TILE * 2
    dq, dkv = plan["dq"], plan["dkv"]
    assert (dq["threads"], dq["stages"]) == (384, 4 if d == 64 else 2)
    assert dq["stages"] % 2 == 0   # each stage serves one of the two warpgroups
    assert (dkv["threads"], dkv["stages"]) == ((384, 4) if d == 64 else (256, 2))
    windows = 0 if mask_only else dq["stages"] * 2 * tile + 2 * 64 * WINDOW_STRIDE[d] * 4
    assert dq["smem_bytes"] >= 2 * tile + 2 * dq["stages"] * tile + windows
    rings = 2 * dkv["stages"] * tile + (0 if mask_only else dkv["stages"] * 2 * tile)
    bands = 0 if mask_only else (dkv["threads"] // 128 - 1) * 64 * 132 * 4
    assert dkv["smem_bytes"] >= 2 * tile + rings + bands
    assert dq["smem_bytes"] <= SMEM_LIMIT and dkv["smem_bytes"] <= SMEM_LIMIT


def test_plan_strides_of_size_one_axes_are_packed():
    plan = wgmma_backward_plan(1, 1, 1, 1, 128, 2, False, True, [1], [0] * 21)
    for name in "qkvg":
        assert plan["maps"][name]["strides"] == (256, 256, 256)


# The largest L of the band variant by head dim while B3's wgmma form kept
# an f32 table [2L][68] beside its tiles and rings; its windows lift it.
TABLE_L_LIMIT = {64: 272, 128: 242}


@pytest.mark.parametrize("d", [64, 128])
def test_launch_raises_past_the_table_limit(recorder, monkeypatch, d):
    """The wgmma form's launch past the former table's limit, at L = 512
    and at 2048, reaches the C entry and asks no shared memory of the
    library (its windows take the same bytes at every L); the mma.sync form
    (float32 at the same head dim, its table growing with L) still raises
    before the launch past its own limit, naming the table's rows, and
    calls nothing."""
    def smem(fn, two_l, mask_only, kernel, kd, bf16):
        assert fn == "loco_flash_rel_bwd_smem_bytes" and bf16 == 0
        return 1024 + two_l * (TILE + 4) * 4   # a table of two_l rows

    monkeypatch.setattr(tfa, "_smem_bytes", smem)
    lse = torch.zeros(1, 2, 64)

    def launch(L, dtype):
        q, k, v, g = (torch.zeros(1, 2, 64, d, dtype=dtype) for _ in range(4))
        pe = torch.zeros(2 * L, d, dtype=dtype)
        return tfa._launch_backward(q, k, v, pe, torch.tensor([64]), lse, lse, g, False, 0.125,
                                    mask_only=False)

    for L in (TABLE_L_LIMIT[d] + 1, 512, 2048):
        launch(L, BF16)
    assert [name for name, _ in recorder.calls] == ["loco_flash_rel_bwd"] * 3
    assert [a[-7] for _, a in recorder.calls] == [2 * (TABLE_L_LIMIT[d] + 1), 1024, 4096]
    assert tfa.flash_rel_backward.launches_by_form == {"mma_sync": 0, "wgmma": 3}
    with pytest.raises(ValueError, match=r"flash_rel_backward: a rel-pos table of 1024 "
                                         r"rows needs \d+ B of shared memory, more than the "
                                         rf"{SMEM_LIMIT} B a block may use"):
        launch(512, torch.float32)
    assert len(recorder.calls) == 3


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
    """The wrapper's gradients (B1's forward, then B3 + B4 of the wgmma
    form, one launch counted) against the plain backward with the band's
    matmuls on the same inputs: each error over its limit, 2^-7 max|plain|."""
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(q.shape[2])).to(
        q.device, BF16)
    table = torch.zeros(2, q.shape[-1], dtype=BF16, device=q.device) if mask_only else pe
    out, lse = tfa.flash_rel_forward(q, k, v, None if mask_only else pe, vl, causal=causal,
                                     scale=scale)
    before = dict(tfa.flash_rel_backward.launches_by_form)
    got = tfa.flash_rel_backward(q, k, v, table, vl, out, lse, g, causal=causal, scale=scale,
                                 mask_only=mask_only)
    torch.cuda.synchronize()
    assert tfa.flash_rel_backward.launches_by_form == {**before, "wgmma": before["wgmma"] + 1}
    dq, dk, dv, dqpe = tfa.flash_rel_backward_plain(q, k, v, table, vl, out, lse, g,
                                                    causal=causal, scale=scale)
    want = [dq, dk, dv]
    if not mask_only:
        want[0] = dq + (dqpe @ pe.float()) * scale
        want.append(torch.einsum("bhim,bhid->md", dqpe, q.float()) * scale)
    assert (got[3] is None) == mask_only
    ratios = []
    for a, w in zip(got, want):
        assert a.dtype is BF16 and a.shape == w.shape
        assert torch.isfinite(a.float()).all()
        err = (a.float() - w.to(BF16).float()).abs().max().item()
        ratios.append(err / max(BF16_REL * w.abs().max().item(), 1e-30))
    return got, ratios


CUDA_CASES = [  # (B, H, Tq, Tk, valid lengths, L)
    (2, 3, 500, 500, [500, 310], 160), (2, 3, 160, 500, [500, 431], 160),
    (3, 2, 61, 61, [61, 0, 30], 20), (2, 2, 90, 90, [90, 1], 8), (2, 2, 130, 70, [70, 69], 150),
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
        _, ratios = _held(q, k, v, pe, vl, causal, mask_only)
        if max(ratios) > 1:
            bad[(tq, tk, tuple(vls), L)] = ratios
    assert not bad, f"(Tq, Tk, valid lengths, L): errors over their limits {bad}"


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("mask_only", [False, True])
def test_cuda_wgmma_at_full_width_is_right_and_repeatable(d, mask_only, cuda):
    """The encoder's training shape ([8, 12, 500, 64], L = 160; [8, 6, 500,
    128] at D = 128): a grid of several waves, where warpgroups that run
    ahead of each other on a stage's barrier would read stale tiles.  Three
    launches give the same bits and hold to the plain version."""
    rng = np.random.default_rng(50 + d + mask_only)
    h = 12 if d == 64 else 6
    q, k, v = (_bf16(rng, (8, h, 500, d), cuda, sc=0.3) for _ in range(3))
    pe = _bf16(rng, (320, d), cuda, sc=0.3)
    vl = torch.tensor([500] * 6 + [430, 310], dtype=torch.int32, device=cuda)
    runs = [_held(q, k, v, pe, vl, False, mask_only) for _ in range(3)]
    for got, ratios in runs:
        assert max(ratios) <= 1, ratios
        for a, b in zip(got, runs[0][0]):
            assert a is None or torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("mask_only", [False, True])
def test_cuda_wgmma_fully_masked_rows_get_zero_gradients(d, mask_only, cuda):
    """A batch row of valid length 0: its dq, dk, dv (and band gradient)
    are exactly 0, not NaN, as in the plain version."""
    rng = np.random.default_rng(40 + d)
    q, k, v = (_bf16(rng, (3, 2, 100, d), cuda) for _ in range(3))
    pe = _bf16(rng, (40, d), cuda)
    vl = torch.tensor([100, 0, 37], dtype=torch.int32, device=cuda)
    (dq, dk, dv, _), ratios = _held(q, k, v, pe, vl, False, mask_only)
    assert max(ratios) <= 1, ratios
    for x in (dq, dk, dv):
        assert bool((x[1] == 0).all())
    assert bool((dk[2, :, 37:] == 0).all()) and bool((dv[2, :, 37:] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_wgmma_table_limit(d, cuda):
    """The band variant at the former table's largest L, one row pair past
    it and at L = 512 and 2048 (T = 700 reaches past 512) holds to the plain
    version: no L raises any more."""
    rng = np.random.default_rng(70 + d)
    L = TABLE_L_LIMIT[d]
    q, k, v = (_bf16(rng, (1, 2, 700, d), cuda) for _ in range(3))
    vl = torch.tensor([650], dtype=torch.int32, device=cuda)
    for two_l in (2 * L, 2 * L + 2, 1024, 4096):
        _, ratios = _held(q, k, v, _bf16(rng, (two_l, d), cuda), vl, False, False)
        assert max(ratios) <= 1, (two_l, ratios)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["split_heads", "ulysses", "tp_local", "cross"])
def test_cuda_wgmma_reads_strided_views(kind, cuda):
    """q, k, v and the cotangent read in place through their strides."""
    rng = np.random.default_rng(len(kind))
    q, k, v, _ = (x.to(cuda) for x in _views(kind))
    q, k, v = (x.copy_(_bf16(rng, x.shape, cuda)) for x in (q, k, v))
    vl = torch.tensor([k.shape[2], k.shape[2] - 9], dtype=torch.int32, device=cuda)
    for mask_only in (False, True):
        _, ratios = _held(q, k, v, _bf16(rng, (40, 64), cuda), vl, False, mask_only)
        assert max(ratios) <= 1, (mask_only, ratios)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", VIEWS)
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_plan_equals_the_c_plan(kind, d, cuda):
    """The mirror against the plan the launch encodes
    (``loco_flash_rel_bwd_wgmma_plan``), on the same strides."""
    import ctypes

    q, k, v, g = _views(kind, d)
    b, h, tq, _ = q.shape
    tk = k.shape[2]
    strides = _strides(q, k, v, g)
    for causal, mask_only, two_l in itertools.product((False, True), (False, True), (8, 320)):
        vls = [tk, max(0, tk - 40)][:b]
        got = (ctypes.c_longlong * 47)()
        _build.library().loco_flash_rel_bwd_wgmma_plan(
            tfc.stride_buffer(tuple(strides)), b, h, tq, tk, d, two_l, int(causal),
            int(mask_only), (ctypes.c_int * b)(*vls), ctypes.addressof(got))
        plan = wgmma_backward_plan(b, h, tq, tk, d, two_l, causal, mask_only, vls, strides)
        want = [plan["dq"]["grid"][0] * plan["dq"]["grid"][1], plan["key_tiles"],
                plan["windows"], plan["dkv"]["grid"][0] * plan["dkv"]["grid"][1],
                plan["query_tiles"], plan["band_rows"]]
        for name in ("q", "k", "v", "g", "pe"):
            want += [*plan["maps"][name]["dims"], *plan["maps"][name]["strides"]]
        want += [plan["dq"]["smem_bytes"], plan["dkv"]["smem_bytes"], plan["dq"]["threads"],
                 plan["dkv"]["threads"], plan["dq"]["stages"], plan["dkv"]["stages"]]
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
    lse = torch.zeros(1, 2, 16, device=cuda)
    dq, dk, dv = (torch.full((1, 2, 16, d), 7.0, device=cuda) for _ in range(3))
    dqpe = torch.full((1, 2, 16, 8), 7.0, device=cuda)
    strides = tfc.operand_strides((("q", q), ("k", q), ("v", q), ("g", q)), 2, "t")
    for x in (dq, dk, dv):
        strides += list(x.stride()[:3])
    code = _build.call_on_stream(
        _build.library().loco_flash_rel_bwd, cuda, q.data_ptr(), q.data_ptr(), q.data_ptr(),
        pe.data_ptr(), vl.data_ptr(), lse.data_ptr(), lse.data_ptr(), q.data_ptr(),
        dq.data_ptr(), dqpe.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        tfc.stride_buffer(tuple(strides)), 1, 2, 16, 16, d, 8, 0, 0, 0.25, form,
        int(dtype is BF16))
    torch.cuda.synchronize()
    assert code == 801   # cudaErrorNotSupported
    with pytest.raises(RuntimeError, match="not supported"):
        _build.check(code, "flash_rel_backward")
    assert all(bool((x == 7.0).all()) for x in (dq, dk, dv, dqpe))
