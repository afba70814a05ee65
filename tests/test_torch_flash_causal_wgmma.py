"""The wgmma form of kernels B5 and B6 (loco_asr_tpu_torch.ops.cuda.flash_causal).

On the CPU: :func:`kernel_form` over operand type and head dim; the form
that the launch path hands the C entry (a recording library in place of the
built one, and tensors on the ``meta`` device to drive the public wrappers
through their launch path), and the per-form launch counts; the mirror of
the wgmma form's host-side plan (:func:`wgmma_plan`, kept here) against a plain
enumeration: grid, key tiles per query tile, the tiles causal skips, and
each tensor map's dims and byte strides against the element addresses of
[B, H, T, D], [B, T, H, D], transposed, qkv-column and tensor-parallel
views.  On a CUDA device (marker ``cuda``): the wgmma form against the
plain versions within ``2^-7 max|plain|`` (lse within 1e-3) -- causal and
not, head dims 64 and 128, Tq = Tk in {1, 63, 129, 1024}, Tq < Tk, Tq > Tk
causal, Tk = 77 non-causal, qkv column views, the tensor-parallel local
[q | k | v] buffer, rows that see one key -- the C plan against the mirror,
and the blockwise backward on the form's lse.

On a GPU machine without JAX, run the kernel tests alone:
``python -m pytest --noconftest tests/test_torch_flash_causal_wgmma.py -m cuda``."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from loco_asr_tpu_torch.ops.cuda import _build
from loco_asr_tpu_torch.ops.cuda import flash_causal as tfc

BF16 = torch.bfloat16
BF16_REL = 2.0 ** -7   # out: max |d| <= 2^-7 max |plain| (chip_smoke.py phase 16)
LSE_TOL = 1e-3


# ---- the form of a launch ---------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("kd", tfc.HEAD_DIMS)
def test_kernel_form_by_type_and_head_dim(dtype, kd):
    want = "wgmma" if dtype is BF16 and kd in (64, 128) else "mma_sync"
    assert tfc.kernel_form(dtype, kd) == want
    assert tfc.FORMS.index(want) == int(want == "wgmma")


def test_padded_head_dims_take_the_form_of_their_instantiation():
    """A head dim without an instantiation runs the next one up: bf16 at
    33-128 reaches the wgmma form, below 33 the mma.sync form."""
    forms = {d: tfc.kernel_form(BF16, tfc.kernel_head_dim(d, "t")) for d in range(1, 129)}
    assert {d for d, f in forms.items() if f == "wgmma"} == set(range(33, 129))
    assert all(tfc.kernel_form(torch.float32, tfc.kernel_head_dim(d, "t")) == "mma_sync"
               for d in range(1, 129))


class _Recorder:
    """Stands in for the built library: each entry point records its
    arguments and reports success."""

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
    for name in ("flash_forward_plain", "flash_forward_nhd_plain"):
        monkeypatch.setattr(tfc, name, lambda *a, **k: pytest.fail("plain version ran"))
    for fn in (tfc.flash_forward, tfc.flash_forward_nhd):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "launches_by_form", dict.fromkeys(tfc.FORMS, 0))
    return rec


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("d,t_axis", [(8, 2), (32, 1), (64, 2), (64, 1), (80, 2), (128, 1)])
def test_launch_passes_the_form_before_the_operand_type(recorder, dtype, d, t_axis):
    shape = (2, 3, 40, d) if t_axis == 2 else (2, 40, 3, d)
    q, k, v = (torch.zeros(shape, dtype=dtype) for _ in range(3))
    out, lse = tfc._launch(q, k, v, (2, 3, 40, 40, d), t_axis=t_axis, causal=True,
                           scale=0.125, what="flash_forward")
    assert out.shape == shape and out.dtype is dtype and lse.shape == (2, 3, 40)
    (name, args), = recorder.calls
    assert name == "loco_flash_causal_fwd"
    kd = tfc.kernel_head_dim(d, "t")
    form = tfc.FORMS.index(tfc.kernel_form(dtype, kd))
    # (..., D, causal, scale, form, operand type, stream)
    assert args[-6:-1] == (kd, 1, 0.125, form, int(dtype is BF16))
    assert form == int(dtype is BF16 and d >= 64)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_wrappers_count_launches_by_form(recorder, dtype):
    """The public wrappers, driven through the launch path on ``meta``
    tensors: gpt2's B6 on [B, T, 12, 64], gpt2-xl's 25 heads on B5 views,
    the SpeechT5 decoder's [B, H, T, 64], and head dims 8 and 128."""
    meta = dict(device="meta", dtype=dtype)
    x = torch.empty(2, 40, 3 * 12 * 64, **meta)
    q, k, v = (y.reshape(2, 40, 12, 64) for y in x.split(12 * 64, dim=-1))
    tfc.flash_attention_nhd(q, k, v)                     # B6
    q25 = torch.empty(2, 40, 25, 64, **meta)
    tfc.flash_attention_nhd(q25, q25, q25)               # B5 on transposed views
    tfc.flash_forward(*(torch.empty(2, 12, 40, 64, **meta) for _ in range(3)), causal=True,
                      scale=0.125)
    tfc.flash_forward(*(torch.empty(2, 4, 40, 8, **meta) for _ in range(3)), causal=False,
                      scale=0.3)
    tfc.flash_forward_nhd(*(torch.empty(2, 40, 2, 128, **meta) for _ in range(3)),
                          causal=True, scale=0.1)
    bf16 = dtype is BF16
    assert tfc.flash_forward.launches == 3
    assert tfc.flash_forward.launches_by_form == {
        "mma_sync": 1 if bf16 else 3, "wgmma": 2 if bf16 else 0}
    assert tfc.flash_forward_nhd.launches == 2
    assert tfc.flash_forward_nhd.launches_by_form == {
        "mma_sync": 0 if bf16 else 2, "wgmma": 2 if bf16 else 0}
    assert [a[-3] for _, a in recorder.calls] == ([1, 1, 1, 0, 1] if bf16 else [0] * 5)


# ---- the wgmma form's launch plan ---------------------------------------------


# The mirror of the wgmma form's host-side plan (csrc/flash_causal.cu,
# namespace wg, ``wg_plan``), kept here: only these tests read it.
WGMMA_BLOCK_Q = 128                # query rows a block: two warpgroups of 64
WGMMA_BOX = 64                     # head-dim columns a TMA box (128 bytes)
WGMMA_THREADS = 384                # two consumer warpgroups and a producer one
WGMMA_STAGES = 4                   # of the K and V rings


def wgmma_key_block(kd: int) -> int:
    """Key rows a tile of the wgmma form at head dim ``kd``
    (``wg::key_block``): 128 at 64, 64 at 128."""
    return 128 if kd == 64 else 64


def wgmma_key_tiles(q0: int, tq: int, tk: int, causal: bool, bk: int) -> int:
    """Key tiles of ``bk`` rows the wgmma form reads for the query tile at
    row ``q0``: every one below ``tk`` and, under ``causal``, none wholly
    above the tile's last row below ``tq`` (``wg::key_tiles`` in
    csrc/flash_causal.cu)."""
    n = -(-tk // bk)
    return min(n, (min(q0 + WGMMA_BLOCK_Q, tq) - 1) // bk + 1) if causal else n


def wgmma_plan(b: int, h: int, tq: int, tk: int, kd: int, causal: bool,
               strides) -> dict:
    """The wgmma form's launch as the C code plans it (``wg_plan``), from
    the dims and the element strides the wrapper passes (batch, head, time
    of q, k, v, then out's, through which the kernel stores): the blocks
    (one per (b*h, query tile), the longest tiles first), the key rows of a
    tile, the key tiles of each query tile in launch order, the tiles
    causal skips of one (b, h), and the tensor maps of q, k and v: dims
    (D, T, H, B) innermost first, byte strides of T, H and B (an axis of
    size 1 takes the packed stride: it is never stepped), the box; and a
    block's threads, K/V stages and dynamic shared memory (Q, the rings,
    the barriers, 1024 bytes to align the tiles)."""
    bk = wgmma_key_block(kd)
    nq = -(-tq // WGMMA_BLOCK_Q)
    tiles = [wgmma_key_tiles(q0, tq, tk, causal, bk)
             for q0 in range((nq - 1) * WGMMA_BLOCK_Q, -1, -WGMMA_BLOCK_Q)]
    maps = {}
    for i, (name, t) in enumerate((("q", tq), ("k", tk), ("v", tk))):
        sb, sh, st = (2 * x for x in strides[3 * i:3 * i + 3])
        s_t = 2 * kd if t == 1 else st
        s_h = s_t * t if h == 1 else sh
        s_b = s_h * h if b == 1 else sb
        rows = bk if name in ("k", "v") else WGMMA_BLOCK_Q // 2
        maps[name] = dict(dims=(kd, t, h, b), strides=(s_t, s_h, s_b),
                          box=(WGMMA_BOX, rows, 1, 1))
    smem = (WGMMA_BLOCK_Q * kd * 2 + 2 * WGMMA_STAGES * bk * kd * 2
            + 8 * (1 + 4 * WGMMA_STAGES) + 1024)
    return dict(blocks=b * h * nq, key_block=bk, tiles=tiles,
                skipped=nq * -(-tk // bk) - sum(tiles), maps=maps,
                threads=WGMMA_THREADS, stages=WGMMA_STAGES, smem_bytes=smem)


def _enumerated_tiles(tq, tk, causal, bk):
    """Key tiles of ``bk`` rows each query tile needs, longest first, from
    its (row, key) pairs: a tile is read when one of its keys below Tk
    meets one of the query tile's rows below Tq unmasked."""
    bq = WGMMA_BLOCK_Q
    out = []
    for q0 in reversed(range(0, tq, bq)):
        rows = range(q0, min(q0 + bq, tq))
        need = [any(not causal or k0 <= i for i in rows) for k0 in range(0, tk, bk)]
        # the tiles read are a prefix: none past the first unneeded one
        assert need == sorted(need, reverse=True)
        out.append(sum(need))
    return out


@pytest.mark.parametrize("tq,tk", [(1, 1), (63, 63), (129, 129), (1024, 1024), (100, 300),
                                   (300, 100), (77, 77), (200, 77), (128, 128), (257, 1000)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kd,bk", [(64, 128), (128, 64)])
def test_plan_blocks_and_tiles_match_enumeration(tq, tk, causal, kd, bk):
    plan = wgmma_plan(3, 5, tq, tk, kd, causal, [0] * 12)
    tiles = _enumerated_tiles(tq, tk, causal, bk)
    n_q, n_k = -(-tq // 128), -(-tk // bk)
    assert plan["key_block"] == bk
    assert plan["blocks"] == 15 * n_q
    assert plan["tiles"] == tiles
    assert plan["skipped"] == n_q * n_k - sum(tiles)
    if not causal:
        assert plan["skipped"] == 0
    elif tq == tk:   # the tiles on or below the diagonal
        assert sum(tiles) == sum(min(n_k, (min(q0 + 128, tq) - 1) // bk + 1)
                                 for q0 in range(0, tq, 128))


@pytest.mark.parametrize("kd", [64, 128])
def test_plan_shared_memory_fits_a_block(kd):
    """Q, four stages of K and V tiles and the barriers, aligned to 1024
    bytes, within the 227 KB a block may opt in to on an H100."""
    plan = wgmma_plan(1, 1, 1024, 1024, kd, True, [0] * 12)
    assert plan["threads"] == 384 and plan["stages"] == 4
    tile = plan["key_block"] * kd * 2
    assert plan["smem_bytes"] == 128 * kd * 2 + 2 * 4 * tile + 8 * 17 + 1024
    assert plan["smem_bytes"] <= 232448


def _views(kind):
    """(q, k, v, t_axis, heads) of each layout the form reads, small."""
    b, t, h, d = 2, 33, 3, 64
    if kind == "bhtd":
        q, k, v = (torch.zeros(b, h, t, d, dtype=BF16) for _ in range(3))
        return q, k, v, 2
    if kind == "bthd":
        q, k, v = (torch.zeros(b, t, h, d, dtype=BF16) for _ in range(3))
        return q, k, v, 1
    if kind in ("qkv_columns", "qkv_columns_bhtd"):        # gpt2's B6; gpt2-xl's B5 views
        x = torch.zeros(b, t, 3 * h * d, dtype=BF16)
        q, k, v = (y.reshape(b, t, h, d) for y in x.split(h * d, dim=-1))
        if kind == "qkv_columns":
            return q, k, v, 1
        return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), 2
    if kind == "tp_local":   # a rank's c_attn block: its 2 heads' [q | k | v]
        x = torch.zeros(b, t, 3 * 2 * 128, dtype=BF16)
        q, k, v = (y.reshape(b, t, 2, 128) for y in x.split(2 * 128, dim=-1))
        return q, k, v, 1
    if kind == "ulysses":    # [B, H/sp, T, D] head blocks of [B, T, H, D]
        x = torch.zeros(b, t, 12, d, dtype=BF16)
        q = k = v = x[:, :, 3:6].transpose(1, 2)
        return q, k, v, 2
    if kind == "size_one":   # B = H = 1, Tq = 1
        q = torch.zeros(1, 1, 1, d, dtype=BF16)
        k = v = torch.zeros(1, 1, 5, d, dtype=BF16)
        return q, k, v, 2
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["bhtd", "bthd", "qkv_columns", "qkv_columns_bhtd",
                                  "tp_local", "ulysses", "size_one"])
def test_plan_maps_address_every_element(kind):
    q, k, v, t_axis = _views(kind)
    h_axis = 3 - t_axis
    b, h, tq, tk, kd = q.shape[0], q.shape[h_axis], q.shape[t_axis], k.shape[t_axis], q.shape[3]
    strides = tfc.operand_strides((("q", q), ("k", k), ("v", v)), t_axis, "t")
    out = torch.empty_like(q)
    so = out.stride()
    plan = wgmma_plan(b, h, tq, tk, kd, True, strides + [so[0], so[h_axis], so[t_axis]])
    assert set(plan["maps"]) == {"q", "k", "v"}   # out is stored through its strides
    for name, x in (("q", q), ("k", k), ("v", v)):
        m = plan["maps"][name]
        t = x.shape[t_axis]
        assert m["dims"] == (kd, t, h, b)
        assert m["box"] == (64, plan["key_block"] if name in ("k", "v") else 64, 1, 1)
        s_t, s_h, s_b = m["strides"]
        assert all(s % 16 == 0 and s > 0 for s in m["strides"])
        for bi, hi, ti in itertools.product(range(b), range(h), range(t)):
            idx = (bi, hi, ti) if t_axis == 2 else (bi, ti, hi)
            offset = x[idx].data_ptr() - x.data_ptr()
            assert offset == ti * s_t + hi * s_h + bi * s_b, (name, bi, hi, ti)
        # rows are contiguous: a box row is 64 neighbouring elements
        assert x.stride(3) == 1


def test_plan_strides_of_size_one_axes_are_packed():
    """An axis of size 1 is never stepped: the plan takes the packed stride
    whatever the tensor says (the slow path of operand_strides hands 0)."""
    plan = wgmma_plan(1, 1, 1, 1, 128, False, [0] * 12)
    for m in plan["maps"].values():
        assert m["strides"] == (256, 256, 256)


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


def _held(q, k, v, causal, t_axis=2, scale=None):
    """The kernel against its plain version on the same inputs, after
    checking that one launch of the wgmma form was counted: (out error
    over its limit, lse error)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    fn, plain = ((tfc.flash_forward, tfc.flash_forward_plain) if t_axis == 2
                 else (tfc.flash_forward_nhd, tfc.flash_forward_nhd_plain))
    before = dict(fn.launches_by_form)
    out, lse = fn(q, k, v, causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert fn.launches_by_form == {**before, "wgmma": before["wgmma"] + 1}
    pout, plse = plain(q, k, v, causal=causal, scale=scale)
    assert out.dtype is BF16 and out.shape == pout.shape and lse.shape == plse.shape
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    err = (out.float() - pout.float()).abs().max().item()
    lim = BF16_REL * pout.float().abs().max().item()
    return err / lim, (lse - plse).abs().max().item()


CASES = ([(t, t) for t in (1, 63, 129, 1024)] + [(100, 300), (65, 1000)])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_wgmma_matches_plain(d, causal, cuda):
    """Tq = Tk, Tq < Tk, and Tq > Tk (causal: rows past Tk see every key)
    or Tk = 77 with no 8-aligned tile end (non-causal)."""
    cases = CASES + ([(300, 100), (1000, 65)] if causal else [(77, 77), (200, 77)])
    rng = np.random.default_rng(d + causal)
    errs = {}
    for tq, tk in cases:
        q = _bf16(rng, (2, 3, tq, d), cuda)
        k, v = _bf16(rng, (2, 3, tk, d), cuda), _bf16(rng, (2, 3, tk, d), cuda)
        errs[(tq, tk)] = _held(q, k, v, causal)
    bad = {c: e for c, e in errs.items() if e[0] > 1 or e[1] > LSE_TOL}
    assert not bad, f"(Tq, Tk): (out error / limit, lse error) {bad}"


@pytest.mark.cuda
@pytest.mark.parametrize("t", [129, 1024])
def test_cuda_wgmma_reads_qkv_column_views(t, cuda):
    """B6 on [B, T, H, 64] column slices of one qkv projection (gpt2), and
    B5 on their [B, H, T, 64] transposes (the gpt2-xl route), in place."""
    rng = np.random.default_rng(t)
    x = _bf16(rng, (2, t, 3 * 4 * 64), cuda)
    q, k, v = (y.reshape(2, t, 4, 64) for y in x.split(4 * 64, dim=-1))
    for got in (_held(q, k, v, True, t_axis=1),
                _held(*(y.transpose(1, 2) for y in (q, k, v)), True)):
        assert got[0] <= 1 and got[1] <= LSE_TOL, got


@pytest.mark.cuda
def test_cuda_wgmma_reads_the_tensor_parallel_local_buffer(cuda):
    """A tensor-parallel rank's c_attn output: its heads' [q | k | v]
    columns ([B, T, 3 * 6 * 64], gpt2's 12 heads over two ranks), and the
    same at head dim 128 with two heads."""
    rng = np.random.default_rng(17)
    for heads, d in ((6, 64), (2, 128)):
        x = _bf16(rng, (2, 257, 3 * heads * d), cuda)
        q, k, v = (y.reshape(2, 257, heads, d) for y in x.split(heads * d, dim=-1))
        got = _held(q, k, v, True, t_axis=1)
        assert got[0] <= 1 and got[1] <= LSE_TOL, (heads, d, got)


@pytest.mark.cuda
def test_cuda_wgmma_reads_ulysses_head_blocks(cuda):
    """B5 on [B, 3, T, 64] head blocks of a [B, T, 12, 64] tensor, as a
    Ulysses rank holds its heads."""
    x = _bf16(np.random.default_rng(18), (2, 1024, 12, 64), cuda)
    q, k, v = (x[:, :, 3 * i:3 * i + 3].transpose(1, 2) for i in range(3))
    got = _held(q, k, v, True)
    assert got[0] <= 1 and got[1] <= LSE_TOL, got


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_wgmma_rows_that_see_one_key(d, cuda):
    """With Tk = 1 every row weighs key 0 alone against the rest of its
    tile (-1e30 above the diagonal, -inf past Tk): out is v[0] and lse is
    q . k0 * scale."""
    rng = np.random.default_rng(d)
    q, k, v = _bf16(rng, (2, 3, 130, d), cuda), _bf16(rng, (2, 3, 1, d), cuda), \
        _bf16(rng, (2, 3, 1, d), cuda)
    for causal in (True, False):
        got = _held(q, k, v, causal, scale=0.5)
        assert got[0] <= 1 and got[1] <= LSE_TOL, got
        out, lse = tfc.flash_forward(q, k, v, causal=causal, scale=0.5)
        assert torch.equal(out, v.expand_as(out))
        want = (q.float() @ k.float().transpose(-1, -2))[..., 0] * 0.5
        torch.testing.assert_close(lse, want, atol=LSE_TOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bhtd", "bthd", "qkv_columns", "tp_local", "ulysses",
                                  "size_one"])
def test_cuda_plan_equals_the_c_plan(kind, cuda):
    """The mirror against the plan the launch encodes
    (``loco_flash_causal_wgmma_plan``), on the same strides."""
    import ctypes

    q, k, v, t_axis = _views(kind)
    h_axis = 3 - t_axis
    b, h, tq, tk, kd = q.shape[0], q.shape[h_axis], q.shape[t_axis], k.shape[t_axis], q.shape[3]
    strides = tfc.operand_strides((("q", q), ("k", k), ("v", v)), t_axis, "t")
    so = torch.empty_like(q).stride()
    strides += [so[0], so[h_axis], so[t_axis]]
    for causal in (True, False):
        got = (ctypes.c_longlong * 30)()
        _build.library().loco_flash_causal_wgmma_plan(tfc.stride_buffer(tuple(strides)), b, h,
                                                     tq, tk, kd, int(causal),
                                                     ctypes.addressof(got))
        plan = wgmma_plan(b, h, tq, tk, kd, causal, strides)
        want = [plan["blocks"], sum(plan["tiles"]), plan["key_block"]]
        for name in ("q", "k", "v"):
            m = plan["maps"][name]
            want += [*m["dims"], *m["strides"], m["box"][1]]
        want += [plan["smem_bytes"], plan["threads"], plan["stages"]]
        assert list(got) == want


@pytest.mark.cuda
@pytest.mark.parametrize("form,dtype,d", [(1, torch.float32, 64), (1, BF16, 32),
                                          (0, BF16, 64), (0, BF16, 128)])
def test_cuda_c_entry_refuses_a_form_it_has_no_kernel_for(form, dtype, d, cuda):
    """The wgmma form exists for bf16 at head dims 64 and 128 only, and the
    mma.sync form no longer for bf16 there: the C entry returns
    cudaErrorNotSupported, which ``_build.check`` raises, and launches
    nothing."""
    q = torch.zeros(1, 2, 16, d, dtype=dtype, device=cuda)
    out = torch.full_like(q, 7.0)
    lse = torch.empty(1, 2, 16, device=cuda)
    strides = tfc.operand_strides((("q", q), ("k", q), ("v", q)), 2, "t")
    strides += [q.stride(0), q.stride(1), q.stride(2)]
    code = _build.call_on_stream(
        _build.library().loco_flash_causal_fwd, cuda, q.data_ptr(), q.data_ptr(),
        q.data_ptr(), out.data_ptr(), lse.data_ptr(), tfc.stride_buffer(tuple(strides)), 1, 2,
        16, 16, d, 1, 0.25, form, int(dtype is BF16))
    torch.cuda.synchronize()
    assert code == 801   # cudaErrorNotSupported
    with pytest.raises(RuntimeError, match="not supported"):
        _build.check(code, "flash_forward")
    assert bool((out == 7.0).all())


@pytest.mark.cuda
def test_cuda_wgmma_lse_drives_the_blockwise_backward(cuda):
    """Gradients through the wgmma forward (its out and lse saved for the
    blockwise backward) against those through the plain forward."""
    rng = np.random.default_rng(5)
    q, k, v = (_bf16(rng, (2, 3, 200, 64), cuda).requires_grad_() for _ in range(3))
    g = _bf16(rng, (2, 3, 200, 64), cuda, sc=1.0)
    out, _ = tfc.flash_forward(q, k, v, causal=True, scale=0.125)
    got = torch.autograd.grad(out, (q, k, v), g)
    pout, plse = tfc.flash_forward_plain(q, k, v, causal=True, scale=0.125)
    want = tfc.flash_backward_blockwise(q, k, v, pout, plse, g, causal=True, scale=0.125)
    for a, w in zip(got, want):
        assert a.dtype is BF16
        err = (a.float() - w.float()).abs().max().item()
        assert err <= BF16_REL * w.float().abs().max().item(), err
