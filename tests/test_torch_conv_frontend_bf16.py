"""The bf16 form of kernel B2 (form ``"mma_sync"``: ``conv_out_mma_kernel``
in ``csrc/conv_frontend.cu``), the conv on the tensor cores with aligned
16-byte stores.

On the CPU:

* the form's arithmetic modelled in numpy (bf16 products summed in f32,
  gain and offset applied after the product as one f32 FMA, the
  Abramowitz-Stegun GELU, one rounding to bf16) against the plain version
  and against the JAX Pallas B2 in interpret mode on bf16 inputs, within
  one bf16 ulp;
* the kernel emulated lane by lane (the two staged copies of the waveform,
  the A and B fragments of m16n8k16, the frames of each product's columns,
  the epilogue and the stores) against that model, bit for bit;
* the store plan for B in {1, 3, 16}, C in {64, 200, 512} and F in {1,
  127, 128, 129, 15999, 31999}: every output written exactly once, every
  16-byte store aligned, and a tile that skips the bounds tests holds only
  whole chunks;
* the form rule and the form argument of the launch path.

On a CUDA device (marker ``cuda``) the form against its plain version at
``chip_smoke.py``'s B2 shapes, at [1, 2624080], at C = 200 and 64, at F =
1, 127, 128 and 129, with a zero-padded row and a DC offset: max|d| <=
2^-7 max|plain|, and the error against float64 at most twice the plain
version's; each call counted in ``launches_by_form["mma_sync"]``.

The CUDA tests import no JAX; on a GPU machine without it run:
``python -m pytest --noconftest tests/test_torch_conv_frontend_bf16.py -m cuda``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax.numpy as jnp

    from loco_asr_tpu.ops.pallas.conv_frontend import conv1_instance_norm_gelu as jax_b2
except ImportError:   # only the tests marked ``cuda`` run without JAX
    jnp = None

from loco_asr_tpu_torch.ops.cuda import _build
from loco_asr_tpu_torch.ops.cuda import conv_frontend as cf
from test_torch_conv_frontend_kernel import gelu_as

BF16 = torch.bfloat16
ULP = 2.0 ** -8          # one bf16 ulp relative to the reference value
# mirrors of conv_frontend.cu's constants of the bf16 output kernel
MT_FRAMES = 128          # frames an output tile
MT_GROUPS = MT_FRAMES // 32
MT_CHUNKS = MT_FRAMES // 8   # 16-byte chunks of a row of the tile
MT_ROWS = 32 // MT_CHUNKS    # rows a warp's 16-byte store covers
CT = 128                 # channels an output tile: warp r takes c0 + r + 8i, i < 16
MT_WORDS = MT_FRAMES * 5 // 2 + 23
MT_COPY1 = MT_WORDS + (48 - MT_WORDS % 32) % 32
OUT_THREADS = 256


def _bf16_inputs(b, t, c, seed, dc=0.0):
    rng = np.random.default_rng(seed)
    wav = torch.from_numpy((rng.standard_normal((b, t)) * 0.1 + dc).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((c, 1, 10)) * 0.3).astype(np.float32))
    scale = torch.from_numpy((rng.standard_normal(c) * 0.2 + 1.0).astype(np.float32))
    bias = torch.from_numpy((rng.standard_normal(c) * 0.1).astype(np.float32))
    return [x.to(BF16) for x in (wav, w, scale, bias)]


def _frames(t: int) -> int:
    return (t - 10) // 5 + 1


def model_mma_form(wav, w, scale, bias):
    """The bf16 form's arithmetic on CPU bf16 tensors: y = sum_k w_k x_k
    (bf16 products, exact in f32, summed; here exactly and rounded once to
    f32, the tensor cores' sum differs in order only), the row's statistics
    folded into gain and offset (the shared statistics kernel, held to the
    float32 tests' limits), z = fma(y, gain, off), the A-S GELU in f32, one
    rounding to bf16.  Returns (out bf16 [B, C, F], y f32, gain, off)."""
    x = wav.double().numpy()
    wc = w[:, 0, :].double().numpy()
    f = _frames(x.shape[1])
    taps = np.stack([x[:, i:i + 5 * (f - 1) + 1:5] for i in range(10)], -1)   # [B, F, 10]
    y64 = np.einsum("bfi,ci->bcf", taps, wc)
    mean = y64.mean(-1)
    var = ((y64 - mean[..., None]) ** 2).mean(-1)
    gain = (scale.double().numpy() / np.sqrt(var + cf.EPS)).astype(np.float32)
    off = (bias.double().numpy() - mean * gain).astype(np.float32)
    y = y64.astype(np.float32)
    z = (y.astype(np.float64) * gain[..., None] + off[..., None]).astype(np.float32)
    return gelu_as(torch.from_numpy(z)).to(BF16), y, gain, off


def _within_one_ulp(got: np.ndarray, want: np.ndarray, what: str) -> None:
    """Every element within one bf16 ulp of ``want`` (2^-8 |want|, at least
    the spacing of bf16 at ``want``) plus 1e-6 for the A-S erf's absolute
    error (<= 1.5e-7, times |z| / 2) where the GELU is near 0."""
    e = np.floor(np.log2(np.maximum(np.abs(want), np.finfo(np.float32).tiny)))
    lim = np.maximum(ULP * np.abs(want), np.exp2(e - 7)) + 1e-6
    err = np.abs(got - want)
    bad = err > lim
    assert not bad.any(), f"{what}: {bad.sum()} of {bad.size} beyond one ulp, worst {err.max()}"


@pytest.mark.parametrize("case", ["plain", "padded_rows", "dc_offset"])
def test_model_matches_plain_within_one_ulp(case):
    wav, w, scale, bias = _bf16_inputs(3, 6003, 64, seed=1, dc=0.5 if case == "dc_offset" else 0.0)
    if case == "padded_rows":
        wav[1, 2000:] = 0.0
        wav[2, 300:] = 0.0
    got = model_mma_form(wav, w, scale, bias)[0]
    want = cf.conv1_instance_norm_gelu_plain(wav, w, scale, bias)
    assert got.dtype is want.dtype is BF16 and got.shape == want.shape == (3, 64, 1199)
    _within_one_ulp(got.float().numpy(), want.float().numpy(), case)


@pytest.mark.parametrize("t_len", [8000, 5003])
def test_model_matches_jax_pallas_within_one_ulp(t_len):
    if jnp is None:
        pytest.skip("needs JAX")
    wav, w, scale, bias = _bf16_inputs(3, t_len, 64, seed=t_len)
    jargs = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (wav, w, scale, bias)]
    want = jax_b2(*jargs, chunk_frames=256, interpret=True)
    assert want.dtype == jnp.bfloat16
    got = model_mma_form(wav, w, scale, bias)[0]
    _within_one_ulp(got.float().numpy(), np.asarray(want.astype(jnp.float32)), f"T={t_len}")


# ---- the kernel emulated lane by lane


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(np.uint16).astype(np.uint32)


def _lo_hi(words) -> tuple:
    """The two bf16 halves of 32-bit words as float32 (low half first)."""
    w = np.asarray(words).astype(np.uint32)
    return ((w & 0xFFFF) << 16).view(np.float32), (w & 0xFFFF0000).view(np.float32)


def tile_count(b_n: int, c_n: int, f_n: int) -> int:
    """The kernel's tiles (row b, channel tile, frame tile): its frame tiles
    own the chunks that start in their frames, shifted back by up to 8, so a
    row has (F + 7) // MT_FRAMES + 1 of them."""
    return ((f_n + 7) // MT_FRAMES + 1) * -(-c_n // CT) * b_n


def stage_samples(x_row: np.ndarray, s0: int, t_n: int) -> np.ndarray:
    """stage_samples: the two copies of a tile's samples, through the
    interior path's loads (two a word, the next lane's first sample, lane
    31's own third; each asserted inside the row) or the edge path's
    bounds tests."""
    sx = np.zeros(MT_COPY1 + MT_WORDS, np.uint32)
    if s0 >= 0 and s0 + 2 * MT_WORDS + 1 < t_n:
        for i0 in range(0, MT_WORDS, OUT_THREADS):
            i = i0 + np.arange(OUT_THREADS)
            s = s0 + 2 * i
            load = i <= MT_WORDS
            assert (s[load] >= 0).all() and (s[load] + 1 < t_n).all()
            x0 = np.where(load, x_row[np.minimum(s, t_n - 1)], 0)
            x1 = np.where(load, x_row[np.minimum(s + 1, t_n - 1)], 0)
            nxt = np.roll(x0.reshape(-1, 32), -1, axis=1).reshape(-1)   # __shfl_down 1
            own = (i % 32 == 31) & (i < MT_WORDS)
            assert (s[own] + 2 < t_n).all()
            x2 = np.where(own, x_row[np.minimum(s + 2, t_n - 1)], nxt)
            keep = i < MT_WORDS
            sx[i[keep]] = x0[keep] | x1[keep] << 16
            sx[MT_COPY1 + i[keep]] = x1[keep] | x2[keep] << 16
    else:
        s = s0 + 2 * np.arange(MT_WORDS)

        def sample(j):
            return np.where((j >= 0) & (j < t_n), x_row[np.clip(j, 0, t_n - 1)], 0)

        sx[:MT_WORDS] = sample(s) | sample(s + 1) << 16
        sx[MT_COPY1:] = sample(s + 1) | sample(s + 2) << 16
    return sx


def emulate_mma_kernel(wav, w, gain, off):
    """conv_out_mma_kernel's indices and data flow in numpy, a block (one
    tile), a warp and a product at a time, all 32 lanes at once, up to the GELU's input z = fma(y, gain, off) (elementwise from
    there): the staged waveform, the A and B fragments of m16n8k16, each
    group's chunks into the warp's swizzled stage, read back a row a store
    instruction.  Returns z as the stores place it [B, C, F], the count of
    writes of each output, and the element offsets of the 16-byte
    stores."""
    b_n, t_n = wav.shape
    c_n = w.shape[0]
    f_n = _frames(t_n)
    x, wb = _bits(wav).astype(np.int64), _bits(w[:, 0, :]).reshape(-1)
    out = np.zeros(b_n * c_n * f_n, np.float32)
    writes = np.zeros(b_n * c_n * f_n, np.int64)
    wide = []
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    k, hs = lane % MT_CHUNKS, lane // MT_CHUNKS
    k8 = np.arange(8)
    nfx, ncy = (f_n + 7) // MT_FRAMES + 1, -(-c_n // CT)
    total = tile_count(b_n, c_n, f_n)

    def weight_pair(c, kk, inside):
        cc = np.clip(c, 0, c_n - 1)
        return np.where(inside, wb[cc * 10 + kk] | wb[cc * 10 + kk + 1] << 16, 0)

    def row_value(v, b, c, inside):
        return np.where(inside, v[b, np.clip(c, 0, c_n - 1)], 0).astype(np.float32)

    for tile in range(total):   # the grid's blocks, frame tile fastest
        fx, rest = tile % nfx, tile // nfx
        cy, b = rest % ncy, rest // ncy
        f0, c0 = fx * MT_FRAMES, cy * CT
        sx = stage_samples(x[b], 5 * (f0 - 8), t_n)
        full = fx > 0 and f0 + MT_FRAMES - 1 <= f_n and c0 + CT <= c_n
        for r in range(8):
            ca = c0 + r + 8 * g
            cb = ca + 64
            ina, inb = ca < c_n, cb < c_n
            a = [weight_pair(ca, 2 * t, ina), weight_pair(cb, 2 * t, inb),
                 weight_pair(ca, 8, ina & (t == 0)), weight_pair(cb, 8, inb & (t == 0))]
            amat = np.zeros((16, 16))
            for reg, (row, col) in enumerate(((g, 2 * t), (g + 8, 2 * t),
                                              (g, 2 * t + 8), (g + 8, 2 * t + 8))):
                amat[row, col], amat[row, col + 1] = _lo_hi(a[reg])
            gain_off = [(row_value(gain, b, c, i), row_value(off, b, c, i))
                        for c, i in ((ca, ina), (cb, inb))]
            e = ((b * c_n + c0 + r) * (f_n & 7)) & 7
            dl = (8 - e) & 7
            s_lane = 5 * (dl + 8 * (g >> 1) + (g & 1))
            sb = np.where(s_lane & 1, MT_COPY1 + (s_lane - 1) // 2, s_lane // 2) + t
            # the warp's stage: [16 rows][MT_CHUNKS] chunks of 8 values
            st = np.full((16, MT_CHUNKS, 8), np.nan, np.float32)
            for q in range(MT_GROUPS):
                z = np.zeros((2, 32, 8), np.float32)   # rows g and g + 8
                for j in range(4):
                    bmat = np.zeros((16, 8))
                    for reg, row in ((0, 2 * t), (4, 2 * t + 8)):
                        bmat[row, g], bmat[row + 1, g] = _lo_hi(sx[sb + 80 * q + 5 * j + reg])
                    d = (amat @ bmat).astype(np.float32)   # exact products, one rounding
                    for h, row in enumerate((g, g + 8)):
                        gv, ov = gain_off[h]
                        for col in range(2):
                            z[h, :, 2 * j + col] = (d[row, 2 * t + col].astype(np.float64)
                                                    * gv + ov).astype(np.float32)
                pos = (4 * q + t) ^ ((g & 1) << 2)
                for h in range(2):
                    assert np.isnan(st[g + 8 * h, pos]).all(), "a stage chunk written twice"
                    st[g + 8 * h, pos] = z[h]
            # the write: store instruction i, lane (hs, k): row i MT_ROWS + hs, chunk k
            f = f0 - 8 + dl + 8 * k
            whole = (f >= 0) & (f + 8 <= f_n)
            assert not full or whole.all(), "a tile without bounds tests holds a partial chunk"
            for i in range(16 // MT_ROWS):
                h = i * MT_ROWS + hs
                c = c0 + r + 8 * (h & 7) + 64 * (h >> 3)
                v = st[h, k ^ ((h & 1) << 2)]
                i0 = (b * c_n + c) * f_n + f
                inside = c < c_n
                keep = inside[:, None] & (whole[:, None] | (
                    (f[:, None] + k8 >= 0) & (f[:, None] + k8 < f_n)))
                wide.extend(i0[inside & whole])
                idx = i0[:, None] + k8
                out[idx[keep]] = v[keep]
                np.add.at(writes, idx[keep], 1)
    shape = (b_n, c_n, f_n)
    return out.reshape(shape), writes.reshape(shape), np.array(wide, np.int64)


@pytest.mark.parametrize("b,t_len,c", [(2, 3508, 200), (1, 643, 64), (1, 1933, 64), (3, 10, 64)])
def test_emulated_kernel_equals_the_model_bit_for_bit(b, t_len, c):
    """F = 700 (six frame tiles: a row's first, interior ones, its last; C
    = 200: a whole channel tile and a partial one), F = 127, F = 385 and F
    = 1."""
    wav, w, scale, bias = _bf16_inputs(b, t_len, c, seed=t_len)
    if b > 1:
        wav[-1, t_len // 3:] = 0.0
    _, y, gain, off = model_mma_form(wav, w, scale, bias)
    z, writes, wide = emulate_mma_kernel(wav, w, gain, off)
    assert (writes == 1).all()
    assert (wide % 8 == 0).all() and (len(wide) > 0 or z.shape[-1] < 8)
    want = (y.astype(np.float64) * gain[..., None] + off[..., None]).astype(np.float32)
    np.testing.assert_array_equal(z, want)


@pytest.mark.parametrize("t_len", [643, 40000])
def test_staged_samples_equal_the_waveform(t_len):
    """Both staging paths give word i = samples (s0 + 2i, s0 + 2i + 1) and
    its shifted copy, zero outside the row, at every tile of a row."""
    x = np.random.default_rng(t_len).integers(1, 1 << 16, t_len)
    f_n = _frames(t_len)
    for fx in range((f_n + 7) // MT_FRAMES + 1):
        s0 = 5 * (fx * MT_FRAMES - 8)
        sx = stage_samples(x, s0, t_len)
        j = s0 + np.arange(2 * MT_WORDS + 2)
        v = np.where((j >= 0) & (j < t_len), x[np.clip(j, 0, t_len - 1)], 0)
        np.testing.assert_array_equal(sx[:MT_WORDS], v[0:-2:2] | v[1:-1:2] << 16)
        np.testing.assert_array_equal(sx[MT_COPY1:], v[1:-1:2] | v[2::2] << 16)


# ---- the store plan at the main path's shapes


def store_plan(b_n: int, c_n: int, f_n: int):
    """The chunks conv_out_mma_kernel stores, from its indices, a batch row
    at a time: the channel of each row [rows], and for each of the row's
    chunks [rows, chunks], in the order a row's tiles and lanes take them:
    its first frame, its element offset, and whether its tile skips the
    bounds tests."""
    nx, ny = (f_n + 7) // MT_FRAMES + 1, -(-c_n // CT)
    # rows: (tile by, warp r, stage row h); chunks: (tile bx, lane's k)
    by, r, h = (v.reshape(-1, 1) for v in np.meshgrid(
        np.arange(ny), np.arange(8), np.arange(16), indexing="ij"))
    bx, k = (v.reshape(1, -1) for v in np.meshgrid(np.arange(nx), np.arange(MT_CHUNKS),
                                                   indexing="ij"))
    c0 = by * CT
    c = c0 + r + 8 * (h & 7) + 64 * (h >> 3)
    full = (bx > 0) & (bx * MT_FRAMES + MT_FRAMES - 1 <= f_n) & (c0 + CT <= c_n)
    for b in range(b_n):
        e = ((b * c_n + c0 + r) * (f_n & 7)) & 7
        f = bx * MT_FRAMES - 8 + ((8 - e) & 7) + 8 * k
        yield c[:, 0], f, (b * c_n + c) * f_n + f, full


@pytest.mark.parametrize("f_n", [1, 127, 128, 129, 15999, 31999])
def test_store_plan_writes_every_output_once_and_aligned(f_n):
    for b_n in (1, 3, 16):
        for c_n in (64, 200, 512):
            for c, f, i, full in store_plan(b_n, c_n, f_n):
                rows = c < c_n                     # rows past C store nothing
                assert sorted(c[rows]) == list(range(c_n))
                f, i, full = f[rows], i[rows], np.broadcast_to(full, f.shape)[rows]
                writes = (f + 8 > 0) & (f < f_n)   # chunks holding a frame of the row
                whole = (f >= 0) & (f + 8 <= f_n)  # each in one 16-byte store
                assert (i[whole] % 8 == 0).all() and whole[full].all()
                # a row's chunks are 8 frames apart and cover [0, F) once
                assert (np.diff(f, axis=1) == 8).all()
                first = np.where(writes, f, f_n).min(1)
                last = np.where(writes, f, -8).max(1)
                assert ((first <= 0) & (first + 8 > 0)).all()
                assert ((last < f_n) & (last + 8 >= f_n)).all()
                assert (writes.sum(1) == (last - first) // 8 + 1).all()


def test_stage_swizzle_is_conflict_free():
    """The warp's 16-byte stage stores (a group's chunks of rows g and g +
    8) and reads (a row's chunks, MT_ROWS rows an instruction): each
    quarter warp touches the 32 banks once (bank group = the chunk's byte
    offset / 16 mod 8 over a 256-byte row)."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    k, hs = lane % MT_CHUNKS, lane // MT_CHUNKS
    for q in range(MT_GROUPS):
        for h0 in (0, 8):
            pos = (h0 + g) * MT_CHUNKS + ((4 * q + t) ^ ((g & 1) << 2))
            for quarter in pos.reshape(4, 8):
                assert len(set(quarter % 8)) == 8
    for i in range(16 // MT_ROWS):
        h = i * MT_ROWS + hs
        pos = h * MT_CHUNKS + (k ^ ((h & 1) << 2))
        assert len(set(pos)) == 32
        for quarter in pos.reshape(4, 8):
            assert len(set(quarter % 8)) == 8


# ---- the form rule and the launch path


def test_form_follows_the_operand_type():
    assert cf.FORMS == ("ffma", "mma_sync")
    assert cf.kernel_form(torch.float32) == "ffma"
    assert cf.kernel_form(BF16) == "mma_sync"
    assert set(cf.conv1_instance_norm_gelu.launches_by_form) == set(cf.FORMS)


@pytest.mark.parametrize("dtype,form", [(torch.float32, 0), (BF16, 1)])
def test_launch_path_passes_the_form_before_the_operand_type(monkeypatch, dtype, form):
    calls = []
    lib = type("Lib", (), {"loco_conv_frontend": lambda self, *a: (calls.append(a), 0)[1]})()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "require_cuda", lambda t, what: None)
    monkeypatch.setattr(_build, "call_on_stream", lambda fn, dev, *a: fn(*a, None))
    monkeypatch.setattr(cf, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    wav = torch.zeros(2, 4000, dtype=dtype)
    out = cf._launch(wav, torch.zeros(8, 1, 10, dtype=dtype), torch.ones(8, dtype=dtype),
                     torch.zeros(8, dtype=dtype), 10, 5)
    assert out.dtype is dtype and out.shape == (2, 8, 799)
    (args,) = calls
    assert args[-3:] == (form, int(dtype is BF16), None)


# ---- on the card


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False     # the plain version's conv in f32
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = old


def _hold_on_card(args, what):
    """The kernel's bf16 output against its plain version: max|d| <= 2^-7
    max|plain| and its float64 error at most twice the plain version's;
    one launch, of the mma_sync form."""
    before = dict(cf.conv1_instance_norm_gelu.launches_by_form)
    with torch.no_grad():
        got = cf.conv1_instance_norm_gelu(*args)
    torch.cuda.synchronize()
    after = cf.conv1_instance_norm_gelu.launches_by_form
    assert after["mma_sync"] == before["mma_sync"] + 1 and after["ffma"] == before["ffma"], what
    plain = cf.conv1_instance_norm_gelu_plain(*args)
    exact = cf.conv1_instance_norm_gelu_plain(*(a.double() for a in args))
    assert got.dtype is BF16 and got.shape == plain.shape, what
    assert torch.isfinite(got.float()).all(), what
    err = (got.float() - plain.float()).abs().max().item()
    assert err <= 2.0 ** -7 * plain.float().abs().max().item(), f"{what}: max |d| {err}"
    k_err = (got.double() - exact).abs().max().item()
    p_err = (plain.double() - exact).abs().max().item()
    assert k_err <= 2 * p_err, f"{what}: error {k_err} against float64 > 2 x plain {p_err}"


@pytest.mark.cuda
@pytest.mark.parametrize("b,t_len", [(16, 80000), (8, 160000), (4, 64000), (3, 23457),
                                     (1, 2624080)])
def test_cuda_form_matches_plain_at_the_main_shapes(b, t_len, cuda_dev):
    _hold_on_card([a.to(cuda_dev) for a in _bf16_inputs(b, t_len, 512, seed=b)], f"[{b}, {t_len}]")


@pytest.mark.cuda
@pytest.mark.parametrize("c", [200, 64])
@pytest.mark.parametrize("f_n,extra", [(1, 0), (127, 3), (128, 0), (129, 4), (12799, 1)])
def test_cuda_form_matches_plain_at_edge_shapes(c, f_n, extra, cuda_dev):
    t_len = 5 * (f_n - 1) + 10 + extra
    args = [a.to(cuda_dev) for a in _bf16_inputs(3, t_len, c, seed=f_n + c)]
    args[0][-1, t_len // 3:] = 0.0        # a zero-padded row
    _hold_on_card(args, f"C={c} F={f_n}")


@pytest.mark.cuda
def test_cuda_form_with_dc_offset(cuda_dev):
    _hold_on_card([a.to(cuda_dev) for a in _bf16_inputs(4, 64000, 200, seed=3, dc=0.5)], "DC")


@pytest.mark.cuda
def test_cuda_entry_refuses_pairings_without_a_kernel(cuda_dev):
    """Form 0 with bf16 operands and form 1 with f32 ones:
    cudaErrorNotSupported, nothing launched."""
    lib = _build.library()
    for form, dtype in ((0, BF16), (1, torch.float32)):
        wav = torch.zeros(1, 4000, dtype=dtype, device=cuda_dev)
        w = torch.zeros(8, 1, 10, dtype=dtype, device=cuda_dev)
        s = torch.zeros(8, dtype=dtype, device=cuda_dev)
        scratch = torch.zeros(4096, device=cuda_dev)
        out = torch.zeros(1, 8, 799, dtype=dtype, device=cuda_dev)
        code = lib.loco_conv_frontend(wav.data_ptr(), w.data_ptr(), s.data_ptr(), s.data_ptr(),
                                      scratch.data_ptr(), out.data_ptr(), 1, 4000, 8, 10, 5, 799,
                                      128, cf.EPS, form, int(dtype is BF16), None)
        assert lib.loco_error_string(code).decode() == "operation not supported", (form, code)
