"""Shorten (SHN) lossless audio codec, decoder and encoder in numpy: the
port's own copy of ``loco_asr_tpu.ops.shorten`` (same bitstream, same
C-style truncating division, same ``ShortenError`` cases).

NIST SPHERE files of LDC telephone corpora (Fisher among them) are
``sample_coding: {ulaw,pcm},embedded-shorten-v2.00``; ``read_sphere``
(``ops/audio_io.py``) decodes them through :func:`decode`, and the C++
ingest core (``native/loco_audio.cc``) carries a twin decoder that the
tests hold to this one bit for bit.  The bitstream follows the published
shorten 2.x specification (Robinson, Cambridge TR156):

  * magic "ajkg" + version byte; Rice/uvar bit coding (unary zeros + k
    LSBs, MSB-first), ulong = uvar(uvar(2))
  * header: internal ftype, nchan, blocksize, maxnlpc, nmean, nskip
  * commands: DIFF0-3 / QLPC / ZERO audio blocks with Rice residuals,
    BLOCKSIZE / BITSHIFT state changes, VERBATIM passthrough chunks,
    QUIT
  * per-channel mean offsets (nmean window) and wrap history (max(3,
    maxnlpc)) carried across blocks

Internal sample types: the PCM family (S8/U8/S16HL/S16LH/U16HL/U16LH)
decodes to the PCM samples; the ulaw/alaw family (ULAW/AU1/AU2 and
ALAW/AU3) stores G.711-expanded linear values, so decoded output is linear
PCM, what sph2pipe emits for those files.  (AU2's "-0" zero mapping
matters only to a byte-exact ulaw re-encoding, not to linear output.)

:func:`encode` writes version-2 streams for fixtures and test corpora; it
gives the JAX encoder's bytes, with its residuals and Rice codes computed
a block at a time in numpy.
"""

from __future__ import annotations

import numpy as np

MAGIC = b"ajkg"
FORMAT_VERSION = 2

# internal file types (shorten.h)
TYPE_AU1 = 0      # lossless ulaw (linear internal)
TYPE_S8 = 1
TYPE_U8 = 2
TYPE_S16HL = 3    # big endian
TYPE_U16HL = 4
TYPE_S16LH = 5    # little endian
TYPE_U16LH = 6
TYPE_ULAW = 7     # ulaw through linear
TYPE_AU2 = 8      # ulaw with zero mapping (linear internal)
TYPE_AU3 = 9      # alaw (linear internal)
TYPE_ALAW = 10

ULAW_TYPES = (TYPE_AU1, TYPE_ULAW, TYPE_AU2)
ALAW_TYPES = (TYPE_AU3, TYPE_ALAW)

# bit-size constants (shorten.h)
ULONGSIZE = 2
TYPESIZE = 4
CHANSIZE = 0
FNSIZE = 2
ENERGYSIZE = 3
BITSHIFTSIZE = 2
LPCQSIZE = 2
LPCQUANT = 5
NSKIPSIZE = 1
XBYTESIZE = 7
VERBATIM_CKSIZE_SIZE = 5
VERBATIM_BYTE_SIZE = 8
DEFAULT_BLOCK_SIZE = 256
NWRAP = 3
V2LPCQOFFSET = 1 << LPCQUANT

FN_DIFF0, FN_DIFF1, FN_DIFF2, FN_DIFF3 = 0, 1, 2, 3
FN_QUIT, FN_BLOCKSIZE, FN_BITSHIFT, FN_QLPC = 4, 5, 6, 7
FN_ZERO, FN_VERBATIM = 8, 9

_MAX_CHANNELS = 16
_MAX_BLOCKSIZE = 1 << 17
_MAX_NLPC = 1024


class ShortenError(ValueError):
    pass


class _BitReader:
    def __init__(self, data: bytes):
        # unpackbits gives the MSB-first bit stream directly
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8))
        self.pos = 0

    def bit(self) -> int:
        if self.pos >= len(self.bits):
            raise ShortenError("shorten: bitstream truncated")
        b = int(self.bits[self.pos])
        self.pos += 1
        return b

    def nbits(self, k: int) -> int:
        v = 0
        for _ in range(k):
            v = (v << 1) | self.bit()
        return v

    def uvar(self, k: int) -> int:
        q = 0
        while not self.bit():
            q += 1
            if q > 1 << 24:
                raise ShortenError("shorten: unreasonable unary run")
        return (q << k) | self.nbits(k)

    def var(self, k: int) -> int:
        u = self.uvar(k + 1)
        return ~(u >> 1) if (u & 1) else (u >> 1)

    def ulong(self) -> int:
        return self.uvar(self.uvar(ULONGSIZE))


def _rounded_shift_down(x: int, n: int) -> int:
    return x if n == 0 else ((x >> (n - 1)) + 1) >> 1


def decode(data: bytes, max_samples: int | None = None):
    """Decode a shorten stream -> (samples [n_frames, nchan] int32, ftype).

    Values are in the internal domain: PCM samples for the PCM types,
    G.711-expanded linear for the ulaw/alaw types.
    """
    off = data.find(MAGIC, 0, 4096)
    if off < 0:
        raise ShortenError("shorten: magic 'ajkg' not found")
    version = data[off + 4]  # version byte is raw, not bit-coded
    if version > 3:
        raise ShortenError(f"shorten: unsupported version {version}")
    br = _BitReader(data[off + 5:])

    def get_uint(k_default: int) -> int:
        if version > 0:
            return br.ulong()
        return br.uvar(k_default)

    ftype = get_uint(TYPESIZE)
    nchan = get_uint(CHANSIZE)
    if not 0 < nchan <= _MAX_CHANNELS:
        raise ShortenError(f"shorten: bad channel count {nchan}")
    blocksize, maxnlpc, nmean, nskip = DEFAULT_BLOCK_SIZE, 0, 0, 0
    if version > 0:
        blocksize = get_uint(int(np.log2(DEFAULT_BLOCK_SIZE)))
        maxnlpc = get_uint(LPCQSIZE)
        nmean = get_uint(0)
        nskip = get_uint(NSKIPSIZE)
        for _ in range(nskip):
            br.uvar(XBYTESIZE)
    if not 0 < blocksize <= _MAX_BLOCKSIZE:
        raise ShortenError(f"shorten: bad blocksize {blocksize}")
    if maxnlpc > _MAX_NLPC:
        raise ShortenError(f"shorten: bad maxnlpc {maxnlpc}")
    lpcqoffset = V2LPCQOFFSET if version >= 2 else 0
    nwrap = max(NWRAP, maxnlpc)

    mean0 = 0x80 if ftype == TYPE_U8 else (
        0x8000 if ftype in (TYPE_U16HL, TYPE_U16LH) else 0)
    offsets = [[mean0] * max(1, nmean) for _ in range(nchan)]
    hist = [[0] * nwrap for _ in range(nchan)]
    out = [[] for _ in range(nchan)]
    bitshift = 0
    chan = 0

    while True:
        cmd = br.uvar(FNSIZE)
        if cmd == FN_QUIT:
            break
        if cmd == FN_VERBATIM:
            n = br.uvar(VERBATIM_CKSIZE_SIZE)
            for _ in range(n):
                br.uvar(VERBATIM_BYTE_SIZE)
        elif cmd == FN_BITSHIFT:
            bitshift = br.uvar(BITSHIFTSIZE)
            if bitshift > 31:
                raise ShortenError(f"shorten: bad bitshift {bitshift}")
        elif cmd == FN_BLOCKSIZE:
            blocksize = get_uint(int(np.log2(max(1, blocksize))))
            if not 0 < blocksize <= _MAX_BLOCKSIZE:
                raise ShortenError(f"shorten: bad blocksize {blocksize}")
        elif cmd in (FN_DIFF0, FN_DIFF1, FN_DIFF2, FN_DIFF3, FN_QLPC, FN_ZERO):
            resn = 0
            if cmd != FN_ZERO:
                resn = br.uvar(ENERGYSIZE)
                if version == 0:
                    resn -= 1
            o = offsets[chan]
            if nmean == 0:
                coffset = o[0]
            else:
                s = (0 if version < 2 else nmean // 2) + sum(o)
                coffset = _c_div(s, nmean)
                if version >= 2:
                    coffset = _rounded_shift_down(coffset, bitshift)
            # buffer with nwrap history at the front
            buf = hist[chan] + [0] * blocksize

            if cmd == FN_ZERO:
                pass  # block already zeros
            elif cmd == FN_DIFF0:
                for i in range(blocksize):
                    buf[nwrap + i] = br.var(resn) + coffset
            elif cmd == FN_DIFF1:
                for i in range(blocksize):
                    buf[nwrap + i] = br.var(resn) + buf[nwrap + i - 1]
            elif cmd == FN_DIFF2:
                for i in range(blocksize):
                    buf[nwrap + i] = (br.var(resn) + 2 * buf[nwrap + i - 1]
                                      - buf[nwrap + i - 2])
            elif cmd == FN_DIFF3:
                for i in range(blocksize):
                    buf[nwrap + i] = (br.var(resn)
                                      + 3 * (buf[nwrap + i - 1] - buf[nwrap + i - 2])
                                      + buf[nwrap + i - 3])
            else:  # FN_QLPC
                nlpc = br.uvar(LPCQSIZE)
                if nlpc > nwrap:
                    raise ShortenError(f"shorten: nlpc {nlpc} > nwrap {nwrap}")
                qlpc = [br.var(LPCQUANT) for _ in range(nlpc)]
                for i in range(nlpc):
                    buf[nwrap - 1 - i] -= coffset
                for i in range(blocksize):
                    s = lpcqoffset
                    for j in range(nlpc):
                        s += qlpc[j] * buf[nwrap + i - j - 1]
                    buf[nwrap + i] = br.var(resn) + (s >> LPCQUANT)
                if coffset != 0:
                    for i in range(nwrap - nlpc, nwrap + blocksize):
                        buf[i] += coffset

            block = buf[nwrap:]
            if nmean > 0:
                s = (0 if version < 2 else blocksize // 2) + sum(block)
                mean = _c_div(s, blocksize)
                o.pop(0)
                o.append(mean if version < 2 else mean << bitshift)
            hist[chan] = buf[blocksize:]  # last nwrap values, pre-bitshift
            if bitshift:
                block = [v << bitshift for v in block]
            out[chan].extend(block)
            chan = (chan + 1) % nchan
            if (max_samples is not None and chan == 0
                    and len(out[0]) >= max_samples):
                break
        else:
            raise ShortenError(f"shorten: unknown command {cmd}")

    n = min(len(c) for c in out) if out else 0
    samples = np.stack([np.asarray(c[:n], np.int32) for c in out], axis=1) \
        if n else np.zeros((0, nchan), np.int32)
    return samples, ftype


def _c_div(a: int, b: int) -> int:
    """C-style truncating integer division (shorten does sum / n in C)."""
    q = abs(a) // b
    return q if a >= 0 else -q




# ---------------------------------------------------------------------------
# Encoder (fixtures and test corpora; sph2pipe itself cannot encode)
# ---------------------------------------------------------------------------

class _BitWriter:
    """MSB-first bit stream kept as a list of uint8 bit arrays."""

    def __init__(self):
        self.chunks: list = []

    def uvar(self, v: int, k: int) -> None:
        self.uvars(np.asarray([v], np.int64), k)

    def uvars(self, u: np.ndarray, k: int) -> None:
        """Rice codes of the non-negative ``u`` with ``k`` low bits: ``u >> k``
        zeros, a one, then the low bits."""
        q = u >> k
        lengths = q + 1 + k
        starts = np.cumsum(lengths) - lengths
        out = np.zeros(int(lengths.sum()), np.uint8)
        stop = starts + q
        out[stop] = 1
        for j in range(k):
            out[stop + 1 + j] = (u >> (k - 1 - j)) & 1
        self.chunks.append(out)

    def vars(self, x: np.ndarray, k: int) -> None:
        """Signed values: ``2x`` for x >= 0, ``2(~x) + 1`` below, as uvar(k + 1)."""
        x = np.asarray(x, np.int64)
        self.uvars(np.where(x >= 0, x << 1, ((~x) << 1) | 1), k + 1)

    def ulong(self, v: int) -> None:
        nbit = max(1, int(v).bit_length()) if v else 0
        self.uvar(nbit, ULONGSIZE)
        self.uvar(v, nbit)

    def tobytes(self) -> bytes:
        bits = np.concatenate(self.chunks) if self.chunks else np.zeros(0, np.uint8)
        by = np.packbits(bits).tobytes()   # zero-pads the last byte
        return by + b"\x00" * ((-len(by)) % 4)  # word-align like shorten


def _best_resn(residuals: np.ndarray) -> int:
    if not len(residuals):
        return 0
    mean_abs = int(np.abs(residuals).sum()) / len(residuals)
    return min(30, max(0, int(mean_abs).bit_length()))


def encode(samples: np.ndarray, ftype: int, blocksize: int = DEFAULT_BLOCK_SIZE,
           nmean: int = 0, commands=None, maxnlpc: int = 0,
           qlpc=None, bitshift: int = 0, verbatim: bytes = b"") -> bytes:
    """Encode [n_frames, nchan] int32 internal-domain samples to a version-2
    shorten stream.  ``commands`` optionally forces the per-block command
    cycle (e.g. [FN_DIFF2, FN_QLPC]); default picks DIFF1.
    """
    samples = np.atleast_2d(np.asarray(samples, np.int64))
    if samples.ndim != 2:
        raise ValueError("samples must be [n, nchan]")
    n, nchan = samples.shape
    if bitshift:
        if ((samples & ((1 << bitshift) - 1)) != 0).any():
            raise ValueError("bitshift requires low bits to be zero")
        samples = samples >> bitshift

    bw = _BitWriter()
    nwrap = max(NWRAP, maxnlpc)
    for v in (ftype, nchan, blocksize, maxnlpc, nmean, 0):   # 0: nskip
        bw.ulong(v)
    if verbatim:
        bw.uvar(FN_VERBATIM, FNSIZE)
        bw.uvar(len(verbatim), VERBATIM_CKSIZE_SIZE)
        bw.uvars(np.frombuffer(verbatim, np.uint8).astype(np.int64), VERBATIM_BYTE_SIZE)
    if bitshift:
        bw.uvar(FN_BITSHIFT, FNSIZE)
        bw.uvar(bitshift, BITSHIFTSIZE)

    mean0 = 0x80 if ftype == TYPE_U8 else (
        0x8000 if ftype in (TYPE_U16HL, TYPE_U16LH) else 0)
    if bitshift:
        mean0 >>= bitshift
    offsets = [[mean0] * max(1, nmean) for _ in range(nchan)]
    hist = [np.zeros(nwrap, np.int64) for _ in range(nchan)]

    pos = 0
    bidx = 0
    while pos < n:
        bs = min(blocksize, n - pos)
        if bs != blocksize:
            bw.uvar(FN_BLOCKSIZE, FNSIZE)
            bw.ulong(bs)
            blocksize = bs
        for chan in range(nchan):
            cmd = FN_DIFF1 if commands is None else commands[bidx % len(commands)]
            block = samples[pos:pos + bs, chan]
            o = offsets[chan]
            if nmean == 0:
                coffset = o[0]
            else:
                s = nmean // 2 + sum(o)
                coffset = _rounded_shift_down(_c_div(s, nmean), bitshift)
            buf = np.concatenate([hist[chan], block])
            if cmd == FN_ZERO and block.any():
                cmd = FN_DIFF1  # ZERO only encodes a zero block
            cur = buf[nwrap:]
            if cmd == FN_ZERO:
                bw.uvar(FN_ZERO, FNSIZE)
            elif cmd == FN_QLPC:
                coeffs = list(qlpc or [50, -20])
                nlpc = len(coeffs)
                assert nlpc <= maxnlpc, "qlpc order exceeds maxnlpc"
                shifted = buf.copy()
                shifted[nwrap - nlpc:] -= coffset
                s = np.full(bs, V2LPCQOFFSET, np.int64)
                for j, c in enumerate(coeffs):
                    s += c * shifted[nwrap - j - 1:nwrap - j - 1 + bs]
                res = shifted[nwrap:] - (s >> LPCQUANT)
                resn = _best_resn(res)
                bw.uvar(FN_QLPC, FNSIZE)
                bw.uvar(resn, ENERGYSIZE)
                bw.uvar(nlpc, LPCQSIZE)
                bw.vars(np.asarray(coeffs, np.int64), LPCQUANT)
                bw.vars(res, resn)
            else:
                p1, p2, p3 = (buf[nwrap - j:nwrap - j + bs] for j in (1, 2, 3))
                if cmd == FN_DIFF0:
                    res = cur - coffset
                elif cmd == FN_DIFF1:
                    res = cur - p1
                elif cmd == FN_DIFF2:
                    res = cur - 2 * p1 + p2
                elif cmd == FN_DIFF3:
                    res = cur - 3 * (p1 - p2) - p3
                else:
                    raise ValueError(f"unsupported command {cmd}")
                resn = _best_resn(res)
                bw.uvar(cmd, FNSIZE)
                bw.uvar(resn, ENERGYSIZE)
                bw.vars(res, resn)
            if nmean > 0:
                s = bs // 2 + int(block.sum())
                o.pop(0)
                o.append(_c_div(s, bs) << bitshift)
            hist[chan] = buf[bs:]  # last nwrap values
        pos += bs
        bidx += 1
    bw.uvar(FN_QUIT, FNSIZE)
    return MAGIC + bytes([FORMAT_VERSION]) + bw.tobytes()


# --- ulaw/alaw byte <-> internal linear helpers (fixture construction) ---

def ulaw_bytes_to_internal(u: np.ndarray) -> np.ndarray:
    from .audio_io import ulaw_to_linear
    return ulaw_to_linear(np.asarray(u, np.uint8)).astype(np.int32)


def alaw_bytes_to_internal(a: np.ndarray) -> np.ndarray:
    from .audio_io import alaw_to_linear
    return alaw_to_linear(np.asarray(a, np.uint8)).astype(np.int32)


def internal_to_float(samples: np.ndarray, ftype: int) -> np.ndarray:
    """Decoded internal samples -> float32 in [-1, 1] (per channel)."""
    s = np.asarray(samples, np.int32)
    if ftype in ULAW_TYPES or ftype in ALAW_TYPES or ftype in (TYPE_S16HL,
                                                               TYPE_S16LH):
        return s.astype(np.float32) / 32768.0
    if ftype in (TYPE_U16HL, TYPE_U16LH):
        return (s.astype(np.float32) - 32768.0) / 32768.0
    if ftype == TYPE_S8:
        return s.astype(np.float32) / 128.0
    if ftype == TYPE_U8:
        return (s.astype(np.float32) - 128.0) / 128.0
    raise ShortenError(f"shorten: unsupported internal type {ftype}")
