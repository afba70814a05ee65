"""The port's shorten codec (``loco_asr_tpu_torch.ops.shorten``) against the
JAX package's, for every command mix the JAX tests cover
(``tests/test_shorten.py``): the port's encoder writes the JAX encoder's
bytes, the port's decoder gives the JAX decoder's samples and type on
the JAX stream, and both raise ``ShortenError`` on a truncated stream and
on bad magic."""

import numpy as np
import pytest

from loco_asr_tpu.ops import shorten as jshn
from loco_asr_tpu_torch.ops import shorten as tshn


def _signal(n=1500, nchan=2, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    cols = [(3000 * np.sin(t / (17 + 5 * c))
             + rng.integers(-60, 60, n)).astype(np.int32)
            for c in range(nchan)]
    return np.stack(cols, axis=1)


def _ulaw(n, nchan, seed):
    ub = np.random.default_rng(seed).integers(0, 256, (n, nchan)).astype(np.uint8)
    return np.stack([jshn.ulaw_bytes_to_internal(ub[:, c]) for c in range(nchan)], axis=1)


def _case(name):
    """(samples, encode kwargs) of each JAX test's stream."""
    s16 = jshn.TYPE_S16LH
    rng = np.random.default_rng(5)
    cmd_cycles = {
        "default": None, "diff0": [jshn.FN_DIFF0], "diff1": [jshn.FN_DIFF1],
        "diff2": [jshn.FN_DIFF2], "diff3": [jshn.FN_DIFF3],
        "diff0123": [jshn.FN_DIFF0, jshn.FN_DIFF1, jshn.FN_DIFF2, jshn.FN_DIFF3]}
    if name in cmd_cycles:
        return _signal(), dict(ftype=s16, blocksize=256, commands=cmd_cycles[name])
    return {
        "qlpc_means": (_signal(seed=3), dict(ftype=s16, nmean=4, maxnlpc=3, qlpc=[60, -30, 5],
                                             commands=[jshn.FN_QLPC, jshn.FN_DIFF1])),
        "bitshift": ((_signal(seed=4) >> 3) << 3, dict(ftype=s16, bitshift=3, nmean=2)),
        "zero_verbatim": (np.zeros((700, 1), np.int32),
                          dict(ftype=s16, commands=[jshn.FN_ZERO],
                               verbatim=b"NIST_1A original header bytes")),
        "partial_block": (_signal(n=777, nchan=1), dict(ftype=s16, blocksize=256)),
        "u8": (rng.integers(0, 256, (400, 1)).astype(np.int32), dict(ftype=jshn.TYPE_U8)),
        "u16": (rng.integers(0, 65536, (400, 1)).astype(np.int32), dict(ftype=jshn.TYPE_U16LH)),
        "au2_means": (_ulaw(600, 2, 6), dict(ftype=jshn.TYPE_AU2, nmean=4)),
        "au2_all_commands": (_ulaw(3000, 2, 1), dict(
            ftype=jshn.TYPE_AU2, nmean=4, maxnlpc=3, qlpc=[60, -30, 5],
            commands=[jshn.FN_DIFF1, jshn.FN_QLPC, jshn.FN_DIFF2, jshn.FN_DIFF3,
                      jshn.FN_DIFF0], verbatim=b"NIST_1A header copy")),
        "ulaw_type": (_ulaw(500, 1, 7), dict(ftype=jshn.TYPE_ULAW, commands=[jshn.FN_DIFF2])),
        "s16hl_qlpc_zero": (np.concatenate([_signal(n=600, seed=8), np.zeros((300, 2), np.int32)]),
                            dict(ftype=jshn.TYPE_S16HL, maxnlpc=4, qlpc=[40, -10, 3, 1],
                                 commands=[jshn.FN_QLPC, jshn.FN_ZERO, jshn.FN_DIFF3])),
    }[name]


CASES = ["default", "diff0", "diff1", "diff2", "diff3", "diff0123", "qlpc_means", "bitshift",
         "zero_verbatim", "partial_block", "u8", "u16", "au2_means", "au2_all_commands",
         "ulaw_type", "s16hl_qlpc_zero"]


@pytest.mark.parametrize("name", CASES)
def test_encode_bytes_and_decode_match_jax(name):
    x, kw = _case(name)
    ftype = kw.pop("ftype")
    stream = jshn.encode(x, ftype, **kw)
    assert tshn.encode(x, ftype, **kw) == stream
    want, want_type = jshn.decode(stream)
    got, got_type = tshn.decode(stream)
    assert got_type == want_type == ftype
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(tshn.internal_to_float(got, ftype),
                                  jshn.internal_to_float(want, ftype))
    # a decode cut at max_samples stops where the JAX decoder stops
    cut = max(1, len(x) // 3)
    np.testing.assert_array_equal(tshn.decode(stream, max_samples=cut)[0],
                                  jshn.decode(stream, max_samples=cut)[0])


def test_g711_helpers_match_jax():
    b = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(tshn.ulaw_bytes_to_internal(b), jshn.ulaw_bytes_to_internal(b))
    np.testing.assert_array_equal(tshn.alaw_bytes_to_internal(b), jshn.alaw_bytes_to_internal(b))
    for name in ("MAGIC", "FORMAT_VERSION", "TYPE_AU1", "TYPE_ULAW", "TYPE_AU2", "TYPE_AU3",
                 "TYPE_ALAW", "ULAW_TYPES", "ALAW_TYPES", "FN_VERBATIM", "V2LPCQOFFSET"):
        assert getattr(tshn, name) == getattr(jshn, name), name


@pytest.mark.parametrize("bad", ["truncated", "magic", "channels", "bitshift_low_bits"])
def test_errors_match_jax(bad):
    x = _signal(n=500, nchan=1)
    stream = jshn.encode(x, jshn.TYPE_S16LH)
    if bad == "bitshift_low_bits":
        for mod in (jshn, tshn):
            with pytest.raises(ValueError, match="bitshift"):
                mod.encode(x | 1, jshn.TYPE_S16LH, bitshift=2)
        return
    header = jshn._BitWriter()   # type, then a channel count of 0
    header.ulong(jshn.TYPE_S16LH)
    header.ulong(0)
    data = {"truncated": stream[:20], "magic": b"\x00" * 64,
            "channels": jshn.MAGIC + bytes([2]) + header.tobytes()}[bad]
    match = {"truncated": "truncated", "magic": "magic", "channels": "channel count"}[bad]
    for mod in (jshn, tshn):
        with pytest.raises(mod.ShortenError, match=match):
            mod.decode(data)
    assert issubclass(tshn.ShortenError, ValueError)
