"""The port's Zstandard decoder (``loco_asr_tpu_torch.native.zstd_decompress``,
C++ in ``native/loco_zstd.cc``) against the ``zstandard`` module: every
zstd value of the five committed orbax steps under ``exp/loco/*/ckpt``
(their chunks and nodes), and seeded inputs compressed at levels -5, 1,
3, 19 and 22 with and without checksum and content size: all-zero (RLE
blocks), random (raw blocks), text (Huffman literals, FSE sequences,
repeat offsets), more than 128 KiB (many blocks), concatenated frames and
a skippable frame; and inputs that reach the rarer forms (RLE literals,
directly stored Huffman weights, blocks of >= 32512 sequences).  A
corrupt checksum raises, and so does a frame that names a dictionary;
CRC-32C against its published check value."""

import glob
import os
import shutil
import struct

import numpy as np
import pytest

from loco_asr_tpu_torch import native
from loco_asr_tpu_torch.utils.ocdbt import OcdbtStore

zstandard = pytest.importorskip("zstandard")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = sorted(glob.glob(os.path.join(ROOT, "exp", "loco", "*", "ckpt", "step_*")))
MAGIC = b"\x28\xb5\x2f\xfd"

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ compiler")


def _reference(frame: bytes) -> bytes:
    out, rest = [], frame
    while rest:
        d = zstandard.ZstdDecompressor().decompressobj()
        out.append(d.decompress(rest))
        rest = d.unused_data
    return b"".join(out)


def _inputs():
    rng = np.random.default_rng(16)
    words = np.array("the of and a to in is you that it he was for on are as "
                     "with his they at be this from have or by".split())
    text = " ".join(rng.choice(words, 40000)).encode()
    return {
        "zeros": bytes(300_000),
        "random": rng.bytes(150_000),
        "text": text,                                    # > 128 KiB
        "floats": rng.standard_normal(70_000).astype(np.float32).tobytes(),
        "short": b"abcabcabcabcabd",
        "empty": b"",
    }


INPUTS = _inputs()


def _rarer_forms():
    """Inputs whose frames take the decoder's rarer forms: >= 32512
    sequences in a block (the three-byte count: 3-byte tokens, every one a
    match), RLE literals (one literal byte between matches), and Huffman
    weights stored directly (four or nine symbols)."""
    rng = np.random.default_rng(1)
    toks = [rng.bytes(3) for _ in range(2048)]
    r = rng.bytes(4000)
    segs = [r]
    for _ in range(30000):
        i = int(rng.integers(0, 3900))
        segs.append(b"A" + r[i:i + int(rng.integers(8, 40))])
    p9 = np.array([2.0 ** -k for k in range(1, 10)])
    return {
        "tokens3": b"".join(toks[i] for i in rng.integers(0, 2048, 150000)),
        "rle_literals": b"".join(segs),
        "four_symbols": rng.choice(4, 100000, p=[.55, .25, .15, .05]).astype(np.uint8).tobytes(),
        "nine_symbols": rng.choice(9, 100000, p=p9 / p9.sum()).astype(np.uint8).tobytes(),
    }


def test_committed_steps_are_five_with_ten_zstd_data_files():
    assert [os.path.basename(os.path.dirname(os.path.dirname(s))) for s in STEPS] == \
        ["asr", "asr_lm", "asr_lm2", "asr_lm_big", "lm"]
    data = [f for s in STEPS for f in glob.glob(os.path.join(s, "**", "d", "*"), recursive=True)]
    starts = [open(f, "rb").read(4) for f in data]
    assert sum(b == MAGIC for b in starts) == 10


@pytest.mark.parametrize("step", STEPS, ids=lambda s: s.split(os.sep)[-3])
def test_every_committed_value_decodes_like_zstandard(step):
    store = OcdbtStore(step)
    n = 0
    for key in store.keys():
        value = store.read(key)
        if value[:4] == MAGIC:
            assert native.zstd_decompress(value) == _reference(value), key
            n += 1
    assert n >= 100


@pytest.mark.parametrize("level", [-5, 1, 3, 19, 22])
@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("content_size", [False, True])
def test_generated_frames_decode(level, checksum, content_size):
    c = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                 write_content_size=content_size)
    for name, data in INPUTS.items():
        frame = c.compress(data)
        assert native.zstd_decompress(frame) == data, name
    # a frame written in pieces carries no content size
    stream = c.compressobj()
    frame = stream.compress(INPUTS["text"]) + stream.flush()
    assert native.zstd_decompress(frame) == INPUTS["text"]


@pytest.mark.parametrize("level", [1, 19])
def test_rarer_block_forms_decode(level):
    c = zstandard.ZstdCompressor(level=level, write_checksum=True)
    for name, data in _rarer_forms().items():
        assert native.zstd_decompress(c.compress(data)) == data, name


def test_concatenated_and_skippable_frames():
    c = zstandard.ZstdCompressor(level=3, write_checksum=True)
    skippable = struct.pack("<II", 0x184D2A5B, 5) + b"hello"
    parts = [INPUTS["text"][:5000], INPUTS["zeros"][:700], INPUTS["random"][:900]]
    stream = skippable + c.compress(parts[0]) + skippable + c.compress(parts[1]) \
        + c.compress(parts[2]) + skippable
    assert native.zstd_decompress(stream) == b"".join(parts)
    assert native.zstd_decompress(stream) == _reference(stream.replace(skippable, b""))


def test_corrupt_checksum_raises():
    frame = bytearray(zstandard.ZstdCompressor(level=3, write_checksum=True)
                      .compress(INPUTS["text"]))
    frame[-1] ^= 0xFF
    with pytest.raises(native.ZstdError, match="checksum"):
        native.zstd_decompress(bytes(frame))


def test_dictionary_frame_raises_naming_its_id():
    samples = [bytes(INPUTS["text"][i:i + 300]) for i in range(0, 90000, 300)]
    dictionary = zstandard.train_dictionary(4096, samples)
    frame = zstandard.ZstdCompressor(dict_data=dictionary).compress(INPUTS["text"][:2000])
    with pytest.raises(native.ZstdError, match=f"dictionary ID {dictionary.dict_id()}"):
        native.zstd_decompress(frame)


def test_garbage_raises():
    with pytest.raises(native.ZstdError, match="not a Zstandard frame"):
        native.zstd_decompress(b"\x00" * 16)
    frame = zstandard.ZstdCompressor(level=3).compress(INPUTS["text"])
    for cut in (len(frame) // 2, 40, 9, len(frame) - 1):
        with pytest.raises(native.ZstdError):
            native.zstd_decompress(frame[:cut])


def test_crc32c_check_value():
    assert native.crc32c(b"123456789") == 0xE3069283
    assert native.crc32c(b"") == 0


def test_without_the_library_an_orbax_read_names_the_build_error(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build_error", "g++: not found")
    with pytest.raises(RuntimeError, match=r"native.build_error: g\+\+: not found"):
        OcdbtStore(STEPS[0])
