"""ctypes binding of the port's C++ core: SPHERE decode (pcm, mu-law,
A-law, shorten; ``loco_audio.cc``), the fast lane of
``ops/audio_io.read_sphere`` and ``ops/shorten.py`` (same numerics); and a
Zstandard decoder with CRC-32C (``loco_zstd.cc``), which the orbax / OCDBT
reader (``utils/ocdbt.py``, ``utils/orbax.py``) needs.  numpy only, so a
pipe process that uses it loads no torch.

The library is built with ``g++ -O3`` at first use into ``BUILD_DIR``
(``native/build/``, which ``.gitignore`` lists) as
``libloco_audio-<hash of the sources>.so``: a changed source builds a new
file, and nothing is written next to a tracked file.  The build is atomic
across processes: under an exclusive lock on ``BUILD_DIR/.lock`` the
compiler writes a temporary name that ``os.replace`` then moves into
place, so a process never loads a partial library.  Without a compiler
:func:`load` returns None and :data:`build_error` says why.  The SPHERE
callers then take the numpy readers; the Zstandard decoder has no such
lane: :func:`zstd_decompress` and :func:`crc32c` raise, naming
``native.build_error``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = tuple(os.path.join(_HERE, name) for name in ("loco_audio.cc", "loco_zstd.cc"))
BUILD_DIR = os.path.join(_HERE, "build")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_error: Optional[str] = None


def library_path(build_dir: Optional[str] = None) -> str:
    """Where the library of the current sources is (or will be) built."""
    digest = hashlib.sha256()
    for source in SOURCES:
        with open(source, "rb") as f:
            digest.update(f.read())
    digest = digest.hexdigest()[:16]
    return os.path.join(build_dir or BUILD_DIR, f"libloco_audio-{digest}.so")


def build(build_dir: Optional[str] = None) -> str:
    """Build the library unless it exists; returns its path.  Raises
    RuntimeError if the compiler is missing or fails."""
    path = library_path(build_dir)
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(os.path.join(os.path.dirname(path), ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):        # another process built it meanwhile
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", *SOURCES, "-o", tmp]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr}")
        os.replace(tmp, path)
    return path


def load() -> Optional[ctypes.CDLL]:
    """The loaded library (built if needed), or None if it cannot be built
    (:data:`build_error` holds the reason)."""
    global _lib, build_error
    with _lock:
        if _lib is not None or build_error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(build())
        except (RuntimeError, OSError) as e:
            build_error = str(e)
            return None
        c_i32p, c_i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.la_sphere_info.argtypes = [ctypes.c_char_p, c_i32p, c_i32p, c_i64p]
        lib.la_sphere_info.restype = ctypes.c_int
        lib.la_sphere_read.argtypes = [ctypes.c_char_p, ctypes.c_int, f32p, ctypes.c_int64]
        lib.la_sphere_read.restype = ctypes.c_int64
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.lz_zstd_content_size.argtypes = [u8p, ctypes.c_int64]
        lib.lz_zstd_content_size.restype = ctypes.c_int64
        lib.lz_zstd_decompress.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64,
                                           ctypes.c_char_p, ctypes.c_int64]
        lib.lz_zstd_decompress.restype = ctypes.c_int64
        lib.lz_crc32c.argtypes = [u8p, ctypes.c_int64]
        lib.lz_crc32c.restype = ctypes.c_uint32
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def _require() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError(f"the native library did not build (native.build_error: "
                           f"{build_error})")
    return lib


def read_sphere(path: str, channel: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """``ops/audio_io.read_sphere`` in C++: (float32 samples, rate); 0-based
    ``channel``, None mixes the channels."""
    lib = _require()
    rate, channels, n = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int64()
    rc = lib.la_sphere_info(path.encode(), ctypes.byref(rate),
                            ctypes.byref(channels), ctypes.byref(n))
    if rc < 0:
        raise ValueError(f"{path}: sphere decode failed ({rc})")
    # rc == 1: n is an estimate (a shorten payload without a sample_count
    # header; counting exactly would decode the stream twice), so the
    # buffer grows on -3 (cap exceeded) until the one decode fits
    cap = max(int(n.value), 4096)
    ch = -1 if channel is None else channel
    while True:
        out = np.empty(cap, np.float32)
        got = lib.la_sphere_read(path.encode(), ch, out, cap)
        if got == -3 and rc == 1:
            cap *= 4
            continue
        if got < 0:
            raise ValueError(f"{path}: sphere read failed ({got})")
        return out[:got], rate.value


class ZstdError(ValueError):
    """A Zstandard input the decoder refuses (corrupt, or a dictionary)."""


def _bytes_pointer(data):
    """(a uint8 view of ``data``, its pointer for ctypes)."""
    arr = np.frombuffer(memoryview(data), np.uint8)
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def zstd_decompress(data) -> bytes:
    """The content of every Zstandard frame in ``data`` (bytes-like),
    concatenated; skippable frames are passed over.  Raises
    :class:`ZstdError` on a corrupt input, a failed content checksum or a
    frame that needs a dictionary."""
    lib = _require()
    src, ptr = _bytes_pointer(data)
    size = lib.lz_zstd_content_size(ptr, src.size)
    cap = size if size >= 0 else max(4 * src.size, 1 << 16)
    err = ctypes.create_string_buffer(256)
    while True:
        out = np.empty(max(cap, 1), np.uint8)
        got = lib.lz_zstd_decompress(ptr, src.size, out.ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint8)), cap, err, len(err))
        if got == -3 and size < 0:
            cap *= 4
            continue
        if got < 0:
            raise ZstdError(err.value.decode() or "output larger than the frames declare")
        return out[:got].tobytes()


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of ``data``, as OCDBT's checksums use."""
    lib = _require()
    src, ptr = _bytes_pointer(data)
    return int(lib.lz_crc32c(ptr, src.size))
