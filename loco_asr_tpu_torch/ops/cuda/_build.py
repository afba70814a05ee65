"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` (one process
per source, all started together, each spreading its optimization passes
over the machine's threads: ``--split-compile=0`` halves the longest,
``flash_rel_bwd.cu``, for the same registers) and linked into one shared
library with a plain C interface, which is loaded with ``ctypes``.  Headers
(``csrc/*.cuh``) are included by the sources, never compiled alone.  The
library's file name carries a hash of the sources and headers, so an
edited file is rebuilt and an unchanged tree is loaded from
``csrc/build/`` (listed in ``.gitignore``).
Nothing here runs at import time: :func:`library` builds on first use.

Each C entry point takes its pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` after its launches; :func:`check` turns a
non-zero code into an exception, and :func:`call_on_stream` calls an entry
point on a device's current stream.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--split-compile=0", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points in csrc/*.cu: (argtypes, restype).  The
# kernels of B1-B6 take their operand type as an int after their other
# arguments (0: float32, 1: bfloat16; ``bf16_flag``); B1's, B3/B4's and
# B5/B6's take their form (``flash_causal.FORMS``) just before it, B2's
# its own (``conv_frontend.FORMS``).
_SIGNATURES = {
    "loco_flash_rel_fwd": ([_P] * 8 + [_I] * 8 + [_F, _I, _I, _P], _I),
    "loco_flash_rel_smem_bytes": ([_I] * 4, ctypes.c_size_t),
    "loco_flash_rel_blocks_per_sm": ([_I] * 4, _I),
    "loco_flash_rel_fwd_wgmma_plan": ([_P] + [_I] * 8 + [_P, _P], None),
    "loco_flash_rel_bwd": ([_P] * 13 + [_I] * 8 + [_F, _I, _I, _P], _I),
    "loco_flash_rel_bwd_smem_bytes": ([_I] * 5, ctypes.c_size_t),
    "loco_flash_rel_bwd_blocks_per_sm": ([_I] * 5, _I),
    "loco_flash_rel_bwd_wgmma_plan": ([_P] + [_I] * 8 + [_P, _P], None),
    "loco_conv_frontend": ([_P] * 6 + [_I] * 7 + [_F, _I, _I, _P], _I),
    "loco_conv_frontend_blocks_per_sm": ([_I, _I], _I),
    "loco_flash_causal_fwd": ([_P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _F, _I, _I, _P], _I),
    "loco_flash_causal_wgmma_plan": ([_P] + [_I] * 6 + [_P], None),
    "loco_logmel": ([_P] * 6 + [_I] * 12 + [_F, _P], _I),
    "loco_logmel_smem_bytes": ([_I, _I, _I], ctypes.c_size_t),
    "loco_logmel_blocks_per_sm": ([_I, _I, _I], _I),
    "loco_error_string": ([_I], ctypes.c_char_p),
    "loco_tensor_map_encode_us": ([_P, _I], ctypes.c_double),
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # set when this process compiled
build_log: str = ""                     # nvcc/ptxas output of that build


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for p in _sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libloco_kernels-{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile ``csrc/*.cu`` into the hashed library unless it exists;
    returns its path."""
    global build_seconds, build_log
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    srcs = _sources()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", s, "-o", o],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        for s, p, log in zip(srcs, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s}:\n{log}")
        lib_tmp = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", *objs,
                               "-o", lib_tmp],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(lib_tmp, out)   # atomic: concurrent builds agree
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs) + link.stdout
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib


def call_on_stream(fn, device: torch.device, *args) -> int:
    """``fn(*args, stream)`` with the raw handle of ``device``'s current
    CUDA stream, made the current device only when it is not already (a
    launch goes to the current device).  Called with a CUDA tensor's
    device, so CUDA is initialised."""
    current = torch._C._cuda_getDevice()
    index = current if device.index is None else device.index
    if index == current:
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


KERNEL_DTYPES = (torch.float32, torch.bfloat16)   # the operand types of B1-B6


def bf16_flag(dtype: torch.dtype, what: str) -> int:
    """The C entries' operand-type argument: 0 for float32, 1 for
    bfloat16; any other type raises (no kernel takes it, and no wrapper
    casts to one that does)."""
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"{what}: the CUDA kernels take float32 or bfloat16, got {dtype}")
    return int(dtype is torch.bfloat16)


def require_cuda(t: torch.Tensor, what: str) -> None:
    """Raise unless ``t`` lies on a CUDA device: the launch paths' guard
    (the wrappers send CPU tensors to their plain versions before it)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        name = library().loco_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({name})")
