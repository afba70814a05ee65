"""Clock stamps in a copy of a kernel source: the build-and-run code that
``trace_flash_causal_wgmma.py`` and ``trace_flash_rel_bwd_wgmma.py`` share.

A script names a source under ``loco_asr_tpu_torch/csrc/``, the number of
stamp slots, macros that stamp (``tr_store(&g_trace[slot], on)``: the clock
of the thread for which ``on`` holds, stored predicated, no branch) and the
lines of the source to stamp, each with its stamped text.  The copy is
built with nvcc into ``loco_asr_tpu_torch/csrc/build/trace/`` and loaded;
``loco_trace_clear`` and ``loco_trace_read`` zero and read the slots.  An
edit whose line is not in the source (once) stops the script with that
line, so an edit of the kernel shows here instead of giving wrong stamps.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

STORE = r'''
__device__ __forceinline__ void tr_store(long long* p, int on) {
  long long c = clock64();
  asm volatile("{ .reg .pred q; setp.ne.s32 q, %0, 0; @q st.global.u64 [%1], %2; }"
               :: "r"(on), "l"(p), "l"(c) : "memory");
}
'''


def stamped_library(source: str, slots: int, macros: str, edits, out_name: str,
                    defines=(), entries=()) -> ctypes.CDLL:
    """``source`` with ``edits`` applied and ``macros`` after its last
    include (after ``#include "tf32_mma.cuh"``), built with ``-D`` each of
    ``defines`` and loaded; ``entries`` get ``_build``'s C signatures."""
    from loco_asr_tpu_torch.ops.cuda import _build

    src = open(os.path.join(_build.CSRC, source)).read()
    anchor = '#include "tf32_mma.cuh"\n'
    header = f"{anchor}__device__ long long g_trace[{slots}];\n{STORE}{macros}\n"
    edits = [(anchor, header)] + list(edits)
    for line, stamped in edits:
        if src.count(line) != 1:
            raise SystemExit(f"{source} does not have the line once:\n{line}")
        src = src.replace(line, stamped)
    src += ('\nextern "C" int loco_trace_read(long long* host) {\n'
            '  return (int)cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace));\n}\n'
            'extern "C" int loco_trace_clear() {\n'
            f'  static const long long zero[{slots}] = {{}};\n'
            '  return (int)cudaMemcpyToSymbol(g_trace, zero, sizeof(zero));\n}\n')
    out_dir = os.path.join(_build.BUILD_DIR, "trace")
    os.makedirs(out_dir, exist_ok=True)
    cu, so = os.path.join(out_dir, f"{out_name}.cu"), os.path.join(out_dir, f"lib{out_name}.so")
    with open(cu, "w") as f:
        f.write(src)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build._nvcc(), *flags, "-shared", "-I", _build.CSRC,
                    *(f"-D{d}" for d in defines), cu, "-o", so], check=True)
    lib = ctypes.CDLL(so)
    for name in entries:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = _build._SIGNATURES[name]
    lib.slots = slots
    return lib


def clear(lib) -> None:
    if lib.loco_trace_clear():
        raise RuntimeError("clearing the stamps failed")


def read(lib) -> list:
    buf = (ctypes.c_longlong * lib.slots)()
    code = lib.loco_trace_read(ctypes.addressof(buf))
    if code:
        raise RuntimeError(f"reading the stamps: CUDA error {code}")
    return list(buf)


def event_ms(fn, reps: int = 50) -> float:
    """CUDA-event ms a call of ``fn`` over ``reps`` back-to-back calls, after
    5 of warm-up."""
    import torch

    for _ in range(5):
        fn()
    a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return a.elapsed_time(e) / reps


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
