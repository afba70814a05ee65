#!/usr/bin/env python3
"""Where a block of B5/B6's wgmma form spends its cycles, on the GPU.

    python3 scripts/trace_flash_causal_wgmma.py [--block 400]

Copies ``loco_asr_tpu_torch/csrc/flash_causal.cu`` with ``clock64`` stamps
put into its wgmma kernel (thread 0 of each consumer warpgroup of block
``--block`` stamps; the store is predicated, no branch), builds the copy
with nvcc into ``loco_asr_tpu_torch/csrc/build/trace/``, and runs it, and
the untraced kernel, at the main path's shapes in bf16: B5 at
[8, 25, 1024, 64] causal (gpt2-xl) and B6 on [8, 1024, 12, 64] qkv views
(gpt2).  Prints, per shape and warpgroup, the cycles of the block's phases:
the wait for Q, tile 0 (q.k^T and softmax, nothing to overlap), then per
key tile the wait for K, q.k^T issued with p.v of the tile before it until
q.k^T is done, the softmax, the rest of p.v, the rescale of O and P's
packing, and the epilogue; the CUDA-event ms of both builds; and the
card's name and power limit.

The stamps change the code ptxas sees: it serializes the traced build's
wgmma products (its C7520 note), so the phases that wait on products run
longer there than in the untraced kernel; the softmax, the waits for
loads and the block's ends compare.  The stamps are inserted by matching
lines of the source: an edit of those lines makes this script stop with
the line it missed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STAMP = r'''#include "tf32_mma.cuh"
__device__ long long g_trace[2][64];
__device__ __forceinline__ void tr_store(long long* p, int on) {
  long long c = clock64();
  asm volatile("{ .reg .pred q; setp.ne.s32 q, %0, 0; @q st.global.u64 [%1], %2; }"
               :: "r"(on), "l"(p), "l"(c) : "memory");
}
#define TR(k) tr_store(&g_trace[w][k], tid == 0 && blockIdx.x == TRACE_BLOCK)
'''
# (line of the source, the same with its stamp); stamp k: 0 start, 1 Q
# arrived, 2 K0 arrived, 3 tile 0 done; tile i (1..) at 4 + 6 (i % 8):
# +0 K arrived, +1 q.k^T done, +2 softmax done, +3 p.v done, +4 packed;
# 60 loop done, 61 out stored
EDITS = [
    ("    mbar_wait(&sm.q_full, 0);\n    mbar_wait(&sm.k_full[0], 0);",
     "    TR(0);\n    mbar_wait(&sm.q_full, 0);\n    TR(1);\n    mbar_wait(&sm.k_full[0], 0);\n"
     "    TR(2);"),
    ("    wg::pack_p(p, s);\n    // tile i's", "    wg::pack_p(p, s);\n    TR(3);\n    // tile i's"),
    ("      mbar_wait(&sm.k_full[st], (i / S) & 1);\n      wgmma_fence();",
     "      mbar_wait(&sm.k_full[st], (i / S) & 1);\n      TR(4 + 6 * (i & 7));\n"
     "      wgmma_fence();"),
    ("      mbar_arrive(&sm.k_empty[st]);\n", "      TR(5 + 6 * (i & 7));\n"
     "      mbar_arrive(&sm.k_empty[st]);\n"),
    ("      wgmma_wait<0>();   // p.v done", "      TR(6 + 6 * (i & 7));\n"
     "      wgmma_wait<0>();   // p.v done"),
    ("      mbar_arrive(&sm.v_empty[pst]);\n", "      TR(7 + 6 * (i & 7));\n"
     "      mbar_arrive(&sm.v_empty[pst]);\n"),
    ("      wg::pack_p(p, s);\n    }\n", "      wg::pack_p(p, s);\n      TR(8 + 6 * (i & 7));\n"
     "    }\n    TR(60);\n"),
    ("    if (t == 0) {\n#pragma unroll\n      for (int r = 0; r < 2; ++r)\n"
     "        if (row0 + 8 * r < Tq)",
     "    TR(61);\n    if (t == 0) {\n#pragma unroll\n      for (int r = 0; r < 2; ++r)\n"
     "        if (row0 + 8 * r < Tq)"),
]


def traced_library(block: int) -> ctypes.CDLL:
    """The stamped copy of the kernels, built and loaded."""
    from loco_asr_tpu_torch.ops.cuda import _build

    src = open(os.path.join(_build.CSRC, "flash_causal.cu")).read()
    src = src.replace('#include "tf32_mma.cuh"\n', STAMP)
    for line, stamped in EDITS:
        if line not in src:
            raise SystemExit(f"flash_causal.cu no longer has the line\n{line}")
        src = src.replace(line, stamped)
    src += ('\nextern "C" int loco_trace_read(long long* host) {\n'
            '  return (int)cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace));\n}\n'
            'extern "C" int loco_trace_clear() {\n'
            '  static const long long zero[2][64] = {};\n'
            '  return (int)cudaMemcpyToSymbol(g_trace, zero, sizeof(zero));\n}\n')
    out_dir = os.path.join(_build.BUILD_DIR, "trace")
    os.makedirs(out_dir, exist_ok=True)
    cu, so = os.path.join(out_dir, "flash_causal_trace.cu"), os.path.join(out_dir, "libtrace.so")
    with open(cu, "w") as f:
        f.write(src)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build._nvcc(), *flags, "-shared", "-I", _build.CSRC,
                    f"-DTRACE_BLOCK={block}", cu, "-o", so], check=True)
    lib = ctypes.CDLL(so)
    lib.loco_flash_causal_fwd.argtypes = _build._SIGNATURES["loco_flash_causal_fwd"][0]
    lib.loco_flash_causal_fwd.restype = ctypes.c_int
    return lib


def phases(stamps: list) -> dict:
    """A warpgroup's stamps as cycles per phase."""
    d = lambda a, b: stamps[b] - stamps[a]
    out = dict(q_wait=d(0, 1), tile0=d(2, 3), tiles=[])
    prev = 3
    for i in range(1, 8):
        base = 4 + 6 * i
        if not stamps[base]:
            break
        out["tiles"].append(dict(k_wait=stamps[base] - stamps[prev], qk=d(base, base + 1),
                                 softmax=d(base + 1, base + 2), pv_rest=d(base + 2, base + 3),
                                 rescale_pack=d(base + 3, base + 4)))
        prev = base + 4
    out["epilogue"] = d(60, 61)
    out["total"] = d(0, 61)
    return out


def main(argv=None) -> int:
    import torch

    from loco_asr_tpu_torch.ops.cuda import _build
    from loco_asr_tpu_torch.ops.cuda import flash_causal as fc

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--block", type=int, default=400,
                    help="the block that stamps (400: B5's 6-tile and B6's 4-tile query rows)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_flash_causal_wgmma: no CUDA device", file=sys.stderr)
        return 1
    lib, traced = _build.library(), traced_library(args.block)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(19)

    def bf(*shape):
        return (torch.randn(*shape, generator=g) * 0.5).to(dev, torch.bfloat16)

    def launcher(which, q, k, v, t_axis):
        b, h, tq, tk, d = fc._check_shapes(q, k, v, t_axis)
        strides = fc.operand_strides((("q", q), ("k", k), ("v", v)), t_axis, "trace")
        out = torch.empty_like(q)
        lse = torch.empty((b, h, tq), dtype=torch.float32, device=dev)
        so = out.stride()
        buf = fc.stride_buffer(tuple(strides + [so[0], so[3 - t_axis], so[t_axis]]))

        def run():
            _build.check(_build.call_on_stream(
                which.loco_flash_causal_fwd, dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), lse.data_ptr(), buf, b, h, tq, tk, d, 1, 0.125,
                fc.FORMS.index("wgmma"), 1), "trace")
        return run

    def ms(fn, reps=50):
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

    x = bf(8, 1024, 3 * 768)
    for name, (q, k, v), t_axis in (
            ("B5 [8, 25, 1024, 64]", [bf(8, 25, 1024, 64) for _ in range(3)], 2),
            ("B6 [8, 1024, 12, 64] qkv views", [y.reshape(8, 1024, 12, 64)
                                                for y in x.split(768, dim=-1)], 1)):
        run = launcher(traced, q, k, v, t_axis)
        if traced.loco_trace_clear():
            raise RuntimeError("clearing the stamps failed")
        run()
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * 128)()
        check = traced.loco_trace_read(ctypes.addressof(buf))
        if check:
            raise RuntimeError(f"reading the stamps: CUDA error {check}")
        rec = dict(case=name, block=args.block,
                   warpgroups=[phases(list(buf[64 * w:64 * w + 64])) for w in range(2)],
                   ms=ms(launcher(lib, q, k, v, t_axis)), traced_ms=ms(run))
        print(json.dumps(rec))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
