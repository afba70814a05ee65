#!/usr/bin/env python3
"""Where a block of B5/B6's wgmma form spends its cycles, on the GPU.

    python3 scripts/trace_flash_causal_wgmma.py [--block 400]

Copies ``loco_asr_tpu_torch/csrc/flash_causal.cu`` with ``clock64`` stamps
put into its wgmma kernel (thread 0 of each consumer warpgroup of block
``--block`` stamps; ``trace_stamps.py`` builds the copy with nvcc into
``loco_asr_tpu_torch/csrc/build/trace/``), and runs it, and
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
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import trace_stamps

# stamps of warpgroup w at slots 64 w ..; thread 0 of each consumer
# warpgroup of block TRACE_BLOCK stamps
MACROS = "#define TR(k) tr_store(&g_trace[64 * w + (k)], tid == 0 && blockIdx.x == TRACE_BLOCK)"
# (line of the source, the same with its stamp); stamp k: 0 start, 1 Q
# arrived, 2 K0 arrived, 3 tile 0 done; tile i (1..) at 4 + 6 (i % 8):
# +0 K arrived, +1 q.k^T done, +2 softmax done, +3 p.v done, +4 packed;
# 60 loop done, 61 out stored
EDITS = [
    ("    mbar_wait(&sm.q_full, 0);\n    mbar_wait(&sm.k_full[0], 0);",
     "    TR(0);\n    mbar_wait(&sm.q_full, 0);\n    TR(1);\n    mbar_wait(&sm.k_full[0], 0);\n"
     "    TR(2);"),
    ("    pack_bf16_a(p, s);\n    // tile i's", "    pack_bf16_a(p, s);\n    TR(3);\n    // tile i's"),
    ("      mbar_wait(&sm.k_full[st], (i / S) & 1);\n      wgmma_fence();",
     "      mbar_wait(&sm.k_full[st], (i / S) & 1);\n      TR(4 + 6 * (i & 7));\n"
     "      wgmma_fence();"),
    ("      mbar_arrive(&sm.k_empty[st]);\n", "      TR(5 + 6 * (i & 7));\n"
     "      mbar_arrive(&sm.k_empty[st]);\n"),
    ("      wgmma_wait<0>();   // p.v done", "      TR(6 + 6 * (i & 7));\n"
     "      wgmma_wait<0>();   // p.v done"),
    ("      mbar_arrive(&sm.v_empty[pst]);\n", "      TR(7 + 6 * (i & 7));\n"
     "      mbar_arrive(&sm.v_empty[pst]);\n"),
    ("      pack_bf16_a(p, s);\n    }\n", "      pack_bf16_a(p, s);\n      TR(8 + 6 * (i & 7));\n"
     "    }\n    TR(60);\n"),
    ("    if (t == 0) {\n#pragma unroll\n      for (int r = 0; r < 2; ++r)\n"
     "        if (row0 + 8 * r < Tq)",
     "    TR(61);\n    if (t == 0) {\n#pragma unroll\n      for (int r = 0; r < 2; ++r)\n"
     "        if (row0 + 8 * r < Tq)"),
]


def traced_library(block: int):
    """The stamped copy of the kernels, built and loaded."""
    return trace_stamps.stamped_library("flash_causal.cu", 128, MACROS, EDITS, "flash_causal_trace",
                                        defines=[f"TRACE_BLOCK={block}"],
                                        entries=["loco_flash_causal_fwd"])


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

    x = bf(8, 1024, 3 * 768)
    for name, (q, k, v), t_axis in (
            ("B5 [8, 25, 1024, 64]", [bf(8, 25, 1024, 64) for _ in range(3)], 2),
            ("B6 [8, 1024, 12, 64] qkv views", [y.reshape(8, 1024, 12, 64)
                                                for y in x.split(768, dim=-1)], 1)):
        run = launcher(traced, q, k, v, t_axis)
        trace_stamps.clear(traced)
        run()
        torch.cuda.synchronize()
        stamps = trace_stamps.read(traced)
        rec = dict(case=name, block=args.block,
                   warpgroups=[phases(stamps[64 * w:64 * w + 64]) for w in range(2)],
                   ms=trace_stamps.event_ms(launcher(lib, q, k, v, t_axis)),
                   traced_ms=trace_stamps.event_ms(run))
        print(json.dumps(rec))
    print(f"card: {trace_stamps.card()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
