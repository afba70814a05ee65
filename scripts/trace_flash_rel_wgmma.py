#!/usr/bin/env python3
"""Where a block of B1's wgmma form spends its cycles, on the GPU.

    python3 scripts/trace_flash_rel_wgmma.py [--bh 0] [--q-tile 1]

Copies ``loco_asr_tpu_torch/csrc/flash_rel.cu`` with ``clock64`` stamps put
into its wgmma kernel (thread 0 of each consumer warpgroup of one block,
the (b*h = ``--bh``, 64 query rows from 64 ``--q-tile``) one;
``trace_stamps.py`` builds the copy), and runs it, and the untraced kernel,
at phase 16 (a)'s shape in bf16: [16, 12, 249, 64], L = 160, valid lengths
249 x 10, 230, 200, 180, 120, 60, 17, non-causal, with the band and
mask-only.  Prints, per warpgroup, the cycles of the block's phases: the
wait for Q, the edge columns, then per key tile (the warpgroup's, in turn
with the other's) the wait for its copies, the products (the band's window
and s = q.k^T), the scores (the band's term and the masks), the online
softmax, o += p.v; the wait for the other warpgroup at the end, the
exchange of the partial sums and the merge with the store; the
CUDA-event ms of both builds; and the card's name and power limit.

The stamps change the code ptxas sees, so the traced build runs a little
slower than the untraced one (both times are printed).  The stamps are
inserted by matching lines of the source: an edit of those lines makes
this script stop with the line it missed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import trace_stamps

# slots: [consumer warpgroup][64]
MACROS = r'''
#define TR_ON (threadIdx.x % 128 == 0 && blockIdx.x == TRACE_BH && blockIdx.y == TRACE_QY)
#define TR1(k) tr_store(&g_trace[64 * w + (k)], TR_ON)
'''
# (line of the source, the same with its stamp): 0 start, 1 Q arrived, 2
# the edge columns; key tile c (of this warpgroup) at 4 + 6 (c % 8): +0
# waiting for its copies, +1 arrived, +2 the window and s done, +3 the
# scores done, +4 the softmax done, +5 p.v done; 60 loop done, 61 the other
# warpgroup met, 63 the partial sums exchanged, 62 merged and stored
# (warpgroup 0).
EDITS = [
    ("  const int rl = 16 * wi + g;            // rows rl and rl + 8 of the block's 64\n",
     "  const int rl = 16 * wi + g;            // rows rl and rl + 8 of the block's 64\n"
     "  TR1(0);\n"),
    ("    mbar_wait(&sm.q_full, 0);\n    edges.dot(",
     "    mbar_wait(&sm.q_full, 0);\n    TR1(1);\n    edges.dot("),
    ("  } else {\n    mbar_wait(&sm.q_full, 0);\n  }\n",
     "  } else {\n    mbar_wait(&sm.q_full, 0);\n    TR1(1);\n  }\n  TR1(2);\n  int tr_c = 0;\n"),
    ("    const int st = idx % S, k0 = idx * BK;\n    mbar_wait(&sm.full[st], (idx / S) & 1);\n"
     "    const int m_lo = MASK_ONLY ? 0 : band_first(q0, k0, L);\n    float s[BK / 2];\n",
     "    const int st = idx % S, k0 = idx * BK;\n    TR1(4 + 6 * (tr_c & 7));\n"
     "    mbar_wait(&sm.full[st], (idx / S) & 1);\n    TR1(5 + 6 * (tr_c & 7));\n"
     "    const int m_lo = MASK_ONLY ? 0 : band_first(q0, k0, L);\n    float s[BK / 2];\n"),
    ("    wgmma_wait<0>();\n    fence_regs(s);\n\n    // i - j over this warp's rows",
     "    wgmma_wait<0>();\n    fence_regs(s);\n    TR1(6 + 6 * (tr_c & 7));\n\n"
     "    // i - j over this warp's rows"),
    ("    float mx[2] = {m[0], m[1]};\n#pragma unroll\n    for (int n = 0; n < BK / 8; ++n) {\n",
     "    TR1(7 + 6 * (tr_c & 7));\n    float mx[2] = {m[0], m[1]};\n#pragma unroll\n"
     "    for (int n = 0; n < BK / 8; ++n) {\n"),
    ("    uint32_t p16[BK / 16][4];\n", "    TR1(8 + 6 * (tr_c & 7));\n    uint32_t p16[BK / 16][4];\n"),
    ("    fence_regs(o);\n    fence_regs(p16);\n    mbar_arrive(&sm.empty[st]);\n  };\n",
     "    fence_regs(o);\n    fence_regs(p16);\n    TR1(9 + 6 * (tr_c & 7));\n    ++tr_c;\n"
     "    mbar_arrive(&sm.empty[st]);\n  };\n"),
    ("  for (int idx = wg::first_item(runs.b, w); idx < nk; idx += wg::W) tile(std::false_type{}, idx);\n",
     "  for (int idx = wg::first_item(runs.b, w); idx < nk; idx += wg::W) tile(std::false_type{}, idx);\n"
     "  TR1(60);\n"),
    ("  named_barrier(1, 256);   // every item is done: the ring is free\n",
     "  named_barrier(1, 256);   // every item is done: the ring is free\n  TR1(61);\n"),
    ("  named_barrier(1, 256);\n  if (!merges) return;\n",
     "  named_barrier(1, 256);\n  TR1(63);\n  if (!merges) return;\n"),
    ("          m[r] == NEG ? NEG_NAT + logf(denom[r]) : (m[r] + log2f(denom[r])) * LN2;\n  }\n}\n",
     "          m[r] == NEG ? NEG_NAT + logf(denom[r]) : (m[r] + log2f(denom[r])) * LN2;\n  }\n"
     "  TR1(62);\n}\n"),
]

TILE = ("wait", "window_and_s", "scores", "softmax", "pv")


def phases(stamps: list) -> dict:
    """A warpgroup's stamps as cycles per phase (each tile's phases from
    the stamp before them)."""
    d = lambda a, b: stamps[b] - stamps[a] if stamps[a] and stamps[b] else None
    out = dict(start_wait=d(0, 1), edges=d(1, 2))
    tiles = []
    for c in range(8):
        base = 4 + 6 * c
        if not stamps[base]:
            break
        tiles.append({n: d(base + i, base + i + 1) for i, n in enumerate(TILE)})
    out["tiles"] = tiles
    out["wait_other"] = d(60, 61)
    out["exchange"] = d(61, 63)
    out["merge_store"] = d(63, 62)
    out["total"] = max(x for x in stamps if x) - stamps[0]
    return out


def main(argv=None) -> int:
    import torch

    from loco_asr_tpu_torch.ops.cuda import _build
    from loco_asr_tpu_torch.ops.cuda import flash_attention as fa
    from loco_asr_tpu_torch.ops.cuda import flash_causal as fc

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bh", type=int, default=0, help="the block's b * h (0: a full row)")
    ap.add_argument("--q-tile", type=int, default=1, help="query rows from 64 x this")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_flash_rel_wgmma: no CUDA device", file=sys.stderr)
        return 1
    b, h, t, d, two_l = 16, 12, 249, 64, 320
    nq = -(-t // 64)
    lib = _build.library()
    traced = trace_stamps.stamped_library(
        "flash_rel.cu", 128, MACROS, EDITS, "flash_rel_trace",
        defines=[f"TRACE_BH={args.bh}", f"TRACE_QY={nq - 1 - args.q_tile}"],
        entries=["loco_flash_rel_fwd"])
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(21)

    def bf(*shape, sc=0.3):
        return (torch.randn(*shape, generator=g) * sc).to(dev, torch.bfloat16)

    q, k, v = (bf(b, h, t, d) for _ in range(3))
    pe = bf(two_l, d)
    vl = torch.tensor([t] * 10 + [230, 200, 180, 120, 60, 17], dtype=torch.int32, device=dev)
    out = fa._heads_view_buffer(b, h, t, d, dev, torch.bfloat16)
    lse = torch.empty(b, h, t, device=dev)
    strides = fc.operand_strides((("q", q), ("k", k), ("v", v)), 2, "trace")
    strides += out.stride()[:3]
    buf = fc.stride_buffer(tuple(strides))

    def launcher(which, mask_only):
        def run():
            _build.check(_build.call_on_stream(
                which.loco_flash_rel_fwd, dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                pe.data_ptr(), vl.data_ptr(), out.data_ptr(), lse.data_ptr(), buf, b, h, t, t, d,
                two_l, 0, int(mask_only), 1.0, fc.FORMS.index("wgmma"), 1), "trace")
        return run

    for mask_only in (False, True):
        run = launcher(traced, mask_only)
        trace_stamps.clear(traced)
        run()
        torch.cuda.synchronize()
        stamps = trace_stamps.read(traced)
        print(json.dumps(dict(kernel="B1 wgmma", variant="mask-only" if mask_only else "band",
                              case=f"[{b}, {h}, {t}, {d}], L = {two_l // 2}", bh=args.bh,
                              rows_from=64 * args.q_tile,
                              warpgroups=[phases(stamps[64 * w:64 * w + 64]) for w in range(2)],
                              ms=trace_stamps.event_ms(launcher(lib, mask_only)),
                              traced_ms=trace_stamps.event_ms(run))))
    print(f"card: {trace_stamps.card()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
