#!/usr/bin/env python3
"""Where a block of B3's and B4's wgmma form spends its cycles, on the GPU.

    python3 scripts/trace_flash_rel_bwd_wgmma.py [--bh 0] [--q-tile 3] [--k-block 3]

Copies ``loco_asr_tpu_torch/csrc/flash_rel_bwd.cu`` with ``clock64`` stamps
put into its two wgmma kernels (thread 0 of each consumer warpgroup of one
B3 block, the (b*h = ``--bh``, 64 query rows from 64 ``--q-tile``) one, and
of one B4 block, the (``--bh``, 64 keys from 64 ``--k-block``) one;
``trace_stamps.py`` builds the copy), and runs it, and the untraced
kernels, at phase 16 (a)'s shape in bf16: [8, 12, 500, 64], L = 160, valid
lengths 500 x 6, 430, 310, non-causal.  Prints, per kernel and warpgroup,
the cycles of the block's phases: B3's wait for Q and dO, the band's edge
columns, then per key tile the wait for its copies, the band's window (its
product and stores) with s = q.k^T and dp = g.v^T, p and ds (with the
band's in-place gradient),
dq += ds.k with the tile's dqpe cells written under it, and the end (dq
through shared memory, then the rest of dqpe); B4's wait for K and V, then
per query tile the wait for its copies, the band (q.pe^T, its barriers and
stores), s^T and dp^T, p^T and ds^T, dv and dk, and the end; the
CUDA-event ms of both builds (one call launches B3 and B4); and the card's
name and power limit.

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

# slots: [kernel 0 (B3) | 1 (B4)][consumer warpgroup][64]
MACROS = r'''
#define TR_ON (threadIdx.x % 128 == 0 && blockIdx.x == TRACE_BH)
#define TR3(k) tr_store(&g_trace[64 * w + (k)], TR_ON && blockIdx.y == TRACE_QY)
#define TR4(k) tr_store(&g_trace[128 + 64 * w + (k)], TR_ON && blockIdx.y == TRACE_KY)
'''
# (line of the source, the same with its stamp).  B3: 0 start, 1 Q and dO
# arrived, 2 the edge columns done; key tile c (of this warpgroup) at
# 4 + 6 (c % 8): +0 waiting for its copies, +1 arrived, +2 the band's window
# stored and s and dp done, +3 ds done, +4 dq done (its dqpe cells written
# under the product); 60 loop done, 61 dq stored, 62 the rest of dqpe
# stored.  B4: 0 start, 1 K and V arrived;
# query tile c at 4 + 6 (c % 8): +0 waiting for its copies, +1 arrived, +2
# the band's product done and stored, +3 s^T and dp^T done, +4 p^T and
# ds^T done, +5 dv and dk done; 60 loop done, 61 dk and dv stored.
EDITS = [
    ("  const int rl = 16 * wi + g;            // rows rl and rl + 8 of the block's 64\n",
     "  const int rl = 16 * wi + g;            // rows rl and rl + 8 of the block's 64\n"
     "  TR3(0);\n"),
    ("      mbar_wait(&sm.qg_full, 0);\n      edges.dot(",
     "      mbar_wait(&sm.qg_full, 0);\n      TR3(1);\n      edges.dot("),
    ("    } else {\n      mbar_wait(&sm.qg_full, 0);\n    }\n  }\n",
     "    } else {\n      mbar_wait(&sm.qg_full, 0);\n      TR3(1);\n    }\n  }\n"
     "  TR3(2);\n  int tr_c = 0;\n"),
    ("    const bool window = !MASK_ONLY && !band_clipped(q0, k0, L);\n"
     "    mbar_wait(&sm.full[st], (idx / S) & 1);\n",
     "    const bool window = !MASK_ONLY && !band_clipped(q0, k0, L);\n"
     "    TR3(4 + 6 * (tr_c & 7));\n"
     "    mbar_wait(&sm.full[st], (idx / S) & 1);\n"
     "    TR3(5 + 6 * (tr_c & 7));\n"),
    ("    fence_regs(s);\n    fence_regs(dp);\n\n    // i - j over this warp's rows",
     "    fence_regs(s);\n    fence_regs(dp);\n    TR3(6 + 6 * (tr_c & 7));\n\n"
     "    // i - j over this warp's rows"),
    ("    uint32_t ds16[BK / 16][4];\n",
     "    TR3(7 + 6 * (tr_c & 7));\n    uint32_t ds16[BK / 16][4];\n"),
    ("    fence_regs(acc);\n    fence_regs(ds16);\n    mbar_arrive(&sm.empty[st]);\n  }\n",
     "    fence_regs(acc);\n    fence_regs(ds16);\n    TR3(8 + 6 * (tr_c & 7));\n    ++tr_c;\n"
     "    mbar_arrive(&sm.empty[st]);\n  }\n  TR3(60);\n"),
    ("  if (MASK_ONLY) return;\n\n  // the rest of dqpe",
     "  TR3(61);\n  if (MASK_ONLY) return;\n\n  // the rest of dqpe"),
    ("    row[two_l - 1] = clip_sums[BQ + rr] + clip_sums[3 * BQ + rr];\n  }\n}\n",
     "    row[two_l - 1] = clip_sums[BQ + rr] + clip_sums[3 * BQ + rr];\n  }\n  TR3(62);\n}\n"),
    ("  const int kr = 16 * wi + g;          // keys kr and kr + 8 of the block's 64\n",
     "  const int kr = 16 * wi + g;          // keys kr and kr + 8 of the block's 64\n"
     "  TR4(0);\n"),
    ("  if (tl.n > 0) mbar_wait(&sm.kv_full, 0);\n",
     "  if (tl.n > 0) mbar_wait(&sm.kv_full, 0);\n  TR4(1);\n"),
    ("  for (int idx = w; idx < tl.n; idx += W) {\n"
     "    const int st = idx % S, q0 = (tl.qt0 + idx) * BQ;\n"
     "    mbar_wait(&sm.full[st], (idx / S) & 1);\n",
     "  int tr_c = 0;\n"
     "  for (int idx = w; idx < tl.n; idx += W) {\n"
     "    const int st = idx % S, q0 = (tl.qt0 + idx) * BQ;\n"
     "    TR4(4 + 6 * (tr_c & 7));\n"
     "    mbar_wait(&sm.full[st], (idx / S) & 1);\n"
     "    TR4(5 + 6 * (tr_c & 7));\n"),
    ("      named_barrier(2 + w, 128);   // this tile's band is complete\n",
     "      named_barrier(2 + w, 128);   // this tile's band is complete\n"
     "      TR4(6 + 6 * (tr_c & 7));\n"),
    ("    fence_regs(s);\n    fence_regs(dp);\n    // the masks are decided once a tile",
     "    fence_regs(s);\n    fence_regs(dp);\n    TR4(7 + 6 * (tr_c & 7));\n"
     "    // the masks are decided once a tile"),
    ("    uint32_t p16[BQ / 16][4], ds16[BQ / 16][4];\n",
     "    TR4(8 + 6 * (tr_c & 7));\n    uint32_t p16[BQ / 16][4], ds16[BQ / 16][4];\n"),
    ("    fence_regs(p16);\n    fence_regs(ds16);\n    mbar_arrive(&sm.empty[st]);\n  }\n",
     "    fence_regs(p16);\n    fence_regs(ds16);\n    TR4(9 + 6 * (tr_c & 7));\n    ++tr_c;\n"
     "    mbar_arrive(&sm.empty[st]);\n  }\n  TR4(60);\n"),
    ("  store_acc<D>(dvb, dv_t, dva, 1.f, kr, Tk - k0, t);\n}\n",
     "  store_acc<D>(dvb, dv_t, dva, 1.f, kr, Tk - k0, t);\n  TR4(61);\n}\n"),
]

B3_TILE = ("kv_wait", "window_s_dp", "ds", "dq")
B4_TILE = ("wait", "band", "s_dp", "p_ds", "dv_dk")


def phases(stamps: list, kernel: int) -> dict:
    """A warpgroup's stamps as cycles per phase (each tile's phases from
    the stamp before them)."""
    d = lambda a, b: stamps[b] - stamps[a] if stamps[a] and stamps[b] else None
    names = B3_TILE if kernel == 0 else B4_TILE
    out = dict(start_wait=d(0, 1))
    if kernel == 0:
        out["edges"] = d(1, 2)
    tiles = []
    for c in range(8):
        base = 4 + 6 * c
        if not stamps[base]:
            break
        tiles.append({n: d(base + i, base + i + 1) for i, n in enumerate(names)})
    out["tiles"] = tiles
    last = max(i for i in range(64) if stamps[i])
    out["end"] = d(60, last) if stamps[60] else None
    if kernel == 0:
        out["end_dq"], out["end_dqpe"] = d(60, 61), d(61, 62)
    out["total"] = stamps[last] - stamps[0]
    return out


def main(argv=None) -> int:
    import torch

    from loco_asr_tpu_torch.ops.cuda import _build
    from loco_asr_tpu_torch.ops.cuda import flash_attention as fa
    from loco_asr_tpu_torch.ops.cuda import flash_causal as fc

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bh", type=int, default=0, help="the blocks' b * h (0: a full row)")
    ap.add_argument("--q-tile", type=int, default=3, help="B3's block: query rows from 64 x this")
    ap.add_argument("--k-block", type=int, default=3, help="B4's block: keys from 64 x this")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_flash_rel_bwd_wgmma: no CUDA device", file=sys.stderr)
        return 1
    b, h, t, d, two_l = 8, 12, 500, 64, 320
    nq = -(-t // 64)
    lib = _build.library()
    traced = trace_stamps.stamped_library(
        "flash_rel_bwd.cu", 256, MACROS, EDITS, "flash_rel_bwd_trace",
        defines=[f"TRACE_BH={args.bh}", f"TRACE_QY={nq - 1 - args.q_tile}",
                 f"TRACE_KY={args.k_block}"],
        entries=["loco_flash_rel_bwd"])
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(20)

    def bf(*shape, sc=0.3):
        return (torch.randn(*shape, generator=g) * sc).to(dev, torch.bfloat16)

    q, k, v = (bf(b, h, t, d) for _ in range(3))
    gg, pe = bf(b, h, t, d, sc=1.0), bf(two_l, d)
    vl = torch.tensor([t] * 6 + [430, 310], dtype=torch.int32, device=dev)
    out, lse = fa.flash_rel_forward(q, k, v, pe, vl, causal=False, scale=1.0)
    delta = (gg.float() * out.float()).sum(-1)
    strides = fc.operand_strides((("q", q), ("k", k), ("v", v), ("g", gg)), 2, "trace")
    dq, dk, dv = (fa._heads_view_buffer(b, h, t, d, dev) for _ in range(3))
    dqpe = torch.empty(b, h, t, two_l, device=dev)
    for x in (dq, dk, dv):
        strides += x.stride()[:3]
    buf = fc.stride_buffer(tuple(strides))

    def launcher(which):
        def run():
            _build.check(_build.call_on_stream(
                which.loco_flash_rel_bwd, dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                pe.data_ptr(), vl.data_ptr(), lse.data_ptr(), delta.data_ptr(), gg.data_ptr(),
                dq.data_ptr(), dqpe.data_ptr(), dk.data_ptr(), dv.data_ptr(), buf, b, h, t, t, d,
                two_l, 0, 0, 1.0, fc.FORMS.index("wgmma"), 1), "trace")
        return run

    run = launcher(traced)
    trace_stamps.clear(traced)
    run()
    torch.cuda.synchronize()
    stamps = trace_stamps.read(traced)
    for kernel, name in ((0, "B3"), (1, "B4")):
        rec = dict(kernel=name, case=f"[{b}, {h}, {t}, {d}], L = {two_l // 2}", bh=args.bh,
                   rows_from=64 * (args.q_tile if kernel == 0 else args.k_block),
                   warpgroups=[phases(stamps[128 * kernel + 64 * w:128 * kernel + 64 * w + 64],
                                      kernel) for w in range(2)])
        print(json.dumps(rec))
    print(json.dumps(dict(pair_ms=trace_stamps.event_ms(launcher(lib)),
                          traced_pair_ms=trace_stamps.event_ms(run))))
    print(f"card: {trace_stamps.card()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
