#!/usr/bin/env python3
"""Variants of kernel B2's bf16 output kernel (``conv_out_mma_kernel``,
form ``"mma_sync"``), built side by side from
``loco_asr_tpu_torch/csrc/conv_frontend.cu`` and timed on one card in one
process.

    python3 scripts/b2_variants.py [--variants committed,direct,...] [--reps 2]
                                   [--out FILE]

Each variant is the committed source with text edits (``VARIANTS``):

* ``committed``: as it is (streaming 16-byte stores, ``st.global.cs``;
  ``__launch_bounds__(256, 6)``: at most 40 registers, six blocks an SM);
* ``direct``: the first design's stores: each lane's 16-byte chunk written
  from the mma fragments as a group is done (64 bytes of each of 8 rows a
  store instruction, a row's pieces a group apart), no staging;
* ``no_store``: the global stores predicated off by a test on the data
  that never holds, so the kernel computes all and writes nothing;
* ``no_gelu``: the GELU taken out (products, affine, staging, stores);
* ``st_global``: plain 16-byte stores in place of the streaming ones;
* ``free_regs``: ``__launch_bounds__(256)`` alone (ptxas picks the
  registers, 48: five blocks an SM); ``free_regs_st_global`` both.

Each is compiled with ``nvcc`` for ``sm_90a`` into a library of its own
under ``csrc/build/variants/`` (all at once), loaded with ``ctypes`` and
launched through the C entry ``loco_conv_frontend`` (form 1, bfloat16) on
the same inputs.  For each variant: ptxas's registers and spill, the
static SASS count of its ``conv_out_mma_kernel``; at ``chip_smoke.py``'s
B2 shapes, the conversation-length row [1, 2624080] and 200 channels, the
error against the plain version (variants that compute the function:
limit 2^-7 max|plain|), the CUDA-event time of a call (median of 10 runs
of 5 calls, warm L2) and the device time of each launch
(``torch.profiler``), the variants taken in turn, forward then backward,
``--reps`` times.  At [16, 80000] the SM clock and power that
``nvidia-smi`` reads while the committed variant runs back to back.
Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "loco_asr_tpu_torch", "csrc", "conv_frontend.cu")
CASES = (("main", 16, 80000, 512), ("s2s", 8, 160000, 512), ("pipeline", 4, 64000, 512),
         ("odd", 3, 23457, 512), ("conversation", 1, 2624080, 512), ("c200", 4, 64000, 200))

_STORE = ("      __stcs(reinterpret_cast<uint4*>(out + (row0 + 8 * (h & 7) + 64 * (h >> 3)) * F"
          " + f), v);\n")
_GROUP = ("    st[g * MT_CHUNKS + ((4 * q + t) ^ sw)] = va;\n"
          "    st[(g + 8) * MT_CHUNKS + ((4 * q + t) ^ sw)] = vb;\n")
_WRITE = _GROUP + "  }\n  __syncwarp();\n"
# (edits, whether the variant computes the function)
VARIANTS = {
    "committed": ([], True),
    "direct": ([(_WRITE, (
        "    const int fq = o + 32 * q + 8 * t;\n"
        "    const long long ia = ((long long)b * C + ca) * F + fq;\n"
        "    unsigned short* o16 = reinterpret_cast<unsigned short*>(out_);\n"
        "    if (ina) store_chunk(o16, ia, fq, F, va);\n"
        "    if (inb) store_chunk(o16, ia + 64LL * F, fq, F, vb);\n"
        "  }\n  return;\n"))], True),
    "no_store": ([(_STORE, "      if ((v.x ^ v.w) == 0x7fc17fc1u)\n" + _STORE)], False),
    "no_gelu": ([("__device__ __forceinline__ void mma_group(",
                  "#define gelu_as(z) (z)\n__device__ __forceinline__ void mma_group(")], False),
    "st_global": ([(_STORE, "      *reinterpret_cast<uint4*>(out + (row0 + 8 * (h & 7) + 64 * "
                            "(h >> 3)) * F + f) = v;\n")], True),
    "free_regs": ([("__launch_bounds__(OUT_THREADS, MT_BLOCKS_PER_SM)",
                    "__launch_bounds__(OUT_THREADS)")], True),
}
VARIANTS["free_regs_st_global"] = (VARIANTS["free_regs"][0] + VARIANTS["st_global"][0], True)


def variant_source(text: str, edits) -> str:
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"edit does not apply: {old[:60]!r}")
        text = text.replace(old, new, 1)
    return text


def build(names, build_dir: str) -> dict:
    """Compile every variant at once; per variant its library path and
    records (registers, spill, static SASS of the bf16 output kernel)."""
    sys.path.insert(0, REPO)
    from loco_asr_tpu_torch.ops.cuda import _build

    os.makedirs(build_dir, exist_ok=True)
    text = open(SOURCE).read()
    nvcc = _build._nvcc()
    procs = {}
    for name in names:
        src = os.path.join(build_dir, f"{name}.cu")
        with open(src, "w") as f:
            f.write(variant_source(text, VARIANTS[name][0]))
        procs[name] = subprocess.Popen(
            [nvcc, *[a for a in _build.NVCC_FLAGS if a != "--split-compile=0"], "-shared", src,
             "-o", os.path.join(build_dir, f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(nvcc), "cuobjdump")
    out = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log[-4000:]}")
        rec, cur = {}, None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                cur = m.group(1)
            if cur and "conv_out_mma_kernel" in cur:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if m:
                    rec["spill_stores"], rec["spill_loads"] = int(m.group(1)), int(m.group(2))
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    rec["registers"] = int(m.group(1))
        lib = os.path.join(build_dir, f"{name}.so")
        sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                              timeout=300).stdout
        for fn in re.split(r"\n\s*Function : ", sass)[1:]:
            if "conv_out_mma_kernel" in fn.split("\n", 1)[0]:
                rec["sass_instructions"] = len(re.findall(r"/\*[0-9a-f]{4,6}\*/\s+\S", fn))
        out[name] = dict(lib=lib, records=rec)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS), help="comma-separated names")
    ap.add_argument("--reps", type=int, default=2, help="turns over the variants")
    ap.add_argument("--out", default="", help="also write the JSON line to this file")
    args = ap.parse_args()
    names = args.variants.split(",")
    unknown = set(names) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from loco_asr_tpu_torch.ops.cuda import conv_frontend as cf
    from loco_asr_tpu_torch.utils.profiling import kernel_device_ms

    built = build(names, os.path.join(REPO, "loco_asr_tpu_torch", "csrc", "build", "variants"))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    entries = {}
    for name in names:
        fn = ctypes.CDLL(built[name]["lib"]).loco_conv_frontend
        fn.argtypes, fn.restype = [P] * 6 + [I] * 7 + [F, I, I, P], I
        entries[name] = fn
    torch.backends.cudnn.allow_tf32 = False
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def launcher(fn, wav, w, sc, bi):
        b, t = wav.shape
        c = w.shape[0]
        f = (t - 10) // 5 + 1
        chunk = cf.stat_chunk(b, f, sms)
        scratch = torch.empty(b * (-(-f // chunk) * cf.N_STATS + 2 * c + 1),
                              dtype=torch.float32, device="cuda")
        out = torch.empty((b, c, f), dtype=torch.bfloat16, device="cuda")
        args = (wav.data_ptr(), w.data_ptr(), sc.data_ptr(), bi.data_ptr(), scratch.data_ptr(),
                out.data_ptr(), b, t, c, 10, 5, f, chunk, cf.EPS, 1, 1)

        def run():
            code = fn(*args, torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"loco_conv_frontend returned {code}")
            return out
        return run

    def event_ms(fn, reps=10, inner=5):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(inner):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / inner)
        return statistics.median(times)

    g = torch.Generator().manual_seed(2)
    cases, clocks = {}, None
    for case, b, t, c in CASES:
        def randn(*shape, sc=0.3):
            return (torch.randn(*shape, generator=g) * sc).to("cuda", torch.bfloat16)

        wav = randn(b, t, sc=0.1)
        w, sc, bi = randn(c, 1, 10), randn(c, sc=0.2) + 1.0, randn(c, sc=0.1)
        plain = cf.conv1_instance_norm_gelu_plain(wav, w, sc, bi).float()
        limit = 2.0 ** -7 * plain.abs().max().item()
        recs = cases[case] = {"shape": [b, t], "channels": c, "limit": limit}
        for rep in range(args.reps):
            for name in (names if rep % 2 == 0 else names[::-1]):
                run = launcher(entries[name], wav, w, sc, bi)
                r = recs.setdefault(name, dict(event_ms=[], conv_stats_ms=[], conv_out_ms=[]))
                if rep == 0:
                    err = (run().float() - plain).abs().max().item()
                    r["max_abs_err"] = err
                    if VARIANTS[name][1]:
                        r["held"] = err <= limit
                split = kernel_device_ms(run, ("conv_stats", "conv_out"))
                r["event_ms"].append(event_ms(run))
                r["conv_stats_ms"].append(split["conv_stats"])
                r["conv_out_ms"].append(split["conv_out"])
        if case == "main" and "committed" in entries:
            run = launcher(entries["committed"], wav, w, sc, bi)
            smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                    "--format=csv,noheader,nounits", "-lms", "50"],
                                   stdout=subprocess.PIPE, text=True)
            end = time.time() + 1.5
            while time.time() < end:
                for _ in range(200):
                    run()
                torch.cuda.synchronize()
            smi.terminate()
            rows = [r.split(",") for r in smi.communicate()[0].strip().splitlines()[3:-1]]
            clocks = dict(sm_mhz=[float(r[0]) for r in rows if len(r) == 2],
                          power_w=[float(r[1]) for r in rows if len(r) == 2])
        del wav, plain
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    rec = dict(variants={n: built[n]["records"] for n in names}, cases=cases,
               clocks_committed_main=clocks, card=card, torch=torch.__version__)
    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    held = [r["held"] for c in cases.values() for r in c.values()
            if isinstance(r, dict) and "held" in r]
    return 0 if all(held) else 1


if __name__ == "__main__":
    sys.exit(main())
