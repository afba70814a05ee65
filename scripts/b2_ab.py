#!/usr/bin/env python3
"""Kernel B2 (conv1 + instance norm + GELU) of the port in one checkout, on
the GPU.

    python3 scripts/b2_ab.py [--root CHECKOUT] [--label NAME]

Imports ``loco_asr_tpu_torch`` from ``--root`` (default: this repository),
so that one script measures two checkouts on one card: unpack the other
one (``git archive <commit> loco_asr_tpu_torch``) into a git-ignored
directory and run the script on each in turn, A B B A.

It records, where this process built the checkout's kernel library,
ptxas's registers, spill and static shared memory of each B2 kernel
(``conv_*_kernel``) and the static SASS count of each (``cuobjdump
-sass``).  Then, for bf16 at ``chip_smoke.py``'s ``B2_CASES`` shapes,
at the sequence-parallel step's conversation-length row [1, 2624080]
and at 200 channels, and for f32 at [16, 80000]: the CUDA-event time
of a call (the median of 10 runs of 5 back-to-back calls, warm L2), the
device time of each launch by kernel name (torch.profiler: statistics,
output, the counters' memset), and the error against the plain version
(bf16: limit 2^-7 max|plain|; f32: 1e-4).  Prints one JSON line with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (name, B, T, C): chip_smoke.py's B2_CASES, then the conversation-length
# row of a sequence-parallel step and a channel count that is not a
# multiple of the output tile's
CASES = (("main", 16, 80000, 512), ("s2s", 8, 160000, 512), ("pipeline", 4, 64000, 512),
         ("odd", 3, 23457, 512), ("conversation", 1, 2624080, 512), ("c200", 4, 64000, 200))


def event_ms(torch, fn, reps: int = 10, inner: int = 5) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` calls, a call."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def build_records(build) -> list:
    """ptxas's record of each B2 kernel in the build log, with its static
    SASS count; empty when the library was loaded from an earlier build."""
    recs, cur = [], None
    for line in build.build_log.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"(_Z\w*conv_\w+_kernel\w*)", line)
            cur = dict(kernel=m.group(1)) if m else None
            if cur:
                recs.append(cur)
        elif cur is not None and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif cur is not None and "Used" in line and "registers" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            cur["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if recs and os.path.exists(tool):
        sass = subprocess.run([tool, "-sass", build.library_path()], capture_output=True,
                              text=True, timeout=300).stdout
        for fn in re.split(r"\n\s*Function : ", sass)[1:]:
            name = fn.split("\n", 1)[0].strip()
            for r in recs:
                if r["kernel"] == name:
                    r["sass_instructions"] = len(re.findall(r"/\*[0-9a-f]{4,6}\*/\s+\S", fn))
    return recs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=REPO, help="checkout whose loco_asr_tpu_torch is timed")
    ap.add_argument("--label", default="", help="name of the checkout in the JSON line")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [root]

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from loco_asr_tpu_torch.ops.cuda import _build
    from loco_asr_tpu_torch.ops.cuda import conv_frontend as cf
    from loco_asr_tpu_torch.utils.profiling import kernel_device_ms

    package = os.path.dirname(os.path.abspath(cf.__file__))
    assert package.startswith(root), f"imported {package}, not from {root}"
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    rec = dict(label=args.label, root=root, torch=torch.__version__,
               build_s=_build.build_seconds, records=build_records(_build), cases={})
    g = torch.Generator().manual_seed(2)
    for name, b, t, c in CASES:
        for dtype in ((torch.bfloat16, torch.float32) if name == "main" else (torch.bfloat16,)):
            def randn(*shape, sc=0.3):
                return (torch.randn(*shape, generator=g) * sc).to("cuda", dtype)

            wav = randn(b, t, sc=0.1)
            w, sc, bi = randn(c, 1, 10), randn(c, sc=0.2) + 1.0, randn(c, sc=0.1)

            def run():
                return cf.conv1_instance_norm_gelu(wav, w, sc, bi)

            out = run()
            plain = cf.conv1_instance_norm_gelu_plain(wav, w, sc, bi)
            err = (out.float() - plain.float()).abs().max().item()
            lim = (2.0 ** -7 * plain.float().abs().max().item() if dtype is torch.bfloat16
                   else 1e-4)
            del out, plain
            split = kernel_device_ms(run, ("conv_stats", "conv_out"), optional=("Memset",))
            key = name if dtype is torch.bfloat16 else f"{name}_f32"
            rec["cases"][key] = dict(shape=[b, t], channels=c, dtype=str(dtype), max_abs_err=err,
                                     limit=lim, held=err <= lim, event_ms=event_ms(torch, run),
                                     device_ms=sum(split.values()), device_ms_by_launch=split)
            del wav
    rec["launches_by_form"] = getattr(cf.conv1_instance_norm_gelu, "launches_by_form", None)
    rec["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip()
    print(json.dumps(rec))
    return 0 if all(r["held"] for r in rec["cases"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
