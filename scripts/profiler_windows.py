#!/usr/bin/env python3
"""Two device measurements on the GPU that ``chip_smoke.py`` rests on.

    python3 scripts/profiler_windows.py [--seconds 240] [--out DIR]

1. The full-width ASR train step (``SpeechT5Config(vocab_size=256)``, B = 8
   windows of <= 10 s from ``exp/loco/asr_corpus/train``, flash, frozen
   feature encoder) in bf16 compute and in f32: 10 steps' wall ms with
   ``torch.backends.cudnn.benchmark`` off and on, the host ms of
   ``cast_compute`` alone, and one step traced with CPU and CUDA activity:
   kernels and runtime calls, the device's busy ms (the union of kernel
   intervals), and the idle gaps over 0.3 ms with the host ops open at
   their middle.  With ``--out`` the traced step's tables (by self CPU and
   by device time, grouped by input shape) go to ``DIR``.
2. How torch.profiler records kernels in short windows: for ``--seconds``,
   windows of 5 launches of B1's bf16 form ([16, 12, 249, 64], L = 160),
   spaced by ~0.1 s of f32 GEMMs, in turn: opened just before the
   launches and closed at once after the synchronize (``at_once``),
   closed 50 ms after it (``wait_after``), and opened 50 ms before the
   launches (``wait_before``, as ``chip_smoke.profiled`` does).  Counts the windows, those that recorded no
   B1 launch, and the launches recorded of the 5; prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

WAIT_S = 0.05


def trace_events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def step_trace(dev, host_batches, out_dir) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from loco_asr_tpu_torch.models.speecht5 import model as st5
    from loco_asr_tpu_torch.models.speecht5.config import SpeechT5Config
    from loco_asr_tpu_torch.parallel import train

    cfg = SpeechT5Config(vocab_size=256)
    res = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", None)):
        model = st5.asr_model_init(cfg, seed=0, device=dev)
        tx = train.adamw(1e-4, mu_dtype=dtype)
        opt = tx.init(train.trainable_params(model, True))
        step = train.make_asr_train_step(cfg, tx, attn_impl="flash", freeze_feature_encoder=True,
                                         compute_dtype=dtype)
        gen = torch.Generator(device=dev).manual_seed(0)
        batches = [{k: torch.as_tensor(hb[k], device=dev)
                    for k in ("input_values", "attention_mask", "labels")} for hb in host_batches]
        for bench in (False, True):
            torch.backends.cudnn.benchmark = bench
            ms = []
            for bt in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(model, opt, bt, gen)["loss"].item()
                ms.append((time.perf_counter() - t0) * 1e3)
            res[f"{name}_median_step_ms_cudnn_benchmark_{int(bench)}"] = statistics.median(ms[3:])
        torch.backends.cudnn.benchmark = False
        if dtype is not None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                train.cast_compute(model, batches[0], dtype)
            torch.cuda.synchronize()
            res["cast_compute_ms"] = (time.perf_counter() - t0) * 1e3 / 10
        step(model, opt, batches[0], gen)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t0 = time.perf_counter()
            step(model, opt, batches[0], gen)["loss"].item()
            wall = (time.perf_counter() - t0) * 1e3
        if out_dir:
            ka = prof.key_averages(group_by_input_shape=True)
            for sort, tag in (("self_cpu_time_total", "cpu"), ("self_device_time_total", "cuda")):
                with open(os.path.join(out_dir, f"step_{name}_{tag}.txt"), "w") as f:
                    f.write(ka.table(sort_by=sort, row_limit=40, max_name_column_width=90,
                                     max_shapes_column_width=120))
        evs = trace_events(prof)
        spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in evs
                       if e.get("cat") == "kernel")
        busy, end = 0.0, float("-inf")
        for a, b in spans:
            if b > end:
                busy += b - max(a, end)
                end = b
        gaps = sorted(((a1 - b0, b0) for (_, b0), (a1, _) in zip(spans, spans[1:])
                       if a1 - b0 > 300), reverse=True)
        cpu_ops = [e for e in evs if e.get("cat") == "cpu_op"]
        res[name] = dict(
            wall_ms=wall, kernels=len(spans),
            runtime_calls=sum(e.get("cat") == "cuda_runtime" for e in evs),
            busy_ms=busy / 1e3, gaps_over_0_3_ms=len(gaps), gap_ms_sum=sum(g for g, _ in gaps) / 1e3,
            top_gaps=[dict(ms=g / 1e3, ops=[e["name"] for e in cpu_ops
                                            if e["ts"] <= at + g / 2 <= e["ts"] + e.get("dur", 0)][-3:])
                      for g, at in gaps[:6]])
        del model, opt
    return res


def window_loss(dev, seconds: float) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from loco_asr_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator().manual_seed(0)
    q, k, v = ((torch.randn(16, 12, 249, 64, generator=g) * 0.3).to(dev, torch.bfloat16)
               for _ in range(3))
    pe = (torch.randn(320, 64, generator=g) * 0.3).to(dev, torch.bfloat16)
    vl = torch.full((16,), 249, dtype=torch.int32, device=dev)

    def fn():
        return fa.flash_rel_forward(q, k, v, pe, vl, causal=False, scale=1.0)

    def window(before_s: float, after_s: float):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(before_s)
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            time.sleep(after_s)
        return prof

    def recorded(prof) -> int:
        return sum(e.count for e in prof.key_averages()
                   if "flash_rel_fwd" in e.key and e.device_time_total > 0)

    a = torch.ones(4096, 4096, device=dev)
    waits = {"at_once": (0.0, 0.0), "wait_after": (0.0, WAIT_S), "wait_before": (WAIT_S, 0.0)}
    tally = {m: dict(windows=0, empty=0, records=dict()) for m in waits}
    fn()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for mode in tally:
            for _ in range(50):
                torch.mm(a, a)
            torch.cuda.synchronize()
            prof = window(*waits[mode])
            n = recorded(prof)
            t = tally[mode]
            t["windows"] += 1
            t["empty"] += n == 0
            t["records"][str(n)] = t["records"].get(str(n), 0) + 1
    return dict(seconds=seconds, wait_s=WAIT_S, launches_a_window=5, **tally)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=240.0)
    ap.add_argument("--out", default=None, help="directory for the traced step's tables")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("profiler_windows: no CUDA device available", file=sys.stderr)
        return 1
    from loco_asr_tpu_torch.ops.cuda import _build

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda")
    smi = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            timeout=60, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] {smi}; torch {torch.__version__}", flush=True)
    _build.build()
    _build.library()
    with tempfile.TemporaryDirectory() as tmp:
        host_batches = cs.asr_host_batches(cs.relocate_corpus(tmp)["train"], n=14)[1:]
    cs.warm_up(dev)
    print(f"[step_trace] {json.dumps(step_trace(dev, host_batches, args.out))}", flush=True)
    print(f"[windows] {json.dumps(window_loss(dev, args.seconds))}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
