#!/usr/bin/env python3
"""The full-width ASR train step of the port in one checkout, on the GPU.

    python3 scripts/asr_step_ab.py [--root CHECKOUT] [--label NAME]

Imports ``loco_asr_tpu_torch`` from ``--root`` (default: this repository),
so that one script times two checkouts on one card: unpack the other one
(``git archive <commit> loco_asr_tpu_torch``) into a git-ignored directory
and run the script on each in turn, A B B A.  It times what
``chip_smoke.py``'s phase 16 (b) times: SpeechT5-base (vocabulary 256),
frozen feature encoder, flash attention, AdamW, on 13 batches of 8
conversation windows of <= 10 s from the committed corpus, first with
bf16 compute and bf16 first moments, then in float32; the median of the
steps after the first three, the device's busy share and kernel time of
one profiled step, and the step's device time by kernel group.  Then the
device time a launch (torch.profiler) and the CUDA-event time a call of
B1 in bf16 at phase 16 (a)'s shapes ([16, 12, 249, 64], L = 160, two
thirds of the rows padded; mask-only [8, 12, 160, 64] over 500 keys, the
cross-attention's; [16, 6, 249, 128], L = 160) and of B3 and B4 at the
training shape ([8, 12, 500, 64], L = 160; mask-only [8, 12, 160, 64] over
500 keys).  Then the host's time a call of ``flash_rel_forward`` (B1) and
of ``flash_rel_backward`` (B1's backward, B3 + B4 and the band's two
matmuls) in bf16 at [1, 2, 64, 64], where the card finishes each call
before the host issues the next one: the band (L = 160) and mask-only
variants, the median of 5 runs of 200 calls, with each call's device
time beside it.  Then one call of each launch path (B1, B3 + B4, B5) is
split into the wrapper's Python (checks, allocation, the C call's
arguments) and the C entry (maps encoded where the form has them, kernels
launched), and, where the checkout's library times a tensor map's
encoding (``loco_tensor_map_encode_us``), the maps' share.  Prints one
JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host_us_per_call(fa, torch, dev, mask_only: bool, calls: int) -> float:
    g = torch.Generator(device="cpu").manual_seed(0)
    q, k, v, dout = (torch.randn(1, 2, 64, 64, generator=g).to(dev, torch.bfloat16)
                     for _ in range(4))
    pe = torch.randn(2 if mask_only else 320, 64, generator=g).to(dev, torch.bfloat16)
    vl = torch.tensor([64], dtype=torch.int32, device=dev)
    out, lse = fa.flash_rel_forward(q, k, v, None if mask_only else pe, vl, causal=False,
                                    scale=0.125)

    def call():
        return fa.flash_rel_backward(q, k, v, pe, vl, out, lse, dout, causal=False,
                                     scale=0.125, need_dpe=not mask_only, mask_only=mask_only)

    for _ in range(10):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def kernel_times(fa, torch, dev, kernel_device_ms, event_ms) -> dict:
    """Device ms a launch and CUDA-event ms a call of bf16 B1 and of B3 and
    B4 (one backward call launches both) at phase 16 (a)'s shapes."""
    g = torch.Generator().manual_seed(16)

    def randn(*shape, sc=0.3):
        return (torch.randn(*shape, generator=g) * sc).to(dev, torch.bfloat16)

    out = {}
    for name, (b, h, tq, tk, d, L, vls) in {
            "b1_band": (16, 12, 249, 249, 64, 160, [249] * 10 + [230, 200, 180, 120, 60, 17]),
            "b1_cross_mask_only": (8, 12, 160, 500, 64, 0, [500] * 6 + [430, 310]),
            "b1_band_d128": (16, 6, 249, 249, 128, 160, [249] * 10 + [230, 200, 180, 120, 60,
                                                                      17])}.items():
        q, k, v = randn(b, h, tq, d), randn(b, h, tk, d), randn(b, h, tk, d)
        pe = randn(2 * L, d) if L else None
        vl = torch.tensor(vls, dtype=torch.int32, device=dev)

        def run():
            with torch.no_grad():
                return fa.flash_rel_forward(q, k, v, pe, vl, causal=False, scale=1.0)

        out[name] = dict(device_ms=kernel_device_ms(run, ("flash_rel_fwd",))["flash_rel_fwd"],
                         event_ms=event_ms(run))
    for name, (tq, L) in {"b34_band": (500, 160), "b34_cross_mask_only": (160, 0)}.items():
        mask_only = L == 0
        q, gg = randn(8, 12, tq, 64), randn(8, 12, tq, 64, sc=1.0)
        k, v = randn(8, 12, 500, 64), randn(8, 12, 500, 64)
        pe = torch.zeros(2, 64, dtype=torch.bfloat16, device=dev) if mask_only else randn(2 * L,
                                                                                          64)
        vl = torch.tensor([500] * 6 + [430, 310], dtype=torch.int32, device=dev)
        o, lse = fa.flash_rel_forward(q, k, v, None if mask_only else pe, vl, causal=False,
                                      scale=1.0)

        def run():
            return fa.flash_rel_backward(q, k, v, pe, vl, o, lse, gg, causal=False, scale=1.0,
                                         need_dpe=not mask_only, mask_only=mask_only)

        split = kernel_device_ms(run, ("flash_rel_bwd_dq", "flash_rel_bwd_dkv"))
        out[name] = dict(b3_device_ms=split["flash_rel_bwd_dq"],
                         b4_device_ms=split["flash_rel_bwd_dkv"], event_ms=event_ms(run))
    return out


def forward_host_us(fa, torch, dev, kernel_device_ms, mask_only: bool, calls: int) -> dict:
    """A B1 call's time at [1, 2, 64, 64] in bf16 when the card finishes it
    before the host issues the next: wall microseconds a call, the median
    and the least of 5 runs of ``calls`` back to back (the host's load
    varies within a process), and the launch's device microseconds."""
    g = torch.Generator(device="cpu").manual_seed(0)
    q, k, v = (torch.randn(1, 2, 64, 64, generator=g).to(dev, torch.bfloat16) for _ in range(3))
    pe = None if mask_only else torch.randn(320, 64, generator=g).to(dev, torch.bfloat16)
    vl = torch.tensor([64], dtype=torch.int32, device=dev)

    def call():
        with torch.no_grad():
            return fa.flash_rel_forward(q, k, v, pe, vl, causal=False, scale=0.125)

    for _ in range(10):
        call()
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / calls * 1e6)
    return dict(wall_us=statistics.median(walls), least_wall_us=min(walls),
                device_us=kernel_device_ms(call, ("flash_rel_fwd",))["flash_rel_fwd"] * 1e3)


def host_split(fa, fc, build, torch, dev, reps: int = 200) -> dict:
    """One call of each launch path in bf16 at [1, 2, 64, 64] (B1 and B3 +
    B4 with the band at L = 160, B5 causal; at head dim 64 the wgmma form
    where the checkout has one) split on the host: the wrapper's Python
    (the launch path with a library whose entries return at once), the C
    entry called with the same arguments (tensor maps encoded, kernels
    launched; the card finishes each call before the next is issued) and,
    where the library times one (``loco_tensor_map_encode_us``), its maps'
    encoding, in microseconds a call: the median of 5 runs of ``reps``."""
    lib = build.library()
    g = torch.Generator(device="cpu").manual_seed(1)
    q, k, v, dout = (torch.randn(1, 2, 64, 64, generator=g).to(dev, torch.bfloat16)
                     for _ in range(4))
    pe = torch.randn(320, 64, generator=g).to(dev, torch.bfloat16)
    vl = torch.tensor([64], dtype=torch.int32, device=dev)
    lse = torch.zeros(1, 2, 64, device=dev)
    paths = {
        "B1": (lambda: fa._launch_forward(q, k, v, pe, vl, False, 0.125, mask_only=False), 4),
        "B3/B4": (lambda: fa._launch_backward(q, k, v, pe, vl, lse, lse, dout, False, 0.125,
                                              mask_only=False), 5),
        "B5": (lambda: fc._launch(q, k, v, (1, 2, 64, 64, 64), t_axis=2, causal=True,
                                  scale=0.125, what="flash_forward"), 3),
    }

    class Recorder:
        def __init__(self):
            self.calls = []

        def __getattr__(self, name):
            return lambda *a: (self.calls.append((name, a)), 0)[1]

    def per_call(fn):
        for _ in range(10):
            fn()
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) / reps * 1e6)
        return statistics.median(runs)

    timed = hasattr(lib, "loco_tensor_map_encode_us")
    encode_us = lib.loco_tensor_map_encode_us(q.data_ptr(), 1000) if timed else None
    out = dict(encode_us_a_map=encode_us)
    real = build.library
    for name, (path, maps) in paths.items():
        rec = Recorder()
        build.library = lambda: rec
        try:
            wrapper_us = per_call(path)
            rec.calls.clear()
            kept = path()   # the outputs whose addresses the recorded call holds
        finally:
            build.library = real
        # the launch's C entry (the mma.sync form's shared-memory query aside)
        (entry, args), = [c for c in rec.calls if not c[0].endswith("smem_bytes")]
        fn = getattr(lib, entry)
        c_us = per_call(lambda: build.check(fn(*args), name))
        out[name] = dict(wrapper_us=wrapper_us, c_entry_us=c_us)
        if timed:
            out[name].update(maps=maps, encode_us=maps * encode_us,
                             launch_us=c_us - maps * encode_us)
        del kept
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=REPO, help="checkout whose loco_asr_tpu_torch is timed")
    ap.add_argument("--label", default="", help="name of the checkout in the JSON line")
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, REPO]

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from loco_asr_tpu_torch.models.speecht5 import model as st5
    from loco_asr_tpu_torch.models.speecht5.config import SpeechT5Config
    from loco_asr_tpu_torch.ops.cuda import flash_attention as fa
    from loco_asr_tpu_torch.parallel import train
    from loco_asr_tpu_torch.ops.cuda import _build
    from loco_asr_tpu_torch.ops.cuda import flash_causal as fc
    from loco_asr_tpu_torch.utils.profiling import device_breakdown, kernel_device_ms

    package = os.path.dirname(os.path.abspath(fa.__file__))
    assert package.startswith(root), f"imported {package}, not from {root}"
    dev = torch.device("cuda")
    bf = torch.bfloat16
    with tempfile.TemporaryDirectory() as tmp:
        host = chip_smoke.asr_host_batches(chip_smoke.relocate_corpus(tmp)["train"])
    cfg = SpeechT5Config(vocab_size=256)

    def to_dev(hb):
        return {k: torch.as_tensor(hb[k], device=dev)
                for k in ("input_values", "attention_mask", "labels")}

    rec = dict(label=args.label, root=root, torch=torch.__version__)
    for name, dtype, mu in (("bf16", bf, bf), ("f32", None, None)):
        model = st5.asr_model_init(cfg, seed=0, device=dev)
        tx = train.adamw(1e-4, mu_dtype=mu)
        opt = tx.init(train.trainable_params(model, True))
        step = train.make_asr_train_step(cfg, tx, attn_impl="flash",
                                         freeze_feature_encoder=True, compute_dtype=dtype)
        gen = torch.Generator(device=dev).manual_seed(0)
        batches = [to_dev(hb) for hb in host[1:14]]
        ms = []
        for bt in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(model, opt, bt, gen)["loss"].item()
            ms.append((time.perf_counter() - t0) * 1e3)
        prof = device_breakdown(lambda: step(model, opt, batches[0], gen))
        rec[name] = dict(median_step_ms=statistics.median(ms[3:]), step_ms=ms,
                         busy_share=prof["busy_share"], device_ms=prof["kernel_ms_sum"],
                         wall_ms=prof["wall_ms"], kernels=prof["kernels"],
                         groups_ms=prof["groups_ms"])
        del model, opt, step, batches
        torch.cuda.empty_cache()
    rec["kernels_bf16"] = kernel_times(fa, torch, dev, kernel_device_ms, chip_smoke.time_ms)
    rec["forward_host_us"] = {v: forward_host_us(fa, torch, dev, kernel_device_ms,
                                                 v == "mask_only", args.calls)
                              for v in ("band", "mask_only")}
    rec["backward_host_us"] = {v: host_us_per_call(fa, torch, dev, v == "mask_only", args.calls)
                               for v in ("band", "mask_only")}
    rec["host_split"] = host_split(fa, fc, _build, torch, dev)
    rec["launches_by_form"] = {
        "B1": getattr(fa.flash_rel_forward, "launches_by_form", None),
        "B3/B4": getattr(fa.flash_rel_backward, "launches_by_form", None)}
    rec["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip()
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
