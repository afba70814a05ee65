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
host's time a call of ``flash_rel_backward`` (B1's backward, B3 + B4 and
the band's two matmuls) in bf16 at [1, 2, 64, 64], where the card
finishes each call before the host issues the next one: the band (L =
160) and mask-only variants, 200 calls each.  Prints one JSON line with
the card's name and power limit.
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
    from loco_asr_tpu_torch.utils.profiling import device_breakdown

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
    rec["backward_host_us"] = {v: host_us_per_call(fa, torch, dev, v == "mask_only", args.calls)
                               for v in ("band", "mask_only")}
    rec["launches_by_form"] = getattr(fa.flash_rel_backward, "launches_by_form", None)
    rec["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip()
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
