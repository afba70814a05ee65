"""Full SLURP evaluation sweep on the GPU: the port of
``loco_asr_tpu.pipelines.slurp_sweep``.  Trains the intent classifier
(:mod:`.train_classifier`) for every modality x pooling combination and
aggregates the results.

Same flags as the JAX pipeline, plus ``--device`` (default cuda; cpu runs
on the CPU), which is passed on to every run.  Each run's artifacts land
in the usual ``checkpoints/`` + ``results/`` layout; the table goes to
``results/{version}/sweep.json`` and is printed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="SLURP modality x pooling sweep (CUDA)")
    p.add_argument("--version", "-v", choices=["fine_tuned", "base"],
                   default="fine_tuned")
    p.add_argument("--modalities", nargs="+", default=["text", "audio"])
    p.add_argument("--poolings", nargs="+",
                   default=["average", "max", "attention"])
    p.add_argument("--folder", default=None)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--hidden_dims", type=int, nargs="*", default=[])
    p.add_argument("--extra", nargs="*", default=[],
                   help="extra args forwarded to train_classifier")
    p.add_argument("--device", default="cuda",
                   help="torch device of every run; 'cpu' runs on the CPU")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from . import train_classifier

    results = {}
    for modality in args.modalities:
        for pooling in args.poolings:
            key = f"{modality}/{pooling}"
            print(f"=== sweep: {key} ===", file=sys.stderr)
            argv_run = ["-m", modality, "-p", pooling, "-v", args.version,
                        "--epochs", str(args.epochs),
                        "--batch_size", str(args.batch_size), "--device", args.device]
            if args.folder:
                argv_run += ["--folder", args.folder]
            if args.hidden_dims:
                argv_run += ["--hidden_dims", *map(str, args.hidden_dims)]
            argv_run += args.extra
            rc = train_classifier.main(argv_run)
            metrics_path = os.path.join("results", args.version, modality,
                                        pooling, "logs", "metrics.jsonl")
            best = None
            if rc == 0 and os.path.exists(metrics_path):
                with open(metrics_path) as f:
                    epochs = [json.loads(line) for line in f if line.strip()]
                vals = [e for e in epochs if "val_acc" in e]
                if vals:
                    best = max(vals, key=lambda e: e["val_acc"])
            results[key] = {
                "status": "ok" if rc == 0 else f"failed({rc})",
                "best_val_acc": best["val_acc"] if best else None,
                "best_epoch": best["epoch"] if best else None,
            }

    out_path = os.path.join("results", args.version, "sweep.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)

    print(f"\n{'combo':<20} {'best val acc':>12} {'epoch':>6}")
    for key, r in results.items():
        acc = f"{r['best_val_acc']*100:.2f}%" if r["best_val_acc"] else r["status"]
        print(f"{key:<20} {acc:>12} {str(r['best_epoch'] or '-'):>6}")
    print(f"\nsaved {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
