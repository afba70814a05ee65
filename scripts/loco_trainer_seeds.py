#!/usr/bin/env python3
"""Train the LoCo experiment's ASR model over several seeds with one
package's ``train_asr`` and decode each with the reference's trained fusion
LM: how the ASR half of the experiment depends on the trainer and on the
random streams.

    python scripts/loco_trainer_seeds.py --package jax --out_dir D --seeds 1 2
    python scripts/loco_trainer_seeds.py --package port --out_dir D --seeds 0 1 2 \
        [--device cuda]

For each seed: the experiment's corpus (``make_asr_corpus`` at its
defaults, seed 0, so train and dev are the recorded run's), ``train_asr``
with the experiment's ASR flags (``--tiny``, the 3-layer conv front end,
batch 8, 4000 steps, lr 1e-3) and ``--seed <seed>``, starting from
``fixtures/loco_reference/asr_init.npz`` (the JAX ``asr_init`` of
``PRNGKey(0)``, which both packages read); then
``loco_experiment --stage asr --skip_training --fusion_weights 1.0`` with
the reference's fusion LM (``exp/loco/asr_lm/ckpt`` for JAX, its ``.npz``
copy in ``fixtures/loco_reference/asr_lm`` for the port).  The seed moves
the dropout and SpecAugment streams; data order is seeded by it as well,
in both packages alike.

Prints one JSON line per seed (the mean training loss over steps
3000-4000, the four decodes' WERs, wall seconds) and writes them to
``{out_dir}/seeds.json``.  ``--package jax`` needs JAX (run it on a CPU);
``--package port`` runs on the GPU unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CONV_OVER = {"conv_dim": [64, 64, 64], "conv_stride": [5, 4, 2],
             "conv_kernel": [10, 8, 4], "max_speech_positions": 2048}
SHARED_INIT = os.path.join(ROOT, "fixtures", "loco_reference", "asr_init.npz")
STEPS = 4000          # the recipe's


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--package", choices=["jax", "port"], required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--device", default="cuda", help="the port's device")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from loco_asr_tpu.data.synthetic_conversations import make_asr_corpus
        from loco_asr_tpu.pipelines import loco_experiment, train_asr
        lm_ckpt, device = os.path.join(ROOT, "exp", "loco", "asr_lm", "ckpt"), []
    else:
        from loco_asr_tpu_torch.data.synthetic_conversations import make_asr_corpus
        from loco_asr_tpu_torch.pipelines import loco_experiment, train_asr
        lm_ckpt = os.path.join(ROOT, "fixtures", "loco_reference", "asr_lm")
        device = ["--device", args.device]

    records = []
    for seed in args.seeds:
        out = os.path.join(args.out_dir, f"seed{seed}")
        tr_dir, _ = make_asr_corpus(os.path.join(out, "asr_corpus"), n_train=200,
                                    n_dev=12, n_utts=10, seed=0)
        cfg_path = os.path.join(out, "asr_config.json")
        with open(cfg_path, "w") as f:
            json.dump(CONV_OVER, f)
        t0 = time.perf_counter()
        rc = train_asr.main([
            "--config_json", cfg_path, "--train_dir", tr_dir, "--tiny",
            "--tokenizer", "char", "--batch_size", "8", "--steps", str(STEPS),
            "--out_dir", os.path.join(out, "asr"), "--max_seconds", "4.0",
            "--eval_every", str(10 * STEPS), "--save_every", str(STEPS),
            "--lr", "1e-3", "--seed", str(seed), "--checkpoint", SHARED_INIT, *device])
        train_s = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"train_asr (seed {seed}) returned {rc}")
        shutil.copytree(lm_ckpt, os.path.join(out, "asr_lm", "ckpt"), dirs_exist_ok=True)
        t0 = time.perf_counter()
        rc = loco_experiment.main(["--out_dir", out, "--stage", "asr", "--skip_training",
                                   "--fusion_weights", "1.0", *device])
        decode_s = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"loco_experiment (seed {seed}) returned {rc}")
        with open(os.path.join(out, "asr", "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        late = [m["loss"] for m in logged if "loss" in m and 3000 <= m["step"] <= 4000]
        with open(os.path.join(out, "results.json")) as f:
            res = json.load(f)["asr"]
        rec = dict(package=args.package, seed=seed,
                   mean_loss_3000_4000=float(np.mean(late)) if late else None,
                   final_loss=[m["loss"] for m in logged if "loss" in m][-1],
                   **{f"{k}_{m}": res[k][m] for k in ("nofusion", "carry", "nocarry", "oracle")
                      for m in ("wer_clean", "wer_degraded", "name_recovery")},
                   train_s=train_s, decode_s=decode_s)
        records.append(rec)
        print(json.dumps(rec), flush=True)
    with open(os.path.join(args.out_dir, "seeds.json"), "w") as f:
        json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
