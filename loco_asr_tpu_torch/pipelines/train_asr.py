"""Fine-tune SpeechT5 ASR on a Kaldi-format corpus on one GPU or on a mesh
of ranks: the port of ``loco_asr_tpu.pipelines.train_asr``.

CLI (the JAX trainer's flags, plus ``--device``):
  --train_dir --dev_dir --out_dir --checkpoint --tokenizer
  --vocab_size --batch_size --steps --lr --warmup_steps --weight_decay
  --grad_clip --grad_accum --eval_every --save_every --max_seconds
  --max_label_len --conversation_seconds --resume --attn_impl {dense,flash}
  --freeze_feature_encoder --seed --tiny --config_json --decode_max_len
  --eval_batches --optimizer {adamw,adafactor} --nan_recovery
  --nan_inject_step --device (default cuda; cpu runs the plain versions)

Each step is ``parallel.train.make_asr_train_step`` (with ``--attn_impl
flash``: kernels B1, B3/B4 and B5 in every step, B2 when the feature
encoder is frozen).  The training batches come through
``utils.prefetch.prefetch(..., depth=4)``: a worker thread decodes (a
wav.scp pipe such as ``fisher_prep``'s ``sph_decode`` lines), resamples
and pads ahead of the steps.  Every ``--eval_every`` steps and at the end it logs
dev loss and greedy-decode WER; ``metrics.jsonl`` gets a training line
every 50 steps with the running ``trunc_*`` totals of data cut at the
caps; ``{out_dir}/ckpt`` holds ``step_{N}.npz`` and ``status.json``, and
``--resume`` continues from the latest.

Mixed precision as in JAX: ``--compute_dtype bfloat16`` runs the forward
and backward in bf16 (the kernels' bf16 forms) on float32 master weights
and optimizer state (``parallel.train.cast_compute``); ``--dtype
bfloat16`` keeps the weights (and so Adam's moments) in bf16, with each op
in the promotion of its operands' dtypes; ``--opt_mu_dtype bfloat16``
stores Adam's first moment in bf16.  Checkpoints hold bf16 leaves as the
JAX package's ``.npz`` does, and ``--resume`` reads them back.

``--remat {full,dots,hybrid,lite}`` (bare ``--remat``: full) runs the
encoder layers under a rematerialization policy of ``ops/remat.py``, with
the same numbers.  The long-context recipe of the JAX trainer runs as it
is: ``--conversation_seconds 164 --attn_impl flash --remat lite``.

``--checkpoint`` takes every source of ``common.load_speecht5_params``:
a JAX ``.npz``, a training directory, an HF directory, ``.safetensors`` or
torch state dict, a fairseq checkpoint.  ``--optimizer adafactor`` is the
JAX ``adafactor`` (``parallel/train.py``; its state is checkpointed and
resumed as AdamW's).  ``--nan_recovery``: a step whose loss is not finite
is logged (``event="nan_rollback"``), its batch skipped and the latest
checkpoint (or, before the first save, the starting state) put back;
``--nan_inject_step N`` fills step N's waveform with NaN, once.

``--mesh data,fsdp,tensor`` of more than one rank trains sharded
(``parallel/``): as a plain command the trainer starts that many local
ranks itself, under ``torchrun`` each process is a rank
(``parallel/launch.py``); each rank runs the kernels on its own batch rows
and, under the tensor axis, its own heads.  Rank 0 writes
``metrics.jsonl``, ``status.json`` and the gathered ``.npz`` steps in the
single-device layout, and ``--resume`` re-shards them.  The dev
evaluation decodes each rank's share of the dev batches on gathered
weights, and rank 0 scores them (JAX decodes on the sharded weights).

``--attn_impl ring|ulysses`` trains sequence-parallel over ``--sp_devices``
ranks (0: every rank), on a ("data", "sequence") mesh whose data axis
absorbs the ranks left over (``common.sp_layout``; a ``--mesh`` other than
-1,1,1 must name the sequence axis's ranks, as the JAX trainer needs):
each rank holds the whole model, runs the prenet and the decoder on the
whole window and the encoder layers on its block of the frames, whose
count must divide by the sequence size (JAX's error otherwise: with the
base conv stack a whole-second window has an odd count).  The dev
evaluation splits the dev batches over every rank, as on a mesh.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train SpeechT5 ASR on Kaldi data (CUDA)")
    p.add_argument("--train_dir", required=True, help="Kaldi data dir (train)")
    p.add_argument("--dev_dir", default=None, help="Kaldi data dir (dev)")
    p.add_argument("--out_dir", default="exp/asr")
    p.add_argument("--checkpoint", default=None,
                   help="init weights: a .npz of the JAX package's params, a "
                        "training directory, HF weights (directory, .safetensors, "
                        "torch state dict) or a fairseq checkpoint; random if omitted")
    p.add_argument("--tokenizer", default="char")
    p.add_argument("--vocab_size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup_steps", type=int, default=500)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--grad_clip", type=float, default=None,
                   help="global-norm gradient clipping threshold")
    p.add_argument("--optimizer", choices=["adamw", "adafactor"], default="adamw",
                   help="adafactor: factored second moments, no first moment")
    p.add_argument("--opt_mu_dtype", choices=["float32", "bfloat16"],
                   default="float32", help="dtype of Adam's first moment")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="micro-batches per optimizer step (sum-form, exact "
                        "token-mean equivalence; batch_size must divide)")
    p.add_argument("--eval_every", type=int, default=1000)
    p.add_argument("--save_every", type=int, default=1000)
    p.add_argument("--max_seconds", type=float, default=20.0)
    p.add_argument("--max_label_len", type=int, default=None,
                   help="label token cap (default 128 per utterance; "
                        "max(128, 16 per second) in conversation mode)")
    p.add_argument("--conversation_seconds", type=float, default=0.0,
                   help="train on conversation windows of up to this many "
                        "seconds (chronological utterances of a recording, "
                        "audio and transcripts concatenated) instead of "
                        "single utterances")
    p.add_argument("--mesh", default="-1,1,1",
                   help="data,fsdp,tensor mesh shape; more than one rank trains "
                        "sharded (local ranks, or the torchrun group)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32",
                   help="dtype of the weights (and so of Adam's moments)")
    p.add_argument("--compute_dtype", choices=["same", "bfloat16"], default="same",
                   help="mixed precision: forward and backward in this dtype on "
                        "float32 master weights")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--remat", nargs="?", const="full", default="none",
                   choices=["none", "full", "dots", "hybrid", "lite"],
                   help="rematerialize encoder intermediates on backward: "
                        "'full' keeps only each layer's input (bare --remat), "
                        "'dots' the matrix products, 'hybrid' those and the "
                        "dropout masks, 'lite' all but the FFN chain "
                        "(ops/remat.py); the numbers do not change")
    p.add_argument("--nan_recovery", action="store_true",
                   help="on a non-finite loss, skip the batch and restore the "
                        "last checkpoint (or the starting state)")
    p.add_argument("--nan_inject_step", type=int, default=None,
                   help="fault injection: step N's waveform is NaN (once)")
    p.add_argument("--attn_impl", default="dense",
                   choices=["dense", "flash", "ring", "ulysses"],
                   help="'flash' runs the attention kernels (B1, B3/B4, B5); "
                        "'ring' / 'ulysses' shard the encoder frames over "
                        "--sp_devices ranks (sequence parallelism)")
    p.add_argument("--sp_devices", type=int, default=0,
                   help="ranks of the sequence axis under --attn_impl ring|ulysses "
                        "(0: every rank; the data axis takes the rest)")
    p.add_argument("--freeze_feature_encoder", action="store_true",
                   help="freeze the conv feature extractor (no gradients, "
                        "no updates; its first layer then runs kernel B2)")
    p.add_argument("--no_unroll_layers", action="store_true",
                   help="a compile knob of the JAX trainer; no counterpart "
                        "here (accepted, ignored)")
    p.add_argument("--rng_impl", default="rbg",
                   choices=["threefry", "rbg", "unsafe_rbg"],
                   help="the JAX trainer's PRNG; no counterpart here (torch "
                        "generators seeded from --seed; accepted, ignored)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true", help="tiny config (smoke)")
    p.add_argument("--config_json", default=None,
                   help="JSON file of SpeechT5Config field overrides")
    p.add_argument("--decode_max_len", type=int, default=None,
                   help="eval greedy-decode token budget (default 100 per "
                        "utterance, max_label_len in conversation mode)")
    p.add_argument("--eval_batches", type=int, default=20)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch versions")
    return p.parse_args(argv)


def build_config(args):
    from ..models.speecht5.config import SpeechT5Config, tiny_config

    if args.tiny:
        cfg = tiny_config(vocab_size=args.vocab_size, hidden_size=32,
                          encoder_attention_heads=4, decoder_attention_heads=4,
                          encoder_ffn_dim=64, decoder_ffn_dim=64)
    else:
        cfg = SpeechT5Config(vocab_size=args.vocab_size)
    if args.config_json:
        with open(args.config_json) as f:
            over = json.load(f)
        cfg = dataclasses.replace(cfg, **{k: tuple(v) if isinstance(v, list) else v
                                          for k, v in over.items()})
    return cfg


def main(argv=None) -> int:
    args = parse_args(argv)
    from . import common
    rc, mesh, dev = common.trainer_mesh(args, "loco_asr_tpu_torch.pipelines.train_asr",
                                        argv)
    if rc is not None:
        return rc

    import torch

    from ..data.asr_dataset import ConversationAsrDataset, KaldiAsrDataset
    from ..data.tokenizer import load_tokenizer
    from ..decode.beam import greedy_decode
    from ..models.speecht5 import convert
    from ..models.speecht5 import model as st5
    from ..parallel import collectives, partition, train
    from ..utils.checkpoint import Checkpointer, flatten
    from ..ops.layers import cast_parameters
    from ..utils.metrics import MetricsWriter
    from ..utils.prefetch import prefetch
    from ..utils.wer import wer

    rank0 = mesh is None or mesh.rank == 0
    sharded = mesh is not None and args.attn_impl not in ("ring", "ulysses")
    home = "cpu" if sharded else dev      # a sharded model is built whole on the host
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tokenizer = load_tokenizer(args.tokenizer)
    if args.tokenizer == "char":
        tokenizer.vocab_size = args.vocab_size
    cfg = build_config(args)

    if args.checkpoint:
        model = common.load_speecht5_params(args.checkpoint, cfg, device=home, variant="asr")
    else:
        model = st5.asr_model_init(cfg, seed=args.seed, device=home)
    if args.dtype == "bfloat16":
        cast_parameters(model, torch.bfloat16)
    if sharded:
        partition.shard_params(model, mesh)
    if args.optimizer == "adafactor":
        tx = train.adafactor(args.lr, args.weight_decay, args.warmup_steps, args.steps,
                             clip_norm=args.grad_clip)
    else:
        tx = train.adamw(args.lr, args.weight_decay, args.warmup_steps, args.steps,
                         clip_norm=args.grad_clip,
                         mu_dtype=torch.bfloat16 if args.opt_mu_dtype == "bfloat16" else None)
    params = train.trainable_params(model, args.freeze_feature_encoder)
    opt_state = tx.init(params, layout=train.layout(model))
    step_fn = train.make_asr_train_step(
        cfg, tx, attn_impl=args.attn_impl,
        freeze_feature_encoder=args.freeze_feature_encoder,
        grad_accum=args.grad_accum,
        compute_dtype=torch.bfloat16 if args.compute_dtype == "bfloat16" else None,
        remat=args.remat, mesh=mesh)

    ckpt = Checkpointer(os.path.join(args.out_dir, "ckpt"))
    metrics = MetricsWriter(os.path.join(args.out_dir, "metrics.jsonl") if rank0 else None)
    start_step = 0

    def load_state(restored):
        common.load_step(restored, model, opt_state, tx, mesh,
                         convert.asr_from_jax_params(flatten(restored["params"]), cfg))

    if args.resume:
        restored = common.restore_own_run(ckpt)
        if restored is not None:
            load_state(restored)
            start_step = int(restored["step"])
            if rank0:
                print(f"resumed at step {start_step}", file=sys.stderr)

    if args.conversation_seconds > 0:
        args.max_seconds = args.conversation_seconds
        if args.max_label_len is None:
            args.max_label_len = max(128, int(16 * args.conversation_seconds))
        if args.decode_max_len is None:
            args.decode_max_len = args.max_label_len
        train_ds = ConversationAsrDataset(args.train_dir,
                                          window_seconds=args.conversation_seconds)
        dev_ds = (ConversationAsrDataset(args.dev_dir,
                                         window_seconds=args.conversation_seconds)
                  if args.dev_dir else None)
        print(f"conversation windows: {len(train_ds)} "
              f"(<= {args.conversation_seconds:.0f}s each)", file=sys.stderr)
    else:
        if args.max_label_len is None:
            args.max_label_len = 128
        if args.decode_max_len is None:
            args.decode_max_len = 100
        train_ds = KaldiAsrDataset(args.train_dir)
        dev_ds = KaldiAsrDataset(args.dev_dir) if args.dev_dir else None
        print(f"train utts: {len(train_ds)}", file=sys.stderr)

    eos = cfg.eos_token_id
    eval_impl = "dense" if args.attn_impl == "dense" else "flash"

    def to_device(batch):
        b = {k: batch[k] for k in ("input_values", "attention_mask", "labels")}
        if mesh is not None:
            return train.shard_batch(b, mesh, args.grad_accum)
        return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}

    eval_model = [model]

    def evaluator():
        """The model the evaluation runs: on a sharded mesh a whole copy on
        this rank's device, loaded with the gathered weights."""
        if not sharded:
            return model
        state = partition.gather_params(model)
        if eval_model[0] is model:
            eval_model[0] = st5.asr_model_init(cfg, seed=args.seed, device="cpu")
            if args.dtype == "bfloat16":
                cast_parameters(eval_model[0], torch.bfloat16)
            eval_model[0].to(dev)
        eval_model[0].load_state_dict(state, strict=True)
        return eval_model[0]

    def run_eval(step):
        if dev_ds is None:
            return {}
        net = evaluator()
        net.eval()
        refs, hyps, nll, ntok = [], [], 0.0, 0
        share = (0, 1) if mesh is None else (mesh.world.index, mesh.world.size)
        with torch.no_grad():
            for bi, batch in enumerate(dev_ds.batches(
                    tokenizer, args.batch_size, max_seconds=args.max_seconds,
                    max_label_len=args.max_label_len, eos_id=eos)):
                if bi >= args.eval_batches:
                    break
                if bi % share[1] != share[0]:      # another rank's share
                    continue
                b = {k: torch.as_tensor(batch[k], device=dev)
                     for k in ("input_values", "attention_mask", "labels")}
                _, aux = st5.asr_loss(net, b["input_values"], b["attention_mask"],
                                      b["labels"], attn_impl=eval_impl)
                nll += float(aux["nll_sum"])
                ntok += int(aux["ntokens"])
                enc, msk = st5.encode_speech(net, b["input_values"],
                                             b["attention_mask"],
                                             use_kernels=eval_impl == "flash")
                toks, lens = greedy_decode(net, enc, msk, max_len=args.decode_max_len)
                for text, row, n in zip(batch["texts"], toks.cpu().numpy(),
                                        lens.cpu().numpy()):
                    ids = [int(t) for t in row[:n] if int(t) != eos]
                    refs.append((bi, text))
                    hyps.append((bi, tokenizer.decode(ids) if ids else ""))
        if mesh is not None:        # every rank's share, in batch order
            parts = collectives.all_gather_objects((nll, ntok, refs, hyps), mesh.world)
            nll, ntok = sum(p[0] for p in parts), sum(p[1] for p in parts)
            refs = sorted((r for p in parts for r in p[2]), key=lambda x: x[0])
            hyps = sorted((h for p in parts for h in p[3]), key=lambda x: x[0])
        refs, hyps = [t for _, t in refs], [t for _, t in hyps]
        out = {"dev_loss": nll / max(ntok, 1), "dev_wer": wer(refs, hyps)}
        metrics.log(step=step, **out)
        if rank0:
            print(f"step {step}: {out}", file=sys.stderr)
        return out

    def batch_stream(epoch):
        # decode, resample and pad on a worker thread, 4 batches ahead
        return prefetch(train_ds.batches(tokenizer, args.batch_size,
                                         max_seconds=args.max_seconds,
                                         max_label_len=args.max_label_len, shuffle=True,
                                         seed=args.seed + epoch, eos_id=eos), depth=4)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    step, epoch = start_step, 0
    stream = batch_stream(epoch)
    trunc = {"samples": 0, "label_tokens": 0, "utterances": 0}
    trunc_warned = False
    t0 = time.perf_counter()
    rollback = (common.NanRollback(model, opt_state, ckpt, metrics, load_state, mesh)
                if args.nan_recovery else None)
    while step < args.steps:
        try:
            batch = next(stream)
        except StopIteration:
            epoch += 1
            stream = batch_stream(epoch)
            continue
        tr = batch.get("truncation") or {}
        for k in trunc:
            trunc[k] += tr.get(k, 0)
        if any(tr.values()) and not trunc_warned and rank0:
            trunc_warned = True
            print(f"WARNING: batch truncated data at the caps "
                  f"(max_seconds={args.max_seconds}, max_label_len="
                  f"{args.max_label_len}): {tr}; running totals are logged "
                  "as trunc_* in metrics.jsonl", file=sys.stderr)
        if args.nan_inject_step is not None and step + 1 == args.nan_inject_step:
            # fault injection: a poisoned batch (NaN waveform -> NaN loss)
            batch = dict(batch, input_values=np.full_like(
                np.asarray(batch["input_values"], np.float32), np.nan))
            args.nan_inject_step = None
        m = step_fn(model, opt_state, to_device(batch), gen)
        if rollback is not None and rollback(step + 1, m["loss"]):
            continue
        step += 1
        if step % 50 == 0:
            dt = time.perf_counter() - t0
            t0 = time.perf_counter()
            metrics.log(step=step, loss=float(m["loss"]),
                        grad_norm=float(m["grad_norm"]), steps_per_sec=50.0 / dt,
                        trunc_samples=trunc["samples"],
                        trunc_label_tokens=trunc["label_tokens"],
                        trunc_utterances=trunc["utterances"])
            if rank0:
                print(f"step {step}: loss {float(m['loss']):.4f} "
                      f"({50.0 / dt:.2f} steps/s)", file=sys.stderr)
        if step % args.eval_every == 0:
            run_eval(step)
        if step % args.save_every == 0 or step == args.steps:
            common.save_step(ckpt, step, model, opt_state, tx, mesh,
                             convert.asr_to_jax_params)
    run_eval(step)
    if rank0:
        print("Training done!", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
