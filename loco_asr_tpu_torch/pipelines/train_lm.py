"""Train a GPT-2-class LM on Kaldi-format transcripts on one GPU or on a mesh
of ranks: the port of ``loco_asr_tpu.pipelines.train_lm``.

Each recording is rebuilt as one chronological token stream (the max_len
dataset's conversation semantics) and the streams are cut into fixed
``--seq_len`` chunks, so conversation-level context is in the training
distribution.

CLI (the JAX trainer's flags, plus ``--device``):
  --train_file --dev_file --out_dir --model {tiny,gpt2,...} --checkpoint
  --tokenizer --seq_len --batch_size --steps --lr --warmup_steps
  --weight_decay --eval_every --save_every --log_every --resume
  --attn_impl {dense,flash} --grad_clip --grad_accum --eos_id
  --tiny_n_embd --tiny_n_layer --tiny_n_head --loss_impl {chunked,dense}
  --optimizer {adamw,adafactor} --nan_recovery --nan_inject_step
  --seed --rng_impl (accepted, ignored) --device (default cuda; cpu runs
  the plain PyTorch versions)

Each step is ``parallel.train.make_lm_train_step``; with ``--attn_impl
flash`` every layer runs kernel B6 (B5 where the head dim is not 64 or the
head count is odd) forward and its blockwise PyTorch backward.  For the
same seed the batches are the JAX trainer's, in its order.
``metrics.jsonl`` gets ``loss``, ``grad_norm``, ``steps_per_sec`` every
``--log_every`` steps and ``dev_ppl``, ``dev_tokens`` at each evaluation;
``{out_dir}/ckpt`` holds ``step_{N}.npz`` (``params.<JAX flat key>``, read
by the JAX package's ``load_npz``) and ``status.json``; ``--resume``
continues from the latest.  ``--checkpoint`` takes what ``eval_ppl``
reads: a JAX ``.npz``, a training directory of ``.npz`` steps, HF weights.

Mixed precision as in JAX: ``--compute_dtype bfloat16`` runs the forward
and backward in bf16 (kernel B6's bf16 form under ``--attn_impl flash``)
on float32 master weights and optimizer state; ``--opt_mu_dtype bfloat16``
stores Adam's first moment in bf16 (read back by ``--resume``).

``--remat {full,dots,hybrid,lite}`` (bare ``--remat``: full) runs the
blocks under a rematerialization policy of ``ops/remat.py``, with the same
numbers.

``--optimizer adafactor`` is the JAX ``adafactor`` (``parallel/train.py``):
no first moment and factored second moments, a + b floats for an [a, b]
matrix, which is what fits gpt2-xl training beside its weights.
``--nan_recovery``: a step whose loss is not finite is logged
(``event="nan_rollback"``), its batch skipped and the latest checkpoint (or,
before the first save, the starting state) put back; ``--nan_inject_step
N`` multiplies the parameters by NaN before step N, once.

``--mesh data,fsdp,tensor`` of more than one rank trains sharded
(``parallel/``; local ranks started by the command, or the ``torchrun``
group): each rank runs B6 on its rows and, under the tensor axis, its
heads' [B, T, H/tp, D] views of its local qkv buffer.  Rank 0 writes
``metrics.jsonl`` and the gathered ``.npz`` steps in the single-device
layout; ``--resume`` re-shards them; the dev evaluation scores each rank's
share of the dev chunks on gathered weights.

``--attn_impl ring|ulysses`` trains sequence-parallel over ``--sp_devices``
ranks (0: every rank), on a ("data", "sequence") mesh whose data axis
absorbs the ranks left over (``common.sp_layout``, as ``train_asr``):
each rank holds the whole model and runs the blocks on its block of each
chunk (``--seq_len`` must divide by the sequence size), scoring the
tokens its positions predict; the dev evaluation is dense, as JAX's.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, Iterator, List

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a GPT-2 LM on Fisher text (CUDA)")
    p.add_argument("--train_file", required=True, help="Kaldi text file")
    p.add_argument("--dev_file", default=None)
    p.add_argument("--out_dir", default="exp/lm")
    p.add_argument("--model", default="gpt2",
                   choices=["tiny", "gpt2", "gpt2-medium", "gpt2-large", "gpt2-xl"])
    p.add_argument("--checkpoint", default=None,
                   help="init weights: a JAX .npz, a training directory of .npz "
                        "steps, or HF weights (what eval_ppl reads)")
    p.add_argument("--tokenizer", default="char")
    p.add_argument("--seq_len", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup_steps", type=int, default=200)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--eval_every", type=int, default=1000)
    p.add_argument("--save_every", type=int, default=1000)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--mesh", default="-1,1,1",
                   help="data,fsdp,tensor mesh shape; more than one rank trains "
                        "sharded (local ranks, or the torchrun group)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--remat", nargs="?", const="full", default="none",
                   choices=["none", "full", "dots", "hybrid", "lite"],
                   help="rematerialize block intermediates on backward "
                        "(ops/remat.py; bare --remat: full); the numbers do "
                        "not change")
    p.add_argument("--nan_recovery", action="store_true",
                   help="on a non-finite loss, skip the batch and restore the "
                        "last checkpoint (or the starting state)")
    p.add_argument("--nan_inject_step", type=int, default=None,
                   help="fault injection: the parameters times NaN before step N "
                        "(once)")
    p.add_argument("--attn_impl", default="dense",
                   choices=["dense", "flash", "ring", "ulysses"],
                   help="causal self-attention in training: 'flash' runs kernel "
                        "B6 (B5) and its blockwise backward; 'ring' / 'ulysses' "
                        "shard each chunk over --sp_devices ranks (sequence "
                        "parallelism)")
    p.add_argument("--sp_devices", type=int, default=0,
                   help="ranks of the sequence axis under --attn_impl ring|ulysses "
                        "(0: every rank; the data axis takes the rest)")
    p.add_argument("--rng_impl", default="rbg",
                   choices=["threefry", "rbg", "unsafe_rbg"],
                   help="the JAX trainer's PRNG; no counterpart here (torch "
                        "generators seeded from --seed; accepted, ignored)")
    p.add_argument("--compute_dtype", choices=["same", "bfloat16"], default="same",
                   help="mixed precision: forward and backward in this dtype on "
                        "float32 master weights")
    p.add_argument("--grad_clip", type=float, default=None,
                   help="global-norm gradient clipping threshold")
    p.add_argument("--optimizer", choices=["adamw", "adafactor"], default="adamw",
                   help="adafactor: factored second moments, no first moment")
    p.add_argument("--opt_mu_dtype", choices=["float32", "bfloat16"],
                   default="float32", help="dtype of Adam's first moment")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="micro-batches per optimizer step (sum-form, exact "
                        "token-mean equivalence; the batch is padded to a "
                        "multiple with rows of no token)")
    p.add_argument("--eos_id", type=int, default=None,
                   help="override the tokenizer's eos id for the conversation-"
                        "stream separators (2 = the SpeechT5 decoder's eos, for "
                        "a shallow-fusion LM)")
    p.add_argument("--tiny_n_embd", type=int, default=32,
                   help="hidden size for --model tiny")
    p.add_argument("--tiny_n_layer", type=int, default=2,
                   help="layer count for --model tiny")
    p.add_argument("--tiny_n_head", type=int, default=4,
                   help="head count for --model tiny")
    p.add_argument("--loss_impl", choices=["chunked", "dense"], default="chunked",
                   help="'chunked' (default) scores the lm head in time chunks "
                        "recomputed in the backward, so the [B,L,V] logits never "
                        "live in memory; 'dense' materializes them")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch versions")
    return p.parse_args(argv)


def _stream_chunks(rec_id2tokens, seq_len: int, eos_id: int,
                   shuffle_seed=None) -> List[np.ndarray]:
    """Concatenate recording streams -> non-overlapping seq_len chunks."""
    recs = list(rec_id2tokens.values())
    if shuffle_seed is not None:
        np.random.default_rng(shuffle_seed).shuffle(recs)
    flat: List[int] = []
    for toks in recs:
        flat.extend(toks)
    chunks = []
    for i in range(0, len(flat) - 1, seq_len):
        chunk = flat[i:i + seq_len]
        if len(chunk) >= 2:
            chunks.append(np.asarray(chunk, np.int32))
    return chunks


def _pack(chunks: List[np.ndarray], seq_len: int) -> Dict[str, np.ndarray]:
    """Right-padded ``ids`` [len(chunks), seq_len] and their ``lengths``."""
    lens = np.asarray([len(c) for c in chunks], np.int32)
    ids = np.zeros((len(chunks), seq_len), np.int32)
    for r, c in enumerate(chunks):
        ids[r, :len(c)] = c
    return {"ids": ids, "lengths": lens}


def epoch_batches(rec_id2tokens, seq_len: int, eos_id: int, batch_size: int,
                  seed: int, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
    """One epoch of training batches, the JAX trainer's: the recordings
    shuffled and chunked with seed ``seed + epoch``, the chunks permuted
    with the same seed, ``batch_size`` at a time (the last may be short)."""
    chunks = _stream_chunks(rec_id2tokens, seq_len, eos_id, shuffle_seed=seed + epoch)
    order = np.random.default_rng(seed + epoch).permutation(len(chunks))
    for i in range(0, len(order), batch_size):
        yield _pack([chunks[j] for j in order[i:i + batch_size]], seq_len)


def pad_rows(batch: Dict[str, np.ndarray], multiple: int) -> Dict[str, np.ndarray]:
    """Rows of no token appended up to a multiple of ``multiple`` (the JAX
    ``shard_batch`` on one device: the ``grad_accum`` split divides and the
    padded rows add nothing to the sum-form loss)."""
    pad = -len(batch["lengths"]) % multiple
    if not pad:
        return batch
    return {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
            for k, v in batch.items()}


def dev_nll(model, chunks: List[np.ndarray], batch_size: int, seq_len: int,
            attn_impl: str, share=(0, 1)):
    """(summed NLL, token count) of ``chunks`` under ``model``, scored
    ``batch_size`` right-padded chunks at a time: the trainer's dev
    evaluation (``exp(sum / count)`` is its ``dev_ppl``).  ``share``
    (index, count): score only every count-th batch from the index-th (a
    rank's share)."""
    import torch

    from ..models.gpt2 import model as g

    dev = model.wte.weight.device
    total, count = 0.0, 0
    with torch.no_grad():
        for i in range(share[0] * batch_size, len(chunks), share[1] * batch_size):
            b = _pack(chunks[i:i + batch_size], seq_len)
            nll = g.score_tokens(model, torch.as_tensor(b["ids"], device=dev),
                                 attn_impl=attn_impl)
            lens = torch.as_tensor(b["lengths"], device=dev)
            valid = torch.arange(nll.shape[1], device=dev)[None, :] < (lens - 1)[:, None]
            total += float((nll * valid).sum())
            count += int(valid.sum())
    return total, count


def build_config(args):
    from ..models.gpt2 import model as g

    if args.model == "tiny":
        return g.tiny_gpt2_config(vocab_size=256, n_positions=max(args.seq_len, 64),
                                  n_embd=args.tiny_n_embd, n_layer=args.tiny_n_layer,
                                  n_head=args.tiny_n_head)
    cfg = g.PRESETS[args.model]
    if args.tokenizer == "char":
        cfg = g.GPT2Config(**{**cfg.__dict__, "vocab_size": 256})
    return cfg


def main(argv=None) -> int:
    args = parse_args(argv)
    from . import common
    rc, mesh, dev = common.trainer_mesh(args, "loco_asr_tpu_torch.pipelines.train_lm", argv)
    if rc is not None:
        return rc

    import torch

    from ..data import lm_datasets
    from ..data.tokenizer import load_tokenizer
    from ..models.gpt2 import convert
    from ..parallel import collectives, partition, train
    from ..utils.checkpoint import Checkpointer, flatten
    from ..utils.metrics import MetricsWriter
    from .eval_ppl import load_gpt2

    rank0 = mesh is None or mesh.rank == 0
    sharded = mesh is not None and args.attn_impl not in ("ring", "ulysses")
    torch.backends.cuda.matmul.allow_tf32 = False
    tokenizer = load_tokenizer(args.tokenizer)
    cfg = build_config(args)
    if args.tokenizer == "char":
        tokenizer.vocab_size = cfg.vocab_size
    if args.eos_id is not None:
        tokenizer.eos_token_id = args.eos_id
    if args.seq_len > cfg.n_positions:
        raise SystemExit(f"--seq_len {args.seq_len} exceeds n_positions {cfg.n_positions}")

    model = load_gpt2(args.checkpoint, cfg, "cpu" if sharded else dev)
    cfg = model.cfg
    if sharded:
        partition.shard_params(model, mesh)
    params = dict(model.named_parameters())
    if args.optimizer == "adafactor":
        tx = train.adafactor(args.lr, args.weight_decay, args.warmup_steps, args.steps,
                             clip_norm=args.grad_clip)
    else:
        tx = train.adamw(args.lr, args.weight_decay, args.warmup_steps, args.steps,
                         clip_norm=args.grad_clip,
                         mu_dtype=torch.bfloat16 if args.opt_mu_dtype == "bfloat16" else None)
    opt_state = tx.init(params, layout=train.layout(model))
    step_fn = train.make_lm_train_step(
        cfg, tx, attn_impl=args.attn_impl, loss_impl=args.loss_impl,
        grad_accum=args.grad_accum,
        compute_dtype=torch.bfloat16 if args.compute_dtype == "bfloat16" else None,
        remat=args.remat, mesh=mesh)

    train_ds = lm_datasets.MaxLenTextDataset(args.train_file, tokenizer,
                                             max_len=args.seq_len)
    dev_chunks = None
    if args.dev_file:
        dev_ds = lm_datasets.MaxLenTextDataset(args.dev_file, tokenizer,
                                               max_len=args.seq_len)
        dev_chunks = _stream_chunks(dev_ds.rec_id2tokens, args.seq_len,
                                    tokenizer.eos_token_id)

    ckpt = Checkpointer(os.path.join(args.out_dir, "ckpt"))
    metrics = MetricsWriter(os.path.join(args.out_dir, "metrics.jsonl") if rank0 else None)
    start_step = 0

    def load_state(restored):
        common.load_step(restored, model, opt_state, tx, mesh,
                         convert.from_jax_params(flatten(restored["params"]), cfg))

    if args.resume:
        restored = common.restore_own_run(ckpt)
        if restored is not None:
            load_state(restored)
            start_step = int(restored["step"])
            if rank0:
                print(f"resumed at step {start_step}", file=sys.stderr)

    eval_impl = "flash" if args.attn_impl == "flash" else "dense"

    eval_model = []

    def run_eval(step):
        if dev_chunks is None:
            return
        net, share = model, (0, 1)
        if mesh is not None:
            share = (mesh.world.index, mesh.world.size)
        if sharded:               # a whole copy with the gathered weights
            state = partition.gather_params(model)
            if not eval_model:
                eval_model.append(load_gpt2(None, cfg, "cpu").to(dev))
            net = eval_model[0]
            net.load_state_dict(state, strict=True)
        net.eval()
        total, count = dev_nll(net, dev_chunks, args.batch_size, args.seq_len,
                               eval_impl, share)
        if mesh is not None:
            sums = collectives.all_reduce(torch.tensor([total, float(count)],
                                                       dtype=torch.float64, device=dev),
                                          mesh.world, mesh)
            total, count = float(sums[0]), int(sums[1])
        ppl = float(np.exp(total / max(count, 1)))
        metrics.log(step=step, dev_ppl=ppl, dev_tokens=count)
        if rank0:
            print(f"step {step}: dev PPL {ppl:.2f} over {count} tokens", file=sys.stderr)

    def batches(epoch):
        return epoch_batches(train_ds.rec_id2tokens, args.seq_len, tokenizer.eos_token_id,
                             args.batch_size, args.seed, epoch)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    step, epoch = start_step, 0
    stream = batches(epoch)
    t0 = time.perf_counter()
    rollback = (common.NanRollback(model, opt_state, ckpt, metrics, load_state, mesh)
                if args.nan_recovery else None)
    while step < args.steps:
        try:
            batch = next(stream)
        except StopIteration:
            epoch += 1
            stream = batches(epoch)
            continue
        if mesh is not None:
            batch = train.shard_batch(batch, mesh, args.grad_accum)
        else:
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in pad_rows(batch, args.grad_accum).items()}
        if args.nan_inject_step is not None and step + 1 == args.nan_inject_step:
            # fault injection: NaN-poisoned parameters -> non-finite loss
            with torch.no_grad():
                for p in params.values():
                    p.mul_(float("nan"))
            args.nan_inject_step = None
        m = step_fn(model, opt_state, batch, gen)
        if rollback is not None and rollback(step + 1, m["loss"]):
            continue
        step += 1
        if step % args.log_every == 0:
            dt = time.perf_counter() - t0
            t0 = time.perf_counter()
            loss = float(m["loss"])
            metrics.log(step=step, loss=loss, grad_norm=float(m["grad_norm"]),
                        steps_per_sec=args.log_every / dt)
            if rank0:
                print(f"step {step}: loss {loss:.4f}", file=sys.stderr)
        if step % args.eval_every == 0:
            run_eval(step)
        if step % args.save_every == 0 or step == args.steps:
            common.save_step(ckpt, step, model, opt_state, tx, mesh, convert.to_jax_params)
    run_eval(step)
    if rank0:
        print("Training done!", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
