"""GPT-2 perplexity over Fisher-style transcripts on the GPU: the port of
``loco_asr_tpu.pipelines.eval_ppl`` (the reference's
lms/src/eval_ppl_with_pretrained_lm.py).

    python -m loco_asr_tpu_torch.pipelines.eval_ppl -i <key-text> -o <dir> \\
        --model gpt2 --context_type {indep,max_len,streaming} --attn_impl flash

Same flags as the JAX pipeline, plus ``--device`` (default cuda; cpu runs
the plain PyTorch versions of the kernels).  Same modes and numbers:

  indep     : per-utterance NLLs, scored in padded length buckets;
  max_len   : per recording, all NLLs of the first ``max_len`` window, then
              the last token's NLL of every stride-1 window, streamed
              through one global [bsize, max_len] batch (short recordings
              right-padded, the last flush repeat-padded);
  streaming : half-overlap windows, every token scored once; recordings
              no longer than ``max_len`` zero-padded into full batches.

Under ``--attn_impl flash`` each scoring forward runs kernel B6 (B5 when
the head dim is not 64 or the head count is odd) in every layer.

Artifacts: ``rec_id2nlls.pkl``, ``rec_id2ppl.json`` and the timestamped
log with the reference's aggregate line.  Checkpoints: none (seeded random
init), a JAX ``.npz``, a training directory (``status.json`` whose latest
step is ``step_N.npz`` or an orbax ``step_N/``: ``train_lm``'s, or the JAX
package's on either backend; orbax steps through ``utils/orbax.py``,
without orbax), or HF ``pytorch_model.bin`` / ``.safetensors`` files or
directories (``.safetensors`` through ``utils/safetensors.py``, without
the package).  ``--compute_dtype bfloat16`` casts the weights to bf16, as
the JAX pipeline does (the attention kernels then run their bf16 forms;
the lm head's logsumexp and the NLLs stay float32).  ``--data_parallel
N`` splits each scoring batch's rows over N ranks (local ranks started by
the command, or the ``torchrun`` group; ``common.DataParallel``), as the
JAX pipeline shards them; rank 0 writes the artifacts.  As in JAX it is
dense only (``--attn_impl flash`` with it is refused).
``--sequence_parallel N --sp_impl ring|ulysses`` splits each scoring
window's time axis over N ranks (``parallel/sp.py``): each rank runs GPT-2
on its block and the scheme's causal attention over the window, and every
rank gets the window's NLLs.  As in JAX: a ``--max_len`` that N does not
divide shrinks to the largest multiple (with a warning), a shorter window
is right-padded with its last token to a multiple of N (inert under
causality) and its NLLs cut back, a pad past ``n_positions`` is an error,
and ``--attn_impl`` other than dense or ``--data_parallel`` with it are
refused.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import pickle
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np


def parse_arguments(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--in_file", "-in_file", "-i", required=True,
                   help="path to input text file on which PPL shall be computed")
    p.add_argument("--out_dir", "-o", required=True,
                   help="path to out dir where results are stored")
    p.add_argument("--bsize", "--batch_size", "-bsize", "-batch_size",
                   "--sb", "-sb", type=int, default=128, help="max batch size")
    p.add_argument("--model", "-model", "-m", type=str, default="gpt2",
                   choices=["gpt2", "gpt2-medium", "gpt2-large", "gpt2-xl",
                            "tiny"])
    p.add_argument("--context_type", "-context_type", "--ct", "-ct",
                   choices=["indep", "max_len", "streaming"], default="indep",
                   help="indep/max_len = reference semantics; streaming = "
                        "half-overlap strided windows")
    p.add_argument("--checkpoint", default=None,
                   help="local GPT-2 weights (.npz of the JAX package, a "
                        "training dir of .npz or orbax steps, .bin/.safetensors "
                        "or an HF dir); random init if omitted")
    p.add_argument("--tokenizer", default="char",
                   help="'char' or dir with vocab.json+merges.txt")
    p.add_argument("--max_len", type=int, default=None,
                   help="context window (default: model n_positions)")
    p.add_argument("--tiny_n_head", type=int, default=4,
                   help="head count for --model tiny")
    p.add_argument("--download_only", action="store_true",
                   help="kept for CLI parity; no-op (no network)")
    p.add_argument("--no_cuda", action="store_true",
                   help="run on the CPU (same as --device cpu)")
    p.add_argument("--verbose", "-v", action="store_true")
    p.add_argument("--limit_recordings", type=int, default=None)
    p.add_argument("--data_parallel", type=int, default=1,
                   help="shard window batches over this many ranks")
    p.add_argument("--sequence_parallel", type=int, default=1,
                   help="shard each scoring window's time axis over this many "
                        "ranks (sequence parallelism, --sp_impl)")
    p.add_argument("--sp_impl", choices=["ring", "ulysses"], default="ring",
                   help="sequence-parallel scheme: 'ring' rotates K/V blocks "
                        "around the ranks; 'ulysses' scatters heads by "
                        "all-to-all (needs n_head %% ranks == 0)")
    p.add_argument("--compute_dtype", choices=["same", "bfloat16"],
                   default="same",
                   help="bfloat16 casts the weights to bf16 (the attention "
                        "kernels run their bf16 forms)")
    p.add_argument("--attn_impl", choices=["dense", "flash"], default="dense",
                   help="'flash' runs causal attention through kernel B6/B5")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch versions")
    return p.parse_args(argv)


def training_dir_params(directory: str) -> Dict:
    """Flat JAX params of the latest step of a training directory
    (``status.json`` + ``step_N.npz`` or an orbax ``step_N/``, the layouts of
    both packages' checkpointers: ``params.<flat key>`` entries)."""
    from ..utils.checkpoint import Checkpointer, flatten

    ckpt = Checkpointer(directory)
    step = ckpt.status()["latest"]
    if step is None:
        raise SystemExit(f"{directory}: status.json names no saved step")
    return flatten(ckpt.restore(step, "params")["params"])


def read_checkpoint(checkpoint: str):
    """('jax', flat JAX params) for a ``.npz`` or a training directory of
    ``.npz`` steps, ('hf', state dict) for HF torch or safetensors
    weights."""
    if os.path.isdir(checkpoint):
        if os.path.exists(os.path.join(checkpoint, "status.json")):
            return "jax", training_dir_params(checkpoint)
        for name in ("model.safetensors", "pytorch_model.bin"):
            path = os.path.join(checkpoint, name)
            if os.path.exists(path):
                checkpoint = path
                break
    if checkpoint.endswith(".npz"):
        with np.load(checkpoint, allow_pickle=False) as z:
            return "jax", {k: z[k] for k in z.files}
    if checkpoint.endswith(".safetensors"):
        from ..utils.safetensors import load_file
        return "hf", load_file(checkpoint)
    import torch
    return "hf", torch.load(checkpoint, map_location="cpu", weights_only=True)


def checkpoint_config(cfg, flat: Dict, *, tiny: bool):
    """The config that ``flat``'s shapes pin down: its vocab always (the
    lm head is tied to ``wte``) and, for ``--model tiny``, its width,
    positions and depth as well."""
    from ..models.gpt2.convert import strip_hf_prefix

    shapes = {strip_hf_prefix(k): tuple(np.shape(v)) for k, v in flat.items()}
    vocab, width = shapes["wte.weight"]
    over = dict(vocab_size=vocab)
    if tiny:
        over.update(n_embd=width, n_positions=shapes["wpe.weight"][0],
                    n_layer=len({k.split(".")[1] for k in shapes if k.startswith("h.")}))
    return dataclasses.replace(cfg, **over)


def load_gpt2(checkpoint, cfg, device, *, tiny: bool = False):
    """A ``GPT2Model`` in eval mode on ``device``: seeded random weights
    (seed 0) of ``cfg`` without a ``checkpoint``, else the weights that
    :func:`read_checkpoint` reads, under the config their shapes pin
    (:func:`checkpoint_config`); ``model.cfg`` is that config."""
    import torch

    from ..models.gpt2 import convert, model as g

    if checkpoint is None:
        return g.gpt2_init(cfg, seed=0, device=device)
    kind, flat = read_checkpoint(checkpoint)
    cfg = checkpoint_config(cfg, flat, tiny=tiny)
    bridge = convert.from_jax_params if kind == "jax" else convert.load_hf_gpt2
    state = bridge(flat, cfg)
    with torch.device("meta"):
        model = g.GPT2Model(cfg)
    model.load_state_dict(state, strict=True, assign=True)
    return model.to(device).eval()


def main(argv=None) -> int:
    args = parse_arguments(argv)
    if args.download_only:
        print("download_only is a no-op in the egress-free build", file=sys.stderr)
        return 0
    # the JAX pipeline's refusals, in its order
    n_sp = args.sequence_parallel
    if args.attn_impl != "dense" and n_sp > 1:
        raise SystemExit("--attn_impl applies to single-chip scoring; "
                         "--sequence_parallel already picks its own "
                         "kernel via --sp_impl")
    if args.attn_impl != "dense" and args.data_parallel > 1:
        # its Pallas kernel has no GSPMD partition rule
        raise SystemExit("--attn_impl flash with --data_parallel is not "
                         "supported (the Pallas kernel has no GSPMD "
                         "partition rule); use dense for DP scoring")
    if n_sp > 1 and args.data_parallel > 1:
        raise SystemExit("--sequence_parallel and --data_parallel are "
                         "mutually exclusive (use a 2-D mesh via train_lm "
                         "for combined DP+SP training)")
    from ..parallel import launch
    rc = launch.run("loco_asr_tpu_torch.pipelines.eval_ppl", argv,
                    max(args.data_parallel, n_sp), "cpu" if args.no_cuda else args.device)
    if rc is not None:
        return rc

    import torch

    from ..data import lm_datasets, tokenizer as tok_lib
    from ..models.gpt2 import model as g
    from ..ops.layers import cast_parameters
    from ..utils.metrics import create_logger
    from . import common

    dp = common.DataParallel(args.data_parallel, "cpu" if args.no_cuda else args.device)
    dev = dp.device
    os.makedirs(args.out_dir, exist_ok=True)
    path_out_dir = Path(args.out_dir)
    base = os.path.basename(args.in_file).rsplit(".", 1)[0]
    pfx = f"{args.model}_{args.context_type}_{base}"
    if dp.rank0:
        logger = create_logger(str(path_out_dir / f"{pfx}.log"), args.verbose)
    else:           # the other ranks score their rows and write nothing
        logger = logging.getLogger(f"loco_asr_tpu_torch.eval_ppl.rank{dp.mesh.rank}")
        logger.addHandler(logging.NullHandler())
        logger.propagate = False

    tokenizer = tok_lib.load_tokenizer(args.tokenizer)
    if args.model == "tiny":
        vocab = max(256, getattr(tokenizer, "vocab_size", 256))
        cfg = g.tiny_gpt2_config(vocab_size=vocab,
                                 n_positions=max(64, args.max_len or 0),
                                 n_embd=32, n_head=args.tiny_n_head)
    else:
        cfg = g.PRESETS[args.model]
    if args.tokenizer == "char" and args.model != "tiny":
        cfg = dataclasses.replace(cfg, vocab_size=256)
    if args.tokenizer == "char":
        tokenizer.vocab_size = cfg.vocab_size  # keep ids inside the model vocab
    model = load_gpt2(args.checkpoint, cfg, dev, tiny=args.model == "tiny")
    cfg = model.cfg
    if args.model == "tiny" and args.tokenizer == "char":
        tokenizer.vocab_size = cfg.vocab_size
    if args.compute_dtype == "bfloat16":
        cast_parameters(model, torch.bfloat16)
        logger.info("scoring in bfloat16 (f32 logsumexp/NLL accumulation);"
                    " NLLs differ from the f32 reference contract by bf16"
                    " rounding")
    max_len = args.max_len or cfg.n_positions
    if max_len > cfg.n_positions:
        logger.warning(f"--max_len {max_len} > n_positions "
                       f"{cfg.n_positions}; clamping")
        max_len = cfg.n_positions
    sp = None
    if n_sp > 1:
        from ..parallel import mesh as meshlib
        from ..parallel.sp import SequenceParallel

        if max_len % n_sp:
            new_len = (max_len // n_sp) * n_sp
            logger.warning(
                f"--max_len {max_len} not divisible by --sequence_parallel "
                f"{n_sp}; using {new_len} (reference used the full "
                f"n_positions window — PPLs differ slightly)")
            max_len = new_len
        sp = SequenceParallel(meshlib.make_sp_mesh(n_sp, 1, device=dev))

    def score(ids: np.ndarray) -> np.ndarray:
        """[B, T] ids -> [B, T-1] NLLs (chunked lm head; under
        ``--data_parallel`` each rank scores its rows, under
        ``--sequence_parallel`` its block of every window)."""
        (rows,) = dp.rows(np.array(ids, dtype=np.int64))
        kw = dict(attn_impl=args.attn_impl)
        t = rows.shape[1]
        if sp is not None:
            pad = (-t) % n_sp
            if t + pad > cfg.n_positions:
                raise SystemExit(
                    f"sequence of {t} tokens pads to {t + pad} under "
                    f"--sequence_parallel {n_sp}, past n_positions "
                    f"{cfg.n_positions}; use a max_len divisible by "
                    f"{n_sp} or fewer devices")
            if pad:    # causal: trailing pad tokens are inert for the real NLLs
                rows = np.concatenate([rows, np.repeat(rows[:, -1:], pad, 1)], 1)
            kw = dict(attn_impl=args.sp_impl, sp=sp)
        with torch.inference_mode():
            nll = g.score_tokens(model, torch.from_numpy(rows).to(dev), **kw)[:, :t - 1]
        return dp.gather(nll.cpu().numpy(), len(ids))

    nlls: List[List[float]] = []
    stime = time.time()

    if args.context_type == "indep":
        dataset = lm_datasets.IndepTextDataset(args.in_file, tokenizer,
                                               batch_size=args.bsize)
        if args.limit_recordings:
            # utterances of the first N distinct recordings in file order
            seen: List[str] = []
            for u in lm_datasets.load_key_text(args.in_file):
                r = u.split("-")[0]
                if r not in seen:
                    seen.append(r)
            allow = set(seen[: args.limit_recordings])
            keep = [i for i, u in enumerate(dataset.utt_ids)
                    if u.split("-")[0] in allow]
            dataset.text_ids = [dataset.text_ids[i] for i in keep]
            dataset.utt_ids = [dataset.utt_ids[i] for i in keep]
            dataset.lengths = dataset.lengths[keep]
            dataset.bins, dataset.counts = np.unique(dataset.lengths,
                                                     return_counts=True)
        ids_order = dataset.utt_ids
        for ids, lens, _ in dataset.padded_batches(args.bsize):
            for row, L in zip(score(ids), lens):
                nlls.append(row[: L - 1].tolist())
    elif args.context_type == "max_len":
        dataset = lm_datasets.MaxLenTextDataset(args.in_file, tokenizer,
                                                max_len=max_len,
                                                batch_size=args.bsize)
        ids_order = []
        recs = list(dataset.rec_id2tokens.items())
        if args.limit_recordings:
            recs = recs[: args.limit_recordings]
        # one global [bsize, max_len] window stream across recordings;
        # short recordings are right-padded (inert under the causal mask)
        bsize = args.bsize
        buf = np.zeros((bsize, max_len), np.int32)
        pending: List[tuple] = []   # ("full", L) keeps row[:L-1]; ("last", _) keeps row[-1]

        def flush():
            if not pending:
                return
            n = len(pending)
            if n < bsize:
                buf[n:] = buf[n - 1]     # repeat-pad the final partial flush
            for (kind, L), row in zip(pending, score(buf)):
                nlls.append(row[: L - 1].tolist() if kind == "full"
                            else [float(row[-1])])
            pending.clear()

        def enqueue(row: np.ndarray, kind: str, L: int, rec_id: str):
            buf[len(pending), : len(row)] = row
            buf[len(pending), len(row):] = row[-1]   # inert right-pad
            pending.append((kind, L))
            ids_order.append(rec_id)
            if len(pending) == bsize:
                flush()

        for r, (rec_id, tokens) in enumerate(recs):
            print(f"\r recording {r+1}/{len(recs)} ({len(tokens)} tokens)",
                  end=" ", file=sys.stderr)
            T = len(tokens)
            if T < max_len:
                enqueue(np.asarray(tokens, np.int32), "full", T, rec_id)
                continue
            windows = dataset.recording_windows(tokens)
            if len(windows) == 0:
                continue  # reference quirk: T == max_len yields nothing
            enqueue(windows[0], "full", max_len, rec_id)
            for w in windows[1:]:
                enqueue(w, "last", max_len, rec_id)
        flush()
        print(file=sys.stderr)
    elif args.context_type == "streaming":
        dataset = lm_datasets.MaxLenTextDataset(args.in_file, tokenizer,
                                                max_len=max_len,
                                                batch_size=args.bsize)
        ids_order = []
        if max_len < 2:
            raise ValueError("--context_type streaming needs --max_len >= 2 "
                             "(stride = max_len // 2 would be zero)")
        stride = max_len // 2
        recs = list(dataset.rec_id2tokens.items())
        if args.limit_recordings:
            recs = recs[: args.limit_recordings]
        shorts: List[tuple] = []   # T <= max_len: zero-padded full batches
        for r, (rec_id, tokens) in enumerate(recs):
            print(f"\r recording {r+1}/{len(recs)} ({len(tokens)} tokens)",
                  end=" ", file=sys.stderr)
            T = len(tokens)
            arr = np.asarray(tokens, np.int32)
            if T <= max_len:
                shorts.append((rec_id, arr))
                continue
            # half-overlap windows at offsets 0, stride, 2*stride, ...
            offsets = list(range(0, T - max_len, stride)) + [T - max_len]
            wins = np.stack([arr[o:o + max_len] for o in offsets])
            rec_nlls: List[float] = []
            prev_end = 0
            for i in range(0, len(wins), args.bsize):
                chunk = wins[i:i + args.bsize]
                n = len(chunk)
                if n < args.bsize:
                    chunk = np.concatenate(
                        [chunk, np.repeat(chunk[-1:], args.bsize - n, 0)], 0)
                out = score(chunk)[:n]
                for w, row in zip(range(i, i + n), out):
                    o = offsets[w]
                    # row[j] = NLL of token o+j+1; keep tokens not yet scored
                    start_tok = max(o + 1, prev_end)
                    rec_nlls.extend(row[start_tok - o - 1: max_len - 1].tolist())
                    prev_end = o + max_len
            nlls.append(rec_nlls)
            ids_order.append(rec_id)
        for i in range(0, len(shorts), args.bsize):
            group = shorts[i:i + args.bsize]
            batch = np.zeros((args.bsize, max_len), np.int32)
            for j, (_, arr) in enumerate(group):
                batch[j, : len(arr)] = arr
            for (rec_id, arr), row in zip(group, score(batch)):
                nlls.append(row[: len(arr) - 1].tolist())
                ids_order.append(rec_id)
        print(file=sys.stderr)
    else:
        raise ValueError(args.context_type)

    if len(nlls) != len(ids_order):
        raise RuntimeError(f"nlls {len(nlls)} != ids {len(ids_order)}")
    if not dp.rank0:
        return 0
    rec_id2nlls, rec_id2ppl = lm_datasets.compute_ppl_per_recording(nlls, ids_order)
    ppls = list(rec_id2ppl.values())
    logger.info(
        f"Avg. PPL of recordings: {np.mean(ppls):.2f} std.dev: {np.std(ppls):.2f} "
        f"min PPL: {np.min(ppls):.2f} max PPL: {np.max(ppls):.2f}")

    with open(path_out_dir / "rec_id2nlls.pkl", "wb") as f:
        pickle.dump(rec_id2nlls, f)
    with open(path_out_dir / "rec_id2ppl.json", "w", encoding="utf-8") as f:
        json.dump(rec_id2ppl, f, indent=2, ensure_ascii=False)
    logger.info(f"Saved in {args.out_dir} Time taken {time.time() - stime:.2f} sec")
    return 0


if __name__ == "__main__":
    sys.exit(main())
