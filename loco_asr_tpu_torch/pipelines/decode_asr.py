"""Decode a Kaldi-format test set with greedy or beam search and optional
GPT-2 shallow fusion, and score WER: ``loco_asr_tpu.pipelines.decode_asr``
on the GPU.

CLI (the JAX pipeline's flags, plus ``--device``):
  --data_dir  --out_dir  --checkpoint (.npz)  --tokenizer  --vocab_size
  --beam_size  --length_penalty  --max_decode_len  --batch_size
  --max_seconds  --lm_checkpoint  --lm_model  --lm_weight  --tiny
  --limit_batches  --continuous  --conversation  --data_parallel
  --device (default cuda; cpu runs the plain PyTorch versions)

Static batches are encoded by ``encode_speech`` (kernels B2 and B1 on the
GPU) and decoded by ``greedy_decode`` / ``beam_search``; ``--continuous``
runs the continuous batcher (``decode/batcher.py``), and with
``--conversation`` each recording is one stream whose LM context carries
across its utterances.  Artifacts: ``{out_dir}/hyp.text`` (Kaldi
``utt_id hypothesis`` lines), ``wer.json`` (corpus WER, its breakdown and
RTFx), ``metrics.jsonl``.  ``--data_parallel N`` splits each static
batch's rows over N ranks (local ranks started by the command, or the
``torchrun`` group; ``common.DataParallel``), each encoding and decoding
its rows with the whole model; rank 0 writes the outputs.  As in JAX it
excludes ``--continuous``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List



def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Beam-decode a Kaldi set + WER (CUDA)")
    p.add_argument("--data_dir", required=True, help="Kaldi dir (text+wav.scp)")
    p.add_argument("--out_dir", default="exp/decode")
    p.add_argument("--checkpoint", default=None,
                   help="ASR weights: .npz of the JAX package (default: random init)")
    p.add_argument("--tokenizer", default="char")
    p.add_argument("--vocab_size", type=int, default=256)
    p.add_argument("--beam_size", type=int, default=5)
    p.add_argument("--length_penalty", type=float, default=1.0)
    p.add_argument("--max_decode_len", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_seconds", type=float, default=20.0)
    p.add_argument("--lm_checkpoint", default=None,
                   help="fusion LM weights (.npz of the JAX package, HF torch "
                        "or safetensors)")
    p.add_argument("--lm_model", default="tiny",
                   choices=["tiny", "gpt2", "gpt2-medium", "gpt2-large", "gpt2-xl"])
    p.add_argument("--lm_weight", type=float, default=0.3)
    p.add_argument("--tiny", action="store_true", help="tiny ASR config (smoke)")
    p.add_argument("--limit_batches", type=int, default=None)
    p.add_argument("--continuous", action="store_true",
                   help="continuous batching: a decode slot is refilled as soon "
                        "as its stream finishes (decode/batcher.py)")
    p.add_argument("--conversation", action="store_true",
                   help="with --continuous: slot = conversation stream "
                        "(recording id = uttid.split('-')[0]); the fusion LM's "
                        "KV cache carries each recording's context across its "
                        "utterances in start-time order (needs an LM); combines "
                        "with --beam_size > 1")
    p.add_argument("--data_parallel", type=int, default=1,
                   help="shard the decode batch over this many ranks (weights "
                        "whole on each, batch rows split; static batches only)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch versions")
    return p.parse_args(argv)


def load_fusion_lm(args, dev):
    """The fusion LM of the flags, or None: ``--lm_model`` sizes, with the
    vocabulary (and for ``tiny`` the width, positions and depth) of
    ``--lm_checkpoint``; seeded random weights without one."""
    from ..decode.fusion import FusionLM
    from ..models.gpt2 import model as g
    from .eval_ppl import load_gpt2

    if args.lm_checkpoint is None and args.lm_model == "tiny":
        return None
    if args.lm_model == "tiny":
        # the JAX pipeline's tiny LM; conversation carry-over needs room
        # beyond one utterance (history window = n_positions - decode_reserve)
        n_pos = max(args.max_decode_len + 8, 64)
        if args.conversation:
            n_pos = max(4 * (args.max_decode_len + 8), 128)
        cfg = g.tiny_gpt2_config(vocab_size=256, n_embd=32, n_head=4, n_positions=n_pos)
    else:
        cfg = g.PRESETS[args.lm_model]
    model = load_gpt2(args.lm_checkpoint, cfg, dev, tiny=args.lm_model == "tiny")
    cfg = model.cfg
    if cfg.vocab_size != args.vocab_size:
        raise SystemExit(f"fusion adds LM and ASR log-probs: the LM's vocabulary "
                         f"({cfg.vocab_size}) must be the ASR one ({args.vocab_size})")
    return FusionLM(model, weight=args.lm_weight)


def _hypothesis(tokenizer, eos_id: int, row, length: int) -> str:
    ids = [int(t) for t in row[:length] if int(t) != eos_id]
    hyp = tokenizer.decode(ids) if hasattr(tokenizer, "decode") and ids else ""
    # hyp.text is line-based: a byte-level decode may hold newlines or other
    # whitespace (WER is whitespace-tokenized, so scoring is unchanged)
    return " ".join(hyp.split())


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.continuous and args.data_parallel > 1:
        raise SystemExit("--continuous and --data_parallel are mutually "
                         "exclusive (the batcher owns its own device "
                         "scheduling; DP decode uses static batches)")
    if args.conversation and not args.continuous:
        raise SystemExit("--conversation requires --continuous")
    from ..parallel import launch
    rc = launch.run("loco_asr_tpu_torch.pipelines.decode_asr", argv, args.data_parallel,
                    args.device)
    if rc is not None:
        return rc

    import torch

    from ..data.asr_dataset import KaldiAsrDataset
    from ..data.tokenizer import load_tokenizer
    from ..decode.beam import beam_search, greedy_decode
    from ..models.speecht5 import model as st5
    from ..models.speecht5.config import SpeechT5Config, tiny_config
    from ..utils.metrics import MetricsWriter, Stopwatch
    from ..utils.wer import wer_details
    from . import common

    dp = common.DataParallel(args.data_parallel, args.device)
    dev = dp.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.out_dir, exist_ok=True)
    tokenizer = load_tokenizer(args.tokenizer)
    if args.tokenizer == "char":
        tokenizer.vocab_size = args.vocab_size
    if args.tiny:
        cfg = tiny_config(vocab_size=args.vocab_size, apply_spec_augment=False)
    else:
        cfg = SpeechT5Config(vocab_size=args.vocab_size)
    model = common.load_speecht5_params(args.checkpoint, cfg, device=dev, variant="asr")
    fusion = load_fusion_lm(args, dev)
    if args.conversation and fusion is None:
        raise SystemExit("--conversation needs a fusion LM (--lm_checkpoint/"
                         "--lm_model): the carried state IS the LM context")

    ds = KaldiAsrDataset(args.data_dir)
    metrics = MetricsWriter(os.path.join(args.out_dir, "metrics.jsonl") if dp.rank0 else None)
    watch = Stopwatch()
    batches = ds.batches(tokenizer, args.batch_size, max_seconds=args.max_seconds,
                         eos_id=cfg.eos_token_id)
    if args.limit_batches is not None:
        batches = (b for _, b in zip(range(args.limit_batches), batches))

    refs: List[str] = []
    hyps: List[str] = []
    hyp_lines: List[str] = []
    audio_seconds = 0.0

    def emit(utt_id, text, row, length):
        hyp = _hypothesis(tokenizer, cfg.eos_token_id, row, length)
        refs.append(text)
        hyps.append(hyp)
        hyp_lines.append(f"{utt_id} {hyp}")

    if args.continuous:
        from ..decode import batcher

        utts, text_by_id = [], {}
        for batch in batches:
            for utt_id, text, wav, m in zip(batch["utt_ids"], batch["texts"],
                                            batch["input_values"], batch["attention_mask"]):
                utts.append((utt_id, wav[:int(m.sum())]))
                text_by_id[utt_id] = text
        audio_seconds = sum(len(w) for _, w in utts) / 16000.0
        bucket = int(args.max_seconds * 16000)
        if args.conversation:
            # conversation = recording id; utterances in the reference's
            # chronological key order (recid-channel-start-end)
            by_rec = {}
            for uid, wav in sorted(utts, key=lambda x: x[0]):
                by_rec.setdefault(uid.split("-")[0], []).append((uid, wav))
            conv_out = batcher.decode_conversations(
                model, [(rec, [w for _, w in items]) for rec, items in by_rec.items()],
                fusion=fusion, slots=args.batch_size, max_len=args.max_decode_len,
                beam_size=args.beam_size, length_penalty=args.length_penalty,
                audio_samples=bucket, decode_reserve=args.max_decode_len + 8)
            results = {uid: res for rec, items in by_rec.items()
                       for (uid, _), res in zip(items, conv_out[rec])}
        elif args.beam_size > 1:
            results = batcher.decode_continuous_beam(
                model, utts, slots=args.batch_size, beam_size=args.beam_size,
                max_len=args.max_decode_len, length_penalty=args.length_penalty,
                audio_samples=bucket, fusion=fusion)
        else:
            results = batcher.decode_continuous(
                model, utts, slots=args.batch_size, max_len=args.max_decode_len,
                audio_samples=bucket, fusion=fusion)
        for utt_id, _ in utts:
            emit(utt_id, text_by_id[utt_id], *results[utt_id])
    else:
        for batch in batches:
            audio_seconds += float(batch["attention_mask"].sum()) / 16000.0
            enc, mask = st5.encode_speech(model, *dp.rows(batch["input_values"],
                                                          batch["attention_mask"]))
            if args.beam_size == 1:
                toks, lens = greedy_decode(model, enc, mask, max_len=args.max_decode_len,
                                           fusion=fusion)
            else:
                hyp = beam_search(model, enc, mask, beam_size=args.beam_size,
                                  max_len=args.max_decode_len,
                                  length_penalty=args.length_penalty, fusion=fusion)
                toks, lens = hyp.tokens[:, 0], hyp.lengths[:, 0]
            n = len(batch["utt_ids"])     # data-parallel pad rows fall off
            toks, lens = dp.gather(toks.cpu().numpy(), n), dp.gather(lens.cpu().numpy(), n)
            for utt_id, text, row, length in zip(batch["utt_ids"], batch["texts"],
                                                 toks, lens.tolist()):
                emit(utt_id, text, row, length)
            if dp.rank0:
                print(f"\r decoded {len(refs)} utts", end=" ", file=sys.stderr)
    if not dp.rank0:
        return 0
    print(file=sys.stderr)

    details = wer_details(refs, hyps)
    details["rtfx"] = watch.rtfx(audio_seconds)
    with open(os.path.join(args.out_dir, "hyp.text"), "w") as f:
        f.write("\n".join(hyp_lines) + "\n")
    with open(os.path.join(args.out_dir, "wer.json"), "w") as f:
        json.dump(details, f, indent=2)
    metrics.log(**details)
    print(f"WER {details['wer']*100:.2f}% "
          f"(sub {details['sub_rate']*100:.1f} ins {details['ins_rate']*100:.1f} "
          f"del {details['del_rate']*100:.1f}) RTFx {details['rtfx']:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
