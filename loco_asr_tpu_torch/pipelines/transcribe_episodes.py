"""Transcribe long-form episodes (podcast manifests) with conversation
carry-over on one GPU: the port of
``loco_asr_tpu.pipelines.transcribe_episodes`` (BASELINE config 5).

CLI (the JAX pipeline's flags, plus ``--device``):
  --manifest --out_dir --checkpoint --tokenizer --vocab_size
  --lm_checkpoint --lm_model --lm_weight --max_decode_len --beam_size
  --length_penalty --batch_seconds --attn_impl {dense,flash} --tiny
  --limit_episodes --continuous --slots --chunk_steps
  --device (default cuda; cpu runs the plain PyTorch versions)

Input: an episode manifest (``data/podcasts.py``).  Per episode the audio
is decoded, segmented (manifest timestamps or the energy endpointer) and
transcribed segment by segment with greedy decoding
(``decode/long_audio.py``: kernel B2 once a segment, and kernel B1 in
every encoder layer under ``--attn_impl flash``); with an LM the fusion
scorer's KV cache carries the conversation across segments.
``--continuous`` decodes every episode at once in the continuous batcher
(``decode/batcher.py``): slot = episode stream, with an LM each slot's LM
cache carrying that episode's context (``decode_conversations``),
without one each segment alone (``decode_continuous``, or
``decode_continuous_beam`` with ``--beam_size`` > 1).  Its encodes run
``encode_speech``'s default (B1 and B2 on the GPU) whatever
``--attn_impl`` says; the JAX batcher likewise ignores it (its encodes are
dense).

Output: ``{out_dir}/{episode_id}.jsonl``, one segment a line
(``start, end, text, token_ids``), and ``metrics.jsonl``: per episode
``segments`` and ``rtfx`` (wall time until the tokens are on the host), or
with ``--continuous`` ``segments``, ``corpus_rtfx`` and, where the
manifest has texts, ``wer``.

The fusion LM: ``--lm_checkpoint`` or an ``--lm_model`` other than
``tiny`` turns fusion on (the JAX rule); the tiny LM is
``tiny_gpt2_config(vocab_size=256, n_embd=32, n_head=4,
n_positions=512)``, with the width, positions and depth of a
``--lm_checkpoint`` where one is given; without one the LM has seeded
random weights.  Fusion adds log-probs, so the LM's vocabulary must be
the ASR one (``--vocab_size``), else the run is refused.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Transcribe long audio episodes (CUDA)")
    p.add_argument("--manifest", required=True)
    p.add_argument("--out_dir", default="exp/episodes")
    p.add_argument("--checkpoint", default=None,
                   help="ASR weights (any source of load_speecht5_params); "
                        "random init if omitted")
    p.add_argument("--tokenizer", default="char")
    p.add_argument("--vocab_size", type=int, default=256)
    p.add_argument("--lm_checkpoint", default=None)
    p.add_argument("--lm_model", default="tiny",
                   choices=["tiny", "gpt2", "gpt2-medium", "gpt2-large", "gpt2-xl"])
    p.add_argument("--lm_weight", type=float, default=0.3)
    p.add_argument("--max_decode_len", type=int, default=200)
    p.add_argument("--beam_size", type=int, default=1,
                   help="beams per stream in --continuous mode")
    p.add_argument("--length_penalty", type=float, default=1.0)
    p.add_argument("--batch_seconds", type=float, default=20.0)
    p.add_argument("--attn_impl", choices=["dense", "flash"], default="dense",
                   help="'flash' runs kernel B1 in the encoder; lets "
                        "--batch_seconds reach minutes")
    p.add_argument("--tiny", action="store_true", help="tiny ASR config (smoke)")
    p.add_argument("--limit_episodes", type=int, default=None)
    p.add_argument("--continuous", action="store_true",
                   help="decode all episodes concurrently in the continuous "
                        "batcher (slot = episode stream)")
    p.add_argument("--slots", type=int, default=4,
                   help="concurrent episode slots for --continuous")
    p.add_argument("--chunk_steps", type=int, default=16,
                   help="decode steps per host round-trip (--continuous)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch versions")
    return p.parse_args(argv)


def load_fusion_lm(args, dev):
    """The fusion LM of the flags (the JAX pipeline's rule), or None."""
    from ..decode.fusion import FusionLM
    from ..models.gpt2 import model as g
    from .eval_ppl import load_gpt2

    if args.lm_checkpoint is None and args.lm_model == "tiny":
        return None
    tiny = args.lm_model == "tiny"
    cfg = (g.tiny_gpt2_config(vocab_size=256, n_embd=32, n_head=4, n_positions=512)
           if tiny else g.PRESETS[args.lm_model])
    model = load_gpt2(args.lm_checkpoint, cfg, dev, tiny=tiny)
    if model.cfg.vocab_size != args.vocab_size:
        raise SystemExit(f"fusion adds LM and ASR log-probs: the LM's vocabulary "
                         f"({model.cfg.vocab_size}) must be the ASR one ({args.vocab_size})")
    return FusionLM(model, weight=args.lm_weight)


def _ids(toks, length: int, eos: int):
    return [int(t) for t in toks[:length] if int(t) != eos]


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    from ..data import podcasts
    from ..data.tokenizer import load_tokenizer
    from ..decode.long_audio import transcribe_long_audio
    from ..models.speecht5.config import SpeechT5Config, tiny_config
    from ..ops.audio import load_audio
    from ..utils.device import resolve_device
    from ..utils.metrics import MetricsWriter, Stopwatch
    from . import common

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.out_dir, exist_ok=True)
    tokenizer = load_tokenizer(args.tokenizer)
    if args.tokenizer == "char":
        tokenizer.vocab_size = args.vocab_size
    cfg = (tiny_config(vocab_size=args.vocab_size, apply_spec_augment=False)
           if args.tiny else SpeechT5Config(vocab_size=args.vocab_size))
    model = common.load_speecht5_params(args.checkpoint, cfg, device=dev, variant="asr")
    fusion = load_fusion_lm(args, dev)

    episodes = podcasts.load_manifest(args.manifest)
    if args.limit_episodes:
        episodes = episodes[: args.limit_episodes]
    metrics = MetricsWriter(os.path.join(args.out_dir, "metrics.jsonl"))

    if args.continuous:
        return _run_continuous(args, model, fusion, tokenizer, episodes, metrics)

    for ep in episodes:
        watch = Stopwatch()
        wav, sr = load_audio(ep.audio_path, 16000)
        segments = [(s.start, s.end) for s in ep.segments] if ep.segments else None
        out = transcribe_long_audio(
            model, wav, sr, segments=segments, fusion=fusion,
            max_decode_len=args.max_decode_len, batch_seconds=args.batch_seconds,
            tokenizer=tokenizer, attn_impl=args.attn_impl)
        with open(os.path.join(args.out_dir, f"{ep.episode_id}.jsonl"), "w",
                  encoding="utf-8") as f:
            for seg in out:
                f.write(json.dumps({"start": seg.start, "end": seg.end, "text": seg.text,
                                    "token_ids": seg.token_ids}) + "\n")
        rtfx = watch.rtfx(len(wav) / sr)
        metrics.log(episode=ep.episode_id, segments=len(out), rtfx=rtfx)
        print(f"{ep.episode_id}: {len(out)} segments, RTFx {rtfx:.1f}", file=sys.stderr)
    return 0


def _run_continuous(args, model, fusion, tokenizer, episodes, metrics) -> int:
    """Every episode a conversation stream of the continuous batcher, the
    slots freed by short episodes taking the next one.  Per-episode WER is
    scored against the manifest's segment texts where it has them."""
    import numpy as np

    from ..data.podcasts import segment_by_energy
    from ..decode.batcher import (decode_continuous, decode_continuous_beam,
                                  decode_conversations)
    from ..ops.audio import load_audio
    from ..utils.metrics import Stopwatch
    from ..utils.wer import wer

    sr = 16000
    eos = model.cfg.eos_token_id
    bucket = int(args.batch_seconds * sr)
    convs, spans, refs, audio_seconds = [], {}, {}, 0.0
    for ep in episodes:
        wav, _ = load_audio(ep.audio_path, sr)
        audio_seconds += len(wav) / sr
        if ep.segments:
            segs = [(s.start, s.end, s.text) for s in ep.segments]
        else:
            segs = [(a, b, None) for a, b in
                    segment_by_energy(wav, sr, max_segment_s=args.batch_seconds)]
        chunks, kept, texts = [], [], []
        # a dropped empty segment drops its reference text too, or every
        # later hypothesis would be scored against the wrong line
        for start, end, text in segs:
            chunk = wav[int(start * sr): int(end * sr)][:bucket]
            if len(chunk) == 0:
                continue
            chunks.append(chunk.astype(np.float32))
            kept.append((start, end))
            texts.append(text)
        convs.append((ep.episode_id, chunks))
        spans[ep.episode_id] = kept
        refs[ep.episode_id] = texts if ep.segments and any(t for t in texts) else None

    watch = Stopwatch()
    if fusion is not None:
        results = decode_conversations(
            model, convs, fusion=fusion, slots=args.slots, chunk_steps=args.chunk_steps,
            max_len=args.max_decode_len, beam_size=args.beam_size,
            length_penalty=args.length_penalty, audio_samples=bucket,
            decode_reserve=args.max_decode_len + 8)   # transcribe_long_audio's
    else:
        utts = [(f"{cid}::{i}", w) for cid, chunks in convs for i, w in enumerate(chunks)]
        if args.beam_size > 1:
            flat = decode_continuous_beam(
                model, utts, slots=args.slots, beam_size=args.beam_size,
                length_penalty=args.length_penalty, chunk_steps=args.chunk_steps,
                max_len=args.max_decode_len, audio_samples=bucket)
        else:
            flat = decode_continuous(model, utts, slots=args.slots,
                                     chunk_steps=args.chunk_steps,
                                     max_len=args.max_decode_len, audio_samples=bucket)
        results = {cid: [flat[f"{cid}::{i}"] for i in range(len(chunks))]
                   for cid, chunks in convs}

    corpus_rtfx = watch.rtfx(audio_seconds)
    for cid, _ in convs:
        hyps = []
        with open(os.path.join(args.out_dir, f"{cid}.jsonl"), "w", encoding="utf-8") as f:
            for (toks, length), (start, end) in zip(results[cid], spans[cid]):
                ids = _ids(toks, length, eos)
                text = tokenizer.decode(ids) if tokenizer is not None and ids else ""
                hyps.append(text)
                f.write(json.dumps({"start": start, "end": end, "text": text,
                                    "token_ids": ids}) + "\n")
        row = {"episode": cid, "segments": len(hyps), "corpus_rtfx": corpus_rtfx}
        if refs[cid] is not None:
            row["wer"] = wer(refs[cid][:len(hyps)], hyps)
        metrics.log(**row)
        print(f"{cid}: {len(hyps)} segments"
              + (f", WER {row['wer'] * 100:.2f}%" if "wer" in row else "")
              + f" (corpus RTFx {corpus_rtfx:.1f})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
