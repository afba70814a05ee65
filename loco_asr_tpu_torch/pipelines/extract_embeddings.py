"""Extract SpeechT5 encoder embeddings for SLURP on the GPU: the audio
branch of ``loco_asr_tpu.pipelines.extract_embeddings``.

CLI (same flags as the JAX pipeline, plus ``--device``):
  --modality/-m {text,audio}   --split/-s {train,devel,test,train_synthetic}
  --version {fine_tuned,base}  --data_path  --out_dir  --checkpoint (.npz)
  --batch_size  --format {npz,pickle}  --dtype  --limit  --data_parallel
  --device (default cuda; cpu runs the plain PyTorch versions)

Audio is decoded on host threads into batches padded to whole seconds;
each batch runs one ``encode_speech`` (kernels B2 and B1 on the GPU) and
each utterance's embedding is cropped to its valid frames.  Not ported
yet, and refused with an error: ``-m text``, ``--data_parallel > 1`` and
``--dtype bfloat16``.
"""

from __future__ import annotations

import argparse
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Extract embeddings from SLURP data with SpeechT5 (CUDA)")
    p.add_argument("--modality", "-m", choices=["text", "audio"], required=True)
    p.add_argument("--split", "-s", required=True,
                   choices=["train", "devel", "test", "train_synthetic"])
    p.add_argument("--version", "-v", choices=["fine_tuned", "base"],
                   default="fine_tuned")
    p.add_argument("--data_path", default="slurp")
    p.add_argument("--out_dir", default=None,
                   help="default: extracted/speecht5[_base]/{split}/{modality}")
    p.add_argument("--checkpoint", default=None,
                   help=".npz checkpoint of the JAX package (default: random init)")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--format", choices=["npz", "pickle"], default="npz")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    p.add_argument("--limit", type=int, default=None, help="cap utterances (smoke)")
    p.add_argument("--data_parallel", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch versions")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.modality != "audio":
        raise SystemExit("-m text is not supported by this package yet "
                         "(use loco_asr_tpu.pipelines.extract_embeddings)")
    if args.data_parallel > 1:
        raise SystemExit("--data_parallel > 1 is not supported by this package yet")
    if args.dtype != "float32":
        raise SystemExit("--dtype bfloat16 is not supported by this package yet")

    from ..data import embedding_store, slurp
    from ..models.speecht5 import model as st5
    from ..models.speecht5.config import SpeechT5Config
    from ..ops import audio
    from ..utils.metrics import MetricsWriter, Stopwatch
    from . import common

    folder = "extracted/speecht5" if args.version == "fine_tuned" else "extracted/speecht5_base"
    out_dir = args.out_dir or os.path.join(folder, args.split, args.modality)

    ds = slurp.SlurpDataset(args.data_path, mode=args.split, task="intent")
    examples = ds.examples[: args.limit] if args.limit else ds.examples
    print(f"{args.split} set size: {len(examples)}", file=sys.stderr)

    cfg = SpeechT5Config()
    model = common.load_speecht5_params(args.checkpoint, cfg, device=args.device)

    writer = embedding_store.EmbeddingShardWriter(out_dir) if args.format == "npz" else None
    pickle_records: List = []

    watch = Stopwatch()
    audio_seconds = 0.0
    n_done = 0
    with ThreadPoolExecutor(max_workers=8) as pool:
        for batch in slurp.batched(examples, args.batch_size):
            targets = [slurp.onehot_intent(e.label) for e in batch]
            wavs = list(pool.map(lambda e: audio.load_audio(e.audio_path, 16000)[0],
                                 batch))
            audio_seconds += sum(len(w) for w in wavs) / 16000.0
            max_len = common.round_up(max(len(w) for w in wavs), 16000)
            x = np.zeros((len(wavs), max_len), np.float32)
            mask = np.zeros((len(wavs), max_len), np.int32)
            for i, w in enumerate(wavs):
                x[i, :len(w)] = w
                mask[i, :len(w)] = 1
            hidden, fmask = st5.encode_speech(model, x, mask)
            hidden = hidden.float().cpu().numpy()
            flens = fmask.sum(-1).cpu().numpy()

            for e, t, n, emb in zip(batch, targets, flens, hidden):
                rec = emb[: int(n)]
                if writer is not None:
                    writer.add(e.slurp_id, rec, t)
                else:
                    pickle_records.append((e.slurp_id, rec, t))
            n_done += len(batch)
            print(f"\r {n_done}/{len(examples)}", end=" ", file=sys.stderr)
    print(file=sys.stderr)

    if writer is not None:
        writer.close()
    else:
        embedding_store.write_reference_pickles(out_dir, pickle_records)

    rec = MetricsWriter(os.path.join(out_dir, "metrics.jsonl")).log(
        split=args.split, modality=args.modality, records=n_done,
        wall_seconds=watch.elapsed(),
        audio_seconds=audio_seconds or None,
        rtfx=watch.rtfx(audio_seconds) if audio_seconds else None)
    if audio_seconds:
        print(f"RTFx: {rec['rtfx']:.1f}", file=sys.stderr)
    print(f"Done! Wrote {n_done} records to {out_dir}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
