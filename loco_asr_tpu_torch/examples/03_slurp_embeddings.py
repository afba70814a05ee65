"""SLURP embeddings on the card: the port of ``examples/03_slurp_embeddings.py``
(the reference's notebook 3: collate + encoder over SLURP batches).

    python -m loco_asr_tpu_torch.examples.03_slurp_embeddings --tiny [--device cpu]

Builds a seeded mini-SLURP when ``--data_path`` is absent, so the whole
extract -> inspect loop runs anywhere; the encode runs kernels B2 and B1
on the card.
"""

import argparse
import json
import os
import tempfile
import wave

import numpy as np

from loco_asr_tpu_torch.data.slurp import SlurpDataset, batched, onehot_intent
from loco_asr_tpu_torch.models.speecht5 import model as st5
from loco_asr_tpu_torch.models.speecht5.config import SpeechT5Config, tiny_config
from loco_asr_tpu_torch.ops import audio_io


def make_synthetic_slurp(root: str, n: int = 8) -> str:
    os.makedirs(os.path.join(root, "dataset/slurp"), exist_ok=True)
    os.makedirs(os.path.join(root, "audio/slurp_real"), exist_ok=True)
    rng = np.random.default_rng(0)
    intents = ["alarm_set", "play_music", "weather_query"]
    with open(os.path.join(root, "dataset/slurp/train.jsonl"), "w") as f:
        for i in range(n):
            fname = f"utt_{i}.wav"
            pcm = (rng.standard_normal(int(16000 * 0.4)) * 3000).astype(np.int16)
            with wave.open(os.path.join(root, "audio/slurp_real", fname), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes(pcm.tobytes())
            f.write(json.dumps({
                "slurp_id": i, "sentence": f"synthetic sentence {i}",
                "intent": intents[i % 3],
                "recordings": [{"file": fname}]}) + "\n")
    return root


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_path", default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda", help="'cpu' runs the plain versions")
    args = p.parse_args(argv)

    with tempfile.TemporaryDirectory() as tmp:
        data_path = args.data_path or make_synthetic_slurp(tmp)
        cfg = tiny_config(apply_spec_augment=False) if args.tiny else SpeechT5Config()
        model = st5.asr_init(cfg, seed=0, device=args.device)

        ds = SlurpDataset(data_path, mode="train", task="intent")
        print(f"dataset: {len(ds)} utterances, {len(ds.intents)} intents")

        for batch in batched(ds, 4):
            wavs = [audio_io.load_audio(e.audio_path, 16000)[0] for e in batch]
            T = max(len(w) for w in wavs)
            x = np.zeros((len(wavs), T), np.float32)
            m = np.zeros((len(wavs), T), np.int32)
            for i, w in enumerate(wavs):
                x[i, :len(w)] = w
                m[i, :len(w)] = 1
            _, fmask = st5.encode_speech(model, x, m)
            for e, n_frames in zip(batch, fmask.sum(-1).cpu().numpy()):
                tgt = onehot_intent(e.label)
                print(f"  slurp_id={e.slurp_id} frames={int(n_frames)} "
                      f"intent={e.label} (class {int(tgt.argmax())})")
            break
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
