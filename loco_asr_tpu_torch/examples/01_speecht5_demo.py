"""SpeechT5 pipeline demo on the card: the port of ``examples/01_speecht5_demo.py``
(the reference's notebook 1, 'SpeechT5 Demo': ASR, TTS, VC smoke-run).

    python -m loco_asr_tpu_torch.examples.01_speecht5_demo --tiny [--device cpu]

Runs with random weights out of the box (``--checkpoint`` takes any
SpeechT5 source ``pipelines/common.load_speecht5_params`` reads):

  waveform -> encoder -> beam decode        (ASR; kernels B2 and B1)
  text     -> encoder -> AR mel -> HiFi-GAN (TTS)
  waveform -> encoder -> mel                (VC; kernels B2 and B1)

On the card (the default) the speech encodes run kernels B2 and B1;
``--device cpu`` runs their plain versions.  Prints the lines of the JAX
script.
"""

import argparse

import numpy as np
import torch

from loco_asr_tpu_torch.decode.beam import decode_utterance_batch
from loco_asr_tpu_torch.models import speecht5 as st5
from loco_asr_tpu_torch.models.speecht5.config import SpeechT5Config, tiny_config
from loco_asr_tpu_torch.pipelines.common import load_speecht5_params
from loco_asr_tpu_torch.utils.device import resolve_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--tiny", action="store_true", help="tiny config (fast)")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--device", default="cuda", help="'cpu' runs the plain versions")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = tiny_config(apply_spec_augment=False) if args.tiny else SpeechT5Config()
    asr = load_speecht5_params(args.checkpoint, cfg, device=dev, variant="asr")
    tts = st5.tts_init(cfg, seed=1, device=dev)
    voc_cfg = st5.tiny_hifigan_config() if args.tiny else st5.HifiGanConfig()
    voc = st5.hifigan_init(voc_cfg, seed=2, device=dev)

    # --- ASR ---
    wav = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 16000)).astype(np.float32) * 0.1).to(dev)
    tokens, lengths = decode_utterance_batch(asr, wav, beam_size=4, max_len=20)
    print("ASR beam tokens:", tokens[0, : int(lengths[0])].cpu().numpy())

    # --- TTS ---
    ids = torch.tensor([[4, 7, 9, 12, 2]], device=dev)
    spk = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, cfg.speaker_embedding_dim)).astype(np.float32)).to(dev)
    mel, mel_lengths = st5.tts_generate(tts, ids, spk, maxlenratio=4.0)
    print("TTS mel:", tuple(mel.shape), "frames:", int(mel_lengths[0]))
    if voc_cfg.model_in_dim == mel.shape[-1]:
        with torch.no_grad():
            audio = st5.hifigan(voc, mel[:, : int(mel_lengths[0])])
        print("Vocoder waveform:", tuple(audio.shape))

    # --- VC (speech -> speech) ---
    s2s = st5.s2s_init(cfg, seed=3, device=dev)
    mel_in = torch.zeros((1, 4, cfg.num_mel_bins), device=dev)
    with torch.no_grad():
        _, vc_mel, _ = st5.s2s_forward(s2s, wav, mel_in, spk)
    print("VC mel:", tuple(vc_mel.shape))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
