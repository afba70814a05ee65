"""Long-form (episode-scale) transcription with conversation carry-over,
as in ``loco_asr_tpu.decode.long_audio``: BASELINE config 5, hour-long
audio decoded segment by segment while the fusion LM's KV cache carries
the running conversation context.

Per episode:
  1. segment (given timestamps or the energy endpointer);
  2. decode the segments one at a time (B = 1), in order, each cropped to
     ``batch_seconds`` and padded to whole seconds;
  3. greedy decoding, with shallow fusion where a fusion LM is given: the
     ``ConversationContext`` primes the LM with everything decoded so far
     and rolls its window over when it fills;
  4. emit (start, end, token ids, text) per segment.

The JAX module compiles one program per segment shape; here each segment
runs eagerly under ``torch.inference_mode``: one ``encode_speech`` (kernel
B2, and kernel B1 in every encoder layer under ``attn_impl="flash"``), the
decoder's cross-attention K/V projected once (``greedy_decode`` builds
them before its loop), then one decoder step a token.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.podcasts import segment_by_energy
from ..models.speecht5 import model as st5
from .beam import greedy_decode
from .context import ConversationContext
from .fusion import FusionLM


@dataclass
class TranscribedSegment:
    start: float
    end: float
    token_ids: List[int]
    text: str = ""


def transcribe_long_audio(
    model: st5.AsrModel, wav: np.ndarray, sr: int = 16000, *,
    segments: Optional[Sequence[Tuple[float, float]]] = None,
    fusion: Optional[FusionLM] = None,
    max_decode_len: int = 200,
    batch_seconds: float = 20.0,
    tokenizer=None,
    attn_impl: str = "dense",
    use_kernels: bool = True,
) -> List[TranscribedSegment]:
    """Transcribe an arbitrarily long waveform.

    One segment at a time (batch 1 keeps the conversation cache exact);
    segments longer than ``batch_seconds`` are cropped, empty ones skipped.
    Pass ``fusion`` for LM shallow fusion with cross-segment context
    carry-over.  ``attn_impl="flash"`` encodes each segment with kernel B1
    (raise ``batch_seconds`` into minutes: dense attention holds a
    [1, heads, T, T] score matrix); ``use_kernels=False`` runs the plain
    versions (B2's plain version, dense attention) whatever ``attn_impl``
    says."""
    if segments is None:
        segments = segment_by_energy(wav, sr, max_segment_s=batch_seconds)
    cfg = model.cfg
    dev = next(model.parameters()).device
    out: List[TranscribedSegment] = []
    max_samples = int(batch_seconds * sr)
    with torch.inference_mode():
        ctx = None
        if fusion is not None:
            ctx = ConversationContext(fusion, batch=1,
                                      max_positions=fusion.cfg.n_positions,
                                      decode_reserve=max_decode_len + 8)
        for start, end in segments:
            chunk = wav[int(start * sr): int(end * sr)][:max_samples]
            if len(chunk) == 0:
                continue
            pad = -len(chunk) % sr   # whole seconds, as the JAX program shapes
            x = np.zeros((1, len(chunk) + pad), np.float32)
            m = np.zeros_like(x, dtype=np.int32)
            x[0, :len(chunk)] = chunk
            m[0, :len(chunk)] = 1
            enc, enc_mask = st5.encode_speech(model, torch.from_numpy(x).to(dev),
                                              torch.from_numpy(m).to(dev),
                                              use_kernels=use_kernels,
                                              attn_impl=attn_impl)
            if ctx is not None:
                cache, off = ctx.state()
                toks, lens, cache = greedy_decode(
                    model, enc, enc_mask, max_len=max_decode_len, fusion=fusion,
                    lm_cache=cache, lm_start=off, return_lm_cache=True)
                ctx.append(toks, lens, cache)
            else:
                toks, lens = greedy_decode(model, enc, enc_mask, max_len=max_decode_len)
            row = toks[0, :int(lens[0])].tolist()
            ids = [t for t in row if t != cfg.eos_token_id]
            text = tokenizer.decode(ids) if tokenizer is not None and ids else ""
            out.append(TranscribedSegment(start, end, ids, text))
    return out
