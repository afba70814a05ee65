"""Greedy decoding of the SpeechT5 ASR model over the dense KV cache, the
``greedy_decode`` of ``loco_asr_tpu.decode.beam`` without LM fusion.

A Python loop over decode steps takes the place of ``lax.while_loop``; it
stops when every row has emitted EOS or after ``max_len`` steps.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.speecht5 import decoder as dec
from ..models.speecht5 import model as st5


@torch.no_grad()
def greedy_decode(model: st5.AsrModel, encoder_hidden: torch.Tensor,
                  encoder_mask: Optional[torch.Tensor], *, max_len: int = 100
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decode -> (tokens [B, max_len] int64, padded with pad after
    EOS; lengths [B], the non-pad count)."""
    cfg = model.cfg
    b = encoder_hidden.shape[0]
    dev = encoder_hidden.device
    caches = dec.init_decode_cache(cfg, b, max_len + 1, dev, encoder_hidden.dtype)
    cross = st5.asr_cross_cache(model, encoder_hidden)
    out = torch.full((b, max_len), cfg.pad_token_id, dtype=torch.int64, device=dev)
    tok = torch.full((b, 1), cfg.decoder_start_token_id, dtype=torch.int64, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    for t in range(max_len):
        logits = st5.asr_decode_step(model, tok, t, encoder_hidden, encoder_mask,
                                     caches, cross_caches=cross)
        nxt = torch.argmax(torch.log_softmax(logits.float(), dim=-1), dim=-1)
        nxt = torch.where(done, torch.full_like(nxt, cfg.pad_token_id), nxt)
        out[:, t] = nxt
        done = done | (nxt == cfg.eos_token_id)
        tok = nxt[:, None]
        if bool(done.all()):
            break
    return out, (out != cfg.pad_token_id).sum(dim=-1)
