"""Shallow-fusion LM for decoding, as in ``loco_asr_tpu.decode.fusion``: a
GPT-2-class LM scores hypotheses incrementally beside the ASR decoder, and
the decoders add ``weight * log p_lm`` to ``log p_asr``.

The LM must share the ASR vocabulary (an LM trained with the ASR
tokenizer; the GPT-2 model is vocabulary-agnostic).  Its state is the
incremental-mode KV cache of ``models/gpt2/model.py``, written in place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from ..models.gpt2 import model as g

Index = Union[int, torch.Tensor]


@dataclasses.dataclass
class FusionLM:
    """GPT-2 fusion scorer: ``weight * log_softmax(lm_logits)``."""

    model: g.GPT2Model
    weight: float = 0.3

    @property
    def cfg(self) -> g.GPT2Config:
        return self.model.cfg

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32) -> g.KVCache:
        return g.init_kv_cache(self.model, batch, max_len, dtype)

    @torch.no_grad()
    def prime(self, context_ids: torch.Tensor, cache: g.KVCache, start: Index,
              attention_mask: Optional[torch.Tensor] = None
              ) -> Tuple[g.KVCache, Index]:
        """Feed conversation-context tokens [B, T] into ``cache`` from
        offset ``start`` (int or [B]) on -> (cache, start + T).
        ``attention_mask``: optional [B, cache_len] validity over cache
        positions."""
        g.gpt2_forward(self.model, context_ids, attention_mask=attention_mask,
                       kv_caches=cache, cache_index=start)
        return cache, start + context_ids.shape[1]

    @torch.no_grad()
    def step(self, token_ids: torch.Tensor, step: Index, cache: g.KVCache,
             attention_mask: Optional[torch.Tensor] = None,
             write_mask: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, g.KVCache]:
        """One incremental step: [B, 1] tokens at position ``step`` (int or
        [B]) -> (weighted float32 log-probs [B, V], cache).
        ``attention_mask``: optional [B, cache_len] validity over cache
        positions; stale per-stream history tails must be masked here, since
        causality alone does not hide positions below ``step``.
        ``write_mask``: optional [B] bool with a [B] ``step``; rows where it
        is False do not write the cache (the in-place form of JAX's
        discarded update)."""
        logits, cache = g.gpt2_logits(self.model, token_ids,
                                      attention_mask=attention_mask,
                                      kv_caches=cache, cache_index=step,
                                      kv_write_mask=write_mask)
        return self.weight * torch.log_softmax(logits[:, -1].float(), dim=-1), cache
