"""Cross-utterance conversation context for fused decoding, as in
``loco_asr_tpu.decode.context``: the fusion LM's KV cache persists across
the utterances of a conversation, so utterance n is scored conditioned on
utterances 1..n-1 without recomputing them.

Offsets are kept per stream: each stream's keys and values land at its own
contiguous positions (``gpt2_forward`` with a [B] ``cache_index``), so
every slot below a stream's offset is real history and causality hides the
rest, and a batch of streams decodes as each stream would alone.

Rolling policy: when any stream's history would pass ``max_positions -
decode_reserve``, the oldest half of every stream's history is dropped and
the cache rebuilt by one forward over the right-padded kept tails.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.gpt2.model import KVCache
from .beam import BeamHypotheses, beam_search, tile_rows
from .fusion import FusionLM


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclasses.dataclass
class ConversationContext:
    """Per-conversation LM state for fused decoding (a batch of streams).

    Usage per utterance (the decode loop writes the cache it is given in
    place; hand the returned one back all the same, as beam search returns
    a new one):
        cache, start = ctx.state()      # start: [B] per-stream offsets
        toks, lens, cache = greedy_decode(..., fusion=lm, lm_cache=cache,
                                          lm_start=start,
                                          return_lm_cache=True)
        ctx.append(toks, lens, cache)
    """

    lm: FusionLM
    batch: int
    max_positions: Optional[int] = None
    decode_reserve: int = 128   # positions kept free for the next utterance

    def __post_init__(self):
        self.max_positions = self.max_positions or self.lm.cfg.n_positions
        # per-stream token history on the host, trimmed to true lengths
        self._history: List[List[np.ndarray]] = [[] for _ in range(self.batch)]
        self._cache = self.lm.init_cache(self.batch, self.max_positions)
        self._offsets = np.zeros((self.batch,), np.int64)

    @property
    def history_len(self) -> int:
        return int(self._offsets.max(initial=0))

    def state(self) -> Tuple[KVCache, torch.Tensor]:
        dev = self.lm.model.wte.weight.device
        return self._cache, torch.as_tensor(self._offsets, device=dev)

    def append(self, tokens, lengths, cache: Optional[KVCache] = None) -> None:
        """Fold a decoded utterance [B, L] with ``lengths`` [B] into the
        context; ``cache`` is the decode loop's LM cache.  When any stream's
        window would overflow, the kept tails are re-encoded from the host
        history."""
        if cache is not None:
            self._cache = cache
        tokens, lengths = _numpy(tokens), _numpy(lengths).astype(np.int64)
        for s in range(self.batch):
            self._history[s].append(tokens[s, :int(lengths[s])].astype(np.int64))
        self._offsets = self._offsets + lengths
        if self.history_len > self.max_positions - self.decode_reserve:
            self._refresh()

    def _refresh(self) -> None:
        """Drop the oldest half of each stream's history and rebuild the
        cache from the right-padded kept tails.  Pad slots only sit at or
        past a stream's new offset, where causality keeps them out of every
        later softmax."""
        limit = self.max_positions - self.decode_reserve
        tails = []
        for s in range(self.batch):
            hist = (np.concatenate(self._history[s]) if self._history[s]
                    else np.zeros((0,), np.int64))
            keep = min(len(hist) // 2, limit)
            tails.append(hist[len(hist) - keep:])
        max_keep = max((len(t) for t in tails), default=0)
        self._history = [[t] for t in tails]
        self._cache = self.lm.init_cache(self.batch, self.max_positions)
        self._offsets = np.asarray([len(t) for t in tails], np.int64)
        if max_keep > 0:
            padded = np.zeros((self.batch, max_keep), np.int64)
            for s, t in enumerate(tails):
                padded[s, :len(t)] = t
            dev = self.lm.model.wte.weight.device
            self.lm.prime(torch.as_tensor(padded, device=dev), self._cache,
                          torch.zeros(self.batch, dtype=torch.int64, device=dev))

    def reset(self) -> None:
        self._history = [[] for _ in range(self.batch)]
        self._cache = self.lm.init_cache(self.batch, self.max_positions)
        self._offsets = np.zeros((self.batch,), np.int64)


def beam_decode_with_context(model, encoder_hidden, encoder_mask,
                             ctx: ConversationContext, *, beam_size: int,
                             max_len: int = 100,
                             length_penalty: float = 1.0) -> BeamHypotheses:
    """One conversation utterance decoded with beam search and carry-over
    (the sequential reference of the batcher's beam conversation mode).

    Each stream's K beams start from the same carried LM state (the
    per-stream cache tiled over beams); afterwards the best hypothesis' LM
    cache row carries forward.  Returns the hypotheses; ``ctx`` advances by
    each stream's best."""
    k = beam_size
    cache, start = ctx.state()
    hyp, lm_cache = beam_search(
        model, encoder_hidden, encoder_mask, beam_size=k, max_len=max_len,
        length_penalty=length_penalty, fusion=ctx.lm, lm_cache=tile_rows(cache, k),
        lm_start=start, return_lm_cache=True)
    # rows are in hypothesis order: row i*K+0 is stream i's best
    best = {i: {n: c[::k].contiguous() for n, c in layer.items()}
            for i, layer in lm_cache.items()}
    ctx.append(hyp.tokens[:, 0], hyp.lengths[:, 0], best)
    return hyp
