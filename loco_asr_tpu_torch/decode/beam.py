"""Greedy and beam decoding of the SpeechT5 ASR model over the dense KV
caches, with optional LM shallow fusion, as in ``loco_asr_tpu.decode.beam``.

A Python loop over decode steps takes the place of ``lax.while_loop`` /
``lax.fori_loop``.  The caches are written in place, and beam search
reorders them by parent beam with an ``index_select`` of every layer's k
and v each step.  Every ``CHECK_EVERY`` steps the host reads whether every
row (every beam of every row) has finished, and the loop stops there: a
finished batch is a fixed point of both searches (finished rows emit pad
at zero added score, and a finished beam's order no longer changes), so
the tokens, scores and lengths are those of the full-length JAX loops, and
the LM cache rows agree below each row's ``start + length``.

Tie rules follow JAX: ``argmax`` takes the first maximum, the beam's top-k
puts the lower flat index first among equal candidates (``lax.top_k``),
and the final ranking sorts stably (``jnp.argsort``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..models.gpt2.model import KVCache
from ..models.speecht5 import decoder as dec
from ..models.speecht5 import model as st5
from .fusion import FusionLM, Index

NEG_INF = -1.0e9
CHECK_EVERY = 8   # decode steps between the host's all-finished checks


def beam_init_scores(rows: int, k: int, device=None) -> torch.Tensor:
    """[rows, K] beam scores at step 0: only beam 0 live (shared by the
    static search and the continuous batcher, whose equality depends on
    the same init)."""
    init = torch.full((rows, k), NEG_INF, dtype=torch.float32, device=device)
    init[:, 0] = 0.0
    return init


class BeamHypotheses(NamedTuple):
    tokens: torch.Tensor      # [B, K, L] int64 (bos excluded)
    scores: torch.Tensor      # [B, K] raw log-prob sums
    lengths: torch.Tensor     # [B, K] tokens emitted incl. eos
    normalized: torch.Tensor  # [B, K] length-normalized scores (sorted desc)


def _length_penalty(lengths: torch.Tensor, alpha: float) -> torch.Tensor:
    """GNMT length penalty ((5+len)/6)^alpha."""
    return torch.pow((5.0 + lengths.float()) / 6.0, alpha)


def top_k_lower_first(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of each row of ``x``, descending, the lower
    index first among equal values (``jax.lax.top_k``'s order; a stable
    descending sort keeps equal entries in index order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def reorder_rows(cache: KVCache, idx: torch.Tensor) -> None:
    """Replace every layer's k and v of ``cache`` by its rows ``idx``."""
    for layer in cache.values():
        for name, c in layer.items():
            layer[name] = c.index_select(0, idx)


def tile_rows(cache: KVCache, k: int) -> KVCache:
    """Each row of every layer's k and v repeated ``k`` times ([B*K, ...])."""
    return {i: {n: c.repeat_interleave(k, dim=0) for n, c in layer.items()}
            for i, layer in cache.items()}


def _check_lm_room(fusion: FusionLM, lm_cache: KVCache, lm_start: Index,
                   max_len: int) -> None:
    """Refuse, before the loop, an LM cache (or ``n_positions``) without
    room for ``max_len`` positions from each row's ``lm_start`` on.  The
    loop's one-token writes at a [B] offset are not read back on the GPU
    (no host sync a step), so this one read stands in for their bounds
    check."""
    room = min(lm_cache["0"]["k"].shape[2], fusion.cfg.n_positions)
    last = int(lm_start.max()) if isinstance(lm_start, torch.Tensor) else int(lm_start)
    if last + max_len > room:
        raise ValueError(f"LM offset {last} + max_len {max_len} runs past the LM's "
                         f"{room} positions (cache length, n_positions)")


def _all_done(step: int, done: torch.Tensor) -> bool:
    return (step + 1) % CHECK_EVERY == 0 and bool(done.all())


@torch.no_grad()
def greedy_decode(model: st5.AsrModel, encoder_hidden: torch.Tensor,
                  encoder_mask: Optional[torch.Tensor], *, max_len: int = 100,
                  fusion: Optional[FusionLM] = None,
                  lm_cache: Optional[KVCache] = None, lm_start: Optional[Index] = None,
                  lm_mask: Optional[torch.Tensor] = None,
                  return_lm_cache: bool = False):
    """Greedy decode -> (tokens [B, max_len] int64, padded with pad after
    EOS; lengths [B], the non-pad count) and, with ``return_lm_cache``, the
    LM cache.

    With ``fusion`` each step adds the weighted LM log-probs.  Pass a primed
    ``lm_cache`` / ``lm_start`` (int or [B]) / ``lm_mask`` ([B, cache_len]
    validity) for conversation carry-over (``decode/context.py``); the loop
    writes that cache in place."""
    cfg = model.cfg
    b, dev = encoder_hidden.shape[0], encoder_hidden.device
    caches = dec.init_decode_cache(cfg, b, max_len + 1, dev, encoder_hidden.dtype)
    cross = st5.asr_cross_cache(model, encoder_hidden)
    if fusion is not None and lm_cache is None:
        lm_cache, lm_start = fusion.init_cache(b, max_len + 1), 0
    if fusion is not None:
        _check_lm_room(fusion, lm_cache, lm_start, max_len)
    out = torch.full((b, max_len), cfg.pad_token_id, dtype=torch.int64, device=dev)
    tok = torch.full((b, 1), cfg.decoder_start_token_id, dtype=torch.int64, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    for t in range(max_len):
        logits = st5.asr_decode_step(model, tok, t, encoder_hidden, encoder_mask,
                                     caches, cross_caches=cross)
        logp = torch.log_softmax(logits.float(), dim=-1)
        if fusion is not None:
            lm_logp, lm_cache = fusion.step(tok, lm_start + t, lm_cache,
                                            attention_mask=lm_mask)
            logp = logp + lm_logp
        nxt = torch.argmax(logp, dim=-1).masked_fill(done, cfg.pad_token_id)
        out[:, t] = nxt
        done = done | (nxt == cfg.eos_token_id)
        tok = nxt[:, None]
        if _all_done(t, done):
            break
    lengths = (out != cfg.pad_token_id).sum(dim=-1)
    if return_lm_cache:
        return out, lengths, lm_cache
    return out, lengths


@torch.no_grad()
def beam_search(model: st5.AsrModel, encoder_hidden: torch.Tensor,
                encoder_mask: Optional[torch.Tensor], *, beam_size: int = 5,
                max_len: int = 100, length_penalty: float = 1.0,
                fusion: Optional[FusionLM] = None,
                lm_cache: Optional[KVCache] = None, lm_start: Optional[Index] = None,
                lm_mask: Optional[torch.Tensor] = None,
                return_lm_cache: bool = False):
    """Batched beam search -> :class:`BeamHypotheses` (and, with
    ``return_lm_cache``, the LM cache).

    Finished beams are frozen (forced pad emission at zero added score); the
    final ranking applies the GNMT length penalty.  With ``fusion``, token
    scores are log p_asr + weight * log p_lm.

    Conversation carry-over: pass a primed, beam-flat ``lm_cache``
    ([B*K, ...], :func:`tile_rows` of the per-stream cache) and per-stream
    ``lm_start`` ([B] is repeated to [B*K]); with ``return_lm_cache`` the
    LM cache comes back in hypothesis order: row i*K+j is ranked hypothesis
    j of stream i."""
    cfg = model.cfg
    b, k, v = encoder_hidden.shape[0], beam_size, cfg.vocab_size
    dev = encoder_hidden.device
    enc = encoder_hidden.repeat_interleave(k, dim=0)               # [B*K, T, H]
    enc_mask = None if encoder_mask is None else encoder_mask.repeat_interleave(k, dim=0)
    caches = dec.init_decode_cache(cfg, b * k, max_len + 1, dev, encoder_hidden.dtype)
    cross = st5.asr_cross_cache(model, enc)
    if fusion is not None and lm_cache is None:
        lm_cache, lm_start = fusion.init_cache(b * k, max_len + 1), 0
    if isinstance(lm_start, torch.Tensor) and lm_start.dim() == 1 and lm_start.shape[0] == b:
        lm_start = lm_start.repeat_interleave(k)
    if fusion is not None:
        _check_lm_room(fusion, lm_cache, lm_start, max_len)
    lm_mask_k = None if lm_mask is None else lm_mask.repeat_interleave(k, dim=0)
    pad_row = torch.full((v,), NEG_INF, device=dev)
    pad_row[cfg.pad_token_id] = 0.0

    tokens = torch.full((b, k, max_len), cfg.pad_token_id, dtype=torch.int64, device=dev)
    scores = beam_init_scores(b, k, dev)
    lengths = torch.zeros((b, k), dtype=torch.int64, device=dev)
    done = torch.zeros((b, k), dtype=torch.bool, device=dev)
    last = torch.full((b, k), cfg.decoder_start_token_id, dtype=torch.int64, device=dev)
    base = torch.arange(b, device=dev)[:, None] * k
    for t in range(max_len):
        logits = st5.asr_decode_step(model, last.reshape(b * k, 1), t, enc, enc_mask,
                                     caches, cross_caches=cross)
        logp = torch.log_softmax(logits.float(), dim=-1)
        if fusion is not None:
            lm_logp, lm_cache = fusion.step(last.reshape(b * k, 1), lm_start + t,
                                            lm_cache, attention_mask=lm_mask_k)
            logp = logp + lm_logp
        logp = torch.where(done[..., None], pad_row, logp.reshape(b, k, v))
        top_scores, top_idx = top_k_lower_first((scores[..., None] + logp).reshape(b, k * v), k)
        parent, tok = top_idx // v, top_idx % v
        tokens = tokens.gather(1, parent[..., None].expand(-1, -1, max_len))
        tokens[:, :, t] = tok
        done = done.gather(1, parent)
        lengths = lengths.gather(1, parent)
        lengths = torch.where(done, lengths, lengths + 1)
        done = done | (tok == cfg.eos_token_id)
        flat = (base + parent).reshape(-1)
        reorder_rows(caches, flat)
        if fusion is not None:
            reorder_rows(lm_cache, flat)
        scores, last = top_scores, tok
        if _all_done(t, done):
            break

    normalized = scores / _length_penalty(lengths.clamp(min=1), length_penalty)
    order = torch.argsort(-normalized, dim=1, stable=True)
    hyps = BeamHypotheses(
        tokens=tokens.gather(1, order[..., None].expand(-1, -1, max_len)),
        scores=scores.gather(1, order), lengths=lengths.gather(1, order),
        normalized=normalized.gather(1, order))
    if not return_lm_cache:
        return hyps
    if lm_cache is not None:
        reorder_rows(lm_cache, (base + order).reshape(-1))
    return hyps, lm_cache


@torch.no_grad()
def decode_utterance_batch(model: st5.AsrModel, input_values, attention_mask=None, *,
                           beam_size: int = 1, max_len: int = 100,
                           length_penalty: float = 1.0,
                           fusion: Optional[FusionLM] = None,
                           use_kernels: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Waveform in, (tokens, lengths) of the best hypothesis out (encode +
    decode in one call; ``beam_size`` 1 is greedy).  ``use_kernels`` as in
    ``encode_speech``."""
    enc, mask = st5.encode_speech(model, input_values, attention_mask,
                                  use_kernels=use_kernels)
    if beam_size == 1:
        return greedy_decode(model, enc, mask, max_len=max_len, fusion=fusion)
    hyp = beam_search(model, enc, mask, beam_size=beam_size, max_len=max_len,
                      length_penalty=length_penalty, fusion=fusion)
    return hyp.tokens[:, 0], hyp.lengths[:, 0]
