"""Continuous-batching decode (iteration-level scheduling), as in
``loco_asr_tpu.decode.batcher``.

Static batching runs each batch until its slowest utterance finishes.
The batcher keeps a fixed set of decode slots on the device, each at its
own decode step (per-row cache offsets), and refills a slot once its
stream has finished.  The host admits new utterances between bursts of
``chunk_steps`` device steps and reads the slots' state once per burst;
no step inside a burst waits for the host.

Slot state lives in tensors that the steps update in place (the JAX
package threads new state through jitted programs instead; PyTorch has
nothing to compile, so there is no program cache).

Numerics: slots are independent rows of one batch, so each utterance
decodes to the tokens of the static ``greedy_decode`` / ``beam_search``
of that utterance alone, and conversation streams to those of
``ConversationContext`` run sequentially.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..models.gpt2.model import KVCache
from ..models.speecht5 import decoder as dec
from ..models.speecht5 import model as st5
from ..models.speecht5.config import SpeechT5Config
from .beam import NEG_INF, beam_init_scores, reorder_rows, top_k_lower_first
from .fusion import FusionLM

Results = Dict[str, Tuple[np.ndarray, int]]


def _rows(sel: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``sel`` [N] shaped to broadcast over the rows of ``x`` [N, ...]."""
    return sel.reshape((-1,) + (1,) * (x.dim() - 1))


def _zero_rows(cache: KVCache, sel: torch.Tensor) -> None:
    for layer in cache.values():
        for c in layer.values():
            c.masked_fill_(_rows(sel, c), 0.0)


@dataclasses.dataclass
class SlotState:
    """Device state of S decode slots."""
    enc: torch.Tensor        # [S, Tf, H] encoder hidden per slot
    enc_mask: torch.Tensor   # [S, Tf] frame validity
    caches: KVCache          # per-layer self-attention KV, [S, H, max_len+1, hd]
    step: torch.Tensor       # [S] per-slot decode position
    last: torch.Tensor       # [S, 1] last token (the next step's input)
    done: torch.Tensor       # [S] bool
    out: torch.Tensor        # [S, max_len] emitted tokens


def init_slots(cfg: SpeechT5Config, slots: int, enc_frames: int, max_len: int,
               device, dtype=torch.float32) -> SlotState:
    """All slots empty (done, so they decode pads until admitted)."""
    full = lambda shape, v: torch.full(shape, v, dtype=torch.int64, device=device)
    return SlotState(
        enc=torch.zeros((slots, enc_frames, cfg.hidden_size), dtype=dtype, device=device),
        enc_mask=torch.zeros((slots, enc_frames), dtype=torch.int32, device=device),
        caches=dec.init_decode_cache(cfg, slots, max_len + 1, device, dtype),
        step=full((slots,), 0), last=full((slots, 1), cfg.decoder_start_token_id),
        done=torch.ones(slots, dtype=torch.bool, device=device),
        out=full((slots, max_len), cfg.pad_token_id))


def _insert_many(cfg: SpeechT5Config, state: SlotState, sel: torch.Tensor,
                 enc_new: torch.Tensor, mask_new: torch.Tensor,
                 lm_cache: Optional[KVCache] = None,
                 keep_lm: Optional[torch.Tensor] = None) -> None:
    """Admit utterances into every slot with ``sel[s]`` (fresh step, cache
    and output), in place.  ``enc_new`` / ``mask_new`` are [S, ...]; their
    unselected rows are ignored.  ``keep_lm`` [S] bool: slots whose LM
    cache survives the admission (conversation carry-over); decoder caches
    always reset."""
    state.enc = torch.where(_rows(sel, enc_new), enc_new, state.enc)
    state.enc_mask = torch.where(_rows(sel, mask_new), mask_new.to(state.enc_mask.dtype),
                                 state.enc_mask)
    _zero_rows(state.caches, sel)
    state.step = state.step.masked_fill(sel, 0)
    state.last = state.last.masked_fill(sel[:, None], cfg.decoder_start_token_id)
    state.done = state.done & ~sel
    state.out = state.out.masked_fill(sel[:, None], cfg.pad_token_id)
    if lm_cache is not None:
        _zero_rows(lm_cache, sel if keep_lm is None else sel & ~keep_lm)


@torch.no_grad()
def _run_chunk(cfg: SpeechT5Config, model: st5.AsrModel, n_steps: int, max_len: int,
               state: SlotState, fusion: Optional[FusionLM] = None,
               lm_cache: Optional[KVCache] = None,
               lm_off: Optional[torch.Tensor] = None) -> None:
    """``n_steps`` greedy steps over all slots, in place (done slots are
    inert).  With ``fusion`` the LM scores each step at the slot's own
    position, ``lm_off + step`` with per-slot history offsets ``lm_off``
    (conversation carry-over).  Slots already done at the top of a step do
    not write the LM cache: with carry-over a post-EOS write would land
    where the next utterance's first token goes (JAX's ``freeze_lm``)."""
    rows = torch.arange(state.step.shape[0], device=state.step.device)
    cross = st5.asr_cross_cache(model, state.enc)   # loop-invariant
    for _ in range(n_steps):
        logits = st5.asr_decode_step(model, state.last, state.step, state.enc,
                                     state.enc_mask, state.caches, cross_caches=cross)
        logp = torch.log_softmax(logits.float(), dim=-1)
        if fusion is not None:
            pos = state.step if lm_off is None else lm_off + state.step
            lm_logp, _ = fusion.step(state.last, pos, lm_cache, write_mask=~state.done)
            logp = logp + lm_logp
        nxt = torch.argmax(logp, dim=-1).masked_fill(state.done, cfg.pad_token_id)
        pos = state.step.clamp(max=max_len - 1)
        state.out[rows, pos] = torch.where(state.done, state.out[rows, pos], nxt)
        done = state.done | (nxt == cfg.eos_token_id)
        state.step = torch.where(state.done, state.step, state.step + 1)
        state.done = done | (state.step >= max_len)
        state.last = nxt[:, None]


@dataclasses.dataclass
class BeamSlotState:
    """Device state of S beam-decode slots of K beams each: enc, enc_mask
    and caches are beam-flat ([S*K, ...]), the bookkeeping [S, K]."""
    enc: torch.Tensor        # [S*K, Tf, H]
    enc_mask: torch.Tensor   # [S*K, Tf]
    caches: KVCache          # [S*K, H, max_len+1, hd] per layer
    step: torch.Tensor       # [S] per-slot decode position
    tokens: torch.Tensor     # [S, K, max_len]
    scores: torch.Tensor     # [S, K] raw log-prob sums
    lengths: torch.Tensor    # [S, K] tokens emitted incl. eos
    done: torch.Tensor       # [S, K]
    last: torch.Tensor       # [S, K] last emitted token


def _beam_init_slots(cfg: SpeechT5Config, slots: int, k: int, enc_frames: int,
                     max_len: int, device, dtype=torch.float32) -> BeamSlotState:
    full = lambda shape, v: torch.full(shape, v, dtype=torch.int64, device=device)
    return BeamSlotState(
        enc=torch.zeros((slots * k, enc_frames, cfg.hidden_size), dtype=dtype, device=device),
        enc_mask=torch.zeros((slots * k, enc_frames), dtype=torch.int32, device=device),
        caches=dec.init_decode_cache(cfg, slots * k, max_len + 1, device, dtype),
        step=full((slots,), 0), tokens=full((slots, k, max_len), cfg.pad_token_id),
        scores=beam_init_scores(slots, k, device), lengths=full((slots, k), 0),
        done=torch.ones((slots, k), dtype=torch.bool, device=device),
        last=full((slots, k), cfg.decoder_start_token_id))


def _beam_insert_many(cfg: SpeechT5Config, k: int, state: BeamSlotState,
                      sel: torch.Tensor, enc_new: torch.Tensor, mask_new: torch.Tensor,
                      lm_cache: Optional[KVCache] = None,
                      keep_lm: Optional[torch.Tensor] = None) -> None:
    """Admit new utterances into the selected slots, in place (``sel`` [S];
    ``enc_new`` / ``mask_new`` [S, ...] are repeated over each slot's K
    beams).  ``keep_lm`` [S] bool: slots whose LM rows survive (beam
    conversation carry-over); decoder caches always reset."""
    sel_flat = sel.repeat_interleave(k)
    enc_t, mask_t = enc_new.repeat_interleave(k, dim=0), mask_new.repeat_interleave(k, dim=0)
    state.enc = torch.where(_rows(sel_flat, enc_t), enc_t, state.enc)
    state.enc_mask = torch.where(_rows(sel_flat, mask_t), mask_t.to(state.enc_mask.dtype),
                                 state.enc_mask)
    _zero_rows(state.caches, sel_flat)
    s1 = sel[:, None]
    state.step = state.step.masked_fill(sel, 0)
    state.tokens = state.tokens.masked_fill(sel[:, None, None], cfg.pad_token_id)
    state.scores = torch.where(s1, beam_init_scores(sel.shape[0], k, sel.device), state.scores)
    state.lengths = state.lengths.masked_fill(s1, 0)
    state.done = state.done & ~s1
    state.last = state.last.masked_fill(s1, cfg.decoder_start_token_id)
    if lm_cache is not None:
        lm_sel = sel_flat if keep_lm is None else sel_flat & ~keep_lm.repeat_interleave(k)
        _zero_rows(lm_cache, lm_sel)


@torch.no_grad()
def _beam_run_chunk(cfg: SpeechT5Config, model: st5.AsrModel, k: int, n_steps: int,
                    max_len: int, state: BeamSlotState,
                    fusion: Optional[FusionLM] = None,
                    lm_cache: Optional[KVCache] = None,
                    lm_off: Optional[torch.Tensor] = None,
                    early_stop_lp: Optional[float] = None) -> None:
    """``n_steps`` beam steps over all slots, in place: the per-step math of
    ``beam_search`` with per-slot offsets.  Slots whose beams are all done
    keep their state; with ``fusion`` they do not write the beam-flat LM
    cache either (the LM rows of the other slots are reordered by parent
    beam each step, as in ``beam_search``).  Their decoder rows are
    written and reordered all the same: nothing reads them before the
    slot's next admission resets them.

    ``early_stop_lp`` (the decode's GNMT length penalty): a slot also
    retires once no live beam can still beat its best finished hypothesis.
    Raw scores never rise and the penalty q(L) = ((5+L)/6)^p is monotone in
    L, so a live beam of score s and length l is bounded by
    s / max(q(l), q(max_len)); once the best finished normalized score
    exceeds every live bound, the outcome is decided."""
    s, v = state.step.shape[0], cfg.vocab_size
    dev = state.step.device
    pad_row = torch.full((v,), NEG_INF, device=dev)
    pad_row[cfg.pad_token_id] = 0.0
    base = torch.arange(s, device=dev)[:, None] * k
    cross = st5.asr_cross_cache(model, state.enc)   # loop-invariant
    q = lambda L: ((5.0 + L) / 6.0) ** early_stop_lp
    for _ in range(n_steps):
        slot_done = state.done.all(dim=1)                              # [S]
        step_flat = state.step.repeat_interleave(k)                    # [S*K]
        last_flat = state.last.reshape(s * k, 1)
        logits = st5.asr_decode_step(model, last_flat, step_flat, state.enc,
                                     state.enc_mask, state.caches, cross_caches=cross)
        logp = torch.log_softmax(logits.float(), dim=-1)
        if fusion is not None:
            pos = step_flat if lm_off is None else lm_off.repeat_interleave(k) + step_flat
            lm_logp, _ = fusion.step(last_flat, pos, lm_cache,
                                     write_mask=~slot_done.repeat_interleave(k))
            logp = logp + lm_logp
        logp = torch.where(state.done[..., None], pad_row, logp.reshape(s, k, v))
        top_scores, top_idx = top_k_lower_first(
            (state.scores[..., None] + logp).reshape(s, k * v), k)
        parent, tok = top_idx // v, top_idx % v

        pos = state.step.clamp(max=max_len - 1)[:, None, None].expand(-1, k, 1)
        tokens = state.tokens.gather(1, parent[..., None].expand(-1, -1, max_len))
        tokens.scatter_(2, pos, torch.where(slot_done[:, None], tokens.gather(2, pos)[..., 0],
                                            tok)[..., None])
        done = state.done.gather(1, parent)
        lengths = state.lengths.gather(1, parent)
        lengths = torch.where(done | slot_done[:, None], lengths, lengths + 1)
        done = done | (tok == cfg.eos_token_id)
        flat = (base + parent).reshape(-1)
        reorder_rows(state.caches, flat)
        if fusion is not None:
            reorder_rows(lm_cache, flat)
        step = torch.where(slot_done, state.step, state.step + 1)
        done = done | (step >= max_len)[:, None]
        if early_stop_lp is not None:
            lens_f = lengths.float().clamp(min=1.0)
            fin_norm = torch.where(done, top_scores / q(lens_f), NEG_INF).amax(dim=1)
            bound_q = torch.clamp(q(lens_f), min=q(float(max_len)))
            live_bound = torch.where(done, NEG_INF, top_scores / bound_q).amax(dim=1)
            done = done | (fin_norm > live_bound)[:, None]
        keep = slot_done[:, None]
        state.step = step
        state.tokens = torch.where(keep[..., None], state.tokens, tokens)
        state.scores = torch.where(keep, state.scores, top_scores)
        state.lengths = torch.where(keep, state.lengths, lengths)
        state.done = torch.where(keep, state.done, done)
        state.last = torch.where(keep, state.last, tok)


def _new_state(cfg: SpeechT5Config, slots: int, k: int, enc: torch.Tensor, max_len: int):
    """Empty slots sized from the first encode: beam slots when ``k`` > 1."""
    if k > 1:
        return _beam_init_slots(cfg, slots, k, enc.shape[1], max_len, enc.device, enc.dtype)
    return init_slots(cfg, slots, enc.shape[1], max_len, enc.device, enc.dtype)


def _insert(cfg: SpeechT5Config, k: int, state, sel, enc, enc_mask, lm_cache,
            keep_lm=None) -> None:
    if k > 1:
        _beam_insert_many(cfg, k, state, sel, enc, enc_mask, lm_cache, keep_lm)
    else:
        _insert_many(cfg, state, sel, enc, enc_mask, lm_cache, keep_lm)


def _run(cfg: SpeechT5Config, model, k: int, n_steps: int, max_len: int, state,
         fusion, lm_cache, lm_off, length_penalty: float) -> np.ndarray:
    """One burst of ``n_steps`` steps, then the host's one read of which
    slots are done ([S] bool)."""
    if k > 1:
        _beam_run_chunk(cfg, model, k, n_steps, max_len, state, fusion=fusion,
                        lm_cache=lm_cache, lm_off=lm_off, early_stop_lp=length_penalty)
        return state.done.all(dim=1).cpu().numpy()
    _run_chunk(cfg, model, n_steps, max_len, state, fusion=fusion, lm_cache=lm_cache,
               lm_off=lm_off)
    return state.done.cpu().numpy()


def _admission_bucket(n: int, slots: int) -> int:
    """The admission count rounded up to a power of two (at most
    ``slots``): each round encodes only the admitted utterances, in one of
    log2(slots)+1 batch sizes."""
    b = 1
    while b < n:
        b *= 2
    return min(b, slots)


def _encode_pending(encode_fn: Callable, model, pending, slots: int,
                    audio_samples: int, device):
    """Encode one admission round's utterances in a [bucket, T] batch ->
    (sel [S] bool, enc [S, ...], mask [S, ...]) on ``device``.  ``pending``
    holds (slot, waveform) pairs; row ``slot`` of enc / mask carries that
    slot's utterance, unselected rows repeat row 0 and are masked off by
    ``sel`` in the insert."""
    bucket = _admission_bucket(len(pending), slots)
    w = np.zeros((bucket, audio_samples), np.float32)
    m = np.zeros((bucket, audio_samples), np.int32)
    sel = np.zeros((slots,), bool)
    inv = np.zeros((slots,), np.int64)
    for r, (slot, wav) in enumerate(pending):
        w[r, :len(wav)] = wav
        m[r, :len(wav)] = 1
        sel[slot] = True
        inv[slot] = r
    enc, mask = encode_fn(model, w, m)
    inv_t = torch.as_tensor(inv, device=device)
    return (torch.as_tensor(sel, device=device), enc.index_select(0, inv_t),
            mask.index_select(0, inv_t))


def _default_encode(model, wav: np.ndarray, mask: np.ndarray):
    return st5.encode_speech(model, wav, mask)


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _check_bucket(items, audio_samples: int) -> None:
    for uid, w in items:
        if len(w) > audio_samples:
            raise ValueError(f"{uid}: {len(w)} samples > bucket {audio_samples}")


def _best_beam(scores: np.ndarray, lengths: np.ndarray, length_penalty: float) -> int:
    """The GNMT-best beam of one slot, on the host."""
    lens = np.maximum(lengths.astype(np.float32), 1.0)
    return int(np.argmax(scores / ((5.0 + lens) / 6.0) ** length_penalty))


def _decode_stream(model: st5.AsrModel, utterances, *, slots: int, beam_size: int,
                   chunk_steps: int, max_len: int, length_penalty: float,
                   audio_samples: Optional[int], encode_fn: Optional[Callable],
                   fusion: Optional[FusionLM]) -> Results:
    """The continuous batcher of :func:`decode_continuous` (``beam_size``
    1) and :func:`decode_continuous_beam`."""
    utts = list(utterances)
    if not utts:
        return {}
    cfg, dev, k = model.cfg, _device(model), beam_size
    audio_samples = audio_samples or max(len(w) for _, w in utts)
    _check_bucket(utts, audio_samples)
    encode_fn = encode_fn or _default_encode

    slot_owner: List[Optional[str]] = [None] * slots
    results: Results = {}
    queue = list(reversed(utts))          # pop() yields arrival order
    state = None                          # sized from the first encode
    lm_cache: Optional[KVCache] = None

    def admit(state, lm_cache):
        free = [i for i in range(slots) if slot_owner[i] is None]
        pending = []
        for slot in free[:len(queue)]:
            uid, wav = queue.pop()
            slot_owner[slot] = uid
            pending.append((slot, wav))
        if not pending:
            return state, lm_cache
        sel, enc, enc_mask = _encode_pending(encode_fn, model, pending, slots,
                                             audio_samples, dev)
        if state is None:
            state = _new_state(cfg, slots, k, enc, max_len)
            if fusion is not None:
                lm_cache = fusion.init_cache(slots * k, max_len + 1)
        _insert(cfg, k, state, sel, enc, enc_mask, lm_cache)
        return state, lm_cache

    state, lm_cache = admit(state, lm_cache)
    while any(o is not None for o in slot_owner):
        done = _run(cfg, model, k, chunk_steps, max_len, state, fusion, lm_cache, None,
                    length_penalty)
        finished = [i for i in range(slots) if slot_owner[i] is not None and done[i]]
        if not finished:
            continue
        for i, (toks, length, _) in zip(finished, _finished_hypotheses(
                cfg, state, finished, length_penalty)):
            results[slot_owner[i]] = (toks, length)
            slot_owner[i] = None
        state, lm_cache = admit(state, lm_cache)
    return results


def _finished_hypotheses(cfg: SpeechT5Config, state, slots: List[int],
                         length_penalty: float) -> List[Tuple[np.ndarray, int, int]]:
    """(tokens, length, beam) of each finished slot: greedy's output row
    (beam 0), or the GNMT-best beam, ranked on the host."""
    if isinstance(state, SlotState):
        out = state.out.cpu().numpy()
        return [(out[i].copy(), int((out[i] != cfg.pad_token_id).sum()), 0) for i in slots]
    tokens, scores, lengths = (x.cpu().numpy() for x in
                               (state.tokens, state.scores, state.lengths))
    best = [_best_beam(scores[i], lengths[i], length_penalty) for i in slots]
    return [(tokens[i, j].copy(), int(lengths[i, j]), j) for i, j in zip(slots, best)]


def decode_continuous_beam(
    model: st5.AsrModel, utterances: Iterable[Tuple[str, np.ndarray]], *,
    slots: int = 4, beam_size: int = 5, chunk_steps: int = 32, max_len: int = 100,
    length_penalty: float = 1.0, audio_samples: Optional[int] = None,
    encode_fn: Optional[Callable] = None, fusion: Optional[FusionLM] = None,
) -> Results:
    """Beam search with continuous batching: like :func:`decode_continuous`
    but each slot runs ``beam_size`` beams, and a slot is refilled once its
    search is decided (all beams finished, or the best finished hypothesis
    provably beats every live beam, ``_beam_run_chunk``'s
    ``early_stop_lp``).

    Returns {utt_id: (tokens, length)} of the length-penalty-best
    hypothesis: the tokens of per-utterance ``beam_search``."""
    return _decode_stream(model, utterances, slots=slots, beam_size=beam_size,
                          chunk_steps=chunk_steps, max_len=max_len,
                          length_penalty=length_penalty, audio_samples=audio_samples,
                          encode_fn=encode_fn, fusion=fusion)


def decode_continuous(
    model: st5.AsrModel, utterances: Iterable[Tuple[str, np.ndarray]], *,
    slots: int = 8, chunk_steps: int = 32, max_len: int = 100,
    audio_samples: Optional[int] = None, encode_fn: Optional[Callable] = None,
    fusion: Optional[FusionLM] = None,
) -> Results:
    """Greedy-decode a stream of utterances with continuous batching.  With
    ``fusion`` each step adds the weighted LM log-probs; the LM cache rides
    per slot at the slot's own offset and is reset on admission.

    Args:
      utterances: (utt_id, waveform [T] float32) pairs, right-padded to
        ``audio_samples`` (default: the longest; a longer one is an error).
      slots: decode slots (the fixed batch dimension).
      chunk_steps: decode steps between the host's reads of the slots.
      encode_fn: optional (model, wav [A, T] numpy, mask) -> (enc, enc_mask)
        in place of ``encode_speech``.  Each admission round encodes only
        the admitted utterances, the batch rounded up to a power of two.

    Returns {utt_id: (tokens [max_len], length)}: the tokens of
    per-utterance ``greedy_decode``."""
    return _decode_stream(model, utterances, slots=slots, beam_size=1,
                          chunk_steps=chunk_steps, max_len=max_len, length_penalty=1.0,
                          audio_samples=audio_samples, encode_fn=encode_fn, fusion=fusion)


def decode_conversations(
    model: st5.AsrModel, conversations: Iterable[Tuple[str, List[np.ndarray]]], *,
    fusion: FusionLM, slots: int = 4, chunk_steps: int = 16, max_len: int = 100,
    beam_size: int = 1, length_penalty: float = 1.0,
    audio_samples: Optional[int] = None, encode_fn: Optional[Callable] = None,
    max_positions: Optional[int] = None, decode_reserve: int = 128,
) -> Dict[str, List[Tuple[np.ndarray, int]]]:
    """Continuous batching over conversation streams with LM carry-over: a
    slot holds one conversation, and the fusion LM's KV cache persists
    across its utterances, so utterance n is scored conditioned on
    utterances 1..n-1.  A slot keeps its conversation until the last
    utterance finishes, then takes the next conversation (LM state reset).

    Rolling window: a slot whose history passes ``max_positions -
    decode_reserve`` drops the oldest half and re-primes the kept tail
    (``ConversationContext._refresh``, on that slot alone).

    ``beam_size > 1`` runs beam search in each slot (K beams conditioned on
    the stream's carried history; the best hypothesis' LM state carries
    forward).

    Per conversation the tokens are those of ``greedy_decode`` (or
    ``beam_decode_with_context``) with ``ConversationContext(batch=1)`` run
    sequentially.  Returns {conv_id: [(tokens [max_len], length), ...]}."""
    if fusion is None:
        raise ValueError("conversation carry-over requires a fusion LM — "
                         "the carried state IS the LM context")
    convs = [(cid, list(wavs)) for cid, wavs in conversations]
    results: Dict[str, List[Tuple[np.ndarray, int]]] = {cid: [] for cid, _ in convs}
    convs = [(cid, wavs) for cid, wavs in convs if wavs]
    if not convs:
        return results
    max_positions = max_positions or fusion.cfg.n_positions
    if decode_reserve < max_len + 1:
        raise ValueError(
            f"decode_reserve={decode_reserve} must be >= max_len+1={max_len + 1}: "
            f"an utterance admitted at the window edge writes up to max_len LM "
            f"positions past its offset")
    if max_len + 1 > max_positions:
        raise ValueError(
            f"max_len={max_len} does not fit the LM context "
            f"(max_positions={max_positions}); lower max_len or use an LM with "
            f"a longer context")
    audio_samples = audio_samples or max(len(w) for _, wavs in convs for w in wavs)
    _check_bucket([(cid, w) for cid, wavs in convs for w in wavs], audio_samples)
    encode_fn = encode_fn or _default_encode
    cfg, dev, k = model.cfg, _device(model), beam_size

    queue = list(reversed(convs))              # pop() yields arrival order
    slot_conv: List[Optional[str]] = [None] * slots
    slot_wavs: List[list] = [[] for _ in range(slots)]
    slot_hist: List[list] = [[] for _ in range(slots)]
    lm_off = np.zeros((slots,), np.int64)
    state = None
    lm_cache: Optional[KVCache] = None

    def start_next_conversation(i, pending):
        if queue:
            cid, wavs = queue.pop()
            slot_conv[i], slot_wavs[i], slot_hist[i] = cid, list(reversed(wavs)), []
            lm_off[i] = 0
            pending.append((i, slot_wavs[i].pop(), False))

    def admit(state, lm_cache, pending):
        if not pending:
            return state, lm_cache
        keep = np.zeros((slots,), bool)
        for i, _, kp in pending:
            keep[i] = kp
        sel, enc, enc_mask = _encode_pending(encode_fn, model,
                                             [(i, wav) for i, wav, _ in pending],
                                             slots, audio_samples, dev)
        keep_t = torch.as_tensor(keep, device=dev)
        if state is None:
            state = _new_state(cfg, slots, k, enc, max_len)
            lm_cache = fusion.init_cache(slots * k, max_positions)
        _insert(cfg, k, state, sel, enc, enc_mask, lm_cache, keep_t)
        return state, lm_cache

    def refresh_slot(i):
        """``ConversationContext._refresh`` for one slot: drop the oldest
        half of the stream's history, prime the kept tail into a fresh row
        and put it in the slot's K rows."""
        hist = (np.concatenate(slot_hist[i]) if slot_hist[i]
                else np.zeros((0,), np.int64))
        keep = max(0, min(len(hist) // 2, max_positions - decode_reserve))
        tail = hist[len(hist) - keep:]
        slot_hist[i] = [tail]
        lm_off[i] = len(tail)
        row = fusion.init_cache(1, max_positions)
        if keep > 0:
            fusion.prime(torch.as_tensor(tail[None], device=dev), row,
                         torch.zeros(1, dtype=torch.int64, device=dev))
        for layer, row_layer in zip(lm_cache.values(), row.values()):
            for name, c in layer.items():
                c[i * k:(i + 1) * k] = row_layer[name]

    pending: List[Tuple[int, np.ndarray, bool]] = []
    for i in range(slots):
        start_next_conversation(i, pending)
    state, lm_cache = admit(state, lm_cache, pending)

    while any(c is not None for c in slot_conv):
        done = _run(cfg, model, k, chunk_steps, max_len, state, fusion, lm_cache,
                    torch.as_tensor(lm_off, device=dev), length_penalty)
        finished = [i for i in range(slots) if slot_conv[i] is not None and done[i]]
        if not finished:
            continue
        pending = []
        for i, (toks, length, best) in zip(finished, _finished_hypotheses(
                cfg, state, finished, length_penalty)):
            if k > 1:   # the best hypothesis' LM state goes to every beam row
                for layer in lm_cache.values():
                    for c in layer.values():
                        c[i * k:(i + 1) * k] = c[i * k + best].clone()
            results[slot_conv[i]].append((toks, length))
            slot_hist[i].append(toks[:length].astype(np.int64))
            lm_off[i] += length
            if lm_off[i] > max_positions - decode_reserve:
                refresh_slot(i)
            if slot_wavs[i]:
                pending.append((i, slot_wavs[i].pop(), True))
            else:
                slot_conv[i] = None
                start_next_conversation(i, pending)
        state, lm_cache = admit(state, lm_cache, pending)
    return results
