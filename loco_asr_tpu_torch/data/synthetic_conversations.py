"""Synthetic conversation corpora with genuine cross-utterance dependencies:
a copy of ``loco_asr_tpu.data.synthetic_conversations`` (numpy and
``wave`` only), so that the port imports nothing of the JAX package.  For
the same arguments it writes byte-identical files.

The LoCo hypothesis — the experiment the reference exists for
(eval_ppl_with_pretrained_lm.py:67-73: the indep vs max_len PPL
comparison; the max_len machinery at :98-144 has no other purpose) — is
that conversation-level history improves language modeling and speech
recognition.  The real Fisher corpus cannot ship in this egress-free
container, so these generators build corpora where the hypothesis is TRUE
BY CONSTRUCTION and the context gain is therefore measurable offline:

* Every conversation (recording) carries a NAME: a ``name_len``-character
  word drawn from a large pool, appearing once per utterance.  Within a
  single utterance the name is unpredictable (pool-sized entropy, about
  ``name_len * ln(len(NAME_CHARS))`` nats); given the conversation
  history it is a pure copy (induction).  An evaluator that sees history
  (max_len windows, streaming, carry-over decoding) therefore beats an
  utterance-independent one by a margin bounded below by that entropy
  gap.  Dev conversations use names disjoint from training so the gain
  can only come from in-context copying, never memorization.

* The ASR twin (:func:`make_asr_corpus`) renders each character as a pure
  tone (space = silence) and DEGRADES the acoustics of every name
  occurrence after the first one (tone buried in noise): the waveform no
  longer identifies the name, the conversation history still does.  A
  fusion LM whose cache carries the conversation (decode_conversations /
  ConversationContext) recovers the name; the same LM without carry-over
  cannot.

Everything is numpy + stdlib: no network, no external assets.  Output is
Kaldi-format (text / wav.scp / segments) so the standard pipelines
(train_lm, eval_ppl, train_asr, decode_asr) consume it unchanged.
"""

from __future__ import annotations

import os
import wave as wave_mod
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

FILLER_CHARS = "abcdefghij"
NAME_CHARS = "klmnopqrst"
SR = 16000


def make_filler_vocab(rng: np.random.Generator, n: int = 24,
                      chars: str = FILLER_CHARS) -> List[str]:
    """Small vocabulary of 2-4 letter filler words over ``chars``."""
    vocab: List[str] = []
    seen = set()
    while len(vocab) < n:
        ln = int(rng.integers(2, 5))
        w = "".join(rng.choice(list(chars), ln))
        if w not in seen:
            seen.add(w)
            vocab.append(w)
    return vocab


def sample_names(rng: np.random.Generator, n: int, name_len: int = 5,
                 exclude: Sequence[str] = (),
                 chars: str = NAME_CHARS) -> List[str]:
    """``n`` distinct names of ``name_len`` chars over ``chars``."""
    out: List[str] = []
    seen = set(exclude)
    while len(out) < n:
        w = "".join(rng.choice(list(chars), name_len))
        if w not in seen:
            seen.add(w)
            out.append(w)
    return out


@dataclass
class Conversation:
    conv_id: str
    name: str
    utterances: List[str]          # transcript per utterance
    utt_ids: List[str]             # Fisher-style callid-side-start-end


def sample_conversation(rng: np.random.Generator, conv_id: str, name: str,
                        filler_vocab: Sequence[str], *, n_utts: int = 16,
                        filler_words: int = 4) -> Conversation:
    """One conversation: every utterance = filler words with the
    conversation's name inserted at a random word position."""
    utts, ids = [], []
    for u in range(n_utts):
        words = list(rng.choice(filler_vocab, filler_words))
        pos = int(rng.integers(0, len(words) + 1))
        words.insert(pos, name)
        utts.append(" ".join(words))
        start = u * 300                      # centiseconds, 3 s spacing
        end = start + 250
        ids.append(f"{conv_id}-A-{start:06d}-{end:06d}")
    return Conversation(conv_id, name, utts, ids)


def make_lm_corpus(out_dir: str, *, n_train: int = 200, n_dev: int = 40,
                   n_utts: int = 16, filler_words: int = 4,
                   name_len: int = 5, seed: int = 0,
                   ) -> Tuple[str, str]:
    """Write Kaldi ``train.txt`` / ``dev.txt`` text files (utt_id text per
    line, recid = first dash field) and return their paths.  Dev names are
    disjoint from train names."""
    rng = np.random.default_rng(seed)
    filler = make_filler_vocab(rng)
    train_names = sample_names(rng, n_train, name_len)
    dev_names = sample_names(rng, n_dev, name_len, exclude=train_names)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for split, names in (("train", train_names), ("dev", dev_names)):
        lines = []
        for c, name in enumerate(names):
            conv = sample_conversation(
                rng, f"{split}conv{c:04d}", name, filler,
                n_utts=n_utts, filler_words=filler_words)
            for uid, text in zip(conv.utt_ids, conv.utterances):
                lines.append(f"{uid} {text}")
        path = os.path.join(out_dir, f"{split}.txt")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        paths.append(path)
    return paths[0], paths[1]


# ---------------------------------------------------------------------------
# ASR twin: tone-rendered audio, degraded later name occurrences
# ---------------------------------------------------------------------------

CHAR_SECONDS = 0.05
# the ASR twin uses a REDUCED alphabet and DTMF-style two-tone chords.
# Constraint chain: the tiny conv front-end's first layer has stride 5,
# so its output is sampled at 3,200 Hz — any tone above the post-stride
# Nyquist of 1,600 Hz ALIASES back into the band (a 6.8 kHz tone lands
# on 400 Hz, exactly a low char's tone; a log-spaced single-tone
# alphabet measured undecodable for precisely this reason).  Ten chars
# therefore need ten separable codes INSIDE 350-1,500 Hz, where the
# ~20-sample receptive field resolves only ~4-5 bands — so each char is
# a PAIR of the 5 well-separated base tones (C(5,2) = 10 chords).
ASR_FILLER_CHARS = "abcde"
ASR_NAME_CHARS = "klmno"
_ASR_CHARS = ASR_FILLER_CHARS + ASR_NAME_CHARS
_BASE_TONES = (380.0, 650.0, 920.0, 1190.0, 1460.0)
_CHAR_PAIRS = [(i, j) for i in range(5) for j in range(i + 1, 5)]


def _char_freqs(ch: str) -> Tuple[float, float]:
    """The character's two base tones (chord coding, see above)."""
    i, j = _CHAR_PAIRS[_ASR_CHARS.index(ch)]
    return _BASE_TONES[i], _BASE_TONES[j]


def render_utterance(text: str, rng: np.random.Generator, *,
                     degrade_name: str = "", amp: float = 0.3,
                     degrade_tone: float = 0.03, degrade_noise: float = 0.45,
                     ) -> np.ndarray:
    """Tone-code a transcript (space = silence).  If ``degrade_name`` is a
    substring of ``text``, its characters' tones are scaled to
    ``degrade_tone`` and buried in white noise — acoustically the name is
    gone, only the transcript (and the conversation history) knows it."""
    n = int(CHAR_SECONDS * SR)
    t = np.arange(n) / SR
    deg_lo = deg_hi = -1
    if degrade_name:
        idx = text.find(degrade_name)
        if idx >= 0:
            deg_lo, deg_hi = idx, idx + len(degrade_name)
    parts = []
    for i, ch in enumerate(text):
        if ch == " ":
            parts.append(np.zeros(n, np.float32))
            continue
        f1, f2 = _char_freqs(ch)
        tone = (0.5 * (np.sin(2 * np.pi * f1 * t)
                       + np.sin(2 * np.pi * f2 * t))).astype(np.float32)
        if deg_lo <= i < deg_hi:
            seg = (degrade_tone * tone
                   + degrade_noise * rng.standard_normal(n).astype(np.float32))
        else:
            seg = amp * tone
        parts.append(seg)
    return np.concatenate(parts) if parts else np.zeros(0, np.float32)


def make_asr_lm_text(out_path: str, *, n_convs: int = 2000,
                     n_utts: int = 10, filler_words: int = 3,
                     name_len: int = 5, seed: int = 0,
                     exclude: Sequence[str] = ()) -> str:
    """Text-only conversation corpus over the ASR alphabet, for training
    the fusion LM BIGGER than the paired-audio set (text is free; real
    fusion LMs always see more text than transcribed audio).  Uses the
    same filler vocabulary derivation as :func:`make_asr_corpus` with
    the same ``seed`` (rng draw order matches), so the text distribution
    is the ASR corpus's; ``exclude`` must carry the ASR dev names so the
    context gain stays a copy, never a memory."""
    rng = np.random.default_rng(seed + 100)
    filler = make_filler_vocab(rng, n=12, chars=ASR_FILLER_CHARS)
    names = sample_names(np.random.default_rng(seed + 7), n_convs,
                         name_len, exclude=exclude, chars=ASR_NAME_CHARS)
    lines = []
    for c, name in enumerate(names):
        conv = sample_conversation(rng, f"lmconv{c:05d}", name, filler,
                                   n_utts=n_utts,
                                   filler_words=filler_words)
        for uid, text in zip(conv.utt_ids, conv.utterances):
            lines.append(f"{uid} {text}")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return out_path


def make_asr_corpus(out_dir: str, *, n_train: int = 60, n_dev: int = 16,
                    n_utts: int = 8, filler_words: int = 3,
                    name_len: int = 5, seed: int = 0,
                    degrade: bool = True,
                    degrade_prob: float = 0.5) -> Tuple[str, str]:
    """Write Kaldi ASR dirs ``train/`` and ``dev/`` (text, wav.scp,
    segments, one wav per conversation, plus ``degraded.txt`` listing
    the utt ids whose name audio was degraded) and return their paths.

    Per conversation: utterance 0 carries the name with CLEAN audio;
    each later occurrence is DEGRADED with probability ``degrade_prob``
    (render_utterance).  The transcripts are always correct — like a
    human transcriber who heard the name introduced and transcribes the
    later mumbled mentions from context — so supervised training teaches
    the model that degraded segments spell SOME name, while the
    acoustics no longer say which.  Partial degradation matters: with
    EVERY repeat degraded, name-position acoustics are noise in ~7/8 of
    the training signal and the model measurably stops reading clean
    name audio too (the all-clean control reaches dev WER ~0.1; the
    all-degraded corpus never decodes even clean names).  Dev names are
    disjoint from train names."""
    rng = np.random.default_rng(seed + 100)
    filler = make_filler_vocab(rng, n=12, chars=ASR_FILLER_CHARS)
    train_names = sample_names(rng, n_train, name_len,
                               chars=ASR_NAME_CHARS)
    dev_names = sample_names(rng, n_dev, name_len, exclude=train_names,
                             chars=ASR_NAME_CHARS)
    out = []
    for split, names in (("train", train_names), ("dev", dev_names)):
        root = os.path.join(out_dir, split)
        wav_dir = os.path.join(root, "wav")
        os.makedirs(wav_dir, exist_ok=True)
        text_lines, scp_lines, seg_lines = [], [], []
        degraded_ids: List[str] = []
        for c, name in enumerate(names):
            conv_id = f"{split}conv{c:04d}"
            conv = sample_conversation(rng, conv_id, name, filler,
                                       n_utts=n_utts,
                                       filler_words=filler_words)
            reco = f"{conv_id}-A"
            gap = np.zeros(int(0.1 * SR), np.float32)
            chunks, cursor = [], 0.0
            for u, (uid, text) in enumerate(zip(conv.utt_ids,
                                                conv.utterances)):
                deg = (degrade and u > 0
                       and float(rng.random()) < degrade_prob)
                if deg:
                    degraded_ids.append(uid)
                wav = render_utterance(
                    text, rng, degrade_name=(name if deg else ""))
                start = cursor
                end = cursor + len(wav) / SR
                seg_lines.append(f"{uid} {reco} {start:.3f} {end:.3f}")
                text_lines.append(f"{uid} {text}")
                chunks.extend([wav, gap])
                cursor = end + len(gap) / SR
            full = np.concatenate(chunks)
            path = os.path.join(wav_dir, f"{reco}.wav")
            # fixed scale (not per-file max-normalized) so tone amplitudes
            # are consistent across conversations; noise peaks clip rarely
            pcm = np.clip(full * 8192.0, -32768, 32767).astype(np.int16)
            with wave_mod.open(path, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(SR)
                w.writeframes(pcm.tobytes())
            scp_lines.append(f"{reco} {path}")
        for fname, lines in (("text", text_lines), ("wav.scp", scp_lines),
                             ("segments", seg_lines),
                             ("degraded.txt", degraded_ids)):
            with open(os.path.join(root, fname), "w") as f:
                f.write("\n".join(lines) + "\n")
        out.append(root)
    return out[0], out[1]


def name_positions(text: str, name: str) -> List[int]:
    """Character indices of ``name`` inside ``text`` (for per-position
    scoring in the experiment analysis)."""
    idx = text.find(name)
    return list(range(idx, idx + len(name))) if idx >= 0 else []
