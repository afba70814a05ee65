"""ASR training dataset over Kaldi-format data dirs: the port's own copy
of ``loco_asr_tpu.data.asr_dataset`` (same examples, windows and batches
for the same seed; numpy only).

Consumes the manifests the Fisher prep emits (text + wav.scp + segments,
data/fisher_prep.py / reference fisher_data_prep.sh): resolves each
utterance to (waveform, transcript), handling
  * direct audio paths in wav.scp,
  * command pipes ('... |', e.g. sph_decode or sph2pipe lines),
  * segments-based cropping (start/end seconds into the recording).

Batching is length-bucketed (audio seconds) so padded device batches
come in a handful of shapes.

:class:`ConversationAsrDataset` builds CONVERSATION WINDOWS instead of
per-utterance examples: per recording(+channel), utterances are ordered
chronologically (the utt-id timestamp scheme, reference
fisher_data_prep.sh:130-137) and consecutive utterances are concatenated
— cropped audio segments back to back, transcripts joined with a
separator token — into windows of up to ``window_seconds``, always split
at utterance boundaries.  This is the ASR-training twin of the LM
conversation stream (reference lms/src/utils.py:108-139: chronological
per-recording token stream with EOS separators), and what
``train_asr --conversation_seconds`` fine-tunes long-context models on.
"""

from __future__ import annotations

import io
import os
import subprocess
import wave as wave_mod
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..ops import audio_io as audio_ops
from . import kaldi


@dataclass
class AsrExample:
    utt_id: str
    text: str
    reco_id: str
    start: float   # seconds; -1 = whole recording
    end: float


class KaldiAsrDataset:
    def __init__(self, data_dir: str, target_sr: int = 16000):
        self.data_dir = data_dir
        self.target_sr = target_sr
        self.text = kaldi.read_key_value_file(os.path.join(data_dir, "text"))
        self.wav_scp = kaldi.read_key_value_file(os.path.join(data_dir, "wav.scp"))
        seg_path = os.path.join(data_dir, "segments")
        self.segments = kaldi.read_segments(seg_path) if os.path.exists(seg_path) else {}
        self.examples: List[AsrExample] = []
        for utt_id, text in self.text.items():
            if utt_id in self.segments:
                reco, start, end = self.segments[utt_id]
            else:
                reco, start, end = utt_id, -1.0, -1.0
            if reco in self.wav_scp:
                self.examples.append(AsrExample(utt_id, text, reco, start, end))
        self._reco_cache: Dict[str, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.examples)

    def _load_recording(self, reco_id: str) -> np.ndarray:
        if reco_id in self._reco_cache:
            return self._reco_cache[reco_id]
        rxspec = self.wav_scp[reco_id].strip()
        if rxspec.endswith("|"):
            # a pipe line runs as written; the ones data/fisher_prep.py
            # writes call this package's sph_decode (no torch, no JAX), so
            # the package is made importable from any cwd
            env = dict(os.environ)
            pkg_root = os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))))
            env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
            raw = subprocess.run(rxspec[:-1], shell=True, check=True,
                                 capture_output=True, env=env).stdout
            with wave_mod.open(io.BytesIO(raw)) as w:
                rate = w.getframerate()
                pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
                if w.getnchannels() > 1:
                    pcm = pcm.reshape(-1, w.getnchannels()).mean(1).astype(np.int16)
            wav = pcm.astype(np.float32) / 32768.0
            if rate != self.target_sr:
                wav = audio_ops.resample(wav, rate, self.target_sr)
        else:
            wav, _ = audio_ops.load_audio(rxspec, self.target_sr)
        if len(self._reco_cache) > 4:
            self._reco_cache.pop(next(iter(self._reco_cache)))
        self._reco_cache[reco_id] = wav
        return wav

    def load_waveform(self, ex: AsrExample) -> np.ndarray:
        wav = self._load_recording(ex.reco_id)
        if ex.start >= 0:
            a = int(ex.start * self.target_sr)
            b = int(ex.end * self.target_sr)
            wav = wav[a:b]
        return wav

    def batches(
        self, tokenizer, batch_size: int, *,
        max_seconds: float = 20.0, max_label_len: int = 128,
        shuffle: bool = False, seed: int = 0,
        audio_multiple: int = 16000, label_multiple: int = 16,
        bos_id: Optional[int] = None, eos_id: Optional[int] = None,
        label_pad_id: int = -100,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield padded batches {input_values, attention_mask, labels,
        utt_ids, texts}, length-sorted into buckets."""
        order = sorted(
            range(len(self.examples)),
            key=lambda i: (self.examples[i].end - self.examples[i].start
                           if self.examples[i].start >= 0 else 1e9))
        if shuffle:
            rng = np.random.default_rng(seed)
            blocks = [order[i:i + batch_size * 8]
                      for i in range(0, len(order), batch_size * 8)]
            rng.shuffle(blocks)
            order = [i for b in blocks for i in b]

        # reserve label slots for bos/eos BEFORE truncating so rows never
        # exceed max_label_len (they previously could reach max_label_len+1
        # with both set)
        budget = max_label_len - (bos_id is not None) - (eos_id is not None)
        for i in range(0, len(order), batch_size):
            idx = order[i:i + batch_size]
            exs = [self.examples[j] for j in idx]
            wavs, labels, texts = [], [], []
            trunc_samples = trunc_tokens = 0
            for ex in exs:
                w = self.load_waveform(ex)
                cap = int(max_seconds * self.target_sr)
                trunc_samples += max(len(w) - cap, 0)
                w = w[:cap]
                wavs.append(w)
                ids = list(tokenizer(ex.text)["input_ids"])
                trunc_tokens += max(len(ids) - budget, 0)
                ids = ids[:budget]
                if bos_id is not None:
                    ids.insert(0, bos_id)
                if eos_id is not None:
                    ids.append(eos_id)
                labels.append(ids)
                texts.append(ex.text)
            if not wavs:
                continue
            t = max(max(len(w) for w in wavs), 1)
            t = -(-t // audio_multiple) * audio_multiple
            L = -(-max(len(l) for l in labels) // label_multiple) * label_multiple
            x = np.zeros((len(wavs), t), np.float32)
            mask = np.zeros((len(wavs), t), np.int32)
            y = np.full((len(wavs), L), label_pad_id, np.int64)
            for j, (w, l) in enumerate(zip(wavs, labels)):
                x[j, :len(w)] = w
                mask[j, :len(w)] = 1
                y[j, :len(l)] = l
            yield {"input_values": x, "attention_mask": mask, "labels": y,
                   "utt_ids": [e.utt_id for e in exs], "texts": texts,
                   "truncation": {"samples": trunc_samples,
                                  "label_tokens": trunc_tokens,
                                  "utterances": 0}}


@dataclass
class ConversationWindow:
    """One training example of ConversationAsrDataset: consecutive
    utterances of a recording(+channel), audio-concatenated."""
    window_id: str
    reco_id: str
    utt_ids: List[str] = field(default_factory=list)
    texts: List[str] = field(default_factory=list)
    segs: List[Tuple[float, float]] = field(default_factory=list)
    seconds: float = 0.0

    @property
    def text(self) -> str:
        return " ".join(self.texts)


def _utt_time_key(utt_id: str, start: float, end: float):
    """Chronological sort key.  The Fisher utt-id scheme is
    callid-side-START-END in zero-padded centiseconds (reference
    fisher_data_prep.sh:130-137) — parse the trailing two fields as ints
    (equivalent to the reference's lexicographic sort on the zero-padded
    strings, lms/src/utils.py:110-112); fall back to the segments times
    for non-Fisher utt-id schemes."""
    parts = utt_id.split("-")
    if len(parts) >= 4:
        try:
            return (int(parts[-2]), int(parts[-1]))
        except ValueError:
            pass
    return (start, end)


class ConversationAsrDataset(KaldiAsrDataset):
    """Conversation-window ASR training set over a Kaldi dir.

    Windows are built per segments-file recording id — for Fisher that is
    ``callid-side`` (one per channel, data/fisher_prep.py wav.scp/segments
    scheme), so the two speakers' channels never mix, mirroring the
    conversation-intact split design (reference
    split_fisher_data_based_on_ids.py:53).  Within a recording,
    utterances are ordered chronologically by the utt-id timestamp key
    and packed greedily into windows of at most ``window_seconds`` of
    audio, always split at utterance boundaries (an utterance longer than
    the window gets a window of its own).  Window audio is the
    concatenation of the segment-cropped utterance audio (inter-utterance
    silence and the other channel's speech are excluded, exactly like the
    LM stream's token concatenation drops them,
    reference lms/src/utils.py:125-130).

    Utterances without a segments entry (whole-recording utterances)
    become single-utterance windows.
    """

    def __init__(self, data_dir: str, window_seconds: float = 164.0,
                 target_sr: int = 16000):
        super().__init__(data_dir, target_sr)
        self.window_seconds = window_seconds
        self.windows: List[ConversationWindow] = self._build_windows()

    def _build_windows(self) -> List[ConversationWindow]:
        groups: Dict[str, List[AsrExample]] = {}
        for ex in self.examples:
            groups.setdefault(ex.reco_id, []).append(ex)
        windows: List[ConversationWindow] = []
        for reco in groups:   # keep recording first-appearance order
            exs = sorted(groups[reco],
                         key=lambda e: _utt_time_key(e.utt_id, e.start, e.end))
            cur: Optional[ConversationWindow] = None
            for ex in exs:
                if ex.start >= 0:
                    dur = max(ex.end - ex.start, 0.0)
                else:
                    # whole-recording utterance: unknown length; isolate
                    dur = float("inf")
                if cur is None or cur.seconds + dur > self.window_seconds:
                    cur = ConversationWindow(
                        window_id=f"{reco}-conv{len(windows):04d}",
                        reco_id=reco)
                    windows.append(cur)
                cur.utt_ids.append(ex.utt_id)
                cur.texts.append(ex.text)
                cur.segs.append((ex.start, ex.end))
                cur.seconds += dur
                if dur == float("inf"):
                    cur = None     # close the singleton window
        return windows

    def __len__(self) -> int:
        return len(self.windows)

    def load_window_parts(self, win: ConversationWindow) -> List[np.ndarray]:
        """Per-utterance audio crops of a window, in chronological order."""
        wav = self._load_recording(win.reco_id)
        parts = []
        for start, end in win.segs:
            if start >= 0:
                parts.append(wav[int(start * self.target_sr):
                                 int(end * self.target_sr)])
            else:
                parts.append(wav)
        return parts

    def load_window_waveform(self, win: ConversationWindow) -> np.ndarray:
        parts = self.load_window_parts(win)
        wav = self._load_recording(win.reco_id)
        return np.concatenate(parts) if parts else wav[:0]

    def batches(
        self, tokenizer, batch_size: int, *,
        max_seconds: Optional[float] = None, max_label_len: int = 2048,
        shuffle: bool = False, seed: int = 0,
        audio_multiple: int = 16000, label_multiple: int = 64,
        bos_id: Optional[int] = None, eos_id: Optional[int] = None,
        sep_id: Optional[int] = None, label_pad_id: int = -100,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Padded conversation-window batches, same contract as
        KaldiAsrDataset.batches ({input_values, attention_mask, labels,
        utt_ids, texts}; utt_ids are window ids, texts the joined window
        transcript).

        Labels follow the LM conversation-stream convention
        (lms/src/utils.py:129-130): each utterance's tokens are followed
        by a SEPARATOR token (``sep_id``, default ``eos_id``) — the final
        separator doubles as the window's EOS when they coincide."""
        if sep_id is None:
            sep_id = eos_id
        max_seconds = max_seconds or self.window_seconds
        order = sorted(range(len(self.windows)),
                       key=lambda i: self.windows[i].seconds)
        if shuffle:
            rng = np.random.default_rng(seed)
            blocks = [order[i:i + batch_size * 8]
                      for i in range(0, len(order), batch_size * 8)]
            rng.shuffle(blocks)
            order = [i for b in blocks for i in b]

        # reserve bos/eos slots before truncation (rows never exceed
        # max_label_len); audio/label caps crop at UTTERANCE boundaries so
        # labels never cover speech the audio crop removed — every loss is
        # counted and surfaced in the yielded "truncation" entry
        budget = max_label_len - (bos_id is not None) - (eos_id is not None)
        cap = int(max_seconds * self.target_sr)
        for i in range(0, len(order), batch_size):
            wins = [self.windows[j] for j in order[i:i + batch_size]]
            wavs, labels, texts = [], [], []
            trunc_samples = trunc_tokens = trunc_utts = 0
            for win in wins:
                parts = self.load_window_parts(win)
                kept_parts: List[np.ndarray] = []
                kept_texts: List[str] = []
                total = 0
                for k, (part, utt_text) in enumerate(zip(parts, win.texts)):
                    if not kept_parts and len(part) > cap:
                        # a single utterance longer than the whole cap
                        # (e.g. a segment-less whole-recording window):
                        # crop its audio mid-utterance — unavoidable; the
                        # samples counter makes the cut observable
                        trunc_samples += len(part) - cap
                        kept_parts.append(part[:cap])
                        kept_texts.append(utt_text)
                        total = cap
                    elif total + len(part) <= cap:
                        kept_parts.append(part)
                        kept_texts.append(utt_text)
                        total += len(part)
                    else:
                        # crop at the utterance boundary: later utterances
                        # lose audio AND text together (chronology stays
                        # contiguous)
                        trunc_utts += len(parts) - k
                        break
                w = (np.concatenate(kept_parts) if kept_parts
                     else np.zeros(0, np.float32))
                wavs.append(w)
                ids: List[int] = []
                for t in kept_texts:
                    ids.extend(tokenizer(t)["input_ids"])
                    if sep_id is not None:
                        ids.append(sep_id)
                trunc_tokens += max(len(ids) - budget, 0)
                ids = ids[:budget]
                if bos_id is not None:
                    ids.insert(0, bos_id)
                if eos_id is not None and (not ids or ids[-1] != eos_id):
                    ids.append(eos_id)
                labels.append(ids)
                texts.append(" ".join(kept_texts))
            if not wavs:
                continue
            t = max(max(len(w) for w in wavs), 1)
            t = -(-t // audio_multiple) * audio_multiple
            L = -(-max(len(l) for l in labels) // label_multiple) * label_multiple
            x = np.zeros((len(wavs), t), np.float32)
            mask = np.zeros((len(wavs), t), np.int32)
            y = np.full((len(wavs), L), label_pad_id, np.int64)
            for j, (w, l) in enumerate(zip(wavs, labels)):
                x[j, :len(w)] = w
                mask[j, :len(w)] = 1
                y[j, :len(l)] = l
            yield {"input_values": x, "attention_mask": mask, "labels": y,
                   "utt_ids": [w.window_id for w in wins], "texts": texts,
                   "truncation": {"samples": trunc_samples,
                                  "label_tokens": trunc_tokens,
                                  "utterances": trunc_utts}}
