"""Long-form episode corpus adapter, the port's own copy of
``loco_asr_tpu.data.podcasts`` (numpy only).

The reference reserves a corpus slot for Spotify podcasts but ships only an
empty placeholder; the intended workload is hour-long episodes decoded with
conversation-level context (BASELINE config 5).  An episode manifest is a
JSON-lines file, one episode a line:

  {"episode_id": str, "audio": path, "duration": seconds,
   "segments": [{"start": s, "end": s, "text": str}, ...]}   # optional

A relative ``audio`` path resolves against the manifest's folder.
:func:`stream_windows` and :func:`segment_by_energy` give the windows and
the endpointed segments of a waveform; both compute what the JAX module
computes, float for float.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np


@dataclass
class EpisodeSegment:
    start: float
    end: float
    text: str = ""


@dataclass
class Episode:
    episode_id: str
    audio_path: str
    duration: Optional[float] = None
    segments: List[EpisodeSegment] = field(default_factory=list)


def load_manifest(path: str) -> List[Episode]:
    episodes = []
    base = os.path.dirname(os.path.abspath(path))
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            audio = d["audio"]
            if not os.path.isabs(audio):
                audio = os.path.join(base, audio)
            episodes.append(Episode(
                episode_id=d["episode_id"], audio_path=audio,
                duration=d.get("duration"),
                segments=[EpisodeSegment(**s) for s in d.get("segments", [])]))
    return episodes


def write_manifest(path: str, episodes: List[Episode]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for e in episodes:
            f.write(json.dumps({
                "episode_id": e.episode_id, "audio": e.audio_path,
                "duration": e.duration,
                "segments": [vars(s) for s in e.segments]}) + "\n")


def stream_windows(wav: np.ndarray, sr: int, *, window_seconds: float = 30.0,
                   hop_seconds: Optional[float] = None
                   ) -> Iterator[Tuple[float, np.ndarray]]:
    """Fixed windows over a long waveform -> (start_seconds, window)."""
    hop = hop_seconds if hop_seconds is not None else window_seconds
    w = int(window_seconds * sr)
    h = int(hop * sr)
    for start in range(0, max(len(wav) - 1, 1), h):
        chunk = wav[start:start + w]
        if len(chunk) == 0:
            break
        yield start / sr, chunk
        if start + w >= len(wav):
            break


def segment_by_energy(wav: np.ndarray, sr: int, *,
                      frame_ms: float = 25.0, hop_ms: float = 10.0,
                      threshold_db: float = -40.0,
                      min_speech_s: float = 0.3, min_gap_s: float = 0.3,
                      max_segment_s: float = 20.0
                      ) -> List[Tuple[float, float]]:
    """Energy-based utterance segmentation -> [(start_s, end_s), ...].

    A simple endpointer for episodes without transcripts: frames below
    ``threshold_db`` relative to the episode's peak RMS are silence; speech
    runs are merged across gaps shorter than ``min_gap_s`` and split at
    ``max_segment_s``.
    """
    frame = max(int(frame_ms * sr / 1000), 1)
    hop = max(int(hop_ms * sr / 1000), 1)
    if len(wav) < frame:
        return [(0.0, len(wav) / sr)] if len(wav) else []
    n = 1 + (len(wav) - frame) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(frame)[None, :]
    rms = np.sqrt(np.mean(wav[idx] ** 2, axis=1) + 1e-12)
    peak = rms.max() + 1e-12
    db = 20.0 * np.log10(rms / peak + 1e-12)
    speech = db > threshold_db

    segments: List[Tuple[float, float]] = []
    start = None
    gap = 0
    min_gap_frames = int(min_gap_s * 1000 / hop_ms)
    for i, s in enumerate(speech):
        t = i * hop / sr
        if s:
            if start is None:
                start = t
            gap = 0
        elif start is not None:
            gap += 1
            if gap >= min_gap_frames:
                end = t - (gap - 1) * hop / sr
                if end - start >= min_speech_s:
                    segments.append((start, end))
                start, gap = None, 0
    if start is not None:
        end = len(wav) / sr
        if end - start >= min_speech_s:
            segments.append((start, end))

    out: List[Tuple[float, float]] = []
    for s, e in segments:   # split long runs
        while e - s > max_segment_s:
            out.append((s, s + max_segment_s))
            s += max_segment_s
        out.append((s, e))
    return out
