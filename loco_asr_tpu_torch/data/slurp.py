"""SLURP dataset adapter.

Behavior contract (reference speech_text/slurp_data.py):
  * metadata from ``{data_path}/dataset/slurp/{split}.jsonl``
  * audio under ``{data_path}/audio/slurp_real`` (``slurp_synth`` for the
    ``train_synthetic`` split) (slurp_data.py:28-29)
  * per utterance, prefer the recording whose metadata entry has a
    "headset" key; else the first recording (slurp_data.py:39)
  * item = (slurp_id, sentence, audio_path, 16000, task_label)
    where ``task`` picks the label field (slurp_data.py:58-66)

Label encoding replaces sklearn LabelEncoder+LabelBinarizer with a direct
index into the sorted-unique INTENT_CLASSES inventory (identical mapping).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from .intent_classes import INTENT_CLASSES

INTENT_TO_INDEX = {c: i for i, c in enumerate(INTENT_CLASSES)}


@dataclass
class SlurpExample:
    slurp_id: int
    sentence: str
    audio_path: str
    sampling_rate: int
    label: object  # str for intent/action/scenario; list for entities/tokens


class SlurpDataset:
    """Indexes one SLURP split; mirrors the reference adapter's selection
    logic exactly (headset preference, synth-audio switch)."""

    def __init__(self, data_path: str, mode: str = "train", task: str = "intent"):
        self.data_path = data_path
        self.mode = mode
        self.task = task
        self.examples: List[SlurpExample] = []
        self.intents: List[str] = []
        self._prepare()

    def _prepare(self) -> None:
        jsonl = os.path.join(self.data_path, "dataset/slurp", f"{self.mode}.jsonl")
        audio_mode = "slurp_synth" if self.mode == "train_synthetic" else "slurp_real"
        audio_dir = os.path.join(self.data_path, "audio", audio_mode)
        intents = []
        with open(jsonl, "r", encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                item = json.loads(line)
                recording = next(
                    (r["file"] for r in item["recordings"] if "headset" in r),
                    item["recordings"][0]["file"],
                )
                self.examples.append(SlurpExample(
                    slurp_id=item["slurp_id"],
                    sentence=item["sentence"],
                    audio_path=os.path.join(audio_dir, recording),
                    sampling_rate=16000,
                    label=item[self.task],
                ))
                intents.append(item["intent"])
        if self.task == "intent":
            self.intents = sorted(set(intents))

    def __len__(self) -> int:
        return len(self.examples)

    def __getitem__(self, idx: int) -> Tuple:
        e = self.examples[idx]
        return e.slurp_id, e.sentence, e.audio_path, e.sampling_rate, e.label


def encode_intent(label: str) -> int:
    return INTENT_TO_INDEX[label]


def onehot_intent(label: str, dtype=np.float32) -> np.ndarray:
    v = np.zeros((len(INTENT_CLASSES),), dtype)
    v[INTENT_TO_INDEX[label]] = 1.0
    return v


def batched(examples: Sequence[SlurpExample], batch_size: int,
            shuffle: bool = False, seed: int = 0) -> Iterator[List[SlurpExample]]:
    if isinstance(examples, SlurpDataset):
        examples = examples.examples
    order = np.arange(len(examples))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for i in range(0, len(order), batch_size):
        yield [examples[j] for j in order[i:i + batch_size]]
