"""Embedding cache: packed shard files instead of one pickle per utterance.

The reference writes one pickle per utterance (extract_*.py:91-93) and
re-opens one file per training example (slurp_embeddings_and_targets.py:21),
making classifier training IO-bound (SURVEY §3.2).  This store packs
embeddings into .npz shards with an index, loads each shard with one read,
and serves padded batches ready for device transfer.

Record: {id, embedding [T, D] float32/bf16, target [C] one-hot}.
A ``--format pickle`` compatibility writer is provided for byte-level
diffing against the reference layout.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np


class EmbeddingShardWriter:
    """Append records; flush ~shard_mb-sized .npz shards + index.json."""

    def __init__(self, directory: str, shard_mb: int = 256):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.shard_bytes = shard_mb * (1 << 20)
        self._ids: List = []
        self._embs: List[np.ndarray] = []
        self._tgts: List[np.ndarray] = []
        self._cur_bytes = 0
        self._shards: List[Dict] = []

    def add(self, utt_id, embedding: np.ndarray, target: np.ndarray) -> None:
        embedding = np.ascontiguousarray(embedding)
        self._ids.append(utt_id)
        self._embs.append(embedding)
        self._tgts.append(np.asarray(target))
        self._cur_bytes += embedding.nbytes
        if self._cur_bytes >= self.shard_bytes:
            self._flush()

    def _flush(self) -> None:
        if not self._ids:
            return
        n = len(self._shards)
        path = os.path.join(self.directory, f"shard_{n:05d}.npz")
        lengths = np.asarray([e.shape[0] for e in self._embs], np.int32)
        packed = np.concatenate(self._embs, axis=0)
        np.savez(path,
                 ids=np.asarray(self._ids),
                 lengths=lengths,
                 embeddings=packed,
                 targets=np.stack(self._tgts))
        self._shards.append({"file": os.path.basename(path),
                             "num": len(self._ids)})
        self._ids, self._embs, self._tgts, self._cur_bytes = [], [], [], 0

    def close(self) -> None:
        self._flush()
        with open(os.path.join(self.directory, "index.json"), "w") as f:
            json.dump({"shards": self._shards,
                       "total": sum(s["num"] for s in self._shards)}, f)


class EmbeddingStore:
    """Reader over a shard directory (or a list of them, e.g. train +
    train_synthetic concatenated as in train_classifier.py:33-35)."""

    def __init__(self, directories: Sequence[str]):
        if isinstance(directories, str):
            directories = [directories]
        self.records: List[Tuple[str, int]] = []  # (shard path, row)
        self._shard_cache: Dict[str, Dict] = {}
        total = 0
        for d in directories:
            with open(os.path.join(d, "index.json")) as f:
                index = json.load(f)
            for s in index["shards"]:
                path = os.path.join(d, s["file"])
                for row in range(s["num"]):
                    self.records.append((path, row))
            total += index["total"]
        assert total == len(self.records)

    def __len__(self) -> int:
        return len(self.records)

    def _shard(self, path: str) -> Dict:
        if path not in self._shard_cache:
            # keep at most 2 shards resident
            if len(self._shard_cache) >= 2:
                self._shard_cache.pop(next(iter(self._shard_cache)))
            with np.load(path, allow_pickle=False) as z:
                lengths = z["lengths"]
                offsets = np.zeros(len(lengths) + 1, np.int64)
                np.cumsum(lengths, out=offsets[1:])
                self._shard_cache[path] = {
                    "ids": z["ids"], "lengths": lengths, "offsets": offsets,
                    "embeddings": z["embeddings"], "targets": z["targets"],
                }
        return self._shard_cache[path]

    def __getitem__(self, i: int):
        path, row = self.records[i]
        s = self._shard(path)
        a, b = s["offsets"][row], s["offsets"][row + 1]
        return s["ids"][row], s["embeddings"][a:b], s["targets"][row]

    def padded_batches(self, batch_size: int, *, shuffle: bool = False,
                       seed: int = 0, multiple: int = 8
                       ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yield (embeddings [B, L, D], lengths [B], targets [B, C])."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for i in range(0, len(order), batch_size):
            idx = order[i:i + batch_size]
            items = [self[j] for j in idx]
            lens = np.asarray([e.shape[1 - 1] for _, e, _ in items], np.int32)
            L = int(-(-lens.max() // multiple) * multiple)
            d = items[0][1].shape[-1]
            emb = np.zeros((len(items), L, d), items[0][1].dtype)
            for j, (_, e, _) in enumerate(items):
                emb[j, :e.shape[0]] = e
            tgts = np.stack([t for _, _, t in items])
            yield emb, lens, tgts


def write_reference_pickles(directory: str, records) -> None:
    """Reference-layout writer: one '{id}_embedding_and_target.pickle' per
    utterance with {id, embedding, target} (extract_*.py:91-93)."""
    os.makedirs(directory, exist_ok=True)
    for utt_id, embedding, target in records:
        path = os.path.join(directory, f"{utt_id}_embedding_and_target.pickle")
        with open(path, "wb") as f:
            pickle.dump({"id": utt_id, "embedding": np.asarray(embedding),
                         "target": np.asarray(target)}, f,
                        protocol=pickle.HIGHEST_PROTOCOL)


def read_reference_pickles(directory: str):
    """Reader for the reference per-utterance layout
    (slurp_embeddings_and_targets.py:19-28)."""
    for name in os.listdir(directory):
        if not name.endswith(".pickle"):
            continue
        with open(os.path.join(directory, name), "rb") as f:
            d = pickle.load(f)
        yield d["id"], d["embedding"], d["target"]
