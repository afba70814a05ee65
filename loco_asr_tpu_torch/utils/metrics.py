"""Structured metrics: an append-only JSONL stream and a wall-clock
stopwatch with an RTFx helper (audio-seconds per wall-second)."""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class MetricsWriter:
    """Append-only JSONL metrics stream + in-memory history for plots."""

    path: Optional[str] = None
    history: List[Dict[str, Any]] = field(default_factory=list)

    def log(self, **kv: Any) -> Dict[str, Any]:
        rec = {"time": time.time(), **kv}
        self.history.append(rec)
        if self.path:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(json.dumps(rec, default=float) + "\n")
        return rec

    def series(self, key: str) -> List[Any]:
        return [r[key] for r in self.history if key in r]


class Stopwatch:
    """Wall-clock timer with RTFx helper (audio-seconds / wall-seconds)."""

    def __init__(self) -> None:
        self.t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def rtfx(self, audio_seconds: float) -> float:
        dt = self.elapsed()
        return audio_seconds / dt if dt > 0 else float("inf")
