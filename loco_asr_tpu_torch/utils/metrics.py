"""Structured metrics: the reference's timestamped file logger, an
append-only JSONL stream and a wall-clock stopwatch with an RTFx helper
(audio-seconds per wall-second)."""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Dict, List, Optional


def create_logger(log_file_base: str, verbose: bool = False) -> logging.Logger:
    """Logger writing to ``{log_file_base}_{YYYY-mm-dd-HH-MM-SS}`` (and
    stdout when ``verbose``), as ``loco_asr_tpu.utils.metrics.create_logger``
    and the reference's lms/src/utils.py do."""
    now_str = datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
    handlers: List[logging.Handler] = [logging.FileHandler(f"{log_file_base}_{now_str}")]
    if verbose:
        handlers.append(logging.StreamHandler(sys.stdout))
    logger = logging.getLogger(f"loco_asr_tpu_torch.{os.path.basename(log_file_base)}")
    logger.setLevel(logging.INFO)
    for h in logger.handlers:
        h.close()
    logger.handlers = []
    fmt = logging.Formatter("%(asctime)s %(message)s", datefmt="%d-%m-%Y %H:%M:%S")
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


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
