"""Word/character error rate (Levenshtein), the port's own copy of
``loco_asr_tpu.utils.wer``."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def edit_distance(ref: Sequence, hyp: Sequence) -> Tuple[int, Dict[str, int]]:
    """Levenshtein distance + operation counts {sub, ins, del}."""
    n, m = len(ref), len(hyp)
    # dp over (distance, subs, ins, dels)
    dist = np.zeros((n + 1, m + 1), np.int32)
    dist[:, 0] = np.arange(n + 1)
    dist[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            sub = dist[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1])
            dist[i, j] = min(sub, dist[i - 1, j] + 1, dist[i, j - 1] + 1)
    # backtrack for op counts
    i, j = n, m
    ops = {"sub": 0, "ins": 0, "del": 0}
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dist[i, j] == dist[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]):
            if ref[i - 1] != hyp[j - 1]:
                ops["sub"] += 1
            i, j = i - 1, j - 1
        elif i > 0 and dist[i, j] == dist[i - 1, j] + 1:
            ops["del"] += 1
            i -= 1
        else:
            ops["ins"] += 1
            j -= 1
    return int(dist[n, m]), ops


def wer(refs: List[str], hyps: List[str]) -> float:
    """Corpus WER: total edits / total reference words."""
    edits, words = 0, 0
    for r, h in zip(refs, hyps):
        d, _ = edit_distance(r.split(), h.split())
        edits += d
        words += len(r.split())
    return edits / max(words, 1)


def cer(refs: List[str], hyps: List[str]) -> float:
    edits, chars = 0, 0
    for r, h in zip(refs, hyps):
        d, _ = edit_distance(list(r), list(h))
        edits += d
        chars += len(r)
    return edits / max(chars, 1)


def wer_details(refs: List[str], hyps: List[str]) -> Dict[str, float]:
    edits, words = 0, 0
    totals = {"sub": 0, "ins": 0, "del": 0}
    for r, h in zip(refs, hyps):
        d, ops = edit_distance(r.split(), h.split())
        edits += d
        words += len(r.split())
        for k in totals:
            totals[k] += ops[k]
    w = max(words, 1)
    return {"wer": edits / w, "sub_rate": totals["sub"] / w,
            "ins_rate": totals["ins"] / w, "del_rate": totals["del"] / w,
            "ref_words": words}
