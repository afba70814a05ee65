"""Kaldi-format data-directory IO, the port's own copy of
``loco_asr_tpu.data.kaldi``: read/write ``key rest-of-line`` files
(text, wav.scp, utt2spk, ...) and ``segments`` byte-compatibly.
"""

from __future__ import annotations

import os
from collections import OrderedDict, defaultdict
from typing import Dict, Iterable, List, Tuple


def read_key_value_file(path: str) -> "OrderedDict[str, str]":
    """Read 'key rest-of-line' files (text, wav.scp, utt2spk, ...)."""
    out: "OrderedDict[str, str]" = OrderedDict()
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            key, value = line.split(None, 1) if " " in line or "\t" in line else (line, "")
            out[key] = value
    return out


def write_key_value_file(path: str, items: Iterable[Tuple[str, str]]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for key, value in items:
            f.write(f"{key} {value}\n" if value != "" else f"{key}\n")


def utt2spk_to_spk2utt(utt2spk: Dict[str, str]) -> "OrderedDict[str, List[str]]":
    """Invert utt2spk (utils/utt2spk_to_spk2utt.pl behavior: speakers in
    first-appearance order, utterances in input order)."""
    spk2utt: "OrderedDict[str, List[str]]" = OrderedDict()
    for utt, spk in utt2spk.items():
        spk2utt.setdefault(spk, []).append(utt)
    return spk2utt


def write_spk2utt(path: str, spk2utt: Dict[str, List[str]]) -> None:
    write_key_value_file(path, ((s, " ".join(us)) for s, us in spk2utt.items()))


def read_segments(path: str) -> "OrderedDict[str, Tuple[str, float, float]]":
    """segments: utt_id reco_id start end."""
    out: "OrderedDict[str, Tuple[str, float, float]]" = OrderedDict()
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) == 4:
                out[parts[0]] = (parts[1], float(parts[2]), float(parts[3]))
    return out


def recording_id(utt_id: str) -> str:
    """rec_id = utt_id up to the first '-' (the contract shared by the
    split filter, LM datasets, and PPL aggregation:
    split_fisher_data_based_on_ids.py:53, lms/src/utils.py:216)."""
    return utt_id.split("-", 1)[0]


def group_by_recording(utt_ids: Iterable[str]) -> Dict[str, List[str]]:
    groups: Dict[str, List[str]] = defaultdict(list)
    for u in utt_ids:
        groups[recording_id(u)].append(u)
    return dict(groups)
