"""Split a Kaldi data dir by recording-id lists, the port's own copy of
``loco_asr_tpu.data.fisher_split`` (same outputs).

A port of the reference's split_fisher_data_based_on_ids.py:
  * every plain file in ``data_dir`` is filtered line by line, keeping
    lines whose first token's recording id (``tok.split('-')[0]``) is in
    the split's ``.recids`` list;
  * ``frame_shift`` is copied verbatim;
  * output mirrors the input layout under ``out_dir/{split}/``.
"""

from __future__ import annotations

import glob
import os
import shutil
from typing import Dict, Iterable, List


def load_list(fname: str) -> List[str]:
    with open(fname, "r", encoding="utf-8") as f:
        return [line.strip() for line in f if line.strip()]


def get_subset(fname: str, subset_ids: Iterable[str]) -> List[str]:
    ids = set(subset_ids)
    out = []
    with open(fname, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            first = line.split(" ", 1)[0]
            if first.split("-")[0] in ids:
                out.append(line)
    return out


def split_data_dir(split_dir: str, data_dir: str, out_dir: str,
                   sets: Iterable[str] = ("train", "dev", "test")) -> Dict[str, str]:
    """Filter ``data_dir`` into per-split dirs; returns {split: out_path}."""
    os.makedirs(out_dir, exist_ok=True)
    splits = {}
    for name in sets:
        splits[name] = load_list(os.path.join(split_dir, f"{name}.recids"))
        os.makedirs(os.path.join(out_dir, name), exist_ok=True)

    for fname in glob.glob(os.path.join(data_dir, "*")):
        if not os.path.isfile(fname):
            continue
        base = os.path.basename(fname)
        for name, recids in splits.items():
            out_fname = os.path.join(out_dir, name, base)
            if base == "frame_shift":
                shutil.copy(fname, out_fname)
            else:
                lines = get_subset(fname, recids)
                with open(out_fname, "w", encoding="utf-8") as f:
                    f.write("\n".join(lines) + "\n")
    return {name: os.path.join(out_dir, name) for name in splits}
