"""Fisher corpus preparation: LDC transcripts -> Kaldi-format data dir,
the port's own copy of ``loco_asr_tpu.data.fisher_prep`` (numpy-free,
no torch).  The manifests are byte-identical to the JAX package's; only
``decode_cmd``'s default differs: the wav.scp pipes run this package's
``sph_decode`` (``python -m loco_asr_tpu_torch.pipelines.sph_decode``),
which loads no torch and no JAX.

A port of the reference's bash/perl recipe (fisher_data_prep.sh):

  * transcript parsing (.txt: '# <call>.sph' header check, then
    'start end side: words' lines; utt id = callid-side-start-end with
    start/end in zero-padded centiseconds)
  * text normalization: sorted, lines containing '((' are dropped,
    single-field lines dropped, [laugh]->[laughter],
    [sigh|cough|mn|breath|lipsmack]->[noise]
  * derived manifests: utt2spk (spk = callid-side), segments (times back
    to seconds with 2 decimals), spk2utt, reco2file_and_channel (sorted),
    wav.scp (one decode pipe per channel), spk2gender from filetable rows
    'name.sph XY'.
"""

from __future__ import annotations

import os
import re
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Tuple

from . import kaldi

_NOISE_TAGS = ("sigh", "cough", "mn", "breath", "lipsmack")
_TRANS_LINE = re.compile(r"([0-9.]+)\s+([0-9.]+) ([AB]):\s*(\S.+\S|\S)\s*$")


def parse_transcript(path: str) -> Tuple[str, List[Tuple[str, str]]]:
    """One LDC transcript file -> (call_id, [(utt_id, words), ...]).

    Raises on a header/call-id mismatch exactly like the perl parser
    (fisher_data_prep.sh:127-128) — the integrity check is part of the
    contract.
    """
    call_id = os.path.basename(path).rsplit(".", 1)[0]
    entries: List[Tuple[str, str]] = []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        line1 = f.readline()
        m = re.search(r"# (.+)\.sph", line1)
        if not m:
            raise ValueError(f"Bad first line {line1!r} in file {path}")
        if m.group(1) != call_id:
            raise ValueError(f"Mismatch call-id {call_id} vs {m.group(1)}")
        for line in f:
            m = _TRANS_LINE.search(line)
            if not m:
                continue
            start = f"{int(round(float(m.group(1)) * 100.0)):06d}"
            end = f"{int(round(float(m.group(2)) * 100.0)):06d}"
            if len(end) > 6:
                raise ValueError(f"Time too long {end} in file {path}")
            side, words = m.group(3), m.group(4)
            entries.append((f"{call_id}-{side}-{start}-{end}", words))
    return call_id, entries


def normalize_text_lines(lines: Iterable[str]) -> List[str]:
    """The stage-2 sed pipeline (fisher_data_prep.sh:145-153): sort, drop
    '((' lines and no-word lines, retag noises."""
    out = []
    for line in sorted(lines):
        if "((" in line:
            continue
        if len(line.split()) <= 1:
            continue
        line = line.replace("[laugh]", "[laughter]")
        for tag in _NOISE_TAGS:
            line = line.replace(f"[{tag}]", "[noise]")
        out.append(line)
    return out


def prepare_fisher(
    transcript_files: List[str],
    out_dir: str,
    sphere_files: Optional[List[str]] = None,
    filetable_lines: Optional[Iterable[str]] = None,
    decode_cmd: str = "python -m loco_asr_tpu_torch.pipelines.sph_decode",
) -> Dict[str, str]:
    """Produce the Kaldi train_all dir; returns {manifest_name: path}."""
    os.makedirs(out_dir, exist_ok=True)

    raw_lines: List[str] = []
    reco2fc: List[Tuple[str, str]] = []
    for path in transcript_files:
        call_id, entries = parse_transcript(path)
        reco2fc.append((f"{call_id}-A", f"{call_id} A"))
        reco2fc.append((f"{call_id}-B", f"{call_id} B"))
        raw_lines.extend(f"{utt} {words}" for utt, words in entries)

    text_lines = normalize_text_lines(raw_lines)
    kaldi.write_key_value_file(
        os.path.join(out_dir, "text"),
        (tuple(line.split(" ", 1)) for line in text_lines))
    kaldi.write_key_value_file(
        os.path.join(out_dir, "reco2file_and_channel"), sorted(reco2fc))

    utt2spk = OrderedDict()
    segments = []
    for line in text_lines:
        utt_id = line.split(" ", 1)[0]
        m = re.match(r"([^-]+)-([AB])-(\d+)-(\d+)", utt_id)
        if not m:
            raise ValueError(f"Bad utt id {utt_id}")
        spk = f"{m.group(1)}-{m.group(2)}"
        utt2spk[utt_id] = spk
        segments.append((utt_id, f"{spk} {0.01 * int(m.group(3)):.2f} {0.01 * int(m.group(4)):.2f}"))
    kaldi.write_key_value_file(os.path.join(out_dir, "utt2spk"), utt2spk.items())
    kaldi.write_key_value_file(os.path.join(out_dir, "segments"), segments)
    kaldi.write_spk2utt(os.path.join(out_dir, "spk2utt"),
                        kaldi.utt2spk_to_spk2utt(utt2spk))

    if sphere_files:
        wav_scp = []
        for sph in sorted(set(os.path.abspath(s) for s in sphere_files)):
            rec = os.path.basename(sph).rsplit(".", 1)[0]
            wav_scp.append((f"{rec}-A", f"{decode_cmd} -c 1 {sph} |"))
            wav_scp.append((f"{rec}-B", f"{decode_cmd} -c 2 {sph} |"))
        kaldi.write_key_value_file(os.path.join(out_dir, "wav.scp"), sorted(wav_scp))

    if filetable_lines is not None:
        spk2gender = set()
        for line in filetable_lines:
            m = re.search(r"(\S+)\.sph ([fm])([fm])", line) or \
                re.search(r"fe_03_p[12]_sph\d\t(\d+)\t([mf])([mf])", line)
            if not m:
                continue
            name = m.group(1)
            if name.isdigit():
                name = f"fe_03_{name}"
            spk2gender.add((f"{name}-A", m.group(2)))
            spk2gender.add((f"{name}-B", m.group(3)))
        known = set(utt2spk.values())
        kaldi.write_key_value_file(
            os.path.join(out_dir, "spk2gender"),
            sorted((s, g) for s, g in spk2gender if s in known))

    return {name: os.path.join(out_dir, name)
            for name in ("text", "segments", "utt2spk", "spk2utt",
                         "reco2file_and_channel")}
