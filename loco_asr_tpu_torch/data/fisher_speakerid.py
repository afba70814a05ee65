"""True-speaker remap from Fisher calldata tables, the port's own copy of
``loco_asr_tpu.data.fisher_speakerid`` (same outputs).

A port of the reference's fisher_fix_speakerid.pl (run by
fisher_data_prep.sh under --calldata): calldata.tbl rows are CSV whose
field 0 is the conversation id and fields 5/10 the physical speaker pins
for sides A/B; utterance/speaker ids 'fe_03_NNNNN-X...' become
'fe_03_<PIN>-X...' across utt2spk, spk2gender, segments and text, and
spk2utt is rebuilt.  Conversations missing from the table keep their old
ids (with a warning), as the perl script does.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List

from . import kaldi


def load_calldata(path_or_lines) -> Dict[str, str]:
    """calldata.tbl -> {'fe_03_NNNNN-A': pin, ...-B': pin}."""
    if isinstance(path_or_lines, str):
        with open(path_or_lines, "r", encoding="utf-8", errors="replace") as f:
            lines = f.readlines()
    else:
        lines = list(path_or_lines)
    conv_to_spk: Dict[str, str] = {}
    for line in lines:
        fields = line.rstrip("\n").split(",")
        if len(fields) < 11:
            continue
        conv_to_spk[f"fe_03_{fields[0]}-A"] = fields[5].strip()
        conv_to_spk[f"fe_03_{fields[0]}-B"] = fields[10].strip()
    return conv_to_spk


def fix_speaker_ids(calldata, data_dir: str, apply: bool = True) -> List[str]:
    """Rewrite utt2spk/spk2gender/segments/text with true speaker ids.

    Writes '<file>.new' beside each input; with ``apply`` the originals are
    backed up to '<file>.old' and replaced, and spk2utt is rebuilt
    (fisher_data_prep.sh:198-204).  Returns missing conversation ids.
    """
    conv_to_spk = calldata if isinstance(calldata, dict) else load_calldata(calldata)
    missing = set()

    def remap_prefix(line: str) -> str:
        convid = line[:13]   # 'fe_03_NNNNN-X'
        if convid in conv_to_spk:
            return f"fe_03_{conv_to_spk[convid]}-{line[6:]}"
        missing.add(convid[6:11])
        return line

    # utt2spk: both utt id and spk id change
    utt2spk_path = os.path.join(data_dir, "utt2spk")
    with open(utt2spk_path) as f, open(utt2spk_path + ".new", "w") as out:
        for line in f:
            fields = line.split()
            convid = fields[0][:13]
            if convid in conv_to_spk:
                spkid = f"fe_03_{conv_to_spk[convid]}"
                out.write(f"{spkid}-{fields[0][6:]} {spkid}\n")
            else:
                missing.add(convid[6:11])
                out.write(f"{fields[0]} {fields[1]}\n")

    # spk2gender: speaker id column only
    g_path = os.path.join(data_dir, "spk2gender")
    if os.path.exists(g_path):
        with open(g_path) as f, open(g_path + ".new", "w") as out:
            for line in f:
                fields = line.split()
                if fields[0] in conv_to_spk:
                    out.write(f"fe_03_{conv_to_spk[fields[0]]} {fields[1]}\n")
                else:
                    out.write(f"{fields[0]} {fields[1]}\n")

    # segments and text: leading utt id prefix
    for name in ("segments", "text"):
        path = os.path.join(data_dir, name)
        with open(path) as f, open(path + ".new", "w") as out:
            for line in f:
                out.write(remap_prefix(line.rstrip("\n")) + "\n")

    for conv in sorted(missing):
        print(f"Warning: Conversation ID '{conv}' not found in conv.tab, "
              f"retaining old speaker IDs", file=sys.stderr)

    if apply:
        names = ["utt2spk", "segments", "text"]
        if os.path.exists(g_path):
            names.append("spk2gender")
        for name in names:
            path = os.path.join(data_dir, name)
            os.replace(path, path + ".old")
            os.replace(path + ".new", path)
        utt2spk = kaldi.read_key_value_file(os.path.join(data_dir, "utt2spk"))
        kaldi.write_spk2utt(os.path.join(data_dir, "spk2utt"),
                            kaldi.utt2spk_to_spk2utt(utt2spk))
    return sorted(missing)
