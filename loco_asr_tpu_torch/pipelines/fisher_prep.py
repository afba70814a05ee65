"""Fisher corpus preparation CLI, the port of
``loco_asr_tpu.pipelines.fisher_prep`` (same flags, same manifests but for
the wav.scp pipes' module, which is this package's ``sph_decode``).

    python -m loco_asr_tpu_torch.pipelines.fisher_prep <fisher_dir> \
        [--out_dir data/train_all] [--calldata] [--split_dir <dir>] \
        [--split_out data] [--sets train dev ...] [--expected_count N] [--strict]

The entry of the reference's scripts/fisher_data_prep.sh <FISHER_DIR> plus
its topic split, as one command: walks an LDC-style corpus tree for
transcripts (*.txt under */trans/*) and SPHERE audio (*.sph), checks the
transcript/audio pairing (the reference counts 11,699 of each), writes
the Kaldi train_all dir, optionally applies the calldata true-speaker
remap (--calldata) and filters topic splits (--split_dir).  No torch.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Prepare Fisher data (Kaldi format)")
    p.add_argument("fisher_dir", help="root holding the LDC corpus parts")
    p.add_argument("--out_dir", default="data/train_all")
    p.add_argument("--calldata", action="store_true",
                   help="remap speaker ids from *calldata.tbl files")
    p.add_argument("--split_dir", default=None,
                   help="dir with {set}.recids files to split by")
    p.add_argument("--split_out", default="data")
    p.add_argument("--sets", nargs="+",
                   default=["train", "dev", "test", "train_500", "dev_6"])
    p.add_argument("--expected_count", type=int, default=None,
                   help="integrity check: required number of transcript/sph "
                        "pairs (the full corpus has 11699)")
    p.add_argument("--strict", action="store_true",
                   help="reproduce the reference's integrity gate "
                        "(fisher_data_prep.sh:89-98): fail unless transcript "
                        "and sph counts match --expected_count (default "
                        "11699) and every transcript has its sph and vice "
                        "versa")
    return p.parse_args(argv)


def find_corpus_files(root: str):
    transcripts = sorted(
        f for f in glob.glob(os.path.join(root, "**", "*.txt"), recursive=True)
        if os.path.basename(f).startswith("fe_03_") or "/trans" in f.replace("\\", "/"))
    spheres = sorted(glob.glob(os.path.join(root, "**", "*.sph"), recursive=True))
    calldata = sorted(glob.glob(os.path.join(root, "**", "*calldata.tbl"),
                                recursive=True))
    filetables = sorted(glob.glob(os.path.join(root, "**", "filetable*.txt"),
                                  recursive=True))
    return transcripts, spheres, calldata, filetables


def main(argv=None) -> int:
    args = parse_args(argv)

    from ..data import fisher_prep, fisher_speakerid, fisher_split

    transcripts, spheres, calldata_files, filetables = find_corpus_files(args.fisher_dir)
    print(f"found {len(transcripts)} transcripts, {len(spheres)} sph files",
          file=sys.stderr)

    t_ids = {os.path.basename(t).rsplit(".", 1)[0] for t in transcripts}
    s_ids = {os.path.basename(s).rsplit(".", 1)[0] for s in spheres}
    expected = args.expected_count
    if args.strict and expected is None:
        expected = 11699  # the full Fisher corpus (fisher_data_prep.sh:90-97)
    if spheres and t_ids != s_ids:
        missing = sorted(t_ids ^ s_ids)[:5]
        level = "ERROR" if args.strict else "WARNING"
        print(f"{level}: transcript/audio mismatch ({len(t_ids ^ s_ids)} ids, "
              f"e.g. {missing})", file=sys.stderr)
        if args.strict:
            return 1
    if expected is not None and len(transcripts) != expected:
        print(f"ERROR: expected {expected} transcripts, found "
              f"{len(transcripts)}", file=sys.stderr)
        return 1
    if args.strict and len(spheres) != expected:
        print(f"ERROR: expected {expected} .sph files, found {len(spheres)}",
              file=sys.stderr)
        return 1

    filetable_lines = []
    for ft in filetables:
        with open(ft, "r", encoding="utf-8", errors="replace") as f:
            filetable_lines.extend(f.readlines())

    fisher_prep.prepare_fisher(
        transcripts, args.out_dir, sphere_files=spheres or None,
        filetable_lines=filetable_lines or None)
    print(f"wrote Kaldi dir {args.out_dir}", file=sys.stderr)

    if args.calldata and calldata_files:
        lines = []
        for c in calldata_files:
            with open(c, "r", encoding="utf-8", errors="replace") as f:
                lines.extend(f.readlines())
        missing = fisher_speakerid.fix_speaker_ids(
            fisher_speakerid.load_calldata(lines), args.out_dir, apply=True)
        print(f"speaker remap done ({len(missing)} conversations retained "
              f"old ids)", file=sys.stderr)

    if args.split_dir:
        out = fisher_split.split_data_dir(args.split_dir, args.out_dir,
                                          args.split_out, sets=args.sets)
        for name, path in out.items():
            print(f"split {name}: {path}", file=sys.stderr)

    print("Data preparation succeeded", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
