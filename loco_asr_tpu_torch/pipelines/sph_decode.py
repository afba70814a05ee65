"""sph2pipe-compatible CLI: decode NIST SPHERE to WAV on stdout, the port
of ``loco_asr_tpu.pipelines.sph_decode`` (the same bytes out).

    python -m loco_asr_tpu_torch.pipelines.sph_decode [-f wav|raw] [-p] [-c 1|2] file.sph [out]

The command of the wav.scp pipes that ``data/fisher_prep.py`` writes
(sph2pipe's ``sph2pipe -f wav -p -c {1,2} file |``).  Channels are 1-based
like sph2pipe's ``-c``; without ``-c`` the channels are mixed.  It decodes
through the C++ ingest core (``native``) when that builds and through the
numpy readers (``ops/audio_io.py``, ``ops/shorten.py``) otherwise.  The
process imports numpy and those modules only: no torch, one pipe for each
channel of every call of a corpus.
"""

from __future__ import annotations

import argparse
import struct
import sys


def wav_header(n_samples: int, sample_rate: int, channels: int = 1,
               bits: int = 16) -> bytes:
    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    data_size = n_samples * block_align
    return (b"RIFF" + struct.pack("<I", 36 + data_size) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, sample_rate,
                                    byte_rate, block_align, bits)
            + b"data" + struct.pack("<I", data_size))


def decode(path: str, channel=None):
    """(float32 samples, rate) of ``path``'s 0-based ``channel`` (None
    mixes), through the native core when it builds and reads the file,
    else numpy."""
    from .. import native

    if native.available():
        try:
            return native.read_sphere(path, channel)
        except ValueError:
            pass
    from ..ops.audio_io import read_sphere
    return read_sphere(path, channel)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="SPHERE -> WAV decoder (sph2pipe replacement)")
    p.add_argument("-c", "--channel", type=int, default=None,
                   help="1-based channel (sph2pipe convention); default: mix")
    p.add_argument("-f", "--format", default="wav", choices=["wav", "raw"],
                   help="wav: a RIFF header, then the samples; raw: the samples")
    p.add_argument("-p", action="store_true",
                   help="force PCM output (sph2pipe parity; always on here)")
    p.add_argument("sph", help="input .sph file")
    p.add_argument("out", nargs="?", default=None,
                   help="output file (default: stdout)")
    args = p.parse_args(argv)

    import numpy as np

    wav, rate = decode(args.sph, None if args.channel is None else args.channel - 1)
    pcm = np.clip(wav * 32768.0, -32768, 32767).astype("<i2")
    out = sys.stdout.buffer if args.out is None else open(args.out, "wb")
    try:
        if args.format == "wav":
            out.write(wav_header(len(pcm), rate))
        out.write(pcm.tobytes())
    finally:
        if args.out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
