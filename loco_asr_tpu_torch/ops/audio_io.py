"""Host-side audio decode and resampling, numpy only (no torch): WAV and
NIST SPHERE readers -- pcm, mu-law, A-law and shorten-coded
("embedded-shorten-v2.xx", the coding LDC ships telephone corpora in) --
and a polyphase windowed-sinc resampler.  The same functions as
``loco_asr_tpu.ops.audio``; ``ops/audio.py`` re-exports them, and the
``sph_decode`` pipe CLI imports this module so that its process loads no
torch.  ``loco_asr_tpu_torch.native`` is the C++ fast lane of the same
readers.
"""

from __future__ import annotations

import math
import wave
from typing import Optional, Tuple

import numpy as np

_ULAW_BIAS = 0x84


def ulaw_to_linear(u: np.ndarray) -> np.ndarray:
    """mu-law byte -> int16 PCM (G.711, matches sph2pipe's table)."""
    u = ~u.astype(np.uint8)
    sign = u & 0x80
    exponent = (u >> 4) & 0x07
    mantissa = u & 0x0F
    sample = ((mantissa.astype(np.int32) << 3) + _ULAW_BIAS) << exponent
    sample -= _ULAW_BIAS
    return np.where(sign != 0, -sample, sample).astype(np.int16)


def alaw_to_linear(a: np.ndarray) -> np.ndarray:
    """A-law byte -> int16 PCM (G.711)."""
    a = a.astype(np.uint8) ^ 0x55
    sign = a & 0x80
    exponent = (a >> 4) & 0x07
    mantissa = (a & 0x0F).astype(np.int32)
    sample = (mantissa << 4) + 8
    sample = np.where(exponent > 0, (sample + 0x100) << (exponent - 1), sample)
    return np.where(sign != 0, -sample, sample).astype(np.int16)


def read_sphere(path: str, channel: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Read a NIST SPHERE file -> (float32 waveform in [-1, 1], sample_rate).

    Supports ulaw / alaw / pcm (1-2 bytes) and shorten-coded payloads
    (``ops/shorten.py``), 1-2 channels; ``channel`` selects the 0-based
    channel (sph2pipe's ``-c 1`` / ``-c 2`` are 0 / 1), else channels are
    averaged.  A shorten stream is cropped to the header's
    ``sample_count`` and must carry the header's ``channel_count``.
    """
    with open(path, "rb") as f:
        magic = f.read(8)
        if not magic.startswith(b"NIST_1A"):
            raise ValueError(f"{path}: not a NIST SPHERE file")
        header_size = int(f.read(8).strip())
        f.seek(0)
        header = f.read(header_size).decode("ascii", errors="replace")
        fields = {}
        for line in header.splitlines()[2:]:
            line = line.strip()
            if line == "end_head" or not line:
                break
            parts = line.split(None, 2)
            if len(parts) == 3:
                name, typ, value = parts
                fields[name] = int(value) if typ.startswith("-i") else value
        n_channels = int(fields.get("channel_count", 1))
        sample_rate = int(fields.get("sample_rate", 8000))
        n_bytes = int(fields.get("sample_n_bytes", 2))
        encoding = str(fields.get("sample_coding", "pcm"))
        byte_format = str(fields.get("sample_byte_format", "01"))
        sample_count = fields.get("sample_count")
        f.seek(header_size)
        raw = f.read()

    if "shorten" in encoding:
        from . import shorten as shn
        samples, ftype = shn.decode(raw, max_samples=sample_count)
        vals = shn.internal_to_float(samples, ftype)  # [n, nchan]
        if sample_count:
            vals = vals[:sample_count]
        if vals.shape[1] != n_channels:
            raise ValueError(
                f"{path}: shorten stream has {vals.shape[1]} channels, "
                f"header says {n_channels}")
        if n_channels > 1:
            vals = vals[:, channel] if channel is not None else vals.mean(axis=1)
        else:
            vals = vals[:, 0]
        return np.ascontiguousarray(vals, np.float32), sample_rate

    if encoding.startswith("ulaw") or encoding.startswith("mu-law"):
        pcm = ulaw_to_linear(np.frombuffer(raw, np.uint8))
    elif encoding.startswith("alaw"):
        pcm = alaw_to_linear(np.frombuffer(raw, np.uint8))
    else:  # linear pcm
        dtype = np.dtype(np.int16 if n_bytes == 2 else np.int8)
        if n_bytes == 2 and byte_format == "10":
            dtype = dtype.newbyteorder(">")
        pcm = np.frombuffer(raw, dtype).astype(np.int16)

    if n_channels > 1:
        pcm = pcm[: (len(pcm) // n_channels) * n_channels].reshape(-1, n_channels)
        pcm = pcm[:, channel] if channel is not None else pcm.mean(axis=1).astype(np.int16)
    return pcm.astype(np.float32) / 32768.0, sample_rate


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a PCM WAV file -> (float32 mono waveform in [-1, 1], rate)."""
    with wave.open(path, "rb") as w:
        n_channels = w.getnchannels()
        width = w.getsampwidth()
        rate = w.getframerate()
        raw = w.readframes(w.getnframes())
    if width == 2:
        pcm = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 1:
        pcm = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 4:
        pcm = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        val = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
               | (b[:, 2].astype(np.int32) << 16))
        val = np.where(val >= 1 << 23, val - (1 << 24), val)
        pcm = val.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"{path}: unsupported sample width {width}")
    if n_channels > 1:
        pcm = pcm.reshape(-1, n_channels).mean(axis=1)
    return pcm, rate


def load_audio(path: str, target_sr: int = 16000) -> Tuple[np.ndarray, int]:
    """Decode WAV/SPHERE (auto-detected) and resample to ``target_sr``:
    float32 mono at the requested rate."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic.startswith(b"NIST_1A"):
        wav, sr = read_sphere(path)
    else:
        wav, sr = read_wav(path)
    if sr != target_sr:
        wav = resample(wav, sr, target_sr)
        sr = target_sr
    return wav, sr


def resample(x: np.ndarray, sr_in: int, sr_out: int, *, zeros: int = 32,
             rolloff: float = 0.945) -> np.ndarray:
    """Polyphase windowed-sinc resampler (Kaiser-windowed low-pass)."""
    if sr_in == sr_out:
        return x
    g = math.gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    cutoff = rolloff * 0.5 * min(1.0, up / down)
    half_width = zeros / (2.0 * cutoff)
    taps_per_phase = int(2 * half_width) + 1
    t = (np.arange(taps_per_phase * up) - taps_per_phase * up // 2) / up
    kernel = 2 * cutoff * np.sinc(2 * cutoff * t) * np.kaiser(len(t), 14.0)
    # upsample-filter-downsample: insert zeros, convolve, decimate
    y = np.zeros(len(x) * up, np.float32)
    y[::up] = x * up
    y = np.convolve(y, kernel.astype(np.float32), mode="same")
    return y[::down].astype(np.float32)
