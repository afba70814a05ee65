"""Host-side audio decode and resampling (numpy): WAV and NIST SPHERE
(pcm, mu-law, A-law) readers and a polyphase windowed-sinc resampler, the
same functions as ``loco_asr_tpu.ops.audio``; and SpecAugment span masks
(:func:`compute_mask_indices`), drawn on the device from a
``torch.Generator``.

Shorten-coded SPHERE raises ``NotImplementedError``: its decoder is not
ported yet.
"""

from __future__ import annotations

import math
import wave
from typing import Optional, Tuple

import numpy as np
import torch

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

    Supports ulaw / alaw / pcm (1-2 bytes) and 1-2 channels; ``channel``
    selects the 0-based channel, else channels are averaged.
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
        f.seek(header_size)
        raw = f.read()

    if "shorten" in encoding:
        raise NotImplementedError(
            f"{path}: shorten-coded SPHERE is not supported by this package "
            "yet; decode it with loco_asr_tpu's sph_decode first")

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


def compute_mask_indices(generator: Optional[torch.Generator],
                         shape: Tuple[int, int], mask_prob: float,
                         mask_length: int,
                         lengths: Optional[torch.Tensor] = None,
                         min_masks: int = 0, *,
                         device: Optional[torch.device] = None) -> torch.Tensor:
    """SpecAugment span masks, [B, T] bool, with the rules of the JAX
    ``compute_mask_indices``: row b gets
    ``max(int(mask_prob * len_b / mask_length + u_b), min_masks)`` spans
    (``u_b`` uniform in [0, 1)) of ``mask_length`` steps, each starting at
    ``int(u * max(len_b - mask_length, 1))``, spans clipped to the row's
    valid length.  The random numbers come from ``generator``, so they
    differ from JAX's; the counts and bounds do not."""
    b, t = shape
    if lengths is None:
        lengths = torch.full((b,), t, device=device)
    lengths = lengths.to(torch.int64)
    dev = lengths.device
    u = torch.rand(b, generator=generator, device=dev)
    num_spans = torch.clamp(
        (mask_prob * lengths.to(torch.float32) / mask_length + u).to(torch.int64),
        min=min_masks)
    max_spans = int(mask_prob * t / mask_length + 1) + min_masks
    span_max = torch.clamp(lengths - mask_length, min=1)[:, None]
    starts = (torch.rand(b, max_spans, generator=generator, device=dev)
              * span_max).to(torch.int64)
    active = torch.arange(max_spans, device=dev)[None, :] < num_spans[:, None]
    pos = torch.arange(t, device=dev)[None, None, :]
    in_span = (pos >= starts[..., None]) & (pos < (starts + mask_length)[..., None])
    mask = torch.any(in_span & active[..., None], dim=1)
    return mask & (torch.arange(t, device=dev)[None, :] < lengths[:, None])
