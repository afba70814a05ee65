"""Host-side audio decode and resampling (numpy): WAV and NIST SPHERE
(pcm, mu-law, A-law) readers and a polyphase windowed-sinc resampler, the
same functions as ``loco_asr_tpu.ops.audio``; SpecAugment span masks
(:func:`compute_mask_indices`), drawn on the device from a
``torch.Generator``; and the SpeechT5 log-mel front end
(:func:`log_mel_spectrogram`: periodic Hann window, 1024-point |rfft|,
slaney mel bank, log10), the plain version of kernel B7
(``ops/cuda/logmel.py``).  The window and the mel bank are built in
float64 and cast to float32 once, as in the JAX package.

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


def hann_window(length: int, periodic: bool = True) -> np.ndarray:
    """Hann window, float64 (``periodic`` drops the last point of a
    ``length + 1`` symmetric window)."""
    n = length + 1 if periodic else length
    w = 0.5 * (1 - np.cos(2 * np.pi * np.arange(n) / (n - 1)))
    return w[:length].astype(np.float64)


def hertz_to_mel_slaney(freq):
    freq = np.asarray(freq, np.float64)
    mels = 3.0 * freq / 200.0
    log_region = freq >= 1000.0
    logstep = 27.0 / np.log(6.4)
    return np.where(log_region, 15.0 + np.log(np.maximum(freq, 1e-10) / 1000.0) * logstep, mels)


def mel_to_hertz_slaney(mels):
    mels = np.asarray(mels, np.float64)
    freq = 200.0 * mels / 3.0
    log_region = mels >= 15.0
    logstep = np.log(6.4) / 27.0
    return np.where(log_region, 1000.0 * np.exp(logstep * (mels - 15.0)), freq)


def mel_filter_bank(num_frequency_bins: int, num_mel_filters: int,
                    min_frequency: float, max_frequency: float,
                    sampling_rate: int) -> np.ndarray:
    """Slaney-scale, slaney-normalised triangular mel filter bank
    (``transformers.audio_utils.mel_filter_bank(norm="slaney",
    mel_scale="slaney")`` as SpeechT5FeatureExtractor builds it), computed
    in float64: float32 [num_frequency_bins, num_mel_filters]."""
    mel_min = hertz_to_mel_slaney(min_frequency)
    mel_max = hertz_to_mel_slaney(max_frequency)
    mel_freqs = np.linspace(mel_min, mel_max, num_mel_filters + 2)
    filter_freqs = mel_to_hertz_slaney(mel_freqs)
    fft_freqs = np.linspace(0, sampling_rate // 2, num_frequency_bins)

    filter_diff = np.diff(filter_freqs)
    slopes = filter_freqs[None, :] - fft_freqs[:, None]  # [bins, mels+2]
    down = -slopes[:, :-2] / filter_diff[:-1]
    up = slopes[:, 2:] / filter_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))

    enorm = 2.0 / (filter_freqs[2:] - filter_freqs[:-2])
    fb *= enorm[None, :]
    return fb.astype(np.float32)


def reflect_indices(length: int, start: int, stop: int) -> np.ndarray:
    """Source index in ``[0, length)`` of each position ``start..stop-1`` of
    a signal reflect-padded on both sides, with numpy's rule for a pad
    longer than the signal: reflect again (period ``2 * (length - 1)``), so
    ``np.pad(x, p, "reflect")[i + p] == x[reflect_indices(len(x), -p,
    len(x) + p)[i]]``.  ``torch.nn.functional.pad`` refuses such pads."""
    i = np.arange(start, stop)
    if length == 1:
        return np.zeros_like(i)
    period = 2 * (length - 1)
    i = np.mod(i, period)
    return np.where(i < length, i, period - i)


def frame_signal(wav: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """[.., T] waveform -> [.., 1 + T // hop, frame_length] frames (for an
    even ``frame_length``), reflect-padded by ``frame_length // 2`` on both
    sides (numpy's repeated reflection for short rows)."""
    t = wav.shape[-1]
    pad = frame_length // 2
    num_frames = 1 + (t + 2 * pad - frame_length) // hop
    if num_frames < 1:
        raise ValueError(f"a waveform of {t} samples gives no frame of {frame_length}")
    src = reflect_indices(t, -pad, t + pad)
    idx = (np.arange(num_frames)[:, None] * hop + np.arange(frame_length)[None, :])
    return wav[..., torch.from_numpy(src[idx]).to(wav.device)]


def log_mel_spectrogram(
    wav: torch.Tensor, *,
    sampling_rate: int = 16000, frame_length: int = 1024, hop: int = 256,
    fft_length: int = 1024, num_mel_bins: int = 80,
    fmin: float = 80.0, fmax: float = 7600.0, mel_floor: float = 1e-10,
) -> torch.Tensor:
    """Waveform [.., T] -> log10-mel [.., 1 + T // hop, num_mel_bins],
    float32.

    Default parameters replicate SpeechT5FeatureExtractor (64 ms periodic
    Hann window, 16 ms hop, magnitude spectrum, slaney mels, log10 with a
    1e-10 floor).  Frames are cut from each (padded) row as it is given,
    so the reflection at the end of a zero-padded row mirrors its zero
    tail."""
    window = hann_window(frame_length, periodic=True)
    mel_filters = mel_filter_bank(fft_length // 2 + 1, num_mel_bins, fmin, fmax,
                                  sampling_rate)
    frames = frame_signal(wav.to(torch.float32), frame_length, hop)
    frames = frames * torch.as_tensor(window, dtype=torch.float32, device=wav.device)
    spec = torch.fft.rfft(frames, n=fft_length, dim=-1).abs()
    mel = spec @ torch.as_tensor(mel_filters, dtype=torch.float32, device=wav.device)
    return torch.log10(torch.clamp(mel, min=mel_floor))
