"""Kernel B7: the SpeechT5 log-mel front end, waveform -> reflect-padded
frames -> periodic Hann window -> |rfft| -> slaney mel -> log10, as one
CUDA kernel (``csrc/logmel.cu``) beside its plain PyTorch version.

Counterpart of ``loco_asr_tpu/ops/pallas/logmel.py`` (``fused_log_mel``),
with the same signature less ``block_frames`` / ``interpret``.  The TPU
kernel takes the DFT as two matmuls; this one runs a radix-8 FFT one warp a
frame, in registers and the warp's shared memory, and cuts each frame from
the waveform itself (see the source's note).  :func:`fft_plan`,
and :func:`twiddle_table` are the kernel's schedule and table, which the
CPU tests hold to numpy.

:func:`fused_log_mel` launches the kernel for a CUDA tensor and takes the
plain version only for a CPU tensor; ``launches`` counts kernel launches.
The kernel has no backward, as the Pallas one has none: on CUDA with an
input that requires grad the wrapper raises rather than return a detached
output.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from .. import audio
from . import _build

MAX_FFT = 4096          # the block-per-frame kernel (m = 1024, 2048) stays under 48 KB
_SMEM_LIMIT = 48 * 1024
WARPS = 8               # frames a block of the warp kernel (m <= 512) holds at once


# plain PyTorch version of the kernel
fused_log_mel_plain = audio.log_mel_spectrogram


def fft_plan(m: int) -> Tuple[Tuple[int, int], ...]:
    """(radix, p) of each Stockham pass of the kernel's FFT on ``m``
    complex points: radix 8 while 8 divides what is left, then 4 or 2; p is
    the product of the earlier radices.  Pass (r, p) reads inputs i + s m/r
    of butterfly i, multiplies input s by W_{rp}^{s (i mod p)}, and writes
    output s to (i - i mod p) r + i mod p + s p."""
    plan, p = [], 1
    while p < m:
        r = min(8, m // p)
        plan.append((r, p))
        p *= r
    return tuple(plan)


def twiddle_table(fft_length: int) -> np.ndarray:
    """[fft_length, 2] float32 (2m entries, m = fft_length / 2), built in
    float64: for each pass (r, p) of :func:`fft_plan`, W_{rp}^{s k} at
    p - 1 + (s - 1) p + k for s = 1..r-1, k < p (the passes fill [0, m - 1)),
    then the post-pass's W_N^k for k = 0..m at m - 1."""
    m = fft_length // 2
    parts = [np.exp(-2j * np.pi * np.arange(1, r)[:, None] * np.arange(p)[None, :]
                    / (r * p)).ravel() for r, p in fft_plan(m)]
    parts.append(np.exp(-2j * np.pi * np.arange(m + 1) / fft_length))
    w = np.concatenate(parts)
    return np.stack([w.real, w.imag], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _host_constants(sampling_rate: int, frame_length: int, fft_length: int,
                    num_mel_bins: int, fmin: float, fmax: float
                    ) -> Tuple[np.ndarray, ...]:
    """Window [fft_length] (zero past ``frame_length``), the twiddle table
    of :func:`twiddle_table`, and the mel bank as (first bin, count)
    [n_mel, 2] int32 with each triangle's weights in a padded [n_mel, max
    count] table; all computed in float64 and cast to float32 once."""
    window = np.zeros(fft_length, np.float32)
    window[:frame_length] = audio.hann_window(frame_length, periodic=True)
    m = fft_length // 2
    bank = audio.mel_filter_bank(m + 1, num_mel_bins, fmin, fmax, sampling_rate)
    ranges = np.zeros((num_mel_bins, 2), np.int32)
    for j in range(num_mel_bins):
        nz = np.flatnonzero(bank[:, j])
        if len(nz):
            ranges[j] = nz[0], nz[-1] + 1 - nz[0]
    weights = np.zeros((num_mel_bins, max(1, int(ranges[:, 1].max()))), np.float32)
    for j, (lo, n) in enumerate(ranges):
        weights[j, :n] = bank[lo:lo + n, j]
    return window, twiddle_table(fft_length), ranges, weights


def bin_range(ranges: np.ndarray) -> Tuple[int, int]:
    """[lo, hi): the FFT bins the sparse bank reads ((0, 0) if none)."""
    used = ranges[ranges[:, 1] > 0]
    if not len(used):
        return 0, 0
    return int(used[:, 0].min()), int((used[:, 0] + used[:, 1]).max())


@functools.lru_cache(maxsize=8)
def _constants(device: torch.device, *key) -> Tuple[torch.Tensor, ...]:
    """:func:`_host_constants` on ``device``, copied once per device."""
    return tuple(torch.from_numpy(a).to(device) for a in _host_constants(*key))


@functools.lru_cache(maxsize=8)
def _launch_plan(index: int, *key) -> tuple:
    """Per device and constants: the device tensors, the bank's bin range,
    and the most blocks of the persistent warp kernel (SMs times blocks an
    SM; 0 where m > 512, one block a frame)."""
    consts = _constants(torch.device("cuda", index), *key)
    fft_length, n_mel = key[2], key[3]
    stride = consts[3].shape[1]
    lib = _build.library()
    with torch.cuda.device(index):
        per_sm = lib.loco_logmel_blocks_per_sm((fft_length // 2).bit_length() - 1,
                                               n_mel, stride)
    if per_sm < 0:
        _build.check(-per_sm, "logmel")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return consts, bin_range(_host_constants(*key)[2]), per_sm * sms


def fused_log_mel(wav: torch.Tensor, *, sampling_rate: int = 16000,
                  frame_length: int = 1024, hop: int = 256,
                  fft_length: int = 1024, num_mel_bins: int = 80,
                  fmin: float = 80.0, fmax: float = 7600.0,
                  mel_floor: float = 1e-10) -> torch.Tensor:
    """[.., T] float32 waveform -> [.., 1 + (T + 2 (L//2) - L) // hop,
    num_mel_bins] log10-mel (L = ``frame_length``; ``1 + T // hop`` at the
    defaults).  Defaults: the SpeechT5 feature extractor."""
    if wav.device.type == "cpu":
        return fused_log_mel_plain(
            wav, sampling_rate=sampling_rate, frame_length=frame_length, hop=hop,
            fft_length=fft_length, num_mel_bins=num_mel_bins, fmin=fmin, fmax=fmax,
            mel_floor=mel_floor)
    if wav.device.type != "cuda":
        raise ValueError(f"unsupported device {wav.device}")
    if torch.is_grad_enabled() and wav.requires_grad:
        raise RuntimeError("fused_log_mel: kernel B7 has no backward; call it "
                           "under torch.no_grad() or on a detached waveform")
    if wav.dtype != torch.float32:
        raise ValueError(f"wav must be float32, got {wav.dtype}")
    if fft_length & (fft_length - 1) or not 64 <= fft_length <= MAX_FFT:
        raise ValueError(f"fft_length must be a power of two in [64, {MAX_FFT}], "
                         f"got {fft_length}")
    if not 0 < frame_length <= fft_length or hop < 1:
        raise ValueError(f"need 0 < frame_length <= fft_length and hop >= 1, got "
                         f"frame_length {frame_length}, hop {hop}")
    m = fft_length // 2
    if m * 8 + (m + 1 + num_mel_bins) * 4 > _SMEM_LIMIT:
        raise ValueError(f"{num_mel_bins} mel bins do not fit the kernel's shared memory")
    lead, t = wav.shape[:-1], wav.shape[-1]
    pad = frame_length // 2
    n_frames = 1 + (t + 2 * pad - frame_length) // hop
    if t < 1 or n_frames < 1:
        raise ValueError(f"a waveform of {t} samples gives no frame of {frame_length}")
    rows = math.prod(lead)
    if rows * n_frames > 2 ** 31 - 1:
        raise ValueError(f"{rows} x {n_frames} frames exceed one launch's grid")
    x = wav.reshape(rows, t)
    if not x.is_contiguous():
        x = x.contiguous()
    out = torch.empty((rows, n_frames, num_mel_bins), dtype=torch.float32,
                      device=wav.device)
    if rows == 0:
        return out.reshape(*lead, n_frames, num_mel_bins)
    index = wav.device.index if wav.device.index is not None else torch.cuda.current_device()
    (window, twiddle, ranges, weights), (lo, hi), max_blocks = _launch_plan(
        index, sampling_rate, frame_length, fft_length, num_mel_bins, float(fmin),
        float(fmax))
    grid = min(max_blocks, -(-rows * n_frames // WARPS))
    code = _build.call_on_stream(
        _build.library().loco_logmel, wav.device, x.data_ptr(), window.data_ptr(),
        twiddle.data_ptr(), ranges.data_ptr(), weights.data_ptr(), out.data_ptr(), rows, t,
        n_frames, frame_length, hop, pad, m.bit_length() - 1, num_mel_bins,
        weights.shape[1], lo, hi, grid, mel_floor)
    _build.check(code, "logmel")
    fused_log_mel.launches += 1
    return out.reshape(*lead, n_frames, num_mel_bins)


fused_log_mel.launches = 0
