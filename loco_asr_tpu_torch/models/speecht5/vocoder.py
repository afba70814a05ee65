"""HiFi-GAN vocoder (log-mel -> waveform), as in
``loco_asr_tpu.models.speecht5.vocoder``: conv_pre -> [leaky ReLU ->
transposed-conv upsample -> mean of the multi-kernel residual blocks] per
rate -> leaky ReLU (slope 0.01) -> conv_post -> tanh, with the optional
mean/scale input normalisation.  Parameter names and layouts are the JAX
tree's (HF SpeechT5HifiGan's): conv weights OIH, the transposed convs'
``(in, out, k)``.  The convolutions are ``F.conv1d`` /
``F.conv_transpose1d`` (cuDNN on the card), as XLA ran them for the JAX
package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import layers
from ...utils.device import resolve_device
from .prenets import Conv


@dataclasses.dataclass(frozen=True)
class HifiGanConfig:
    """``microsoft/speecht5_hifigan``'s layout."""
    model_in_dim: int = 80
    sampling_rate: int = 16000
    upsample_initial_channel: int = 512
    upsample_rates: Tuple[int, ...] = (4, 4, 4, 4)
    upsample_kernel_sizes: Tuple[int, ...] = (8, 8, 8, 8)
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    leaky_relu_slope: float = 0.1
    normalize_before: bool = True


def tiny_hifigan_config(**over) -> HifiGanConfig:
    base = dict(model_in_dim=8, upsample_initial_channel=16,
                upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                resblock_kernel_sizes=(3, 7),
                resblock_dilation_sizes=((1, 3), (1, 3)))
    base.update(over)
    return HifiGanConfig(**base)


class Upsampler(nn.Module):
    """Transposed-conv weight ``(in, out, k)``, uniform +-1/sqrt(in k), and
    a zero bias."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.weight = layers.uniform_param((in_ch, out_ch, kernel), in_ch * kernel,
                                           generator)
        self.bias = nn.Parameter(torch.zeros(out_ch))


class ResBlock(nn.Module):
    def __init__(self, channels: int, kernel: int, dilations: Sequence[int],
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.convs1 = nn.ModuleList(Conv(channels, channels, kernel, bias=True,
                                         generator=generator) for _ in dilations)
        self.convs2 = nn.ModuleList(Conv(channels, channels, kernel, bias=True,
                                         generator=generator) for _ in dilations)


class HifiGan(nn.Module):
    """The JAX ``hifigan_init`` tree: ``conv_pre``, ``mean`` / ``scale``
    (buffers: HF keeps them as such), ``upsampler.{i}``,
    ``resblocks.{i * len(kernels) + j}``, ``conv_post``."""

    def __init__(self, cfg: HifiGanConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        c0 = cfg.upsample_initial_channel
        self.conv_pre = Conv(cfg.model_in_dim, c0, 7, bias=True, generator=generator)
        self.register_buffer("mean", torch.zeros(cfg.model_in_dim))
        self.register_buffer("scale", torch.ones(cfg.model_in_dim))
        self.upsampler = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, k in enumerate(cfg.upsample_kernel_sizes):
            in_ch, out_ch = c0 // 2 ** i, c0 // 2 ** (i + 1)
            self.upsampler.append(Upsampler(in_ch, out_ch, k, generator))
            for rk, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                self.resblocks.append(ResBlock(out_ch, rk, dils, generator))
        last = c0 // 2 ** len(cfg.upsample_rates)
        self.conv_post = Conv(last, 1, 7, bias=True, generator=generator)


def hifigan_init(cfg: HifiGanConfig, *, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None) -> HifiGan:
    """Seeded random init (the JAX ``hifigan_init``'s distributions; the
    numbers differ), in eval mode on ``device`` (default CUDA; raises when
    no GPU is present)."""
    dev = resolve_device(device)
    return HifiGan(cfg, torch.Generator().manual_seed(seed)).to(dev).eval()


def _resblock(block: ResBlock, x: torch.Tensor, kernel: int,
              dilations: Sequence[int], slope: float) -> torch.Tensor:
    for c1, c2, dil in zip(block.convs1, block.convs2, dilations):
        h = F.conv1d(F.leaky_relu(x, slope), c1.weight, c1.bias,
                     padding=(kernel * dil - dil) // 2, dilation=dil)
        h = F.conv1d(F.leaky_relu(h, slope), c2.weight, c2.bias,
                     padding=(kernel - 1) // 2)
        x = h + x
    return x


def hifigan(model: HifiGan, spectrogram: torch.Tensor) -> torch.Tensor:
    """[B, T, mel] (or [T, mel]) log-mel -> waveform [B, T * prod(rates)]
    (or [T * prod(rates)]) in (-1, 1)."""
    cfg = model.cfg
    batched = spectrogram.dim() == 3
    if not batched:
        spectrogram = spectrogram[None]
    if cfg.normalize_before:
        spectrogram = (spectrogram - model.mean) / model.scale
    x = layers.conv1d(spectrogram.transpose(1, 2), model.conv_pre.weight,
                      model.conv_pre.bias, padding=3)
    nk = len(cfg.resblock_kernel_sizes)
    slope = cfg.leaky_relu_slope
    for i, (rate, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        up = model.upsampler[i]
        x = F.conv_transpose1d(F.leaky_relu(x, slope), up.weight, up.bias,
                               stride=rate, padding=(k - rate) // 2)
        acc = None
        for j, (rk, dils) in enumerate(zip(cfg.resblock_kernel_sizes,
                                           cfg.resblock_dilation_sizes)):
            r = _resblock(model.resblocks[i * nk + j], x, rk, dils, slope)
            acc = r if acc is None else acc + r
        x = acc / nk
    x = F.leaky_relu(x, 0.01)     # torch's default slope: HF passes none here
    x = torch.tanh(layers.conv1d(x, model.conv_post.weight, model.conv_post.bias,
                                 padding=3))
    wav = x[:, 0, :]
    return wav if batched else wav[0]

