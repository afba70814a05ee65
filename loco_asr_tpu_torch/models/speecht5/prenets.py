"""SpeechT5 speech encoder prenet: conv feature encoder, feature projection,
weight-normed grouped positional conv and sinusoidal positions, as in
``loco_asr_tpu.models.speecht5.prenets`` (deterministic forward; the
training-time SpecAugment is not ported yet).

Layer 0 of the feature encoder (conv k=10/s=5 + instance norm + GELU) runs
through kernel B2 (``ops/cuda/conv_frontend.py``) and emits channel-major
[B, C, F], so layers 1-6 run as ``F.conv1d`` directly.  Parameter names
follow the JAX tree (``feature_encoder.conv_layers.{i}.conv.weight`` ...)
so the weight bridge is a mechanical rename.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ...ops import layers
from ...ops.cuda import conv_frontend
from .config import SpeechT5Config


class Conv(nn.Module):
    """Conv weight (OIH) and optional bias, initialised as the JAX
    ``conv1d_init`` (uniform +-1/sqrt(fan_in), zero bias)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, *, bias: bool,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.weight = layers.uniform_param((out_ch, in_ch, kernel), in_ch * kernel,
                                           generator)
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None


class ConvLayer(nn.Module):
    def __init__(self, cfg: SpeechT5Config, i: int, generator: Optional[torch.Generator]):
        super().__init__()
        in_ch = 1 if i == 0 else cfg.conv_dim[i - 1]
        self.conv = Conv(in_ch, cfg.conv_dim[i], cfg.conv_kernel[i],
                         bias=cfg.conv_bias, generator=generator)
        if i == 0:   # instance norm (GroupNorm with groups == channels)
            self.layer_norm = layers.Norm(cfg.conv_dim[i])


def _check_frontend(cfg: SpeechT5Config) -> None:
    if cfg.feat_extract_norm != "group" or cfg.conv_kernel[0] != 2 * cfg.conv_stride[0]:
        raise ValueError(
            "the speech prenet needs feat_extract_norm='group' and a first "
            f"conv of kernel 2*stride, got {cfg.feat_extract_norm!r}, "
            f"kernel {cfg.conv_kernel[0]}, stride {cfg.conv_stride[0]}")


class FeatureEncoder(nn.Module):
    """wav2vec2-style conv stack: [B, T] waveform -> [B, frames, C]."""

    def __init__(self, cfg: SpeechT5Config, generator: Optional[torch.Generator]):
        super().__init__()
        _check_frontend(cfg)
        self.cfg = cfg
        self.conv_layers = nn.ModuleList(
            ConvLayer(cfg, i, generator) for i in range(len(cfg.conv_dim)))

    def forward(self, wav: torch.Tensor, *, use_kernels: bool = True) -> torch.Tensor:
        cfg = self.cfg
        c0 = self.conv_layers[0]
        first = (conv_frontend.conv1_instance_norm_gelu if use_kernels
                 else conv_frontend.conv1_instance_norm_gelu_plain)
        x = first(wav, c0.conv.weight, c0.layer_norm.weight, c0.layer_norm.bias,
                  stride=cfg.conv_stride[0])                        # [B, C, F]
        for i in range(1, len(cfg.conv_dim)):
            p = self.conv_layers[i]
            x = layers.gelu(layers.conv1d(x, p.conv.weight, p.conv.bias,
                                          stride=cfg.conv_stride[i]))
        return x.transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: SpeechT5Config, generator: Optional[torch.Generator]):
        super().__init__()
        self.layer_norm = layers.Norm(cfg.conv_dim[-1])
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)
        layers.init_dense(self.projection, generator)


class WeightNormConv(nn.Module):
    """Weight-normed grouped conv (``weight_g`` [1, 1, K], ``weight_v``,
    ``bias``), ``g`` initialised to the per-position norm of ``v``."""

    def __init__(self, channels: int, kernel: int, groups: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        v = layers.uniform_param((channels, channels // groups, kernel),
                                 channels // groups * kernel, generator).data
        self.weight_g = nn.Parameter(torch.sqrt(torch.sum(v * v, dim=(0, 1), keepdim=True)))
        self.weight_v = nn.Parameter(v)
        self.bias = nn.Parameter(torch.zeros(channels))


class PosConvEmbed(nn.Module):
    def __init__(self, cfg: SpeechT5Config, generator: Optional[torch.Generator]):
        super().__init__()
        self.conv = WeightNormConv(cfg.hidden_size, cfg.num_conv_pos_embeddings,
                                   cfg.num_conv_pos_embedding_groups, generator)


def sinusoidal_speech_table(cfg: SpeechT5Config, min_positions: int = 0) -> np.ndarray:
    """HF sizes the table ``max_speech_positions + pad + 1`` (+2 offset) and
    grows it on demand; here it is sized to the sequence up front."""
    num = max(cfg.max_speech_positions, min_positions) + cfg.pad_token_id + 1 + 2
    return layers.sinusoidal_table(num, cfg.hidden_size, padding_idx=cfg.pad_token_id)


def reduce_attention_mask(cfg: SpeechT5Config, frame_len: int,
                          attention_mask: torch.Tensor) -> torch.Tensor:
    """Waveform-resolution validity mask -> frame-resolution int32 mask: the
    frames strictly before the conv output length of the row's valid
    samples (HF ``_get_feature_vector_attention_mask``)."""
    lengths = attention_mask.to(torch.int64).sum(dim=-1)
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        lengths = torch.div(lengths - k, s, rounding_mode="floor") + 1
    frames = torch.arange(frame_len, device=attention_mask.device)
    return (frames[None, :] < lengths[:, None]).to(torch.int32)


class SpeechPrenet(nn.Module):
    def __init__(self, cfg: SpeechT5Config, generator: Optional[torch.Generator]):
        super().__init__()
        self.cfg = cfg
        self.feature_encoder = FeatureEncoder(cfg, generator)
        self.feature_projection = FeatureProjection(cfg, generator)
        self.pos_conv_embed = PosConvEmbed(cfg, generator)
        if cfg.mask_time_prob > 0.0 or cfg.mask_feature_prob > 0.0:
            # SpecAugment's mask vector: loaded, unused until training lands
            self.masked_spec_embed = nn.Parameter(
                torch.rand(cfg.hidden_size, generator=generator))
        # sinusoidal rows do not depend on the table's length, so one table
        # of the configured size serves every shorter sequence
        self.register_buffer("sinusoidal_table",
                             torch.from_numpy(sinusoidal_speech_table(cfg)),
                             persistent=False)

    def forward(self, wav: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                *, use_kernels: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        return speech_prenet(self, wav, attention_mask, use_kernels=use_kernels)


def speech_prenet(prenet: SpeechPrenet, wav: torch.Tensor,
                  attention_mask: Optional[torch.Tensor] = None, *,
                  use_kernels: bool = True
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """[B, T] waveform -> ([B, frames, H] hidden, [B, frames] frame mask)."""
    cfg = prenet.cfg
    feats = prenet.feature_encoder(wav, use_kernels=use_kernels)
    if attention_mask is not None:
        attention_mask = reduce_attention_mask(cfg, feats.shape[1], attention_mask)

    fp = prenet.feature_projection
    hidden = layers.layer_norm(feats, fp.layer_norm.weight, fp.layer_norm.bias,
                               eps=cfg.layer_norm_eps)
    hidden = fp.projection(hidden)

    conv = prenet.pos_conv_embed.conv
    w = layers.weight_norm_conv1d_weight(conv.weight_g, conv.weight_v)
    pos = layers.conv1d_nhc(hidden, w, padding=cfg.num_conv_pos_embeddings // 2,
                            groups=cfg.num_conv_pos_embedding_groups, bias=conv.bias)
    if cfg.num_conv_pos_embeddings % 2 == 0:
        pos = pos[:, :-1]
    hidden = hidden + layers.gelu(pos)

    table = prenet.sinusoidal_table
    if hidden.shape[1] > cfg.max_speech_positions:
        table = torch.from_numpy(sinusoidal_speech_table(cfg, hidden.shape[1]))
    table = table.to(hidden.device, hidden.dtype)
    valid = (attention_mask if attention_mask is not None
             else torch.ones(hidden.shape[:2], dtype=torch.int32, device=hidden.device))
    pos_ids = layers.positions_from_padding(valid, cfg.pad_token_id)
    return hidden + table[pos_ids], attention_mask
