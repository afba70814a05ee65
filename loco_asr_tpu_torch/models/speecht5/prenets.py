"""SpeechT5 pre- and post-nets, as in
``loco_asr_tpu.models.speecht5.prenets``: the speech encoder prenet (conv
feature encoder, feature projection, SpecAugment when training,
weight-normed grouped positional conv, sinusoidal positions), the text
decoder prenet (token embedding + sinusoidal positions from the non-pad
mask) and the text decoder postnet (the vocabulary head) of the ASR model;
the text encoder prenet, the speech decoder prenet (whole sequence and one
step) and the speech decoder postnet of the TTS and voice-conversion
models.

Layer 0 of the feature encoder (conv k=10/s=5 + instance norm + GELU) runs
through kernel B2 (``ops/cuda/conv_frontend.py``) when no gradient is
wanted (inference, or a frozen feature encoder), and through the
differentiable gram form :func:`conv1_instance_norm_gelu_gram` when its
parameters train -- the route the JAX package's training takes too (its
Pallas kernel has no VJP).  Either way it emits channel-major [B, C, F],
so layers 1-6 run as ``F.conv1d`` directly.  Parameter names follow the
JAX tree (``feature_encoder.conv_layers.{i}.conv.weight`` ...) so the
weight bridge is a mechanical rename.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ...ops import layers
from ...ops.audio import compute_mask_indices
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


def conv1_instance_norm_gelu_gram(wav: torch.Tensor, weight: torch.Tensor,
                                  scale: torch.Tensor, bias: torch.Tensor, *,
                                  stride: int = 5, eps: float = conv_frontend.EPS
                                  ) -> torch.Tensor:
    """Differentiable first feature-encoder layer, the port's counterpart of
    the JAX ``conv1_instance_norm_gelu_gram``: the same function as kernel
    B2, with the per-channel statistics taken from the [K, K] gram matrix of
    the K = 2*stride taps (``mean_c = E[taps].W_c``,
    ``E[y^2]_c = W_c^T E[taps taps^T] W_c``), so autograd runs through small
    products.  [B, T] -> [B, C, F]."""
    b, t = wav.shape
    k = conv_frontend._check_geometry(weight, stride)
    f = (t - k) // stride + 1
    r = wav[:, :stride * (f + 1)].reshape(b, f + 1, stride)
    taps = torch.cat([r[:, :f], r[:, 1:f + 1]], dim=-1)           # [B, F, K]
    w = weight[:, 0, :].t().to(wav.dtype)                         # [K, C]
    # the dtypes of the JAX form's: the tap means and their product in the
    # caller's dtype, the gram, E[y^2], the affine and y in float32, the
    # activation emitted in the caller's dtype
    tf, wf = taps.float(), w.float()
    mean = taps.mean(dim=1) @ w                                   # [B, C]
    gram = torch.matmul(tf.transpose(1, 2), tf) / f               # [B, K, K]
    ysq = torch.einsum("ic,bij,jc->bc", wf, gram, wf)             # E[y^2]
    gain = torch.rsqrt(ysq - mean * mean + eps) * scale[None, :]
    off = bias[None, :] - mean * gain
    y = torch.matmul(tf, wf).transpose(1, 2)                      # [B, C, F]
    return layers.gelu((y * gain[:, :, None] + off[:, :, None]).to(wav.dtype))


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
        if torch.is_grad_enabled() and any(p.requires_grad for p in c0.parameters()):
            first = conv1_instance_norm_gelu_gram
        elif use_kernels:
            first = conv_frontend.conv1_instance_norm_gelu
        else:
            first = conv_frontend.conv1_instance_norm_gelu_plain
        # layer 0 in the promotion of the waveform's and weights' dtypes
        # (JAX's: a float32 waveform with bfloat16 weights computes in
        # float32); the kernel and the plain version take one dtype
        dt = torch.promote_types(wav.dtype, c0.conv.weight.dtype)
        x = first(wav.to(dt), c0.conv.weight.to(dt), c0.layer_norm.weight.to(dt),
                  c0.layer_norm.bias.to(dt), stride=cfg.conv_stride[0])   # [B, C, F]
        for i in range(1, len(cfg.conv_dim)):
            p = self.conv_layers[i]
            x = layers.gelu(layers.conv1d(x, p.conv.weight, p.conv.bias,
                                          stride=cfg.conv_stride[i]))
        return x.transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: SpeechT5Config, generator: Optional[torch.Generator]):
        super().__init__()
        self.layer_norm = layers.Norm(cfg.conv_dim[-1])
        self.projection = layers.Dense(cfg.conv_dim[-1], cfg.hidden_size)
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
            # SpecAugment's mask vector
            self.masked_spec_embed = nn.Parameter(
                torch.rand(cfg.hidden_size, generator=generator))
        # sinusoidal rows do not depend on the table's length, so one table
        # of the configured size serves every shorter sequence
        self.register_buffer("sinusoidal_table",
                             torch.from_numpy(sinusoidal_speech_table(cfg)),
                             persistent=False)

    def forward(self, wav: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                *, use_kernels: bool = True,
                generator: Optional[torch.Generator] = None,
                freeze_feature_encoder: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        return speech_prenet(self, wav, attention_mask, use_kernels=use_kernels,
                             generator=generator,
                             freeze_feature_encoder=freeze_feature_encoder)


def speech_prenet(prenet: SpeechPrenet, wav: torch.Tensor,
                  attention_mask: Optional[torch.Tensor] = None, *,
                  use_kernels: bool = True,
                  generator: Optional[torch.Generator] = None,
                  freeze_feature_encoder: bool = False
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """[B, T] waveform -> ([B, frames, H] hidden, [B, frames] frame mask).

    In training mode with a ``generator``, SpecAugment masks time spans
    with ``masked_spec_embed`` (and feature spans with 0) after the
    projection.  ``freeze_feature_encoder`` runs the conv stack under
    ``torch.no_grad()`` (the JAX ``stop_gradient``): its parameters get no
    gradient and layer 0 runs kernel B2."""
    cfg = prenet.cfg
    with torch.no_grad() if freeze_feature_encoder else contextlib.nullcontext():
        feats = prenet.feature_encoder(wav, use_kernels=use_kernels)
    if attention_mask is not None:
        attention_mask = reduce_attention_mask(cfg, feats.shape[1], attention_mask)

    fp = prenet.feature_projection
    hidden = layers.layer_norm(feats, fp.layer_norm.weight, fp.layer_norm.bias,
                               eps=cfg.layer_norm_eps)
    hidden = fp.projection(hidden)

    if prenet.training and cfg.apply_spec_augment and generator is not None:
        b, t, h = hidden.shape
        if cfg.mask_time_prob > 0:
            lengths = None if attention_mask is None else attention_mask.sum(-1)
            m = compute_mask_indices(generator, (b, t), cfg.mask_time_prob,
                                     cfg.mask_time_length, lengths,
                                     cfg.mask_time_min_masks, device=hidden.device)
            hidden = torch.where(m[..., None], prenet.masked_spec_embed.to(hidden.dtype),
                                 hidden)
        if cfg.mask_feature_prob > 0:
            m = compute_mask_indices(generator, (b, h), cfg.mask_feature_prob,
                                     cfg.mask_feature_length, None,
                                     cfg.mask_feature_min_masks, device=hidden.device)
            hidden = hidden.masked_fill(m[:, None, :], 0.0)

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


def sinusoidal_text_table(cfg: SpeechT5Config, min_positions: int = 0) -> np.ndarray:
    num = max(cfg.max_text_positions, min_positions) + cfg.pad_token_id + 1 + 2
    return layers.sinusoidal_table(num, cfg.hidden_size, padding_idx=cfg.pad_token_id)


class TextDecoderPrenet(nn.Module):
    """Token embedding (N(0, 1), pad row zeroed at init) + sinusoidal
    positions."""

    def __init__(self, cfg: SpeechT5Config, generator: Optional[torch.Generator]):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = layers.embedding_init(cfg.vocab_size, cfg.hidden_size,
                                                  generator, cfg.pad_token_id)
        self.register_buffer("sinusoidal_table",
                             torch.from_numpy(sinusoidal_text_table(cfg)),
                             persistent=False)


def text_decoder_prenet(prenet: TextDecoderPrenet, input_ids: torch.Tensor, *,
                        past_length: Union[int, torch.Tensor] = 0) -> torch.Tensor:
    """[B, L] token ids -> [B, L, H]: embedding (times sqrt(H) with
    ``scale_embedding``) plus the sinusoidal row of each position, where
    positions count the non-pad tokens from ``past_length`` (int, or [B]
    per-row offsets in decoding), HF's TextDecoderPrenet."""
    cfg = prenet.cfg
    table = prenet.sinusoidal_table
    if input_ids.shape[1] > cfg.max_text_positions:
        table = torch.from_numpy(sinusoidal_text_table(cfg, input_ids.shape[1]))
    table = table.to(input_ids.device)
    if isinstance(past_length, torch.Tensor) and past_length.dim() == 1:
        past_length = past_length[:, None]
    valid = input_ids != cfg.pad_token_id
    pos_ids = layers.positions_from_padding(valid, cfg.pad_token_id, past_length)
    pos_ids = torch.clamp(pos_ids, max=table.shape[0] - 1)
    scale = math.sqrt(cfg.hidden_size) if cfg.scale_embedding else 1.0
    emb = prenet.embed_tokens(input_ids) * scale
    return emb + table[pos_ids].to(emb.dtype)


class TextDecoderPostnet(nn.Module):
    """Vocabulary head: bias-free ``lm_head`` (JAX ``dense_init``)."""

    def __init__(self, cfg: SpeechT5Config, generator: Optional[torch.Generator]):
        super().__init__()
        self.lm_head = layers.Dense(cfg.hidden_size, cfg.vocab_size, bias=False)
        with torch.no_grad():
            self.lm_head.weight.copy_(layers.uniform_param(
                self.lm_head.weight.shape, cfg.hidden_size, generator))


# -- TTS side: text encoder prenet, speech decoder pre- and postnet -------

class ScaledPositions(nn.Module):
    """``alpha``, the learned scale of the interleaved sinusoidal table
    (HF SpeechT5ScaledPositionalEncoding)."""

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(()))


def _interleaved_table(rows: int, dim: int) -> torch.Tensor:
    return torch.from_numpy(layers.interleaved_sinusoidal_table(rows, dim))


class TextEncoderPrenet(nn.Module):
    """Token embedding (N(0, 1), pad row zeroed at init) + ``alpha`` times
    the interleaved table of ``max_text_positions`` rows."""

    def __init__(self, cfg: SpeechT5Config, generator: Optional[torch.Generator]):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = layers.embedding_init(cfg.vocab_size, cfg.hidden_size,
                                                  generator, cfg.pad_token_id)
        self.encode_positions = ScaledPositions()
        self.register_buffer("pe", _interleaved_table(cfg.max_text_positions,
                                                      cfg.hidden_size),
                             persistent=False)


def _rows(pe: torch.Tensor, n: int, what: str) -> torch.Tensor:
    if n > pe.shape[0]:
        raise ValueError(f"{n} {what} positions exceed the table's {pe.shape[0]}")
    return pe[:n]


def text_encoder_prenet(prenet: TextEncoderPrenet, input_ids: torch.Tensor) -> torch.Tensor:
    """[B, L] token ids -> [B, L, H]: embedding + ``alpha`` * table rows
    0..L-1 (positions count every token, pads included, as in the JAX
    package)."""
    emb = prenet.embed_tokens(input_ids)
    pe = _rows(prenet.pe, input_ids.shape[1], "text")
    return emb + prenet.encode_positions.alpha * pe.to(emb.dtype)


class SpeechDecoderPrenet(nn.Module):
    """Bottleneck ReLU stack (``layers``), ``final_layer`` to the model
    width, ``alpha`` * interleaved positions, and the speaker projection
    ``speaker_embeds_layer`` over [hidden | normalised speaker]."""

    def __init__(self, cfg: SpeechT5Config, generator: Optional[torch.Generator]):
        super().__init__()
        self.cfg = cfg
        units = cfg.speech_decoder_prenet_units
        self.layers = nn.ModuleList(
            layers.Dense(cfg.num_mel_bins if i == 0 else units, units)
            for i in range(cfg.speech_decoder_prenet_layers))
        self.final_layer = layers.Dense(units, cfg.hidden_size)
        self.encode_positions = ScaledPositions()
        self.speaker_embeds_layer = layers.Dense(
            cfg.speaker_embedding_dim + cfg.hidden_size, cfg.hidden_size)
        for lin in (*self.layers, self.final_layer, self.speaker_embeds_layer):
            layers.init_dense(lin, generator)
        self.register_buffer("pe", _interleaved_table(cfg.max_speech_positions,
                                                      cfg.hidden_size),
                             persistent=False)


def _bottleneck(prenet: SpeechDecoderPrenet, x: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """ReLU stack + final layer.  With a ``generator`` (on ``x``'s device)
    each layer's output goes through HF's ``_consistent_dropout``: a mask
    drawn ``bernoulli(p)`` over ``x.shape[1:]`` is the KEEP mask, shared by
    the batch, and kept entries are scaled by 1 / (1 - p), in eval mode
    too.  Without one no dropout applies (the JAX ``rng=None``)."""
    p = prenet.cfg.speech_decoder_prenet_dropout
    for lin in prenet.layers:
        x = torch.relu(lin(x))
        if generator is not None and p > 0:
            keep = torch.rand(x.shape[1:], generator=generator, device=x.device) < p
            x = torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device)) / (1.0 - p)
    return prenet.final_layer(x)


def _add_speaker(prenet: SpeechDecoderPrenet, x: torch.Tensor,
                 speaker_embeddings: Optional[torch.Tensor]) -> torch.Tensor:
    if speaker_embeddings is None:
        return x
    se = speaker_embeddings / torch.linalg.norm(speaker_embeddings, dim=-1, keepdim=True)
    se = se.to(x.dtype)
    if x.dim() == 3:
        se = se[:, None, :].expand(x.shape[0], x.shape[1], se.shape[-1])
    return torch.relu(prenet.speaker_embeds_layer(torch.cat([x, se], dim=-1)))


def speech_decoder_prenet(prenet: SpeechDecoderPrenet, input_values: torch.Tensor,
                          speaker_embeddings: Optional[torch.Tensor] = None, *,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """[B, T, mel] decoder input frames (+ [B, spk] speaker embeddings) ->
    [B, T, H]."""
    x = _bottleneck(prenet, input_values, generator)
    pe = _rows(prenet.pe, x.shape[1], "speech")
    x = x + prenet.encode_positions.alpha * pe.to(x.dtype)
    return _add_speaker(prenet, x, speaker_embeddings)


def speech_decoder_prenet_step(prenet: SpeechDecoderPrenet, frame: torch.Tensor,
                               idx: int,
                               speaker_embeddings: Optional[torch.Tensor] = None, *,
                               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One position: [B, mel] frame at position ``idx`` -> [B, H].  The
    prenet is position-wise, so this equals :func:`speech_decoder_prenet`
    over a sequence sliced at ``idx``; a position past the table takes its
    last row (the JAX gather clamps)."""
    x = _bottleneck(prenet, frame, generator)
    pe = prenet.pe[min(idx, prenet.pe.shape[0] - 1)]
    x = x + prenet.encode_positions.alpha * pe.to(x.dtype)
    return _add_speaker(prenet, x, speaker_embeddings)


BN_EPS = 1e-5


class BatchNorm(layers.Norm):
    """Batch norm in inference form: the affine (``weight``, the JAX
    ``scale``, and ``bias``) and the running ``mean`` / ``var`` buffers."""

    def __init__(self, dim: int):
        super().__init__(dim)
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))


class PostnetLayer(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.conv = Conv(in_ch, out_ch, kernel, bias=False, generator=generator)
        self.batch_norm = BatchNorm(out_ch)


class SpeechDecoderPostnet(nn.Module):
    """``feat_out`` (H -> mel * r), ``prob_out`` (H -> r) and the residual
    conv postnet ``layers``."""

    def __init__(self, cfg: SpeechT5Config, generator: Optional[torch.Generator]):
        super().__init__()
        self.cfg = cfg
        self.feat_out = layers.Dense(cfg.hidden_size, cfg.num_mel_bins * cfg.reduction_factor)
        self.prob_out = layers.Dense(cfg.hidden_size, cfg.reduction_factor)
        layers.init_dense(self.feat_out, generator)
        layers.init_dense(self.prob_out, generator)
        n, units = cfg.speech_decoder_postnet_layers, cfg.speech_decoder_postnet_units
        self.layers = nn.ModuleList(
            PostnetLayer(cfg.num_mel_bins if i == 0 else units,
                         cfg.num_mel_bins if i == n - 1 else units,
                         cfg.speech_decoder_postnet_kernel, generator)
            for i in range(n))


def speech_decoder_postnet_conv(postnet: SpeechDecoderPostnet,
                                mel: torch.Tensor) -> torch.Tensor:
    """Residual conv postnet: [B, T, mel] -> refined [B, T, mel] (conv,
    inference batch norm, tanh on all but the last layer)."""
    pad = (postnet.cfg.speech_decoder_postnet_kernel - 1) // 2
    x = mel.transpose(1, 2)
    for i, lyr in enumerate(postnet.layers):
        x = layers.conv1d(x, lyr.conv.weight, padding=pad)
        bn = lyr.batch_norm
        x = (x - bn.mean[None, :, None]) * torch.rsqrt(bn.var[None, :, None] + BN_EPS)
        x = x * bn.weight[None, :, None] + bn.bias[None, :, None]
        if i < len(postnet.layers) - 1:
            x = torch.tanh(x)
    return mel + x.transpose(1, 2)


def speech_decoder_postnet(postnet: SpeechDecoderPostnet, hidden: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[B, T, H] -> (mel_before [B, T*r, mel], mel_after, stop_logits
    [B, T*r])."""
    b = hidden.shape[0]
    before = postnet.feat_out(hidden).reshape(b, -1, postnet.cfg.num_mel_bins)
    logits = postnet.prob_out(hidden).reshape(b, -1)
    return before, speech_decoder_postnet_conv(postnet, before), logits
