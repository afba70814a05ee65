"""SpeechT5 transformer decoder (causal self-attention + cross-attention
layers, post-LN, no top-level LayerNorm, no relative position bias), as in
``loco_asr_tpu.models.speecht5.decoder``.

Full-sequence mode (teacher forcing) runs dense or flash attention; flash
sends the causal self-attention through kernel B5 and the cross-attention
through kernel B1's mask-only form.  Incremental mode (decoding) runs
dense attention over a fixed-shape KV cache that :func:`decoder` writes in
place (the JAX package returns a new cache instead), with cross-attention
K/V precomputed once per utterance by :func:`init_cross_cache`.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch import nn

from ...ops import attention, layers
from .config import SpeechT5Config
from .encoder import FeedForward

Cache = Dict[str, Dict[str, torch.Tensor]]


class DecoderLayer(nn.Module):
    def __init__(self, cfg: SpeechT5Config, generator: Optional[torch.Generator]):
        super().__init__()
        if cfg.hidden_act != "gelu":
            raise ValueError(f"hidden_act {cfg.hidden_act!r}: only 'gelu' is ported")
        d = cfg.hidden_size
        self.self_attn = attention.MultiHeadAttention(d, cfg.decoder_attention_heads)
        self.self_attn_layer_norm = layers.Norm(d)
        self.encoder_attn = attention.MultiHeadAttention(d, cfg.decoder_attention_heads)
        self.encoder_attn_layer_norm = layers.Norm(d)
        self.feed_forward = FeedForward(cfg, cfg.decoder_ffn_dim)
        self.final_layer_norm = layers.Norm(d)
        for mha in (self.self_attn, self.encoder_attn):
            for lin in (mha.q_proj, mha.k_proj, mha.v_proj, mha.out_proj):
                layers.init_dense(lin, generator)
        layers.init_dense(self.feed_forward.intermediate_dense, generator)
        layers.init_dense(self.feed_forward.output_dense, generator)


class Decoder(nn.Module):
    """The ``wrapped_decoder`` subtree: ``layers.{i}``."""

    def __init__(self, cfg: SpeechT5Config, generator: Optional[torch.Generator]):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(DecoderLayer(cfg, generator)
                                    for _ in range(cfg.decoder_layers))


def init_decode_cache(cfg: SpeechT5Config, batch: int, max_len: int,
                      device=None, dtype=torch.float32) -> Cache:
    """Zeroed self-attention KV cache, {layer: {"k", "v"}} of
    [B, heads, max_len, head_dim]."""
    heads = cfg.decoder_attention_heads
    shape = (batch, heads, max_len, cfg.hidden_size // heads)
    return {str(i): {"k": torch.zeros(shape, dtype=dtype, device=device),
                     "v": torch.zeros(shape, dtype=dtype, device=device)}
            for i in range(cfg.decoder_layers)}


def init_cross_cache(module: Decoder, encoder_hidden: torch.Tensor) -> Cache:
    """Every layer's cross-attention K/V ([B, heads, Tenc, head_dim]) from
    the encoder output, computed once per utterance rather than per step."""
    heads = module.cfg.decoder_attention_heads
    return {str(i): {"k": attention.split_heads(lyr.encoder_attn.k_proj(encoder_hidden), heads),
                     "v": attention.split_heads(lyr.encoder_attn.v_proj(encoder_hidden), heads)}
            for i, lyr in enumerate(module.layers)}


def _layer(cfg: SpeechT5Config, lyr: DecoderLayer, hidden, encoder_hidden, *,
           self_bias, cross_bias, enc_valid_len, kv_cache, cache_index,
           cross_kv, attn_impl, generator, training):
    drop = lambda x, p: layers.dropout(x, p, generator, training)
    common = dict(dropout_p=cfg.attention_dropout, generator=generator,
                  training=training, attn_impl=attn_impl)
    attn_out = attention.multi_head_attention(
        lyr.self_attn, hidden, attention_bias=self_bias, kv_cache=kv_cache,
        cache_index=cache_index, causal=True, **common)
    hidden = layers.layer_norm(hidden + drop(attn_out, cfg.hidden_dropout),
                               lyr.self_attn_layer_norm.weight,
                               lyr.self_attn_layer_norm.bias, eps=cfg.layer_norm_eps)
    cross_out = attention.multi_head_attention(
        lyr.encoder_attn, hidden, key_value_states=encoder_hidden,
        attention_bias=cross_bias, static_kv=cross_kv, kv_valid_len=enc_valid_len,
        **common)
    hidden = layers.layer_norm(hidden + drop(cross_out, cfg.hidden_dropout),
                               lyr.encoder_attn_layer_norm.weight,
                               lyr.encoder_attn_layer_norm.bias, eps=cfg.layer_norm_eps)
    ff = lyr.feed_forward
    x = drop(layers.gelu(ff.intermediate_dense(hidden)), cfg.activation_dropout)
    x = drop(ff.output_dense(x), cfg.hidden_dropout)
    return layers.layer_norm(hidden + x, lyr.final_layer_norm.weight,
                             lyr.final_layer_norm.bias, eps=cfg.layer_norm_eps)


def _cache_bias(cache_index: Union[int, torch.Tensor], t: int, k_len: int,
                device) -> torch.Tensor:
    """Additive bias over the cache: key slot <= the query's position."""
    pos = torch.arange(k_len, device=device)
    if isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1:
        qi = cache_index.to(device)[:, None, None] + torch.arange(t, device=device)[None, :, None]
        keep = pos[None, None, :] <= qi                              # [B, t, K]
        return torch.where(keep, 0.0, attention.NEG_INF)[:, None].float()
    qi = int(cache_index) + torch.arange(t, device=device)[:, None]
    return torch.where(pos[None, :] <= qi, 0.0, attention.NEG_INF).float()[None, None]


def decoder(module: Decoder, hidden_states: torch.Tensor,
            encoder_hidden_states: torch.Tensor, *,
            attention_mask: Optional[torch.Tensor] = None,
            encoder_attention_mask: Optional[torch.Tensor] = None,
            kv_caches: Optional[Cache] = None,
            cache_index: Optional[Union[int, torch.Tensor]] = None,
            cross_caches: Optional[Cache] = None,
            generator: Optional[torch.Generator] = None,
            attn_impl: str = "dense") -> torch.Tensor:
    """Run the decoder stack over [B, T, H] -> [B, T, H].

    Full-sequence mode (``kv_caches`` None): causal attention over the
    sequence.  Incremental mode: ``hidden_states`` is the current step(s),
    ``kv_caches`` the per-layer cache (written in place at
    ``cache_index``, an int or [B] per-row offsets).  Dropout draws from
    ``generator`` when the module is in training mode.

    ``attn_impl="flash"`` (full-sequence mode only) routes both attentions
    through the kernels.  As in the JAX package it refuses attention-prob
    dropout (the kernels have none; ``make_asr_train_step`` zeroes it), and
    a caller-supplied ``attention_mask`` must describe right padding only:
    the kernel builds no self-attention bias, and right-padded rows are
    inert under causality (their outputs fall to the loss mask), so any
    other mask would be silently dropped -- such a mask raises.
    """
    cfg = module.cfg
    training = module.training
    b, t, _ = hidden_states.shape
    use_flash = attn_impl == "flash" and kv_caches is None
    if use_flash and training and cfg.attention_dropout > 0.0:
        raise ValueError(
            f"decoder attn_impl='flash' drops attention-prob dropout "
            f"(attention_dropout={cfg.attention_dropout}); train with "
            f"attention_dropout=0.0 or attn_impl='dense'")
    if use_flash and attention_mask is not None:
        m = attention_mask.to(torch.int64)
        if bool((m[:, 1:] > m[:, :-1]).any()):
            raise ValueError("decoder attn_impl='flash' needs a right-padded "
                             "attention_mask; use attn_impl='dense' for other masks")

    enc_valid_len = self_bias = cross_bias = None
    dev = hidden_states.device
    if kv_caches is None:
        if not use_flash:
            self_bias = attention.causal_attention_bias(t, t, dev)
            if attention_mask is not None:
                self_bias = self_bias + attention.padding_attention_bias(attention_mask)
    else:
        self_bias = _cache_bias(cache_index, t, kv_caches["0"]["k"].shape[2], dev)
    if encoder_attention_mask is not None:
        if use_flash:
            enc_valid_len = encoder_attention_mask.to(torch.int32).sum(-1, dtype=torch.int32)
        else:
            cross_bias = attention.padding_attention_bias(encoder_attention_mask)

    hidden = hidden_states
    for i, lyr in enumerate(module.layers):
        hidden = _layer(
            cfg, lyr, hidden, encoder_hidden_states, self_bias=self_bias,
            cross_bias=cross_bias, enc_valid_len=enc_valid_len,
            kv_cache=kv_caches[str(i)] if kv_caches is not None else None,
            cache_index=cache_index,
            cross_kv=cross_caches[str(i)] if cross_caches is not None else None,
            attn_impl="flash" if use_flash else "dense", generator=generator,
            training=training)
    return hidden
