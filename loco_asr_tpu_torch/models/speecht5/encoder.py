"""SpeechT5 transformer encoder: input LayerNorm, then post-LN layers
(attention -> residual -> LN -> FFN -> residual -> LN) that share one
relative-position key table, as in
``loco_asr_tpu.models.speecht5.encoder``.  A Python loop over the layers
takes the place of ``lax.scan``.  In training mode with a generator, the
dropouts of the JAX encoder apply: hidden dropout after the input LN and
after each residual branch, activation dropout inside the FFN, and
attention-prob dropout on the dense path."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...ops import attention, layers
from .config import SpeechT5Config


class FeedForward(nn.Module):
    def __init__(self, cfg: SpeechT5Config, ffn_dim: Optional[int] = None):
        super().__init__()
        ffn_dim = ffn_dim or cfg.encoder_ffn_dim
        self.intermediate_dense = nn.Linear(cfg.hidden_size, ffn_dim)
        self.output_dense = nn.Linear(ffn_dim, cfg.hidden_size)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: SpeechT5Config, generator: Optional[torch.Generator]):
        super().__init__()
        if cfg.hidden_act != "gelu":
            raise ValueError(f"hidden_act {cfg.hidden_act!r}: only 'gelu' is ported")
        self.attention = attention.MultiHeadAttention(cfg.hidden_size,
                                                      cfg.encoder_attention_heads)
        self.layer_norm = layers.Norm(cfg.hidden_size)
        self.feed_forward = FeedForward(cfg)
        self.final_layer_norm = layers.Norm(cfg.hidden_size)
        for lin in (self.attention.q_proj, self.attention.k_proj,
                    self.attention.v_proj, self.attention.out_proj,
                    self.feed_forward.intermediate_dense,
                    self.feed_forward.output_dense):
            layers.init_dense(lin, generator)


class RelativePositions(nn.Module):
    def __init__(self, cfg: SpeechT5Config, generator: Optional[torch.Generator]):
        super().__init__()
        self.pe_k = nn.Embedding(2 * cfg.encoder_max_relative_position, cfg.head_dim)
        with torch.no_grad():
            self.pe_k.weight.copy_(torch.randn(self.pe_k.weight.shape, generator=generator))


class Encoder(nn.Module):
    def __init__(self, cfg: SpeechT5Config, generator: Optional[torch.Generator]):
        super().__init__()
        self.cfg = cfg
        self.layer_norm = layers.Norm(cfg.hidden_size)
        self.embed_positions = RelativePositions(cfg, generator)
        self.layers = nn.ModuleList(EncoderLayer(cfg, generator)
                                    for _ in range(cfg.encoder_layers))

    def forward(self, hidden: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None, *,
                attn_impl: str = "flash",
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return encoder(self, hidden, attention_mask, attn_impl=attn_impl,
                       generator=generator)


def _layer_body(cfg: SpeechT5Config, layer: EncoderLayer, hidden: torch.Tensor, *,
                rel_pe, kv_valid_len, attn_impl, generator, training) -> torch.Tensor:
    drop = lambda x, p: layers.dropout(x, p, generator, training)
    attn_out = attention.multi_head_attention(
        layer.attention, hidden, rel_pe=rel_pe, kv_valid_len=kv_valid_len,
        dropout_p=cfg.attention_dropout, generator=generator, training=training,
        attn_impl=attn_impl)
    hidden = layers.layer_norm(hidden + drop(attn_out, cfg.hidden_dropout),
                               layer.layer_norm.weight, layer.layer_norm.bias,
                               eps=cfg.layer_norm_eps)
    ff = layer.feed_forward
    x = drop(layers.gelu(ff.intermediate_dense(hidden)), cfg.activation_dropout)
    x = drop(ff.output_dense(x), cfg.hidden_dropout)
    return layers.layer_norm(hidden + x, layer.final_layer_norm.weight,
                             layer.final_layer_norm.bias, eps=cfg.layer_norm_eps)


def encoder(module: Encoder, hidden: torch.Tensor,
            attention_mask: Optional[torch.Tensor] = None, *,
            attn_impl: str = "flash",
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """[B, T, H] prenet features -> [B, T, H] encodings.

    ``attention_mask`` is a right-padded [B, T] 1/0 mask at frame
    resolution.  ``attn_impl`` "flash" runs every layer through kernel B1;
    "dense" materialises the [T, T] scores.  Dropout draws from
    ``generator`` when the module is in training mode.
    """
    cfg = module.cfg
    training = module.training
    hidden = layers.layer_norm(hidden, module.layer_norm.weight,
                               module.layer_norm.bias, eps=cfg.layer_norm_eps)
    hidden = layers.dropout(hidden, cfg.hidden_dropout, generator, training)
    rel_pe = module.embed_positions.pe_k.weight
    if attention_mask is None:
        kv_valid_len = None
    else:
        kv_valid_len = attention_mask.to(torch.int32).sum(dim=-1, dtype=torch.int32)
    for layer in module.layers:
        hidden = _layer_body(cfg, layer, hidden, rel_pe=rel_pe,
                             kv_valid_len=kv_valid_len, attn_impl=attn_impl,
                             generator=generator, training=training)
    return hidden
