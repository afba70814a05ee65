"""Multi-head attention with the SpeechT5 relative-position bias, key
padding, causal masking, cross-attention and a decode KV cache, as in
``loco_asr_tpu.ops.attention.multi_head_attention``.

q is pre-scaled by ``head_dim**-0.5`` before both the content term q.k^T
and the relative term q.pe^T (HF SpeechT5Attention).  Two paths compute
the same function:

* ``"dense"`` materialises the [B, H, Tq, Tk] scores, adds the band of
  ``q.pe^T`` and the additive ``attention_bias`` (or sets keys past
  ``kv_valid_len`` to -1e9), takes a softmax and applies attention-prob
  dropout when training;
* ``"flash"`` runs the kernels with ``scale=1`` on the pre-scaled q:
  B1 (``ops/cuda/flash_attention.py``) for the encoder (rel_pe +
  kv_valid_len) and the decoder's cross-attention (mask-only,
  kv_valid_len), B5 (``ops/cuda/flash_causal.py``) for the decoder's
  causal self-attention.  The kernels have no attention-prob dropout, so
  flash is taken only when that dropout is off, and never with a KV cache
  or precomputed cross K/V (decoding), as in the JAX package.

Under the "lite" remat policy the dense path's score chain runs under a
checkpoint of its own (``ops/remat.py``; JAX tags it ``big``).
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch import nn

from . import layers, remat
from .cuda import flash_attention as flash

NEG_INF = -1e9  # additive mask of the dense path

ATTN_IMPLS = ("dense", "flash")


class MultiHeadAttention(layers.ShardableBlock):
    """q/k/v/out projections of one attention block (``nn.Linear`` weights,
    ``[out, in]``); ``tp`` ranks split its heads."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = layers.Dense(embed_dim, embed_dim)
        self.k_proj = layers.Dense(embed_dim, embed_dim)
        self.v_proj = layers.Dense(embed_dim, embed_dim)
        self.out_proj = layers.Dense(embed_dim, embed_dim)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def padding_attention_bias(valid_mask: torch.Tensor) -> torch.Tensor:
    """[B, Tk] 1/0 validity -> additive [B, 1, 1, Tk] float32 bias."""
    keep = valid_mask[:, None, None, :].to(torch.bool)
    zero = torch.zeros((), dtype=torch.float32, device=valid_mask.device)
    return torch.where(keep, zero, torch.full_like(zero, NEG_INF))


def causal_attention_bias(q_len: int, k_len: int, device=None,
                          offset: int = 0) -> torch.Tensor:
    """Additive [1, 1, Tq, Tk] causal mask; ``offset`` shifts the query
    positions forward (incremental decoding with a KV cache)."""
    qi = torch.arange(q_len, device=device)[:, None] + offset
    kj = torch.arange(k_len, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(kj <= qi, zero, torch.full_like(zero, NEG_INF))[None, None]


def _write_cache(kv_cache: Dict[str, torch.Tensor], k: torch.Tensor,
                 v: torch.Tensor, cache_index: Union[int, torch.Tensor],
                 write_mask: Optional[torch.Tensor] = None) -> None:
    """Write the T new k/v positions ([B, H, T, hd]) into the [B, H, Tmax, hd]
    cache, in place: from ``cache_index`` on for every row (int or 0-d
    tensor), or from row b's own ``cache_index[b]`` (1-D tensor).
    ``write_mask`` [B] bool (a [B] index and T == 1 only): rows where it is
    False keep what their cache held at that position.

    A write that would run past the cache's end raises ValueError (the JAX
    ``dynamic_update_slice`` clamps its start instead).  The check reads the
    index on the host; a one-token write at a [B] index that lives on the
    GPU (the decode loops' per-row steps) is not read back, so that a step
    costs no host sync, and an index past the end fails in the indexing
    kernel instead."""
    t, t_max = k.shape[2], kv_cache["k"].shape[2]
    per_row = isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1
    if write_mask is not None and not (per_row and t == 1):
        raise ValueError("write_mask needs a [B] cache_index and one new position")
    if per_row:
        idx = cache_index.to(k.device, torch.int64)
        if t > 1 or not idx.is_cuda:
            lo, hi = int(idx.min()), int(idx.max())
            if lo < 0 or hi + t > t_max:
                raise ValueError(f"cache write at offsets {lo}..{hi} of {t} "
                                 f"positions runs past the cache's {t_max}")
        rows = torch.arange(k.shape[0], device=k.device)
        if t == 1:
            for name, new in (("k", k[:, :, 0]), ("v", v[:, :, 0])):
                if write_mask is not None:
                    new = torch.where(write_mask[:, None, None], new,
                                      kv_cache[name][rows, :, idx])
                kv_cache[name][rows, :, idx] = new
            return
        cols = idx[:, None] + torch.arange(t, device=k.device)[None, :]   # [B, T]
        # advanced indices around a slice put their dims first: [B, T, H, hd]
        kv_cache["k"][rows[:, None], :, cols] = k.transpose(1, 2)
        kv_cache["v"][rows[:, None], :, cols] = v.transpose(1, 2)
        return
    i = int(cache_index)
    if i < 0 or i + t > t_max:
        raise ValueError(f"cache write at offset {i} of {t} positions runs "
                         f"past the cache's {t_max}")
    kv_cache["k"][:, :, i:i + t] = k
    kv_cache["v"][:, :, i:i + t] = v


def multi_head_attention(
    module: MultiHeadAttention,
    hidden: torch.Tensor,
    *,
    key_value_states: Optional[torch.Tensor] = None,
    attention_bias: Optional[torch.Tensor] = None,
    rel_pe: Optional[torch.Tensor] = None,
    kv_valid_len: Optional[torch.Tensor] = None,
    kv_cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_index: Optional[Union[int, torch.Tensor]] = None,
    static_kv: Optional[Dict[str, torch.Tensor]] = None,
    dropout_p: float = 0.0,
    generator: Optional[torch.Generator] = None,
    training: bool = False,
    attn_impl: str = "flash",
    causal: bool = False,
) -> torch.Tensor:
    """Scaled dot-product MHA over [B, Tq, D] queries -> [B, Tq, D].

    Args:
      key_value_states: [B, Tk, D] for cross-attention (None: self-attention).
      attention_bias: additive mask broadcastable to [B, H, Tq, Tk] (dense).
      rel_pe: [2L, head_dim] relative-position key table; the rel term is
        ``q . pe[clip(i - j, -L, L-1) + L]``.
      kv_valid_len: [B] valid key count (right-padded batches); keys at or
        past it are masked.  The dense path uses ``attention_bias`` instead
        when both are given.
      kv_cache: {"k", "v"} [B, H, Tmax, hd] self-attention cache, written in
        place at ``cache_index`` (int, or [B] per-row offsets) before the
        attention reads it -- the port updates the cache in place where
        the JAX package returns a new one.
      static_kv: precomputed cross-attention {"k", "v"} [B, H, Tk, hd].
      dropout_p / generator / training: attention-prob dropout (dense only).
      attn_impl: "dense" or "flash".
      causal: marks the attention causal for the flash path (kernel B5); the
        dense path takes causality from ``attention_bias``.
    """
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r}: expected one of {ATTN_IMPLS}")
    tp = module.tp
    h = module.num_heads // tp
    head_dim = hidden.shape[-1] // module.num_heads
    if tp > 1:
        # this rank's heads: the block's inputs are shared by the tensor
        # ranks, whose gradients each hold their heads' part
        if kv_cache is not None or static_kv is not None:
            raise ValueError("tensor-parallel attention runs whole sequences "
                             "(decode on gathered weights)")
        hidden = module.enter(hidden)
        if key_value_states is not None:
            key_value_states = module.enter(key_value_states)
        if rel_pe is not None:
            rel_pe = module.enter(rel_pe)
    q = split_heads(module.q_proj(hidden) * head_dim ** -0.5, h)  # [B,H,Tq,hd]
    if static_kv is not None:
        k, v = static_kv["k"], static_kv["v"]
    else:
        src = hidden if key_value_states is None else key_value_states
        k = split_heads(module.k_proj(src), h)
        v = split_heads(module.v_proj(src), h)
    if kv_cache is not None:
        if cache_index is None:
            raise ValueError("cache_index required with kv_cache")
        _write_cache(kv_cache, k, v, cache_index)
        k, v = kv_cache["k"], kv_cache["v"]

    use_flash = (attn_impl == "flash" and kv_cache is None and static_kv is None
                 and (not training or dropout_p == 0.0))
    if use_flash:
        # q is pre-scaled, so the kernels run with scale=1
        out = flash.flash_attention(q, k, v, causal=causal, scale=1.0,
                                    rel_pe=rel_pe, kv_valid_len=kv_valid_len)
        return module.out_proj(merge_heads(out))

    out = remat.big(_dense_attention, q, k, v, rel_pe, attention_bias, kv_valid_len,
                    dropout_p, training, 1 if tp > 1 else None, generator=generator)
    return module.out_proj(merge_heads(out))


def _dense_attention(q, k, v, rel_pe, attention_bias, kv_valid_len, dropout_p, training,
                     tensor_dim=None, *, generator):
    """The [B, H, Tq, Tk] chain of the dense path: scores, band, mask,
    softmax, attention-prob dropout (``tensor_dim``: 1 when the heads
    are split over the tensor axis), probs.v."""
    # scores in float32 from operands of their own dtype (JAX's
    # preferred_element_type=float32; bf16 products are exact in float32)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if rel_pe is not None:
        qpe = torch.matmul(q.float(), rel_pe.to(q.dtype).float().t())   # [B,H,Tq,2L]
        scores = scores + flash.relative_position_scores(qpe, k.shape[2])
    if attention_bias is not None:
        scores = scores + attention_bias.to(scores.dtype)
    elif kv_valid_len is not None:
        keep = (torch.arange(k.shape[2], device=k.device)[None, :]
                < kv_valid_len.to(k.device)[:, None])
        scores = scores.masked_fill(~keep[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    probs = layers.dropout(probs, dropout_p, generator, training,
                           **layers.split_dim(tensor_dim))
    return torch.matmul(probs, v)
