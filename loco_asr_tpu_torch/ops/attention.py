"""Multi-head self-attention with the SpeechT5 relative-position bias and
key padding, as in ``loco_asr_tpu.ops.attention.multi_head_attention``.

q is pre-scaled by ``head_dim**-0.5`` before both the content term q.k^T
and the relative term q.pe^T (HF SpeechT5Attention).  Two paths compute
the same function:

* ``"dense"`` materialises the [B, H, Tq, Tk] scores, adds the band of
  ``q.pe^T``, sets padded keys to -1e9 and takes a softmax;
* ``"flash"`` runs kernel B1 (``ops/cuda/flash_attention.py``) with
  ``scale=1`` on the pre-scaled q.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .cuda import flash_attention as flash

NEG_INF = -1e9  # padded-key score of the dense path

ATTN_IMPLS = ("dense", "flash")


class MultiHeadAttention(nn.Module):
    """q/k/v/out projections of one attention block (``nn.Linear`` weights,
    ``[out, in]``)."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def multi_head_attention(
    module: MultiHeadAttention,
    hidden: torch.Tensor,
    *,
    rel_pe: Optional[torch.Tensor] = None,
    kv_valid_len: Optional[torch.Tensor] = None,
    attn_impl: str = "flash",
) -> torch.Tensor:
    """Self-attention over [B, T, D] -> [B, T, D].

    Args:
      rel_pe: [2L, head_dim] relative-position key table; the rel term is
        ``q . pe[clip(i - j, -L, L-1) + L]``.
      kv_valid_len: [B] valid key count (right-padded batches); keys at or
        past it are masked.  None: every key is valid.
      attn_impl: "dense" or "flash" (kernel B1).
    """
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r}: expected one of {ATTN_IMPLS}")
    h = module.num_heads
    head_dim = hidden.shape[-1] // h
    q = _split_heads(module.q_proj(hidden) * head_dim ** -0.5, h)  # [B,H,T,hd]
    k = _split_heads(module.k_proj(hidden), h)
    v = _split_heads(module.v_proj(hidden), h)

    if attn_impl == "flash":
        # q is pre-scaled, so the kernel runs with scale=1
        out = flash.flash_attention(q, k, v, causal=False, scale=1.0,
                                    rel_pe=rel_pe, kv_valid_len=kv_valid_len)
        return module.out_proj(_merge_heads(out))

    scores = torch.matmul(q, k.transpose(-1, -2))
    if rel_pe is not None:
        qpe = torch.matmul(q, rel_pe.to(q.dtype).t())              # [B,H,T,2L]
        scores = scores + flash.relative_position_scores(qpe, k.shape[2])
    if kv_valid_len is not None:
        keep = (torch.arange(k.shape[2], device=k.device)[None, :]
                < kv_valid_len.to(k.device)[:, None])
        scores = scores.masked_fill(~keep[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return module.out_proj(_merge_heads(torch.matmul(probs, v)))
