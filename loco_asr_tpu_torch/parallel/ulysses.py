"""Ulysses (head-scatter) sequence parallelism, the all-to-all alternative
to ring attention: the port of ``loco_asr_tpu.parallel.ulysses``.

Each rank holds [B, H, T/n, D] blocks.  One all-to-all (q, k and v in one
message) re-shards them to [B, H/n, T, D]: this rank's heads over the
whole sequence; each rank attends exactly over the whole sequence on its
head slice, and a second all-to-all restores the sequence split.

The local attention is the port's flash dispatch
(``ops/cuda/flash_attention.flash_attention``), the same function JAX's
dense form computes: on the card kernel B1 for the encoder (relative
positions and key padding over the whole sequence, B3/B4 in the
backward) and kernel B5 for causal attention (GPT-2; its blockwise
backward); on CPU tensors their plain versions.  JAX's dense form gathers
a [T, T, D] relative-key tensor (``ulysses.py:38-42``), 17 GB a rank at
the 164 s window's 8,199 frames."""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.cuda import flash_attention as flash
from . import collectives as coll


def local_full_attention(q, k, v, kv_valid_len, rel_pe, *, causal: bool, scale: float):
    """Exact attention on [B, H/n, T, D] (a head slice, the whole
    sequence): kernel B1 with ``rel_pe`` or ``kv_valid_len``, else B5."""
    return flash.flash_attention(q, k, v, causal=causal, scale=scale, rel_pe=rel_pe,
                                 kv_valid_len=kv_valid_len)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, sp,
                      causal: bool = True, scale: Optional[float] = None,
                      kv_valid_len: Optional[torch.Tensor] = None,
                      rel_pe: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact attention over this rank's [B, H, T/n, D] q/k/v blocks of the
    group ``sp`` by head-scatter all-to-alls; H must divide by the group's
    size.  Same contract as ``ring_attention.ring_attention``."""
    h, n = q.shape[1], sp.size
    if h % n:
        raise ValueError(f"num heads {h} not divisible by mesh axis {n} "
                         "(Ulysses scatters heads; use ring attention)")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    # [3, B, H, T/n, D] -> [3, B, H/n, T, D]: scatter heads, gather the sequence
    qkv = coll.exchange(torch.stack([q, k, v]), sp.group, sp.mesh, split_dim=2,
                        concat_dim=3)
    out = local_full_attention(qkv[0], qkv[1], qkv[2], kv_valid_len, rel_pe,
                               causal=causal, scale=scale)
    # [B, H/n, T, D] -> [B, H, T/n, D]
    return coll.exchange(out, sp.group, sp.mesh, split_dim=2, concat_dim=1)
