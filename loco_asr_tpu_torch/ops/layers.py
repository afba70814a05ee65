"""Functional layers on tensors, with the semantics of
``loco_asr_tpu.ops.layers``.

Weights keep the JAX package's layouts where the tensor is passed in:
convolution weights are torch OIH (``[out, in/groups, K]``), as there.
Dense layers live in ``nn.Linear`` modules, whose ``weight`` is
``[out, in]``; the weight bridge (``models/speecht5/convert.py``)
transposes the JAX ``[in, out]`` kernels.  The large products and
convolutions go to ``torch.matmul`` / ``F.conv1d``, which the JAX package
likewise left to XLA.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_SQRT_HALF = 1.0 / math.sqrt(2.0)


class Norm(nn.Module):
    """Affine of a layer or group norm: ``weight`` (the JAX ``scale``) and
    ``bias``."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


def uniform_param(shape, fan_in: int,
                  generator: Optional[torch.Generator]) -> nn.Parameter:
    """Parameter drawn uniform in +-1/sqrt(fan_in) (JAX ``dense_init`` /
    ``conv1d_init``)."""
    bound = 1.0 / math.sqrt(fan_in)
    return nn.Parameter(torch.rand(shape, generator=generator) * 2 * bound - bound)


def init_dense(lin: nn.Linear, generator: Optional[torch.Generator]) -> None:
    """JAX ``dense_init`` on an ``nn.Linear``: uniform weight, zero bias."""
    with torch.no_grad():
        lin.weight.copy_(uniform_param(lin.weight.shape, lin.in_features, generator))
        lin.bias.zero_()


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf-based) GELU."""
    return 0.5 * x * (1.0 + torch.erf(x * _SQRT_HALF))


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approx GELU (HF "gelu_new", GPT-2's activation):
    ``0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))``, in one pass."""
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {"gelu": gelu, "gelu_new": gelu_new}


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ weight.T + bias`` with an ``nn.Linear``-layout ``[out, in]``
    weight."""
    return F.linear(x, weight, bias)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, reduced in float32."""
    y = F.layer_norm(x.float(), (x.shape[-1],), eps=eps).to(x.dtype)
    return y * weight + bias


def conv1d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *, stride: int = 1,
           padding: int = 0, groups: int = 1) -> torch.Tensor:
    """1-D convolution on channel-major ``[B, C, T]`` with OIH weights."""
    return F.conv1d(x, weight.to(x.dtype), bias, stride=stride,
                    padding=padding, groups=groups)


def conv1d_nhc(x: torch.Tensor, weight: torch.Tensor, *, stride: int = 1,
               padding: int = 0, groups: int = 1,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """1-D convolution on time-major ``[B, T, C]`` with OIH weights; same
    numbers as :func:`conv1d` on the transposed operands."""
    y = conv1d(x.transpose(1, 2), weight, bias, stride=stride,
               padding=padding, groups=groups)
    return y.transpose(1, 2)


def weight_norm_conv1d_weight(weight_g: torch.Tensor,
                              weight_v: torch.Tensor) -> torch.Tensor:
    """``g * v / ||v||`` with the norm over dims (0, 1), i.e. one norm per
    kernel position (``nn.utils.weight_norm(conv, dim=2)``)."""
    v = weight_v.float()
    norm = torch.sqrt(torch.sum(v * v, dim=(0, 1), keepdim=True))
    return (weight_g.float() * v / norm).to(weight_v.dtype)


def sinusoidal_table(num_embeddings: int, dim: int,
                     padding_idx: Optional[int] = None) -> np.ndarray:
    """fairseq-style sinusoidal table: [sin | cos] halves concatenated."""
    half = dim // 2
    emb = math.log(10000) / (half - 1)
    freqs = np.exp(np.arange(half, dtype=np.float64) * -emb)
    angles = np.arange(num_embeddings, dtype=np.float64)[:, None] * freqs[None, :]
    table = np.concatenate([np.sin(angles), np.cos(angles)], axis=1).astype(np.float32)
    if dim % 2 == 1:
        table = np.concatenate([table, np.zeros((num_embeddings, 1), np.float32)], axis=1)
    if padding_idx is not None:
        table[padding_idx, :] = 0.0
    return table


def interleaved_sinusoidal_table(max_len: int, dim: int) -> np.ndarray:
    """Interleaved sin/cos table (``pe[:, 0::2] = sin``, ``pe[:, 1::2] =
    cos``), HF SpeechT5ScaledPositionalEncoding's, computed in float64."""
    pe = np.zeros((max_len, dim), np.float32)
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float64) * -(math.log(10000.0) / dim))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator],
            training: bool) -> torch.Tensor:
    """Inverted dropout (``x / (1-p)`` on kept entries), as the JAX
    ``layers.dropout``: a no-op unless ``training`` with ``p > 0`` and a
    ``generator`` (on ``x``'s device) to draw the mask from."""
    if not training or p == 0.0 or generator is None:
        return x
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def embedding_init(num: int, dim: int, generator: Optional[torch.Generator],
                   padding_idx: Optional[int] = None) -> nn.Embedding:
    """``nn.Embedding`` drawn N(0, 1) with the ``padding_idx`` row zeroed
    (JAX ``embedding_init``).  The row is zero at init only: as in the JAX
    package, training may move it."""
    emb = nn.Embedding(num, dim)
    with torch.no_grad():
        emb.weight.copy_(torch.randn(num, dim, generator=generator))
        if padding_idx is not None:
            emb.weight[padding_idx] = 0.0
    return emb


def positions_from_padding(valid_mask: torch.Tensor, padding_idx: int,
                           past_length: int = 0) -> torch.Tensor:
    """Position ids ``padding_idx+1, padding_idx+2, ...`` on valid steps,
    ``padding_idx`` on padded steps (fairseq ``make_positions``)."""
    m = valid_mask.to(torch.int64)
    return (torch.cumsum(m, dim=1) + past_length) * m + padding_idx
