"""Kernels B5 and B6: causal or non-causal flash attention, forward, as one
strided CUDA kernel (``csrc/flash_causal.cu``) behind two wrappers, each
beside its plain PyTorch version.

Counterparts in ``loco_asr_tpu/ops/pallas/flash_attention.py``:

* :func:`flash_forward` -- ``_flash_forward`` (B5, ``_flash_kernel``):
  q [B, H, Tq, D], k/v [B, H, Tk, D] -> (out [B, H, Tq, D], lse [B, H, Tq]);
* :func:`flash_forward_nhd` -- ``_flash_forward_nhd`` (B6,
  ``_flash_pair_kernel``): q [B, Tq, H, D], k/v [B, Tk, H, D] read in place
  -> (out [B, Tq, H, D], lse [B, H, Tq]);
* :func:`flash_attention_nhd` -- the public dispatch: the NHD kernel for
  D == 64 and an even head count, else the flat-BH one on transposed
  views (same numbers).

``s = scale * q k^T``; with ``causal``, keys ``j > i`` are masked with
-1e30 (top-left aligned, so row i sees keys 0..i even when Tq != Tk);
``out = softmax(s) v`` and ``lse = logsumexp(s)`` per row, the row sum
clamped at 1e-30.  Everything runs in float32: the JAX package's
``precision="default"`` (bf16 MXU operands) applies on the TPU only, and
its CPU reference is f32.

The kernel addresses q, k, v and out through (batch, head, time) strides
with a contiguous head dim, so neither layout, nor the column slices of a
fused qkv projection, is copied before the launch.  Both wrappers launch
it for CUDA tensors and take their plain version only for CPU tensors;
each counts its own launches in ``launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30
HEAD_DIMS = (8, 16, 32, 64, 128)   # instantiated in csrc/flash_causal.cu


def flash_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`flash_forward`: dense scores."""
    tq, tk = q.shape[2], k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        i = torch.arange(tq, device=q.device)[:, None]
        j = torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(j > i, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.matmul(p, v.float()) / denom
    lse = (m + torch.log(denom))[..., 0]
    return out.to(q.dtype), lse


def flash_forward_nhd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            causal: bool, scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`flash_forward_nhd`."""
    out, lse = flash_forward_plain(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal, scale=scale)
    return out.transpose(1, 2), lse


def _check_shapes(q, k, v, t_axis: int):
    """(B, H, Tq, Tk, D) of q/k/v whose time axis is ``t_axis`` (2 for
    [B, H, T, D], 1 for [B, T, H, D])."""
    h_axis = 3 - t_axis
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    b, h, tq, d = q.shape[0], q.shape[h_axis], q.shape[t_axis], q.shape[3]
    tk = k.shape[t_axis]
    if k.shape[0] != b or k.shape[h_axis] != h or k.shape[3] != d:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    if tq == 0 or tk == 0:
        raise ValueError(f"empty time axis: Tq={tq}, Tk={tk}")
    return b, h, tq, tk, d


def _launch(q, k, v, dims, *, t_axis: int, causal: bool, scale: float,
            what: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check the CUDA operands, allocate out (q's layout, contiguous) and
    lse, and launch the kernel on the current stream."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, h, tq, tk, d = dims
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: the CUDA kernel takes head dims {HEAD_DIMS}, got {d}")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    h_axis = 3 - t_axis
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"{what}: {name} must be float32 on {q.device}, "
                             f"got {t.dtype} on {t.device}")
        # a stride of a size-1 axis is never stepped; it may be anything
        st = tuple(0 if t.shape[a] == 1 else t.stride(a) for a in (0, h_axis, t_axis))
        if t.stride(3) != 1 or any(s % 4 for s in st) or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} needs a contiguous head dim, strides "
                             f"that are multiples of 4 and a 16-byte aligned "
                             f"start, got strides {tuple(t.stride())}")
        strides.extend(st)
    lib = _build.library()
    c_strides = (ctypes.c_longlong * 12)(*strides)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.loco_flash_causal_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), ctypes.addressof(c_strides), b, h, tq, tk, d,
            int(causal), float(scale), stream)
    _build.check(code, what)
    return out, lse


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B5: q [B,H,Tq,D], k/v [B,H,Tk,D] -> (out [B,H,Tq,D],
    lse [B,H,Tq] float32)."""
    dims = _check_shapes(q, k, v, t_axis=2)
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, causal=causal, scale=scale)
    out, lse = _launch(q, k, v, dims, t_axis=2, causal=causal, scale=scale,
                       what="flash_forward")
    flash_forward.launches += 1
    return out, lse


flash_forward.launches = 0


def flash_forward_nhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B6: q [B,Tq,H,D], k/v [B,Tk,H,D], read in place ->
    (out [B,Tq,H,D], lse [B,H,Tq] float32)."""
    dims = _check_shapes(q, k, v, t_axis=1)
    if q.device.type == "cpu":
        return flash_forward_nhd_plain(q, k, v, causal=causal, scale=scale)
    out, lse = _launch(q, k, v, dims, t_axis=1, causal=causal, scale=scale,
                       what="flash_forward_nhd")
    flash_forward_nhd.launches += 1
    return out, lse


flash_forward_nhd.launches = 0


def flash_attention_nhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, scale: Optional[float] = None
                        ) -> torch.Tensor:
    """[B, T, H, D] q/k/v -> [B, Tq, H, D], as the JAX package's
    ``flash_attention_nhd``: kernel B6 for D == 64 and an even head count,
    else kernel B5 on [B, H, T, D] views (no copy either way)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    _, _, h, d = q.shape
    if d != 64 or h % 2:
        out, _ = flash_forward(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal, scale=scale)
        return out.transpose(1, 2)
    out, _ = flash_forward_nhd(q, k, v, causal=causal, scale=scale)
    return out
