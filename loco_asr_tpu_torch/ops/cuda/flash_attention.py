"""Kernel B1: relative-position + key-padding flash attention, forward, as
one CUDA wrapper (``csrc/flash_rel.cu``) beside its plain PyTorch version.

Counterpart of ``loco_asr_tpu/ops/pallas/flash_attention.py``
(``_flash_rel_forward`` / ``flash_attention(rel_pe=, kv_valid_len=)``):

    s[i, j] = scale * q_i . k_j + scale * q_i . pe[clip(i - j, -L, L-1) + L]

keys ``j >= valid_len[b]`` and, when causal, ``j > i`` are masked with
-1e30; ``out = softmax(s) v`` and ``lse = logsumexp(s)`` per query row,
with the row sum clamped at 1e-30.  A zero 2-row ``pe`` gives the
mask-only variant.

:func:`flash_rel_forward` launches the kernel for CUDA tensors and takes
the plain version only for CPU tensors; ``launches`` counts kernel
launches.  :func:`flash_attention` is the JAX package's public dispatch:
B1 when ``rel_pe`` or ``kv_valid_len`` is given, else kernel B5
(``flash_causal.flash_forward``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build, flash_causal

NEG_INF = -1e30
HEAD_DIM = 64
SMEM_LIMIT = 232448     # bytes of shared memory one block may use on sm_90


def relative_position_scores(qpe: torch.Tensor, tk: int) -> torch.Tensor:
    """Band-gather ``qpe`` [..., Tq, 2L] (= q . pe^T) into the [..., Tq, Tk]
    relative-position term: column ``clip(i - j, -L, L-1) + L`` of row i."""
    tq, two_l = qpe.shape[-2], qpe.shape[-1]
    half = two_l // 2
    i = torch.arange(tq, device=qpe.device)[:, None]
    j = torch.arange(tk, device=qpe.device)[None, :]
    idx = torch.clamp(i - j, -half, half - 1) + half
    return torch.gather(qpe, -1, idx.expand(*qpe.shape[:-1], tk))


def flash_rel_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            pe: torch.Tensor, valid_len: torch.Tensor, *,
                            causal: bool, scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: dense scores with a clipped band gather."""
    tq, tk = q.shape[2], k.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    s = s + relative_position_scores(torch.matmul(qf, pe.float().t()) * scale, tk)
    j = torch.arange(tk, device=q.device)
    vl = torch.clamp(valid_len.to(q.device, torch.int64), max=tk)
    masked = j[None, None, None, :] >= vl[:, None, None, None]
    if causal:
        i = torch.arange(tq, device=q.device)
        masked = masked | (j[None, :] > i[:, None])[None, None]
    s = torch.where(masked, torch.full_like(s, NEG_INF), s)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.matmul(p, vf) / denom
    lse = (m + torch.log(denom))[..., 0]
    return out.to(q.dtype), lse


def flash_rel_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      pe: torch.Tensor, valid_len: torch.Tensor, *,
                      causal: bool, scale: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B,H,Tq,64], k/v [B,H,Tk,64], pe [2L,64], valid_len [B] int ->
    (out [B,H,Tq,64], lse [B,H,Tq] float32)."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if k.shape != (b, h, tk, d) or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if pe.dim() != 2 or pe.shape[1] != d or pe.shape[0] < 2 or pe.shape[0] % 2:
        raise ValueError(f"pe must be [2L, {d}] with L >= 1, got {tuple(pe.shape)}")
    if valid_len.shape != (b,):
        raise ValueError(f"valid_len must be [{b}], got {tuple(valid_len.shape)}")
    if q.device.type == "cpu":
        return flash_rel_forward_plain(q, k, v, pe, valid_len,
                                       causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if d != HEAD_DIM:
        raise ValueError(f"the CUDA kernel needs head dim {HEAD_DIM}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v), ("pe", pe)):
        if t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"{name} must be float32 on {q.device}, "
                             f"got {t.dtype} on {t.device}")
    lib = _build.library()
    two_l = pe.shape[0]
    smem = lib.loco_flash_rel_smem_bytes(two_l)
    if smem > SMEM_LIMIT:
        raise ValueError(f"a rel-pos table of {two_l} rows needs {smem} B of "
                         f"shared memory, more than the {SMEM_LIMIT} B a "
                         "block may use")
    q, k, v, pe = (t.contiguous() for t in (q, k, v, pe))
    for name, t in (("q", q), ("k", k), ("v", v), ("pe", pe)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    vl = valid_len.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.loco_flash_rel_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pe.data_ptr(),
            vl.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b, h, tq, tk, two_l, int(causal), float(scale), stream)
    _build.check(code, "flash_rel_forward")
    flash_rel_forward.launches += 1
    return out, lse


flash_rel_forward.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, scale: float,
                    rel_pe: Optional[torch.Tensor] = None,
                    kv_valid_len: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """[B, H, T, D] q/k/v -> [B, H, Tq, D], as the JAX package's
    ``flash_attention`` with ``causal`` and ``scale`` given: with neither
    ``rel_pe`` nor ``kv_valid_len`` it is kernel B5
    (``flash_causal.flash_forward``); otherwise kernel B1, where a missing
    ``rel_pe`` becomes a zero 2-row table (the mask-only variant) and a
    missing ``kv_valid_len`` makes every key valid."""
    if rel_pe is None and kv_valid_len is None:
        out, _ = flash_causal.flash_forward(q, k, v, causal=causal, scale=scale)
        return out
    if kv_valid_len is None:
        kv_valid_len = torch.full((q.shape[0],), k.shape[2], dtype=torch.int32,
                                  device=q.device)
    if rel_pe is None:
        rel_pe = torch.zeros((2, q.shape[-1]), dtype=q.dtype, device=q.device)
    out, _ = flash_rel_forward(q, k, v, rel_pe, kv_valid_len, causal=causal,
                               scale=scale)
    return out
