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
clamped at 1e-30.  Float32 operands run in float32: the JAX package's
``precision="default"`` (bf16 MXU operands for f32 inputs) applies on the
TPU only, and its CPU reference is f32.  Bfloat16 operands take the JAX
kernels' bf16 path: products of bf16 operands accumulated in f32 (exact
products, so the plain versions upcast to f32), ``p`` rounded to bf16
before ``p v``, softmax and lse in f32, ``out`` in bf16.

The source holds two kernels, the launch's *form* (:func:`kernel_form`):
``"wgmma"``, Hopper's warpgroup products fed by TMA, for bf16 operands at
head dims 64 and 128; ``"mma_sync"`` for every float32 call and bf16 at
head dims 8-32.  A CUDA call launches its form or raises; it never tries
the other one.

The kernel addresses q, k, v and out through (batch, head, time) strides
with a contiguous head dim, so neither layout, nor the column slices of a
fused qkv projection, is copied before the launch.  Both wrappers launch
it for CUDA tensors and take their plain version only for CPU tensors;
each counts its own launches in ``launches`` and, by form, in
``launches_by_form``.  The kernel is instantiated
at ``HEAD_DIMS``; any other head dim up to 128 runs the next one up on
operands zero-padded in the head dim (a copy, exact), and above 128 the
wrappers raise.

Both are differentiable through one ``torch.autograd.Function`` whose
backward is :func:`flash_backward_blockwise`, the counterpart of the JAX
package's XLA ``_flash_backward`` (there is no Pallas backward to port);
``flash_backward.launches`` counts its calls on CUDA tensors.  Under
``torch.no_grad`` / ``inference_mode``, or when no operand requires grad,
the wrappers skip the ``Function`` and launch directly.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30
BLOCK_K = 512                      # key block of the blockwise backward
HEAD_DIMS = (8, 16, 32, 64, 128)   # instantiated in csrc/flash_causal.cu
FORMS = ("mma_sync", "wgmma")      # the C entry's form argument is the index
WGMMA_HEAD_DIMS = (64, 128)        # the wgmma forms' instantiations (bf16)


def kernel_form(dtype: torch.dtype, kd: int) -> str:
    """The kernel a CUDA launch of B1, B3/B4 or B5/B6 with operands of
    ``dtype`` at the instantiated head dim ``kd`` takes: ``"wgmma"`` for
    bfloat16 at 64 and 128, else ``"mma_sync"``."""
    return "wgmma" if dtype is torch.bfloat16 and kd in WGMMA_HEAD_DIMS else "mma_sync"


def kernel_head_dim(d: int, what: str) -> int:
    """The instantiated head dim that a launch at head dim ``d`` runs: ``d``
    itself, else the next one up (12 -> 16, 80 -> 128), on operands
    zero-padded in the head dim.  That is exact: zero columns add nothing
    to q.k^T (or q.pe^T), the padded output columns are dropped, and the
    caller's ``scale`` is kept.  Above the largest it raises."""
    for kd in HEAD_DIMS:
        if d <= kd:
            return kd
    raise ValueError(f"{what}: the CUDA kernels take head dims up to {HEAD_DIMS[-1]}, got {d}")


def pad_head_dim(x: torch.Tensor, kd: int) -> torch.Tensor:
    """``x`` as it is when its head dim (the last) is ``kd``, else a
    contiguous copy zero-padded to ``kd``."""
    d = x.shape[-1]
    return x if d == kd else torch.nn.functional.pad(x, (0, kd - d))


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
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / denom
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
    qs, ks = q.shape, k.shape
    if len(qs) != 4 or len(ks) != 4 or v.shape != ks:
        raise ValueError(f"bad shapes q {tuple(qs)} k {tuple(ks)} v {tuple(v.shape)}")
    b, h, tq, d = qs[0], qs[h_axis], qs[t_axis], qs[3]
    tk = ks[t_axis]
    if ks[0] != b or ks[h_axis] != h or ks[3] != d:
        raise ValueError(f"bad shapes q {tuple(qs)} k {tuple(ks)}")
    if tq == 0 or tk == 0:
        raise ValueError(f"empty time axis: Tq={tq}, Tk={tk}")
    return b, h, tq, tk, d


_STRIDE_BUFS: dict = {}   # strides -> (ctypes array, its address)


def stride_buffer(strides: tuple) -> int:
    """Address of a ctypes ``long long`` array holding ``strides``, made once
    per distinct tuple and kept (a process meets few shapes)."""
    buf = _STRIDE_BUFS.get(strides)
    if buf is None:
        if len(_STRIDE_BUFS) >= 4096:
            _STRIDE_BUFS.clear()
        arr = (ctypes.c_longlong * len(strides))(*strides)
        buf = _STRIDE_BUFS[strides] = (arr, ctypes.addressof(arr))
    return buf[1]


def operand_strides(operands, t_axis: int, what: str) -> list:
    """(batch, head, time) element strides of CUDA operands of the first
    one's type (float32 or bfloat16) and device, with a contiguous head
    dim, strides that are multiples of 16 bytes and 16-byte aligned starts
    -- or a ValueError naming the operand.  The common case costs one pass
    of attribute reads; the full check, which also allows any stride on an
    axis of size 1 (never stepped), runs only when that pass fails."""
    h_axis = 3 - t_axis
    dev, dtype = operands[0][1].device, operands[0][1].dtype
    unit = 16 // operands[0][1].element_size()   # elements in 16 bytes
    strides = []
    ok = dtype in _build.KERNEL_DTYPES
    for _, t in operands:
        s = t.stride()
        strides += (s[0], s[h_axis], s[t_axis])
        ok = (ok and t.dtype is dtype and t.device == dev and s[3] == 1
              and t.data_ptr() % 16 == 0)
    if ok and not any(s % unit for s in strides):
        return strides
    if dtype not in _build.KERNEL_DTYPES:
        _build.bf16_flag(dtype, what)      # raises, naming the types the kernels take
    strides = []
    for name, t in operands:
        if t.dtype != dtype or t.device != dev:
            raise ValueError(f"{what}: {name} must be {dtype} on {dev}, "
                             f"got {t.dtype} on {t.device}")
        # a stride of a size-1 axis is never stepped; it may be anything
        st = tuple(0 if t.shape[a] == 1 else t.stride(a) for a in (0, h_axis, t_axis))
        if t.stride(3) != 1 or any(s % unit for s in st) or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} needs a contiguous head dim, strides "
                             f"that are multiples of {unit} and a 16-byte aligned "
                             f"start, got strides {tuple(t.stride())}")
        strides.extend(st)
    return strides


def _launch(q, k, v, dims, *, t_axis: int, causal: bool, scale: float,
            what: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check the CUDA operands, allocate out (q's layout, and q's strides
    where q is dense: a transposed view of a contiguous tensor gets the
    same transposed layout, so merging its heads is a view) and lse, and
    launch the kernel's form (:func:`kernel_form`) on the current stream.
    A head dim without an instantiation runs the next one up on padded
    copies (:func:`kernel_head_dim`); out is then a view of the first D
    columns."""
    dev = q.device
    _build.require_cuda(q, what)
    b, h, tq, tk, d = dims
    kd = kernel_head_dim(d, what)
    q, k, v = (pad_head_dim(x, kd) for x in (q, k, v))
    strides = operand_strides((("q", q), ("k", k), ("v", v)), t_axis, what)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=dev)
    so = out.stride()
    strides += (so[0], so[3 - t_axis], so[t_axis])
    code = _build.call_on_stream(
        _build.library().loco_flash_causal_fwd, dev,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        stride_buffer(tuple(strides)), b, h, tq, tk, kd, int(causal), float(scale),
        FORMS.index(kernel_form(q.dtype, kd)), _build.bf16_flag(q.dtype, what))
    _build.check(code, what)
    return out[..., :d], lse


def flash_backward_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor, *,
                             causal: bool, scale: float, block_k: int = BLOCK_K
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradient of :func:`flash_forward` ([B, H, T, D] operands): the
    flash-attention-2 backward over key blocks, the counterpart of the JAX
    package's ``_flash_backward`` (XLA there, not a Pallas kernel).  Memory
    is O(Tq * block_k); ``delta = rowsum(g * out)`` and every sum are float32.
    The products take operands of q's dtype (the cotangent cast to it, p and
    ds rounded to it), upcast to float32, which is exact for bf16, so that
    a bf16 call accumulates in float32 as the JAX ``preferred_element_type``
    does; the gradients are cast to the inputs' dtypes.  Under ``causal`` a
    key block only meets the query rows at or below its first key, so the
    rows above are skipped."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    dt = q.dtype
    delta = (g.float() * out.float()).sum(dim=-1)               # [B,H,Tq]
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.to(dt).float()
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for k0 in range(0, tk, block_k):
        k1 = min(k0 + block_k, tk)
        r0 = k0 if causal else 0
        if r0 >= tq:
            break
        kj, vj = kf[:, :, k0:k1], vf[:, :, k0:k1]
        qi, gi = qf[:, :, r0:], gf[:, :, r0:]
        s = torch.matmul(qi, kj.transpose(-1, -2)) * scale
        if causal:
            i = torch.arange(r0, tq, device=q.device)[:, None]
            j = torch.arange(k0, k1, device=q.device)[None, :]
            s = s.masked_fill(j > i, NEG_INF)
        p = torch.exp(s - lse[:, :, r0:, None])
        dv[:, :, k0:k1] = torch.matmul(p.to(dt).float().transpose(-1, -2), gi)
        ds = p * (torch.matmul(gi, vj.transpose(-1, -2)) - delta[:, :, r0:, None])
        ds = ds.to(dt).float()
        dq[:, :, r0:] += torch.matmul(ds, kj) * scale
        dk[:, :, k0:k1] = torch.matmul(ds.transpose(-1, -2), qi) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_backward(q, k, v, out, lse, g, *, causal: bool, scale: float, t_axis: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of B5 (``t_axis=2``) or B6 (``t_axis=1``, [B, T, H, D]
    operands, run on transposed views as the JAX ``_nhd_bwd`` does).
    ``launches`` counts its calls on CUDA tensors."""
    tr = (lambda x: x) if t_axis == 2 else (lambda x: x.transpose(1, 2))
    grads = flash_backward_blockwise(tr(q), tr(k), tr(v), tr(out), lse, tr(g),
                                     causal=causal, scale=scale)
    if q.device.type == "cuda":
        flash_backward.launches += 1
    return tuple(tr(x) for x in grads)


flash_backward.launches = 0


def _forward(q, k, v, dims, t_axis, causal, scale, what):
    """The plain version for CPU tensors, the kernel (counted) for CUDA ones."""
    if q.device.type == "cpu":
        plain = flash_forward_plain if t_axis == 2 else flash_forward_nhd_plain
        return plain(q, k, v, causal=causal, scale=scale)
    out, lse = _launch(q, k, v, dims, t_axis=t_axis, causal=causal, scale=scale,
                       what=what)
    fn = flash_forward if t_axis == 2 else flash_forward_nhd
    fn.launches += 1
    fn.launches_by_form[kernel_form(q.dtype, kernel_head_dim(dims[4], what))] += 1
    return out, lse


def needs_grad(*tensors) -> bool:
    """Whether autograd must record a call on ``tensors``: grad mode is on
    and one of them requires grad.  Otherwise the wrappers launch directly
    and skip the ``torch.autograd.Function``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _FlashCausal(torch.autograd.Function):
    """B5/B6 forward, blockwise PyTorch backward."""

    @staticmethod
    def forward(ctx, q, k, v, dims, t_axis, causal, scale, what):
        out, lse = _forward(q, k, v, dims, t_axis, causal, scale, what)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.t_axis = causal, scale, t_axis
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, g, causal=ctx.causal,
                                    scale=ctx.scale, t_axis=ctx.t_axis)
        return dq, dk, dv, None, None, None, None, None


def _dispatch(q, k, v, t_axis, causal, scale, what):
    dims = _check_shapes(q, k, v, t_axis=t_axis)
    if needs_grad(q, k, v):
        return _FlashCausal.apply(q, k, v, dims, t_axis, causal, scale, what)
    return _forward(q, k, v, dims, t_axis, causal, scale, what)


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B5: q [B,H,Tq,D], k/v [B,H,Tk,D] -> (out [B,H,Tq,D],
    lse [B,H,Tq] float32); ``out`` is differentiable (``lse`` is not)."""
    return _dispatch(q, k, v, 2, causal, scale, "flash_forward")


flash_forward.launches = 0
flash_forward.launches_by_form = dict.fromkeys(FORMS, 0)


def flash_forward_nhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B6: q [B,Tq,H,D], k/v [B,Tk,H,D], read in place ->
    (out [B,Tq,H,D], lse [B,H,Tq] float32); ``out`` is differentiable."""
    return _dispatch(q, k, v, 1, causal, scale, "flash_forward_nhd")


flash_forward_nhd.launches = 0
flash_forward_nhd.launches_by_form = dict.fromkeys(FORMS, 0)


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
