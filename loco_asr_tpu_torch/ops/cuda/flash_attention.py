"""Kernel B1 (relative-position + key-padding flash attention, forward,
``csrc/flash_rel.cu``) and its gradient, kernels B3 and B4
(``csrc/flash_rel_bwd.cu``), each beside its plain PyTorch version.

Counterpart of ``loco_asr_tpu/ops/pallas/flash_attention.py``
(``_flash_rel_forward``, ``_flash_rel_backward_pallas`` and the custom VJP
``_flash_attention_rel`` behind ``flash_attention(rel_pe=, kv_valid_len=)``):

    s[i, j] = scale * q_i . k_j + scale * q_i . pe[clip(i - j, -L, L-1) + L]

keys ``j >= valid_len[b]`` and, when causal, ``j > i`` are masked with
-1e30; ``out = softmax(s) v`` and ``lse = logsumexp(s)`` per query row,
with the row sum clamped at 1e-30.  ``pe=None`` is the mask-only
variant: the kernel skips the band, and the plain version and the
backward take a zero 2-row table in its place.  The backward recomputes
``p = exp(s - lse)`` with masked entries set to exactly 0 (so a row with
no valid key gets zero gradients, not NaN) and
``ds = p * (g.v^T - rowsum(g * out))``.

Float32 operands run in float32.  Bfloat16 operands take the JAX kernels'
bf16 path: every product on bf16 operands with float32 accumulation (the
plain versions upcast to float32, exact for bf16 products), ``p`` rounded
to bf16 before ``p v`` and ``p^T g``, ``ds`` before ``ds k`` and
``ds^T q``; the band ``q pe^T``, the softmax, lse, delta, dqpe and the
gradient sums stay float32; ``out`` is bf16, and dq, dk, dv leave B3 + B4
in float32 and are cast to bf16 after the band's share is added.  ``pe``
takes q's dtype (an exact upcast for a bf16 table under float32 q; a
float32 table under bf16 q raises on the card, where the bf16 form would
round it).  A bf16 CUDA tensor reaches the bf16 forms or raises.

B1 and B3 + B4 come in two forms (``flash_causal.kernel_form``):
``"wgmma"``, Hopper's warpgroup products fed by TMA, for bf16 at kernel
head dims 64 and 128; ``"mma_sync"`` for every float32 launch and bf16 at
8-32.  A CUDA launch runs its form or raises; ``launches_by_form`` on
:func:`flash_rel_forward` and :func:`flash_rel_backward` counts them.
The wgmma forms bring in the band window of each 64 x 64 tile and take the
same shared memory at every L; the mma.sync forms keep an f32 table of the
2L rows in shared memory, and past the L that fits a block the wrapper
raises before the launch.

:func:`flash_rel_forward` is differentiable through one
``torch.autograd.Function``: its forward is B1, its backward
:func:`flash_rel_backward` (B3 + B4 and two ``torch.matmul`` for the
band's share of dq and dpe).  CUDA tensors launch the kernels; CPU
tensors take the plain versions, forward and backward.  ``launches``
on each wrapper counts kernel launches (one per B3 + B4 pair for the
backward).  Under ``torch.no_grad`` / ``inference_mode``, or when no
operand requires grad, the forward launches without the ``Function``.
The kernels read q, k, v (and, backward, the cotangent) through their
strides (the transposed views of ``split_heads`` and a GPT-2 layer's qkv
column views, in place) and write ``out``, dq, dk and dv into [B, T, H, D]
buffers returned as [B, H, T, D] views, so that merging the heads and the
gradient of splitting them are views too.  B1 and B3 + B4 are
instantiated at the head dims B5 is (``flash_causal.HEAD_DIMS``, 8 to
128); any other head dim up to 128 runs the next one up on operands
zero-padded in the head dim (exact: zero columns add nothing to q.k^T or
q.pe^T, the padded output columns are dropped, and ``scale`` stays the
caller's), which costs a copy of each operand; above 128 the wrappers
raise.  A mask-only forward's backward runs the mask-only B3 + B4 and has
no band gradient.
:func:`flash_attention` is the JAX package's public dispatch: B1 when
``rel_pe`` or ``kv_valid_len`` is given, else kernel B5
(``flash_causal.flash_forward``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from . import _build, flash_causal

NEG_INF = -1e30
SMEM_LIMIT = 232448     # bytes of shared memory one block may use on sm_90

_CONSTANTS: dict = {}   # (kind, device, ...) -> a tensor no caller writes to


def _constant(key, make) -> torch.Tensor:
    """One tensor per key, made outside inference mode so that autograd may
    save it: the zero table and the all-valid lengths of
    :func:`flash_attention`, allocated once and not per call."""
    t = _CONSTANTS.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = _CONSTANTS[key] = make()
    return t


def _zero_table(d: int, dtype, device) -> torch.Tensor:
    return _constant(("pe", d, dtype, device),
                     lambda: torch.zeros((2, d), dtype=dtype, device=device))


def _full_lengths(b: int, tk: int, device) -> torch.Tensor:
    return _constant(("vl", b, tk, device),
                     lambda: torch.full((b,), tk, dtype=torch.int32, device=device))


def band_index(tq: int, tk: int, two_l: int, device) -> torch.Tensor:
    """[Tq, Tk] column ``clip(i - j, -L, L-1) + L`` of the rel-pos table."""
    half = two_l // 2
    i = torch.arange(tq, device=device)[:, None]
    j = torch.arange(tk, device=device)[None, :]
    return torch.clamp(i - j, -half, half - 1) + half


def relative_position_scores(qpe: torch.Tensor, tk: int) -> torch.Tensor:
    """Band-gather ``qpe`` [..., Tq, 2L] (= q . pe^T) into the [..., Tq, Tk]
    relative-position term: column ``clip(i - j, -L, L-1) + L`` of row i."""
    idx = band_index(qpe.shape[-2], tk, qpe.shape[-1], qpe.device)
    return torch.gather(qpe, -1, idx.expand(*qpe.shape[:-1], tk))


def _masked(valid_len: torch.Tensor, tq: int, tk: int, causal: bool,
            device) -> torch.Tensor:
    """[B, 1, Tq | 1, Tk] True where a key is masked."""
    j = torch.arange(tk, device=device)
    vl = torch.clamp(valid_len.to(device, torch.int64), max=tk)
    masked = j[None, None, None, :] >= vl[:, None, None, None]
    if causal:
        i = torch.arange(tq, device=device)
        masked = masked | (j[None, :] > i[:, None])[None, None]
    return masked


def _scores(q, k, pe, scale):
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    return s + relative_position_scores(torch.matmul(q, pe.t()) * scale, k.shape[2])


def flash_rel_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            pe: torch.Tensor, valid_len: torch.Tensor, *,
                            causal: bool, scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of B1: dense scores with a clipped band gather."""
    tq, tk = q.shape[2], k.shape[2]
    s = _scores(q.float(), k.float(), pe.float(), scale)
    s = s.masked_fill(_masked(valid_len, tq, tk, causal, q.device), NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / denom
    lse = (m + torch.log(denom))[..., 0]
    return out.to(q.dtype), lse


def _check(q, k, v, pe, valid_len):
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if k.shape != (b, h, tk, d) or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if pe.dim() != 2 or pe.shape[1] != d or pe.shape[0] < 2 or pe.shape[0] % 2:
        raise ValueError(f"pe must be [2L, {d}] with L >= 1, got {tuple(pe.shape)}")
    if valid_len.shape != (b,):
        raise ValueError(f"valid_len must be [{b}], got {tuple(valid_len.shape)}")


@functools.lru_cache(maxsize=None)
def _smem_bytes(fn: str, *args) -> int:
    return getattr(_build.library(), fn)(*args)


def _check_smem(what: str, smem: int, two_l: int) -> None:
    """Raise before the launch when the mma.sync form's table of ``two_l``
    rows leaves a block too little shared memory (the wgmma forms' does
    not depend on L: their launches skip this)."""
    if smem > SMEM_LIMIT:
        raise ValueError(f"{what}: a rel-pos table of {two_l} rows needs {smem} B "
                         f"of shared memory, more than the {SMEM_LIMIT} B a "
                         "block may use")


def _kernel_head_dim(what: str, q: torch.Tensor) -> int:
    _build.require_cuda(q, what)
    return flash_causal.kernel_head_dim(q.shape[-1], what)


def _contiguous(what: str, name: str, t: torch.Tensor, dev,
                dtype=torch.float32) -> torch.Tensor:
    """``t`` as a contiguous, 16-byte aligned ``dtype`` tensor on ``dev``."""
    if t.dtype is not dtype or t.device != dev:
        raise ValueError(f"{what}: {name} must be {dtype} on {dev}, "
                         f"got {t.dtype} on {t.device}")
    t = t.contiguous()
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: {name} must be 16-byte aligned")
    return t


def _table_of(what: str, pe: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The rel-pos table in q's dtype, as the kernel reads it: a bf16 table
    under float32 q widens exactly; a float32 table under bf16 q would be
    rounded, which the JAX kernels do not do, so it raises."""
    if pe.dtype is torch.float32 and q.dtype is torch.bfloat16:
        raise ValueError(f"{what}: a float32 rel-pos table with bfloat16 q; "
                         "cast the table to bfloat16 first")
    return _contiguous(what, "pe", pe.to(q.dtype), q.device, q.dtype)


def _heads_view_buffer(b: int, h: int, t: int, d: int, device,
                       dtype=torch.float32) -> torch.Tensor:
    """[B, H, T, d] view of a new [B, T, H, d] buffer: the layout of
    ``split_heads``, so merging the heads of an output, or the gradient of
    splitting them, is a view."""
    return torch.empty((b, t, h, d), dtype=dtype, device=device).transpose(1, 2)


def _launch_forward(q, k, v, pe, valid_len, causal, scale, *, mask_only: bool):
    """B1 on the current stream (counted, and by form): q, k, v read
    through their strides, out written into a [B, Tq, H, D] buffer and
    returned as a [B, H, Tq, D] view (of the first D columns where D was
    padded).  The form is ``flash_causal.kernel_form``'s: the wgmma kernel
    for bf16 at kernel head dims 64 and 128, the mma.sync one otherwise; the
    C entry launches it or returns an error, which raises."""
    what = "flash_rel_forward"
    b, h, tq, d = q.shape
    kd = _kernel_head_dim(what, q)
    pe = _table_of(what, pe, q)
    q, k, v, pe = (flash_causal.pad_head_dim(x, kd) for x in (q, k, v, pe))
    strides = flash_causal.operand_strides((("q", q), ("k", k), ("v", v)), 2, what)
    bf16 = _build.bf16_flag(q.dtype, what)
    form = flash_causal.kernel_form(q.dtype, kd)
    two_l = pe.shape[0]
    if form == "mma_sync":
        _check_smem(what, _smem_bytes("loco_flash_rel_smem_bytes", two_l, int(mask_only), kd,
                                      bf16), two_l)
    vl = valid_len.to(device=q.device, dtype=torch.int32).contiguous()
    out = _heads_view_buffer(b, h, tq, kd, q.device, q.dtype)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    strides += out.stride()[:3]
    code = _build.call_on_stream(
        _build.library().loco_flash_rel_fwd, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pe.data_ptr(), vl.data_ptr(),
        out.data_ptr(), lse.data_ptr(), flash_causal.stride_buffer(tuple(strides)),
        b, h, tq, k.shape[2], kd, two_l, int(causal), int(mask_only), float(scale),
        flash_causal.FORMS.index(form), bf16)
    _build.check(code, what)
    flash_rel_forward.launches += 1
    flash_rel_forward.launches_by_form[form] += 1
    return out[..., :d], lse


def flash_rel_backward_plain(q, k, v, pe, valid_len, out, lse, g, *,
                             causal: bool, scale: float
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain PyTorch version of B3 + B4: dense recompute of ``p`` from
    ``lse``, then dq, dk, dv and the band gradient ``dqpe`` by
    ``scatter_add`` of ds into the band columns.  Returns (dq_content, dk,
    dv, dqpe) -- dq without the band's share, as the kernels do."""
    tq, tk, two_l = q.shape[2], k.shape[2], pe.shape[0]
    dt = q.dtype
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.to(dt).float()
    s = _scores(qf, kf, pe.float(), scale)
    masked = _masked(valid_len, tq, tk, causal, q.device)
    p = torch.exp(s - lse[..., None]).masked_fill(masked, 0.0)
    delta = (g.float() * out.float()).sum(dim=-1)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), gf)
    ds = p * (torch.matmul(gf, vf.transpose(-1, -2)) - delta[..., None])
    ds_dt = ds.to(dt).float()    # the band's gradient takes ds unrounded
    dq = torch.matmul(ds_dt, kf) * scale
    dk = torch.matmul(ds_dt.transpose(-1, -2), qf) * scale
    idx = band_index(tq, tk, two_l, q.device).expand_as(ds)
    dqpe = torch.zeros(*ds.shape[:-1], two_l, dtype=ds.dtype, device=ds.device)
    dqpe.scatter_add_(-1, idx, ds)
    return dq, dk, dv, dqpe


def _launch_backward(q, k, v, pe, valid_len, lse, delta, g, causal, scale, *,
                     mask_only: bool):
    """B3 + B4 on the current stream (counted, and by form): q, k, v and g
    (float32 or bf16, one dtype) read through their strides, dq, dk, dv
    written in float32 into [B, T, H, D] buffers and returned as
    [B, H, T, D] views (of the first D columns where D was padded), dqpe
    [B, H, Tq, 2L] (None when ``mask_only``) written whole by B3.  The
    form is ``flash_causal.kernel_form``'s: the wgmma kernels for bf16 at
    kernel head dims 64 and 128, the mma.sync ones otherwise; the C entry
    launches it or returns an error, which raises."""
    what = "flash_rel_backward"
    b, h, tq, d = q.shape
    kd = _kernel_head_dim(what, q)
    pe = _table_of(what, pe, q)
    q, k, v, g, pe = (flash_causal.pad_head_dim(x, kd) for x in (q, k, v, g, pe))
    strides = flash_causal.operand_strides(
        (("q", q), ("k", k), ("v", v), ("g", g)), 2, what)
    bf16 = _build.bf16_flag(q.dtype, what)
    form = flash_causal.kernel_form(q.dtype, kd)
    dev = q.device
    lse, delta = (_contiguous(what, n, t, dev) for n, t in (("lse", lse), ("delta", delta)))
    tk, two_l = k.shape[2], pe.shape[0]
    if form == "mma_sync":
        _check_smem(what, max(_smem_bytes("loco_flash_rel_bwd_smem_bytes", two_l,
                                          int(mask_only), kernel, kd, bf16)
                              for kernel in (0, 1)), two_l)
    vl = valid_len.to(device=dev, dtype=torch.int32).contiguous()
    dq = _heads_view_buffer(b, h, tq, kd, dev)
    dk = _heads_view_buffer(b, h, tk, kd, dev)
    dv = _heads_view_buffer(b, h, tk, kd, dev)
    dqpe = None if mask_only else torch.empty((b, h, tq, two_l), dtype=torch.float32,
                                              device=dev)
    for x in (dq, dk, dv):
        strides += x.stride()[:3]
    code = _build.call_on_stream(
        _build.library().loco_flash_rel_bwd, dev,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pe.data_ptr(), vl.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), g.data_ptr(), dq.data_ptr(),
        0 if dqpe is None else dqpe.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        flash_causal.stride_buffer(tuple(strides)), b, h, tq, tk, kd, two_l, int(causal),
        int(mask_only), float(scale), flash_causal.FORMS.index(form), bf16)
    _build.check(code, what)
    flash_rel_backward.launches += 1
    flash_rel_backward.launches_by_form[form] += 1
    return dq[..., :d], dk[..., :d], dv[..., :d], dqpe


def flash_rel_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       pe: torch.Tensor, valid_len: torch.Tensor,
                       out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor, *,
                       causal: bool, scale: float, need_dpe: bool = True,
                       mask_only: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  Optional[torch.Tensor]]:
    """Gradient of :func:`flash_rel_forward`'s ``out`` under cotangent ``g``
    -> (dq, dk, dv, dpe or None).  Kernels B3 + B4 for CUDA tensors, the
    plain version for CPU tensors; the band's share of dq
    (``scale * dqpe . pe``) and ``dpe = scale * sum dqpe^T . q`` are
    ``torch.matmul`` either way, skipped for dpe unless ``need_dpe``.  With
    ``mask_only`` (the forward ran without a table; ``pe`` is the zero
    table) the kernels skip the band and neither matmul runs: dpe is None.
    On the card q, k, v and g are read in place (copied where the head dim
    is padded) and dq, dk, dv are [B, H, T, D] views of [B, T, H, D]
    buffers."""
    _check(q, k, v, pe, valid_len)
    if q.device.type == "cpu":
        dq, dk, dv, dqpe = flash_rel_backward_plain(
            q, k, v, pe, valid_len, out, lse, g, causal=causal, scale=scale)
    else:
        delta = (g.float() * out.float()).sum(dim=-1)
        dq, dk, dv, dqpe = _launch_backward(q, k, v, pe, valid_len, lse, delta,
                                            g, causal, scale, mask_only=mask_only)
    dpe = None
    if not mask_only:
        dq = dq.add_(torch.matmul(dqpe, pe.float()).mul_(scale))
        if need_dpe:
            dpe = torch.einsum("bhim,bhid->md", dqpe, q.float()) * scale
            dpe = dpe.to(pe.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dpe


flash_rel_backward.launches = 0
flash_rel_backward.launches_by_form = dict.fromkeys(flash_causal.FORMS, 0)


def _forward(q, k, v, pe, valid_len, causal, scale, mask_only):
    """The plain version for CPU tensors, the kernel for CUDA ones."""
    if q.device.type == "cpu":
        return flash_rel_forward_plain(q, k, v, pe, valid_len, causal=causal, scale=scale)
    return _launch_forward(q, k, v, pe, valid_len, causal, scale, mask_only=mask_only)


class _FlashRel(torch.autograd.Function):
    """B1 forward, B3 + B4 backward (plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, pe, valid_len, causal, scale, mask_only):
        out, lse = _forward(q, k, v, pe, valid_len, causal, scale, mask_only)
        ctx.save_for_backward(q, k, v, pe, valid_len, out, lse)
        ctx.causal, ctx.scale, ctx.mask_only = causal, scale, mask_only
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, pe, valid_len, out, lse = ctx.saved_tensors
        dq, dk, dv, dpe = flash_rel_backward(
            q, k, v, pe, valid_len, out, lse, _kernel_layout(g), causal=ctx.causal,
            scale=ctx.scale, need_dpe=ctx.needs_input_grad[3], mask_only=ctx.mask_only)
        return dq, dk, dv, dpe, None, None, None, None


def _kernel_layout(g: torch.Tensor) -> torch.Tensor:
    """The cotangent as it came when B3 + B4 can read it in place (a
    contiguous head dim, strides that are multiples of 16 bytes, a 16-byte
    aligned start: the [B, T, H, 64] layout that ``merge_heads`` hands
    back), else a contiguous copy (e.g. of the stride-0 expansion of
    ``out.sum()``'s gradient)."""
    unit = 16 // g.element_size()
    if (g.stride(-1) == 1 and g.data_ptr() % 16 == 0
            and not any(s % unit for s in g.stride()[:-1])):
        return g
    return g.contiguous()


def flash_rel_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      pe: Optional[torch.Tensor], valid_len: torch.Tensor, *,
                      causal: bool, scale: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B,H,Tq,D], k/v [B,H,Tk,D], pe [2L,D] or None (mask-only),
    valid_len [B] int -> (out [B,H,Tq,D], lse [B,H,Tq] float32).  ``out``
    is differentiable in q, k, v and pe (``lse`` is not); on the card
    forward and backward take any D up to 128 (``flash_causal.HEAD_DIMS``
    in place, the rest padded)."""
    mask_only = pe is None
    if mask_only:
        pe = _zero_table(q.shape[-1], q.dtype, q.device)
    _check(q, k, v, pe, valid_len)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if flash_causal.needs_grad(q, k, v, pe):
        return _FlashRel.apply(q, k, v, pe, valid_len, causal, scale, mask_only)
    return _forward(q, k, v, pe, valid_len, causal, scale, mask_only)


flash_rel_forward.launches = 0
flash_rel_forward.launches_by_form = dict.fromkeys(flash_causal.FORMS, 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, scale: float,
                    rel_pe: Optional[torch.Tensor] = None,
                    kv_valid_len: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """[B, H, T, D] q/k/v -> [B, H, Tq, D], as the JAX package's
    ``flash_attention`` with ``causal`` and ``scale`` given: with neither
    ``rel_pe`` nor ``kv_valid_len`` it is kernel B5
    (``flash_causal.flash_forward``); otherwise kernel B1, its mask-only
    variant when ``rel_pe`` is missing, with every key valid when
    ``kv_valid_len`` is missing (lengths made once per shape, not per
    call).  Differentiable either way."""
    if rel_pe is None and kv_valid_len is None:
        out, _ = flash_causal.flash_forward(q, k, v, causal=causal, scale=scale)
        return out
    if kv_valid_len is None:
        kv_valid_len = _full_lengths(q.shape[0], k.shape[2], q.device)
    out, _ = flash_rel_forward(q, k, v, rel_pe, kv_valid_len, causal=causal,
                               scale=scale)
    return out
