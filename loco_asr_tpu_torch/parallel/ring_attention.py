"""Ring attention: exact attention over sequence blocks held by a ring of
ranks, the port of ``loco_asr_tpu.parallel.ring_attention``.

Each rank holds [B, H, T/n, D] blocks of q, k and v.  K/V blocks rotate
around the group (``collectives.ring_shift``: send to rank i+1, receive
from i-1) while each rank folds every block into an online softmax over
its queries, so one rank never holds more than a [T/n, T/n] score tile:
O(T/n) memory a rank.  Causality, key padding and the SpeechT5
relative-position term ``scale * q . pe[clip(i - j, -L, L-1) + L]`` use
global positions.  The products are ``torch.matmul`` in float32, as the
JAX blocks are einsums; masked scores are -1e30 and the normaliser is
clamped at 1e-30, as in JAX.

The backward is written out (:class:`_Ring`): the forward keeps only its
inputs, the output and each row's running max and sum; the backward runs
the ring again, recomputes each block's probabilities from them, adds this
rank's share of the block's dK/dV to accumulators that travel with the
block, and a last shift returns each block's accumulated gradient to its
owner.  Autograd through the loop would keep n score tiles a layer.

With causal attention and no key padding a block wholly in the future of
this rank's queries is skipped (it adds nothing: every row has seen its
own keys); with key padding it is computed, as JAX computes it, since a
row with no valid key averages over every block."""

from __future__ import annotations

from typing import Optional

import torch

from . import collectives as coll

NEG_INF = -1e30


def _positions(index: int, t: int, device) -> torch.Tensor:
    return index * t + torch.arange(t, device=device)


def _masked(q_pos, k_pos, causal: bool, kv_valid_len) -> Optional[torch.Tensor]:
    """True where a key is masked: [1 | B, 1, Tq | 1, Tk], or None."""
    masked = None
    if causal:
        masked = (k_pos[None, :] > q_pos[:, None])[None, None]
    if kv_valid_len is not None:
        pad = (k_pos[None, :] >= kv_valid_len.to(k_pos.device)[:, None])[:, None, None, :]
        masked = pad if masked is None else masked | pad
    return masked


def _band(q_pos, k_pos, two_l: int) -> torch.Tensor:
    """[Tq, Tk] column ``clip(i - j, -L, L-1) + L`` of the q.pe table."""
    L = two_l // 2
    return torch.clamp(q_pos[:, None] - k_pos[None, :], -L, L - 1) + L


def _scores(q, k, qpe, q_pos, k_pos, scale: float, causal: bool, kv_valid_len):
    """Float32 scores of this rank's queries against one K block, masked
    to -1e30, and the mask."""
    s = torch.matmul(q, k.float().transpose(-1, -2)) * scale
    if qpe is not None:
        idx = _band(q_pos, k_pos, qpe.shape[-1])
        s = s + torch.gather(qpe, -1, idx.expand(*qpe.shape[:-1], k.shape[2]))
    masked = _masked(q_pos, k_pos, causal, kv_valid_len)
    if masked is not None:
        s = s.masked_fill(masked, NEG_INF)
    return s, masked


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, pe, kv_valid_len, sp, causal, scale):
        n, me = sp.size, sp.index
        b, h, t, d = q.shape
        skip = causal and kv_valid_len is None
        qf = q.float()
        q_pos = _positions(me, t, q.device)
        qpe = None
        if pe is not None:
            qs = (q * scale).to(q.dtype).float()
            qpe = torch.matmul(qs, pe.to(q.dtype).float().t())        # [B, H, T, 2L]
        acc = q.new_zeros((b, h, t, d), dtype=torch.float32)
        m = q.new_full((b, h, t, 1), NEG_INF, dtype=torch.float32)
        l = q.new_zeros((b, h, t, 1), dtype=torch.float32)
        kv = torch.stack([k, v])
        for i in range(n):
            src = (me - i) % n
            if not (skip and src > me):
                k_pos = _positions(src, t, q.device)
                s, _ = _scores(qf, kv[0], qpe, q_pos, k_pos, scale, causal, kv_valid_len)
                m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                p = torch.exp(s - m_new)
                alpha = torch.exp(m - m_new)
                l = alpha * l + p.sum(dim=-1, keepdim=True)
                acc = acc * alpha + torch.matmul(p, kv[1].float())
                m = m_new
            if i < n - 1:
                kv = coll.ring_shift(kv, sp.group, sp.mesh)
        out = acc / torch.clamp(l, min=1e-30)
        ctx.save_for_backward(q, k, v, pe, kv_valid_len, out, m, l)
        ctx.args = (sp, causal, scale)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, pe, kv_valid_len, out, m, l = ctx.saved_tensors
        sp, causal, scale = ctx.args
        n, me = sp.size, sp.index
        t = q.shape[2]
        skip = causal and kv_valid_len is None
        qf, g = q.float(), dout.float()
        q_pos = _positions(me, t, q.device)
        qs = qpe = None
        if pe is not None:
            qs = (q * scale).to(q.dtype).float()
            qpe = torch.matmul(qs, pe.to(q.dtype).float().t())
        delta = (g * out).sum(dim=-1, keepdim=True)
        lc = torch.clamp(l, min=1e-30)
        dq = torch.zeros_like(qf)
        bins = torch.zeros_like(qpe) if pe is not None else None
        kv = torch.stack([k, v])
        dkv = torch.zeros((2,) + tuple(k.shape), dtype=torch.float32, device=k.device)
        for i in range(n):
            src = (me - i) % n
            if not (skip and src > me):
                k_pos = _positions(src, t, q.device)
                kb, vb = kv[0].float(), kv[1].float()
                s, masked = _scores(qf, kb, qpe, q_pos, k_pos, scale, causal, kv_valid_len)
                p = torch.exp(s - m) / lc
                dkv[1] += torch.matmul(p.transpose(-1, -2), g)
                ds = p * (torch.matmul(g, vb.transpose(-1, -2)) - delta)
                if masked is not None:
                    ds = ds.masked_fill(masked, 0.0)
                dq += torch.matmul(ds, kb) * scale
                dkv[0] += torch.matmul(ds.transpose(-1, -2), qf) * scale
                if pe is not None:
                    idx = _band(q_pos, k_pos, qpe.shape[-1])
                    bins.scatter_add_(-1, idx.expand(*qpe.shape[:-1], kb.shape[2]), ds)
            if i < n - 1:
                kv = coll.ring_shift(kv, sp.group, sp.mesh)
            dkv = coll.ring_shift(dkv, sp.group, sp.mesh)
        dpe = None
        if pe is not None:
            dq += torch.matmul(bins, pe.to(q.dtype).float()) * scale
            dpe = torch.einsum("bhic,bhid->cd", bins, qs).to(pe.dtype)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype), dpe,
                None, None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, sp,
                   causal: bool = True, scale: Optional[float] = None,
                   kv_valid_len: Optional[torch.Tensor] = None,
                   rel_pe: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact attention of this rank's [B, H, T/n, D] q/k/v blocks (block
    ``sp.index`` of the sequence) over the whole sequence of the group
    ``sp`` (``sp.SequenceParallel``); returns this rank's [B, H, T/n, D]
    output.

    ``kv_valid_len``: [B] global valid-key counts (right padding) or None.
    ``rel_pe``: [2L, D] relative-position key table (the rel term
    ``scale * q . pe[clip(i - j, -L, L-1) + L]`` with global i, j, L half
    its rows), or None."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _Ring.apply(q, k, v, rel_pe, kv_valid_len, sp, causal, float(scale))
