"""The collectives of the mesh (``mesh.py``), written out where the JAX
package leaves them to GSPMD.

Each runs over one :class:`~.mesh.AxisGroup` (the ranks along one mesh
axis, or along data x fsdp) and is the identity on a group of one rank.
Blocks are concatenated and split in the group's grid order.

* :func:`all_gather`, :func:`reduce_scatter` and :func:`all_reduce` act on
  tensors, outside autograd;
* :func:`gather`, :func:`copy_to` and :func:`reduce_from` are the
  ``torch.autograd.Function`` forms, each with its adjoint in the
  backward: all-gather forward <-> reduce-scatter backward; identity
  forward <-> all-reduce backward (the input of a column-parallel layer);
  all-reduce forward <-> identity backward (the output of a row-parallel
  one).

Host staging: gloo takes CPU tensors, so on a gloo group (ranks sharing a
card, ``launch.py``) every collective copies a CUDA tensor to host memory
and the result back.  That is decided by the mesh's backend
(``Mesh.staged``), here and nowhere else, not by catching an error.  gloo
also lacks reduce-scatter (an all-reduce and this rank's block stand in)
and bfloat16 sums (summed in float32, rounded once)."""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from .mesh import AxisGroup, Mesh


def _host(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return t.cpu() if mesh.staged and t.is_cuda else t


def all_gather(t: torch.Tensor, g: AxisGroup, dim: int, mesh: Mesh) -> torch.Tensor:
    """The group's blocks of ``t`` concatenated along ``dim``."""
    if g.group is None:
        return t
    src = _host(t, mesh).contiguous()
    if mesh.backend == "nccl":
        moved = src.movedim(dim, 0).contiguous()
        out = moved.new_empty((moved.shape[0] * g.size,) + moved.shape[1:])
        dist.all_gather_into_tensor(out, moved, group=g.group)
        return out.movedim(0, dim)
    if src.dtype is torch.bfloat16:      # moved bit for bit, as 2-byte floats gloo takes
        parts = [torch.empty_like(src.view(torch.float16)) for _ in range(g.size)]
        dist.all_gather(parts, src.view(torch.float16), group=g.group)
        parts = [p.view(torch.bfloat16) for p in parts]
    else:
        parts = [torch.empty_like(src) for _ in range(g.size)]
        dist.all_gather(parts, src, group=g.group)
    return torch.cat(parts, dim=dim).to(t.device)


def all_reduce(t: torch.Tensor, g: AxisGroup, mesh: Mesh,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The group's ``op`` (sum by default) of ``t``, as a new tensor."""
    if g.group is None:
        return t
    src = _host(t, mesh)
    narrow = src.dtype is torch.bfloat16 and mesh.backend != "nccl"
    buf = src.float() if narrow else src.clone()
    dist.all_reduce(buf, op=op, group=g.group)
    return buf.to(device=t.device, dtype=t.dtype)


def reduce_scatter(t: torch.Tensor, g: AxisGroup, dim: int, mesh: Mesh) -> torch.Tensor:
    """This rank's block along ``dim`` of the group's sum of ``t``."""
    if g.group is None:
        return t
    n = t.shape[dim] // g.size
    if mesh.backend == "nccl":
        moved = t.movedim(dim, 0).contiguous()
        out = moved.new_empty((n,) + moved.shape[1:])
        dist.reduce_scatter_tensor(out, moved, group=g.group)
        return out.movedim(0, dim)
    return all_reduce(t, g, mesh).narrow(dim, g.index * n, n).contiguous()


def block(t: torch.Tensor, g: AxisGroup, dim: int) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` (no communication)."""
    if g.group is None:
        return t
    n = t.shape[dim] // g.size
    return t.narrow(dim, g.index * n, n).contiguous()


def all_gather_objects(obj, g: AxisGroup) -> List:
    """The group's picklable objects, in grid order."""
    if g.group is None:
        return [obj]
    out = [None] * g.size
    dist.all_gather_object(out, obj, group=g.group)
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, g, dim, mesh):
        ctx.args = (g, dim, mesh)
        return all_gather(t, g, dim, mesh)

    @staticmethod
    def backward(ctx, dy):
        g, dim, mesh = ctx.args
        return reduce_scatter(dy, g, dim, mesh), None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, g, mesh):
        ctx.args = (g, mesh)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, dy):
        g, mesh = ctx.args
        return all_reduce(dy, g, mesh), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, g, mesh):
        return all_reduce(t, g, mesh)

    @staticmethod
    def backward(ctx, dy):
        return dy, None, None


def gather(t: torch.Tensor, g: AxisGroup, dim: int, mesh: Mesh) -> torch.Tensor:
    """All-gather along ``dim``; the backward reduce-scatters."""
    return t if g.group is None else _Gather.apply(t, g, dim, mesh)


def copy_to(t: torch.Tensor, g: AxisGroup, mesh: Mesh) -> torch.Tensor:
    """Identity; the backward all-reduces (Megatron's f)."""
    return t if g.group is None else _CopyTo.apply(t, g, mesh)


def reduce_from(t: torch.Tensor, g: AxisGroup, mesh: Mesh) -> torch.Tensor:
    """All-reduce; the backward is the identity (Megatron's g)."""
    return t if g.group is None else _ReduceFrom.apply(t, g, mesh)
