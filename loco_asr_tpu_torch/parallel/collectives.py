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
  one);
* the sequence-parallel ones (``sp.py``): :func:`ring_shift` sends a
  tensor to the next rank of the group and receives the previous rank's
  (JAX's ``ppermute`` over ``(i, i+1 mod n)``; ``batch_isend_irecv``), and
  :func:`all_to_all` splits one dimension over the group and concatenates
  another (JAX's ``all_to_all(..., tiled=True)``); :func:`permute` and
  :func:`exchange` are their autograd forms, whose backwards are the
  reverse shift and the inverse all-to-all.

Host staging: gloo takes CPU tensors, so on a gloo group (ranks sharing a
card, ``launch.py``) every collective copies a CUDA tensor to host memory
and the result back.  That is decided by the mesh's backend
(``Mesh.staged``), here and nowhere else, not by catching an error.  gloo
also lacks reduce-scatter (an all-reduce and this rank's block stand in),
all-to-all in some builds (point-to-point sends stand in) and bfloat16
(moved as 2-byte floats, summed in float32 and rounded once)."""

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


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as gloo moves it: a bfloat16 tensor viewed as 2-byte floats."""
    return t.view(torch.float16) if t.dtype is torch.bfloat16 else t


def ring_shift(t: torch.Tensor, g: AxisGroup, mesh: Mesh, step: int = 1) -> torch.Tensor:
    """The tensor of the rank ``step`` places before this one in the group
    (ranks send to ``(i + step) mod n``), as a new tensor."""
    if g.group is None:
        return t
    n = g.size
    src = _wire(_host(t, mesh).contiguous())
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, g.members[(g.index + step) % n], g.group),
           dist.P2POp(dist.irecv, out, g.members[(g.index - step) % n], g.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if t.dtype is torch.bfloat16:
        out = out.view(torch.bfloat16)
    return out.to(t.device)


def all_to_all(t: torch.Tensor, g: AxisGroup, mesh: Mesh, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """Block j of ``t`` along ``split_dim`` goes to the group's rank j; the
    blocks received, in the group's order, are concatenated along
    ``concat_dim``."""
    if g.group is None:
        return t
    src = _wire(_host(t, mesh))
    parts = [p.contiguous() for p in src.chunk(g.size, dim=split_dim)]
    got = [torch.empty_like(p) for p in parts]
    if mesh.backend == "nccl":
        dist.all_to_all(got, parts, group=g.group)
    else:   # gloo: one send and one receive a peer (not every build has alltoall)
        got[g.index] = parts[g.index]
        ops = []
        for j, peer in enumerate(g.members):
            if j != g.index:
                ops += [dist.P2POp(dist.isend, parts[j], peer, g.group),
                        dist.P2POp(dist.irecv, got[j], peer, g.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    out = torch.cat(got, dim=concat_dim)
    if t.dtype is torch.bfloat16:
        out = out.view(torch.bfloat16)
    return out.to(t.device)


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


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, g, mesh, step):
        ctx.args = (g, mesh, step)
        return ring_shift(t, g, mesh, step)

    @staticmethod
    def backward(ctx, dy):
        g, mesh, step = ctx.args
        return ring_shift(dy, g, mesh, -step), None, None, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, g, mesh, split_dim, concat_dim):
        ctx.args = (g, mesh, split_dim, concat_dim)
        return all_to_all(t, g, mesh, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, dy):
        g, mesh, split_dim, concat_dim = ctx.args
        return all_to_all(dy, g, mesh, concat_dim, split_dim), None, None, None, None


def permute(t: torch.Tensor, g: AxisGroup, mesh: Mesh, step: int = 1) -> torch.Tensor:
    """:func:`ring_shift`; the backward shifts the other way."""
    return t if g.group is None else _Permute.apply(t, g, mesh, step)


def exchange(t: torch.Tensor, g: AxisGroup, mesh: Mesh, split_dim: int,
             concat_dim: int) -> torch.Tensor:
    """:func:`all_to_all`; the backward is the inverse all-to-all."""
    return t if g.group is None else _Exchange.apply(t, g, mesh, split_dim, concat_dim)


def gather(t: torch.Tensor, g: AxisGroup, dim: int, mesh: Mesh) -> torch.Tensor:
    """All-gather along ``dim``; the backward reduce-scatters."""
    return t if g.group is None else _Gather.apply(t, g, dim, mesh)


def copy_to(t: torch.Tensor, g: AxisGroup, mesh: Mesh) -> torch.Tensor:
    """Identity; the backward all-reduces (Megatron's f)."""
    return t if g.group is None else _CopyTo.apply(t, g, mesh)


def reduce_from(t: torch.Tensor, g: AxisGroup, mesh: Mesh) -> torch.Tensor:
    """All-reduce; the backward is the identity (Megatron's g)."""
    return t if g.group is None else _ReduceFrom.apply(t, g, mesh)
