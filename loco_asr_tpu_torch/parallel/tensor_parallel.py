"""Sharded parameters in use: FSDP gathers and Megatron tensor parallelism
inside the models, on the layouts of ``partition.TRANSFORMER_RULES``.

A sharded parameter holds this rank's block (:class:`ParamShard` records
its global shape and spec).  Its module computes in one of three roles
(:class:`LinearShard`):

* ``column`` (q/k/v projections, ``intermediate_dense``, GPT-2 ``c_attn``
  and ``c_fc``): the weight is gathered over every axis but the tensor
  axis of its output dimension; the layer computes this rank's output
  columns (its heads).  The block's input passes :func:`enter` first, the
  identity whose backward all-reduces over tensor (Megatron's f).
* ``row`` (``out_proj``, ``output_dense``, ``attn.c_proj``,
  ``mlp.c_proj``): the layer computes on its input columns, all-reduces
  over tensor (Megatron's g), then adds the replicated bias once.
* ``whole`` (every other sharded parameter, and any block whose heads or
  width do not divide the tensor axis): gathered whole just before use.

``partition.shard_params`` gives each sharded module a subclass of its own
class that computes this way: :class:`ShardedLinear` (a dense layer),
:class:`ShardedEmbedding` (a table lookup) and :class:`TensorParallelBlock`
(an attention or feed-forward block whose heads or width the tensor axis
splits: its ``enter`` is Megatron's f), so the layers below know nothing
of the mesh.

The gathers run inside ``torch.autograd.Function``s that keep only the
shards for the backward and gather again there (:func:`linear`,
:func:`embedding`), so beyond its shards a rank holds one layer's weights
at a time, as FSDP does.  A gather's adjoint reduce-scatters over the
data-like axes (each rank's rows gave part of the gradient) and takes this
rank's block over tensor (the tensor ranks computed the same rows alike).
:func:`weight` gives a whole parameter as an autograd op, for the uses
that are not a product (position tables, the tied lm head)."""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops import act_sharding
from . import collectives as coll
from .mesh import AXES, Mesh, axis_names


@dataclasses.dataclass
class ParamShard:
    """A parameter's global ``shape`` and ``spec`` (port layout) on
    ``mesh``; ``interleave`` > 1 marks a fused projection (GPT-2's
    ``c_attn``: q | k | v) whose tensor blocks hold every part's columns
    of their heads, so dimension ``interleave_dim`` is permuted before it
    is split."""

    mesh: Mesh
    shape: Tuple[int, ...]
    spec: Tuple
    interleave: int = 1
    interleave_dim: int = -1

    def steps(self, keep: Optional[int] = None) -> List[Tuple[int, str]]:
        """(dim, axis) gathers that rebuild the tensor, innermost axis of a
        dimension first; ``keep`` leaves the tensor axis of that dimension
        sharded."""
        out = []
        for dim, entry in enumerate(self.spec):
            for axis in reversed(axis_names(entry)):
                if self.mesh.size(axis) > 1 and not (dim == keep and axis == AXES.tensor):
                    out.append((dim, axis))
        return out

    def gather(self, t: torch.Tensor, keep: Optional[int] = None) -> torch.Tensor:
        for dim, axis in self.steps(keep):
            t = coll.all_gather(t, self.mesh.groups[axis], dim, self.mesh)
        return t

    def adjoint(self, dt: torch.Tensor, keep: Optional[int] = None) -> torch.Tensor:
        for dim, axis in reversed(self.steps(keep)):
            g = self.mesh.groups[axis]
            dt = (coll.block(dt, g, dim) if axis == AXES.tensor
                  else coll.reduce_scatter(dt, g, dim, self.mesh))
        return dt

    def _perm(self, device) -> Optional[torch.Tensor]:
        """Global index order of the interleaved dimension: tensor block t
        holds block t of each of the ``interleave`` parts."""
        if self.interleave == 1:
            return None
        n = self.shape[self.interleave_dim]
        tp = self.mesh.size(AXES.tensor)
        idx = torch.arange(n, device=device).reshape(self.interleave, tp, -1)
        return idx.transpose(0, 1).reshape(-1)

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global tensor ``full``."""
        perm = self._perm(full.device)
        if perm is not None:
            full = full.index_select(self.interleave_dim, perm)
        for dim, entry in enumerate(self.spec):
            for axis in axis_names(entry):
                n = full.shape[dim] // self.mesh.size(axis)
                full = full.narrow(dim, self.mesh.index(axis) * n, n)
        return full.clone(memory_format=torch.contiguous_format)   # not a view of ``full``

    def full(self, shard: torch.Tensor) -> torch.Tensor:
        """The global tensor, in its original layout (every rank)."""
        t = self.gather(shard)
        perm = self._perm(t.device)
        if perm is not None:
            t = t.index_select(self.interleave_dim, torch.argsort(perm))
        return t


@dataclasses.dataclass
class LinearShard:
    """A dense layer's role and its parameters' shards; ``transposed``:
    the weight is ``[in, out]`` (GPT-2's Conv1D) rather than ``[out, in]``."""

    role: str
    weight: ParamShard
    bias: Optional[ParamShard]
    transposed: bool = False

    @property
    def keep(self) -> Optional[int]:
        out_dim = 1 if self.transposed else 0
        return {"column": out_dim, "row": 1 - out_dim}.get(self.role)

    @property
    def bias_keep(self) -> Optional[int]:
        return 0 if self.role == "column" else None


class _Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, tp: LinearShard):
        ctx.tp = tp
        ctx.save_for_backward(x, w, b)
        wf = tp.weight.gather(w, tp.keep)
        dt = torch.promote_types(x.dtype, w.dtype)
        wf = (wf.t() if tp.transposed else wf).to(dt)
        bias = None if b is None else tp.bias.gather(b, tp.bias_keep).to(dt)
        if tp.role == "row":
            y = F.linear(x.to(dt), wf)
            y = coll.all_reduce(y, tp.weight.mesh.groups[AXES.tensor], tp.weight.mesh)
            return y if bias is None else y + bias
        return F.linear(x.to(dt), wf, bias)

    @staticmethod
    def backward(ctx, dy):
        x, w, b = ctx.saved_tensors
        tp: LinearShard = ctx.tp
        dt = dy.dtype
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            wf = tp.weight.gather(w, tp.keep)
            wf = (wf.t() if tp.transposed else wf).to(dt)
            dx = (dy @ wf).to(x.dtype)
        if ctx.needs_input_grad[1]:
            x2, dy2 = x.reshape(-1, x.shape[-1]).to(dt), dy.reshape(-1, dy.shape[-1])
            g = dy2.t() @ x2                                     # [out, in]
            g = g.t() if tp.transposed else g
            dw = tp.weight.adjoint(g.to(w.dtype).contiguous(), tp.keep)
        if b is not None and ctx.needs_input_grad[2]:
            db = tp.bias.adjoint(dy.reshape(-1, dy.shape[-1]).sum(0).to(b.dtype),
                                 tp.bias_keep)
        return dx, dw, db, None


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           tp: LinearShard) -> torch.Tensor:
    """A dense layer on sharded parameters, in its ``tp.role``; in the
    promotion of the input's and weight's dtypes, as ``layers.dense``."""
    return _Linear.apply(x, weight, bias, tp)


class _Embedding(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids, w, ps: ParamShard):
        ctx.ps = ps
        ctx.save_for_backward(ids)
        ctx.dtype = w.dtype
        return F.embedding(ids, ps.gather(w))

    @staticmethod
    def backward(ctx, dy):
        (ids,) = ctx.saved_tensors
        ps: ParamShard = ctx.ps
        # summed in float32 whatever the table's dtype: a token's rows add up
        full = dy.new_zeros(ps.shape, dtype=torch.float32).index_add_(
            0, ids.reshape(-1), dy.reshape(-1, ps.shape[1]).float())
        return None, ps.adjoint(full.to(ctx.dtype)), None


def embedding(ids: torch.Tensor, weight: torch.Tensor, ps: ParamShard) -> torch.Tensor:
    """Table lookup on a sharded table, gathered whole for the lookup."""
    return _Embedding.apply(ids, weight, ps)


class _Whole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, ps: ParamShard):
        ctx.ps = ps
        return ps.gather(w)

    @staticmethod
    def backward(ctx, dy):
        return ctx.ps.adjoint(dy.contiguous()), None


def weight(module: torch.nn.Module, name: str = "weight") -> torch.Tensor:
    """``module``'s parameter ``name``, gathered whole when it is sharded
    (an autograd op whose backward is the gather's adjoint)."""
    t = getattr(module, name)
    ps = getattr(module, "_shards", {}).get(name)
    return t if ps is None else _Whole.apply(t, ps)


def is_sharded(module: torch.nn.Module) -> bool:
    """Whether any of ``module``'s own parameters is split on its mesh."""
    return bool(getattr(module, "_shards", None))


class ShardedLinear:
    """A dense layer (``layers.Dense``, GPT-2's ``Conv1D``) on sharded
    parameters: :func:`linear` in its role ``_tp``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias, self._tp)


class ShardedEmbedding:
    """An ``nn.Embedding`` on a sharded table: :func:`embedding`."""

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return embedding(ids, self.weight, self._shards["weight"])


class TensorParallelBlock:
    """A block split over the tensor axis (``tp`` ranks on ``_mesh``): the
    input of its heads is the identity whose backward all-reduces over
    tensor (each tensor rank gives its heads' part)."""

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return coll.copy_to(x, self._mesh.groups[AXES.tensor], self._mesh)


@functools.lru_cache(maxsize=None)
def _subclass(cls: type, role: type) -> type:
    return type(f"{role.__name__}[{cls.__name__}]", (role, cls), {})


def become(module: torch.nn.Module, role: type, **attrs) -> None:
    """Give ``module`` the subclass of its class that computes in ``role``
    (one of the three classes above), with ``attrs`` set."""
    module.__class__ = _subclass(type(module), role)
    for k, v in attrs.items():
        setattr(module, k, v)


def global_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``t`` in global order (an all-gather over the
    batch axes of the active ``act_sharding.activation_mesh``, outside
    autograd); ``t`` itself without one."""
    active = act_sharding.active()
    if active is None or not active[1]:
        return t
    mesh, _ = active
    return coll.all_gather(t, mesh.dp, 0, mesh)

