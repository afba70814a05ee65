"""ASR and LM training steps, as ``loco_asr_tpu.parallel.train``'s
``adamw``, ``make_asr_train_step`` and ``make_lm_train_step`` compute them:
on one device, or with ``mesh=`` sharded over a (data, fsdp, tensor) mesh
of ranks (``mesh.py``).

* :func:`adamw` -- optax's ``adamw`` (b1 0.9, b2 0.999, eps 1e-8,
  decoupled weight decay on every trainable tensor) with the JAX
  package's warmup-cosine schedule and optional global-norm clipping
  before the moment updates, applied in place with ``torch._foreach_*``;
  ``mu_dtype=torch.bfloat16`` stores the first moment in bf16 in optax's
  order (updated from the float32 gradient, the step built from the
  float32 moment, the moment then stored rounded).
* :func:`adafactor` -- the JAX ``adafactor``: optax's factored second
  moments (no first moment), block-RMS clipping, the same schedule, the
  learning-rate-scaled decoupled decay and optional global-norm clipping.
  :func:`load_opt_state`, :func:`host_snapshot` and
  :func:`restore_snapshot` read back a checkpoint's, copy to the host and
  put back either optimizer's state (``--resume`` and NaN rollback).
* :func:`cast_compute` -- mixed precision, the JAX ``_cast_compute``:
  inside the differentiated loss the float parameters and batch entries
  are cast to the compute dtype (bf16 copies swapped in for the call by
  ``torch.func.functional_call``), so gradients come back through the
  casts in float32 and the master parameters and optimizer state stay
  float32.  Norms, the attention kernels' softmax and sums, and the
  losses' log-softmax reduce in float32 whatever the compute dtype.
* :func:`reference_adam` -- torch ``Adam(lr, weight_decay)`` (L2 added to
  the gradients before the moments), the JAX ``reference_adam`` of the
  intent classifier, on the same in-place update as :func:`adamw`.
* :func:`make_asr_train_step` -- loss -> backward -> update.  Non-dense
  attention zeroes ``attention_dropout`` with the JAX package's
  ``UserWarning`` (the kernels carry no attention-prob dropout);
  ``grad_accum`` sums ``nll_sum`` gradients over a strided split of the
  batch and divides once by the total token count (exactly the full-batch
  token mean); ``freeze_feature_encoder`` gives the conv stack neither
  gradients nor updates, weight decay included; ``compute_dtype`` runs
  the loss under :func:`cast_compute`; ``remat`` runs the encoder layers
  under a policy of ``ops/remat.py``.
* :func:`make_lm_train_step` -- the GPT-2 causal-LM step: token-mean NLL
  over tokens 1..len-1 of each row, the lm head chunked with recompute
  (default) or dense; ``attn_impl="flash"`` zeroes ``attn_pdrop`` with the
  same warning and runs kernel B6 (B5 where the head dim is not 64 or the
  head count is odd) and its blockwise backward; ``grad_accum``,
  ``compute_dtype`` and ``remat`` (over the blocks) as above.
* With a mesh (``mesh=``; the model sharded by ``partition.shard_params``,
  the batch this rank's rows from :func:`shard_batch`) each step computes
  what JAX's pinned sharded step computes: ``nll_sum`` and ``ntokens`` are
  summed over data x fsdp before the one division (under ``grad_accum``
  too, on the same strided split of the global batch); gradients of
  fsdp-sharded parameters are reduce-scattered in the backward
  (``tensor_parallel.py``), every gradient is then summed over the data
  axes its parameter is replicated on; the global norm counts each element
  once; AdamW updates the local shards, and Adafactor reduces its factored
  row / column statistics and its block RMS across the shard axes first,
  so they are the whole matrix's.  Dropout and SpecAugment draw the
  single-device step's masks (``ops/act_sharding.py``).  :func:`pad_batch`,
  :func:`shard_batch`, :func:`init_sharded`, :func:`gather_opt_state` and
  :func:`load_opt_state` (``layout=``) complete it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import warnings
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..models.gpt2 import model as g
from ..models.speecht5 import model as st5
from ..models.speecht5.config import SpeechT5Config
from ..ops.act_sharding import activation_mesh
from ..ops.remat import RematSpec
from ..utils.checkpoint import flatten
from . import collectives as coll
from . import partition
from .mesh import AXES, AxisGroup, Mesh, data_sharding
from . import tensor_parallel
from .tensor_parallel import ParamShard

Layout = Optional[Mapping[str, ParamShard]]

FROZEN_PREFIX = "encoder.prenet.feature_encoder."
B1, B2, EPS = 0.9, 0.999, 1e-8          # optax.adamw's defaults

OptState = Dict[str, object]


class Optimizer:
    """The JAX optimizers' learning-rate schedule and gradient clipping.

    ``learning_rate_at(count)`` is optax's ``warmup_cosine_decay_schedule(
    0, lr, warmup, total)`` when ``warmup_steps`` or ``total_steps`` is
    given (warmup clamped below the total, as the JAX ``adamw`` and
    ``adafactor`` do), else the constant ``lr``; step n (counting from 1)
    uses the rate at n-1.  ``clip_norm`` scales the gradients down to that
    global norm first (``optax.clip_by_global_norm``)."""

    def __init__(self, learning_rate: float, weight_decay: float, warmup_steps: int,
                 total_steps: Optional[int], clip_norm: Optional[float]):
        self.lr, self.weight_decay, self.clip_norm = learning_rate, weight_decay, clip_norm
        self.scheduled = bool(warmup_steps or total_steps)
        self.total = total_steps or warmup_steps * 10
        self.warmup = min(warmup_steps, max(self.total - 1, 0))

    def learning_rate_at(self, count: int) -> float:
        if not self.scheduled:
            return self.lr
        if count < self.warmup:
            return self.lr * count / self.warmup
        decay = self.total - self.warmup
        t = min(count - self.warmup, decay)
        return self.lr * 0.5 * (1.0 + math.cos(math.pi * t / decay)) if decay > 0 else self.lr

    def _gradients(self, params: Mapping[str, torch.Tensor],
                   grads: Mapping[str, Optional[torch.Tensor]],
                   norm: Optional[torch.Tensor] = None):
        """(names, parameters, gradients: None as zeros, clipped by their
        global ``norm``, computed here when not given)."""
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] if grads.get(k) is not None else torch.zeros_like(params[k])
             for k in names]
        if self.clip_norm is not None:
            norm = global_norm(g) if norm is None else norm
            factor = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                                 self.clip_norm / norm)
            g = torch._foreach_mul(g, factor)
        return names, p, g


class AdamW(Optimizer):
    """AdamW over a dict of named tensors, updated in place, on the
    schedule of :class:`Optimizer`."""

    def __init__(self, learning_rate: float = 1e-4, weight_decay: float = 0.01,
                 warmup_steps: int = 0, total_steps: Optional[int] = None,
                 clip_norm: Optional[float] = None,
                 mu_dtype: Optional[torch.dtype] = None):
        super().__init__(learning_rate, weight_decay, warmup_steps, total_steps, clip_norm)
        self.mu_dtype = mu_dtype

    def init(self, params: Mapping[str, torch.Tensor], layout: Layout = None) -> OptState:
        return {"count": 0,
                "mu": {k: torch.zeros_like(p, dtype=self.mu_dtype) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def state_shards(self, ps: ParamShard) -> Dict[str, Optional[ParamShard]]:
        """The shard of each of a parameter's state tensors."""
        return {"mu": ps, "nu": ps}

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor],
               grads: Mapping[str, Optional[torch.Tensor]], state: OptState,
               norm: Optional[torch.Tensor] = None, layout: Layout = None) -> None:
        """One step on ``params`` (in place) from ``grads`` (None = zeros);
        ``norm``: their global norm (a sharded step's), for clipping."""
        names, p, g = self._gradients(params, grads, norm)
        stored = [state["mu"][k] for k in names]
        narrow = any(m.dtype != x.dtype for m, x in zip(stored, g))
        if narrow:
            # optax's order for a narrower stored moment: decay * mu in the
            # stored dtype, with the decay itself in that dtype (JAX's weak
            # typing makes 0.9 * a bf16 array a bf16 product by 0.8984375),
            # (1 - decay) * g added in the gradient's dtype, the step built
            # from that, the moment stored rounded at the end
            mu = [(m * _in_dtype(B1, m.dtype)).to(x.dtype) for m, x in zip(stored, g)]
        else:
            mu = stored
            torch._foreach_mul_(mu, B1)
        nu = [state["nu"][k] for k in names]
        torch._foreach_add_(mu, g, alpha=1.0 - B1)
        torch._foreach_mul_(nu, B2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - B2)
        lr = self.learning_rate_at(state["count"])
        state["count"] += 1
        n = state["count"]
        upd = torch._foreach_div(mu, 1.0 - B1 ** n)
        den = torch._foreach_div(nu, 1.0 - B2 ** n)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, EPS)
        torch._foreach_div_(upd, den)
        if self.weight_decay:
            torch._foreach_add_(upd, p, alpha=self.weight_decay)
        torch._foreach_add_(p, upd, alpha=-lr)
        if narrow:
            for s, m in zip(stored, mu):
                s.copy_(m)


def adamw(learning_rate: float = 1e-4, weight_decay: float = 0.01,
          warmup_steps: int = 0, total_steps: Optional[int] = None,
          clip_norm: Optional[float] = None,
          mu_dtype: Optional[torch.dtype] = None) -> AdamW:
    """AdamW with warmup-cosine schedule and optional global-norm clipping
    (the JAX ``adamw``); ``mu_dtype`` (e.g. ``torch.bfloat16``) stores the
    first moment in that dtype, the second stays in the parameters'."""
    return AdamW(learning_rate, weight_decay, warmup_steps, total_steps, clip_norm,
                 mu_dtype)


class Adafactor(Optimizer):
    """What the JAX ``adafactor`` computes (``optax.adafactor(learning_rate=
    sched, multiply_by_parameter_scale=False, momentum=None,
    weight_decay_rate=None)`` at optax's other defaults, then the decoupled
    decay, with global-norm clipping in front), over a dict of named
    tensors, updated in place, on the schedule of :class:`Optimizer`.

    Per tensor, with d = 1 - (t+1)^-0.8 at step index t (0 first) and
    g2 = g^2 + 1e-30: where the two largest dims (``numpy.argsort`` order)
    are both >= 128 the second moment is factored, a row statistic
    ``v_row`` (g2's mean over the largest dim) and a column one ``v_col``
    (over the second largest), each ``d * old + (1 - d) * new``, and
    u = g (v_row / mean(v_row))^-1/2 v_col^-1/2; else the full second
    moment ``v`` and u = g v^-1/2.  Then u / max(1, rms(u)) (optax's
    ``clip_by_block_rms(1)``), and p <- p - lr_t u - lr_t wd p.  State: the
    count and, per tensor, ``v_row``, ``v_col`` and ``v`` as optax keeps
    them (a (1,) zero where a form is not used), in the parameter's dtype:
    a + b floats for an [a, b] matrix where AdamW keeps 2ab."""

    MIN_DIM_TO_FACTOR, DECAY_RATE, EPS = 128, 0.8, 1e-30

    @classmethod
    def factored_dims(cls, shape) -> Optional[tuple]:
        """(second largest dim, largest dim), or None where the moment is
        kept whole (optax's ``_factored_dims``)."""
        if len(shape) < 2:
            return None
        order = np.argsort(shape)
        if shape[order[-2]] < cls.MIN_DIM_TO_FACTOR:
            return None
        return int(order[-2]), int(order[-1])

    def init(self, params: Mapping[str, torch.Tensor], layout: Layout = None) -> OptState:
        """State of the (local shards of) ``params``; ``layout``: their
        shards, whose global shapes decide the factoring."""
        state = {"count": 0, "v_row": {}, "v_col": {}, "v": {}}
        for k, p in params.items():
            dims = self.factored_dims(_global_shape(p, layout, k))
            one = lambda: torch.zeros(1, dtype=p.dtype, device=p.device)
            if dims is None:
                state["v_row"][k], state["v_col"][k] = one(), one()
                state["v"][k] = torch.zeros_like(p)
            else:
                d1, d0 = dims
                shape = list(p.shape)
                state["v_row"][k] = p.new_zeros(shape[:d0] + shape[d0 + 1:])
                state["v_col"][k] = p.new_zeros(shape[:d1] + shape[d1 + 1:])
                state["v"][k] = one()
        return state

    def state_shards(self, ps: ParamShard) -> Dict[str, Optional[ParamShard]]:
        dims = self.factored_dims(ps.shape)
        if dims is None:
            return {"v_row": None, "v_col": None, "v": ps}
        d1, d0 = dims
        return {"v_row": _drop_dim(ps, d0), "v_col": _drop_dim(ps, d1), "v": None}

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor],
               grads: Mapping[str, Optional[torch.Tensor]], state: OptState,
               norm: Optional[torch.Tensor] = None, layout: Layout = None) -> None:
        """One step on ``params`` (in place) from ``grads`` (None = zeros);
        ``norm``: their global norm (a sharded step's), for clipping;
        ``layout``: the parameters' shards, across which the means run."""
        names, p, g = self._gradients(params, grads, norm)
        t = torch.tensor(state["count"] + 1, dtype=torch.float32)
        decay = float(1.0 - t ** -self.DECAY_RATE)     # float32, as optax
        lr = self.learning_rate_at(state["count"])
        state["count"] += 1
        for k, param, grad in zip(names, p, g):
            ps = None if layout is None else layout.get(k)
            mean = functools.partial(_sharded_mean, ps)
            g2 = grad * grad + self.EPS
            dims = self.factored_dims(_global_shape(param, layout, k))
            if dims is None:
                v = state["v"][k]
                v.mul_(decay).add_(g2, alpha=1.0 - decay)
                u = grad * v.rsqrt()
            else:
                d1, d0 = dims
                v_row, v_col = state["v_row"][k], state["v_col"][k]
                v_row.mul_(decay).add_(mean(g2, d0), alpha=1.0 - decay)
                v_col.mul_(decay).add_(mean(g2, d1), alpha=1.0 - decay)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_mean = mean(v_row, reduced_d1, keepdim=True, param_dim=d1)
                row = (v_row / row_mean).rsqrt()
                u = grad * row.unsqueeze(d0) * v_col.rsqrt().unsqueeze(d1)
            u = u / torch.clamp(mean(u.square(), None).sqrt(), min=1.0) * -lr
            if self.weight_decay:   # on the parameter before this step
                u.sub_(param, alpha=lr * self.weight_decay)
            param.add_(u)


def adafactor(learning_rate: float = 1e-3, weight_decay: float = 0.01,
              warmup_steps: int = 0, total_steps: Optional[int] = None,
              clip_norm: Optional[float] = None) -> Adafactor:
    """Adafactor with the warmup-cosine schedule, the learning-rate-scaled
    decoupled weight decay and optional global-norm clipping (the JAX
    ``adafactor``): no first moment, factored second moments."""
    return Adafactor(learning_rate, weight_decay, warmup_steps, total_steps, clip_norm)


def _global_shape(p: torch.Tensor, layout: Layout, name: str) -> tuple:
    ps = None if layout is None else layout.get(name)
    return tuple(p.shape) if ps is None else ps.shape


def _drop_dim(ps: ParamShard, dim: int) -> ParamShard:
    """The shard of a statistic that reduces parameter dimension ``dim``."""
    return ParamShard(ps.mesh, ps.shape[:dim] + ps.shape[dim + 1:],
                      ps.spec[:dim] + ps.spec[dim + 1:])


def axes_group(mesh: Mesh, axes) -> AxisGroup:
    """The group of the ranks that differ along ``axes`` (fsdp, tensor or
    both; the mesh's groups)."""
    axes = {a for a in axes if mesh.size(a) > 1}
    if not axes:
        return AxisGroup(None, (mesh.rank,), 0)
    if axes == {AXES.fsdp, AXES.tensor}:
        return mesh.model
    if len(axes) == 1:
        return mesh.groups[axes.pop()]
    raise ValueError(f"no group of the axes {sorted(axes)}")


def _sharded_mean(ps: Optional[ParamShard], x: torch.Tensor, dim: Optional[int],
                  keepdim: bool = False, param_dim: Optional[int] = None) -> torch.Tensor:
    """``x.mean(dim)`` (every element for None) of the whole tensor whose
    shard ``x`` is (``ps``: the parameter's shard; ``param_dim``: the
    parameter dimension that ``dim`` of ``x`` is, when they differ)."""
    if ps is None:
        return x.mean() if dim is None else x.mean(dim=dim, keepdim=keepdim)
    if dim is None:
        axes = partition.sharded_axes(ps)
        n = float(np.prod(ps.shape))
        s = x.sum()
    else:
        pd = dim if param_dim is None else param_dim
        axes = tuple(a for a in partition.axis_names(ps.spec[pd]) if ps.mesh.size(a) > 1)
        n = float(ps.shape[pd])
        s = x.sum(dim=dim, keepdim=keepdim)
    if not axes:
        return x.mean() if dim is None else x.mean(dim=dim, keepdim=keepdim)
    return coll.all_reduce(s, axes_group(ps.mesh, axes), ps.mesh) / n


def _in_dtype(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``, as a Python float."""
    return float(torch.tensor(x, dtype=dtype))


class ReferenceAdam(AdamW):
    """torch ``Adam(lr, weight_decay)``: the L2 term ``weight_decay * p`` is
    added to the gradient before the moment updates (optax
    ``add_decayed_weights``, ``scale_by_adam``, ``scale(-lr)``); constant
    rate, eps 1e-8, no clipping."""

    def __init__(self, learning_rate: float = 1e-3, weight_decay: float = 1e-4):
        super().__init__(learning_rate, weight_decay=0.0)
        self.l2 = weight_decay

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor],
               grads: Mapping[str, Optional[torch.Tensor]], state: OptState,
               **kw) -> None:
        g = {k: (grads[k] if grads.get(k) is not None else torch.zeros_like(p)) + self.l2 * p
             for k, p in params.items()}
        super().update(params, g, state, **kw)


def reference_adam(learning_rate: float = 1e-3, weight_decay: float = 1e-4) -> ReferenceAdam:
    """The intent classifier's optimizer, the JAX ``reference_adam``."""
    return ReferenceAdam(learning_rate, weight_decay)


@torch.no_grad()
def load_opt_state(opt_state: OptState, saved: Mapping, tx: Optional[Optimizer] = None,
                   layout: Layout = None) -> None:
    """Copy a checkpoint's optimizer state (the nested dicts of
    ``utils.checkpoint.load_npz``: ``mu``/``nu`` of AdamW,
    ``v_row``/``v_col``/``v`` of Adafactor, and the count) into
    ``opt_state``, in place; with ``tx`` and ``layout`` (a sharded model's
    ``_param_shards``) this rank's shards of the whole saved tensors."""
    for key, tensors in opt_state.items():
        if key == "count":
            continue
        flat = flatten(saved[key])
        for name, t in tensors.items():
            src = torch.as_tensor(flat[name])
            ps = None if layout is None else tx.state_shards(layout[name])[key]
            t.copy_(src if ps is None else ps.local(src))
    opt_state["count"] = int(saved["count"])


@torch.no_grad()
def gather_opt_state(opt_state: OptState, tx: Optimizer, layout: Layout) -> OptState:
    """``opt_state`` of a sharded model with every tensor whole, on the CPU
    (what a single-device run keeps; a collective: every rank calls it)."""
    out: OptState = {"count": opt_state["count"]}
    for key, tensors in opt_state.items():
        if key == "count":
            continue
        out[key] = {}
        for name, t in tensors.items():
            ps = None if layout is None else tx.state_shards(layout[name])[key]
            out[key][name] = (t if ps is None else ps.full(t)).cpu()
    return out


@torch.no_grad()
def host_snapshot(model: nn.Module, opt_state: OptState) -> Dict:
    """Copies on the host of ``model``'s parameters and buffers and of
    ``opt_state``, for :func:`restore_snapshot`."""
    return {"model": {k: v.detach().to("cpu", copy=True)
                      for k, v in model.state_dict().items()},
            "opt_state": {k: v if k == "count" else
                          {n: t.to("cpu", copy=True) for n, t in v.items()}
                          for k, v in opt_state.items()}}


@torch.no_grad()
def restore_snapshot(model: nn.Module, opt_state: OptState, snap: Dict) -> None:
    """Put a :func:`host_snapshot` back into ``model`` and ``opt_state``,
    in place (the tensors the step updates stay the same objects)."""
    for k, v in model.state_dict().items():
        v.copy_(snap["model"][k])
    for key, value in snap["opt_state"].items():
        if key == "count":
            opt_state["count"] = value
        else:
            for name, t in value.items():
                opt_state[key][name].copy_(t)


def cast_compute(model: nn.Module, batch: Mapping[str, torch.Tensor],
                 compute_dtype: torch.dtype):
    """Mixed precision, the JAX ``_cast_compute``: (the float parameters of
    ``model`` cast to ``compute_dtype`` by name, ``batch`` with its float
    entries cast).  Each cast is recorded by autograd, so a loss computed
    from the copies sends float32 gradients to the master parameters; buffers (the sinusoidal tables) are not cast, as
    JAX's are constants the model casts to the hidden dtype at use."""
    params = {k: p.to(compute_dtype) if p.is_floating_point() else p
              for k, p in model.named_parameters()}
    batch = {k: v.to(compute_dtype) if v.is_floating_point() else v
             for k, v in batch.items()}
    return params, batch


class _Bound(nn.Module):
    """``fn(model, *args)`` as a module call, so that
    ``torch.func.functional_call`` can swap ``model``'s parameters."""

    def __init__(self, model: nn.Module, fn: Callable):
        super().__init__()
        self.model, self.fn = model, fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def _with_compute_dtype(loss_parts: Callable, compute_dtype: Optional[torch.dtype]
                        ) -> Callable:
    """``loss_parts`` as it is, or run under :func:`cast_compute`: the
    model's parameters replaced by their cast copies for the call."""
    if compute_dtype is None:
        return loss_parts

    def cast_loss_parts(model, batch, generator):
        params, batch = cast_compute(model, batch, compute_dtype)
        return torch.func.functional_call(_Bound(model, loss_parts),
                                          {f"model.{k}": v for k, v in params.items()},
                                          (batch, generator))

    return cast_loss_parts


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, float32."""
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm([t.float() for t in tensors])))


def sharded_global_norm(grads: Mapping[str, torch.Tensor], layout: Mapping[str, ParamShard],
                        mesh: Mesh) -> torch.Tensor:
    """The global norm of a sharded model's gradients, each element counted
    once: squares summed per class of shard axes, the sums added over the
    fsdp x tensor group, each class divided by the ranks that hold the same
    shard (a parameter replicated over tensor counts once, not tp times)."""
    classes = [(), (AXES.fsdp,), (AXES.tensor,), (AXES.fsdp, AXES.tensor)]
    sums = [[] for _ in classes]
    for name, g in grads.items():
        axes = tuple(a for a in (AXES.fsdp, AXES.tensor)
                     if a in partition.sharded_axes(layout.get(name)))
        sums[classes.index(axes)].append(torch.linalg.vector_norm(g.float()) ** 2)
    dev = next(iter(grads.values())).device
    vec = torch.stack([torch.stack(x).sum() if x else torch.zeros((), device=dev)
                       for x in sums])
    vec = coll.all_reduce(vec, mesh.model, mesh)
    plane = mesh.size(AXES.fsdp) * mesh.size(AXES.tensor)
    held = torch.tensor([plane / int(np.prod([mesh.size(a) for a in c])) for c in classes],
                        device=dev)
    return torch.sqrt((vec / held).sum())


@torch.no_grad()
def sync_gradients(grads: Mapping[str, torch.Tensor], layout: Mapping[str, ParamShard],
                   mesh: Mesh) -> None:
    """Sum each gradient over the data-parallel ranks that hold the same
    shard, in place: over data for an fsdp-sharded parameter (whose fsdp sum
    the backward's reduce-scatter made), over data x fsdp for the others.
    One all-reduce per group and dtype."""
    buckets: Dict[tuple, list] = {}
    for name, g in grads.items():
        sharded = AXES.fsdp in partition.sharded_axes(layout.get(name))
        group = mesh.groups[AXES.data] if sharded else mesh.dp
        buckets.setdefault((id(group), g.dtype), (group, []))[1].append(g)
    for group, gs in buckets.values():
        if group.group is None:
            continue
        flat = coll.all_reduce(torch.cat([g.reshape(-1) for g in gs]), group, mesh)
        for g, part in zip(gs, flat.split([g.numel() for g in gs])):
            g.copy_(part.view_as(g))


def layout(model: nn.Module) -> Layout:
    """A sharded model's parameter shards (None for an unsharded model)."""
    return getattr(model, "_param_shards", None)


def trainable_params(model: torch.nn.Module, freeze_feature_encoder: bool = False
                     ) -> Dict[str, torch.Tensor]:
    """Named parameters the optimizer updates: all, less the conv feature
    encoder when it is frozen."""
    return {k: p for k, p in model.named_parameters()
            if not (freeze_feature_encoder and k.startswith(FROZEN_PREFIX))}


def use_config(model: torch.nn.Module, cfg) -> None:
    """Point every submodule's ``cfg`` at ``cfg`` (the step's config may
    differ from the model's in its dropout rates only)."""
    for m in model.modules():
        if hasattr(m, "cfg"):
            m.cfg = cfg


def _zero_attention_dropout(cfg, field: str, attn_impl: str):
    """``cfg`` with ``field`` zeroed, and the JAX package's warning, when
    ``attn_impl`` is not dense (the kernels carry no attention-prob
    dropout)."""
    rate = getattr(cfg, field)
    if attn_impl == "dense" or rate <= 0.0:
        return cfg
    warnings.warn(
        f"attn_impl={attn_impl!r} carries no attention-prob dropout: "
        f"{field}={rate} is zeroed for this "
        "run (all other dropout rates keep their configured values). "
        "Use attn_impl='dense' if attention dropout must be active.",
        UserWarning, stacklevel=3)
    return dataclasses.replace(cfg, **{field: 0.0})


def _sum_form_update(loss_parts, model, params: Dict[str, torch.Tensor],
                     tx: Optimizer, opt_state: OptState, batch: Mapping[str, torch.Tensor],
                     keys, grad_accum: int, generator,
                     mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """Sum-form gradients of ``loss_parts(model, micro, generator) ->
    (nll_sum, ntokens)`` over a strided split of ``batch`` into
    ``grad_accum`` micro-batches (micro-batch j = rows j, j+accum, ..., as
    JAX), divided once by the total token count, then one ``tx`` update of
    ``params``.  Returns the step's metrics.

    With a ``mesh``, ``batch`` is this rank's rows of the global batch:
    the sums and the gradients are summed over the data-parallel ranks
    before the division (:func:`sync_gradients`), and the norm is the
    sharded model's (:func:`sharded_global_norm`)."""
    for p in model.parameters():
        p.grad = None
    b = batch[keys[0]].shape[0]
    if b % grad_accum:
        raise ValueError(f"batch size {b} not divisible by grad_accum {grad_accum}")
    nll_sum = ntok = 0.0
    with (activation_mesh(mesh) if mesh is not None else contextlib.nullcontext()):
        for j in range(grad_accum):
            micro = {k: batch[k][j::grad_accum] for k in keys}
            nll, n = loss_parts(model, micro, generator)
            nll.backward()
            nll_sum, ntok = nll_sum + nll.detach(), ntok + n
    shards = layout(model)
    if mesh is not None:
        sums = coll.all_reduce(torch.stack([torch.as_tensor(nll_sum).double(),
                                            torch.as_tensor(ntok).double()]).to(mesh.device),
                               mesh.dp, mesh)
        nll_sum, ntok = sums[0].float(), sums[1].long()
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        sync_gradients({k: p.grad for k, p in params.items()}, shards, mesh)
    n = torch.clamp(torch.as_tensor(ntok, dtype=torch.float32), min=1.0)
    grads = {k: (p.grad.div_(n) if p.grad is not None else None)
             for k, p in params.items()}
    present = {k: g for k, g in grads.items() if g is not None}
    if mesh is not None:
        gnorm = sharded_global_norm(present, shards, mesh)
    else:
        gnorm = global_norm(list(present.values())) if present else torch.zeros(())
    tx.update(params, grads, opt_state, norm=gnorm if mesh is not None else None,
              layout=shards)
    return {"loss": nll_sum / n, "grad_norm": gnorm,
            "nll_sum": nll_sum, "ntokens": torch.as_tensor(ntok)}


def make_asr_train_step(cfg: SpeechT5Config, tx: Optimizer, *,
                        attn_impl: str = "dense",
                        freeze_feature_encoder: bool = False,
                        grad_accum: int = 1,
                        compute_dtype: Optional[torch.dtype] = None,
                        remat: RematSpec = None,
                        mesh: Optional[Mesh] = None) -> Callable:
    """Returns ``step(model, opt_state, batch, generator) -> metrics``:
    the model (an ``AsrModel`` on the batch's device) and ``opt_state``
    (``tx.init(trainable_params(model, freeze_feature_encoder))``) are
    updated in place; ``batch`` holds ``input_values``, ``attention_mask``
    and ``labels`` tensors; dropout and SpecAugment draw from
    ``generator``.  Metrics (0-d tensors): ``loss``, ``grad_norm`` (before
    clipping), ``nll_sum``, ``ntokens``.

    ``attn_impl="flash"`` runs the kernels (B1, B3/B4, B5 and its
    backward; B2 under ``freeze_feature_encoder``), in their bf16 forms
    under ``compute_dtype=torch.bfloat16`` (:func:`cast_compute`).
    ``remat`` ("none", "full", "dots", "hybrid", "lite" or a bool;
    ``ops/remat.py``) rematerializes the encoder layers in the backward:
    "full" keeps only their inputs, "lite" all but the FFN chain; the
    step's numbers do not change.

    ``mesh``: the sharded step (the model from ``partition.shard_params``
    on that mesh, ``batch`` this rank's rows from :func:`shard_batch`, the
    same ``generator`` seed on every rank); None is the single-device
    step."""
    cfg = _zero_attention_dropout(cfg, "attention_dropout", attn_impl)
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def loss_parts(model, batch, generator):
        _, aux = st5.asr_loss(model, batch["input_values"], batch["attention_mask"],
                              batch["labels"], attn_impl=attn_impl,
                              generator=generator,
                              freeze_feature_encoder=freeze_feature_encoder, remat=remat)
        return aux["nll_sum"], aux["ntokens"]

    loss_parts = _with_compute_dtype(loss_parts, compute_dtype)

    def step(model, opt_state: OptState, batch: Mapping[str, torch.Tensor],
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        use_config(model, cfg)
        model.train()
        return _sum_form_update(loss_parts, model,
                                trainable_params(model, freeze_feature_encoder), tx,
                                opt_state, batch,
                                ("input_values", "attention_mask", "labels"),
                                grad_accum, generator, mesh)

    return step


def make_lm_train_step(cfg: g.GPT2Config, tx: Optimizer, *, attn_impl: str = "dense",
                       loss_impl: str = "chunked", grad_accum: int = 1,
                       compute_dtype: Optional[torch.dtype] = None,
                       remat: RematSpec = None,
                       mesh: Optional[Mesh] = None) -> Callable:
    """Returns ``step(model, opt_state, batch, generator) -> metrics`` for
    a ``GPT2Model`` on the batch's device, updated in place with
    ``opt_state = tx.init(dict(model.named_parameters()))``.  ``batch``
    holds ``ids`` [B, L] and ``lengths`` [B] tensors; the loss is the token
    mean of the NLL of tokens 1..len-1 (right padding is inert under
    causality).  Dropout draws from ``generator``.  Metrics as
    :func:`make_asr_train_step`'s.

    ``loss_impl``: ``"chunked"`` (default) scores the lm head in time
    chunks recomputed in the backward
    (``token_nll_from_hidden(checkpoint_chunks=True)``), so the [B, L, V]
    logits never live in memory; ``"dense"`` materialises them.
    ``attn_impl="flash"`` runs B6 in every layer, forward, and its
    blockwise PyTorch backward.  ``remat`` and ``mesh`` as
    :func:`make_asr_train_step`'s (``remat`` over the blocks)."""
    cfg = _zero_attention_dropout(cfg, "attn_pdrop", attn_impl)
    if loss_impl not in ("dense", "chunked"):
        raise ValueError(f"loss_impl must be 'dense' or 'chunked', got {loss_impl!r}")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def loss_parts(model, batch, generator):
        ids = batch["ids"]
        kw = dict(deterministic=False, generator=generator, attn_impl=attn_impl,
                  remat=remat)
        if loss_impl == "chunked":
            hidden, _ = g.gpt2_forward(model, ids, **kw)
            nll = g.token_nll_from_hidden(tensor_parallel.weight(model.wte), hidden, ids,
                                          checkpoint_chunks=True)
        else:
            logits, _ = g.gpt2_logits(model, ids, **kw)
            nll = g.token_nll(logits, ids)
        t = nll.shape[1]
        valid = (torch.arange(t, device=nll.device)[None, :]
                 < (batch["lengths"].to(nll.device) - 1)[:, None])
        return (nll * valid).sum(), valid.sum()

    loss_parts = _with_compute_dtype(loss_parts, compute_dtype)

    def step(model, opt_state: OptState, batch: Mapping[str, torch.Tensor],
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        use_config(model, cfg)
        model.train()
        return _sum_form_update(loss_parts, model, dict(model.named_parameters()), tx,
                                opt_state, batch, ("ids", "lengths"), grad_accum,
                                generator, mesh)

    return step


def pad_batch(batch: Mapping[str, Any], multiple: int,
              label_pad_id: int = -100) -> Dict[str, Any]:
    """Pad the batch axis to a multiple of the DP width.  Padded rows carry
    zero attention mask and all-pad labels, so they contribute nothing to
    the loss (numpy arrays or tensors, as given)."""
    b = next(iter(batch.values())).shape[0]
    pad = -b % multiple
    if pad == 0:
        return dict(batch)
    out = {}
    for k, v in batch.items():
        fill = label_pad_id if k == "labels" else 0
        if isinstance(v, torch.Tensor):
            out[k] = torch.cat([v, v.new_full((pad,) + tuple(v.shape[1:]), fill)])
        else:
            v = np.asarray(v)
            out[k] = np.pad(v, [(0, pad)] + [(0, 0)] * (v.ndim - 1), constant_values=fill)
    return out


def shard_batch(batch: Mapping[str, Any], mesh: Mesh, grad_accum: int = 1
                ) -> Dict[str, torch.Tensor]:
    """Pad the batch to a multiple of the DP width (x ``grad_accum``, so
    the micro-batch split divides evenly and every micro-batch stays a DP
    multiple; padded rows carry zero masks / all-pad labels and contribute
    no token) and return this rank's rows on its device: its block of the
    data x fsdp split, as JAX's ``data_sharding`` places it."""
    dp = mesh.size(AXES.data) * mesh.size(AXES.fsdp)
    batch = pad_batch(batch, dp * max(grad_accum, 1))
    sh = data_sharding(mesh)
    return {k: sh.shard(torch.as_tensor(v)).to(mesh.device) for k, v in batch.items()}


def init_sharded(init_fn: Callable, seed: int, cfg, mesh: Mesh,
                 rules=partition.TRANSFORMER_RULES) -> nn.Module:
    """``init_fn(cfg, seed=seed, device="cpu")`` (the same seeded weights on
    every rank), sharded onto ``mesh`` (``partition.shard_params``): only
    this rank's shards reach its device."""
    return partition.shard_params(init_fn(cfg, seed=seed, device="cpu"), mesh, rules)
