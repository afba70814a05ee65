"""Parameter partition rules: parameter path -> spec, the port of
``loco_asr_tpu.parallel.partition``.

The rules and :func:`validate_spec` are the JAX package's, applied to the
JAX flat names (``utils.pytree`` paths, the checkpoints' keys), so a
parameter gets the spec it gets there.  A spec is a tuple with one entry a
dimension: None, a mesh axis, or a tuple of axes (major first), JAX's
``PartitionSpec`` layout without the sharding object.

Kernel layout reminder: the JAX dense kernels are [in, out] (the port's
``nn.Linear`` weights [out, in] take the transposed spec).
  * column-parallel (shard OUT over tensor): q/k/v projections, FFN up,
    qkv fused (GPT-2 c_attn), lm_head
  * row-parallel (shard IN over tensor): attention out_proj, FFN down
  * embeddings: shard the embedding dim over tensor
  * FSDP shards whichever large axis tensor did not take.

:func:`shard_params` turns a model's parameters into this rank's local
shards (each of the shape JAX's ``NamedSharding(mesh, spec).shard_shape``
gives) and gives each module that holds a shard, or whose heads it
splits, the sharded subclass of its class (``tensor_parallel.py``): a
block whose weights put the tensor axis on their head or width dimension,
with heads that divide it, runs tensor-parallel; every other sharded
parameter is gathered whole before use.  GPT-2's fused ``c_attn`` is the one place
where a shard's contents are not JAX's contiguous block: under tensor
parallelism a rank's columns are its heads' columns of q, k and v, so that
kernel B6 reads its [q | k | v] layout from the local buffer.
:func:`gather_params` puts every parameter back whole, in the original
layout, for saving and evaluation; :func:`load_params` re-shards a whole
state."""

from __future__ import annotations

import logging
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..utils.checkpoint import flatten, unflatten
from . import tensor_parallel as tpar
from .mesh import AXES, Mesh, NamedSharding, axis_names

logger = logging.getLogger(__name__)


class PartitionSpec(tuple):
    """One entry a dimension: None, an axis name or a tuple of names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec
Rule = Tuple[str, PartitionSpec]

_F, _T = AXES.fsdp, AXES.tensor

# Shared transformer rules (SpeechT5 + GPT-2 use the same module names
# where it matters).
TRANSFORMER_RULES: List[Rule] = [
    # attention projections (SpeechT5 naming)
    (r"\.(q_proj|k_proj|v_proj)\.kernel$", P(_F, _T)),
    (r"\.(q_proj|k_proj|v_proj)\.bias$", P(_T)),
    (r"\.out_proj\.kernel$", P(_T, _F)),
    (r"\.out_proj\.bias$", P()),
    # feed-forward (SpeechT5 naming)
    (r"\.intermediate_dense\.kernel$", P(_F, _T)),
    (r"\.intermediate_dense\.bias$", P(_T)),
    (r"\.output_dense\.kernel$", P(_T, _F)),
    (r"\.output_dense\.bias$", P()),
    # GPT-2 naming: fused qkv + mlp
    (r"\.c_attn\.kernel$", P(_F, _T)),
    (r"\.c_attn\.bias$", P(_T)),
    (r"attn\.c_proj\.kernel$", P(_T, _F)),
    (r"mlp\.c_fc\.kernel$", P(_F, _T)),
    (r"mlp\.c_fc\.bias$", P(_T)),
    (r"mlp\.c_proj\.kernel$", P(_T, _F)),
    # embeddings / heads
    (r"(wte|embed_tokens)\.weight$", P(_F, _T)),
    (r"wpe\.weight$", P(None, _T)),
    (r"lm_head\.kernel$", P(_F, _T)),
    # SpeechT5 speech prenet: conv feature encoder is tiny -> replicate;
    # feature projection is a real matmul
    (r"feature_projection\.projection\.kernel$", P(_F, _T)),
    (r"pos_conv_embed\.conv\.weight_v$", P(_T, None, None)),
    # relative position table: replicate (small)
    (r"pe_k\.weight$", P()),
]


def spec_for(path: str, rules: Sequence[Rule]) -> PartitionSpec:
    for pattern, spec in rules:
        if re.search(pattern, path):
            return spec
    return P()  # replicate by default


def partition_specs(params: Dict, rules: Sequence[Rule] = TRANSFORMER_RULES) -> Dict:
    """Param tree -> tree of specs with identical structure."""
    flat = flatten(params)
    return unflatten({k: spec_for(k, rules) for k in flat})


def validate_spec(spec: PartitionSpec, shape: Tuple[int, ...],
                  axis_sizes: Dict[str, int], path: str = "") -> PartitionSpec:
    """Resolve a rule spec against a concrete shape + mesh-axis sizes.

    1. Drop sharding on dims the array can't honor (indivisible dims —
       keeps the rules usable for toy test configs).
    2. RELOCATE a dropped mesh axis to another dim that CAN honor it
       (combined with whatever trivial/compatible axes already sit
       there).  The motivating case is gpt2-xl's wte [50257, 1600] under
       --mesh 1,8,1: the vocab dim is not divisible by fsdp=8, and
       without relocation ~920 MB of embedding + Adam state would be
       silently replicated on every chip; moving fsdp to the (divisible)
       embedding dim keeps the state fully sharded.
    3. Only if no dim can take the axis is it dropped for real — logged
       as a warning, since at real scale that means a mistyped rule or
       an odd vocab and the memory/step-time cost is large.
    """
    out: List = []
    dropped: List[Tuple] = []
    for i, s in enumerate(spec):
        if s is not None and i >= len(shape):
            # a rule naming a dim the array doesn't have is a mistyped
            # rule, not a divisibility accident — keep it loud
            logger.warning(
                "partition rule ignored: %s spec entry %r at dim %d but "
                "array rank is %d", path or "<param>", s, i, len(shape))
            continue
        if s is None or i >= len(shape):
            out.append(None)
            continue
        names = s if isinstance(s, tuple) else (s,)
        size = int(np.prod([axis_sizes[n] for n in names]))
        if shape[i] % size == 0:
            out.append(s)
        else:
            out.append(None)
            if size > 1:
                dropped.append((i, names, size))
    out += [None] * (len(shape) - len(out))
    out = out[:len(shape)]

    for i, names, size in dropped:
        placed = False
        for j in range(len(shape)):
            if j == i:
                continue
            here = out[j]
            here_names = (() if here is None
                          else (here if isinstance(here, tuple) else (here,)))
            if any(n in here_names for n in names):
                continue
            combined = here_names + names
            csize = int(np.prod([axis_sizes[n] for n in combined]))
            if shape[j] % csize == 0:
                out[j] = combined if len(combined) > 1 else combined[0]
                # at real scale a relocation means the RULE's layout isn't
                # what runs (collectives/layouts differ) — warn for big
                # params, stay quiet for toy test shapes
                level = (logger.warning if int(np.prod(shape)) >= 1 << 20
                         else logger.info)
                level(
                    "partition rule relocated: %s mesh axis %r moved from "
                    "dim %d (size %d, indivisible) to dim %d (size %d)",
                    path or "<param>", names, i, shape[i], j, shape[j])
                placed = True
                break
        if not placed:
            logger.warning(
                "partition rule dropped: %s dim %d (size %s) not divisible "
                "by mesh axis %r (size %d) — tensor axis will be REPLICATED",
                path or "<param>", i, shape[i], names, size)
    return P(*out)


def _validate(spec: PartitionSpec, shape: Tuple[int, ...], mesh: Mesh,
              path: str = "") -> PartitionSpec:
    return validate_spec(spec, shape, dict(mesh.shape), path=path)


def jax_names(model: nn.Module) -> Dict[str, Tuple[str, bool]]:
    """Port parameter name -> (JAX flat key, whether the port's tensor is
    the transpose of JAX's): the model's converter's names, which the
    rules are written against."""
    from ..models.gpt2 import convert as gconvert, model as g
    from ..models.speecht5 import convert

    return (gconvert.jax_names(model) if isinstance(model, g.GPT2Model)
            else convert.jax_names(model))


def model_specs(model: nn.Module, mesh: Mesh,
                rules: Sequence[Rule] = TRANSFORMER_RULES) -> Dict[str, PartitionSpec]:
    """Port parameter name -> validated spec in the port's layout."""
    out = {}
    names = jax_names(model)
    for name, p in model.named_parameters():
        key, transpose = names[name]
        shape = tuple(p.shape)
        jshape = tuple(reversed(shape)) if transpose else shape
        spec = tuple(_validate(spec_for(key, rules), jshape, mesh, path=key))
        out[name] = P(*(reversed(spec) if transpose else spec))
    return out


def sharding_tree(model: nn.Module, mesh: Mesh,
                  rules: Sequence[Rule] = TRANSFORMER_RULES) -> Dict[str, NamedSharding]:
    """Port parameter name -> :class:`~.mesh.NamedSharding` (validated)."""
    return {k: NamedSharding(mesh, tuple(s))
            for k, s in model_specs(model, mesh, rules).items()}


def _tensor_first(entry) -> bool:
    names = axis_names(entry)
    return bool(names) and names[0] == AXES.tensor


def _blocks(model: nn.Module):
    """(block, [(linear, role)], heads or None) of every attention and
    feed-forward block: the layers that run column- or row-parallel."""
    from ..models.gpt2 import model as g
    from ..models.speecht5 import encoder as enc
    from ..ops import attention

    n_head = model.cfg.n_head if isinstance(model, g.GPT2Model) else None
    for m in model.modules():
        if isinstance(m, attention.MultiHeadAttention):
            yield m, [(m.q_proj, "column"), (m.k_proj, "column"),
                      (m.v_proj, "column"), (m.out_proj, "row")], m.num_heads
        elif isinstance(m, enc.FeedForward):
            yield m, [(m.intermediate_dense, "column"), (m.output_dense, "row")], None
        elif isinstance(m, g.Attention):
            yield m, [(m.c_attn, "column"), (m.c_proj, "row")], n_head
        elif isinstance(m, g.MLP):
            yield m, [(m.c_fc, "column"), (m.c_proj, "row")], None


def shard_params(model: nn.Module, mesh: Mesh,
                 rules: Sequence[Rule] = TRANSFORMER_RULES) -> nn.Module:
    """Replace ``model``'s parameters by this rank's shards (validated
    specs) on ``mesh.device``, in place, set each block's tensor-parallel
    role, and return the model."""
    from ..models.gpt2 import model as g

    specs = model_specs(model, mesh, rules)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    tp = mesh.size(AXES.tensor)
    roles: Dict[str, Tuple[str, int]] = {}        # linear module -> role
    names = {id(m): n for n, m in model.named_modules()}
    for block, linears, heads in _blocks(model):
        ok = tp > 1 and (heads is None or heads % tp == 0)
        for lin, role in linears:
            w = specs[f"{names[id(lin)]}.weight"]
            out_dim = 1 if isinstance(lin, g.Conv1D) else 0
            dim = out_dim if role == "column" else 1 - out_dim
            ok = ok and _tensor_first(w[dim])
        if ok:
            tpar.become(block, tpar.TensorParallelBlock, tp=tp, _mesh=mesh)
        for lin, role in linears:
            roles[names[id(lin)]] = (role if ok else "whole",
                                     3 if ok and isinstance(block, g.Attention)
                                     and role == "column" else 1)

    model._param_shards = {}
    for mod_name, m in model.named_modules():
        local_params = list(m.named_parameters(recurse=False))
        if not local_params:
            continue
        role, interleave = roles.get(mod_name, ("whole", 1))
        shards = {}
        for pname, p in local_params:
            full = f"{mod_name}.{pname}" if mod_name else pname
            transposed = isinstance(m, g.Conv1D)
            il_dim = (1 if transposed else 0) if pname == "weight" else 0
            ps = tpar.ParamShard(mesh, shapes[full], tuple(specs[full]),
                                 interleave, il_dim)
            model._param_shards[full] = ps
            shards[pname] = ps
            m._parameters[pname] = nn.Parameter(ps.local(p.data).to(mesh.device),
                                                requires_grad=p.requires_grad)
        sharded = {k: ps for k, ps in shards.items() if ps.steps()}
        if sharded:
            m._shards = sharded
            if isinstance(m, (nn.Linear, g.Conv1D)):
                tpar.become(m, tpar.ShardedLinear, _tp=tpar.LinearShard(
                    role, shards["weight"], shards.get("bias"),
                    transposed=isinstance(m, g.Conv1D)))
            elif isinstance(m, nn.Embedding):
                tpar.become(m, tpar.ShardedEmbedding)
    for name, buf in list(model.named_buffers()):
        mod_name, _, bname = name.rpartition(".")
        owner = model.get_submodule(mod_name) if mod_name else model
        owner._buffers[bname] = buf.to(mesh.device)
    return model


@torch.no_grad()
def gather_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter of a sharded ``model`` whole, in the original
    layout, and its persistent buffers: a CPU state dict (a collective:
    every rank calls it)."""
    shards = model._param_shards
    state = {}
    for name, t in model.state_dict().items():
        ps = shards.get(name)
        state[name] = (ps.full(t) if ps is not None else t).cpu()
    return state


@torch.no_grad()
def load_params(model: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Copy this rank's shards of a whole state dict (original layout) into
    a sharded ``model``, in place (``--resume`` re-shards a checkpoint)."""
    shards = model._param_shards
    for name, t in model.state_dict().items():
        ps = shards.get(name)
        src = torch.as_tensor(state[name])
        t.copy_(ps.local(src) if ps is not None else src)


def sharded_axes(ps: Optional[tpar.ParamShard]) -> Tuple[str, ...]:
    """The mesh axes (of size > 1) a parameter is split over."""
    if ps is None:
        return ()
    return tuple(a for e in ps.spec for a in axis_names(e) if ps.mesh.size(a) > 1)


def local_bytes(tensors) -> int:
    """Bytes of a collection of tensors (this rank's shards)."""
    return sum(t.numel() * t.element_size() for t in tensors)


def local_param_bytes(model: nn.Module, mesh: Mesh,
                      rules: Sequence[Rule] = TRANSFORMER_RULES) -> int:
    """Bytes of one rank's parameter shards of the whole ``model`` (a meta
    model will do), from the validated specs: what :func:`shard_params`
    leaves on a rank."""
    specs = model_specs(model, mesh, rules)
    return sum(int(np.prod(NamedSharding(mesh, tuple(specs[k])).shard_shape(p.shape)))
               * p.element_size() for k, p in model.named_parameters())
