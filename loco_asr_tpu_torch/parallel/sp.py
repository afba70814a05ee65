"""Sequence parallelism over a group of ranks: the port of
``loco_asr_tpu.parallel.sp``, the plumbing that the two schemes (ring,
``ring_attention.py``; Ulysses, ``ulysses.py``) and their callers (the
SpeechT5 encoder, GPT-2) share.

The JAX package hands a scheme global [B, H, T, D] arrays and lets
``shard_map`` split the time axis over a mesh axis.  Here each rank
already holds its block: a model takes this rank's block of the sequence
(:meth:`SequenceParallel.block`, which raises JAX's error when the length
does not divide), runs its layers on it, and its attention runs a scheme
on the local [B, H, T/n, D] blocks with

* key padding as global valid-key counts of this rank's batch rows
  (``kv_valid_len`` [B]; JAX slices them over the batch axis of a
  (data, sequence) mesh, here each rank holds its rows already);
* the SpeechT5 relative-position table whole (replicated);
* causality, padding and the relative distances at global positions
  (:meth:`SequenceParallel.offset`).

:class:`SequenceParallel` stands where JAX passes ``ring=(mesh,
axis_name[, batch_axis])``: the mesh (``mesh.make_sp_mesh``) and the
group of its sequence axis.  Inside :meth:`SequenceParallel.split` a
dropout draw is made over the whole sequence and sliced at this rank's
block (``ops/act_sharding.py``), so the sequence-parallel step draws the
single-device step's masks."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops import act_sharding
from . import collectives as coll
from .mesh import SEQUENCE, Mesh
from .ring_attention import ring_attention
from .ulysses import ulysses_attention

SCHEMES = {"ring": ring_attention, "ulysses": ulysses_attention}
IMPLS = tuple(SCHEMES)


def resolve_sp_impl(name: str) -> Callable:
    """'ring' | 'ulysses' -> the scheme's attention entry point."""
    if name not in SCHEMES:
        raise ValueError(f"unknown sequence-parallel impl {name!r}")
    return SCHEMES[name]


class SequenceParallel:
    """The sequence axis of ``mesh``: this rank's group along it, its size
    and this rank's index."""

    def __init__(self, mesh: Mesh):
        if SEQUENCE not in mesh.shape:
            raise ValueError(f"mesh {mesh.shape} has no axis {SEQUENCE!r}")
        self.mesh, self.group = mesh, mesh.groups[SEQUENCE]

    @property
    def size(self) -> int:
        return self.group.size

    @property
    def index(self) -> int:
        return self.group.index

    def block(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's block of the whole sequence ``x`` along ``dim``."""
        if x.shape[dim] % self.size:
            raise ValueError(f"sequence length {x.shape[dim]} not divisible by mesh axis "
                             f"{self.size}")
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.index * n, n)

    def offset(self, t_local: int) -> int:
        """The global position of this rank's first element."""
        return self.index * t_local

    def gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The whole sequence from every rank's block; the backward
        reduce-scatters (each rank's gradient is a share of the sum)."""
        return coll.gather(x, self.group, dim, self.mesh)

    def split(self):
        """Context: code inside holds this rank's block of dimension 1."""
        return act_sharding.sequence_block(self.size, self.index)

    def attention(self, impl: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, scale: Optional[float] = None,
                  kv_valid_len: Optional[torch.Tensor] = None,
                  rel_pe: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Exact attention of this rank's [B, H, T/n, D] blocks against the
        whole sequence, by scheme ``impl``."""
        return resolve_sp_impl(impl)(q, k, v, sp=self, causal=causal, scale=scale,
                                     kv_valid_len=kv_valid_len, rel_pe=rel_pe)
