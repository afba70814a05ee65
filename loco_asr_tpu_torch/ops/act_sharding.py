"""The batch layout of a sharded step, the port of
``loco_asr_tpu.ops.act_sharding``.

In JAX the sharded steps activate ``activation_mesh`` and the models pin
their batch-carrying activations with ``constrain_batch``, so that GSPMD
keeps the batch split over data x fsdp.  Here each rank already holds only
its own batch rows, so there is nothing to pin: :func:`constrain_batch`
keeps the JAX check (a batch that does not divide the data-parallel width,
with its once-per-shape warning) and returns its argument.

What the context does carry is the rank's place in the global batch, for
the random draws: a dropout or SpecAugment draw is made at its global
shape from the step's generator, in the single-device order, and the rank
takes its rows (and, for an activation split over the tensor axis, its
columns) -- :func:`rand`, :func:`batch_rows` and :func:`local_rows`
(``parallel.tensor_parallel.global_rows`` gathers the rows a draw depends
on).  So the sharded step
draws the masks of the single-device step, and the ranks of one tensor
group draw the same masks for the activations they share.  Under
sequence parallelism a model marks the code that holds a block of the
time axis (dimension 1) with :func:`sequence_block`, and a draw there
is made over the whole sequence and sliced at the block.  Without an
active context every function is the single-device one."""

from __future__ import annotations

import contextlib
import contextvars
import logging
import math
from typing import Optional, Sequence, Tuple

import torch

logger = logging.getLogger(__name__)
_warned_skip = set()

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("loco_activation_mesh",
                                                         default=None)
_SEQUENCE: contextvars.ContextVar = contextvars.ContextVar("loco_sequence_block",
                                                           default=None)


@contextlib.contextmanager
def sequence_block(n: int, index: int):
    """Mark code run inside as holding block ``index`` of ``n`` equal
    blocks along dimension 1 of its activations (inert for ``n`` 1)."""
    token = _SEQUENCE.set((n, index) if n > 1 else None)
    try:
        yield
    finally:
        _SEQUENCE.reset(token)


@contextlib.contextmanager
def activation_mesh(mesh, batch_axes: Sequence[str] = ("data", "fsdp")):
    """Mark code run inside as a sharded step's: the batch rows of each
    rank are its block of the batch split over ``batch_axes`` (axes
    missing from the mesh or of size 1 are dropped; with none left, and
    no tensor axis, the context is inert)."""
    axes = tuple(a for a in batch_axes if a in mesh.shape and mesh.shape[a] > 1)
    inert = not axes and mesh.shape.get("tensor", 1) == 1
    token = _ACTIVE.set(None if inert else (mesh, axes))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def _width(mesh, axes) -> Tuple[int, int]:
    """(data-parallel width, this rank's block index) over ``axes``."""
    width, index = 1, 0
    for a in axes:
        width, index = width * mesh.shape[a], index * mesh.shape[a] + mesh.index(a)
    return width, index


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """JAX's check on a batch (axis 0 of ``x``, before it is split): warn,
    once per shape and width, when it does not divide the data-parallel
    width (``parallel.train.shard_batch`` pads to a multiple).  Returns
    ``x``: each rank holds its own rows already."""
    active = _ACTIVE.get()
    if active is None or getattr(x, "ndim", 0) == 0:
        return x
    mesh, axes = active
    width = math.prod(mesh.shape[a] for a in axes)
    if x.shape[0] % width:
        key = (x.shape[0], width)
        if key not in _warned_skip:
            _warned_skip.add(key)
            logger.warning(
                "constrain_batch: batch dim %d not divisible by data-axes "
                "width %d — activation-sharding constraint SKIPPED for "
                "this tensor (pad the batch: parallel.train.shard_batch)",
                x.shape[0], width)
    return x


def batch_rows(local: int) -> Tuple[int, int]:
    """(global batch size, first global row of this rank) for a rank
    holding ``local`` rows."""
    active = _ACTIVE.get()
    if active is None:
        return local, 0
    width, index = _width(*active)
    return local * width, index * local


def rand(shape, generator: Optional[torch.Generator], device,
         tensor_dim: Optional[int] = None) -> torch.Tensor:
    """``torch.rand(shape)`` of this rank's block: drawn at the global
    shape (rows over the data axes, ``tensor_dim`` over the tensor axis
    when given, dimension 1 inside a :func:`sequence_block`), then
    sliced."""
    active, seq = _ACTIVE.get(), _SEQUENCE.get()
    if active is None and seq is None:
        return torch.rand(shape, generator=generator, device=device)
    gshape = list(shape)
    if active is not None:
        mesh, axes = active
        width, index = _width(mesh, axes)
        gshape[0] *= width
        tp = mesh.shape.get("tensor", 1)
        if tensor_dim is not None:
            gshape[tensor_dim] *= tp
    if seq is not None:
        gshape[1] *= seq[0]
    r = torch.rand(gshape, generator=generator, device=device)
    if active is not None:
        r = r.narrow(0, index * shape[0], shape[0])
        if tensor_dim is not None and tp > 1:
            n = shape[tensor_dim]
            r = r.narrow(tensor_dim, mesh.index("tensor") * n, n)
    if seq is not None:
        r = r.narrow(1, seq[1] * shape[1], shape[1])
    return r


def active():
    """(mesh, batch axes) of the active context, or None."""
    return _ACTIVE.get()


def local_rows(t: torch.Tensor, local: int) -> torch.Tensor:
    """This rank's ``local`` rows of a global-batch tensor."""
    _, first = batch_rows(local)
    return t.narrow(0, first, local)
