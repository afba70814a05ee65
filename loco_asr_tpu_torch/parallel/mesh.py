"""The (data, fsdp, tensor) mesh over ``torch.distributed`` ranks: the port
of ``loco_asr_tpu.parallel.mesh``.

The JAX package runs one controller over ``jax.devices()`` and lets XLA
insert the collectives.  Here each mesh position is one process (a rank),
and the collectives are written out (``collectives.py``).  A :class:`Mesh`
holds the grid of ranks, this rank's position on it and, for each axis,
the process group of the ranks that differ from it on that axis only, plus
the group of data x fsdp (the data-parallel width).

Axis conventions (:class:`MeshAxes`), as in JAX:
  data    -- pure data parallelism (gradients all-reduced)
  fsdp    -- data parallelism with parameter sharding (parameters gathered
             a layer at a time, gradients reduce-scattered)
  tensor  -- Megatron-style tensor parallelism inside attention and FFN
             blocks; innermost, so neighbouring ranks share a tensor group

``devices`` arguments take ranks (ints) where JAX takes devices; by default
the ranks of the initialised process group (one rank without one).  The
grid is built without a process group, so the layout functions run
anywhere; groups are made when the process group is initialised, by every
rank in the same order.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    data: str = "data"
    fsdp: str = "fsdp"
    tensor: str = "tensor"

    @property
    def names(self) -> Tuple[str, str, str]:
        return (self.data, self.fsdp, self.tensor)


AXES = MeshAxes()


@dataclasses.dataclass
class AxisGroup:
    """The ranks that differ from this one along some mesh axes only, in
    grid order (data-major), with this rank's index among them."""

    group: Optional[dist.ProcessGroup]
    members: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.members)


class Mesh:
    """A grid of ranks with named axes (``devices``: the rank array, like
    JAX's ``Mesh.devices``; ``shape``: axis name -> size).

    ``coords`` is this rank's position (None for a rank outside the grid
    or without a process group), ``groups[axis]`` the :class:`AxisGroup`
    along one axis, ``dp`` the one of data x fsdp, ``model`` the one of
    fsdp x tensor, ``world`` every rank.  ``device`` is the
    rank's device and ``staged`` whether its collectives copy CUDA tensors
    to host memory (a gloo group, ``collectives.py``)."""

    def __init__(self, grid: np.ndarray, axis_names: Sequence[str] = AXES.names,
                 device: Optional[torch.device] = None):
        self.devices = np.asarray(grid, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, self.devices.shape))
        self.device = torch.device("cpu") if device is None else torch.device(device)
        initialised = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank() if initialised else 0
        self.backend = dist.get_backend() if initialised else None
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        where = np.argwhere(self.devices == self.rank)
        self.coords = ({a: int(i) for a, i in zip(self.axis_names, where[0])}
                       if len(where) else None)
        self.groups: Dict[str, AxisGroup] = {}
        for axis in self.axis_names:
            self.groups[axis] = self._make_groups((axis,), initialised)
        self.dp = self._make_groups((AXES.data, AXES.fsdp), initialised)
        self.model = self._make_groups((AXES.fsdp, AXES.tensor), initialised)
        ranks = tuple(world_ranks())
        self.world = AxisGroup(dist.group.WORLD if len(ranks) > 1 else None, ranks,
                               ranks.index(self.rank))

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return 0 if self.coords is None else self.coords.get(axis, 0)

    def _make_groups(self, axes: Tuple[str, ...], initialised: bool) -> AxisGroup:
        """Every group of ranks that differ only along ``axes`` (made by every
        rank, in the same order, as ``dist.new_group`` requires); returns
        this rank's."""
        axes = tuple(a for a in axes if a in self.shape)
        moved = np.moveaxis(self.devices, [self.axis_names.index(a) for a in axes],
                            list(range(-len(axes), 0)))
        rows = moved.reshape(-1, int(np.prod([self.shape[a] for a in axes])))
        mine = None
        for row in rows:
            members = tuple(int(r) for r in row)
            if list(members) != sorted(members):
                raise ValueError(f"ranks {members} along {axes} are not in "
                                 "increasing order")
            group = None
            if initialised and len(members) > 1:
                group = dist.new_group(list(members))
            if self.rank in members:
                mine = AxisGroup(group, members, members.index(self.rank))
        return mine if mine is not None else AxisGroup(None, (self.rank,), 0)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def world_ranks() -> List[int]:
    """The ranks of the initialised process group, else ``[0]``."""
    if dist.is_available() and dist.is_initialized():
        return list(range(dist.get_world_size()))
    return [0]


def make_mesh(data: int = -1, fsdp: int = 1, tensor: int = 1,
              devices: Optional[Sequence[int]] = None,
              device: Optional[torch.device] = None) -> Mesh:
    """Build a (data, fsdp, tensor) mesh.  ``-1`` absorbs remaining ranks.

    Rank order follows ``devices`` (default: the world's ranks), keeping
    tensor (the chattiest axis) innermost, so ranks next to each other
    share a tensor group."""
    devs = list(devices if devices is not None else world_ranks())
    n = len(devs)
    dims = [data, fsdp, tensor]
    known = int(np.prod([d for d in dims if d > 0]))
    for i, d in enumerate(dims):
        if d == -1:
            if n % known:
                raise ValueError(f"{n} devices not divisible by {known}")
            dims[i] = n // known
            known *= dims[i]
            break
    want = int(np.prod(dims))
    if want > n:
        raise ValueError(f"mesh {dims} needs {want} devices, have {n}")
    grid = np.asarray(devs[:want]).reshape(dims)
    return Mesh(grid, AXES.names, device)


def slice_index(rank: int) -> int:
    """The slice (node) of ``rank``: ranks are contiguous per node, and a
    node holds ``LOCAL_WORLD_SIZE`` of them (one node when it is unset)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "0") or 0)
    return rank // local if local > 0 else 0


def slice_groups(devices: Sequence[int], num_slices: Optional[int] = None) -> list:
    """Group ranks by slice (:func:`slice_index`); if ``num_slices`` is
    given and exceeds what the runtime reports (one node, CPU tests), ranks
    are split into that many equal contiguous groups, which have the same
    locality structure as real nodes."""
    devs = list(devices)
    groups: dict = {}
    for d in devs:
        groups.setdefault(slice_index(d), []).append(d)
    granules = [groups[k] for k in sorted(groups)]
    if num_slices is not None and num_slices > len(granules):
        if num_slices % len(granules):
            raise ValueError(
                f"cannot split {len(granules)} slice(s) into {num_slices}")
        k = num_slices // len(granules)        # groups per real slice
        split = []
        for g in granules:
            if k == 0 or len(g) % k:
                # must divide by the GROUP COUNT, not the group size —
                # 8 devices into 3 groups would otherwise silently yield 4
                raise ValueError(
                    f"slice of {len(g)} devices not divisible into "
                    f"{k} groups")
            per = len(g) // k
            split.extend(g[i:i + per] for i in range(0, len(g), per))
        granules = split
        assert len(granules) == num_slices, (len(granules), num_slices)
    if num_slices is not None and len(granules) != num_slices:
        # requesting FEWER slices than the runtime reports would put
        # unexpected axes across nodes — refuse instead
        raise ValueError(
            f"num_slices={num_slices} but the device set resolves to "
            f"{len(granules)} slice group(s)")
    if len({len(g) for g in granules}) != 1:
        raise ValueError("slices have unequal device counts")
    return granules


def make_multislice_mesh(data: int = -1, fsdp: int = 1, tensor: int = 1,
                         num_slices: Optional[int] = None,
                         devices: Optional[Sequence[int]] = None,
                         device: Optional[torch.device] = None) -> Mesh:
    """Mesh spanning several slices (nodes): the data axis is laid out
    across slices, so its collectives (the gradient all-reduce) cross
    nodes while fsdp and tensor stay inside one.  Falls back to
    :func:`make_mesh` when there is one slice and no ``num_slices``."""
    devs = list(devices if devices is not None else world_ranks())
    granules = slice_groups(devs, num_slices)
    n_slices = len(granules)
    if n_slices <= 1:
        return make_mesh(data, fsdp, tensor, devices=devs, device=device)

    per_slice = len(granules[0])
    if fsdp * tensor > per_slice or per_slice % (fsdp * tensor):
        raise ValueError(f"fsdp*tensor={fsdp * tensor} must divide the "
                         f"per-slice device count {per_slice}")
    if data == -1:
        data = len(devs) // (fsdp * tensor)
    if data % n_slices:
        raise ValueError(f"data axis {data} must divide across {n_slices} slices")
    data_per_slice = data // n_slices
    if data_per_slice * fsdp * tensor != per_slice:
        raise ValueError(
            f"mesh ({data},{fsdp},{tensor}) needs {data_per_slice * fsdp * tensor}"
            f" devices per slice, slices have {per_slice}")
    # each slice contributes a (data/n_slices, fsdp, tensor) block of
    # contiguous ranks; slices stack along the data axis
    grid = np.stack([
        np.asarray(g).reshape(data_per_slice, fsdp, tensor) for g in granules
    ]).reshape(data, fsdp, tensor)
    return Mesh(grid, AXES.names, device)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh (the counterpart of JAX's ``NamedSharding``): per
    dimension None, an axis name or a tuple of them (major first)."""

    mesh: Mesh
    spec: Tuple = ()

    def shard_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        shape = list(global_shape)
        for i, entry in enumerate(self.spec[:len(shape)]):
            shape[i] //= axes_size(self.mesh, entry)
        return tuple(shape)

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global tensor ``x``."""
        for i, entry in enumerate(self.spec[:x.dim()]):
            n, k = axes_size(self.mesh, entry), axes_index(self.mesh, entry)
            if n > 1:
                x = x.narrow(i, k * (x.shape[i] // n), x.shape[i] // n)
        return x


def axis_names(entry) -> Tuple[str, ...]:
    """A spec entry (None, a name, or a tuple of names) as a tuple."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def axes_size(mesh: Mesh, entry) -> int:
    return int(np.prod([mesh.size(a) for a in axis_names(entry)]))


def axes_index(mesh: Mesh, entry) -> int:
    """This rank's block index along a dimension sharded over ``entry``
    (the first axis major, as JAX lays out a tuple of axes)."""
    k = 0
    for a in axis_names(entry):
        k = k * mesh.size(a) + mesh.index(a)
    return k


def named(mesh: Mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, tuple(spec))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Batch-axis sharding over data x fsdp (the combined DP width)."""
    return NamedSharding(mesh, ((AXES.data, AXES.fsdp),))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())
