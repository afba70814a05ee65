"""The port's (data, fsdp, tensor) mesh over ``torch.distributed`` ranks
against the JAX package's mesh on the 8 virtual CPU devices of
``tests/conftest.py``: ``make_mesh``, ``slice_groups`` and
``make_multislice_mesh`` lay ranks out as JAX lays out devices (rank i for
device i) and raise the same ``ValueError``s; on 8 spawned gloo ranks each
rank's coordinates and axis groups are its place in JAX's grid; the
collectives and their adjoints on 4 ranks; and ``ops/act_sharding.py``:
JAX's batch check with its once-per-shape warning, and the global draws
cut to a rank's block."""

import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import torch_dist_worker as worker
from loco_asr_tpu.parallel import mesh as jmesh
from loco_asr_tpu_torch.ops import act_sharding
from loco_asr_tpu_torch.parallel import mesh as tmesh

RANKS = list(range(8))


def _ids(grid) -> np.ndarray:
    return np.vectorize(lambda d: d.id)(grid)


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    """One start of 8 ranks for the layouts, then of 4 for the collectives."""
    out = str(tmp_path_factory.mktemp("mesh"))
    worker.spawn(out, 8, [("mesh_layout", {})])
    worker.spawn(out, 4, [("collectives", {})])
    return out


def _load(out, name, rank):
    return torch.load(os.path.join(out, f"{name}.rank{rank}.pt"), weights_only=False)


@pytest.mark.parametrize("dims", [(2, 2, 2), (-1, 1, 2), (2, -1, 1), (1, 1, -1), (4, 1, 1),
                                  (1, 2, 2)])
def test_make_mesh_grid_matches_jax(dims):
    want = jmesh.make_mesh(*dims)
    got = tmesh.make_mesh(*dims, devices=RANKS)
    assert got.shape == dict(want.shape)
    np.testing.assert_array_equal(got.devices, _ids(want.devices))


@pytest.mark.parametrize("dims", [(3, -1, 1), (4, 4, 1), (3, 3, 1), (1, -1, 16)])
def test_make_mesh_errors_match_jax(dims):
    with pytest.raises(ValueError) as want:
        jmesh.make_mesh(*dims)
    with pytest.raises(ValueError) as got:
        tmesh.make_mesh(*dims, devices=RANKS)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("num_slices", [None, 1, 2, 4, 8, 3, 16])
def test_slice_groups_match_jax(num_slices):
    try:
        want = [[d.id for d in g] for g in jmesh.slice_groups(jax.devices(), num_slices)]
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.slice_groups(RANKS, num_slices)
        assert str(got.value) == str(e)
        return
    assert tmesh.slice_groups(RANKS, num_slices) == want


@pytest.mark.parametrize("args", [(4, 1, 2, 2), (2, 2, 2, 2), (-1, 1, 2, 2), (8, 1, 1, 4),
                                  (2, 2, 2, None), (3, 1, 1, 2), (2, 4, 1, 2), (2, 1, 2, 2)])
def test_multislice_mesh_matches_jax(args):
    data, fsdp, tensor, n = args
    try:
        want = jmesh.make_multislice_mesh(data, fsdp, tensor, num_slices=n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.make_multislice_mesh(data, fsdp, tensor, num_slices=n, devices=RANKS)
        assert str(got.value) == str(e)
        return
    got = tmesh.make_multislice_mesh(data, fsdp, tensor, num_slices=n, devices=RANKS)
    assert got.shape == dict(want.shape)
    np.testing.assert_array_equal(got.devices, _ids(want.devices))


@pytest.mark.parametrize("name", sorted(worker.MESHES))
def test_each_rank_sits_where_jax_puts_its_device(ranks_out, name):
    spec = worker.MESHES[name]
    devs = jax.devices()
    if spec["kind"] == "mesh":
        grid = _ids(jmesh.make_mesh(*spec["dims"], devices=devs).devices)
    else:
        grid = _ids(jmesh.make_multislice_mesh(*spec["dims"], num_slices=spec["num_slices"],
                                               devices=devs).devices)
    names = ("data", "fsdp", "tensor")
    for rank in RANKS:
        rec = _load(ranks_out, "mesh_layout", rank)[name]
        pos = tuple(int(i) for i in np.argwhere(grid == rank)[0])
        assert rec["coords"] == dict(zip(names, pos))
        assert rec["shape"] == dict(zip(names, grid.shape))
        for ax, axis in enumerate(names):
            along = list(np.moveaxis(grid, ax, -1)[tuple(np.delete(pos, ax))])
            assert rec["groups"][axis] == along, (axis, rank)
        assert rec["dp"] == list(grid[:, :, pos[2]].reshape(-1))


def test_collectives_and_their_adjoints(ranks_out):
    grid = np.arange(4).reshape(2, 2)                      # (fsdp, tensor) of (1, 2, 2)
    w = lambda r: np.arange(12.0).reshape(4, 3) + r
    for rank in range(4):
        rec = _load(ranks_out, "collectives", rank)
        f, t = (int(i) for i in np.argwhere(grid == rank)[0])
        for axis, members in (("fsdp", grid[:, t]), ("tensor", grid[f, :])):
            k = list(members).index(rank)
            want = np.concatenate([np.full((2, 3), float(r)) for r in members])
            np.testing.assert_array_equal(rec[axis]["gather"].numpy(), want)
            total = sum(w(r) for r in members)
            np.testing.assert_array_equal(rec[axis]["grad"].numpy(), total[2 * k:2 * k + 2])
            np.testing.assert_array_equal(rec[axis]["reduce_scatter"].numpy(),
                                          total[2 * k:2 * k + 2])
            np.testing.assert_array_equal(rec[axis]["all_reduce"].numpy(), total)
        members = grid[f, :]
        np.testing.assert_array_equal(rec["copy_to_grad"].numpy(),
                                      np.full((2, 3), float(sum(r + 1 for r in members))))
        np.testing.assert_array_equal(rec["reduce_from"].numpy(),
                                      np.full((2, 3), float(sum(members))))
        np.testing.assert_array_equal(rec["reduce_from_grad"].numpy(),
                                      np.full((2, 3), float(rank + 1)))


def test_constrain_batch_keeps_jax_check_and_warns_once(caplog):
    mesh = tmesh.make_mesh(2, 2, 2, devices=RANKS)
    x = torch.zeros(6, 3)
    with caplog.at_level(logging.WARNING, logger="loco_asr_tpu_torch.ops.act_sharding"):
        assert act_sharding.constrain_batch(x) is x          # no context: no check
        with act_sharding.activation_mesh(mesh):
            for _ in range(2):
                assert act_sharding.constrain_batch(x) is x
            assert act_sharding.constrain_batch(torch.zeros(8, 3)) is not None
    warned = [r for r in caplog.records if "not divisible by data-axes width 4" in r.message]
    assert len(warned) == 1


@pytest.mark.parametrize("tensor_dim", [None, 1, -1])
def test_global_draws_cut_to_a_rank_block(tensor_dim):
    """Rank 0 of (2, 2, 2) (data 0, fsdp 0, tensor 0) holds the first rows
    of the 4-way data split and, along ``tensor_dim``, the first block."""
    mesh = tmesh.make_mesh(2, 2, 2, devices=RANKS)
    shape = (3, 4, 6)
    with act_sharding.activation_mesh(mesh):
        got = act_sharding.rand(shape, torch.Generator().manual_seed(3), "cpu", tensor_dim)
        assert act_sharding.batch_rows(3) == (12, 0)
    gshape = [12, 4, 6]
    if tensor_dim is not None:
        gshape[tensor_dim] *= 2
    want = torch.rand(gshape, generator=torch.Generator().manual_seed(3))[:3]
    if tensor_dim is not None:
        want = want.narrow(tensor_dim, 0, shape[tensor_dim])
    assert torch.equal(got, want)
    assert torch.equal(act_sharding.rand(shape, torch.Generator().manual_seed(3), "cpu"),
                       torch.rand(shape, generator=torch.Generator().manual_seed(3)))
