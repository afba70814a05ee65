"""The port's orbax step reader (``loco_asr_tpu_torch.utils.orbax``, no
orbax or tensorstore) against orbax's own restore, leaf for leaf (type,
dtype, shape, bytes): on the five committed steps under ``exp/loco``, on
fresh steps the JAX ``Checkpointer(use_orbax=True)`` writes (a bf16 leaf,
an int32 scalar array, a float16 leaf, optax's tuple state, a 4 MiB array,
a Python int) and on a step of ``jax.Array`` leaves, whose directory also
holds ``_sharding`` and ``array_metadatas/``.  The ``.npz`` fixtures of
``fixtures/loco_reference`` equal the committed steps they were made from;
``asr_lm2`` equals ``asr_lm``.  A ``"params"`` read leaves the other
subtrees unread.  The port's ``Checkpointer`` lists and averages orbax
steps; an incomplete step raises SystemExit naming what it lacks."""

import glob
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ocp = pytest.importorskip("orbax.checkpoint")

import jax
import jax.numpy as jnp
import optax

from loco_asr_tpu.utils import checkpoint as jckpt
from loco_asr_tpu_torch.utils import checkpoint as tckpt
from loco_asr_tpu_torch.utils.orbax import restore_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = os.path.join(ROOT, "exp", "loco")
STEPS = sorted(glob.glob(os.path.join(EXP, "*", "ckpt", "step_*")))
FIXTURES = os.path.join(ROOT, "fixtures", "loco_reference")

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ compiler")


def assert_same_tree(got, want, path="state"):
    """``got`` (the port's restore) is ``want`` (orbax's), leaf for leaf."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{path}.{i}")
    elif want is None or isinstance(want, (int, float)):
        assert type(got) is type(want) and got == want, path
    else:
        want = np.asarray(want)
        if str(want.dtype) == "bfloat16":
            assert isinstance(got, torch.Tensor) and got.dtype is torch.bfloat16, path
            got_bytes = got.view(torch.int16).numpy().tobytes()
        else:
            assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
            got_bytes = got.tobytes()
        assert tuple(got.shape) == want.shape and got_bytes == want.tobytes(), path


@pytest.mark.parametrize("step", STEPS, ids=lambda s: s.split(os.sep)[-3])
def test_committed_steps_equal_orbax_restore(step):
    assert_same_tree(restore_step(step), ocp.PyTreeCheckpointer().restore(step))


def _fresh_state():
    rng = np.random.default_rng(5)
    params = {"w": rng.standard_normal((1024, 1024)).astype(np.float32),
              "b16": np.asarray(jnp.asarray(rng.standard_normal(7), jnp.bfloat16)),
              "h": rng.standard_normal((2, 3)).astype(np.float16),
              "n": {"k": np.int32(7)}}
    opt_state = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3)).init(params)
    return {"params": params, "opt_state": opt_state, "step": 5}


def test_fresh_jax_checkpointer_step_equals_orbax_restore(tmp_path):
    jckpt.Checkpointer(str(tmp_path), use_orbax=True).save(5, _fresh_state())
    step = str(tmp_path / "step_5")
    got = restore_step(step)
    assert_same_tree(got, ocp.PyTreeCheckpointer().restore(step))
    assert isinstance(got["opt_state"], list) and got["step"] == 5
    assert got["params"]["b16"].dtype is torch.bfloat16


def test_jax_array_step_with_sharding_files_equals_orbax_restore(tmp_path):
    tree = {"a": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
            "b": jnp.ones((5,), jnp.bfloat16),
            "c": [jnp.zeros((2,), jnp.int32), 3.5, None]}
    step = str(tmp_path / "step_1")
    ocp.PyTreeCheckpointer().save(step, tree)
    assert os.path.exists(os.path.join(step, "_sharding"))
    assert os.path.isdir(os.path.join(step, "array_metadatas"))
    assert_same_tree(restore_step(step), ocp.PyTreeCheckpointer().restore(step))


@pytest.mark.parametrize("name", ["asr", "asr_lm"])
def test_fixture_npz_equals_the_orbax_step(name):
    fixture = glob.glob(os.path.join(FIXTURES, name, "step_*.npz"))[0]
    step = os.path.join(EXP, name, "ckpt", os.path.basename(fixture)[:-4])
    got = tckpt.flatten(restore_step(step)["params"])
    with np.load(fixture) as z:
        want = {k[len("params."):]: z[k] for k in z.files}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes(), k


def test_asr_lm2_equals_asr_lm():
    a = tckpt.flatten(restore_step(os.path.join(EXP, "asr_lm", "ckpt", "step_8000")))
    b = tckpt.flatten(restore_step(os.path.join(EXP, "asr_lm2", "ckpt", "step_8000")))
    assert sorted(a) == sorted(b)
    for k in a:
        if a[k] is not None:
            assert a[k].tobytes() == b[k].tobytes(), k


def test_checkpointer_lists_restores_and_averages_orbax_steps(tmp_path):
    jc = jckpt.Checkpointer(str(tmp_path), use_orbax=True)
    rng = np.random.default_rng(0)
    params = [{"w": rng.standard_normal((4, 3)).astype(np.float32)} for _ in range(3)]
    for i, p in enumerate(params):
        jc.save(10 * (i + 1), {"params": p, "step": 10 * (i + 1)})
    tckpt.Checkpointer(str(tmp_path)).save(40, {"params": {"w": np.zeros((4, 3), np.float32)}})
    ck = tckpt.Checkpointer(str(tmp_path))
    assert ck.steps() == [10, 20, 30, 40]
    assert [ck.is_orbax(s) for s in ck.steps()] == [True, True, True, False]
    np.testing.assert_array_equal(ck.restore(20)["params"]["w"], params[1]["w"])
    mean = tckpt.average_last_k(ck, 3)["w"]
    want = jckpt.average_checkpoints(params[1:] + [{"w": np.zeros((4, 3), np.float32)}])["w"]
    np.testing.assert_array_equal(mean, np.asarray(want))


@pytest.mark.parametrize("missing", ["_METADATA", "manifest.ocdbt", "data"])
def test_incomplete_step_raises_naming_the_file(tmp_path, missing):
    step = str(tmp_path / "step_4000")
    shutil.copytree(os.path.join(EXP, "lm", "ckpt", "step_4000"), step)
    if missing == "data":
        path = max(glob.glob(os.path.join(step, "ocdbt.process_0", "d", "*")),
                   key=os.path.getsize)
        missing = os.path.basename(path)
    else:
        path = os.path.join(step, missing)
    os.remove(path)
    with pytest.raises(SystemExit, match=f"incomplete orbax step directory, no .*{missing}"):
        restore_step(step)


def test_metadata_names_every_leaf_the_reader_returns():
    step = os.path.join(EXP, "lm", "ckpt", "step_4000")
    with open(os.path.join(step, "_METADATA")) as f:
        n_leaves = len(json.load(f)["tree_metadata"])
    flat = tckpt.flatten(restore_step(step))
    assert len(flat) == n_leaves


@pytest.mark.parametrize("step", STEPS, ids=lambda p: p.split(os.sep)[-3])
def test_params_subtree_reads_only_the_params(step, monkeypatch):
    """``restore_step(path, "params")`` is the whole restore's ``params``,
    leaf for leaf, and reads no array of another subtree (optax's state)."""
    from loco_asr_tpu_torch.utils import orbax as torbax

    read, read_array = [], torbax.read_array
    monkeypatch.setattr(torbax, "read_array",
                        lambda store, path: read.append(path) or read_array(store, path))
    got = restore_step(step, "params")
    assert list(got) == ["params"] and read and all(p.startswith("params.") for p in read)
    assert_same_tree(got["params"], ocp.PyTreeCheckpointer().restore(step)["params"])
    with pytest.raises(SystemExit, match="holds no 'weights' subtree"):
        restore_step(step, "weights")


def test_checkpointer_reads_the_params_subtree_of_npz_steps(tmp_path):
    ck = tckpt.Checkpointer(str(tmp_path))
    ck.save(3, {"params": {"w": np.ones((2, 3), np.float32)},
                "opt_state": {"mu": {"w": np.zeros((2, 3), np.float32)}}, "step": np.asarray(3)})
    got = ck.restore(3, "params")
    assert list(got) == ["params"] and list(got["params"]) == ["w"]
    np.testing.assert_array_equal(got["params"]["w"], np.ones((2, 3), np.float32))
    assert sorted(ck.restore(3)) == ["opt_state", "params", "step"]
