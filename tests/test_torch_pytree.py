"""``loco_asr_tpu_torch.utils.pytree`` against ``loco_asr_tpu.utils.pytree``
on the same trees: ``num_params``, ``map_leaves_with_paths``,
``iter_leaves``, ``from_torch`` / ``torch_state_dict_to_numpy`` and
``assert_trees_match`` (its messages too); the flatten pair is
``utils/checkpoint``'s, held to JAX's ``flatten_with_paths`` here."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from loco_asr_tpu.utils import pytree as jtree
from loco_asr_tpu_torch.utils import checkpoint as tckpt
from loco_asr_tpu_torch.utils import pytree as ttree


def _tree():
    rng = np.random.default_rng(0)
    return {"enc": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                    "b": np.zeros(4, np.float32)},
            "head": {"kernel": rng.standard_normal((4, 2)).astype(np.float32)}}


def test_counts_paths_and_maps_as_jax():
    tree = _tree()
    assert ttree.num_params(tree) == jtree.num_params(tree) == 24
    assert list(ttree.iter_leaves(tree)) == [(k, v) for k, v in jtree.iter_leaves(tree)]
    assert tckpt.flatten(tree).keys() == jtree.flatten_with_paths(tree).keys()
    fn = lambda path, x: x * (2 if path.startswith("enc") else 3)  # noqa: E731
    got, want = ttree.map_leaves_with_paths(tree, fn), jtree.map_leaves_with_paths(tree, fn)
    for k, v in jtree.flatten_with_paths(want).items():
        np.testing.assert_array_equal(tckpt.flatten(got)[k], np.asarray(v))


def test_flatten_walks_lists_and_tuples_as_jax_counts_them():
    """An orbax restore's sequences (optax's tuple state) are nodes, keyed
    by position; a None leaf is kept by path and counts no element."""
    tree = {"a": [np.ones(3), {"b": np.zeros((2, 2))}], "c": (np.arange(2),), "d": None}
    assert list(tckpt.flatten(tree)) == ["a.0", "a.1.b", "c.0", "d"]
    assert ttree.num_params(tree) == jtree.num_params(tree) == 9


def test_torch_state_dict_to_numpy():
    sd = {"a": torch.arange(3.0), "b": torch.ones(2, dtype=torch.bfloat16)}
    out = ttree.torch_state_dict_to_numpy(sd)
    np.testing.assert_array_equal(out["a"], jtree.from_torch(sd["a"]))
    assert out["b"].dtype == np.float32 and out["b"].tolist() == [1.0, 1.0]


@pytest.mark.parametrize("change", ["same", "missing", "unexpected", "shape"])
def test_assert_trees_match_as_jax(change):
    want, got = _tree(), _tree()
    if change == "missing":
        del got["enc"]["b"]
    elif change == "unexpected":
        got["enc"]["extra"] = np.zeros(1)
    elif change == "shape":
        got["head"]["kernel"] = np.zeros((2, 4))
    if change == "same":
        ttree.assert_trees_match(want, got)
        jtree.assert_trees_match(want, got)
        return
    with pytest.raises(ValueError) as t_err:
        ttree.assert_trees_match(want, got)
    with pytest.raises(ValueError) as j_err:
        jtree.assert_trees_match(want, got)
    assert str(t_err.value) == str(j_err.value)
