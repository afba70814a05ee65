"""Helpers over nested dicts of arrays (the JAX-layout parameter trees the
bridges read and write): the part of ``loco_asr_tpu.utils.pytree`` that no
other module of this package carries.  ``flatten_with_paths`` and
``unflatten_from_paths`` are :func:`utils.checkpoint.flatten` (which walks
lists and tuples too, an orbax restore's sequences) and
:func:`utils.checkpoint.unflatten`; ``cast_floating`` is
``ops/layers.cast_parameters`` for modules and ``parallel/train.cast_compute``
for a training step's compute copy."""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from .checkpoint import flatten, unflatten


def num_params(tree: Dict) -> int:
    """Elements over every leaf (None holds none, as in a JAX tree)."""
    return sum(int(np.prod(np.shape(x))) for x in flatten(tree).values() if x is not None)


def from_torch(x: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host (bfloat16 as float32, which
    numpy can hold)."""
    x = x.detach().cpu()
    return (x.float() if x.dtype is torch.bfloat16 else x).numpy()


def torch_state_dict_to_numpy(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: from_torch(v) for k, v in state_dict.items()}


def map_leaves_with_paths(tree: Dict, fn: Callable[[str, Any], Any]) -> Dict:
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    return unflatten({k: fn(k, v) for k, v in flatten(tree).items()})


def iter_leaves(tree: Dict) -> Iterator[Tuple[str, Any]]:
    yield from flatten(tree).items()


def assert_trees_match(expected: Dict, got: Dict) -> None:
    """The same keys and the same shapes, as ``load_state_dict(strict=True)``
    asks; raises ValueError naming the first differences."""
    e, g = flatten(expected), flatten(got)
    missing, unexpected = sorted(set(e) - set(g)), sorted(set(g) - set(e))
    if missing or unexpected:
        raise ValueError(
            f"Param tree mismatch. Missing: {missing[:8]}{'...' if len(missing) > 8 else ''} "
            f"Unexpected: {unexpected[:8]}{'...' if len(unexpected) > 8 else ''}")
    bad = [(k, tuple(np.shape(e[k])), tuple(np.shape(g[k]))) for k in e
           if tuple(np.shape(e[k])) != tuple(np.shape(g[k]))]
    if bad:
        raise ValueError(f"Shape mismatches: {bad[:8]}")
