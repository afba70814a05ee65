"""Debugging aids: the port of ``loco_asr_tpu.utils.debugging``.

* :func:`nan_checks`: within the block, the first op whose output holds a
  NaN raises FloatingPointError naming the op, as ``jax_debug_nans`` does
  (a ``TorchDispatchMode`` sees every op, the backward's included; anomaly
  mode alone checks only the backward).  Each op's output is read on the
  host, so the block runs synchronously.
* :func:`assert_all_finite`: FloatingPointError at a tree's first
  non-finite floating leaf.
* :func:`check_deterministic`: whether repeated calls give bit-identical
  outputs.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterator, List, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .checkpoint import flatten
from .pytree import from_torch


class _NanCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for leaf in tree_flatten(out)[0]:
            if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
                    and bool(torch.isnan(leaf).any())):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def nan_checks(enable: bool = True) -> Iterator[None]:
    """Raise at the op that produces the first NaN in the block."""
    if not enable:
        yield
        return
    with _NanCheck():
        yield


def _leaves(tree: Any) -> List[Tuple[str, Any]]:
    """``tree``'s leaves by path (a lone leaf at path ""), None leaves left out."""
    return [(p, x) for p, x in flatten({"": tree}).items() if x is not None]


def _host(x) -> np.ndarray:
    return from_torch(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_all_finite(tree: Any, name: str = "tree") -> None:
    """Raise FloatingPointError at the first floating leaf of ``tree``
    (tensors, arrays, nested dicts / lists / tuples) that holds a NaN or an
    infinity."""
    for i, (path, leaf) in enumerate(_leaves(tree)):
        arr = _host(leaf)
        if np.issubdtype(arr.dtype, np.floating) and not np.isfinite(arr).all():
            raise FloatingPointError(f"{name}: non-finite values in leaf {i} ({path})")


def check_deterministic(fn: Callable, *args, runs: int = 2) -> bool:
    """Whether ``runs`` calls of ``fn(*args)`` give bit-identical outputs
    (every random draw must come from an explicit generator or seed)."""
    ref = [(p, _host(x)) for p, x in _leaves(fn(*args))]
    for _ in range(runs - 1):
        out = [(p, _host(x)) for p, x in _leaves(fn(*args))]
        if [p for p, _ in out] != [p for p, _ in ref]:
            return False
        if not all(a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
                   for (_, a), (_, b) in zip(ref, out)):
            return False
    return True
