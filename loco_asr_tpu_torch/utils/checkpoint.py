"""Step-indexed training checkpoints: the ``.npz`` backend of
``loco_asr_tpu.utils.checkpoint.Checkpointer``, which this package writes,
and the orbax step directories that backend writes where orbax is
installed, which this package reads (``utils/orbax.py``, without orbax).

Layout: ``{dir}/step_{N}.npz`` (or an orbax ``{dir}/step_{N}/``) plus
``{dir}/status.json``, whose
``latest`` names the newest step (the JAX file's ``best`` keys are kept
as they are; nothing here tracks a best step).  A state is a nested dict of arrays, saved
flat with ``.``-joined keys: the trainer stores ``params.<JAX flat key>``
(``convert.asr_to_jax_params``), so the JAX package's ``load_npz`` and
``Checkpointer(use_orbax=False)`` read the parameters, and the optimizer
state under ``opt_state.count``, ``opt_state.mu.<name>``,
``opt_state.nu.<name>`` with the port's parameter names.

:func:`average_checkpoints` and :func:`average_last_k` average saved
parameter trees, as the JAX module's do.

A bfloat16 tensor (a ``--opt_mu_dtype bfloat16`` first moment, a
``--dtype bfloat16`` parameter) is saved as the JAX package's ``.npz``
holds one: its raw 2-byte values as a void (``|V2``) array, since the
``.npy`` format has no bfloat16; a 2-byte void array reads back as
bfloat16.  A file the JAX ``save_npz`` wrote and one written here then
hold the same bytes.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{"a": {"b": x}, "c": [y]} -> {"a.b": x, "c.0": y}: dicts, and the
    lists and tuples of an orbax restore (optax's state), are nodes; a list
    comes back from :func:`unflatten` as an index-keyed dict."""
    out: Dict[str, Any] = {}
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, (dict, list, tuple)):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def unflatten(flat: Dict[str, Any]) -> Dict:
    """Inverse of :func:`flatten`: a key's first parts become nested dicts."""
    tree: Dict = {}
    for path, leaf in flat.items():
        keys = path.split(".")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree


BF16_NPZ = np.dtype("V2")   # how a bfloat16 array is stored in an .npz


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype is torch.bfloat16:
            return x.view(torch.int16).numpy().view(BF16_NPZ)
        return x.numpy()
    return np.asarray(x)


def _tensor_or_array(a: np.ndarray):
    """A stored bfloat16 array (2-byte void) as a bfloat16 tensor; any other
    array as it was stored."""
    if a.dtype == BF16_NPZ:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return a


def save_npz(path: str, tree: Dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{k: _numpy(v) for k, v in flatten(tree).items()})
    os.replace(tmp, path)


def load_npz(path: str, subtree: Optional[str] = None) -> Dict:
    """The tree of :func:`save_npz`: numpy arrays, and bfloat16 tensors for
    the 2-byte void arrays that hold bfloat16 values; with ``subtree`` only
    ``{subtree: ...}``."""
    with np.load(path, allow_pickle=False) as z:
        return unflatten({k: _tensor_or_array(z[k]) for k in z.files
                          if subtree is None or k.startswith(f"{subtree}.")})


class Checkpointer:
    """``{dir}/step_{N}.npz`` checkpoints with resume; reads orbax
    ``{dir}/step_{N}/`` steps too (saving stays ``.npz``)."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _status_path(self) -> str:
        return os.path.join(self.directory, "status.json")

    def status(self) -> Dict[str, Any]:
        if os.path.exists(self._status_path()):
            with open(self._status_path()) as f:
                return json.load(f)
        return {"latest": None, "best": None, "best_metric": None}

    def step_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.npz")

    def is_orbax(self, step: int) -> bool:
        """Whether ``step`` is an orbax step directory (and no ``.npz``)."""
        return (not os.path.exists(self.step_path(step))
                and os.path.isdir(os.path.join(self.directory, f"step_{step}")))

    def save(self, step: int, state: Dict) -> None:
        save_npz(self.step_path(step), state)
        st = self.status()
        st["latest"] = step
        with open(self._status_path(), "w") as f:
            json.dump(st, f)

    def restore(self, step: Optional[int] = None,
                subtree: Optional[str] = None) -> Optional[Dict]:
        """The state of ``step`` (default: latest), or None if none saved;
        with ``subtree`` (``"params"``) only that part of it is read."""
        if step is None:
            step = self.status()["latest"]
        if step is None:
            return None
        if self.is_orbax(step):
            from .orbax import restore_step
            return restore_step(os.path.join(self.directory, f"step_{step}"), subtree)
        return load_npz(self.step_path(step), subtree)

    def steps(self) -> List[int]:
        """Every saved step number, ``.npz`` or orbax, ascending."""
        out = set()
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)(\.npz)?", name)
            if m and (m.group(2) or os.path.isdir(os.path.join(self.directory, name))):
                out.add(int(m.group(1)))
        return sorted(out)


def _float64(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().double().numpy()
    return np.asarray(leaf, np.float64)


def _like(values: np.ndarray, leaf):
    """``values`` in ``leaf``'s dtype (a tensor for a tensor leaf)."""
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(values).to(leaf.dtype)
    return values.astype(np.asarray(leaf).dtype)


def average_checkpoints(states: List[Dict]) -> Dict:
    """Leafwise mean of parameter trees (ASR checkpoint averaging over the
    last saves): summed in float64, cast back to each leaf's dtype.  Pass
    parameter trees (``[s["params"] for s in ...]``)."""
    if not states:
        raise ValueError("no states to average")
    flats = [flatten(s) for s in states]
    if any(f.keys() != flats[0].keys() for f in flats):
        raise ValueError("the trees to average hold different keys")
    out = {}
    for key, first in flats[0].items():
        acc = _float64(first)
        for f in flats[1:]:
            acc = acc + _float64(f[key])
        out[key] = _like(acc / float(len(flats)), first)
    return unflatten(out)


def average_last_k(ckpt: Checkpointer, k: int = 5) -> Optional[Dict]:
    """The mean parameters of the last ``k`` saved steps, or None."""
    steps = ckpt.steps()[-k:]
    if not steps:
        return None
    return average_checkpoints([ckpt.restore(s, "params")["params"] for s in steps])
