"""Step-indexed training checkpoints, the ``.npz`` backend of
``loco_asr_tpu.utils.checkpoint.Checkpointer``.

Layout: ``{dir}/step_{N}.npz`` plus ``{dir}/status.json``, whose
``latest`` names the newest step (the JAX file's ``best`` keys are kept
as they are; nothing here tracks a best step).  A state is a nested dict of arrays, saved
flat with ``.``-joined keys: the trainer stores ``params.<JAX flat key>``
(``convert.asr_to_jax_params``), so the JAX package's ``load_npz`` and
``Checkpointer(use_orbax=False)`` read the parameters, and the optimizer
state under ``opt_state.count``, ``opt_state.mu.<name>``,
``opt_state.nu.<name>`` with the port's parameter names.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch


def flatten(tree: Dict, prefix: str = "") -> Dict[str, Any]:
    """{"a": {"b": x}} -> {"a.b": x}."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
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


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_npz(path: str, tree: Dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{k: _numpy(v) for k, v in flatten(tree).items()})
    os.replace(tmp, path)


def load_npz(path: str) -> Dict:
    with np.load(path, allow_pickle=False) as z:
        return unflatten({k: z[k] for k in z.files})


class Checkpointer:
    """``{dir}/step_{N}.npz`` checkpoints with resume."""

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

    def save(self, step: int, state: Dict) -> None:
        save_npz(self.step_path(step), state)
        st = self.status()
        st["latest"] = step
        with open(self._status_path(), "w") as f:
            json.dump(st, f)

    def restore(self, step: Optional[int] = None) -> Optional[Dict]:
        """The state of ``step`` (default: latest), or None if none saved."""
        if step is None:
            step = self.status()["latest"]
        return None if step is None else load_npz(self.step_path(step))
