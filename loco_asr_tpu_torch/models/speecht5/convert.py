"""Weight bridge from the JAX package's SpeechT5 parameters.

:func:`from_jax_params` takes the ``.``-joined flat dict of
``loco_asr_tpu.utils.pytree.flatten_with_paths`` -- the key layout of that
package's ``.npz`` checkpoints too -- and returns a state dict for
``model.SpeechEncoder``.  Only the ``encoder.`` subtree is read (the
decoder is not ported yet).  Renames: a dense ``kernel`` ([in, out]) is
transposed into an ``nn.Linear`` ``weight`` ([out, in]); a norm ``scale``
becomes ``weight``; convolution weights are torch OIH on both sides.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .config import SpeechT5Config
from .model import SpeechEncoder

PREFIX = "encoder."


def _port_key(jax_key: str):
    parts = jax_key[len(PREFIX):].split(".")
    transpose = parts[-1] == "kernel"
    if parts[-1] in ("kernel", "scale"):
        parts[-1] = "weight"
    return ".".join(parts), transpose


def from_jax_params(flat: Mapping[str, np.ndarray],
                    cfg: SpeechT5Config) -> Dict[str, torch.Tensor]:
    """Flat JAX params -> ``SpeechEncoder(cfg)`` state dict.  Raises on a
    missing or unexpected key of the encoder subtree or a shape mismatch."""
    with torch.device("meta"):
        expected = {k: tuple(v.shape) for k, v in SpeechEncoder(cfg).state_dict().items()}
    state: Dict[str, torch.Tensor] = {}
    unexpected = []
    for key, value in flat.items():
        if not key.startswith(PREFIX):
            continue
        name, transpose = _port_key(key)
        if name not in expected:
            unexpected.append(key)
            continue
        t = torch.from_numpy(np.array(value, dtype=np.float32))
        if transpose:
            t = t.t().contiguous()
        if tuple(t.shape) != expected[name]:
            raise ValueError(f"{key}: shape {tuple(np.shape(value))} does not "
                             f"give {name} {expected[name]}")
        state[name] = t
    missing = sorted(set(expected) - set(state))
    if missing or unexpected:
        raise KeyError(f"JAX encoder params do not match the config: "
                       f"missing {missing}, unexpected {sorted(unexpected)}")
    return state
