"""Weight bridge between the JAX package's SpeechT5 parameters and the
port's modules.

The JAX side is the ``.``-joined flat dict of
``loco_asr_tpu.utils.pytree.flatten_with_paths`` -- the key layout of that
package's ``.npz`` checkpoints too.  Renames: a dense ``kernel`` ([in,
out]) is transposed into an ``nn.Linear`` ``weight`` ([out, in]); a norm
``scale`` becomes ``weight``; convolution weights are torch OIH on both
sides and every other name is kept.

* :func:`from_jax_params` reads the ``encoder.`` subtree into a
  ``model.SpeechEncoder`` state dict (embedding extraction);
* :func:`asr_from_jax_params` reads the whole ``asr_init`` tree into a
  ``model.AsrModel`` state dict;
* :func:`asr_to_jax_params` goes back: an ``AsrModel`` -> flat JAX-layout
  numpy dict (what the trainer's checkpoints store under ``params.``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from ...ops import layers
from .config import SpeechT5Config
from .model import AsrModel, SpeechEncoder

PREFIX = "encoder."


def _port_key(jax_key: str, prefix: str = PREFIX):
    parts = jax_key[len(prefix):].split(".")
    transpose = parts[-1] == "kernel"
    if parts[-1] in ("kernel", "scale"):
        parts[-1] = "weight"
    return ".".join(parts), transpose


def _state_from_jax(flat: Mapping[str, np.ndarray], module: nn.Module,
                    prefix: str, what: str) -> Dict[str, torch.Tensor]:
    expected = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    state: Dict[str, torch.Tensor] = {}
    unexpected = []
    for key, value in flat.items():
        if not key.startswith(prefix):
            continue
        name, transpose = _port_key(key, prefix)
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
        raise KeyError(f"JAX {what} params do not match the config: "
                       f"missing {missing}, unexpected {sorted(unexpected)}")
    return state


def from_jax_params(flat: Mapping[str, np.ndarray],
                    cfg: SpeechT5Config) -> Dict[str, torch.Tensor]:
    """Flat JAX params -> ``SpeechEncoder(cfg)`` state dict.  Raises on a
    missing or unexpected key of the encoder subtree or a shape mismatch;
    keys outside ``encoder.`` are ignored."""
    with torch.device("meta"):
        module = SpeechEncoder(cfg)
    return _state_from_jax(flat, module, PREFIX, "encoder")


def asr_from_jax_params(flat: Mapping[str, np.ndarray],
                        cfg: SpeechT5Config) -> Dict[str, torch.Tensor]:
    """Flat JAX ``asr_init`` params -> ``AsrModel(cfg)`` state dict; raises
    on a missing or unexpected key or a shape mismatch."""
    with torch.device("meta"):
        module = AsrModel(cfg)
    return _state_from_jax(flat, module, "", "ASR")


def jax_names(model: nn.Module) -> Dict[str, tuple]:
    """Port parameter name -> (JAX flat key, transpose) for every parameter
    of ``model``."""
    out = {}
    for mod_name, mod in model.named_modules():
        for p_name, _ in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            if isinstance(mod, nn.Linear) and p_name == "weight":
                out[name] = (f"{mod_name}.kernel", True)
            elif isinstance(mod, layers.Norm) and p_name == "weight":
                out[name] = (f"{mod_name}.scale", False)
            else:
                out[name] = (name, False)
    return out


def asr_to_jax_params(model: AsrModel) -> Dict[str, np.ndarray]:
    """``AsrModel`` -> flat JAX-layout float32 numpy params (the inverse of
    :func:`asr_from_jax_params`)."""
    names = jax_names(model)
    out = {}
    for name, p in model.named_parameters():
        key, transpose = names[name]
        t = p.detach().float().cpu()
        out[key] = (t.t() if transpose else t).contiguous().numpy()
    return out
