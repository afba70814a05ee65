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
  numpy dict (what the trainer's checkpoints store under ``params.``), and
  :func:`encoder_to_jax_params` likewise for a ``SpeechEncoder``;
* :func:`tts_from_jax_params` / :func:`s2s_from_jax_params` read the
  ``tts_init`` / ``s2s_init`` trees into ``TtsModel`` / ``S2sModel`` state
  dicts, :func:`hifigan_from_jax_params` the ``hifigan_init`` tree (whose
  names are kept as they are) into a ``vocoder.HifiGan`` one, and the
  ``*_to_jax_params`` functions go back.  Batch-norm ``mean`` / ``var`` and
  the vocoder's ``mean`` / ``scale`` are buffers on the port's side.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from ...ops import layers
from .config import SpeechT5Config
from .model import AsrModel, S2sModel, SpeechEncoder, TtsModel
from .vocoder import HifiGan, HifiGanConfig

PREFIX = "encoder."


def _port_key(jax_key: str, prefix: str = PREFIX, rename: bool = True):
    parts = jax_key[len(prefix):].split(".")
    transpose = rename and parts[-1] == "kernel"
    if rename and parts[-1] in ("kernel", "scale"):
        parts[-1] = "weight"
    return ".".join(parts), transpose


def _state_from_jax(flat: Mapping[str, np.ndarray], module: nn.Module,
                    prefix: str, what: str,
                    rename: bool = True) -> Dict[str, torch.Tensor]:
    expected = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    state: Dict[str, torch.Tensor] = {}
    unexpected = []
    for key, value in flat.items():
        if not key.startswith(prefix):
            continue
        name, transpose = _port_key(key, prefix, rename)
        if name not in expected:
            unexpected.append(key)
            continue
        t = (value.detach().float() if isinstance(value, torch.Tensor)   # bf16 leaves
             else torch.from_numpy(np.array(value, dtype=np.float32)))
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


def tts_from_jax_params(flat: Mapping[str, np.ndarray],
                        cfg: SpeechT5Config) -> Dict[str, torch.Tensor]:
    """Flat JAX ``tts_init`` params -> ``TtsModel(cfg)`` state dict; raises
    on a missing or unexpected key or a shape mismatch."""
    with torch.device("meta"):
        module = TtsModel(cfg)
    return _state_from_jax(flat, module, "", "TTS")


def s2s_from_jax_params(flat: Mapping[str, np.ndarray],
                        cfg: SpeechT5Config) -> Dict[str, torch.Tensor]:
    """Flat JAX ``s2s_init`` params -> ``S2sModel(cfg)`` state dict; raises
    on a missing or unexpected key or a shape mismatch."""
    with torch.device("meta"):
        module = S2sModel(cfg)
    return _state_from_jax(flat, module, "", "S2S")


def hifigan_from_jax_params(flat: Mapping[str, np.ndarray],
                            cfg: HifiGanConfig) -> Dict[str, torch.Tensor]:
    """Flat JAX ``hifigan_init`` params -> ``HifiGan(cfg)`` state dict (the
    names are the same on both sides); raises on a missing or unexpected
    key or a shape mismatch."""
    with torch.device("meta"):
        module = HifiGan(cfg)
    return _state_from_jax(flat, module, "", "HiFi-GAN", rename=False)


def jax_names(model: nn.Module, rename: bool = True) -> Dict[str, tuple]:
    """Port state name -> (JAX flat key, transpose) for every parameter and
    persistent buffer of ``model``."""
    saved = set(model.state_dict())
    out = {}
    for mod_name, mod in model.named_modules():
        local = [n for n, _ in mod.named_parameters(recurse=False)]
        local += [n for n, _ in mod.named_buffers(recurse=False)]
        for p_name in local:
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            if name not in saved:      # a non-persistent buffer
                continue
            if rename and isinstance(mod, nn.Linear) and p_name == "weight":
                out[name] = (f"{mod_name}.kernel", True)
            elif rename and isinstance(mod, layers.Norm) and p_name == "weight":
                out[name] = (f"{mod_name}.scale", False)
            else:
                out[name] = (name, False)
    return out


def _to_jax_params(model: nn.Module, rename: bool = True) -> Dict[str, np.ndarray]:
    """Float32 numpy leaves, except that a bfloat16 model's stay bfloat16
    CPU tensors (numpy has no bfloat16; the checkpoint stores them as the
    JAX package does)."""
    names = jax_names(model, rename)
    out = {}
    for name, t in model.state_dict().items():
        key, transpose = names[name]
        t = t.detach().cpu()
        t = (t.t() if transpose else t).contiguous()
        out[key] = t if t.dtype is torch.bfloat16 else t.float().numpy()
    return out


def encoder_to_jax_params(model: SpeechEncoder) -> Dict[str, np.ndarray]:
    """``SpeechEncoder`` -> its flat JAX-layout params under ``encoder.``
    (the inverse of :func:`from_jax_params`)."""
    return {PREFIX + k: v for k, v in _to_jax_params(model).items()}


def asr_to_jax_params(model: AsrModel) -> Dict[str, np.ndarray]:
    """``AsrModel`` -> flat JAX-layout float32 numpy params (the inverse of
    :func:`asr_from_jax_params`)."""
    return _to_jax_params(model)


def tts_to_jax_params(model: TtsModel) -> Dict[str, np.ndarray]:
    """``TtsModel`` -> flat JAX ``tts_init`` layout (inverse of
    :func:`tts_from_jax_params`)."""
    return _to_jax_params(model)


def s2s_to_jax_params(model: S2sModel) -> Dict[str, np.ndarray]:
    """``S2sModel`` -> flat JAX ``s2s_init`` layout (inverse of
    :func:`s2s_from_jax_params`)."""
    return _to_jax_params(model)


def hifigan_to_jax_params(model: HifiGan) -> Dict[str, np.ndarray]:
    """``HifiGan`` -> flat JAX ``hifigan_init`` layout (inverse of
    :func:`hifigan_from_jax_params`)."""
    return _to_jax_params(model, rename=False)
