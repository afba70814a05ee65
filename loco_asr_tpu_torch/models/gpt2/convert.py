"""Weight bridges into ``model.GPT2Model``.

* :func:`from_jax_params`: the ``.``-joined flat dict of the JAX package's
  GPT-2 tree (``loco_asr_tpu.utils.pytree.flatten_with_paths``, the key
  layout of its ``.npz`` checkpoints).  A dense ``kernel`` and a norm
  ``scale`` become ``weight``; dense weights are ``[in, out]`` on both
  sides, so nothing is transposed.  :func:`to_jax_params` is its
  inverse, the layout ``train_lm`` saves; :func:`jax_names` the renaming.
* :func:`load_hf_gpt2`: an HF ``GPT2LMHeadModel`` / ``GPT2Model`` state
  dict, the counterpart of ``loco_asr_tpu.models.gpt2.import_torch``.  HF's
  ``Conv1D`` already stores ``[in, out]``; the ``transformer.`` prefix, the
  causal-mask buffers and the tied ``lm_head.weight`` are dropped.

Both return a state dict for ``GPT2Model(cfg)`` and raise on a missing or
unexpected key or a shape mismatch.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .model import GPT2Config, GPT2Model

_HF_SKIP = (".attn.bias", ".attn.masked_bias", "lm_head.weight")
_HF_PREFIX = "transformer."


def _as_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(value, dtype=np.float32))


def _checked(state: Dict[str, torch.Tensor], cfg: GPT2Config, what: str
             ) -> Dict[str, torch.Tensor]:
    with torch.device("meta"):
        expected = {k: tuple(v.shape) for k, v in GPT2Model(cfg).state_dict().items()}
    missing = sorted(set(expected) - set(state))
    unexpected = sorted(set(state) - set(expected))
    if missing or unexpected:
        raise KeyError(f"{what} params do not match the config: "
                       f"missing {missing}, unexpected {unexpected}")
    for name, t in state.items():
        if tuple(t.shape) != expected[name]:
            raise ValueError(f"{what} {name}: shape {tuple(t.shape)}, the config "
                             f"needs {expected[name]}")
    return state


def from_jax_params(flat: Mapping[str, np.ndarray], cfg: GPT2Config
                    ) -> Dict[str, torch.Tensor]:
    """Flat JAX GPT-2 params -> ``GPT2Model(cfg)`` state dict."""
    state = {}
    for key, value in flat.items():
        parts = key.split(".")
        if parts[-1] in ("kernel", "scale"):
            parts[-1] = "weight"
        state[".".join(parts)] = _as_tensor(value)
    return _checked(state, cfg, "JAX GPT-2")


def jax_names(model: GPT2Model) -> Dict[str, tuple]:
    """Port state name -> (JAX flat key, transpose): a dense layer's
    ``weight`` is its ``kernel``, a norm's its ``scale``; the tables keep
    ``weight``; nothing is transposed."""
    out = {}
    for key in model.state_dict():
        parts = key.split(".")
        if parts[-1] == "weight" and parts[0] not in ("wte", "wpe"):
            parts[-1] = "scale" if parts[-2].startswith("ln_") else "kernel"
        out[key] = (".".join(parts), False)
    return out


def to_jax_params(model: GPT2Model, state: Optional[Mapping[str, torch.Tensor]] = None
                  ) -> Dict[str, np.ndarray]:
    """``GPT2Model`` -> flat JAX-layout float32 numpy params (the inverse
    of :func:`from_jax_params`), from ``state`` when given (a whole state
    dict, e.g. ``parallel.partition.gather_params`` of a sharded model)
    else from the model's own."""
    names = jax_names(model)
    state = model.state_dict() if state is None else state
    return {names[k][0]: v.detach().to("cpu", torch.float32).numpy()
            for k, v in state.items()}


def strip_hf_prefix(key: str) -> str:
    return key[len(_HF_PREFIX):] if key.startswith(_HF_PREFIX) else key


def load_hf_gpt2(state_dict: Mapping[str, object], cfg: GPT2Config
                 ) -> Dict[str, torch.Tensor]:
    """HF GPT-2 state dict (tensors or arrays) -> ``GPT2Model(cfg)`` state
    dict."""
    state = {strip_hf_prefix(key): _as_tensor(value)
             for key, value in state_dict.items()
             if not any(key.endswith(s) or s in key for s in _HF_SKIP)}
    return _checked(state, cfg, "HF GPT-2")
