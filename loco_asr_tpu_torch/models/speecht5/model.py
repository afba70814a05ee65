"""SpeechT5 speech encoder: waveform -> prenet -> relative-position
transformer -> per-frame embeddings, the forward of
``loco_asr_tpu.models.speecht5.model.encode_speech`` (the reference's
embedding-extraction workload).

Parameter names follow the JAX tree's ``encoder`` subtree with that prefix
dropped (``prenet.*``, ``wrapped_encoder.*``); ``convert.from_jax_params``
maps one onto the other.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ...utils.device import resolve_device
from . import encoder as enc
from . import prenets
from .config import SpeechT5Config


class SpeechEncoder(nn.Module):
    """Speech prenet + transformer encoder (the encoder half of the JAX
    ``asr_init`` tree)."""

    def __init__(self, cfg: SpeechT5Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.prenet = prenets.SpeechPrenet(cfg, generator)
        self.wrapped_encoder = enc.Encoder(cfg, generator)

    def forward(self, input_values: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None, *,
                use_kernels: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        hidden, mask = self.prenet(input_values, attention_mask,
                                   use_kernels=use_kernels)
        hidden = self.wrapped_encoder(hidden, mask,
                                      attn_impl="flash" if use_kernels else "dense")
        return hidden, mask


def asr_init(cfg: SpeechT5Config, *, seed: int = 0,
             device: Optional[Union[str, torch.device]] = None) -> SpeechEncoder:
    """Seeded random init of the speech encoder (the distributions of the
    JAX ``asr_init``; the numbers differ), in eval mode on ``device``
    (default CUDA; raises when no GPU is present)."""
    dev = resolve_device(device)
    model = SpeechEncoder(cfg, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


ArrayLike = Union[torch.Tensor, np.ndarray]


def encode_speech(model: SpeechEncoder, input_values: ArrayLike,
                  attention_mask: Optional[ArrayLike] = None, *,
                  use_kernels: bool = True
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Raw waveform [B, T] -> ([B, frames, H], [B, frames] frame mask or
    None), on the model's device.

    ``use_kernels`` runs the main path: kernel B2 for the first conv layer
    and kernel B1 (``attn_impl="flash"``) in every encoder layer; False
    runs their plain PyTorch versions with dense attention.
    """
    dev = next(model.parameters()).device
    wav = torch.as_tensor(input_values, dtype=torch.float32, device=dev)
    mask = (None if attention_mask is None
            else torch.as_tensor(attention_mask, device=dev))
    with torch.no_grad():
        return model(wav, mask, use_kernels=use_kernels)
