"""SpeechT5 ASR model, as in ``loco_asr_tpu.models.speecht5.model``:

* :class:`SpeechEncoder` and :func:`encode_speech` -- waveform -> prenet ->
  relative-position transformer -> per-frame embeddings (the reference's
  embedding-extraction workload);
* :class:`AsrModel` -- encoder + text decoder + vocabulary head (the JAX
  ``asr_init`` tree) with :func:`asr_forward` (teacher-forced logits),
  :func:`asr_loss` (shift-right cross-entropy), :func:`asr_cross_cache`
  and :func:`asr_decode_step` (one incremental decode step).

Parameter names follow the JAX tree (``SpeechEncoder`` drops the
``encoder.`` prefix); ``convert`` maps one onto the other.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ...ops import layers
from ...utils.device import resolve_device
from . import decoder as dec
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
                use_kernels: bool = True,
                generator: Optional[torch.Generator] = None,
                freeze_feature_encoder: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        hidden, mask = self.prenet(input_values, attention_mask,
                                   use_kernels=use_kernels, generator=generator,
                                   freeze_feature_encoder=freeze_feature_encoder)
        hidden = self.wrapped_encoder(hidden, mask,
                                      attn_impl="flash" if use_kernels else "dense",
                                      generator=generator)
        return hidden, mask


class TextDecoder(nn.Module):
    """Text decoder prenet + transformer decoder (the JAX ``decoder``
    subtree)."""

    def __init__(self, cfg: SpeechT5Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.prenet = prenets.TextDecoderPrenet(cfg, generator)
        self.wrapped_decoder = dec.Decoder(cfg, generator)


class AsrModel(nn.Module):
    """Speech encoder, text decoder and vocabulary head: the JAX
    ``asr_init`` tree (``encoder``, ``decoder``, ``text_decoder_postnet``)."""

    def __init__(self, cfg: SpeechT5Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.encoder = SpeechEncoder(cfg, generator)
        self.decoder = TextDecoder(cfg, generator)
        self.text_decoder_postnet = prenets.TextDecoderPostnet(cfg, generator)


def asr_init(cfg: SpeechT5Config, *, seed: int = 0,
             device: Optional[Union[str, torch.device]] = None) -> SpeechEncoder:
    """Seeded random init of the speech encoder (the distributions of the
    JAX ``asr_init``; the numbers differ), in eval mode on ``device``
    (default CUDA; raises when no GPU is present)."""
    dev = resolve_device(device)
    model = SpeechEncoder(cfg, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def asr_model_init(cfg: SpeechT5Config, *, seed: int = 0,
                   device: Optional[Union[str, torch.device]] = None) -> AsrModel:
    """Seeded random init of the whole ASR model (the distributions of the
    JAX ``asr_init``; the numbers differ), in eval mode on ``device``
    (default CUDA; raises when no GPU is present)."""
    dev = resolve_device(device)
    model = AsrModel(cfg, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


ArrayLike = Union[torch.Tensor, np.ndarray]


def encode_speech(model: Union[SpeechEncoder, AsrModel], input_values: ArrayLike,
                  attention_mask: Optional[ArrayLike] = None, *,
                  use_kernels: bool = True
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Raw waveform [B, T] -> ([B, frames, H], [B, frames] frame mask or
    None), on the model's device.

    ``use_kernels`` runs the main path: kernel B2 for the first conv layer
    and kernel B1 (``attn_impl="flash"``) in every encoder layer; False
    runs their plain PyTorch versions with dense attention.  An
    :class:`AsrModel` runs its encoder.
    """
    if isinstance(model, AsrModel):
        model = model.encoder
    dev = next(model.parameters()).device
    wav = torch.as_tensor(input_values, dtype=torch.float32, device=dev)
    mask = (None if attention_mask is None
            else torch.as_tensor(attention_mask, device=dev))
    with torch.no_grad():
        return model(wav, mask, use_kernels=use_kernels)


def asr_forward(model: AsrModel, input_values: torch.Tensor,
                decoder_input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                decoder_attention_mask: Optional[torch.Tensor] = None, *,
                attn_impl: str = "dense",
                generator: Optional[torch.Generator] = None,
                freeze_feature_encoder: bool = False) -> torch.Tensor:
    """Teacher-forced ASR forward -> vocabulary logits [B, L, V].

    ``attn_impl="flash"`` runs kernel B1 in the encoder and both decoder
    attentions through the kernels (B5 causal self-attention, B1 mask-only
    cross-attention); ``"dense"`` materialises every score matrix and runs
    kernel B2's plain version when the feature encoder takes no gradient.
    Dropout and SpecAugment draw from ``generator`` in training mode."""
    cfg = model.cfg
    flash = attn_impl == "flash"
    encoder_hidden, enc_mask = model.encoder(
        input_values, attention_mask, use_kernels=flash, generator=generator,
        freeze_feature_encoder=freeze_feature_encoder)
    dec_in = prenets.text_decoder_prenet(model.decoder.prenet, decoder_input_ids)
    dec_in = layers.dropout(dec_in, cfg.positional_dropout, generator, model.training)
    hidden = dec.decoder(model.decoder.wrapped_decoder, dec_in, encoder_hidden,
                         attention_mask=decoder_attention_mask,
                         encoder_attention_mask=enc_mask, generator=generator,
                         attn_impl=attn_impl)
    return model.text_decoder_postnet.lm_head(hidden)


def asr_loss(model: AsrModel, input_values: torch.Tensor,
             attention_mask: torch.Tensor, labels: torch.Tensor, *,
             label_pad_id: int = -100, attn_impl: str = "dense",
             generator: Optional[torch.Generator] = None,
             freeze_feature_encoder: bool = False
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token-mean cross-entropy with the HF shift-right convention (decoder
    inputs ``[decoder_start, labels[:-1]]``, ``label_pad_id`` -> pad) ->
    (loss, {"nll_sum", "ntokens"}); log-softmax in float32."""
    cfg = model.cfg
    start = torch.full((labels.shape[0], 1), cfg.decoder_start_token_id,
                       dtype=labels.dtype, device=labels.device)
    shifted = torch.cat([start, labels[:, :-1]], dim=1)
    shifted = shifted.masked_fill(shifted == label_pad_id, cfg.pad_token_id)
    logits = asr_forward(model, input_values, shifted, attention_mask,
                         attn_impl=attn_impl, generator=generator,
                         freeze_feature_encoder=freeze_feature_encoder)
    valid = labels != label_pad_id
    tgt = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    n = torch.clamp(valid.sum(), min=1)
    nll_sum = (nll * valid).sum()
    return nll_sum / n, {"ntokens": n, "nll_sum": nll_sum}


def asr_cross_cache(model: AsrModel, encoder_hidden: torch.Tensor) -> dec.Cache:
    """Per-layer cross-attention K/V for incremental decoding."""
    return dec.init_cross_cache(model.decoder.wrapped_decoder, encoder_hidden)


def asr_decode_step(model: AsrModel, token_ids: torch.Tensor,
                    step: Union[int, torch.Tensor], encoder_hidden: torch.Tensor,
                    encoder_mask: Optional[torch.Tensor], kv_caches: dec.Cache,
                    cross_caches: Optional[dec.Cache] = None) -> torch.Tensor:
    """One incremental decode step over [B, 1] tokens at position ``step``
    (int or [B]) -> logits [B, V]; ``kv_caches`` is updated in place."""
    dec_in = prenets.text_decoder_prenet(model.decoder.prenet, token_ids,
                                         past_length=step)
    hidden = dec.decoder(model.decoder.wrapped_decoder, dec_in, encoder_hidden,
                         encoder_attention_mask=encoder_mask, kv_caches=kv_caches,
                         cache_index=step, cross_caches=cross_caches)
    return model.text_decoder_postnet.lm_head(hidden)[:, -1, :]
