"""SpeechT5 models, as in ``loco_asr_tpu.models.speecht5.model``:

* :class:`SpeechEncoder` and :func:`encode_speech` -- waveform -> prenet ->
  relative-position transformer -> per-frame embeddings (the reference's
  embedding-extraction workload);
* :class:`AsrModel` -- encoder + text decoder + vocabulary head (the JAX
  ``asr_init`` tree) with :func:`asr_forward` (teacher-forced logits),
  :func:`asr_loss` (shift-right cross-entropy), :func:`asr_cross_cache`
  and :func:`asr_decode_step` (one incremental decode step);
* :class:`TtsModel` (text encoder + speech decoder + speech postnet, the
  JAX ``tts_init`` tree) with :func:`encode_text`, :func:`tts_forward`
  (teacher-forced mels) and :func:`tts_generate` (autoregressive mels);
  :class:`S2sModel` (the JAX ``s2s_init`` tree) with :func:`s2s_forward`
  (voice conversion); :func:`shift_spectrograms_right`.  Log-mel targets
  come from kernel B7 (``ops/cuda/logmel.py``), waveforms from the HiFi-GAN
  vocoder (``vocoder.py``).

Parameter names follow the JAX tree (``SpeechEncoder`` drops the
``encoder.`` prefix); ``convert`` maps one onto the other.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ...ops import layers
from ...ops.remat import RematSpec
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
                freeze_feature_encoder: bool = False,
                remat: RematSpec = None, attn_impl: Optional[str] = None,
                sp=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``attn_impl`` None follows ``use_kernels`` (flash with them,
        dense without); ``use_kernels=False`` always runs the plain
        versions (dense attention, B2's plain version).  "ring" /
        "ulysses" run the prenet on the whole waveform and the encoder
        layers on this rank's block of the frames (``sp``), and return that
        block with the whole frame mask."""
        if attn_impl is None or not use_kernels:
            attn_impl = "flash" if use_kernels else "dense"
        hidden, mask = self.prenet(input_values, attention_mask,
                                   use_kernels=use_kernels, generator=generator,
                                   freeze_feature_encoder=freeze_feature_encoder)
        hidden = self.wrapped_encoder(hidden, mask, attn_impl=attn_impl,
                                      generator=generator, remat=remat, sp=sp)
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
                  use_kernels: bool = True, attn_impl: Optional[str] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Raw waveform [B, T] -> ([B, frames, H], [B, frames] frame mask or
    None), on the model's device.

    ``use_kernels`` runs the main path: kernel B2 for the first conv layer
    and, under ``attn_impl`` "flash" (the default with kernels), kernel B1
    in every encoder layer; ``attn_impl="dense"`` keeps B2 and
    materialises the encoder's scores.  ``use_kernels=False`` runs the
    plain PyTorch versions with dense attention.  An :class:`AsrModel`
    runs its encoder.
    """
    if isinstance(model, AsrModel):
        model = model.encoder
    dev = next(model.parameters()).device
    wav = torch.as_tensor(input_values, dtype=torch.float32, device=dev)
    mask = (None if attention_mask is None
            else torch.as_tensor(attention_mask, device=dev))
    with torch.no_grad():
        return model(wav, mask, use_kernels=use_kernels, attn_impl=attn_impl)


def asr_forward(model: AsrModel, input_values: torch.Tensor,
                decoder_input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                decoder_attention_mask: Optional[torch.Tensor] = None, *,
                attn_impl: str = "dense",
                generator: Optional[torch.Generator] = None,
                freeze_feature_encoder: bool = False,
                remat: RematSpec = None, sp=None) -> torch.Tensor:
    """Teacher-forced ASR forward -> vocabulary logits [B, L, V].

    ``attn_impl="flash"`` runs kernel B1 in the encoder and both decoder
    attentions through the kernels (B5 causal self-attention, B1 mask-only
    cross-attention); ``"dense"`` materialises every score matrix and runs
    kernel B2's plain version when the feature encoder takes no gradient.
    Dropout and SpecAugment draw from ``generator`` in training mode.
    ``remat`` (``ops/remat.py``) applies to the encoder stack only, as in
    the JAX model.  ``"ring"`` / ``"ulysses"`` run the encoder layers
    sequence-parallel over ``sp`` (``parallel/sp.py``) and the decoder dense
    on the gathered encodings, as JAX's; the prenet and the decoder run
    whole on every rank of the group."""
    cfg = model.cfg
    if attn_impl in ("ring", "ulysses"):
        block, enc_mask = model.encoder(
            input_values, attention_mask, use_kernels=True, generator=generator,
            freeze_feature_encoder=freeze_feature_encoder, remat=remat,
            attn_impl=attn_impl, sp=sp)
        encoder_hidden = sp.gather(block, 1)
        attn_impl = "dense"
    else:
        encoder_hidden, enc_mask = model.encoder(
            input_values, attention_mask, use_kernels=attn_impl == "flash",
            generator=generator, freeze_feature_encoder=freeze_feature_encoder,
            remat=remat)
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
             freeze_feature_encoder: bool = False, remat: RematSpec = None, sp=None
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
                         freeze_feature_encoder=freeze_feature_encoder, remat=remat, sp=sp)
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


# -- TTS and voice conversion -------------------------------------------

class TextEncoder(nn.Module):
    """Text encoder prenet + transformer encoder (the ``encoder`` subtree
    of the JAX ``tts_init``)."""

    def __init__(self, cfg: SpeechT5Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.prenet = prenets.TextEncoderPrenet(cfg, generator)
        self.wrapped_encoder = enc.Encoder(cfg, generator)


class SpeechDecoder(nn.Module):
    """Speech decoder prenet + transformer decoder (the ``decoder``
    subtree of the JAX ``tts_init`` / ``s2s_init``)."""

    def __init__(self, cfg: SpeechT5Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.prenet = prenets.SpeechDecoderPrenet(cfg, generator)
        self.wrapped_decoder = dec.Decoder(cfg, generator)


class TtsModel(nn.Module):
    """Text encoder, speech decoder and speech decoder postnet: the JAX
    ``tts_init`` tree."""

    def __init__(self, cfg: SpeechT5Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.encoder = TextEncoder(cfg, generator)
        self.decoder = SpeechDecoder(cfg, generator)
        self.speech_decoder_postnet = prenets.SpeechDecoderPostnet(cfg, generator)


class S2sModel(nn.Module):
    """Speech encoder, speech decoder and speech decoder postnet: the JAX
    ``s2s_init`` tree (voice conversion)."""

    def __init__(self, cfg: SpeechT5Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.encoder = SpeechEncoder(cfg, generator)
        self.decoder = SpeechDecoder(cfg, generator)
        self.speech_decoder_postnet = prenets.SpeechDecoderPostnet(cfg, generator)


def tts_init(cfg: SpeechT5Config, *, seed: int = 0,
             device: Optional[Union[str, torch.device]] = None) -> TtsModel:
    """Seeded random init of the TTS model (the distributions of the JAX
    ``tts_init``; the numbers differ), in eval mode on ``device`` (default
    CUDA; raises when no GPU is present)."""
    dev = resolve_device(device)
    return TtsModel(cfg, torch.Generator().manual_seed(seed)).to(dev).eval()


def s2s_init(cfg: SpeechT5Config, *, seed: int = 0,
             device: Optional[Union[str, torch.device]] = None) -> S2sModel:
    """Seeded random init of the voice-conversion model (JAX ``s2s_init``'s
    distributions), in eval mode on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    return S2sModel(cfg, torch.Generator().manual_seed(seed)).to(dev).eval()


def encode_text(model: TtsModel, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Token ids [B, L] -> [B, L, H]: text encoder prenet, then the
    relative-position encoder under the [B, L] key mask, with dense
    attention as every JAX caller of ``encode_text`` runs it."""
    hidden = prenets.text_encoder_prenet(model.encoder.prenet, input_ids)
    return model.encoder.wrapped_encoder(hidden, attention_mask, attn_impl="dense",
                                         generator=generator)


Mels = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _speech_decode(model: Union[TtsModel, S2sModel], encoder_hidden: torch.Tensor,
                   enc_mask: Optional[torch.Tensor], decoder_input_values: torch.Tensor,
                   speaker_embeddings: Optional[torch.Tensor],
                   generator: Optional[torch.Generator],
                   prenet_generator: Optional[torch.Generator]) -> Mels:
    dec_in = prenets.speech_decoder_prenet(model.decoder.prenet, decoder_input_values,
                                           speaker_embeddings, generator=prenet_generator)
    hidden = dec.decoder(model.decoder.wrapped_decoder, dec_in, encoder_hidden,
                         encoder_attention_mask=enc_mask, generator=generator)
    return prenets.speech_decoder_postnet(model.speech_decoder_postnet, hidden)


def tts_forward(model: TtsModel, input_ids: torch.Tensor,
                decoder_input_values: torch.Tensor,
                speaker_embeddings: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None,
                prenet_generator: Optional[torch.Generator] = None) -> Mels:
    """Teacher-forced TTS -> (mel_before, mel_after [B, T*r, mel],
    stop_logits [B, T*r]).  ``decoder_input_values`` [B, T, mel] are, in
    training, label mels thinned and shifted by
    :func:`shift_spectrograms_right`.  Encoder and decoder dropout draw
    from ``generator`` in training mode; the prenet's dropout draws from
    ``prenet_generator`` whenever one is given (HF's rule)."""
    encoder_hidden = encode_text(model, input_ids, attention_mask, generator=generator)
    return _speech_decode(model, encoder_hidden, attention_mask, decoder_input_values,
                          speaker_embeddings, generator, prenet_generator)


def s2s_forward(model: S2sModel, input_values: torch.Tensor,
                decoder_input_values: torch.Tensor,
                speaker_embeddings: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None, *,
                use_kernels: bool = True,
                generator: Optional[torch.Generator] = None,
                prenet_generator: Optional[torch.Generator] = None) -> Mels:
    """Teacher-forced voice conversion: waveform [B, T] -> (mel_before,
    mel_after, stop_logits).  The speech encoder runs as in
    :func:`encode_speech`: with ``use_kernels`` kernel B2 (when no
    gradient is wanted) and kernel B1 in every layer; without, their plain
    versions and dense attention.  The decoder is dense, as in JAX."""
    encoder_hidden, enc_mask = model.encoder(input_values, attention_mask,
                                             use_kernels=use_kernels, generator=generator)
    return _speech_decode(model, encoder_hidden, enc_mask, decoder_input_values,
                          speaker_embeddings, generator, prenet_generator)


def shift_spectrograms_right(mel: torch.Tensor, reduction_factor: int = 1) -> torch.Tensor:
    """Label mels [B, T, mel] -> decoder inputs: keep every
    ``reduction_factor``-th frame (the last of each group), then shift
    right one step behind a zero frame (HF ``shift_spectrograms_right``)."""
    if reduction_factor > 1:
        mel = mel[:, reduction_factor - 1::reduction_factor]
    return torch.cat([torch.zeros_like(mel[:, :1]), mel[:, :-1]], dim=1)


@torch.no_grad()
def tts_generate(model: TtsModel, input_ids: torch.Tensor,
                 speaker_embeddings: torch.Tensor,
                 attention_mask: Optional[torch.Tensor] = None, *,
                 threshold: float = 0.5, minlenratio: float = 0.0,
                 maxlenratio: float = 20.0,
                 prenet_generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Autoregressive mel synthesis -> (refined mel [B, maxlen * r, mel],
    frame lengths [B] int32), the loop of the JAX ``tts_generate``: a zero
    first frame; per step one prenet position, one decoder step over a KV
    cache of ``maxlen + 1`` slots (cross K/V computed once), r frames from
    ``feat_out``; a row stops once ``sum(sigmoid(prob_out)) >= threshold``
    and ``step + 1 >= minlen``, with length ``(step + 1) * r``; rows that
    never stop get ``steps * r``.  The Python loop ends when every row has
    stopped or at ``maxlen = int(L * maxlenratio / r)`` steps.  The conv
    postnet runs over the whole padded buffer, as in JAX (HF crops each
    row first, so a row's last frames can differ from HF's)."""
    if speaker_embeddings is None:
        raise ValueError("speaker_embeddings must be specified")
    cfg = model.cfg
    if attention_mask is None:
        attention_mask = (input_ids != cfg.pad_token_id).to(torch.int32)
    b = input_ids.shape[0]
    encoder_hidden = encode_text(model, input_ids, attention_mask)
    t_enc = encoder_hidden.shape[1]
    r, n_mel = cfg.reduction_factor, cfg.num_mel_bins
    maxlen = int(t_enc * maxlenratio / r)
    minlen = int(t_enc * minlenratio / r)
    dev, dtype = encoder_hidden.device, encoder_hidden.dtype

    caches = dec.init_decode_cache(cfg, b, maxlen + 1, dev, dtype)
    cross = dec.init_cross_cache(model.decoder.wrapped_decoder, encoder_hidden)
    postnet = model.speech_decoder_postnet
    spec_buf = torch.zeros((b, maxlen * r, n_mel), dtype=dtype, device=dev)
    frame = torch.zeros((b, n_mel), dtype=dtype, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    lengths = torch.full((b,), maxlen * r, dtype=torch.int32, device=dev)
    idx = 0
    while idx < maxlen:
        dec_in = prenets.speech_decoder_prenet_step(model.decoder.prenet, frame, idx,
                                                    speaker_embeddings,
                                                    generator=prenet_generator)
        hidden = dec.decoder(model.decoder.wrapped_decoder, dec_in[:, None, :],
                             encoder_hidden, encoder_attention_mask=attention_mask,
                             kv_caches=caches, cache_index=idx, cross_caches=cross)
        last = hidden[:, 0]
        spectrum = postnet.feat_out(last).reshape(b, r, n_mel)
        spec_buf[:, idx * r:(idx + 1) * r] = spectrum
        stop = torch.sigmoid(postnet.prob_out(last)).sum(-1) >= threshold
        stop = stop & (idx + 1 >= minlen)
        lengths = torch.where(stop & ~done, (idx + 1) * r, lengths).to(torch.int32)
        done = done | stop
        frame = spectrum[:, -1]
        idx += 1
        if bool(done.all()):
            break
    lengths = torch.where(done, lengths, idx * r).to(torch.int32)
    return prenets.speech_decoder_postnet_conv(postnet, spec_buf), lengths
