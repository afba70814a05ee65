"""Shared pipeline utilities: the trainers' refusal of flags not ported,
batch rounding, SpeechT5 weight loading from every source the JAX package
reads, and the trainers' NaN rollback."""

from __future__ import annotations

import os
import sys
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from ..models.speecht5 import convert
from ..models.speecht5 import model as st5
from ..models.speecht5.config import SpeechT5Config
from ..parallel import train


def refuse_unported(args, jax_pipeline: str) -> None:
    """SystemExit naming every flag of a trainer's ``args`` that this
    package does not support yet: the multi-device ones of the JAX
    trainers (a mesh of more than one device, ring / Ulysses attention,
    ``--sp_devices``)."""
    dims = [int(x) for x in args.mesh.split(",")]
    refused = {
        "--mesh with more than one device": any(d not in (-1, 1) for d in dims),
        f"--attn_impl {args.attn_impl}": args.attn_impl in ("ring", "ulysses"),
        "--sp_devices": bool(args.sp_devices),
    }
    bad = [k for k, v in refused.items() if v]
    if bad:
        raise SystemExit(f"not supported by this package yet: {', '.join(bad)} "
                         f"(use loco_asr_tpu.pipelines.{jax_pipeline})")


def round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


# the first name part of every flat key, in any variant
MODEL_HALVES = ("encoder", "decoder", "text_decoder_postnet", "speech_decoder_postnet")

VARIANTS = {
    "encoder": (st5.asr_init, convert.from_jax_params, convert.encoder_to_jax_params),
    "asr": (st5.asr_model_init, convert.asr_from_jax_params, convert.asr_to_jax_params),
    "tts": (st5.tts_init, convert.tts_from_jax_params, convert.tts_to_jax_params),
}


def load_speecht5_params(checkpoint: Optional[str], cfg: SpeechT5Config, *,
                         device: Optional[Union[str, torch.device]] = None,
                         variant: str = "encoder"
                         ) -> Union[st5.SpeechEncoder, st5.AsrModel, st5.TtsModel]:
    """The speech encoder (``variant="encoder"``), the whole ASR model
    (``"asr"``: encoder, text decoder and vocabulary head) or the TTS model
    (``"tts"``: text encoder, speech decoder and postnet) on ``device``
    (default CUDA), from any source the JAX ``load_speecht5_params`` reads:

      * None          -> seeded random init (smoke/benchmark mode)
      * *.npz         -> a checkpoint of the JAX package (``save_npz``)
      * a directory with ``status.json`` -> a training directory's latest
                         ``.npz`` step (``train_asr``'s)
      * a directory   -> an HF model directory (``model.safetensors`` or
                         ``pytorch_model.bin``)
      * *.safetensors -> HF weights, read by ``utils/safetensors.py``
      * other files   -> a torch state dict (HF) or a fairseq checkpoint
                         with ``model`` (grafted over the init)

    ``.npz`` params and training directories are the whole tree.  HF and
    fairseq weights overlay the seeded init, as the JAX loader's ``_merge``
    does; a shape mismatch raises.  A loaded key of a module that the model
    does not have (``masked_spec_embed`` of a model without SpecAugment, the
    other half of a task model) is dropped: the JAX model carries it unread.
    A loaded key that names no parameter of a module the model has is a
    mis-mapped name and raises.  Every route ends in the strict weight
    bridge of
    ``models/speecht5/convert.py``.
    """
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: expected one of {sorted(VARIANTS)}")
    init, bridge, to_jax = VARIANTS[variant]
    model = init(cfg, device=device)
    if checkpoint is None:
        return model
    flat = _read_params(checkpoint, variant, lambda: to_jax(model))
    model.load_state_dict(bridge(flat, cfg), strict=True)
    return model


def _read_params(checkpoint: str, variant: str,
                 init: Callable[[], Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Flat JAX-layout params of ``checkpoint`` (see
    :func:`load_speecht5_params`); ``init()`` gives the seeded init's,
    which HF and fairseq weights overlay and whose keys they keep."""
    from ..models.speecht5 import import_torch

    if os.path.isdir(checkpoint):
        if os.path.exists(os.path.join(checkpoint, "status.json")):
            from .eval_ppl import training_dir_params
            return training_dir_params(checkpoint)
        for name in ("model.safetensors", "pytorch_model.bin"):
            path = os.path.join(checkpoint, name)
            if os.path.exists(path):
                checkpoint = path
                break
        else:
            raise FileNotFoundError(f"no weights found under {checkpoint}")
    if checkpoint.endswith(".npz"):
        with np.load(checkpoint, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    base = init()
    if checkpoint.endswith(".safetensors"):
        from ..utils.safetensors import load_file
        flat = _merge(base, import_torch.load_hf_state_dict(load_file(checkpoint)))
    else:
        obj = torch.load(checkpoint, map_location="cpu", weights_only=False)
        if isinstance(obj, dict) and "model" in obj and not any(
                k.startswith("speecht5") for k in obj):
            # fairseq speecht5_base.pt: graft the encoder / prenets over the init
            graft = (import_torch.graft_fairseq_into_tts if variant == "tts"
                     else import_torch.graft_fairseq_into_asr)
            flat = graft(base, obj)
        else:
            flat = _merge(base, import_torch.load_hf_state_dict(obj))
    return _known_keys(flat, base)


def _known_keys(flat: Dict[str, np.ndarray], base: Dict[str, np.ndarray]
                ) -> Dict[str, np.ndarray]:
    """``flat`` cut to ``base``'s keys.  A key is dropped where ``base`` has
    no module of its first three name parts (``encoder.prenet.feature_encoder``
    under the text prenet, ``decoder.wrapped_decoder`` under the encoder);
    any other key that ``base`` lacks raises KeyError, naming it."""
    modules = {tuple(k.split(".")[:3]) for k in base}
    stray = sorted(k for k in flat if k not in base
                   and (k.split(".")[0] not in MODEL_HALVES
                        or tuple(k.split(".")[:3]) in modules))
    if stray:
        raise KeyError(f"{len(stray)} loaded keys name no parameter of the model: {stray[:8]}")
    return {k: v for k, v in flat.items() if k in base}


def _merge(base: Dict[str, np.ndarray], loaded: Dict[str, np.ndarray]
           ) -> Dict[str, np.ndarray]:
    """Overlay ``loaded`` onto ``base`` (both flat), raising on a shape
    mismatch."""
    out = dict(base)
    for k, v in loaded.items():
        if k in out and tuple(np.shape(out[k])) != tuple(np.shape(v)):
            raise ValueError(f"shape mismatch for {k}: {np.shape(out[k])} vs {np.shape(v)}")
        out[k] = v
    return out


class NanRollback:
    """The JAX trainers' ``--nan_recovery``: after a step whose loss is not
    finite, log ``event="nan_rollback"`` at that step and put back the
    latest checkpoint's parameters and optimizer state (``load(restored)``
    reads a ``Checkpointer.restore()`` state into the live ones) or, with
    none saved yet, the host snapshot of the state the run started from.
    The step updated the parameters and the optimizer state in place, NaN
    and all, so both are restored whole, the optimizer's count included."""

    def __init__(self, model, opt_state, ckpt, metrics, load: Callable[[Dict], None]):
        self.model, self.opt_state, self.ckpt, self.metrics = model, opt_state, ckpt, metrics
        self.load = load
        self.snapshot = train.host_snapshot(model, opt_state)

    def __call__(self, step: int, loss) -> bool:
        """Whether step ``step`` (1-based) was rolled back."""
        if np.isfinite(float(loss)):
            return False
        print(f"step {step}: non-finite loss; rolling back", file=sys.stderr)
        self.metrics.log(step=step, event="nan_rollback")
        restored = self.ckpt.restore()
        if restored is not None:
            self.load(restored)
        else:
            print("no checkpoint yet; restoring initial state", file=sys.stderr)
            train.restore_snapshot(self.model, self.opt_state, self.snapshot)
        return True
