"""Shared pipeline utilities: the trainers' refusal of flags not ported,
batch rounding and SpeechT5 weight loading."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..models.speecht5 import convert
from ..models.speecht5 import model as st5
from ..models.speecht5.config import SpeechT5Config


def refuse_unported(args, jax_pipeline: str, **extra: bool) -> None:
    """SystemExit naming every flag of a trainer's ``args`` that this
    package does not support yet: the JAX trainers' common ones (adafactor,
    a bfloat16 first moment or compute type, a mesh of more than one device,
    sequence parallelism, remat, NaN recovery) and ``extra`` (a description
    of the flag -> whether it was given)."""
    dims = [int(x) for x in args.mesh.split(",")]
    refused = {
        "--optimizer adafactor": args.optimizer != "adamw",
        "--opt_mu_dtype bfloat16": args.opt_mu_dtype != "float32",
        "--compute_dtype bfloat16 (the kernels are float32)": args.compute_dtype != "same",
        "--mesh with more than one device": any(d not in (-1, 1) for d in dims),
        f"--attn_impl {args.attn_impl}": args.attn_impl in ("ring", "ulysses"),
        "--sp_devices": bool(args.sp_devices),
        f"--remat {args.remat}": args.remat != "none",
        "--nan_recovery": args.nan_recovery,
        "--nan_inject_step": args.nan_inject_step is not None,
        **extra,
    }
    bad = [k for k, v in refused.items() if v]
    if bad:
        raise SystemExit(f"not supported by this package yet: {', '.join(bad)} "
                         f"(use loco_asr_tpu.pipelines.{jax_pipeline})")


def round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def load_speecht5_params(checkpoint: Optional[str], cfg: SpeechT5Config, *,
                         device: Optional[Union[str, torch.device]] = None,
                         variant: str = "encoder"
                         ) -> Union[st5.SpeechEncoder, st5.AsrModel]:
    """The speech encoder (``variant="encoder"``) or the whole ASR model
    (``"asr"``: encoder, text decoder and vocabulary head) on ``device``
    (default CUDA), from:

      * None   -> seeded random init (smoke/benchmark mode)
      * *.npz  -> a checkpoint of the JAX package (``utils.checkpoint.save_npz``),
                  through ``convert.from_jax_params`` / ``asr_from_jax_params``

    Other formats (HF / fairseq torch files, training directories) are not
    supported by this package yet and raise.
    """
    if variant not in ("encoder", "asr"):
        raise ValueError(f"variant {variant!r}: expected 'encoder' or 'asr'")
    init = st5.asr_init if variant == "encoder" else st5.asr_model_init
    model = init(cfg, device=device)
    if checkpoint is None:
        return model
    if not checkpoint.endswith(".npz"):
        raise ValueError(f"{checkpoint}: only .npz checkpoints of the JAX "
                         "package load in this package so far")
    bridge = convert.from_jax_params if variant == "encoder" else convert.asr_from_jax_params
    with np.load(checkpoint, allow_pickle=False) as z:
        state = bridge({k: z[k] for k in z.files}, cfg)
    model.load_state_dict(state, strict=True)
    return model
