"""Shared pipeline utilities: the trainers' refusal of flags not ported,
batch rounding, SpeechT5 weight loading from every source the JAX package
reads, the trainers' NaN rollback, and the row split of the data-parallel
pipelines (:class:`DataParallel`)."""

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


def refuse_unported(args) -> None:
    """SystemExit naming every flag of a trainer's ``args`` that this
    package does not support yet: the sequence-parallel ones of the JAX
    trainers (ring / Ulysses attention, ``--sp_devices``), which wait for
    sequence parallelism (ROADMAP A9)."""
    refused = {
        f"--attn_impl {args.attn_impl}": args.attn_impl in ("ring", "ulysses"),
        "--sp_devices": bool(getattr(args, "sp_devices", 0)),
    }
    bad = [k for k, v in refused.items() if v]
    if bad:
        raise SystemExit(f"not supported by this package yet: {', '.join(bad)} "
                         "(sequence parallelism, ROADMAP A9)")


def restore_own_run(ckpt) -> Optional[Dict]:
    """``--resume``: the latest state of this package's own run in ``ckpt``
    (``.npz`` steps), or None.  An orbax step there (a JAX run) is refused:
    its optimizer state is optax's, which the trainers do not take; its
    weights start a run through ``--checkpoint``."""
    latest = ckpt.status()["latest"]
    if latest is not None and ckpt.is_orbax(latest):
        raise SystemExit(f"{ckpt.directory}/step_{latest}: --resume continues this "
                         "package's own runs (.npz steps); start from a JAX run's "
                         "orbax weights with --checkpoint")
    return ckpt.restore(latest)


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

    def __init__(self, model, opt_state, ckpt, metrics, load: Callable[[Dict], None],
                 mesh=None):
        self.model, self.opt_state, self.ckpt, self.metrics = model, opt_state, ckpt, metrics
        self.load, self.mesh = load, mesh
        self.snapshot = train.host_snapshot(model, opt_state)

    def __call__(self, step: int, loss) -> bool:
        """Whether step ``step`` (1-based) was rolled back (on a mesh, every
        rank agrees through one all-reduce of the finite flag)."""
        finite = bool(np.isfinite(float(loss)))
        if self.mesh is not None:
            import torch.distributed as dist

            from ..parallel import collectives
            flag = torch.tensor([int(finite)], device=self.mesh.device)
            finite = bool(collectives.all_reduce(flag, self.mesh.world, self.mesh,
                                                 op=dist.ReduceOp.MIN).item())
        if finite:
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


def trainer_mesh(args, module: str, argv):
    """The trainers' ``--mesh``: (exit code, None, None) when this process
    started the ranks (``parallel/launch.py``) and they have ended; else
    (None, mesh or None, device): a mesh when this process is a rank,
    None for the single-device run."""
    from ..parallel import launch, mesh as meshlib
    from ..utils.device import resolve_device

    dims = [int(x) for x in args.mesh.split(",")]
    rc = launch.run(module, argv, launch.ranks_wanted(dims), args.device)
    if rc is not None:
        return rc, None, None
    if not launch.is_rank():
        return None, None, resolve_device(args.device)
    dev = launch.rank_device(args.device)
    mesh = meshlib.make_mesh(*dims, device=dev)
    if mesh.rank == 0:
        print(f"mesh: {mesh.shape}", file=sys.stderr)
    return None, mesh, dev


def save_step(ckpt, step: int, model, opt_state, tx, mesh, to_jax: Callable) -> None:
    """Save ``step``: on one device as before; on a mesh every rank gathers
    the parameters and optimizer state whole and rank 0 writes them in the
    single-device layout (``--resume``, ``eval_ppl`` and ``decode_asr`` read
    it unchanged)."""
    if mesh is None:
        ckpt.save(step, {"params": to_jax(model), "opt_state": opt_state,
                         "step": np.asarray(step)})
        return
    import torch.distributed as dist

    from ..parallel import partition

    params = to_jax(model, state=partition.gather_params(model))
    opt = train.gather_opt_state(opt_state, tx, train.layout(model))
    if mesh.rank == 0:
        ckpt.save(step, {"params": params, "opt_state": opt, "step": np.asarray(step)})
    dist.barrier()


def load_step(restored: Dict, model, opt_state, tx, mesh, state: Dict) -> None:
    """Put a restored step back: ``state`` its parameters as a whole port
    state dict; on a mesh re-sharded (this rank's shards)."""
    if mesh is None:
        model.load_state_dict(state, strict=True)
        train.load_opt_state(opt_state, restored["opt_state"])
        return
    from ..parallel import partition

    partition.load_params(model, state)
    train.load_opt_state(opt_state, restored["opt_state"], tx, train.layout(model))


class DataParallel:
    """``--data_parallel N`` of the inference pipelines: the ranks
    (``parallel/launch.py``) hold the whole model each, and every batch is
    split by rows, as JAX's ``data_sharding`` of a ``(N, 1, 1)`` mesh:
    padded with zero rows to a multiple of N (``parallel.train.pad_batch``;
    the batch already has one length, so every rank's rows keep it and the
    encodings do not depend on N), rank r takes block r, and
    :meth:`gather` puts the per-row results back in order, the padding
    dropped.  With one process it is the identity."""

    def __init__(self, n: int, device: str):
        from ..parallel import launch, mesh as meshlib
        from ..utils.device import resolve_device

        self.mesh = None
        if launch.is_rank():
            self.device = launch.rank_device(device)
            self.mesh = meshlib.make_mesh(data=n, device=self.device)
        else:
            self.device = resolve_device(device)

    @property
    def rank0(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def rows(self, *arrays):
        """This rank's rows of each [B, ...] array (numpy)."""
        if self.mesh is None:
            return arrays
        from ..parallel import train

        n = self.mesh.size("data")
        padded = train.pad_batch({str(i): np.asarray(a) for i, a in enumerate(arrays)}, n)
        k = self.mesh.index("data")
        out = []
        for i in range(len(arrays)):
            a = padded[str(i)]
            step = a.shape[0] // n
            out.append(a[k * step:(k + 1) * step])
        return tuple(out)

    def gather(self, local: np.ndarray, total: int) -> np.ndarray:
        """Every rank's rows of a [b, ...] array, in row order, cut to the
        batch's ``total`` rows (trailing dimensions zero-padded to the
        largest rank's)."""
        local = np.asarray(local)
        if self.mesh is None:
            return local[:total]
        from ..parallel import collectives

        parts = collectives.all_gather_objects(local, self.mesh.groups["data"])
        shape = np.max([p.shape for p in parts], axis=0)
        parts = [np.pad(p, [(0, 0)] + [(0, int(m) - n) for m, n in zip(shape[1:], p.shape[1:])])
                 for p in parts]
        return np.concatenate(parts)[:total]
