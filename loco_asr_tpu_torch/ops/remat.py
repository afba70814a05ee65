"""Rematerialization policies for the transformer layer stacks, the port of
``loco_asr_tpu.ops.remat``: the SpeechT5 encoder's layers
(``models/speecht5/encoder.py``) and GPT-2's blocks
(``models/gpt2/model.py``) run under one of

  "none"    autograd saves what each op needs;
  "full"    each layer under ``torch.utils.checkpoint`` (non-reentrant):
            only its inputs are saved and the whole layer runs again in the
            backward, the attention kernel included;
  "dots"    the same, with torch's selective checkpoint keeping the outputs
            of the matrix products (``mm``, ``addmm``, ``bmm``,
            ``baddbmm``) and recomputing the rest: norms, activations,
            dropout and the flash kernels, whose outputs are not products
            (JAX's ``dots_saveable``);
  "hybrid"  "dots" and the dropout masks (the ``lt`` that turns the
            uniform draws into a mask; the recompute still draws the
            uniforms, from a replayed generator, and drops them: the
            selective checkpoint runs every op it does not keep);
  "lite"    no checkpoint of the layer: only the chains the JAX package
            tags ``big`` run under a checkpoint of their own
            (:func:`big`): the [B, T, ffn] FFN chain and the dense
            attention's [B, H, Tq, Tk] score chain.  Everything else is
            saved, so a flash kernel does not run again.

Bare ``--remat`` means "full", as in JAX.  Every policy is exact.  JAX's
remat replays dropout because its masks come from keys; the port's draw
from explicit ``torch.Generator``s, which checkpoint's
``preserve_rng_state`` does not restore (it keeps only the default
generators).  So each checkpointed call snapshots its generator's state
before it runs, and its recompute draws from a copy set to that state:
the same masks, while the live generator stays where the forward left it.
With dropout active every policy gives "none"'s loss and gradients
(``tests/test_torch_remat.py``).  Under ``torch.no_grad`` a policy runs
the function as it is.
"""

from __future__ import annotations

import contextvars
import functools
from typing import Callable, Optional, Union

import torch
import torch.utils.checkpoint as ckpt

RematSpec = Union[bool, str, None]

NAMES = ("none", "full", "dots", "hybrid", "lite")

_aten = torch.ops.aten
DOTS = (_aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default)
MASKS = (_aten.lt.Scalar,)   # ``torch.rand(...) < keep`` in ops/layers.py::dropout

_LITE = contextvars.ContextVar("remat_lite", default=False)


def canonicalize(spec: RematSpec) -> str:
    """bool/str/None -> one of :data:`NAMES` (False/None: "none", True:
    "full")."""
    if spec is None or spec is False:
        return "none"
    if spec is True:
        return "full"
    s = str(spec).lower()
    if s not in NAMES:
        raise ValueError(f"unknown remat spec {spec!r}; expected one of {NAMES} (or bool)")
    return s


class _Replay:
    """The generator a checkpointed call draws from: the live one in its
    forward, whose state it snapshots first, and a copy set to that state in
    each recompute."""

    def __init__(self, generator: Optional[torch.Generator]):
        self.generator = generator
        self.state = None if generator is None else generator.get_state()
        self.calls = 0

    def __call__(self) -> Optional[torch.Generator]:
        self.calls += 1
        if self.generator is None or self.calls == 1:
            return self.generator
        copy = torch.Generator(device=self.generator.device)
        copy.set_state(self.state)
        return copy


def _checkpoint(fn: Callable, args: tuple, generator: Optional[torch.Generator],
                saved_ops: Optional[tuple] = None):
    """``fn(*args, generator=)`` under a non-reentrant checkpoint whose
    recompute replays the generator; ``saved_ops``: the ops whose outputs
    a selective checkpoint keeps."""
    replay = _Replay(generator)
    kw = {}
    if saved_ops is not None:
        kw["context_fn"] = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                             list(saved_ops))
    return ckpt.checkpoint(lambda *a: fn(*a, generator=replay()), *args,
                           use_reentrant=False, preserve_rng_state=False, **kw)


def apply(fn: Callable, spec: RematSpec) -> Callable:
    """``fn(*args, generator=None)`` (one layer) under ``spec``; "none"
    returns it as it is."""
    name = canonicalize(spec)
    if name == "none":
        return fn
    if name == "lite":
        def lite(*args, generator=None):
            token = _LITE.set(True)
            try:
                return fn(*args, generator=generator)
            finally:
                _LITE.reset(token)
        return lite
    saved_ops = {"full": None, "dots": DOTS, "hybrid": DOTS + MASKS}[name]

    def layer(*args, generator=None):
        if not torch.is_grad_enabled():
            return fn(*args, generator=generator)
        return _checkpoint(fn, args, generator, saved_ops)
    return layer


def big(fn: Callable, *args, generator: Optional[torch.Generator] = None):
    """``fn(*args, generator=)``, a chain the JAX package tags ``big``:
    under a checkpoint of its own inside a "lite" layer, else called as it
    is."""
    if _LITE.get() and torch.is_grad_enabled():
        return _checkpoint(fn, args, generator)
    return fn(*args, generator=generator)
