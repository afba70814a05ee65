"""ASR and LM training steps on one device, as ``loco_asr_tpu.parallel.train``'s
``adamw``, ``make_asr_train_step`` and ``make_lm_train_step`` compute them
(without the mesh: the port trains on one GPU).

* :func:`adamw` -- optax's ``adamw`` (b1 0.9, b2 0.999, eps 1e-8,
  decoupled weight decay on every trainable tensor) with the JAX
  package's warmup-cosine schedule and optional global-norm clipping
  before the moment updates, applied in place with ``torch._foreach_*``;
  ``mu_dtype=torch.bfloat16`` stores the first moment in bf16 in optax's
  order (updated from the float32 gradient, the step built from the
  float32 moment, the moment then stored rounded).
* :func:`cast_compute` -- mixed precision, the JAX ``_cast_compute``:
  inside the differentiated loss the float parameters and batch entries
  are cast to the compute dtype (bf16 copies swapped in for the call by
  ``torch.func.functional_call``), so gradients come back through the
  casts in float32 and the master parameters and optimizer state stay
  float32.  Norms, the attention kernels' softmax and sums, and the
  losses' log-softmax reduce in float32 whatever the compute dtype.
* :func:`reference_adam` -- torch ``Adam(lr, weight_decay)`` (L2 added to
  the gradients before the moments), the JAX ``reference_adam`` of the
  intent classifier, on the same in-place update as :func:`adamw`.
* :func:`make_asr_train_step` -- loss -> backward -> update.  Non-dense
  attention zeroes ``attention_dropout`` with the JAX package's
  ``UserWarning`` (the kernels carry no attention-prob dropout);
  ``grad_accum`` sums ``nll_sum`` gradients over a strided split of the
  batch and divides once by the total token count (exactly the full-batch
  token mean); ``freeze_feature_encoder`` gives the conv stack neither
  gradients nor updates, weight decay included; ``compute_dtype`` runs
  the loss under :func:`cast_compute`; ``remat`` runs the encoder layers
  under a policy of ``ops/remat.py``.
* :func:`make_lm_train_step` -- the GPT-2 causal-LM step: token-mean NLL
  over tokens 1..len-1 of each row, the lm head chunked with recompute
  (default) or dense; ``attn_impl="flash"`` zeroes ``attn_pdrop`` with the
  same warning and runs kernel B6 (B5 where the head dim is not 64 or the
  head count is odd) and its blockwise backward; ``grad_accum``,
  ``compute_dtype`` and ``remat`` (over the blocks) as above.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, Dict, Mapping, Optional

import torch
from torch import nn

from ..models.gpt2 import model as g
from ..models.speecht5 import model as st5
from ..models.speecht5.config import SpeechT5Config
from ..ops.remat import RematSpec

FROZEN_PREFIX = "encoder.prenet.feature_encoder."
B1, B2, EPS = 0.9, 0.999, 1e-8          # optax.adamw's defaults

OptState = Dict[str, object]


class AdamW:
    """AdamW over a dict of named tensors, updated in place.

    ``learning_rate_at(count)`` is optax's ``warmup_cosine_decay_schedule(
    0, lr, warmup, total)`` when ``warmup_steps`` or ``total_steps`` is
    given (warmup clamped below the total, as the JAX ``adamw`` does), else
    the constant ``lr``; step n (counting from 1) uses the rate at n-1."""

    def __init__(self, learning_rate: float = 1e-4, weight_decay: float = 0.01,
                 warmup_steps: int = 0, total_steps: Optional[int] = None,
                 clip_norm: Optional[float] = None,
                 mu_dtype: Optional[torch.dtype] = None):
        self.lr, self.weight_decay, self.clip_norm = learning_rate, weight_decay, clip_norm
        self.mu_dtype = mu_dtype
        self.scheduled = bool(warmup_steps or total_steps)
        self.total = total_steps or warmup_steps * 10
        self.warmup = min(warmup_steps, max(self.total - 1, 0))

    def learning_rate_at(self, count: int) -> float:
        if not self.scheduled:
            return self.lr
        if count < self.warmup:
            return self.lr * count / self.warmup
        decay = self.total - self.warmup
        t = min(count - self.warmup, decay)
        return self.lr * 0.5 * (1.0 + math.cos(math.pi * t / decay)) if decay > 0 else self.lr

    def init(self, params: Mapping[str, torch.Tensor]) -> OptState:
        return {"count": 0,
                "mu": {k: torch.zeros_like(p, dtype=self.mu_dtype) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor],
               grads: Mapping[str, Optional[torch.Tensor]], state: OptState) -> None:
        """One step on ``params`` (in place) from ``grads`` (None = zeros)."""
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] if grads.get(k) is not None else torch.zeros_like(params[k])
             for k in names]
        if self.clip_norm is not None:
            norm = global_norm(g)
            factor = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                                 self.clip_norm / norm)
            g = torch._foreach_mul(g, factor)
        stored = [state["mu"][k] for k in names]
        narrow = any(m.dtype != x.dtype for m, x in zip(stored, g))
        if narrow:
            # optax's order for a narrower stored moment: decay * mu in the
            # stored dtype, with the decay itself in that dtype (JAX's weak
            # typing makes 0.9 * a bf16 array a bf16 product by 0.8984375),
            # (1 - decay) * g added in the gradient's dtype, the step built
            # from that, the moment stored rounded at the end
            mu = [(m * _in_dtype(B1, m.dtype)).to(x.dtype) for m, x in zip(stored, g)]
        else:
            mu = stored
            torch._foreach_mul_(mu, B1)
        nu = [state["nu"][k] for k in names]
        torch._foreach_add_(mu, g, alpha=1.0 - B1)
        torch._foreach_mul_(nu, B2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - B2)
        lr = self.learning_rate_at(state["count"])
        state["count"] += 1
        n = state["count"]
        upd = torch._foreach_div(mu, 1.0 - B1 ** n)
        den = torch._foreach_div(nu, 1.0 - B2 ** n)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, EPS)
        torch._foreach_div_(upd, den)
        if self.weight_decay:
            torch._foreach_add_(upd, p, alpha=self.weight_decay)
        torch._foreach_add_(p, upd, alpha=-lr)
        if narrow:
            for s, m in zip(stored, mu):
                s.copy_(m)


def adamw(learning_rate: float = 1e-4, weight_decay: float = 0.01,
          warmup_steps: int = 0, total_steps: Optional[int] = None,
          clip_norm: Optional[float] = None,
          mu_dtype: Optional[torch.dtype] = None) -> AdamW:
    """AdamW with warmup-cosine schedule and optional global-norm clipping
    (the JAX ``adamw``); ``mu_dtype`` (e.g. ``torch.bfloat16``) stores the
    first moment in that dtype, the second stays in the parameters'."""
    return AdamW(learning_rate, weight_decay, warmup_steps, total_steps, clip_norm,
                 mu_dtype)


def _in_dtype(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``, as a Python float."""
    return float(torch.tensor(x, dtype=dtype))


class ReferenceAdam(AdamW):
    """torch ``Adam(lr, weight_decay)``: the L2 term ``weight_decay * p`` is
    added to the gradient before the moment updates (optax
    ``add_decayed_weights``, ``scale_by_adam``, ``scale(-lr)``); constant
    rate, eps 1e-8, no clipping."""

    def __init__(self, learning_rate: float = 1e-3, weight_decay: float = 1e-4):
        super().__init__(learning_rate, weight_decay=0.0)
        self.l2 = weight_decay

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor],
               grads: Mapping[str, Optional[torch.Tensor]], state: OptState) -> None:
        g = {k: (grads[k] if grads.get(k) is not None else torch.zeros_like(p)) + self.l2 * p
             for k, p in params.items()}
        super().update(params, g, state)


def reference_adam(learning_rate: float = 1e-3, weight_decay: float = 1e-4) -> ReferenceAdam:
    """The intent classifier's optimizer, the JAX ``reference_adam``."""
    return ReferenceAdam(learning_rate, weight_decay)


def cast_compute(model: nn.Module, batch: Mapping[str, torch.Tensor],
                 compute_dtype: torch.dtype):
    """Mixed precision, the JAX ``_cast_compute``: (the float parameters of
    ``model`` cast to ``compute_dtype`` by name, ``batch`` with its float
    entries cast).  Each cast is recorded by autograd, so a loss computed
    from the copies sends float32 gradients to the master parameters; buffers (the sinusoidal tables) are not cast, as
    JAX's are constants the model casts to the hidden dtype at use."""
    params = {k: p.to(compute_dtype) if p.is_floating_point() else p
              for k, p in model.named_parameters()}
    batch = {k: v.to(compute_dtype) if v.is_floating_point() else v
             for k, v in batch.items()}
    return params, batch


class _Bound(nn.Module):
    """``fn(model, *args)`` as a module call, so that
    ``torch.func.functional_call`` can swap ``model``'s parameters."""

    def __init__(self, model: nn.Module, fn: Callable):
        super().__init__()
        self.model, self.fn = model, fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def _with_compute_dtype(loss_parts: Callable, compute_dtype: Optional[torch.dtype]
                        ) -> Callable:
    """``loss_parts`` as it is, or run under :func:`cast_compute`: the
    model's parameters replaced by their cast copies for the call."""
    if compute_dtype is None:
        return loss_parts

    def cast_loss_parts(model, batch, generator):
        params, batch = cast_compute(model, batch, compute_dtype)
        return torch.func.functional_call(_Bound(model, loss_parts),
                                          {f"model.{k}": v for k, v in params.items()},
                                          (batch, generator))

    return cast_loss_parts


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, float32."""
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm([t.float() for t in tensors])))


def trainable_params(model: torch.nn.Module, freeze_feature_encoder: bool = False
                     ) -> Dict[str, torch.Tensor]:
    """Named parameters the optimizer updates: all, less the conv feature
    encoder when it is frozen."""
    return {k: p for k, p in model.named_parameters()
            if not (freeze_feature_encoder and k.startswith(FROZEN_PREFIX))}


def use_config(model: torch.nn.Module, cfg) -> None:
    """Point every submodule's ``cfg`` at ``cfg`` (the step's config may
    differ from the model's in its dropout rates only)."""
    for m in model.modules():
        if hasattr(m, "cfg"):
            m.cfg = cfg


def _zero_attention_dropout(cfg, field: str, attn_impl: str):
    """``cfg`` with ``field`` zeroed, and the JAX package's warning, when
    ``attn_impl`` is not dense (the kernels carry no attention-prob
    dropout)."""
    rate = getattr(cfg, field)
    if attn_impl == "dense" or rate <= 0.0:
        return cfg
    warnings.warn(
        f"attn_impl={attn_impl!r} carries no attention-prob dropout: "
        f"{field}={rate} is zeroed for this "
        "run (all other dropout rates keep their configured values). "
        "Use attn_impl='dense' if attention dropout must be active.",
        UserWarning, stacklevel=3)
    return dataclasses.replace(cfg, **{field: 0.0})


def _sum_form_update(loss_parts, model, params: Dict[str, torch.Tensor],
                     tx: AdamW, opt_state: OptState, batch: Mapping[str, torch.Tensor],
                     keys, grad_accum: int, generator) -> Dict[str, torch.Tensor]:
    """Sum-form gradients of ``loss_parts(model, micro, generator) ->
    (nll_sum, ntokens)`` over a strided split of ``batch`` into
    ``grad_accum`` micro-batches (micro-batch j = rows j, j+accum, ..., as
    JAX), divided once by the total token count, then one ``tx`` update of
    ``params``.  Returns the step's metrics."""
    for p in model.parameters():
        p.grad = None
    b = batch[keys[0]].shape[0]
    if b % grad_accum:
        raise ValueError(f"batch size {b} not divisible by grad_accum {grad_accum}")
    nll_sum = ntok = 0.0
    for j in range(grad_accum):
        micro = {k: batch[k][j::grad_accum] for k in keys}
        nll, n = loss_parts(model, micro, generator)
        nll.backward()
        nll_sum, ntok = nll_sum + nll.detach(), ntok + n
    n = torch.clamp(torch.as_tensor(ntok, dtype=torch.float32), min=1.0)
    grads = {k: (p.grad.div_(n) if p.grad is not None else None)
             for k, p in params.items()}
    present = [g for g in grads.values() if g is not None]
    gnorm = global_norm(present) if present else torch.zeros(())
    tx.update(params, grads, opt_state)
    return {"loss": nll_sum / n, "grad_norm": gnorm,
            "nll_sum": nll_sum, "ntokens": torch.as_tensor(ntok)}


def make_asr_train_step(cfg: SpeechT5Config, tx: AdamW, *,
                        attn_impl: str = "dense",
                        freeze_feature_encoder: bool = False,
                        grad_accum: int = 1,
                        compute_dtype: Optional[torch.dtype] = None,
                        remat: RematSpec = None) -> Callable:
    """Returns ``step(model, opt_state, batch, generator) -> metrics``:
    the model (an ``AsrModel`` on the batch's device) and ``opt_state``
    (``tx.init(trainable_params(model, freeze_feature_encoder))``) are
    updated in place; ``batch`` holds ``input_values``, ``attention_mask``
    and ``labels`` tensors; dropout and SpecAugment draw from
    ``generator``.  Metrics (0-d tensors): ``loss``, ``grad_norm`` (before
    clipping), ``nll_sum``, ``ntokens``.

    ``attn_impl="flash"`` runs the kernels (B1, B3/B4, B5 and its
    backward; B2 under ``freeze_feature_encoder``), in their bf16 forms
    under ``compute_dtype=torch.bfloat16`` (:func:`cast_compute`).
    ``remat`` ("none", "full", "dots", "hybrid", "lite" or a bool;
    ``ops/remat.py``) rematerializes the encoder layers in the backward:
    "full" keeps only their inputs, "lite" all but the FFN chain; the
    step's numbers do not change."""
    cfg = _zero_attention_dropout(cfg, "attention_dropout", attn_impl)
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def loss_parts(model, batch, generator):
        _, aux = st5.asr_loss(model, batch["input_values"], batch["attention_mask"],
                              batch["labels"], attn_impl=attn_impl,
                              generator=generator,
                              freeze_feature_encoder=freeze_feature_encoder, remat=remat)
        return aux["nll_sum"], aux["ntokens"]

    loss_parts = _with_compute_dtype(loss_parts, compute_dtype)

    def step(model, opt_state: OptState, batch: Mapping[str, torch.Tensor],
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        use_config(model, cfg)
        model.train()
        return _sum_form_update(loss_parts, model,
                                trainable_params(model, freeze_feature_encoder), tx,
                                opt_state, batch,
                                ("input_values", "attention_mask", "labels"),
                                grad_accum, generator)

    return step


def make_lm_train_step(cfg: g.GPT2Config, tx: AdamW, *, attn_impl: str = "dense",
                       loss_impl: str = "chunked", grad_accum: int = 1,
                       compute_dtype: Optional[torch.dtype] = None,
                       remat: RematSpec = None) -> Callable:
    """Returns ``step(model, opt_state, batch, generator) -> metrics`` for
    a ``GPT2Model`` on the batch's device, updated in place with
    ``opt_state = tx.init(dict(model.named_parameters()))``.  ``batch``
    holds ``ids`` [B, L] and ``lengths`` [B] tensors; the loss is the token
    mean of the NLL of tokens 1..len-1 (right padding is inert under
    causality).  Dropout draws from ``generator``.  Metrics as
    :func:`make_asr_train_step`'s.

    ``loss_impl``: ``"chunked"`` (default) scores the lm head in time
    chunks recomputed in the backward
    (``token_nll_from_hidden(checkpoint_chunks=True)``), so the [B, L, V]
    logits never live in memory; ``"dense"`` materialises them.
    ``attn_impl="flash"`` runs B6 in every layer, forward, and its
    blockwise PyTorch backward.  ``remat`` as :func:`make_asr_train_step`'s,
    over the blocks."""
    cfg = _zero_attention_dropout(cfg, "attn_pdrop", attn_impl)
    if loss_impl not in ("dense", "chunked"):
        raise ValueError(f"loss_impl must be 'dense' or 'chunked', got {loss_impl!r}")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def loss_parts(model, batch, generator):
        ids = batch["ids"]
        kw = dict(deterministic=False, generator=generator, attn_impl=attn_impl,
                  remat=remat)
        if loss_impl == "chunked":
            hidden, _ = g.gpt2_forward(model, ids, **kw)
            nll = g.token_nll_from_hidden(model.wte.weight, hidden, ids,
                                          checkpoint_chunks=True)
        else:
            logits, _ = g.gpt2_logits(model, ids, **kw)
            nll = g.token_nll(logits, ids)
        t = nll.shape[1]
        valid = (torch.arange(t, device=nll.device)[None, :]
                 < (batch["lengths"].to(nll.device) - 1)[:, None])
        return (nll * valid).sum(), valid.sum()

    loss_parts = _with_compute_dtype(loss_parts, compute_dtype)

    def step(model, opt_state: OptState, batch: Mapping[str, torch.Tensor],
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        use_config(model, cfg)
        model.train()
        return _sum_form_update(loss_parts, model, dict(model.named_parameters()), tx,
                                opt_state, batch, ("ids", "lengths"), grad_accum,
                                generator)

    return step
