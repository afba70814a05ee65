"""GPT-2 language model: the full-sequence forward and token scoring of
``loco_asr_tpu.models.gpt2.model`` (the reference's LM-evaluation model
family, gpt2 .. gpt2-xl).

Parameter names follow HF ``GPT2Model``, as the JAX tree does: ``wte``,
``wpe``, ``h.<i>.{ln_1, attn.c_attn, attn.c_proj, ln_2, mlp.c_fc,
mlp.c_proj}``, ``ln_f``.  The dense layers are HF ``Conv1D``s, whose
``weight`` is ``[in, out]`` like the JAX ``kernel``; a norm ``weight`` is
the JAX ``scale``.  The lm head is tied to ``wte``.

``attn_impl``:

* ``"dense"``: [B, H, T, T] scores with the additive causal (and padding)
  bias of -1e9 and a softmax;
* ``"flash"``: without ``attention_mask``, kernel B6 reads q/k/v in place
  from the qkv projection (``flash_causal.flash_attention_nhd``; kernel B5
  when D != 64 or the head count is odd); with ``attention_mask``, kernel
  B1 with per-row valid-key counts (right padding) and ``causal=True``.

Training mode (``deterministic=False`` with a ``generator``) applies the
JAX model's dropout at its places: ``embd_pdrop`` after the token and
position tables, ``attn_pdrop`` on the dense attention probabilities,
``resid_pdrop`` on the attention and MLP outputs.  The masks come from the
generator, so they are not JAX's bits.  :func:`token_nll_from_hidden` with
``checkpoint_chunks`` recomputes each chunk's logits in the backward, so
the [B, T, V] logits never live in memory during training.

Incremental mode (``kv_caches`` from :func:`init_kv_cache`, ``cache_index``
an int or a [B] tensor of per-row offsets) attends densely over the cache,
as the JAX one does, and writes the new keys and values into it in place
where the JAX one returns a new cache.  The LM of shallow fusion
(``decode/fusion.py``) runs in this mode.

Not ported yet, and refused with an error: the sequence-parallel ``ring``
/ ``ulysses`` attention.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from ...ops import attention, layers
from ...ops.cuda import flash_attention, flash_causal
from ...utils.device import resolve_device

NEG_INF = -1e9   # additive mask of the dense path
ATTN_IMPLS = ("dense", "flash")


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    activation: str = "gelu_new"
    embd_pdrop: float = 0.1
    attn_pdrop: float = 0.1
    resid_pdrop: float = 0.1

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


def tiny_gpt2_config(**over) -> GPT2Config:
    base = dict(vocab_size=61, n_positions=32, n_embd=16, n_layer=2, n_head=2)
    base.update(over)
    return GPT2Config(**base)


# the public GPT-2 family (the reference's --model choices)
PRESETS = {
    "gpt2": GPT2Config(),
    "gpt2-medium": GPT2Config(n_embd=1024, n_layer=24, n_head=16),
    "gpt2-large": GPT2Config(n_embd=1280, n_layer=36, n_head=20),
    "gpt2-xl": GPT2Config(n_embd=1600, n_layer=48, n_head=25),
}


class Conv1D(nn.Module):
    """HF GPT-2's dense layer: ``y = x @ weight + bias``, weight [in, out]."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_in, n_out))
        self.bias = nn.Parameter(torch.empty(n_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.addmm(self.bias, x.reshape(-1, x.shape[-1]), self.weight)
        return y.reshape(*x.shape[:-1], y.shape[-1])


class Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.c_attn = Conv1D(d, 3 * d)
        self.c_proj = Conv1D(d, d)


class MLP(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.c_fc = Conv1D(d, 4 * d)
        self.c_proj = Conv1D(4 * d, d)


class Block(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.ln_1 = layers.Norm(d)
        self.attn = Attention(d)
        self.ln_2 = layers.Norm(d)
        self.mlp = MLP(d)


class GPT2Model(nn.Module):
    """Token and position tables, ``n_layer`` pre-LN blocks, final norm."""

    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.n_embd,
                                _weight=torch.empty(cfg.vocab_size, cfg.n_embd))
        self.wpe = nn.Embedding(cfg.n_positions, cfg.n_embd,
                                _weight=torch.empty(cfg.n_positions, cfg.n_embd))
        self.h = nn.ModuleList(Block(cfg.n_embd) for _ in range(cfg.n_layer))
        self.ln_f = layers.Norm(cfg.n_embd)


def gpt2_init(cfg: GPT2Config, *, seed: int = 0,
              device: Optional[Union[str, torch.device]] = None) -> GPT2Model:
    """Seeded random init with the JAX ``gpt2_init`` distributions (dense
    weights uniform in +-1/sqrt(in), zero biases, unit norms, ``wte`` ~
    N(0, 0.02), ``wpe`` ~ N(0, 0.01); the numbers differ), drawn on
    ``device`` (default CUDA; raises when no GPU is present) by a
    generator of that device, in eval mode."""
    dev = resolve_device(device)
    with torch.device(dev):
        model = GPT2Model(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for blk in model.h:
            for lin in (blk.attn.c_attn, blk.attn.c_proj, blk.mlp.c_fc, blk.mlp.c_proj):
                bound = lin.weight.shape[0] ** -0.5
                lin.weight.uniform_(-bound, bound, generator=gen)
                lin.bias.zero_()
        model.wte.weight.normal_(0.0, 0.02, generator=gen)
        model.wpe.weight.normal_(0.0, 0.01, generator=gen)
    return model.eval()


ArrayLike = Union[torch.Tensor, np.ndarray]
KVCache = Dict[str, Dict[str, torch.Tensor]]


def init_kv_cache(model: GPT2Model, batch: int, max_len: int,
                  dtype=torch.float32) -> KVCache:
    """Zeroed incremental-mode cache on the model's device: {layer: {"k",
    "v"}} of [B, n_head, max_len, head_dim]."""
    cfg = model.cfg
    shape = (batch, cfg.n_head, max_len, cfg.head_dim)
    dev = model.wte.weight.device
    return {str(i): {"k": torch.zeros(shape, dtype=dtype, device=dev),
                     "v": torch.zeros(shape, dtype=dtype, device=dev)}
            for i in range(cfg.n_layer)}


def _attention(blk: Block, cfg: GPT2Config, h: torch.Tensor,
               bias: Optional[torch.Tensor], attn_impl: str,
               kv_valid_len: Optional[torch.Tensor],
               kv_cache: Optional[Dict[str, torch.Tensor]], cache_index, write_mask,
               drop: Callable[[torch.Tensor, float], torch.Tensor]) -> torch.Tensor:
    b, t, _ = h.shape
    q, k, v = (x.reshape(b, t, cfg.n_head, cfg.head_dim)
               for x in blk.attn.c_attn(h).split(cfg.n_embd, dim=-1))
    scale = cfg.head_dim ** -0.5
    if kv_cache is None and attn_impl == "flash" and kv_valid_len is None:
        # [B, T, H, D] views of the qkv projection, read in place
        attn = flash_causal.flash_attention_nhd(q, k, v, causal=True, scale=scale)
    elif kv_cache is None and attn_impl == "flash":
        attn = flash_attention.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True,
            scale=scale, kv_valid_len=kv_valid_len).transpose(1, 2)
    else:
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
        if kv_cache is not None:
            attention._write_cache(kv_cache, k, v, cache_index, write_mask)
            k, v = kv_cache["k"], kv_cache["v"]
        scores = torch.matmul(q, k.transpose(-1, -2)) / cfg.head_dim ** 0.5
        probs = drop(torch.softmax(scores + bias, dim=-1), cfg.attn_pdrop)
        attn = torch.matmul(probs, v).transpose(1, 2)
    return drop(blk.attn.c_proj(attn.reshape(b, t, cfg.n_embd)), cfg.resid_pdrop)


def _causal_bias(past, t: int, k_len: int, dev) -> torch.Tensor:
    """Additive causal bias of queries at positions ``past + i`` over
    ``k_len`` keys: [1, 1, T, K] for an int ``past``, [B, 1, T, K] for a [B]
    tensor of per-row offsets."""
    kj, qi = torch.arange(k_len, device=dev), torch.arange(t, device=dev)[:, None]
    if isinstance(past, torch.Tensor):
        return torch.where(kj <= past[:, None, None] + qi, 0.0, NEG_INF)[:, None]
    return torch.where(kj <= past + qi, 0.0, NEG_INF)[None, None]


def gpt2_forward(model: GPT2Model, input_ids: ArrayLike, *,
                 attention_mask: Optional[ArrayLike] = None,
                 kv_caches: Optional[KVCache] = None, cache_index=None,
                 kv_write_mask: Optional[torch.Tensor] = None,
                 deterministic: bool = True, attn_impl: str = "dense",
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Token ids [B, T] -> (hidden [B, T, D], ``kv_caches``), on the model's
    device.

    ``attention_mask`` [B, T] marks valid tokens; padding must be on the
    right (the data layer's only form).  Dropout runs only outside
    ``deterministic`` and with a ``generator`` on the model's device (the
    JAX forward's ``dropout_rng``); ``attn_impl="flash"`` outside
    ``deterministic`` refuses ``attn_pdrop > 0`` as the JAX one does.

    Incremental mode: ``kv_caches`` (:func:`init_kv_cache`) and
    ``cache_index``, the number of positions already cached: an int for
    every row, or a [B] tensor of per-row offsets (ragged conversation
    histories, ``decode/context.py``).  The tokens take positions
    ``cache_index + i``, their keys and values are written into the caches
    in place, and each query attends the cache positions up to its own;
    ``attention_mask`` is then [B, cache_len] validity over cache positions.
    ``kv_write_mask`` [B] bool (a [B] ``cache_index``, one token): rows where
    it is False leave their caches as they were (a finished stream of the
    conversation batcher).  ``attn_impl`` is ignored there: the attention
    is dense, as in JAX.
    """
    cfg = model.cfg
    if (kv_caches is None) != (cache_index is None):
        raise ValueError("kv_caches and cache_index go together")
    if attn_impl in ("ring", "ulysses"):
        raise NotImplementedError(f"attn_impl={attn_impl!r} (sequence parallel) "
                                  "is not ported yet")
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r}: expected one of {ATTN_IMPLS}")
    dev = model.wte.weight.device
    ids = torch.as_tensor(input_ids, device=dev).long()
    b, t = ids.shape
    if t > cfg.n_positions:
        raise ValueError(f"sequence length {t} exceeds n_positions {cfg.n_positions}")
    if attn_impl == "flash" and not deterministic and cfg.attn_pdrop > 0.0:
        raise ValueError(
            f"attn_impl={attn_impl!r} drops attention-prob dropout "
            f"(attn_pdrop={cfg.attn_pdrop}); train with "
            f"attn_pdrop=0.0 or attn_impl='dense'")

    past = 0
    if isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1:
        past = cache_index.to(dev, torch.int64)
        if t > 1 or not past.is_cuda:   # as _write_cache: a decode step is not read back
            lo, hi = int(past.min()), int(past.max())
            if lo < 0 or hi + t > cfg.n_positions:
                raise ValueError(f"positions {lo}..{hi + t - 1} exceed "
                                 f"n_positions {cfg.n_positions}")
        pos_emb = model.wpe.weight[past[:, None] + torch.arange(t, device=dev)]
    else:
        if cache_index is not None:
            past = int(cache_index)
        if past < 0 or past + t > cfg.n_positions:
            raise ValueError(f"positions {past}..{past + t - 1} exceed "
                             f"n_positions {cfg.n_positions}")
        pos_emb = model.wpe.weight[past:past + t][None]
    training = not deterministic

    def drop(y, p):
        return layers.dropout(y, p, generator, training)

    x = drop(model.wte(ids) + pos_emb, cfg.embd_pdrop)
    mask = None if attention_mask is None else torch.as_tensor(attention_mask, device=dev)
    bias = kv_valid_len = None
    if kv_caches is not None:
        bias = _causal_bias(past, t, kv_caches["0"]["k"].shape[2], dev)
    elif attn_impl == "flash":
        if mask is not None:
            kv_valid_len = mask.to(torch.int32).sum(-1, dtype=torch.int32)
    else:
        bias = _causal_bias(0, t, t, dev)
    if bias is not None and mask is not None:
        bias = bias + torch.where(mask.bool(), 0.0, NEG_INF)[:, None, None, :]

    act = layers.ACTIVATIONS[cfg.activation]
    eps = cfg.layer_norm_epsilon
    for i, blk in enumerate(model.h):
        h = layers.layer_norm(x, blk.ln_1.weight, blk.ln_1.bias, eps=eps)
        x = x + _attention(blk, cfg, h, bias, attn_impl, kv_valid_len,
                           None if kv_caches is None else kv_caches[str(i)],
                           cache_index, kv_write_mask, drop)
        h = layers.layer_norm(x, blk.ln_2.weight, blk.ln_2.bias, eps=eps)
        x = x + drop(blk.mlp.c_proj(act(blk.mlp.c_fc(h))), cfg.resid_pdrop)
    return layers.layer_norm(x, model.ln_f.weight, model.ln_f.bias, eps=eps), kv_caches


def gpt2_logits(model: GPT2Model, input_ids: ArrayLike, **kw
                ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Forward + tied lm head -> (logits [B, T, V], ``kv_caches``)."""
    hidden, caches = gpt2_forward(model, input_ids, **kw)
    return torch.matmul(hidden, model.wte.weight.t()), caches


def _chunk_nll(hid: torch.Tensor, wte_weight: torch.Tensor,
               tgt: torch.Tensor) -> torch.Tensor:
    logits = torch.matmul(hid.float(), wte_weight.float().t())
    picked = logits.gather(-1, tgt[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - picked


def token_nll_from_hidden(wte_weight: torch.Tensor, hidden: torch.Tensor,
                          targets: torch.Tensor, *, chunk: int = 256,
                          checkpoint_chunks: bool = False) -> torch.Tensor:
    """Per-token NLL [B, T-1] straight from the final hidden states, the
    numbers of ``token_nll(logits, targets)`` without the [B, T, V] logits:
    the time axis is scored ``chunk`` steps at a time (logsumexp minus the
    target's logit, in float32).

    ``checkpoint_chunks`` (training): each chunk runs under
    ``torch.utils.checkpoint`` (non-reentrant), which keeps only its
    inputs for the backward and recomputes the chunk's [B, chunk, V]
    logits there, as the JAX ``jax.checkpoint`` of the scan body does.
    Without it autograd keeps every chunk's logits."""
    b, t, _ = hidden.shape
    n = t - 1
    chunk = max(1, min(chunk, n))
    hid, tgt = hidden[:, :-1], targets[:, 1:].to(hidden.device).long()
    recompute = checkpoint_chunks and torch.is_grad_enabled()
    out = []
    for s in range(0, n, chunk):
        args = (hid[:, s:s + chunk], wte_weight, tgt[:, s:s + chunk])
        out.append(torch.utils.checkpoint.checkpoint(_chunk_nll, *args, use_reentrant=False)
                   if recompute else _chunk_nll(*args))
    return torch.cat(out, dim=1) if out else hidden.new_zeros((b, 0))


def score_tokens(model: GPT2Model, input_ids: ArrayLike, *, chunk: int = 256,
                 **kw) -> torch.Tensor:
    """Forward + per-token NLL [B, T-1] through the chunked lm head (the
    eval_ppl hot path; the numbers of ``token_nll(gpt2_logits(...))``)."""
    ids = torch.as_tensor(input_ids, device=model.wte.weight.device).long()
    hidden, _ = gpt2_forward(model, ids, **kw)
    return token_nll_from_hidden(model.wte.weight, hidden, ids, chunk=chunk)


def token_nll(logits: torch.Tensor, targets: ArrayLike) -> torch.Tensor:
    """Per-token NLL [B, T-1] of ``targets`` under shifted ``logits`` (the
    reference's CrossEntropyLoss(reduction='none'))."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = torch.as_tensor(targets, device=logits.device).long()[:, 1:]
    return -logp.gather(-1, tgt[..., None])[..., 0]
