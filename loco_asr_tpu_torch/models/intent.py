"""SLURP intent classifier over frozen SpeechT5 embeddings: the port of
``loco_asr_tpu.models.intent``.

* pooling over time: ``average`` (mean), ``max`` (elementwise max) or
  ``attention`` (one learned query ``q`` [1, D], ``alpha = softmax(x q^T)``
  over time, ``alpha^T x``).  With ``lengths`` every pooling is masked to
  the valid frames (the max with ``finfo.min``, the attention scores with
  -1e9, as in JAX); without, it pools over the padding as the reference
  does.
* head: ``Linear(D, num_classes)`` (the reference's), or with
  ``hidden_dims`` Linear + exact GELU blocks before the last projection.

Parameter names follow the JAX tree: ``q``, then ``classifier`` (an
``nn.Linear``) or ``classifier.<i>`` (an ``nn.ModuleList``), so
:func:`intent_from_jax_params` / :func:`intent_to_jax_params` only rename
``kernel`` to ``weight`` and transpose.  The pooling and the head are plain
PyTorch: the JAX package has no Pallas kernel here.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import layers
from ..utils.device import resolve_device

POOLINGS = ("average", "max", "attention")
ATTENTION_MASK = -1e9


class IntentClassifier(nn.Module):
    """Query ``q`` [1, D] and the head: one ``nn.Linear`` or, with
    ``hidden_dims``, a list of them with a GELU between each two."""

    def __init__(self, embedding_size: int = 768, num_classes: int = 101,
                 hidden_dims: Sequence[int] = (),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_dims = tuple(hidden_dims)
        self.q = nn.Parameter(torch.randn(1, embedding_size, generator=generator) * 0.001)
        dims = [embedding_size, *self.hidden_dims, num_classes]
        dense = []
        for n_in, n_out in zip(dims[:-1], dims[1:]):
            lin = nn.Linear(n_in, n_out)
            layers.init_dense(lin, generator)
            dense.append(lin)
        self.classifier = nn.ModuleList(dense) if self.hidden_dims else dense[0]


def intent_classifier_init(embedding_size: int = 768, num_classes: int = 101,
                           hidden_dims: Sequence[int] = (), *, seed: int = 0,
                           device: Optional[Union[str, torch.device]] = None
                           ) -> IntentClassifier:
    """Seeded init with the JAX distributions (``q`` ~ N(0, 1) * 0.001,
    dense weights uniform in +-1/sqrt(in), zero biases; the numbers differ),
    drawn on the CPU and moved to ``device`` (default CUDA; raises when no
    GPU is present)."""
    dev = resolve_device(device)
    model = IntentClassifier(embedding_size, num_classes, hidden_dims,
                             torch.Generator().manual_seed(seed))
    return model.to(dev)


def _head(model: IntentClassifier, pooled: torch.Tensor) -> torch.Tensor:
    if isinstance(model.classifier, nn.Linear):
        return model.classifier(pooled)
    x = pooled
    for i, lin in enumerate(model.classifier):
        x = lin(x)
        if i < len(model.classifier) - 1:
            x = layers.gelu(x)
    return x


def pool(model: IntentClassifier, x: torch.Tensor, method: str,
         lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, T, D] -> [B, D] by ``method``, masked to ``lengths`` if given."""
    mask = None
    if lengths is not None:
        mask = torch.arange(x.shape[1], device=x.device)[None, :] < lengths[:, None]
    if method == "average":
        if mask is None:
            return x.mean(dim=1)
        m = mask[..., None].to(x.dtype)
        return (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
    if method == "max":
        if mask is None:
            return x.amax(dim=1)
        neg = torch.finfo(x.dtype).min
        return torch.where(mask[..., None], x, torch.full_like(x, neg)).amax(dim=1)
    if method == "attention":
        z = torch.einsum("btd,qd->btq", x, model.q)          # [B, T, 1]
        if mask is not None:
            z = torch.where(mask[..., None], z, torch.full_like(z, ATTENTION_MASK))
        alpha = torch.softmax(z, dim=1)
        return torch.einsum("bt,btd->bd", alpha[..., 0], x)
    raise ValueError(f"unknown pooling {method}")


def intent_forward(model: IntentClassifier, x: torch.Tensor, *, method: str = "average",
                   lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, T, D] embeddings -> [B, num_classes] logits."""
    return _head(model, pool(model, x, method, lengths))


def intent_loss_and_acc(model: IntentClassifier, x: torch.Tensor, onehot: torch.Tensor, *,
                        method: str, lengths: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax cross-entropy against (possibly soft) one-hot targets, in
    float32, and the count of rows whose argmax matches the target's."""
    logits = intent_forward(model, x, method=method, lengths=lengths)
    logp = F.log_softmax(logits.float(), dim=-1)
    loss = -(onehot.float() * logp).sum(dim=-1).mean()
    correct = (logits.argmax(-1) == onehot.argmax(-1)).float().sum()
    return loss, correct


def _jax_names(model: IntentClassifier) -> Dict[str, Tuple[str, bool]]:
    """Port parameter name -> (JAX flat key, transpose)."""
    out = {}
    for name in model.state_dict():
        if name.endswith(".weight"):
            out[name] = (name[: -len("weight")] + "kernel", True)
        else:
            out[name] = (name, False)
    return out


def intent_from_jax_params(flat: Mapping[str, np.ndarray]) -> IntentClassifier:
    """The JAX ``intent_classifier_init`` tree, as a flat ``.``-joined numpy
    dict, -> an ``IntentClassifier`` on the CPU holding those weights
    (either head form, read from the keys)."""
    kernels = sorted((k for k in flat if k.startswith("classifier.") and k.endswith("kernel")),
                     key=lambda k: int(k.split(".")[1]) if k.count(".") == 2 else 0)
    shapes = [np.shape(flat[k]) for k in kernels]
    hidden = tuple(s[1] for s in shapes[:-1]) if kernels != ["classifier.kernel"] else ()
    with torch.device("meta"):
        model = IntentClassifier(shapes[0][0], shapes[-1][1], hidden)
    names = _jax_names(model)
    if set(flat) != {key for key, _ in names.values()}:
        raise KeyError(f"intent params {sorted(flat)} do not match "
                       f"{sorted(key for key, _ in names.values())}")
    state = {}
    for name, (key, transpose) in names.items():
        t = torch.from_numpy(np.array(flat[key], dtype=np.float32))
        state[name] = t.t().contiguous() if transpose else t
    model.load_state_dict(state, strict=True, assign=True)
    return model


def intent_to_jax_params(model: IntentClassifier) -> Dict[str, np.ndarray]:
    """``IntentClassifier`` -> the flat JAX layout (inverse of
    :func:`intent_from_jax_params`)."""
    out, state = {}, model.state_dict()
    for name, (key, transpose) in _jax_names(model).items():
        t = state[name].detach().float().cpu()
        out[key] = (t.t() if transpose else t).contiguous().numpy()
    return out
