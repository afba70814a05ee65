"""Checkpoint import: HF SpeechT5 and the original fairseq SpeechT5 state
dicts into the JAX package's flat parameter layout, the port of
``loco_asr_tpu.models.speecht5.import_torch``.

The loaders return flat ``.``-joined numpy dicts under the JAX names (what
``convert.*_from_jax_params`` read into the port's modules); the grafts
take and return such dicts too:

* :func:`load_hf_state_dict`: an HF ``SpeechT5ForSpeechToText`` /
  ``SpeechT5ForTextToSpeech`` (or sub-module) state dict, by a mechanical
  rename and the transpose of every dense weight; the sinusoidal tables
  that the model recomputes are dropped.
* :func:`load_fairseq_checkpoint`: fairseq ``speecht5_base.pt``'s encoder,
  speech prenet and text prenet subtrees, by the reference's renaming
  rules (fc1/fc2, self_attn, pos_emb, feature_extractor.N.{0,2},
  post_extract_proj, mask_emb, pos_conv.0).
* :func:`graft_fairseq_into_asr` / :func:`graft_fairseq_into_tts`: those
  subtrees replace the same subtrees of an ``asr`` / ``tts`` tree, as the
  JAX grafts replace them.

Values may be torch tensors or numpy arrays; everything comes back as
numpy.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np

Flat = Dict[str, np.ndarray]

# Dense (torch Linear) leaves -> transpose [out,in] -> [in,out], rename to kernel.
_DENSE_MODULES = (
    "q_proj", "k_proj", "v_proj", "out_proj",
    "intermediate_dense", "output_dense",
    "projection", "lm_head", "feat_out", "prob_out",
    "final_layer", "speaker_embeds_layer",
)

# Buffers the model recomputes (sinusoidal tables) rather than stores.
_SKIPPED = (
    "pos_sinusoidal_embed.weights",
    "encode_positions.pe",
    "num_batches_tracked",
    "rotary_embed",
)


def _to_numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return np.asarray(x.detach().cpu().float().numpy()
                          if x.is_floating_point() else x.detach().cpu().numpy())
    return np.asarray(x)


def _is_dense_weight(key: str) -> bool:
    parts = key.split(".")
    if len(parts) < 2 or parts[-1] != "weight":
        return False
    if parts[-2] in _DENSE_MODULES:
        return True
    # speech decoder prenet dense stack: decoder.prenet.layers.N.weight
    return bool(re.search(r"decoder\.prenet\.layers\.\d+\.weight$", key))


def _map_hf_key(key: str) -> str:
    """One HF state-dict key -> the JAX flat key."""
    k = key
    if k.startswith("speecht5."):
        k = k[len("speecht5."):]
    # torch >= 2 weight-norm parametrization names
    k = k.replace("parametrizations.weight.original0", "weight_g")
    k = k.replace("parametrizations.weight.original1", "weight_v")
    k = re.sub(r"(layer_norm|batch_norm)\.weight$", r"\1.scale", k)
    k = re.sub(r"batch_norm\.running_mean$", "batch_norm.mean", k)
    k = re.sub(r"batch_norm\.running_var$", "batch_norm.var", k)
    if _is_dense_weight(key):
        k = re.sub(r"\.weight$", ".kernel", k)
    return k


def load_hf_state_dict(state_dict: Mapping) -> Flat:
    """HF SpeechT5 model state dict -> flat JAX-layout params (full task
    models or sub-module state dicts)."""
    flat: Flat = {}
    for key, value in state_dict.items():
        if any(s in key for s in _SKIPPED):
            continue
        arr = _to_numpy(value)
        flat[_map_hf_key(key)] = arr.T if _is_dense_weight(key) else arr
    return flat


# -- fairseq speecht5_base.pt -----------------------------------------------

def _map_fairseq_encoder_key(key: str) -> str:
    """fairseq 'encoder.*' key -> the wrapped_encoder-relative path."""
    k = key[len("encoder."):]
    k = k.replace("pos_emb.pe_k", "embed_positions.pe_k")
    k = re.sub(r"layers\.(\d+)\.self_attn\.", r"layers.\1.attention.", k)
    k = re.sub(r"layers\.(\d+)\.self_attn_layer_norm\.", r"layers.\1.layer_norm.", k)
    k = re.sub(r"layers\.(\d+)\.fc1\.", r"layers.\1.feed_forward.intermediate_dense.", k)
    k = re.sub(r"layers\.(\d+)\.fc2\.", r"layers.\1.feed_forward.output_dense.", k)
    return k


def load_fairseq_encoder(model_state: Mapping) -> Flat:
    """fairseq ckpt['model'] -> the transformer encoder's params
    (wrapped_encoder-relative)."""
    flat: Flat = {}
    for key, value in model_state.items():
        if not key.startswith("encoder."):
            continue
        k = _map_fairseq_encoder_key(key)
        arr = _to_numpy(value)
        parts = k.split(".")
        if parts[-1] == "weight" and parts[-2] in _DENSE_MODULES:
            arr = arr.T
            k = re.sub(r"\.weight$", ".kernel", k)
        elif "layer_norm" in k and k.endswith(".weight"):
            k = re.sub(r"\.weight$", ".scale", k)
        flat[k] = arr
    return flat


def load_fairseq_speech_prenet(model_state: Mapping) -> Flat:
    """fairseq speech_encoder_prenet.* -> the speech prenet's params."""
    flat: Flat = {}
    for key, value in model_state.items():
        if not key.startswith("speech_encoder_prenet."):
            continue
        k = key[len("speech_encoder_prenet."):]
        arr = _to_numpy(value)
        if k == "mask_emb":
            flat["masked_spec_embed"] = arr
        elif k == "layer_norm.weight":
            flat["feature_projection.layer_norm.scale"] = arr
        elif k == "layer_norm.bias":
            flat["feature_projection.layer_norm.bias"] = arr
        elif k == "post_extract_proj.weight":
            flat["feature_projection.projection.kernel"] = arr.T
        elif k == "post_extract_proj.bias":
            flat["feature_projection.projection.bias"] = arr
        elif k.startswith("feature_extractor.conv_layers."):
            m = re.match(r"feature_extractor\.conv_layers\.(\d+)\.(\d+)\.(weight|bias)", k)
            if not m:
                continue
            layer, sub, leaf = m.group(1), m.group(2), m.group(3)
            if sub == "0":
                flat[f"feature_encoder.conv_layers.{layer}.conv.{leaf}"] = arr
            else:  # submodule 2 = the norm
                ours = "scale" if leaf == "weight" else "bias"
                flat[f"feature_encoder.conv_layers.{layer}.layer_norm.{ours}"] = arr
        elif k.startswith("pos_conv.0."):
            flat[f"pos_conv_embed.conv.{k[len('pos_conv.0.'):]}"] = arr
    return flat


def load_fairseq_text_prenet(model_state: Mapping) -> Flat:
    """fairseq text_encoder_prenet embedding table -> the text prenet's
    params (alpha at its init value 1.0, as the JAX loader sets it)."""
    emb = _to_numpy(model_state["text_encoder_prenet.encoder_prenet.0.weight"])
    return {"embed_tokens.weight": emb,
            "encode_positions.alpha": np.ones((), np.float32)}


def load_fairseq_checkpoint(ckpt: Mapping) -> Dict[str, Flat]:
    """A fairseq checkpoint dict (with or without its 'model' key) -> the
    ``encoder`` / ``speech_prenet`` / ``text_prenet`` params."""
    model_state = ckpt["model"] if "model" in ckpt else ckpt
    return {"encoder": load_fairseq_encoder(model_state),
            "speech_prenet": load_fairseq_speech_prenet(model_state),
            "text_prenet": load_fairseq_text_prenet(model_state)}


def _replace(flat: Flat, prefix: str, sub: Flat) -> Flat:
    """``flat`` with the subtree (or leaf) at ``prefix`` replaced by ``sub``,
    whose keys are relative to ``prefix`` (``""`` for a leaf)."""
    out = {k: v for k, v in flat.items() if k != prefix and not k.startswith(prefix + ".")}
    out.update({f"{prefix}.{k}" if k else prefix: v for k, v in sub.items()})
    return out


def graft_fairseq_into_asr(asr_params: Flat, ckpt: Mapping) -> Flat:
    """An ``asr`` tree (flat) with its transformer encoder replaced by the
    fairseq one, and each top-level part of its speech prenet that the
    checkpoint carries (feature encoder, projection, positional conv,
    mask embedding) replaced by the checkpoint's."""
    sub = load_fairseq_checkpoint(ckpt)
    out = _replace(asr_params, "encoder.wrapped_encoder", sub["encoder"])
    prenet = sub["speech_prenet"]
    for part in dict.fromkeys(k.split(".")[0] for k in prenet):
        out = _replace(out, f"encoder.prenet.{part}",
                       {k[len(part) + 1:]: v for k, v in prenet.items()
                        if k == part or k.startswith(part + ".")})
    return out


def graft_fairseq_into_tts(tts_params: Flat, ckpt: Mapping) -> Flat:
    """A ``tts`` tree (flat) whose text encoder (transformer and prenet) is
    the fairseq checkpoint's."""
    sub = load_fairseq_checkpoint(ckpt)
    return _replace(tts_params, "encoder",
                    {**{f"wrapped_encoder.{k}": v for k, v in sub["encoder"].items()},
                     **{f"prenet.{k}": v for k, v in sub["text_prenet"].items()}})
