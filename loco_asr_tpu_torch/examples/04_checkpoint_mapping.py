"""Checkpoint mapping demo: the port of ``examples/04_checkpoint_mapping.py``
(the reference's notebook 4, 'Save Mappings and Loading SpeechT5 Base'):
the HF -> JAX-layout and fairseq -> JAX-layout imports of
``models/speecht5/import_torch.py``, with strict key and shape checks.

    python -m loco_asr_tpu_torch.examples.04_checkpoint_mapping --tiny \\
        [--fairseq_ckpt speecht5_base.pt [--out converted.npz]] [--device cpu]

Without a real ``speecht5_base.pt`` it demonstrates on the seeded model
itself: its weights written under HF ``SpeechT5ForSpeechToText`` names
(built here without ``transformers``) and under fairseq's encoder names,
then imported back; ``--fairseq_ckpt`` grafts the real checkpoint.
"""

import argparse
import re

import numpy as np

from loco_asr_tpu_torch.models.speecht5 import convert, import_torch
from loco_asr_tpu_torch.models.speecht5 import model as st5
from loco_asr_tpu_torch.models.speecht5.config import SpeechT5Config, tiny_config
from loco_asr_tpu_torch.utils.checkpoint import save_npz, unflatten
from loco_asr_tpu_torch.utils.pytree import assert_trees_match


def to_hf_state_dict(flat):
    """A flat JAX-layout ASR tree under HF ``SpeechT5ForSpeechToText`` names:
    the inverse of ``import_torch.load_hf_state_dict``'s renames (kernels
    back to transposed ``weight``s, norm ``scale``s to ``weight``s, batch
    norm statistics to ``running_*``), under the ``speecht5.`` prefix but
    for the vocabulary head."""
    out = {}
    for key, value in flat.items():
        k = re.sub(r"(layer_norm|batch_norm)\.scale$", r"\1.weight", key)
        k = re.sub(r"batch_norm\.(mean|var)$", r"batch_norm.running_\1", k)
        if k.endswith(".kernel"):
            k, value = k[:-len("kernel")] + "weight", np.ascontiguousarray(value.T)
        out[k if k.startswith("text_decoder_postnet.") else "speecht5." + k] = value
    return out


def to_fairseq_encoder(flat):
    """The transformer encoder's leaves under fairseq's ``encoder.*`` names
    (the inverse of ``import_torch.load_fairseq_encoder``)."""
    out = {}
    for key, value in flat.items():
        k = key.replace("embed_positions.pe_k", "pos_emb.pe_k")
        k = re.sub(r"layers\.(\d+)\.attention\.", r"layers.\1.self_attn.", k)
        k = re.sub(r"layers\.(\d+)\.layer_norm\.", r"layers.\1.self_attn_layer_norm.", k)
        k = re.sub(r"feed_forward\.intermediate_dense\.", "fc1.", k)
        k = re.sub(r"feed_forward\.output_dense\.", "fc2.", k)
        if k.endswith(".kernel"):
            k, value = k[:-len("kernel")] + "weight", value.T
        elif k.endswith(".scale"):
            k = k[:-len("scale")] + "weight"
        out["encoder." + k] = value
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--fairseq_ckpt", default=None,
                   help="path to the original speecht5_base.pt")
    p.add_argument("--out", default=None, help="save the converted tree (.npz)")
    p.add_argument("--tiny", action="store_true", help="tiny config (fast)")
    p.add_argument("--device", default="cuda", help="where the seeded model is drawn")
    args = p.parse_args(argv)

    cfg = tiny_config(apply_spec_augment=False) if args.tiny else SpeechT5Config()
    ours = convert.asr_to_jax_params(st5.asr_model_init(cfg, seed=0, device=args.device))

    if args.fairseq_ckpt:
        import torch

        ckpt = torch.load(args.fairseq_ckpt, map_location="cpu", weights_only=False)
        grafted = import_torch.graft_fairseq_into_asr(ours, ckpt)
        print("fairseq graft OK:",
              sum(k.startswith("encoder.wrapped_encoder.") for k in grafted),
              "encoder leaves")
        if args.out:
            save_npz(args.out, unflatten(grafted))
            print("saved to", args.out)
        return 0

    # the seeded model -> HF names -> our tree, strict-key checked
    imported = import_torch.load_hf_state_dict(to_hf_state_dict(ours))
    assert_trees_match(unflatten(ours), unflatten(imported))
    assert all(np.array_equal(imported[k], v) for k, v in ours.items())
    print("HF import: strict key+shape match,", len(imported), "leaves")

    # ... and its encoder -> fairseq names -> the encoder subtree
    prefix = "encoder.wrapped_encoder."
    encoder = {k[len(prefix):]: v for k, v in ours.items() if k.startswith(prefix)}
    back = import_torch.load_fairseq_encoder(to_fairseq_encoder(encoder))
    assert_trees_match(unflatten(encoder), unflatten(back))
    assert all(np.array_equal(back[k], v) for k, v in encoder.items())
    print("fairseq encoder import: strict key+shape match,", len(back), "leaves")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
