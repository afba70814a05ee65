"""Shared speech/text embedding space on the card: the port of
``examples/02_shared_embedding_space.py`` (the reference's notebook 2,
"SpeechT5 unified speech and text embeddings visualization"):
cross-modal cosine similarity, PCA of per-frame and mean-pooled encoder
outputs, and KMeans over the pooled space with a modality-purity readout.

    python -m loco_asr_tpu_torch.examples.02_shared_embedding_space --tiny [--device cpu]

With random weights the similarities are near zero and the clusters split
by modality; real checkpoints (``--asr_checkpoint`` / ``--tts_checkpoint``)
show the shared space.  The speech encode runs kernels B2 and B1 on the
card.  PCA and KMeans are numpy (SVD, Lloyd's iterations), as in the JAX
script; plots need matplotlib and ``--plot_dir``.
"""

import argparse
import os

import numpy as np
import torch

from loco_asr_tpu_torch.models.speecht5 import model as st5
from loco_asr_tpu_torch.models.speecht5.config import SpeechT5Config, tiny_config
from loco_asr_tpu_torch.pipelines.common import load_speecht5_params
from loco_asr_tpu_torch.utils.device import resolve_device


def pca(x: np.ndarray, n_components: int = 3) -> np.ndarray:
    """Project rows of x onto the top principal components (via SVD)."""
    centered = x - x.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    return centered @ vt[:n_components].T


def kmeans(x: np.ndarray, k: int = 2, iters: int = 50, seed: int = 0):
    """Lloyd's algorithm; returns (assignments, centroids)."""
    rng = np.random.default_rng(seed)
    centroids = x[rng.choice(len(x), size=k, replace=False)]
    assign = np.zeros(len(x), dtype=np.int64)
    for _ in range(iters):
        d = ((x[:, None, :] - centroids[None]) ** 2).sum(-1)
        new_assign = d.argmin(axis=1)
        if (new_assign == assign).all():
            break
        assign = new_assign
        for j in range(k):
            if (assign == j).any():
                centroids[j] = x[assign == j].mean(axis=0)
    return assign, centroids


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--asr_checkpoint", default=None)
    p.add_argument("--tts_checkpoint", default=None)
    p.add_argument("--plot_dir", default=None,
                   help="write pca_frames.png / pca_pooled.png here")
    p.add_argument("--device", default="cuda", help="'cpu' runs the plain versions")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = tiny_config(apply_spec_augment=False) if args.tiny else SpeechT5Config()
    asr = load_speecht5_params(args.asr_checkpoint, cfg, device=dev, variant="asr")
    tts = load_speecht5_params(args.tts_checkpoint, cfg, device=dev, variant="tts")

    wav = np.random.default_rng(0).standard_normal((4, 16000)).astype(np.float32) * 0.1
    ids = torch.tensor([[4, 7, 9, 12, 2], [5, 6, 2, 1, 1],
                        [3, 8, 10, 2, 1], [11, 4, 6, 9, 2]], device=dev)

    speech_emb, _ = st5.encode_speech(asr, wav)
    with torch.no_grad():
        text_emb = st5.encode_text(tts, ids)
    speech_emb, text_emb = speech_emb.cpu().numpy(), text_emb.cpu().numpy()

    # --- cosine similarity of mean-pooled embeddings (cross-modal) ---
    s = speech_emb.mean(axis=1)
    t = text_emb.mean(axis=1)
    s_n = s / np.linalg.norm(s, axis=-1, keepdims=True)
    t_n = t / np.linalg.norm(t, axis=-1, keepdims=True)
    print("speech x text cosine similarity matrix:\n", s_n @ t_n.T)

    # --- PCA of per-frame embeddings, each modality separately ---
    dim = speech_emb.shape[-1]
    pca_speech = pca(speech_emb.reshape(-1, dim))
    pca_text = pca(text_emb.reshape(-1, dim))
    print(f"per-frame PCA: speech {pca_speech.shape}, text {pca_text.shape}; "
          f"speech PC1 var {pca_speech[:, 0].var():.4f}, "
          f"text PC1 var {pca_text[:, 0].var():.4f}")

    # --- PCA of mean-pooled embeddings, both modalities together ---
    pooled = np.concatenate([s, t], axis=0)
    pca_pooled = pca(pooled)
    print("pooled PCA coordinates (first 4 rows = speech, last 4 = text):")
    print(np.round(pca_pooled, 4))

    # --- KMeans over the pooled shared space: does k=2 split by modality? ---
    assign, _ = kmeans(pooled, k=2)
    modality = np.array([0] * len(s) + [1] * len(t))
    agree = max((assign == modality).mean(), (assign != modality).mean())
    print(f"kmeans(k=2) over pooled space: assignments {assign.tolist()}, "
          f"modality purity {agree:.2f} "
          f"(1.0 = clusters are the modalities, i.e. NOT a shared space)")

    if args.plot_dir:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print("matplotlib unavailable; skipping plots")
            return 0
        os.makedirs(args.plot_dir, exist_ok=True)
        for name, (a, b) in {"pca_frames": (pca_speech, pca_text),
                             "pca_pooled": (pca_pooled[:len(s)], pca_pooled[len(s):])}.items():
            fig = plt.figure(figsize=(10, 7))
            ax = fig.add_subplot(projection="3d")
            ax.scatter3D(a[:, 0], a[:, 1], a[:, 2], s=10, c="b", label="speech")
            ax.scatter3D(b[:, 0], b[:, 1], b[:, 2], s=10, c="r", label="text")
            ax.set_xlabel("PC1"), ax.set_ylabel("PC2"), ax.set_zlabel("PC3")
            ax.legend()
            out = os.path.join(args.plot_dir, f"{name}.png")
            fig.savefig(out)
            plt.close(fig)
            print("wrote", out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
