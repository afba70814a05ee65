"""LoCo-ASR on PyTorch + CUDA: the port of ``loco_asr_tpu`` to one NVIDIA
Hopper GPU.

Same layout as ``loco_asr_tpu`` so every module has an obvious counterpart.
Plain tensor code is PyTorch; every Pallas kernel of the JAX package on a
ported path is a hand-written CUDA kernel under ``csrc/``, built with
``nvcc`` at first use and bound through ``ctypes`` (``ops/cuda/``).  This
package imports neither ``jax`` nor ``loco_asr_tpu``.

Layout:
  ops/        -- layers, attention, audio decode; ops/cuda: kernel wrappers
  csrc/       -- CUDA C++ kernel sources (sm_90a)
  models/     -- SpeechT5 speech encoder, JAX weight bridge
  data/       -- SLURP adapter, embedding store
  pipelines/  -- CLI entry points (extract_embeddings)
  utils/      -- device resolution, metrics
"""

__version__ = "0.1.0"
