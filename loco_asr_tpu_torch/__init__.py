"""LoCo-ASR on PyTorch + CUDA: the port of ``loco_asr_tpu`` to one NVIDIA
Hopper GPU.

Same layout as ``loco_asr_tpu`` so every module has an obvious counterpart.
Plain tensor code is PyTorch; every Pallas kernel of the JAX package on a
ported path is a hand-written CUDA kernel under ``csrc/``, built with
``nvcc`` at first use and bound through ``ctypes`` (``ops/cuda/``).  This
package imports neither ``jax`` nor ``loco_asr_tpu``.

Ported paths: SpeechT5-base speech-encoder embedding extraction (kernels
B1, B2), GPT-2 perplexity scoring (kernels B5/B6, one strided kernel),
SpeechT5-base ASR fine-tuning (kernels B3/B4, the backward of B1; every
flash wrapper is a ``torch.autograd.Function``), SpeechT5 TTS / voice
conversion (kernel B7) and ASR decoding with GPT-2 shallow fusion and
conversation carry-over (B1, B2 in each encode).

Layout:
  ops/        -- layers, attention, audio decode; ops/cuda: kernel wrappers
  csrc/       -- CUDA C++ kernel sources (sm_90a)
  models/     -- SpeechT5 ASR (speech encoder, text decoder); GPT-2 (gpt2 ..
                 gpt2-xl); JAX and HF weight bridges
  data/       -- SLURP adapter, embedding store, tokenizers, LM datasets,
                 Kaldi IO and ASR (conversation-window) datasets
  decode/     -- greedy / beam decoding with LM fusion, conversation
                 carry-over, continuous batching
  parallel/   -- AdamW and the one-device ASR train step
  pipelines/  -- CLI entry points (extract_embeddings, eval_ppl, train_asr,
                 decode_asr)
  utils/      -- device resolution, metrics, file logger, checkpoints, WER

The CPU tests (``tests/test_torch_*.py``) run the plain PyTorch versions
against the JAX package; ``chip_smoke.py`` builds and checks the kernels
and drives the paths on the GPU.
"""

__version__ = "0.1.0"
