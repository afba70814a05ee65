"""Hand-written CUDA kernels (``csrc/``) with their wrappers, plain PyTorch
versions and launch counters.  Nothing here builds or loads a kernel at
import time: ``_build.library()`` compiles ``csrc/*.cu`` on first launch."""
