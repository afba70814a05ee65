"""Kernel B2: the feature encoder's first layer, conv k=2*stride (1 -> C,
no bias) + instance norm over all frames + erf-GELU, as one CUDA wrapper
(``csrc/conv_frontend.cu``) beside its plain PyTorch version.  The kernel
spreads the instance-norm statistics over the card in frame chunks
(:func:`stat_chunk`) and evaluates the GELU with the TPU kernel's
Abramowitz-Stegun erf; the plain version keeps torch's exact erf.

Counterpart of ``loco_asr_tpu/ops/pallas/conv_frontend.py``
(``conv1_instance_norm_gelu``) and of the XLA gram form
``prenets.conv1_instance_norm_gelu_gram``: all three compute the same
function.  The instance norm runs over every frame of the (padded) row,
zero tail included; the plain version takes the ``E[y^2] - mean^2``
variance, the kernel a sum of centred squares (the same value, without
the cancellation a DC offset brings).

Bfloat16 inputs (waveform, weight, scale and bias, one dtype) take the
TPU kernel's bf16 path: the conv's products are exact in float32, the
statistics, the norm and the GELU run in float32, and the output is
rounded to bf16 once.

The statistics kernel is shared; the output kernel has two *forms*
(:func:`kernel_form`), one for each type:

* ``"ffma"`` (float32): the conv as ten FMA an output on the CUDA cores,
  gain folded into the weights in f32, scalar stores.  The output's bytes
  bind it (524 MB at B=16 x 5 s).
* ``"mma_sync"`` (bfloat16): the conv on the tensor cores (one bf16
  ``mma.sync`` per 16 channels x 8 frames, the 10 taps padded to 16 with
  zero weights), gain and offset after the product in f32, packed bf16
  pairs staged a warp at a time in shared memory and written as aligned
  16-byte chunks, a row's 128 frames of a tile in one store instruction.
  The output is half as large, so the GELU's instructions (two of them on
  the special-function unit) become the rival of the write.

A CUDA call launches its dtype's form or raises; it never tries the other
form nor the plain version.

:func:`conv1_instance_norm_gelu` launches the kernel for a CUDA tensor
and takes the plain version only for a CPU tensor; ``launches`` counts
kernel launches, ``launches_by_form`` the same by form.  The kernel has no
backward, as the Pallas one has none: on CUDA with an input that requires
grad the wrapper raises rather than return a detached output.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..layers import gelu
from . import _build

EPS = 1e-5
MAX_CHUNK = 2048      # frames of a statistics block, its waveform in shared memory
N_STATS = 65          # 10 tap sums and the 55 distinct products of the tap gram
FORMS = ("ffma", "mma_sync")   # the C entry's form argument is the index


def kernel_form(dtype: torch.dtype) -> str:
    """The output kernel a CUDA launch with operands of ``dtype`` takes:
    ``"mma_sync"`` for bfloat16, ``"ffma"`` for float32."""
    return "mma_sync" if dtype is torch.bfloat16 else "ffma"


def stat_chunk(b: int, f: int, sm_count: int) -> int:
    """Frames of one statistics block: each row's ``f`` frames are cut into
    at most 2 * ``sm_count`` // ``b`` chunks, so that the grid fills the
    card's two blocks an SM in one wave at any batch ``b`` (16 chunks a row
    at B=16 x 5 s, 58 at B=4 x 4 s on 132 SMs); a multiple of 32 frames in
    [128, MAX_CHUNK].  The kernel's grid is (ceil(f / chunk), b)."""
    per_row = max(1, 2 * sm_count // b)
    chunk = 32 * -(-f // (32 * per_row))    # ceil(f / per_row), up to 32
    return max(128, min(MAX_CHUNK, chunk))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_geometry(weight: torch.Tensor, stride: int) -> int:
    k = weight.shape[2]
    if k != 2 * stride:
        raise ValueError(f"kernel {k} must equal 2*stride {stride} "
                         "(wav2vec2 first-layer geometry)")
    return k


def conv1_instance_norm_gelu_plain(wav: torch.Tensor, weight: torch.Tensor,
                                   scale: torch.Tensor, bias: torch.Tensor, *,
                                   stride: int = 5) -> torch.Tensor:
    """Plain PyTorch version: [B, T] wave -> [B, C, (T-K)//stride + 1] in
    the waveform's dtype, computed in float32 (float64 for float64 input)."""
    _check_geometry(weight, stride)
    ct = torch.promote_types(wav.dtype, torch.float32)
    y = F.conv1d(wav.to(ct)[:, None, :], weight.to(ct), stride=stride)   # [B, C, F]
    mean = y.mean(dim=-1, keepdim=True)
    var = (y * y).mean(dim=-1, keepdim=True) - mean * mean
    z = (y - mean) * torch.rsqrt(var + EPS)
    return gelu(z * scale.to(ct)[None, :, None] + bias.to(ct)[None, :, None]).to(wav.dtype)


def conv1_instance_norm_gelu(wav: torch.Tensor, weight: torch.Tensor,
                             scale: torch.Tensor, bias: torch.Tensor, *,
                             stride: int = 5) -> torch.Tensor:
    """[B, T] float32 or bf16 waveform, [C, 1, K] conv weight (K ==
    2*stride), [C] norm scale/bias, all of one dtype -> [B, C, (T-K)//stride
    + 1] activations of that dtype."""
    if wav.device.type == "cpu":
        return conv1_instance_norm_gelu_plain(wav, weight, scale, bias,
                                              stride=stride)
    k = _check_geometry(weight, stride)
    if wav.device.type != "cuda":
        raise ValueError(f"unsupported device {wav.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (wav, weight, scale, bias)):
        # the kernel has no backward (nor has the Pallas kernel): trainable
        # callers take prenets.conv1_instance_norm_gelu_gram, as JAX does
        raise RuntimeError(
            "conv1_instance_norm_gelu: kernel B2 has no backward; call it "
            "under torch.no_grad() or use the differentiable gram form "
            "(models/speecht5/prenets.conv1_instance_norm_gelu_gram)")
    out = _launch(wav, weight, scale, bias, k, stride)
    conv1_instance_norm_gelu.launches += 1
    conv1_instance_norm_gelu.launches_by_form[kernel_form(wav.dtype)] += 1
    return out


def _launch(wav, weight, scale, bias, k: int, stride: int) -> torch.Tensor:
    """Check the CUDA operands, allocate the output and scratch, and launch
    the kernel's form for the operands' type on the current stream."""
    _build.require_cuda(wav, "conv_frontend")
    if k != 10:
        raise ValueError(f"the CUDA kernel is built for k=10/stride 5, got k={k}")
    bf16 = _build.bf16_flag(wav.dtype, "conv_frontend")
    for name, t in (("wav", wav), ("weight", weight), ("scale", scale),
                    ("bias", bias)):
        if t.dtype != wav.dtype or t.device != wav.device:
            raise ValueError(f"{name} must be {wav.dtype} on {wav.device}, "
                             f"got {t.dtype} on {t.device}")
    b, t = wav.shape
    c = weight.shape[0]
    if weight.shape[1] != 1 or scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"bad shapes: weight {tuple(weight.shape)}, "
                         f"scale {tuple(scale.shape)}, bias {tuple(bias.shape)}")
    f = (t - k) // stride + 1
    if f < 1:
        raise ValueError(f"waveform of {t} samples is shorter than the kernel")
    wav, weight = wav.contiguous(), weight.contiguous()
    scale, bias = scale.contiguous(), bias.contiguous()
    dev = wav.device
    chunk = stat_chunk(b, f, _sm_count(torch.cuda.current_device() if dev.index is None
                                       else dev.index))
    # per-chunk statistics, each row's gains and offsets, then b int32
    # ticket counters (zeroed by the C entry)
    scratch = torch.empty(b * (-(-f // chunk) * N_STATS + 2 * c + 1),
                          dtype=torch.float32, device=dev)
    out = torch.empty((b, c, f), dtype=wav.dtype, device=dev)
    code = _build.call_on_stream(
        _build.library().loco_conv_frontend, dev, wav.data_ptr(), weight.data_ptr(),
        scale.data_ptr(), bias.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        b, t, c, k, stride, f, chunk, EPS, FORMS.index(kernel_form(wav.dtype)), bf16)
    _build.check(code, "conv_frontend")
    return out


conv1_instance_norm_gelu.launches = 0
conv1_instance_norm_gelu.launches_by_form = dict.fromkeys(FORMS, 0)
