#!/usr/bin/env python3
"""Smoke test of loco_asr_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the CUDA kernels from ``loco_asr_tpu_torch/csrc/`` and drives the
port's main paths at full width with random weights made from a seed:
SpeechT5-base speech-encoder embedding extraction, GPT-2 perplexity
scoring (``eval_ppl --attn_impl flash``), SpeechT5-base ASR fine-tuning
(``train_asr --attn_impl flash``), SpeechT5 TTS / voice conversion with
the HiFi-GAN vocoder and the log-mel front end, ASR decoding with GPT-2
shallow fusion and conversation carry-over (``decode_asr``), GPT-2 LM
training (``train_lm --attn_impl flash``), the LoCo experiment
(``loco_experiment``, its tiny models trained on the card, and its decodes
on the reference's trained weights) and SLURP intent classification
(``extract_embeddings`` -> ``train_classifier`` -> ``slurp_sweep``).
Phases, in order (any failure raises and exits non-zero):

1. environment: card name and power limit, torch / CUDA versions, TF32
   flags (both set False: every comparison here is float32);
2. build: nvcc for sm_90a, build seconds and ptxas register/smem lines;
   for B1's two kernels and B3's and B4's two each (rel band and
   mask-only), their block shapes, registers, spill, shared memory at
   L=160 and blocks per SM; the same for B2's two kernels and B7's warp
   kernels, with their static SASS counts where cuobjdump exists;
3. kernel checks, after ~0.5 s of warm-up GEMMs: each kernel against its
   plain PyTorch version on the card at the main path's shapes (B1:
   [16, 12, 249, 64], L=160, mixed valid lengths, also causal, mask-only
   (the variant without the band, as ``flash_attention`` runs it), rows
   with valid length 0, on ``split_heads``-style strided views, and
   T=2048, and the cross-attention's mask-only 192 x 500, each with its
   profiler device time and host time; B1 at the LoCo encoder's head
   dim 8 ([4, 4, 398, 8], L=20, a padded and an empty row; with the band
   and mask-only) and at head dim 32; B2: [16, 80000], [8, 160000],
   [4, 64000] and an odd length, its device time by launch (counter
   memset, statistics, output), and ``F.conv1d`` alone (cuDNN, TF32 off)
   as ``partial_library_ms``; B6: views of
   a qkv projection at [8, 1024, 12, 64] and [128, 27, 12, 64], causal;
   B5: [8, 25, 1024, 64] causal, [2, 12, 384, 64] non-causal, [2, 4, 100, 8]
   against 160 keys causal, the ASR decoder's [8, 12, 160, 64] causal; B7:
   a batch of 8 corpus windows of <= 10 s, [8, 160000], and [3, 16001],
   [2, 300] (numpy's repeated reflection), [2, 3, 8000], held to atol +
   rtol |plain| of 2e-4 each, and entries at the mel floor exactly; both
   also against a float64 log-mel; device and host time, and
   ``torch.stft`` alone as ``partial_library_ms``), max abs error against a stated
   tolerance, CUDA-event medians of kernel, plain version and, where one
   PyTorch call computes the same function, that call (timed as a
   yardstick only; B5/B6 also the kernel's profiler device time and the
   host time, the CUDA-event time less it), and the
   bound: bytes over 3.35 TB/s or operations over their peak, matrix
   products (B1, B3-B6) at 3 flops / 495 TFLOP/s (f32 accuracy from three
   TF32 passes) with the 67 TFLOP/s term beside it; the backward: B3 + B4
   against their plain version for dq, dk, dv, dpe at the encoder's
   [8, 12, 500, 64], L=160, two rows padded, non-causal and causal, on
   ``split_heads`` views, with rows of valid length 0, at 160 queries x
   500 keys with the band, and the cross-attention's mask-only
   [8, 12, 160, 500] (each kernel's device time from the profiler, the
   wrapper's host time at the padded and mask-only cases, dq/dk/dv checked
   to be [B, H, T, 64] views of [B, T, H, 64] buffers, the library column
   SDPA forward + backward minus forward); B5's blockwise backward against autograd through its
   plain version at the decoder's [8, 12, 160, 64] causal; on CUDA tensors
   that require grad, B1/B5/B6 outputs carry a grad_fn and B2 raises;
4. encoder: full-width ``encode_speech`` at B=16 x 5 s with padded rows,
   kernel path against plain path on valid frames, launch counts of one
   forward (12 B1, 1 B2), forward ms and RTFx, and the device time of one
   forward by kernel group (torch.profiler);
5. pipeline: ``extract_embeddings -m audio`` on a SLURP-format directory of
   8 seeded wavs of 1-4 s; the launch counts of this run are the B1/B2
   main path's counts;
6. GPT-2: ``score_tokens`` of gpt2 (768 wide, 12 layers, vocab 50257) at
   [8, 1024] seeded ids, flash against dense (NLL within 1e-4), launch
   counts of one forward (12 B6, 0 B5), forward ms and tokens/s, the device
   time by kernel group; a right-padded batch under flash (kernel B1)
   against dense; then gpt2-xl widths (1600, 25 heads), flash against
   dense with n_layer B5 launches;
7. LM-scoring pipeline: ``eval_ppl --model gpt2 --context_type max_len
   --bsize 8`` on the committed ``exp/loco/lm_corpus/dev.txt`` under flash
   (60 B6 launches) and dense (none), PPLs within rtol 1e-4; an ``indep``
   run under flash; a gpt2-xl ``max_len`` run under flash (B5's main-path
   launches);
8. ASR train step at full width (SpeechT5Config(vocab_size=256)) on a
   batch of 8 conversation windows of <= 10 s from the committed corpus,
   dropout and SpecAugment off: kernels + flash against plain + dense
   (loss rtol 1e-5, grad_norm rtol 1e-3, every gradient atol 1e-4 / rtol
   1e-3); launch counts of one ``make_asr_train_step`` (18 B1, 18 B3/B4,
   6 B5, 0 B2) and of one with the feature encoder frozen (1 B2);
9. training throughput: 30 steps at B=8 windows, AdamW lr 1e-4 without
   warmup, dropout on; loss finite and falling (mean of the last 5 below
   the first 5), median step ms, audio-s per wall-s, peak memory, and one
   profiled step's device time by kernel group with its busy share;
10. ASR training pipeline: ``train_asr --attn_impl flash
   --conversation_seconds 10 --batch_size 8 --steps 8 --save_every 4
   --eval_every 8 --eval_batches 2`` on the committed corpus (metrics.jsonl,
   step_8.npz, status.json, finite dev loss and WER), then ``--resume
   --steps 12``; the launch counts of the first run are B3/B4's main-path
   counts;
11. TTS / voice conversion at full width (``SpeechT5Config(vocab_size=256)``,
   ``HifiGanConfig()``), seeded speaker embeddings, the corpus windows'
   transcripts through the char tokenizer: (a) teacher-forced
   ``tts_forward`` and ``s2s_forward`` on ``shift_spectrograms_right`` of
   the windows' B7 log-mels, kernel path against plain path (``mel_after``
   and ``stop_logits`` max abs 1e-3), launch counts (1 B7, 12 B1, 1 B2) and
   forward ms; (b) ``tts_generate`` of 4 transcripts of ~100 characters at
   ``minlenratio = maxlenratio = 4`` (~200 decoder steps), then ``hifigan``:
   finite, |wav| <= 1, ms per step, vocoder ms, synthesis RTFx, and the
   device time of a 25-step synthesis + vocoder by kernel group; once more
   at the default threshold (lengths multiples of r, <= maxlen r); (c)
   copy synthesis ``hifigan(fused_log_mel(wav))`` of the 8 windows;
12. ASR decoding (``SpeechT5Config(vocab_size=256)`` and GPT-2 at gpt2
   widths with vocabulary 256, fusion weight 0.3): (a) ``greedy_decode``
   and ``beam_search`` (K = 5, 200 steps) of the 8 corpus windows, kernel
   path against plain path: launch counts of one encode + decode (12 B1,
   1 B2, none else), encoder outputs within 1e-3 (max) and 1e-4 (mean),
   greedy tokens equal, each beam row's step-by-step choices equal with
   scores within 1e-4 (atol + rtol) or parting at a near-tie (the two
   candidates within 1e-3 of each other in the plain path's own scores,
   and within 1e-3 between the paths; listed), ms per step and RTFx, the
   device time by kernel group and busy share of 25-step greedy and beam
   windows, peak memory; one dev recording of 10 utterances through
   ``ConversationContext`` (``max_positions=256``, two or more
   refreshes), kernel path against plain path; (b) ``encode_speech`` of
   dev utterances at the pipeline's batch shapes ([8, 16000] and the
   batcher's admission buckets [4 | 2 | 1, 16000]), kernel path against
   plain path within 1e-3 (max) and 1e-4 (mean); ``decode_asr`` on the
   dev corpus (12 recordings, 120 utterances of <= 1 s, ``--max_seconds
   1`` so that static batches and the batcher pad alike) with a seeded
   gpt2-width LM ``.npz``, in six modes (static greedy and beam 5, ``--continuous`` greedy and beam 5,
   ``--continuous --conversation`` greedy and beam 5): 120 hyp.text lines,
   a finite wer.json, continuous hypotheses equal to static ones, B1/B2
   launches, RTFx and wall seconds per mode;
13. LM training and the LoCo experiment: (a) one ``make_lm_train_step``
   at gpt2 widths, vocabulary 256, [8, 1024] seeded ids with ragged
   lengths, dropout off, kernels + flash against plain + dense (phase 8's
   limits), launches of one step (12 B6, 12 blockwise backward calls, no
   B5 or B1), 10 steps' median ms and tokens/s, peak memory under the
   chunked and the dense loss, the device time by kernel group and busy
   share; B6's backward at [8, 1024, 12, 64] qkv views against autograd
   through its plain version, SDPA forward + backward timed beside it;
   (b) ``train_lm --model gpt2 --attn_impl flash --seq_len 1024
   --batch_size 8`` for 20 steps on ``exp/loco/lm_corpus`` (one save, one
   dev eval), then ``eval_ppl --checkpoint <its ckpt dir> --attn_impl
   flash``, and the read-back parameters' dev PPL within rtol 1e-4 of the
   trainer's; (c) ``loco_experiment --stage lm`` at
   ``tests/test_loco_experiment.py``'s scale with that test's assertions
   (context gain > 0.02 nats, max_len and streaming PPL below indep);
   (d) ``loco_experiment --stage asr`` at a smoke scale (6 train
   conversations, 2 dev, 4 utterances, 100 + 100 steps): every
   ``results.json`` key finite, 2 B1 and 1 B2 launches an encode and
   nothing else, the trained encoder kernel vs plain path at the decodes'
   batch shapes within 1e-3 (max) and 1e-4 (mean);
14. SLURP intent classification at full width (SpeechT5-base, random
   weights): (a) a SLURP directory of seeded 1-4 s wavs (64 train, 16
   train_synthetic, 16 devel, 16 test) whose labels cycle through all 101
   intents; ``extract_embeddings -m audio`` of every split, 12 B1 and 1 B2
   a batch of 16 and nothing else, each batch's encoder output against
   the plain versions' on the same padded batch (1e-3 max, 1e-4 mean over
   valid frames), and ``-m text`` with a hand-built
   SentencePiece ``.model`` (the TTS text encoder, dense: no launch);
   (b) ``train_classifier`` on the audio store for 3 epochs, each pooling
   and the attention pooling with ``--hidden_dims 256``: every artifact,
   finite losses, the training loss falling, and a CPU run of the same
   command giving the same ``metrics.jsonl`` (losses within 1e-4,
   accuracies equal); the classifier step's ms by CUDA events at a batch
   of 16; (c) ``slurp_sweep --epochs 2``: six ``ok`` entries in
   ``sweep.json``; (d) an HF-layout ``model.safetensors`` of the port's own
   seeded encoder (written and read without the safetensors package)
   loads the same weights and encoder output as the ``.npz`` route;
15. the LoCo ASR stage's decodes (``loco_experiment --stage asr
   --skip_training --fusion_weights 1.0``) on ``fixtures/loco_reference``,
   the reference's trained weights: 2 B1 (head dim 8) and 1 B2 (64
   channels) an encode and nothing else, the ``nofusion``, ``carry``,
   ``nocarry`` and ``oracle`` entries of ``exp/loco/results.json`` to
   every digit, wall seconds; then the same decodes through the plain
   versions on the card: the same entries, and no hypothesis parting
   from the kernel path's;
16. summary: one ``{"kernels": [...]}`` line (B1 and B2 also with their
   ``decode_launches`` of phase 12, ``loco_launches`` of phase 13 (d),
   ``intent_launches`` of phase 14 and ``loco_reference_launches`` of
   phase 15, B1 with its head-dim-8 time, B6 with its phase 13 launches),
   then last ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when no CUDA device is present.

    python3 chip_smoke.py --kernel-cases

runs only the build and phase 3's B2 and B7 cases, and ends with one
``{"kernel_cases": [...]}`` line.  Copied to the root of another checkout
(an earlier commit unpacked with ``git archive``), it runs that
checkout's B2 and B7 through the same cases and inputs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np

# H100 SXM data-sheet peaks used for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12       # CUDA cores
TF32_FLOP_PER_S = 495e12     # tensor cores, dense

B1_TOL = 1e-4
B2_TOL = 1e-4
B56_TOL = 1e-4
B34_TOL = 1e-4        # dq, dk, dv; dpe (a sum over B*H*Tq rows) relative to its max
B56_BWD_TOL = 1e-4
NLL_TOL = 1e-4
LOSS_RTOL = 1e-5      # full-width train step, kernels + flash vs plain + dense
GNORM_RTOL = 1e-3
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3
PPL_RTOL = 1e-4
B7_TOL = 2e-4         # atol and rtol, the JAX package's own fused_log_mel test
TTS_TOL = 1e-3        # teacher-forced mels / stop logits, kernel vs plain path
DECODE_SCORE_TOL = 1e-4   # beam scores, kernel path vs plain path (atol and rtol)
DECODE_TIE_ATOL = 1e-3    # a beam near-tie: the parting candidates' gap and drift
ENC_MAX_TOL, ENC_MEAN_TOL = 1e-3, 1e-4   # encoder output, kernel path vs plain path
ROOT = os.path.dirname(os.path.abspath(__file__))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(fn, reps: int = 10, inner: int = 5) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` back-to-back
    calls, divided by ``inner``; after warm-up."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound(nbytes: float, flops: float, products: bool = False):
    """(least ms, what binds it): the bytes over the memory rate, or the
    operations over the peak rate for them.  With ``products`` the flops are
    matrix products, whose least time at f32 accuracy is three TF32 passes
    on the tensor cores, 3 flops / 495 TFLOP/s (six bf16 passes at 989 give
    the same); other flops run on the CUDA cores at 67 TFLOP/s."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (3 * flops / TF32_FLOP_PER_S if products else flops / F32_FLOP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cores_ms(flops: float) -> float:
    """The flops on the CUDA cores at 67 TFLOP/s, printed beside a products
    bound."""
    return flops / F32_FLOP_PER_S * 1e3


KERNEL_GROUPS = (   # kernel-name pattern -> group, first match wins
    ("flash_rel_fwd", "B1 flash_rel"), ("flash_causal_fwd", "B5/B6 flash_causal"),
    ("flash_rel_bwd_dq", "B3 flash_rel_bwd_dq"), ("flash_rel_bwd_dkv", "B4 flash_rel_bwd_dkv"),
    ("logmel_", "B7 logmel"), ("multi_tensor_apply", "optimizer (foreach)"),
    ("conv_stats_kernel", "B2 conv_frontend"), ("conv_out_kernel", "B2 conv_frontend"),
    ("Memset", "memset"),
    ("convolve", "cuDNN conv"), ("fprop", "cuDNN conv"), ("dgrad", "cuDNN conv"),
    ("wgrad", "cuDNN conv"), ("conv", "cuDNN conv"),
    ("gemm", "GEMM"), ("Kernel2", "GEMM"), ("cutlass", "GEMM"),
    ("layer_norm", "layer norm"), ("softmax", "softmax"), ("reduce", "reductions"),
    ("elementwise", "elementwise"), ("copy", "copies"), ("gather", "gather/index"),
    ("index", "gather/index"),
)


def device_breakdown(fn) -> dict:
    """Device time of one ``fn()`` by kernel group (torch.profiler, CUDA
    activity; summed kernel durations), and the device-busy share of the
    profiled window: the union of kernel intervals over its wall time
    (cuDNN may run kernels concurrently, so the group sums can exceed it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups: dict = {}
    top = []
    for e in prof.key_averages():
        us = e.device_time_total
        if us <= 0:
            continue
        name = e.key
        group = next((g for pat, g in KERNEL_GROUPS if pat in name), "other")
        groups[group] = groups.get(group, 0.0) + us / 1e3
        top.append((us / 1e3, e.count, name[:90]))
    top.sort(reverse=True)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return dict(kernel_ms_sum=sum(groups.values()), busy_ms=busy_us / 1e3,
                wall_ms=wall_ms, busy_share=busy_us / 1e3 / wall_ms,
                groups_ms=dict(sorted(groups.items(), key=lambda kv: -kv[1])),
                top_kernels=[dict(ms=ms, count=n, name=k) for ms, n, k in top[:12]])


def visible(tq, tk, two_l, vl, causal):
    """(query-key pairs, distinct rel-table cells) one head of the batch
    needs: row i sees keys 0..jmax and reaches offsets i-jmax..i of the
    table, clipped to [-L, L-1]."""
    half = two_l // 2
    i = np.arange(tq)
    keys = pe_cols = 0
    for n in vl.tolist():
        n = min(n, tk) if n > 0 else tk
        jmax = np.minimum(i, n - 1) if causal else np.full(tq, n - 1)
        keys += int((jmax + 1).sum())
        pe_cols += int((np.clip(i, -half, half - 1)
                        - np.clip(i - jmax, -half, half - 1) + 1).sum())
    return keys, pe_cols


def b1_work(q, k, pe, vl, causal):
    """Bytes moved (q, k, v, out, pe, lse, valid_len once each) and FLOP
    this run's data needs: q.k^T and p.v over the keys each row may see,
    plus q.pe^T over the distinct table cells those keys reach (none for
    the mask-only variant, ``pe`` None)."""
    b, h, tq, d = q.shape
    pe_numel = 0 if pe is None else pe.numel()
    nbytes = 4 * (2 * q.numel() + 2 * k.numel() + pe_numel + b * h * tq + b)
    keys, pe_cols = visible(tq, k.shape[2], 2 if pe is None else pe.shape[0], vl, causal)
    return nbytes, h * 2 * d * (2 * keys + (0 if pe is None else pe_cols))


def b34_work(q, k, pe, vl, causal):
    """Bounds of B3 and B4 from this run's data.  Both read q, g, k, v, pe,
    lse, delta and valid_len once.  B3 writes dq and the band gradient
    dqpe [B, H, Tq, 2L] and needs s, dp and ds.k over the visible pairs plus
    q.pe^T over the reached cells; B4 writes dk, dv and needs s, dp, p^T.g
    and ds^T.q over the pairs plus the same band product."""
    b, h, tq, d = q.shape
    reads = 4 * (2 * q.numel() + 2 * k.numel() + pe.numel() + 2 * b * h * tq + b)
    keys, pe_cols = visible(tq, k.shape[2], pe.shape[0], vl, causal)
    b3 = (reads + 4 * (q.numel() + b * h * tq * pe.shape[0]), h * 2 * d * (3 * keys + pe_cols))
    b4 = (reads + 4 * 2 * k.numel(), h * 2 * d * (4 * keys + pe_cols))
    return b3, b4


def kernel_device_ms(fn, patterns, n: int = 5, optional=()) -> dict:
    """Mean device time of one launch of the kernels whose names contain
    each pattern (torch.profiler over ``n`` calls of ``fn``, which launches
    each once), divided by the launches the profiler recorded: a window
    can lose kernel records, and is profiled again (up to 3 times) when it
    recorded none of a pattern.  A pattern of ``optional`` may match
    nothing, and then counts 0."""
    patterns = tuple(patterns) + tuple(optional)
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total = {p: 0.0 for p in patterns}
        count = {p: 0 for p in patterns}
        for e in prof.key_averages():
            for p in patterns:
                if p in e.key and e.device_time_total > 0:
                    total[p] += e.device_time_total / 1e3
                    count[p] += e.count
        required = [count[p] for p in patterns if p not in optional]
        if all(required):
            break
    check(all(required), f"the profiler recorded no launch of {patterns}")
    return {p: total[p] / count[p] if count[p] else 0.0 for p in patterns}


def warm_up(dev) -> None:
    """~0.5 s of f32 GEMMs, so that the first timed case does not meet a
    card that is still clocking up."""
    import torch

    warm = torch.ones(4096, 4096, device=dev)
    for _ in range(200):
        torch.mm(warm, warm)
    torch.cuda.synchronize()


def relocate_corpus(dst: str) -> dict:
    """Copies of the committed Kaldi dirs (exp/loco/asr_corpus/{train,dev})
    whose wav.scp points at this checkout's wav files."""
    out = {}
    for split in ("train", "dev"):
        src, d = os.path.join(ROOT, "exp", "loco", "asr_corpus", split), os.path.join(dst, split)
        os.makedirs(d)
        for name in ("text", "segments"):
            with open(os.path.join(src, name), "rb") as f, open(os.path.join(d, name), "wb") as g:
                g.write(f.read())
        with open(os.path.join(src, "wav.scp")) as f, open(os.path.join(d, "wav.scp"), "w") as g:
            for line in f:
                key, path = line.split(None, 1)
                g.write(f"{key} {os.path.join(src, 'wav', os.path.basename(path.strip()))}\n")
        out[split] = d
    return out


def kernel_build_records(build, pattern: str, describe, n: int) -> list:
    """ptxas registers, spill bytes and static shared memory of the ``n``
    kernels whose mangled names match ``pattern``, each with
    ``describe(match)`` (its block shape, shared memory and blocks an SM)."""
    recs, cur = [], None
    for line in build.build_log.splitlines():
        if "Compiling entry" in line:
            m = re.search(pattern, line)
            cur = None
            if m:
                cur = describe(m)
                recs.append(cur)
        elif cur is not None and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif cur is not None and "Used" in line and "registers" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            if smem:
                cur["static_smem_bytes"] = int(smem.group(1))
    # a cached library was built by another process, whose log is gone
    check(not build.build_log or len(recs) == n,
          f"ptxas log names {len(recs)} kernels matching {pattern}, not {n}")
    return recs


def b1_build_records(build) -> list:
    """B1's ten flash_rel_fwd_kernels (rel band and mask-only at head dims
    8-128), with their shared memory at L = 160 and the blocks that fit on
    one SM of this card (CUDA's occupancy API)."""
    lib = build.library()

    def describe(m):
        mask_only, d = int(m.group(1)), int(m.group(2))
        return dict(kernel="B1", mask_only=bool(mask_only), head_dim=d,
                    shape="4 warps, 64-key tiles, 2 stages" if mask_only
                    else "4 warps, 32-key tiles, 1 stage",
                    smem_bytes_l160=lib.loco_flash_rel_smem_bytes(320, mask_only, d),
                    blocks_per_sm_l160=lib.loco_flash_rel_blocks_per_sm(320, mask_only, d))
    return kernel_build_records(build, r"flash_rel_fwd_kernelILb([01])ELi(\d+)E", describe, 10)


def b34_build_records(build) -> list:
    """The same for B3's and B4's kernels (flash_rel_bwd_dq_kernel,
    flash_rel_bwd_dkv_kernel), rel band and mask-only."""
    lib = build.library()
    b3 = "4 warps of 16 query rows, 32-key tiles, K double-buffered, V single"
    b4 = "4 warps of 16 keys, 32-query tiles double-buffered, v in shared memory"

    def describe(m):
        kernel, mask_only = int(m.group(1) == "dkv"), int(m.group(2))
        return dict(kernel=("B3", "B4")[kernel], mask_only=bool(mask_only),
                    shape=(b3, b4)[kernel] + ("" if mask_only else
                                              (", the q.pe table", ", the pe band")[kernel]),
                    smem_bytes_l160=lib.loco_flash_rel_bwd_smem_bytes(320, mask_only, kernel),
                    blocks_per_sm_l160=lib.loco_flash_rel_bwd_blocks_per_sm(320, mask_only,
                                                                            kernel))
    return kernel_build_records(build, r"flash_rel_bwd_(dq|dkv)_kernelILb([01])E", describe, 4)


def sass_counts(lib_path: str, patterns) -> dict:
    """Static SASS instruction count of each function whose name holds one
    of ``patterns`` (``cuobjdump -sass`` of the built library); empty where
    the toolkit has no cuobjdump."""
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          timeout=300).stdout
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0].strip()
        for pat in patterns:
            if pat in name:
                out[name] = len(re.findall(r"/\*[0-9a-f]{4,6}\*/\s+\S", fn))
    return out


def b2_b7_build_records(build) -> list:
    """B2's two kernels and B7's warp kernels: registers and spill (ptxas),
    shared memory and blocks an SM at the main path's shapes (CUDA's
    occupancy API; B2's statistics at [16, 80000]'s 1024-frame chunk, B7 at
    80 mel bins of stride 25), no clusters, and the static SASS count: for
    B2's output kernel over the 2 x 64 outputs of a thread's two unrolled
    bodies (full tile, edge tile; prologue included), for B7 a whole kernel."""
    import torch
    from loco_asr_tpu_torch.ops.cuda import conv_frontend as cf
    from loco_asr_tpu_torch.ops.cuda import logmel

    lib = build.library()
    chunk = cf.stat_chunk(16, 15999, torch.cuda.get_device_properties(0).multi_processor_count)
    stride = logmel._host_constants(16000, 1024, 1024, 80, 80.0, 7600.0)[3].shape[1]

    def b2(m):
        phase = int(m.group(1) == "out")
        return dict(kernel="B2", phase=("statistics", "output")[phase],
                    shape=(f"256 threads, {chunk}-frame chunks at [16, 80000]",
                           "8 warps x 16 channels x 4 frames a thread, 128-frame tiles")[phase],
                    dynamic_smem_bytes=((chunk * 5 + 5) * 4, 0)[phase], cluster=None,
                    blocks_per_sm=lib.loco_conv_frontend_blocks_per_sm(phase, chunk))

    def b7(m):
        log2_m = int(m.group(1))
        return dict(kernel="B7", m=1 << log2_m, shape="8 warps, a warp a frame, persistent",
                    smem_bytes_80_mels=lib.loco_logmel_smem_bytes(log2_m, 80, stride),
                    blocks_per_sm_80_mels=lib.loco_logmel_blocks_per_sm(log2_m, 80, stride),
                    cluster=None)

    recs = (kernel_build_records(build, r"conv_(stats|out)_kernel", b2, 2)
            + kernel_build_records(build, r"logmel_warp_kernelILi(\d)E", b7, 5))
    sass = sass_counts(build.library_path(), ("conv_out_kernel", "logmel_warp_kernelILi9E"))
    for name, n in sass.items():
        if "conv_out_kernel" in name:
            recs.append(dict(kernel="B2", sass_instructions_output_kernel=n,
                             sass_per_output=n / 128))
        else:
            recs.append(dict(kernel="B7", sass_instructions_m512=n))
    return recs


def b2_work(wav, c, k, f):
    b = wav.shape[0]
    nbytes = 4 * (wav.numel() + c * k + 2 * c + b * c * f)
    # conv (2K), folded affine (2) and GELU (~4) per output, tap statistics
    flops = b * c * f * (2 * k + 6) + 2 * b * f * (k + k * (k + 1) // 2)
    return nbytes, flops


B2_CASES = (("main", 16, 80000), ("s2s", 8, 160000), ("pipeline", 4, 64000),
            ("odd", 3, 23457))


def b2_case_checks(cf, smi: str) -> list:
    """B2 (module ``cf``) at the encoder's [16, 80000], s2s_forward's
    [8, 160000], the extraction pipeline's --batch_size 4 and an odd length
    (inputs from their own seed), each against its plain version;
    CUDA-event time, and device time as the sum of its launches (statistics,
    output and, where the wrapper zeroes a counter first, the memset),
    beside ``F.conv1d`` alone."""
    import torch

    g = torch.Generator().manual_seed(2)

    def randn(*shape, sc=0.3):
        return (torch.randn(*shape, generator=g) * sc).cuda()

    conv1d = torch.nn.functional.conv1d
    recs = []
    for name, b, t in B2_CASES:
        wav = randn(b, t, sc=0.1)
        w, sc, bi = randn(512, 1, 10), randn(512, sc=0.2) + 1.0, randn(512, sc=0.1)

        def run():
            return cf.conv1_instance_norm_gelu(wav, w, sc, bi)

        out = run()
        torch.cuda.synchronize()
        pout = cf.conv1_instance_norm_gelu_plain(wav, w, sc, bi)
        f = (t - 10) // 5 + 1
        check(tuple(out.shape) == (b, 512, f), f"B2 {name}: shape {tuple(out.shape)}")
        err = (out - pout).abs().max().item()
        check(bool(torch.isfinite(out).all()), f"B2 {name}: non-finite output")
        check(err <= B2_TOL, f"B2 {name}: max abs err {err} > {B2_TOL}")
        del out, pout
        nbytes, flops = b2_work(wav, 512, 10, f)
        bms, by = bound(nbytes, flops)
        ms = time_ms(run)
        split = kernel_device_ms(run, ("conv_stats", "conv_out"), optional=("Memset",))
        dev_ms = sum(split.values())
        recs.append(dict(
            kernel="B2", case=name, shape=[b, t], max_abs_err=err, tol=B2_TOL, ms=ms,
            device_ms=dev_ms, host_ms=ms - dev_ms, memset_ms=split["Memset"],
            stats_ms=split["conv_stats"], out_ms=split["conv_out"],
            plain_ms=time_ms(lambda: cf.conv1_instance_norm_gelu_plain(wav, w, sc, bi)),
            library_ms=None,
            partial_library_ms=time_ms(lambda: conv1d(wav[:, None], w, stride=5)),
            bound_ms=bms, bound_by=by, bound_share=bms / ms, device_bound_share=bms / dev_ms,
            card=smi))
        del wav
    return recs


def causal_work(b, h, tq, tk, d, causal):
    """Bytes moved (q, k, v, out, lse once each) and FLOP of q.k^T and p.v
    over the key pairs each row may see (row i sees keys 0..i if causal)."""
    pairs = sum(min(i + 1, tk) for i in range(tq)) if causal else tq * tk
    nbytes = 4 * (2 * b * h * tq * d + 2 * b * h * tk * d + b * h * tq)
    return nbytes, 4 * b * h * d * pairs


def b7_work(rows, t, n_frames, n_mel, consts, frame_length=1024, fft_length=1024):
    """Bytes (waveform, window, twiddles, sparse bank and log-mel, once
    each) and the least FLOP of the function for every frame: the window,
    a fft/2-point complex FFT at the split-radix count 4 m log2 m - 6 m + 8
    (no multiply where a twiddle is +-1 or +-i), and for each bin the mel
    bank reads only, the real post-pass (14 flops a bin pair) and the
    magnitude (4); then 2 nnz - n_mel for the sparse mel sums and a max and
    a log a mel bin."""
    window, twiddle, ranges, weights = consts
    nbytes = 4 * (rows * t + rows * n_frames * n_mel + window.numel() + twiddle.numel()
                  + ranges.numel() + weights.numel())
    m = fft_length // 2
    rg = ranges.cpu().numpy()
    nnz = int(rg[:, 1].sum())
    bins = len(set().union(*(range(lo, lo + n) for lo, n in rg)))
    per_frame = (frame_length + 4 * m * int(np.log2(m)) - 6 * m + 8 + 11 * bins
                 + 2 * nnz - n_mel + 2 * n_mel)
    return nbytes, rows * n_frames * per_frame


def log_mel_f64(wav):
    """The log-mel of ``fused_log_mel``'s defaults in float64 on the
    waveform's device: the yardstick both float32 routes are measured
    against."""
    import torch
    from loco_asr_tpu_torch.ops import audio

    window = torch.from_numpy(audio.hann_window(1024)).to(wav.device)
    bank = torch.from_numpy(audio.mel_filter_bank(513, 80, 80.0, 7600.0, 16000))
    mag = torch.fft.rfft(audio.frame_signal(wav.double(), 1024, 256) * window, dim=-1).abs()
    return torch.log10(torch.clamp(mag @ bank.double().to(wav.device), min=1e-10))


def f64_error(out, ref) -> dict:
    """Max and mean abs error of a float32 log-mel against the float64 one,
    and the worst entry: where it lies ([.., frame, mel bin]), its float64
    value, the error in ulps of the float32 output there, and the mel
    energy (10 ** value)."""
    diff = (out.double() - ref).abs()
    flat = int(diff.argmax())
    where = [int(x) for x in np.unravel_index(flat, tuple(diff.shape))]
    val = ref.reshape(-1)[flat].item()
    return dict(max=diff.max().item(), mean=diff.mean().item(), at=where, ref=val,
                ulps=diff.max().item() / float(np.spacing(np.float32(abs(val)))),
                energy=10.0 ** val)


def b7_case_checks(logmel, win_wav, smi: str) -> list:
    """B7 (module ``logmel``) on 8 corpus windows [8, 160000], an odd length,
    rows shorter than the reflect pad and leading dims (inputs from their own
    seed): against its plain version (atol + rtol |plain| of 2e-4, entries at
    the mel floor exactly) and, with the plain version beside it, against a
    float64 log-mel (:func:`f64_error`); CUDA-event, device and host time,
    beside ``torch.stft`` alone."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(7)

    def randn(*shape):
        return (torch.randn(*shape, generator=g) * 0.1).to(dev)

    recs = []
    b7_cases = [("corpus_10s", torch.from_numpy(win_wav).to(dev)),
                ("odd", randn(3, 16001)), ("short_300", randn(2, 300)),
                ("lead_dims", randn(2, 3, 8000))]
    for name, wav in b7_cases:
        out = logmel.fused_log_mel(wav)
        torch.cuda.synchronize()
        pout = logmel.fused_log_mel_plain(wav)
        n_frames = 1 + wav.shape[-1] // 256
        check(tuple(out.shape) == (*wav.shape[:-1], n_frames, 80), f"B7 {name}: shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"B7 {name}: non-finite output")
        diff = (out - pout).abs()
        err = diff.max().item()
        excess = (diff - B7_TOL * (1.0 + pout.abs())).max().item()
        floor = pout == torch.log10(torch.tensor(1e-10, device=dev))   # all-zero frames
        check(torch.equal(out[floor], pout[floor]), f"B7 {name}: entries at the mel floor differ")
        check(excess <= 0.0, f"B7 {name}: |err| exceeds atol + rtol |plain| ({B7_TOL} each) "
                             f"by {excess}; max abs err {err}")
        ref = log_mel_f64(wav)
        vs_f64 = {"kernel": f64_error(out, ref), "plain": f64_error(pout, ref)}
        rows = wav.numel() // wav.shape[-1]
        consts = logmel._constants(dev, 16000, 1024, 1024, 80, 80.0, 7600.0)
        nbytes, flops = b7_work(rows, wav.shape[-1], n_frames, 80, consts)
        bms, by = bound(nbytes, flops)
        ms = time_ms(lambda: logmel.fused_log_mel(wav))
        dev_ms = kernel_device_ms(lambda: logmel.fused_log_mel(wav), ("logmel_",))["logmel_"]
        # torch.stft alone (cuFFT with its reflect pad and window), a part
        # of B7's function, on the same frames; it refuses a reflect pad
        # longer than the row
        stft_ms = stft_dev_ms = None
        if wav.shape[-1] > 512:
            rows2d = wav.reshape(-1, wav.shape[-1])
            hann = torch.hann_window(1024, periodic=True, device=dev)

            def stft():
                return torch.stft(rows2d, 1024, 256, window=hann, center=True,
                                  pad_mode="reflect", return_complex=True)
            stft_ms = time_ms(stft)
            stft_dev_ms = device_breakdown(stft)["kernel_ms_sum"]
        rec = dict(kernel="B7", case=name, shape=list(wav.shape), max_abs_err=err,
                   tol=f"atol {B7_TOL} + rtol {B7_TOL}", worst_excess=excess,
                   floor_entries=int(floor.sum()), vs_f64=vs_f64,
                   ms=ms, device_ms=dev_ms, host_ms=ms - dev_ms,
                   plain_ms=time_ms(lambda: logmel.fused_log_mel_plain(wav)),
                   library_ms=None, partial_library_ms=stft_ms,
                   partial_library_device_ms=stft_dev_ms,
                   bound_ms=bms, bound_by=by, bound_share=bms / ms,
                   device_bound_share=bms / dev_ms,
                   bytes=nbytes, bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                   flops=flops, ops_ms=flops / F32_FLOP_PER_S * 1e3, card=smi)
        recs.append(rec)
        del out, pout
    return recs



def corpus_windows(data_dir: str, n: int, seconds: float = 10.0):
    """The first ``n`` conversation windows of <= ``seconds`` of a Kaldi
    dir: float32 waveforms zero-padded to ``seconds`` [n, T], their valid
    lengths and transcripts."""
    from loco_asr_tpu_torch.data.asr_dataset import ConversationAsrDataset

    ds = ConversationAsrDataset(data_dir, window_seconds=seconds)
    t = int(16000 * seconds)
    wav, lengths, texts = np.zeros((n, t), np.float32), [], []
    for win in ds.windows:
        x = ds.load_window_waveform(win)[:t]
        if len(texts) == n:
            break
        wav[len(texts), :len(x)] = x
        lengths.append(len(x))
        texts.append(win.text)
    check(len(texts) == n, f"{len(texts)} windows in {data_dir}")
    return wav, lengths, texts


def write_slurp(root: str, n: int, seed: int, split: str = "train",
                intents=None, first: int = 0) -> list:
    """SLURP layout: dataset/slurp/{split}.jsonl + audio/slurp_real/*.wav
    (slurp_synth for train_synthetic) of ``n`` seeded wavs of 1-4 s.  The
    labels cycle through ``intents`` (default four) from index ``first``;
    each sentence is its intent's words and its number."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "dataset", "slurp"), exist_ok=True)
    audio_dir = os.path.join(root, "audio",
                             "slurp_synth" if split == "train_synthetic" else "slurp_real")
    os.makedirs(audio_dir, exist_ok=True)
    intents = intents or ["alarm_set", "play_music", "weather_query", "iot_coffee"]
    lengths = []
    with open(os.path.join(root, "dataset", "slurp", f"{split}.jsonl"), "w") as f:
        for i in range(n):
            samples = int(rng.integers(16000, 64001))
            pcm = (rng.standard_normal(samples) * 3000).astype(np.int16)
            name = f"{split}_{i}.wav"
            with wave.open(os.path.join(audio_dir, name), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes(pcm.tobytes())
            intent = intents[(first + i) % len(intents)]
            f.write(json.dumps({"slurp_id": 1000 + first + i,
                                "sentence": f"{intent.replace('_', ' ')} {i}",
                                "intent": intent, "recordings": [{"file": name}]}) + "\n")
            lengths.append(samples)
    return lengths


def sentencepiece_piece(piece: str, score: float, typ: int = 1) -> bytes:
    """One ``pieces`` entry of a SentencePiece ModelProto, wire-encoded:
    field 1 (piece), 2 (score, float) and 3 (type)."""
    pb = piece.encode("utf-8")
    body = (bytes([0x0A, len(pb)]) + pb + bytes([0x15]) + struct.pack("<f", score)
            + bytes([0x18, typ]))
    return bytes([0x0A, len(body)]) + body


def write_sentencepiece_model(path: str, pieces) -> None:
    """A ``.model`` file of ``(piece, score, type)`` entries in id order."""
    with open(path, "wb") as f:
        f.write(b"".join(sentencepiece_piece(*p) for p in pieces))


# a unigram model for SLURP-like sentences whose ids stay below SpeechT5's
# text vocabulary (81): specials, the word mark, letters, digits and words
SLURP_SPM_PIECES = (
    [("<s>", 0.0, 3), ("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2),
     ("\u2581", -3.0, 1)]
    + [(c, -2.5, 1) for c in "abcdefghijklmnopqrstuvwxyz0123456789"]
    + [(f"\u2581{w}", -1.0, 1) for w in ("alarm", "set", "play", "music", "weather",
                                          "query", "iot", "coffee", "email", "calendar",
                                          "news", "general", "qa", "transport", "audio")])


def save_safetensors(path: str, tensors: dict) -> None:
    """float32 CPU tensors as a ``.safetensors`` file: the 8-byte
    little-endian header length, the JSON header, the raw buffers."""
    header, offset, blobs = {}, 0, []
    for name, t in tensors.items():
        data = t.detach().cpu().float().contiguous().numpy().tobytes()
        header[name] = {"dtype": "F32", "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        offset += len(data)
        blobs.append(data)
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for b in blobs:
            f.write(b)


def hf_speecht5_state(flat: dict) -> dict:
    """Flat JAX-layout SpeechT5 params -> an HF ``SpeechT5For*`` state dict
    (``speecht5.`` prefix, dense kernels transposed back to weights, norm
    scales as weights): the inverse of ``import_torch.load_hf_state_dict``."""
    import torch

    out = {}
    for key, value in flat.items():
        t = torch.from_numpy(np.ascontiguousarray(value))
        if key.endswith(".kernel"):
            key, t = key[: -len("kernel")] + "weight", t.t().contiguous()
        key = re.sub(r"(layer_norm|batch_norm)\.scale$", r"\1.weight", key)
        key = re.sub(r"batch_norm\.mean$", "batch_norm.running_mean", key)
        key = re.sub(r"batch_norm\.var$", "batch_norm.running_var", key)
        out["speecht5." + key] = t
    return out


def all_launches() -> dict:
    """Every kernel wrapper's launch count."""
    from loco_asr_tpu_torch.ops.cuda import conv_frontend as cf
    from loco_asr_tpu_torch.ops.cuda import flash_attention as fa
    from loco_asr_tpu_torch.ops.cuda import flash_causal as fc
    from loco_asr_tpu_torch.ops.cuda import logmel

    return {"B1": fa.flash_rel_forward.launches, "B2": cf.conv1_instance_norm_gelu.launches,
            "B3/B4": fa.flash_rel_backward.launches, "B5": fc.flash_forward.launches,
            "B5_bwd": fc.flash_backward.launches, "B6": fc.flash_forward_nhd.launches,
            "B7": logmel.fused_log_mel.launches}


def reset_all_launches() -> None:
    from loco_asr_tpu_torch.ops.cuda import conv_frontend as cf
    from loco_asr_tpu_torch.ops.cuda import flash_attention as fa
    from loco_asr_tpu_torch.ops.cuda import flash_causal as fc
    from loco_asr_tpu_torch.ops.cuda import logmel

    for fn in (fa.flash_rel_forward, cf.conv1_instance_norm_gelu, fa.flash_rel_backward,
               fc.flash_forward, fc.flash_backward, fc.flash_forward_nhd,
               logmel.fused_log_mel):
        fn.launches = 0


def save_gpt2_npz(model, path: str) -> None:
    """The GPT-2 weights as a flat .npz in the JAX package's key layout
    (dense ``kernel``, norm ``scale``), which ``decode_asr --lm_checkpoint``
    reads through the weight bridge."""
    flat = {}
    for key, value in model.state_dict().items():
        parts = key.split(".")
        if parts[-1] == "weight" and parts[0] not in ("wte", "wpe"):
            parts[-1] = "scale" if parts[-2].startswith("ln_") else "kernel"
        flat[".".join(parts)] = value.cpu().numpy()
    np.savez(path, **flat)


@contextlib.contextmanager
def counted_decode_steps():
    """Count the ASR decoder steps that the decode loops run inside (their
    calls of ``asr_decode_step``)."""
    from loco_asr_tpu_torch.models.speecht5 import model as st5

    steps, step = [], st5.asr_decode_step
    st5.asr_decode_step = lambda *a, **kw: steps.append(1) or step(*a, **kw)
    try:
        yield steps
    finally:
        st5.asr_decode_step = step


def same_tokens(a, b, what: str) -> None:
    a, b = np.asarray(a), np.asarray(b)
    if not np.array_equal(a, b):
        first = np.argwhere(a != b)[0].tolist()
        raise RuntimeError(f"check failed: {what}: kernel and plain paths' tokens differ "
                           f"first at {first} ({a[tuple(first)]} vs {b[tuple(first)]})")


@contextlib.contextmanager
def beam_trace():
    """Record, for every step of the beam searches run inside, the top K+1
    candidate scores and flat indices ([B, K+1] each, left on the device).
    The search's own top-k is the first K of the same sort, so its result
    is unchanged."""
    from loco_asr_tpu_torch.decode import beam as beam_mod

    trace, top_k = [], beam_mod.top_k_lower_first

    def recording(x, k):
        vals, idx = top_k(x, k + 1)
        trace.append((vals, idx))
        return vals[..., :k], idx[..., :k]

    beam_mod.top_k_lower_first = recording
    try:
        yield trace
    finally:
        beam_mod.top_k_lower_first = top_k


def beam_agreement(kern: dict, plain: dict):
    """The kernel path's beam search against the plain path's, row by row,
    over the top K+1 candidates traced at every step.  Until a row's K
    chosen candidates first differ (or to the end), their scores agree
    within DECODE_SCORE_TOL (atol + rtol |plain|: the sums reach ~1e3,
    where float32's spacing is 6e-5), and a row that never parts gives the
    same hypotheses and lengths, and final scores within that tolerance.
    A row that parts at step t must part at a near-tie: the candidate that
    the kernel path ranks j lies within DECODE_TIE_ATOL below the plain
    path's rank-j candidate in the plain path's own scores, and every
    candidate traced on both paths at step t differs by at most
    DECODE_TIE_ATOL between them.  Returns ([[row, step, rank, gap,
    drift]], the largest score difference over the compared steps)."""
    import torch

    k = kern["hyp"].scores.shape[1]
    kt = [(vals.cpu(), idx.cpu()) for vals, idx in kern["trace"]]
    pt = [(vals.cpu(), idx.cpu()) for vals, idx in plain["trace"]]
    ties, score_err = [], 0.0
    for b in range(kern["hyp"].scores.shape[0]):
        step = None
        for t in range(min(len(kt), len(pt))):
            (kv, ki), (pv, pi) = kt[t], pt[t]
            if not torch.equal(ki[b, :k], pi[b, :k]):
                step = t
                break
            err = (kv[b, :k] - pv[b, :k]).abs()
            check(bool((err <= DECODE_SCORE_TOL * (1 + pv[b, :k].abs())).all()),
                  f"beam row {b} step {t} scores: kernel vs plain max abs {err.max().item()}")
            score_err = max(score_err, err.max().item())
        if step is None:
            for name in ("tokens", "lengths"):
                same_tokens(getattr(kern["hyp"], name)[b].cpu(),
                            getattr(plain["hyp"], name)[b].cpu(), f"beam row {b} {name}")
            got, ref = kern["hyp"].scores[b].cpu(), plain["hyp"].scores[b].cpu()
            err = (got - ref).abs()
            check(bool((err <= DECODE_SCORE_TOL * (1 + ref.abs())).all()),
                  f"beam row {b} scores: kernel vs plain max abs {err.max().item()}")
            score_err = max(score_err, err.max().item())
            continue
        (kv, ki), (pv, pi) = kt[step], pt[step]
        rank = next(j for j in range(k) if ki[b, j] != pi[b, j])
        at = (pi[b] == ki[b, rank]).nonzero()
        check(len(at) == 1, f"beam row {b} parts from the plain path at step {step} rank "
              f"{rank} on a candidate outside the plain path's top {k + 1}")
        gap = (pv[b, rank] - pv[b, int(at[0])]).item()
        drift = max(abs(kv[b, j].item() - pv[b, int((pi[b] == ki[b, j]).nonzero()[0])].item())
                    for j in range(k + 1) if bool((pi[b] == ki[b, j]).any()))
        check(gap <= DECODE_TIE_ATOL and drift <= DECODE_TIE_ATOL,
              f"beam row {b} parts from the plain path at step {step} rank {rank} where the "
              f"plain path's candidates lie {gap} apart and the paths' scores {drift}: "
              f"not a near-tie")
        ties.append([b, step, rank, gap, drift])
    return ties, score_err


def encoder_error(hid, ref, frame_mask, what: str):
    """(max, mean) abs difference of two encoder outputs over valid frames,
    checked against ENC_MAX_TOL / ENC_MEAN_TOL."""
    diff = (hid - ref).abs()[frame_mask.bool()]
    err = (diff.max().item(), diff.mean().item())
    check(err[0] <= ENC_MAX_TOL and err[1] <= ENC_MEAN_TOL,
          f"{what}: kernel vs plain encoder max {err[0]}, mean {err[1]}")
    return err


def decode_phase(corpus: dict, win_wav, win_lengths, smi: str, dev) -> dict:
    """Phase 12: ASR decoding with GPT-2 shallow fusion and carry-over.
    Returns the B1/B2 launches of the ``decode_asr`` runs."""
    import torch

    from loco_asr_tpu_torch.data.asr_dataset import KaldiAsrDataset
    from loco_asr_tpu_torch.decode import ConversationContext, FusionLM, beam_search, greedy_decode
    from loco_asr_tpu_torch.models.gpt2 import model as gm
    from loco_asr_tpu_torch.models.speecht5 import model as st5
    from loco_asr_tpu_torch.models.speecht5.config import SpeechT5Config
    from loco_asr_tpu_torch.pipelines import decode_asr

    torch.cuda.reset_peak_memory_stats()
    cfg = SpeechT5Config(vocab_size=256)
    model = st5.asr_model_init(cfg, seed=0, device=dev)
    lm_model = gm.gpt2_init(dataclasses.replace(gm.PRESETS["gpt2"], vocab_size=256), seed=1,
                            device=dev)
    lm = FusionLM(lm_model, weight=0.3)
    wav = torch.from_numpy(win_wav).to(dev)
    mask = (torch.arange(wav.shape[1], device=dev)[None, :]
            < torch.tensor(win_lengths, device=dev)[:, None]).to(torch.int32)
    audio_s = sum(win_lengths) / 16000.0
    k, max_len = 5, 200

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    # (a) direct decode of the 8 corpus windows, kernel path against plain path
    with torch.inference_mode():
        enc, enc_mask = st5.encode_speech(model, wav, mask)
        greedy_decode(model, enc, enc_mask, max_len=4, fusion=lm)        # warm-up
        beam_search(model, enc, enc_mask, beam_size=k, max_len=4, fusion=lm)
        runs = {}
        for use_kernels in (True, False):
            reset_all_launches()
            (enc, enc_mask), enc_ms = timed(lambda: st5.encode_speech(
                model, wav, mask, use_kernels=use_kernels))
            with counted_decode_steps() as greedy_steps:
                (toks, lens), greedy_ms = timed(lambda: greedy_decode(
                    model, enc, enc_mask, max_len=max_len, fusion=lm))
            with beam_trace() as trace, counted_decode_steps() as beam_steps:
                hyp, beam_ms = timed(lambda: beam_search(model, enc, enc_mask, beam_size=k,
                                                         max_len=max_len, fusion=lm))
            torch.cuda.synchronize()
            runs[use_kernels] = dict(launches=all_launches(), enc=enc, enc_mask=enc_mask,
                                     toks=toks.cpu().numpy(), hyp=hyp, trace=trace,
                                     greedy_steps=len(greedy_steps),
                                     beam_steps=len(beam_steps),
                                     enc_ms=enc_ms, greedy_ms=greedy_ms, beam_ms=beam_ms)
        kern, plain = runs[True], runs[False]
        want = {"B1": cfg.encoder_layers, "B2": 1, "B3/B4": 0, "B5": 0, "B5_bwd": 0, "B6": 0,
                "B7": 0}
        check(kern["launches"] == want, f"decode: encode + greedy + beam launched "
              f"{kern['launches']}, expected {want}")
        check(not any(plain["launches"].values()), f"plain path launched {plain['launches']}")
        check(torch.equal(kern["enc_mask"], plain["enc_mask"]), "decode: frame masks differ")
        enc_err = encoder_error(kern["enc"], plain["enc"], kern["enc_mask"], "decode windows")
        same_tokens(kern["toks"], plain["toks"], "greedy")
        ties, score_err = beam_agreement(kern, plain)
        toks_np = kern["toks"]
        greedy_steps, beam_steps = kern["greedy_steps"], kern["beam_steps"]
        rec = dict(batch=list(wav.shape), audio_s=audio_s, beam=k, max_len=max_len,
                   lm="gpt2 widths, vocab 256, weight 0.3", launches=kern["launches"],
                   encoder_max_abs=enc_err[0], encoder_mean_abs=enc_err[1],
                   beam_score_max_abs=score_err, beam_near_ties=ties,
                   score_tol=DECODE_SCORE_TOL, tie_atol=DECODE_TIE_ATOL, encode_ms=kern["enc_ms"],
                   plain_encode_ms=plain["enc_ms"],
                   greedy=dict(steps=greedy_steps, ms=kern["greedy_ms"],
                               ms_per_step=kern["greedy_ms"] / greedy_steps,
                               rtfx=audio_s / ((kern["enc_ms"] + kern["greedy_ms"]) / 1e3),
                               lengths=[int(x) for x in (toks_np != cfg.pad_token_id).sum(1)]),
                   beam_search=dict(steps=beam_steps, ms=kern["beam_ms"],
                                    ms_per_step=kern["beam_ms"] / beam_steps,
                                    rtfx=audio_s / ((kern["enc_ms"] + kern["beam_ms"]) / 1e3),
                                    best_lengths=kern["hyp"].lengths[:, 0].tolist()),
                   card=smi)
        print(f"[decode] direct {json.dumps(rec)}")
        enc, enc_mask = kern["enc"], kern["enc_mask"]
        del runs, kern, plain
        for name, fn in (("greedy", lambda: greedy_decode(model, enc, enc_mask, max_len=25,
                                                          fusion=lm)),
                         ("beam", lambda: beam_search(model, enc, enc_mask, beam_size=k,
                                                      max_len=25, fusion=lm))):
            prof = device_breakdown(fn)
            print(f"[decode] device breakdown of a 25-step {name} window: {json.dumps(prof)}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        # (a) carry-over: one recording of 10 utterances through ConversationContext
        ds = KaldiAsrDataset(corpus["dev"])
        rec_id = sorted(ds.examples, key=lambda e: e.utt_id)[0].utt_id.split("-")[0]
        utts = sorted((e for e in ds.examples if e.utt_id.split("-")[0] == rec_id),
                      key=lambda e: e.utt_id)
        check(len(utts) == 10, f"recording {rec_id}: {len(utts)} utterances")
        carry = {}
        for use_kernels in (True, False):
            ctx = ConversationContext(lm, batch=1, max_positions=256)
            refreshes = []
            refresh = ctx._refresh
            ctx._refresh = lambda: refreshes.append(ctx.history_len) or refresh()
            outs, t0 = [], time.perf_counter()
            for ex in utts:
                x = ds.load_waveform(ex)
                w, m = np.zeros((1, 16000), np.float32), np.zeros((1, 16000), np.int32)
                w[0, :len(x)], m[0, :len(x)] = x, 1
                e, em = st5.encode_speech(model, w, m, use_kernels=use_kernels)
                cache, start = ctx.state()
                t, n, cache = greedy_decode(model, e, em, max_len=64, fusion=lm, lm_cache=cache,
                                            lm_start=start, return_lm_cache=True)
                ctx.append(t, n, cache)
                outs.append(t[0].cpu().numpy())
            torch.cuda.synchronize()
            carry[use_kernels] = dict(tokens=outs, refreshes=refreshes,
                                      wall_s=time.perf_counter() - t0)
        for u in range(len(utts)):
            same_tokens(carry[True]["tokens"][u], carry[False]["tokens"][u],
                        f"carry-over utterance {u}")
        check(len(carry[True]["refreshes"]) >= 2,
              f"carry-over refreshed {len(carry[True]['refreshes'])} times")
        print(f"[decode] carry-over {json.dumps(dict(recording=rec_id, utterances=len(utts), max_positions=256, decode_reserve=128, max_len=64, refreshes_at_history=carry[True]['refreshes'], lengths=[int((t != cfg.pad_token_id).sum()) for t in carry[True]['tokens']], wall_s=carry[True]['wall_s'], plain_wall_s=carry[False]['wall_s'], peak_mem_gb=peak_gb, card=smi))}")
    del model, lm, lm_model, enc, enc_mask

    # (b) the pipeline's encodes: dev utterances padded to its 1 s bucket at
    # the static batch (8) and the batcher's admission buckets (4, 2, 1)
    model = st5.asr_model_init(cfg, seed=0, device=dev)
    ds = KaldiAsrDataset(corpus["dev"])
    exs = sorted(ds.examples, key=lambda e: e.utt_id)[:8]
    w, m = np.zeros((8, 16000), np.float32), np.zeros((8, 16000), np.int32)
    for r, ex in enumerate(exs):
        x = ds.load_waveform(ex)[:16000]
        w[r, :len(x)], m[r, :len(x)] = x, 1
    enc_cases = []
    with torch.inference_mode():
        for rows in (8, 4, 2, 1):
            reset_all_launches()
            hid, hmask = st5.encode_speech(model, w[:rows], m[:rows])
            torch.cuda.synchronize()
            got = all_launches()
            check((got["B1"], got["B2"]) == (cfg.encoder_layers, 1),
                  f"encode [{rows}, 16000] launched {got}")
            phid, pmask = st5.encode_speech(model, w[:rows], m[:rows], use_kernels=False)
            check(torch.equal(hmask, pmask), f"encode [{rows}, 16000]: frame masks differ")
            err = encoder_error(hid, phid, hmask, f"encode [{rows}, 16000]")
            enc_cases.append(dict(shape=[rows, 16000], max_abs=err[0], mean_abs=err[1]))
    print(f"[decode_asr] encoder at the pipeline's shapes, kernel vs plain "
          f"(max {ENC_MAX_TOL}, mean {ENC_MEAN_TOL}): {json.dumps(enc_cases)}")
    del model, hid, phid

    # (b) the decode_asr pipeline on the dev corpus in six modes
    results, launches = {}, {"B1": 0, "B2": 0}
    with tempfile.TemporaryDirectory() as tmp:
        lm_path = os.path.join(tmp, "gpt2_vocab256.npz")
        save_gpt2_npz(gm.gpt2_init(dataclasses.replace(gm.PRESETS["gpt2"], vocab_size=256),
                                   seed=1, device=dev), lm_path)
        # the corpus's utterances last <= 1 s: static batches and the
        # batcher's bucket both pad them to 1 s, so both encode the same input
        common = ["--data_dir", corpus["dev"], "--lm_model", "gpt2", "--lm_checkpoint", lm_path,
                  "--max_decode_len", "64", "--batch_size", "8", "--max_seconds", "1"]
        modes = {"static_greedy": ["--beam_size", "1"], "static_beam5": ["--beam_size", "5"],
                 "continuous_greedy": ["--continuous", "--beam_size", "1"],
                 "continuous_beam5": ["--continuous", "--beam_size", "5"],
                 "conversation_greedy": ["--continuous", "--conversation", "--beam_size", "1"],
                 "conversation_beam5": ["--continuous", "--conversation", "--beam_size", "5"]}
        for name, flags in modes.items():
            out_dir = os.path.join(tmp, name)
            reset_all_launches()
            t0 = time.perf_counter()
            rc = decode_asr.main([*common, "--out_dir", out_dir, *flags])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run_launches = all_launches()
            check(rc == 0, f"decode_asr {name} returned {rc}")
            with open(os.path.join(out_dir, "hyp.text")) as f:
                lines = f.read().splitlines()
            with open(os.path.join(out_dir, "wer.json")) as f:
                details = json.load(f)
            check(len(lines) == 120, f"{name}: {len(lines)} lines in hyp.text")
            check(np.isfinite(details["wer"]) and np.isfinite(details["rtfx"]),
                  f"{name}: wer.json {details}")
            check(run_launches["B1"] > 0 and run_launches["B2"] > 0
                  and run_launches["B1"] == cfg.encoder_layers * run_launches["B2"]
                  and not any(v for key, v in run_launches.items() if key not in ("B1", "B2")),
                  f"{name}: launched {run_launches}")
            for key in launches:
                launches[key] += run_launches[key]
            results[name] = dict(lines=lines, wer=details["wer"], rtfx=details["rtfx"],
                                 wall_s=wall, launches=run_launches)
            print(f"[decode_asr] {json.dumps(dict(mode=name, wer=details['wer'], rtfx=details['rtfx'], wall_s=wall, launches=run_launches, card=smi))}")
        for beam in ("greedy", "beam5"):
            static, cont = results[f"static_{beam}"]["lines"], results[f"continuous_{beam}"]["lines"]
            differ = [i for i, (a, b) in enumerate(zip(static, cont)) if a != b]
            check(not differ, f"continuous {beam} differs from static at lines {differ[:5]}: "
                  f"{[(static[i], cont[i]) for i in differ[:2]]}")
    return launches



def grads_against(got: dict, want: dict, what: str):
    """(largest excess of |got - want| over GRAD_RTOL |want|, its parameter,
    largest abs difference) over every gradient, checked against GRAD_ATOL."""
    check(got.keys() == want.keys(), f"{what}: different parameters got gradients")
    worst, worst_name, max_abs = 0.0, "", 0.0
    for k in want:
        diff = (got[k] - want[k]).abs()
        excess = (diff - GRAD_RTOL * want[k].abs()).max().item()
        max_abs = max(max_abs, diff.max().item())
        if excess > worst:
            worst, worst_name = excess, k
    check(worst <= GRAD_ATOL, f"{what}: gradient {worst_name} off by {worst} beyond "
                              f"rtol {GRAD_RTOL} (atol {GRAD_ATOL})")
    return worst, worst_name, max_abs


def lm_training_phase(smi: str, dev) -> dict:
    """Phase 13: GPT-2 LM training at gpt2 width (kernel B6 forward in every
    layer, its blockwise backward) and the LoCo experiment (B1 at head dim
    8 and B2 at 64 channels in its decodes).  Returns the launches of the
    main paths: one train step, the train_lm run, the LoCo ASR stage."""
    import torch

    from loco_asr_tpu_torch.data import lm_datasets
    from loco_asr_tpu_torch.data.asr_dataset import KaldiAsrDataset
    from loco_asr_tpu_torch.data.tokenizer import load_tokenizer
    from loco_asr_tpu_torch.models.gpt2 import model as gm
    from loco_asr_tpu_torch.models.speecht5 import convert as sconvert
    from loco_asr_tpu_torch.models.speecht5 import model as st5
    from loco_asr_tpu_torch.models.speecht5.config import tiny_config
    from loco_asr_tpu_torch.ops.cuda import conv_frontend as cf
    from loco_asr_tpu_torch.ops.cuda import flash_attention as fa
    from loco_asr_tpu_torch.ops.cuda import flash_causal as fc
    from loco_asr_tpu_torch.parallel import train
    from loco_asr_tpu_torch.pipelines import eval_ppl, loco_experiment, train_lm
    from loco_asr_tpu_torch.utils.checkpoint import Checkpointer

    def counts():
        return {"B6": fc.flash_forward_nhd.launches, "B6_bwd": fc.flash_backward.launches,
                "B5": fc.flash_forward.launches, "B1": fa.flash_rel_forward.launches,
                "B2": cf.conv1_instance_norm_gelu.launches,
                "B3/B4": fa.flash_rel_backward.launches}

    def reset():
        fc.flash_forward_nhd.launches = fc.flash_backward.launches = 0
        fc.flash_forward.launches = fa.flash_rel_forward.launches = 0
        cf.conv1_instance_norm_gelu.launches = fa.flash_rel_backward.launches = 0

    none = {"B6": 0, "B6_bwd": 0, "B5": 0, "B1": 0, "B2": 0, "B3/B4": 0}
    t_phase = time.perf_counter()
    # (a) one train step at gpt2 widths, vocabulary 256, dropout off:
    # kernels + flash against plain + dense (AdamW at rate 0 leaves the
    # weights, the gradients stay in .grad)
    cfg = dataclasses.replace(gm.PRESETS["gpt2"], vocab_size=256, embd_pdrop=0.0,
                              attn_pdrop=0.0, resid_pdrop=0.0)
    rng = np.random.default_rng(13)
    B, T = 8, 1024

    def make_batch():
        lengths = rng.integers(T // 2, T + 1, B)
        lengths[0] = T
        return {"ids": torch.as_tensor(rng.integers(0, 256, (B, T)), device=dev),
                "lengths": torch.as_tensor(lengths, device=dev)}

    batch = make_batch()
    lm = gm.gpt2_init(cfg, seed=0, device=dev)
    runs = {}
    for impl in ("flash", "dense"):
        tx = train.adamw(0.0, weight_decay=0.0)
        opt = tx.init(dict(lm.named_parameters()))
        step = train.make_lm_train_step(cfg, tx, attn_impl=impl)
        reset()
        m = step(lm, opt, batch)
        torch.cuda.synchronize()
        runs[impl] = (m["loss"].item(), m["grad_norm"].item(),
                      {k: p.grad.clone() for k, p in lm.named_parameters()}, counts())
        del opt
    (fl, fg, fgr, fcnt), (dl, dg, dgr, dcnt) = runs["flash"], runs["dense"]
    check(np.isfinite(fl) and np.isfinite(fg), f"LM step: loss {fl}, grad_norm {fg}")
    check(abs(fl - dl) <= LOSS_RTOL * abs(dl), f"LM step: loss flash {fl} dense {dl}")
    check(abs(fg - dg) <= GNORM_RTOL * abs(dg), f"LM step: grad_norm flash {fg} dense {dg}")
    worst, worst_name, grad_max_abs = grads_against(fgr, dgr, "LM step")
    want = dict(none, B6=cfg.n_layer, B6_bwd=cfg.n_layer)
    check(fcnt == want, f"flash LM step launched {fcnt}, expected {want}")
    check(dcnt == none, f"dense LM step launched {dcnt}")
    del runs, fgr, dgr
    tx = train.adamw(3e-4)                  # constant rate, no warmup
    opt = tx.init(dict(lm.named_parameters()))
    step = train.make_lm_train_step(cfg, tx, attn_impl="flash")
    batches = [make_batch() for _ in range(10)]
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for bt in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(lm, opt, bt)["loss"].item())     # syncs
        step_ms.append((time.perf_counter() - t0) * 1e3)
    check(all(np.isfinite(losses)), f"LM training losses {losses}")
    peak = {"chunked": torch.cuda.max_memory_allocated() / 1e9}
    dense_loss = train.make_lm_train_step(cfg, tx, attn_impl="flash", loss_impl="dense")
    torch.cuda.reset_peak_memory_stats()
    dense_loss(lm, opt, batches[0])
    torch.cuda.synchronize()
    peak["dense"] = torch.cuda.max_memory_allocated() / 1e9
    med = statistics.median(step_ms[3:])
    prof = device_breakdown(lambda: step(lm, opt, batches[1]))
    rec = dict(model="gpt2", n_embd=cfg.n_embd, n_layer=cfg.n_layer, n_head=cfg.n_head,
               vocab=cfg.vocab_size, batch=[B, T], lengths=batch["lengths"].tolist(),
               loss_flash=fl, loss_dense=dl, grad_norm_flash=fg, grad_norm_dense=dg,
               grad_max_abs_diff=grad_max_abs, grad_worst_excess=worst, grad_worst=worst_name,
               launches_per_step=fcnt, losses=losses, median_step_ms=med,
               tokens_per_s=B * T / (med / 1e3), peak_mem_gb=peak,
               busy_share=prof["busy_share"], device_ms=prof["kernel_ms_sum"],
               device_groups_ms=prof["groups_ms"], card=smi)
    print(f"[lm_train] {json.dumps(rec)}")
    print(f"[lm_train] device breakdown of one step: {json.dumps(prof)}")
    del opt, batches

    # B6's backward at the training shape: [8, 1024, 12, 64] views of a qkv
    # projection, causal, against autograd through B6's plain version
    g = torch.Generator().manual_seed(13)
    x = (torch.randn(B, T, 3 * 768, generator=g) * 0.5).to(dev)
    q, k, v = (y.reshape(B, T, 12, 64) for y in x.split(768, dim=-1))
    gg = torch.randn(B, T, 12, 64, generator=g).to(dev)
    kw = dict(causal=True, scale=0.125)
    out, lse = fc.flash_forward_nhd(q, k, v, **kw)
    got = fc.flash_backward(q, k, v, out, lse, gg, t_axis=1, **kw)
    leaves = [y.detach().clone().requires_grad_() for y in (q, k, v)]

    def plain_fb():
        o, _ = fc.flash_forward_nhd_plain(*leaves, **kw)
        return torch.autograd.grad(o, leaves, gg)

    want_g = plain_fb()
    err = max((a - w).abs().max().item() for a, w in zip(got, want_g))
    check(err <= B56_BWD_TOL, f"B6 backward at the LM training shape: max abs err {err}")
    with torch.no_grad():
        plain_f_ms = time_ms(lambda: fc.flash_forward_nhd_plain(q, k, v, **kw), reps=5, inner=2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs = (y.transpose(1, 2) for y in (q, k, v))
    sl = [y.detach().clone().requires_grad_() for y in (qs, ks, vs)]

    def sdpa_fb():
        torch.autograd.grad(sdpa(*sl, is_causal=True, scale=0.125), sl, gg.transpose(1, 2))

    with torch.no_grad():
        sdpa_f_ms = time_ms(lambda: sdpa(qs, ks, vs, is_causal=True, scale=0.125))
    bwd = dict(kernel="B6 backward", case="lm_train", shape_bthd=[B, T, 12, 64],
               max_abs_err=err, tol=B56_BWD_TOL,
               ms=time_ms(lambda: fc.flash_backward(q, k, v, out, lse, gg, t_axis=1, **kw),
                          reps=5, inner=2),
               plain_ms=time_ms(plain_fb, reps=5, inner=2) - plain_f_ms,
               library_ms=time_ms(sdpa_fb) - sdpa_f_ms, card=smi)
    print(f"[lm_train] {json.dumps(bwd)}")
    del x, q, k, v, gg, out, got, want_g, leaves, sl

    # (b) train_lm at that width on the committed LM corpus: 20 steps, one
    # save and one dev eval; eval_ppl then reads the training directory
    lm_corpus = os.path.join(ROOT, "exp", "loco", "lm_corpus")
    train_txt, dev_txt = (os.path.join(lm_corpus, f) for f in ("train.txt", "dev.txt"))
    tok = load_tokenizer("char")
    tok.vocab_size = 256
    dev_chunks = train_lm._stream_chunks(
        lm_datasets.MaxLenTextDataset(dev_txt, tok, max_len=T).rec_id2tokens, T,
        tok.eos_token_id)
    n_recs = len({u.split("-")[0] for u in lm_datasets.load_key_text(dev_txt)})
    n_steps = 20
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "lm")
        reset()
        t0 = time.perf_counter()
        rc = train_lm.main(["--train_file", train_txt, "--dev_file", dev_txt,
                            "--out_dir", out_dir, "--model", "gpt2", "--tokenizer", "char",
                            "--attn_impl", "flash", "--seq_len", str(T), "--batch_size", "8",
                            "--steps", str(n_steps), "--warmup_steps", "5",
                            "--eval_every", "1000", "--save_every", "1000",
                            "--log_every", "10"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lm_launches = counts()
        check(rc == 0, f"train_lm returned {rc}")
        want = dict(none, B6=cfg.n_layer * (n_steps + -(-len(dev_chunks) // 8)),
                    B6_bwd=cfg.n_layer * n_steps)
        check(lm_launches == want, f"train_lm launched {lm_launches}, expected {want}")
        ckpt = os.path.join(out_dir, "ckpt")
        check(Checkpointer(ckpt).status()["latest"] == n_steps
              and os.path.exists(os.path.join(ckpt, f"step_{n_steps}.npz")),
              f"train_lm saved no step_{n_steps}.npz")
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        evals = [r for r in logged if "dev_ppl" in r]
        losses = [r["loss"] for r in logged if "loss" in r]
        check(len(evals) == 1 and np.isfinite(evals[0]["dev_ppl"]) and losses
              and all(np.isfinite(losses)), f"train_lm metrics {logged}")
        reset()
        t0 = time.perf_counter()
        rc = eval_ppl.main(["-i", dev_txt, "-o", os.path.join(tmp, "ppl"), "--model", "gpt2",
                            "--checkpoint", ckpt, "--context_type", "max_len", "--bsize", "8",
                            "--attn_impl", "flash"])
        eval_wall = time.perf_counter() - t0
        eval_launches = counts()
        check(rc == 0, f"eval_ppl on the training directory returned {rc}")
        check(eval_launches == dict(none, B6=cfg.n_layer * -(-n_recs // 8)),
              f"eval_ppl launched {eval_launches}")
        with open(os.path.join(tmp, "ppl", "rec_id2ppl.json")) as f:
            rec_ppl = json.load(f)
        check(len(rec_ppl) == n_recs and all(np.isfinite(list(rec_ppl.values()))),
              "eval_ppl PPLs on the training directory")
        # the parameters eval_ppl reads there, scored as train_lm's dev eval
        read = eval_ppl.load_gpt2(ckpt, dataclasses.replace(gm.PRESETS["gpt2"], vocab_size=256),
                                  dev)
        total, count = train_lm.dev_nll(read, dev_chunks, 8, T, "flash")
        ppl_read = float(np.exp(total / count))
        ppl_rel = abs(ppl_read - evals[0]["dev_ppl"]) / evals[0]["dev_ppl"]
        check(ppl_rel <= PPL_RTOL, f"read-back dev PPL {ppl_read} vs train_lm's "
                                   f"{evals[0]['dev_ppl']}")
        del read
    rec = dict(steps=n_steps, wall_s=wall, launches=lm_launches, dev_ppl=evals[0]["dev_ppl"],
               dev_tokens=evals[0]["dev_tokens"], losses_logged=losses,
               steps_per_sec=[r["steps_per_sec"] for r in logged if "steps_per_sec" in r],
               eval_ppl_launches=eval_launches, eval_ppl_wall_s=eval_wall,
               eval_ppl_mean_rec_ppl=float(np.mean(list(rec_ppl.values()))),
               read_back_dev_ppl=ppl_read, read_back_rel_diff=ppl_rel, card=smi)
    print(f"[lm_pipeline_train] {json.dumps(rec)}")
    del lm

    with tempfile.TemporaryDirectory() as tmp:
        # (c) the LM stage at the JAX test's own scale, with its assertions
        out = os.path.join(tmp, "lm_stage")
        reset()
        t0 = time.perf_counter()
        rc = loco_experiment.main([
            "--out_dir", out, "--stage", "lm", "--lm_convs", "60", "--lm_dev_convs", "10",
            "--lm_utts", "8", "--lm_steps", "400", "--lm_batch", "8", "--seq_len", "128",
            "--lm_n_embd", "64", "--lm_n_layer", "3", "--seed", "0"])
        lm_wall = time.perf_counter() - t0
        check(rc == 0, f"loco_experiment --stage lm returned {rc}")
        with open(os.path.join(out, "results.json")) as f:
            res = json.load(f)["lm"]
        check(res["nll_indep"] - res["nll_max_len"] > 0.02
              and res["ppl_max_len"] < res["ppl_indep"]
              and res["ppl_streaming"] < res["ppl_indep"], f"LM stage: no context gain {res}")
        print(f"[loco_lm] {json.dumps(dict(res, wall_s=lm_wall, launches=counts()))}")

        # (d) the ASR stage at a smoke scale: training, the three decodes and
        # the oracle, with B1 (head dim 8) and B2 (64 channels) in each encode
        out = os.path.join(tmp, "asr_stage")
        encodes = []
        real_encode = st5.encode_speech

        def counted_encode(model, wav, mask=None, **kw):
            encodes.append(tuple(np.shape(wav)))
            return real_encode(model, wav, mask, **kw)

        st5.encode_speech = counted_encode
        try:
            reset()
            t0 = time.perf_counter()
            rc = loco_experiment.main([
                "--out_dir", out, "--stage", "asr", "--asr_convs", "6",
                "--asr_dev_convs", "2", "--asr_utts", "4", "--asr_steps", "100",
                "--asr_lm_steps", "100", "--asr_lm_convs", "60", "--seed", "0"])
            torch.cuda.synchronize()
            asr_wall = time.perf_counter() - t0
            loco_launches = counts()
        finally:
            st5.encode_speech = real_encode
        check(rc == 0, f"loco_experiment --stage asr returned {rc}")
        tiny = tiny_config(vocab_size=256, hidden_size=32, encoder_attention_heads=4,
                           decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64)
        cfg_asr = dataclasses.replace(tiny, **{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in loco_experiment.CONV_OVER.items()})
        n_enc = len(encodes)
        want = dict(none, B1=cfg_asr.encoder_layers * n_enc, B2=n_enc)
        check(n_enc >= 8 and loco_launches == want,
              f"LoCo ASR stage launched {loco_launches} over {n_enc} encodes, expected {want}")
        with open(os.path.join(out, "results.json")) as f:
            res = json.load(f)["asr"]
        keys = {"nofusion", "carry", "nocarry", "oracle"}
        metrics = {"wer_all", "wer_clean", "wer_degraded", "name_recovery"}
        check(set(res) == keys | {"wer_gain_degraded"}
              and all(set(res[k]) == metrics and all(np.isfinite(list(res[k].values())))
                      for k in keys) and np.isfinite(res["wer_gain_degraded"]),
              f"LoCo ASR results {res}")
        # the trained encoder at the decodes' shapes, kernel path against plain
        asr = st5.asr_model_init(cfg_asr, device=dev)
        asr.load_state_dict(sconvert.asr_from_jax_params(
            eval_ppl.training_dir_params(os.path.join(out, "asr", "ckpt")), cfg_asr),
            strict=True)
        ds = KaldiAsrDataset(os.path.join(out, "asr_corpus", "dev"))
        wavs = [ds.load_waveform(e) for e in ds.examples]
        bucket = max(len(w) for w in wavs)
        enc_err = {}
        for rows in sorted({shape[0] for shape in encodes}):
            wav = np.zeros((rows, bucket), np.float32)
            mask = np.zeros((rows, bucket), np.int32)
            for r in range(rows):
                w = wavs[r % len(wavs)]
                wav[r, :len(w)] = w
                mask[r, :len(w)] = 1
            reset()
            hid, fmask = real_encode(asr, wav, mask)
            check(counts() == dict(none, B1=cfg_asr.encoder_layers, B2=1),
                  f"LoCo encode at {rows} rows launched {counts()}")
            phid, _ = real_encode(asr, wav, mask, use_kernels=False)
            enc_err[rows] = encoder_error(hid, phid, fmask, f"LoCo encoder [{rows}, {bucket}]")
        rec = dict(results=res, wall_s=asr_wall, launches=loco_launches, encodes=n_enc,
                   encode_shapes=sorted(set(encodes)), frames=int(hid.shape[1]),
                   encoder_err=enc_err, card=smi)
        print(f"[loco_asr] {json.dumps(rec)}")
    print(f"[lm_phase] {json.dumps(dict(wall_s=time.perf_counter() - t_phase))}")
    return {"train_step": fcnt, "train_lm": lm_launches, "loco_asr": loco_launches}


INTENT_SPLITS = (("train", 64), ("train_synthetic", 16), ("devel", 16), ("test", 16))
INTENT_POOLINGS = ("average", "max", "attention")
INTENT_TOL = 1e-4     # metrics.jsonl losses, card run against a CPU run


def intent_phase(smi: str, dev) -> dict:
    """Phase 14: SLURP intent classification at full width (SpeechT5-base,
    768, 12 layers).  Returns the launches of the audio extraction, every
    split, counted from zero just before it."""
    import torch

    from loco_asr_tpu_torch.data.embedding_store import EmbeddingStore
    from loco_asr_tpu_torch.data.intent_classes import INTENT_CLASSES
    from loco_asr_tpu_torch.models.speecht5 import convert as sconvert
    from loco_asr_tpu_torch.models.speecht5 import model as st5
    from loco_asr_tpu_torch.models.speecht5.config import SpeechT5Config
    from loco_asr_tpu_torch.pipelines import common, extract_embeddings, slurp_sweep
    from loco_asr_tpu_torch.pipelines import train_classifier

    cfg = SpeechT5Config()
    none = {k: 0 for k in all_launches()}
    t_phase = time.perf_counter()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        # (a) a SLURP directory over all 101 intents, then both modalities'
        # embeddings of every split
        root = os.path.join(tmp, "slurp")
        first, lengths = 0, {}
        for i, (split, n) in enumerate(INTENT_SPLITS):
            lengths[split] = write_slurp(root, n, seed=20 + i, split=split,
                                         intents=list(INTENT_CLASSES), first=first)
            first += n
        check(first >= len(INTENT_CLASSES), "labels do not cover every intent")
        folder = os.path.join(tmp, "extracted", "speecht5")
        spm = os.path.join(tmp, "slurp.model")
        write_sentencepiece_model(spm, SLURP_SPM_PIECES)
        extraction = {}
        intent_launches = dict(none)
        real_encode = st5.encode_speech
        for modality, flags in (("audio", []), ("text", ["--tokenizer", spm])):
            for split, n in INTENT_SPLITS:
                encodes = []

                def kept_encode(model, wav, mask=None, **kw):
                    hid, fmask = real_encode(model, wav, mask, **kw)
                    encodes.append((model, wav, mask, hid, fmask))
                    return hid, fmask

                st5.encode_speech = kept_encode
                try:
                    reset_all_launches()
                    t0 = time.perf_counter()
                    rc = extract_embeddings.main([
                        "-m", modality, "-s", split, "--data_path", root,
                        "--out_dir", os.path.join(folder, split, modality),
                        "--batch_size", "16", *flags])
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    got = all_launches()
                finally:
                    st5.encode_speech = real_encode
                check(rc == 0, f"extract_embeddings -m {modality} -s {split} returned {rc}")
                n_batches = -(-n // 16)
                want = (dict(none, B1=cfg.encoder_layers * n_batches, B2=n_batches)
                        if modality == "audio" else none)
                check(got == want, f"-m {modality} -s {split}: launched {got}, expected {want}")
                check(len(encodes) == (n_batches if modality == "audio" else 0),
                      f"-m {modality} -s {split}: {len(encodes)} speech encodes")
                # each batch's encoder output, kernel path against plain path
                enc_err = []
                for model, wav, mask, hid, fmask in encodes:
                    with torch.inference_mode():
                        phid, pmask = real_encode(model, wav, mask, use_kernels=False)
                    check(torch.equal(fmask, pmask), f"-m audio -s {split}: frame masks differ")
                    enc_err.append([list(np.shape(wav)), *encoder_error(
                        hid, phid, fmask, f"-m audio -s {split} {list(np.shape(wav))}")])
                del encodes
                if modality == "audio":
                    intent_launches = {k: intent_launches[k] + v for k, v in got.items()}
                store = EmbeddingStore(os.path.join(folder, split, modality))
                check(len(store) == n, f"{modality}/{split}: {len(store)} records")
                for j in range(n):
                    _, emb, tgt = store[j]
                    frames = (cfg.feat_extract_output_length(lengths[split][j])
                              if modality == "audio" else emb.shape[0])
                    check(emb.shape == (frames, 768) and bool(np.isfinite(emb).all())
                          and tgt.shape == (len(INTENT_CLASSES),),
                          f"{modality}/{split} record {j}: {emb.shape}")
                extraction[f"{modality}/{split}"] = dict(records=n, wall_s=wall, launches=got,
                                                         encoder_err=enc_err)
        print(f"[intent_extract] {json.dumps(dict(extraction=extraction, card=smi))}")

        # (b) train_classifier on the audio store, each pooling and the MLP
        # head, 3 epochs on the card, then the same command on the CPU
        runs = [(p, []) for p in INTENT_POOLINGS] + [("attention", ["--hidden_dims", "256"])]
        classifier = []
        for pooling, extra in runs:
            argv = ["-m", "audio", "-p", pooling, "--folder", folder, "--epochs", "3",
                    "--seed", "0", *extra]
            metrics = {}
            for device in ("cuda", "cpu"):
                run_dir = os.path.join(tmp, "runs", f"{pooling}{len(extra)}_{device}")
                os.makedirs(run_dir)
                os.chdir(run_dir)
                try:
                    reset_all_launches()
                    t0 = time.perf_counter()
                    rc = train_classifier.main([*argv, "--device", device])
                    wall = time.perf_counter() - t0
                finally:
                    os.chdir(cwd)
                check(rc == 0, f"train_classifier {argv} --device {device} returned {rc}")
                check(all_launches() == none, f"train_classifier launched {all_launches()}")
                ckpt = os.path.join(run_dir, "checkpoints", "fine_tuned", "audio", pooling)
                logs = os.path.join(run_dir, "results", "fine_tuned", "audio", pooling, "logs")
                files = [f"speecht5_{pooling}_audio_{x}.npz"
                         for x in ("epoch_1", "epoch_2", "epoch_3", "best", "last")]
                files += ["status.json", "step_3.npz"]
                check(all(os.path.exists(os.path.join(ckpt, f)) for f in files)
                      and os.path.exists(os.path.join(logs, "results.txt")),
                      f"train_classifier artifacts missing under {run_dir}")
                with open(os.path.join(logs, "metrics.jsonl")) as f:
                    metrics[device] = [json.loads(line) for line in f]
                if device == "cuda":
                    card_wall = wall
            m, c = metrics["cuda"], metrics["cpu"]
            check(len(m) == len(c) == 3, f"{pooling}: {len(m)} / {len(c)} epochs logged")
            losses = [e["train_loss"] for e in m]
            check(all(np.isfinite([e[k] for e in m for k in ("train_loss", "val_loss")]))
                  and losses[-1] < losses[0], f"{pooling}: train losses {losses}")
            err = max(abs(a[k] - b[k]) for a, b in zip(m, c) for k in ("train_loss", "val_loss"))
            check(err <= INTENT_TOL and all(a[k] == b[k] for a, b in zip(m, c)
                                            for k in ("train_acc", "val_acc")),
                  f"{pooling}: card and CPU metrics part (loss error {err})\n{m}\n{c}")
            rec = dict(pooling=pooling, hidden_dims=[int(x) for x in extra[1:]] or None,
                       train_losses=losses,
                       val_losses=[e["val_loss"] for e in m],
                       val_acc=[e["val_acc"] for e in m], card_cpu_loss_err=err,
                       wall_s=card_wall, card=smi)
            classifier.append(rec)
            print(f"[intent_train] {json.dumps(rec)}")

        # the classifier step alone at the store's batch shape, by CUDA events
        from loco_asr_tpu_torch.models import intent
        from loco_asr_tpu_torch.parallel.train import reference_adam
        store = EmbeddingStore([os.path.join(folder, "train", "audio")])
        emb, lens, tgts = next(store.padded_batches(16))
        batch = [torch.from_numpy(x).to(dev) for x in (emb, lens, tgts)]
        step_ms = {}
        for pooling in INTENT_POOLINGS:
            model = intent.intent_classifier_init(768, 101, seed=0, device=dev)
            tx = reference_adam()
            state = tx.init(dict(model.named_parameters()))
            step = train_classifier.make_classifier_step(pooling, True, tx)
            step_ms[pooling] = time_ms(lambda: step(model, state, *batch))
        print(f"[intent_step] {json.dumps(dict(batch=list(emb.shape), step_ms=step_ms, card=smi))}")

        # (c) the sweep over both modalities and the three poolings
        sweep_dir = os.path.join(tmp, "sweep")
        os.makedirs(sweep_dir)
        os.chdir(sweep_dir)
        try:
            t0 = time.perf_counter()
            rc = slurp_sweep.main(["--folder", folder, "--epochs", "2"])
            sweep_wall = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        check(rc == 0, f"slurp_sweep returned {rc}")
        with open(os.path.join(sweep_dir, "results", "fine_tuned", "sweep.json")) as f:
            sweep = json.load(f)
        check(len(sweep) == 6 and all(r["status"] == "ok" for r in sweep.values()),
              f"sweep.json {sweep}")
        print(f"[intent_sweep] {json.dumps(dict(sweep=sweep, wall_s=sweep_wall))}")

        # (d) an HF-layout state dict of the port's own seeded encoder as a
        # model.safetensors directory, read without the package, against the
        # .npz route of the same weights
        src = st5.asr_init(cfg, seed=7, device="cpu")
        flat = sconvert.encoder_to_jax_params(src)
        hf_dir = os.path.join(tmp, "hf")
        os.makedirs(hf_dir)
        save_safetensors(os.path.join(hf_dir, "model.safetensors"), hf_speecht5_state(flat))
        npz = os.path.join(tmp, "encoder.npz")
        np.savez(npz, **flat)
        t0 = time.perf_counter()
        from_hf = common.load_speecht5_params(hf_dir, cfg, device=dev)
        hf_load_s = time.perf_counter() - t0
        from_npz = common.load_speecht5_params(npz, cfg, device=dev)
        a, b = from_hf.state_dict(), from_npz.state_dict()
        check(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a),
              "the .safetensors route loads other weights than the .npz route")
        wav = np.random.default_rng(3).standard_normal((2, 48000)).astype(np.float32) * 0.1
        mask = np.ones_like(wav, np.int32)
        mask[1, 30000:] = 0
        h_hf, _ = st5.encode_speech(from_hf, wav, mask)
        h_npz, _ = st5.encode_speech(from_npz, wav, mask)
        check(torch.equal(h_hf, h_npz), "encoder outputs of the two routes differ")
        seeded = st5.asr_init(cfg, seed=0, device=dev)
        check(not torch.equal(st5.encode_speech(seeded, wav, mask)[0], h_hf),
              "the .safetensors route kept the seeded init")
        print(f"[intent_import] {json.dumps(dict(tensors=len(flat), load_s=hf_load_s))}")
    print(f"[intent_phase] {json.dumps(dict(wall_s=time.perf_counter() - t_phase))}")
    return intent_launches


LOCO_LABELS = ("nofusion", "carry", "nocarry", "oracle")


def loco_reference_phase(smi: str, dev) -> dict:
    """Phase 15: the LoCo ASR stage's decodes on the reference's own trained
    weights (``fixtures/loco_reference``), through B1 at head dim 8 and B2 at
    64 channels, against ``exp/loco/results.json``; then the same decodes
    with the plain versions on the card, which must give the same entries
    and hypotheses.  Returns the kernel run's launches."""
    import torch

    from loco_asr_tpu_torch.models.speecht5 import model as st5
    from loco_asr_tpu_torch.pipelines import loco_experiment

    with open(os.path.join(ROOT, "exp", "loco", "results.json")) as f:
        recorded = json.load(f)["asr"]
    none = {k: 0 for k in all_launches()}
    runs = {}
    real_encode = st5.encode_speech
    with tempfile.TemporaryDirectory() as tmp:
        for path in ("kernels", "plain"):
            out = os.path.join(tmp, path)
            for name in ("asr", "asr_lm"):
                shutil.copytree(os.path.join(ROOT, "fixtures", "loco_reference", name),
                                os.path.join(out, name, "ckpt"))
            encodes = []

            def counted_encode(model, wav, mask=None, use_kernels=True, **kw):
                encodes.append(tuple(np.shape(wav)))
                return real_encode(model, wav, mask, use_kernels=path == "kernels", **kw)

            st5.encode_speech = counted_encode
            try:
                reset_all_launches()
                t0 = time.perf_counter()
                rc = loco_experiment.main(["--out_dir", out, "--stage", "asr",
                                           "--skip_training", "--fusion_weights", "1.0"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = all_launches()
            finally:
                st5.encode_speech = real_encode
            check(rc == 0, f"loco_experiment ({path}) returned {rc}")
            n = len(encodes)
            want = (dict(none, B1=2 * n, B2=n) if path == "kernels" else none)
            check(n >= 12 and launches == want,
                  f"{path}: {n} encodes launched {launches}, expected {want}")
            with open(os.path.join(out, "results.json")) as f:
                res = json.load(f)["asr"]
            with open(os.path.join(out, "asr_hyps.json")) as f:
                hyps = json.load(f)
            runs[path] = dict(results={k: res[k] for k in LOCO_LABELS}, hyps=hyps,
                              wall_s=wall, encodes=n, launches=launches)
    kern, plain = runs["kernels"], runs["plain"]
    parted = sorted((uid, label) for uid, h in kern["hyps"].items() for label in LOCO_LABELS
                    if h[label] != plain["hyps"][uid][label])
    # the recorded entries, to every digit, on both paths; no hypothesis
    # parts between them
    for path in ("kernels", "plain"):
        for label in LOCO_LABELS:
            for key, value in recorded[label].items():
                check(abs(runs[path]["results"][label][key] - value) <= 1e-12,
                      f"LoCo on the reference weights ({path}): {label}.{key} "
                      f"{runs[path]['results'][label][key]} against the recorded {value}; "
                      f"kernel and plain paths part at {parted}")
    check(not parted, f"LoCo on the reference weights: kernel and plain hypotheses part at "
                      f"{parted}")
    rec = dict(results=kern["results"], recorded={k: recorded[k] for k in LOCO_LABELS},
               wall_s=kern["wall_s"], plain_wall_s=plain["wall_s"], encodes=kern["encodes"],
               launches=kern["launches"],
               launches_per_encode={k: v / kern["encodes"] for k, v in kern["launches"].items()
                                    if v},
               card=smi)
    print(f"[loco_reference] {json.dumps(rec)}")
    return kern["launches"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from loco_asr_tpu_torch.data import lm_datasets
    from loco_asr_tpu_torch.data.asr_dataset import ConversationAsrDataset
    from loco_asr_tpu_torch.data.tokenizer import load_tokenizer
    from loco_asr_tpu_torch.data.embedding_store import EmbeddingStore
    from loco_asr_tpu_torch.models.gpt2 import model as gm
    from loco_asr_tpu_torch.models.speecht5 import model as st5
    from loco_asr_tpu_torch.models.speecht5.config import SpeechT5Config
    from loco_asr_tpu_torch.ops.cuda import _build
    from loco_asr_tpu_torch.ops.cuda import conv_frontend as cf
    from loco_asr_tpu_torch.ops.cuda import flash_attention as fa
    from loco_asr_tpu_torch.ops.cuda import flash_causal as fc
    from loco_asr_tpu_torch.ops.cuda import logmel
    from loco_asr_tpu_torch.models.speecht5 import vocoder
    from loco_asr_tpu_torch.parallel import train
    from loco_asr_tpu_torch.pipelines import eval_ppl, extract_embeddings, train_asr

    # -- 1. environment ---------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"[env] nvidia-smi: {smi}")
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")
    print(f"[env] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    print(f"[build] {os.path.relpath(path)} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {'ran' if _build.build_seconds is not None else 'skipped: cached'})")
    for line in _build.build_log.splitlines():
        if any(w in line for w in ("registers", "Compiling entry", "spill")):
            print(f"[build] {line.strip()}")
    for rec in (b1_build_records(_build) + b34_build_records(_build)
                + b2_b7_build_records(_build)):
        print(f"[build] {rec['kernel']} {json.dumps(rec)}")

    # the committed ASR corpus, with its wav.scp pointing into this checkout
    tmp_corpus = tempfile.TemporaryDirectory()
    corpus = relocate_corpus(tmp_corpus.name)
    win_wav, win_lengths, win_texts = corpus_windows(corpus["train"], 8)

    # -- 3. kernel checks -------------------------------------------------
    warm_up(dev)
    g = torch.Generator().manual_seed(0)

    def randn(*shape, sc=0.3):
        return (torch.randn(*shape, generator=g) * sc).to(dev)

    checks = []
    # (case, B, Tq, Tk, L (0: the mask-only variant, as flash_attention
    # runs it without rel_pe), causal, valid lengths, layout, H, D);
    # "split_heads" hands q/k/v over as the encoder does, transposed views
    # of [B, T, 768] projections, read in place; the "loco" cases are the
    # LoCo experiment's tiny encoder (4 heads of 8, L = 20) at its decode
    # batches of 4 slots of 1 s (398 frames), a slot padded and one empty
    rel_lens = [249] * 10 + [230, 200, 180, 120, 60, 17]
    loco_lens = [398, 350, 201, 0]
    b1_cases = [
        ("rel_padded", 16, 249, 249, 160, False, rel_lens, "bhtd", 12, 64),
        ("rel_causal", 16, 249, 249, 160, True, [249] * 14 + [200, 100], "bhtd", 12, 64),
        ("mask_only", 16, 249, 249, 0, False, [249] * 12 + [200, 150, 99, 40], "bhtd", 12, 64),
        ("rel_long", 2, 2048, 2048, 160, False, [2048, 1500], "bhtd", 12, 64),
        ("vl0", 16, 249, 249, 160, False, [249] * 12 + [0, 120, 0, 60], "bhtd", 12, 64),
        ("cross_mask_only", 8, 192, 500, 0, False, [500] * 6 + [430, 310], "bhtd", 12, 64),
        ("rel_strided", 16, 249, 249, 160, False, rel_lens, "split_heads", 12, 64),
        ("loco_d8", 4, 398, 398, 20, False, loco_lens, "bhtd", 4, 8),
        ("loco_mask_only_d8", 4, 398, 398, 0, False, loco_lens, "bhtd", 4, 8),
        ("loco_d32", 4, 398, 398, 20, False, loco_lens, "bhtd", 4, 32),
    ]
    for name, b, tq, tk, L, causal, vls, layout, h, d in b1_cases:
        if layout == "split_heads":
            q, k, v = (randn(b, t, h * d).reshape(b, t, h, d).transpose(1, 2)
                       for t in (tq, tk, tk))
        else:
            q, k, v = randn(b, h, tq, d), randn(b, h, tk, d), randn(b, h, tk, d)
        pe = randn(2 * L, d) if L else None
        table = pe if L else torch.zeros(2, d, device=dev)   # the plain version's
        vl = torch.tensor(vls, dtype=torch.int32, device=dev)
        kw = dict(causal=causal, scale=1.0)

        def run():
            return fa.flash_rel_forward(q, k, v, pe, vl, **kw)

        out, lse = run()
        torch.cuda.synchronize()
        pout, plse = fa.flash_rel_forward_plain(q, k, v, table, vl, **kw)
        err = max((out - pout).abs().max().item(), (lse - plse).abs().max().item())
        check(bool(torch.isfinite(out).all() and torch.isfinite(lse).all()),
              f"B1 {name}: non-finite output")
        check(err <= B1_TOL, f"B1 {name}: max abs err {err} > {B1_TOL}")
        lib_ms = None
        if not L:   # one PyTorch call computes the mask-only variant
            keep = (torch.arange(tk, device=dev)[None, :] < vl[:, None])[:, None, None, :]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=keep, scale=1.0))
        nbytes, flops = b1_work(q, k, pe, vl, causal)
        bms, by = bound(nbytes, flops, products=True)
        ms = time_ms(run)
        dev_ms = kernel_device_ms(run, ("flash_rel_fwd",))["flash_rel_fwd"]
        rec = dict(kernel="B1", case=name, shape=[b, h, tq, d], tk=tk,
                   two_l=2 * L if L else "mask-only", causal=causal, layout=layout,
                   max_abs_err=err, tol=B1_TOL, ms=ms, device_ms=dev_ms, host_ms=ms - dev_ms,
                   plain_ms=time_ms(lambda: fa.flash_rel_forward_plain(q, k, v, table, vl, **kw)),
                   library_ms=lib_ms, bound_ms=bms, bound_by=by, bound_share=bms / ms,
                   device_bound_share=bms / dev_ms, ops_ms_f32_cores=cores_ms(flops))
        checks.append(rec)
        print(f"[kernels] {json.dumps(rec)}")
        del q, k, v, out, pout

    for rec in b2_case_checks(cf, smi):
        checks.append(rec)
        print(f"[kernels] {json.dumps(rec)}")

    for rec in b7_case_checks(logmel, win_wav, smi):
        checks.append(rec)
        print(f"[kernels] {json.dumps(rec)}")

    sdpa = torch.nn.functional.scaled_dot_product_attention
    tr = lambda x: x.transpose(1, 2)   # [B, T, H, D] <-> [B, H, T, D] view

    def qkv_views(b, t, h, d):
        """q, k, v as [B, T, H, D] column views of one qkv projection
        output, as a GPT-2 layer hands them to the kernel."""
        x = randn(b, t, 3 * h * d, sc=0.5)
        return [y.reshape(b, t, h, d) for y in x.split(h * d, dim=-1)]

    # (kernel, case, B, H, Tq, Tk, D, causal); B6 and the gpt2-xl B5 case
    # read strided views of a qkv projection, as on the scoring path
    b56_cases = [
        ("B6", "gpt2_max_len", 8, 12, 1024, 1024, 64, True),
        ("B6", "gpt2_indep", 128, 12, 27, 27, 64, True),
        ("B5", "gpt2xl", 8, 25, 1024, 1024, 64, True),
        ("B5", "noncausal_384", 2, 12, 384, 384, 64, False),
        ("B5", "tq_ne_tk", 2, 4, 100, 160, 8, True),
        ("B5", "decoder_train", 8, 12, 160, 160, 64, True),
    ]
    for kern, name, b, h, tq, tk, d, causal in b56_cases:
        if name == "decoder_train":   # the ASR decoder's self-attention, [B, H, T, D]
            q, k, v = randn(b, h, tq, d, sc=0.5), randn(b, h, tk, d, sc=0.5), randn(b, h, tk, d, sc=0.5)
        elif tq == tk:
            q, k, v = qkv_views(b, tq, h, d)        # [B, T, H, D]
            if kern == "B5":
                q, k, v = tr(q), tr(k), tr(v)       # [B, H, T, D] views
        else:
            q = randn(b, h, tq, d, sc=0.5)
            k, v = randn(b, h, tk, d, sc=0.5), randn(b, h, tk, d, sc=0.5)
        kw = dict(causal=causal, scale=d ** -0.5)
        fn, plain = ((fc.flash_forward_nhd, fc.flash_forward_nhd_plain) if kern == "B6"
                     else (fc.flash_forward, fc.flash_forward_plain))
        out, lse = fn(q, k, v, **kw)
        torch.cuda.synchronize()
        pout, plse = plain(q, k, v, **kw)
        err = max((out - pout).abs().max().item(), (lse - plse).abs().max().item())
        check(bool(torch.isfinite(out).all() and torch.isfinite(lse).all()),
              f"{kern} {name}: non-finite output")
        check(err <= B56_TOL, f"{kern} {name}: max abs err {err} > {B56_TOL}")
        qs, ks, vs = (tr(x) for x in (q, k, v)) if kern == "B6" else (q, k, v)
        nbytes, flops = causal_work(b, h, tq, tk, d, causal)
        bms, by = bound(nbytes, flops, products=True)
        ms = time_ms(lambda: fn(q, k, v, **kw))
        dev_ms = kernel_device_ms(lambda: fn(q, k, v, **kw),
                                  ("flash_causal_fwd",))["flash_causal_fwd"]
        rec = dict(kernel=kern, case=name, shape_bhtd=[b, h, tq, d], tk=tk, causal=causal,
                   max_abs_err=err, tol=B56_TOL, ms=ms,
                   plain_ms=time_ms(lambda: plain(q, k, v, **kw)),
                   library_ms=time_ms(lambda: sdpa(qs, ks, vs, is_causal=causal,
                                                   scale=kw["scale"])),
                   device_ms=dev_ms, host_ms=ms - dev_ms,
                   bound_ms=bms, bound_by=by, bound_share=bms / ms,
                   ops_ms_f32_cores=cores_ms(flops), bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        checks.append(rec)
        print(f"[kernels] {json.dumps(rec)}")
        del q, k, v, qs, ks, vs, out, pout

    # the gradient of B1: B3 + B4 (and the band's matmuls) against the plain
    # version, at the encoder's and the cross-attention's training shapes
    def rel_bwd_plain(q, k, v, pe, vl, out, lse, gg, causal):
        dq, dk, dv, dqpe = fa.flash_rel_backward_plain(q, k, v, pe, vl, out, lse, gg,
                                                       causal=causal, scale=1.0)
        return (dq + dqpe @ pe, dk, dv, torch.einsum("bhim,bhid->md", dqpe, q))

    def sdpa_bwd_ms(q, k, v, gg, mask):
        """SDPA forward + backward minus its forward, f32 with a key mask."""
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]

        def fb():
            o = sdpa(*leaves, attn_mask=mask, scale=1.0)
            torch.autograd.grad(o, leaves, gg)

        def f():
            with torch.no_grad():
                sdpa(q, k, v, attn_mask=mask, scale=1.0)
        return time_ms(fb) - time_ms(f)

    # (case, B, Tq, Tk, L (0: mask-only, as flash_attention runs the
    # cross-attention), causal, valid lengths (None: all but two rows full),
    # layout); "split_heads" hands q/k/v and the cotangent over as training
    # does, views of [B, T, 768] buffers, read in place
    bwd_cases = [("enc_padded", 8, 500, 500, 160, False, None, "bhtd"),
                 ("enc_causal", 8, 500, 500, 160, True, None, "bhtd"),
                 ("cross_mask_only", 8, 160, 500, 0, False, None, "bhtd"),
                 ("strided", 8, 500, 500, 160, False, None, "split_heads"),
                 ("vl0", 8, 500, 500, 160, False, [500] * 5 + [0, 310, 0], "bhtd"),
                 ("tq_ne_tk", 8, 160, 500, 160, False, None, "bhtd")]
    for name, b, tq, tk, L, causal, vls, layout in bwd_cases:
        if layout == "split_heads":
            q, k, v, gg = (randn(b, t, 768, sc=sc).reshape(b, t, 12, 64).transpose(1, 2)
                           for t, sc in ((tq, 0.3), (tk, 0.3), (tk, 0.3), (tq, 1.0)))
        else:
            q, k, v = randn(b, 12, tq, 64), randn(b, 12, tk, 64), randn(b, 12, tk, 64)
            gg = randn(b, 12, tq, 64, sc=1.0)
        mask_only = L == 0
        pe = torch.zeros(2, 64, device=dev) if mask_only else randn(2 * L, 64)
        if vls is None:
            vls = [tk] * (b - 2) + [tk - 70, tk - 190]
        vl = torch.tensor(vls, dtype=torch.int32, device=dev)
        out, lse = fa.flash_rel_forward(q, k, v, None if mask_only else pe, vl,
                                        causal=causal, scale=1.0)
        kw = dict(causal=causal, scale=1.0, need_dpe=not mask_only, mask_only=mask_only)

        def run():
            return fa.flash_rel_backward(q, k, v, pe, vl, out, lse, gg, **kw)

        got = run()
        torch.cuda.synchronize()
        want = rel_bwd_plain(q, k, v, pe, vl, out, lse, gg, causal)
        errs = {n: (a - w).abs().max().item() for n, a, w in zip("q k v".split(), got, want)}
        if not mask_only:
            errs["pe"] = (got[3] - want[3]).abs().max().item() / want[3].abs().max().item()
        check(all(bool(torch.isfinite(t).all()) for t in got if t is not None),
              f"B3/B4 {name}: non-finite gradient")
        check(max(errs.values()) <= B34_TOL,
              f"B3/B4 {name}: errors {errs} > {B34_TOL} (dpe relative to its max)")
        check(all(x.transpose(1, 2).is_contiguous() for x in got[:3]),
              f"B3/B4 {name}: dq/dk/dv are not views of [B, T, H, 64] buffers")
        check(mask_only == (got[3] is None), f"B3/B4 {name}: dpe {got[3] is None}")
        lib_ms = None
        if mask_only or causal:
            keep = (torch.arange(tk, device=dev)[None, :] < vl[:, None])[:, None, None, :]
            if causal:
                keep = keep & (torch.arange(tk, device=dev)[None, :]
                               <= torch.arange(tq, device=dev)[:, None])
            lib_ms = sdpa_bwd_ms(q, k, v, gg, keep)
        split = kernel_device_ms(run, ("flash_rel_bwd_dq", "flash_rel_bwd_dkv"))
        (b3b, b3f), (b4b, b4f) = b34_work(q, k, pe, vl, causal)
        ms = time_ms(run)
        rec = dict(kernel="B3/B4", case=name, shape=[b, 12, tq, 64], tk=tk,
                   two_l=2 * L if L else "mask-only", causal=causal, layout=layout,
                   max_abs_err=max(errs.values()), errs=errs, tol=B34_TOL, ms=ms,
                   plain_ms=time_ms(lambda: rel_bwd_plain(q, k, v, pe, vl, out, lse,
                                                          gg, causal)),
                   library_ms=lib_ms, b3_ms=split["flash_rel_bwd_dq"],
                   b4_ms=split["flash_rel_bwd_dkv"],
                   b3_bound=bound(b3b, b3f, products=True), b4_bound=bound(b4b, b4f, products=True),
                   b3_ops_ms_f32_cores=cores_ms(b3f), b4_ops_ms_f32_cores=cores_ms(b4f))
        if name in ("enc_padded", "cross_mask_only"):   # B3, B4, delta, band matmuls
            rec["device_ms"] = device_breakdown(run)["kernel_ms_sum"]
            rec["host_ms"] = ms - rec["device_ms"]
        checks.append(rec)
        print(f"[kernels] {json.dumps(rec)}")
        del q, k, v, out, gg, got, want

    # B5's backward (blockwise PyTorch, the counterpart of the JAX XLA
    # backward) against autograd through B5's plain version, decoder shape
    q, k, v = randn(8, 12, 160, 64, sc=0.5), randn(8, 12, 160, 64, sc=0.5), randn(8, 12, 160, 64, sc=0.5)
    gg = randn(8, 12, 160, 64, sc=1.0)
    kw = dict(causal=True, scale=0.125)
    out, lse = fc.flash_forward(q, k, v, **kw)
    got = fc.flash_backward(q, k, v, out, lse, gg, t_axis=2, **kw)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]

    def plain_fb():
        o, _ = fc.flash_forward_plain(*leaves, **kw)
        return torch.autograd.grad(o, leaves, gg)

    want = plain_fb()
    err = max((a - w).abs().max().item() for a, w in zip(got, want))
    check(err <= B56_BWD_TOL, f"B5 backward: max abs err {err} > {B56_BWD_TOL}")
    with torch.no_grad():
        plain_f_ms = time_ms(lambda: fc.flash_forward_plain(q, k, v, **kw))
    mask = torch.ones(160, 160, dtype=torch.bool, device=dev).tril()
    b5_bwd = dict(kernel="B5/B6 backward", case="decoder_causal", shape=[8, 12, 160, 64],
                  max_abs_err=err, tol=B56_BWD_TOL,
                  ms=time_ms(lambda: fc.flash_backward(q, k, v, out, lse, gg, t_axis=2, **kw)),
                  plain_ms=time_ms(plain_fb) - plain_f_ms,
                  library_ms=sdpa_bwd_ms(q * 0.125, k, v, gg, mask))
    print(f"[kernels] {json.dumps(b5_bwd)}")

    # on CUDA tensors that require grad, every flash output keeps the graph
    # and kernel B2 (no backward) refuses
    x = randn(2, 12, 40, 64).requires_grad_()
    y = randn(2, 12, 40, 64)
    outs = {"B1": fa.flash_attention(x, y, y, causal=False, scale=1.0, rel_pe=randn(8, 64),
                                     kv_valid_len=torch.tensor([40, 30], device=dev)),
            "B5": fc.flash_forward(x, y, y, causal=True, scale=1.0)[0],
            "B6": fc.flash_forward_nhd(tr(x), tr(y), tr(y), causal=True, scale=1.0)[0]}
    for kname, o in outs.items():
        check(o.grad_fn is not None, f"{kname}: CUDA output has no grad_fn")
    try:
        cf.conv1_instance_norm_gelu(randn(2, 4000), randn(512, 1, 10).requires_grad_(),
                                    randn(512) + 1.0, randn(512))
        raise RuntimeError("check failed: B2 returned an output under grad")
    except RuntimeError as e:
        check("no backward" in str(e), f"B2 under grad raised {e}")
    print("[kernels] autograd: B1/B5/B6 CUDA outputs carry grad_fn; B2 raises under grad")
    del x, y, outs, q, k, v, gg, got, want, leaves

    # -- 4. encoder -------------------------------------------------------
    cfg = SpeechT5Config()
    model = st5.asr_init(cfg, seed=0, device=dev)
    batch, seconds = 16, 5.0
    lengths = [80000] * 12 + [72000, 56000, 40000, 17000]
    rng = np.random.default_rng(0)
    wav = np.zeros((batch, int(16000 * seconds)), np.float32)
    mask = np.zeros(wav.shape, np.int32)
    for i, n in enumerate(lengths):
        wav[i, :n] = rng.standard_normal(n).astype(np.float32) * 0.1
        mask[i, :n] = 1
    fa.flash_rel_forward.launches = cf.conv1_instance_norm_gelu.launches = 0
    hid, fmask = st5.encode_speech(model, wav, mask)
    torch.cuda.synchronize()
    per_forward = (fa.flash_rel_forward.launches, cf.conv1_instance_norm_gelu.launches)
    check(per_forward == (cfg.encoder_layers, 1),
          f"one forward launched B1 {per_forward[0]}x, B2 {per_forward[1]}x")
    phid, pmask = st5.encode_speech(model, wav, mask, use_kernels=False)
    valid = fmask.bool()
    check(torch.equal(fmask, pmask), "frame masks differ")
    check(tuple(hid.shape) == (batch, cfg.feat_extract_output_length(wav.shape[1]), 768),
          f"encoder output shape {tuple(hid.shape)}")
    check(bool(torch.isfinite(hid[valid]).all()), "non-finite embeddings")
    enc_max, enc_mean = encoder_error(hid, phid, fmask, "encoder")
    wav_t = torch.from_numpy(wav).to(dev)
    mask_t = torch.from_numpy(mask).to(dev)
    fwd_ms = time_ms(lambda: st5.encode_speech(model, wav_t, mask_t), reps=5, inner=2)
    plain_fwd_ms = time_ms(lambda: st5.encode_speech(model, wav_t, mask_t, use_kernels=False),
                           reps=5, inner=2)
    audio_s = sum(lengths) / 16000.0
    enc = dict(batch=batch, seconds=seconds, frames=hid.shape[1], max_abs=enc_max,
               mean_abs=enc_mean, launches_per_forward={"B1": per_forward[0], "B2": per_forward[1]},
               forward_ms=fwd_ms, plain_forward_ms=plain_fwd_ms,
               rtfx=audio_s / (fwd_ms / 1e3), card=smi)
    print(f"[encoder] {json.dumps(enc)}")
    prof = device_breakdown(lambda: st5.encode_speech(model, wav_t, mask_t))
    print(f"[encoder] device breakdown of one forward: {json.dumps(prof)}")
    del model, hid, phid

    # -- 5. pipeline (the main path through its user entry point) ---------
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "slurp")
        utt_lengths = write_slurp(root, 8, seed=1)
        out_dir = os.path.join(tmp, "emb")
        fa.flash_rel_forward.launches = cf.conv1_instance_norm_gelu.launches = 0
        t0 = time.perf_counter()
        rc = extract_embeddings.main(["-m", "audio", "-s", "train", "--data_path", root,
                                      "--out_dir", out_dir, "--batch_size", "4"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"B1": fa.flash_rel_forward.launches,
                    "B2": cf.conv1_instance_norm_gelu.launches}
        check(rc == 0, f"extract_embeddings returned {rc}")
        n_batches = -(-len(utt_lengths) // 4)
        check(launches == {"B1": cfg.encoder_layers * n_batches, "B2": n_batches},
              f"{n_batches} batches launched {launches}")
        store = EmbeddingStore(out_dir)
        check(len(store) == len(utt_lengths), f"{len(store)} records")
        for i, n in enumerate(utt_lengths):
            _, emb, _ = store[i]
            check(emb.shape == (cfg.feat_extract_output_length(n), 768),
                  f"record {i}: shape {emb.shape}")
            check(bool(np.isfinite(emb).all()), f"record {i}: non-finite")
        print(f"[pipeline] {json.dumps(dict(records=len(store), launches=launches, wall_s=wall, audio_s=sum(utt_lengths) / 16000.0))}")

    # -- 6. GPT-2 scoring -------------------------------------------------
    def b56_launches():
        return {"B5": fc.flash_forward.launches, "B6": fc.flash_forward_nhd.launches}

    def reset_b56():
        fc.flash_forward.launches = fc.flash_forward_nhd.launches = 0

    batch, seq = 8, 1024
    ids = torch.randint(0, 50257, (batch, seq), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    n_tokens = batch * seq
    for preset, kern in (("gpt2", "B6"), ("gpt2-xl", "B5")):
        cfg = gm.PRESETS[preset]
        lm = gm.gpt2_init(cfg, seed=0, device=dev)
        with torch.inference_mode():
            reset_b56()
            nll = gm.score_tokens(lm, ids, attn_impl="flash")
            torch.cuda.synchronize()
            per_forward = b56_launches()
            want = {"B5": 0, "B6": 0, kern: cfg.n_layer}
            check(per_forward == want, f"{preset}: one forward launched {per_forward}, "
                                       f"expected {want}")
            nll_dense = gm.score_tokens(lm, ids, attn_impl="dense")
            check(tuple(nll.shape) == (batch, seq - 1), f"{preset}: NLL shape {tuple(nll.shape)}")
            check(bool(torch.isfinite(nll).all() and torch.isfinite(nll_dense).all()),
                  f"{preset}: non-finite NLL")
            nll_err = (nll - nll_dense).abs().max().item()
            check(nll_err <= NLL_TOL, f"{preset}: flash vs dense NLL max abs {nll_err}")
            reps = 5 if preset == "gpt2" else 3
            fwd_ms = time_ms(lambda: gm.score_tokens(lm, ids, attn_impl="flash"),
                             reps=reps, inner=1)
            dense_ms = time_ms(lambda: gm.score_tokens(lm, ids, attn_impl="dense"),
                               reps=reps, inner=1)
            rec = dict(model=preset, n_embd=cfg.n_embd, n_layer=cfg.n_layer,
                       n_head=cfg.n_head, vocab=cfg.vocab_size, batch=batch, seq=seq,
                       launches_per_forward=per_forward, nll_max_abs=nll_err,
                       mean_nll=nll.mean().item(), forward_ms=fwd_ms,
                       tokens_per_s=n_tokens / (fwd_ms / 1e3), dense_forward_ms=dense_ms,
                       dense_tokens_per_s=n_tokens / (dense_ms / 1e3), card=smi)
            print(f"[gpt2] {json.dumps(rec)}")
            if preset == "gpt2":
                prof = device_breakdown(lambda: gm.score_tokens(lm, ids, attn_impl="flash"))
                print(f"[gpt2] device breakdown of one flash scoring forward: {json.dumps(prof)}")
                # a right-padded batch under flash runs kernel B1 (causal,
                # valid-key counts) in every layer
                lens = torch.tensor([seq] * 6 + [700, 301], device=dev)
                mask = (torch.arange(seq, device=dev)[None, :] < lens[:, None]).int()
                fa.flash_rel_forward.launches = 0
                pad_flash = gm.score_tokens(lm, ids, attention_mask=mask, attn_impl="flash")
                check(fa.flash_rel_forward.launches == cfg.n_layer,
                      f"padded gpt2 forward launched B1 {fa.flash_rel_forward.launches}x")
                pad_dense = gm.score_tokens(lm, ids, attention_mask=mask)
                scored = mask[:, 1:].bool()
                pad_err = (pad_flash - pad_dense).abs()[scored].max().item()
                check(pad_err <= NLL_TOL, f"padded gpt2: flash vs dense NLL max abs {pad_err}")
                print(f"[gpt2] {json.dumps(dict(padded_rows=[700, 301], b1_launches=cfg.n_layer, nll_max_abs=pad_err))}")
        del lm, nll, nll_dense

    # -- 7. LM-scoring pipeline (the B5/B6 main path) ---------------------
    dev_text = os.path.join(ROOT, "exp", "loco", "lm_corpus", "dev.txt")
    n_recs = len({u.split("-")[0] for u in lm_datasets.load_key_text(dev_text)})
    n_utts = len(lm_datasets.load_key_text(dev_text))

    def run_eval_ppl(tmp, tag, *flags):
        out = os.path.join(tmp, tag)
        reset_b56()
        t0 = time.perf_counter()
        rc = eval_ppl.main(["-i", dev_text, "-o", out, *flags])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(rc == 0, f"eval_ppl {tag} returned {rc}")
        with open(os.path.join(out, "rec_id2ppl.json")) as f:
            ppl = json.load(f)
        check(len(ppl) == n_recs and all(np.isfinite(list(ppl.values()))),
              f"eval_ppl {tag}: {len(ppl)} recordings or non-finite PPL")
        rec = dict(run=tag, launches=b56_launches(), wall_s=wall, recordings=len(ppl),
                   mean_ppl=float(np.mean(list(ppl.values()))))
        print(f"[lm_pipeline] {json.dumps(rec)}")
        return rec, ppl

    max_len_flags = ["--model", "gpt2", "--context_type", "max_len", "--bsize", "8"]
    n_windows = -(-n_recs // 8)   # every recording is shorter than 1024 tokens
    with tempfile.TemporaryDirectory() as tmp:
        flash_run, flash_ppl = run_eval_ppl(tmp, "gpt2_max_len_flash", *max_len_flags,
                                            "--attn_impl", "flash")
        lm_launches = dict(flash_run["launches"])
        check(lm_launches == {"B5": 0, "B6": 12 * n_windows},
              f"gpt2 max_len flash run launched {lm_launches}")
        dense_run, dense_ppl = run_eval_ppl(tmp, "gpt2_max_len_dense", *max_len_flags,
                                            "--attn_impl", "dense")
        check(dense_run["launches"] == {"B5": 0, "B6": 0},
              f"dense run launched {dense_run['launches']}")
        check(list(flash_ppl) == list(dense_ppl), "flash and dense recordings differ")
        ppl_rel = max(abs(flash_ppl[r] - dense_ppl[r]) / dense_ppl[r] for r in dense_ppl)
        check(ppl_rel <= PPL_RTOL, f"flash vs dense PPL rel diff {ppl_rel}")
        print(f"[lm_pipeline] {json.dumps(dict(ppl_max_rel_diff=ppl_rel, rtol=PPL_RTOL))}")
        indep_run, _ = run_eval_ppl(tmp, "gpt2_indep_flash", "--model", "gpt2",
                                    "--context_type", "indep", "--bsize", "128",
                                    "--attn_impl", "flash")
        check(indep_run["launches"] == {"B5": 0, "B6": 12 * -(-n_utts // 128)},
              f"indep run launched {indep_run['launches']}")
        xl_run, _ = run_eval_ppl(tmp, "gpt2xl_max_len_flash", "--model", "gpt2-xl",
                                 "--context_type", "max_len", "--bsize", "8",
                                 "--attn_impl", "flash")
        xl_layers = gm.PRESETS["gpt2-xl"].n_layer
        check(xl_run["launches"] == {"B5": xl_layers * n_windows, "B6": 0},
              f"gpt2-xl max_len flash run launched {xl_run['launches']}")
        lm_launches["B5"] = xl_run["launches"]["B5"]

    # -- 8. ASR train step: kernels + flash against plain + dense -----------
    def counts():
        return {"B1": fa.flash_rel_forward.launches, "B2": cf.conv1_instance_norm_gelu.launches,
                "B3/B4": fa.flash_rel_backward.launches, "B5": fc.flash_forward.launches,
                "B5_bwd": fc.flash_backward.launches}

    def reset_counts():
        fa.flash_rel_forward.launches = cf.conv1_instance_norm_gelu.launches = 0
        fa.flash_rel_backward.launches = fc.flash_forward.launches = 0
        fc.flash_backward.launches = 0

    tok = load_tokenizer("char")
    tok.vocab_size = 256
    cfg = SpeechT5Config(vocab_size=256)
    train_ds = ConversationAsrDataset(corpus["train"], window_seconds=10)
    host_batches = list(itertools.islice(itertools.chain.from_iterable(
        train_ds.batches(tok, 8, max_seconds=10, max_label_len=160, shuffle=True,
                         seed=e, eos_id=cfg.eos_token_id) for e in range(3)), 31))

    def to_dev(hb):
        return {k: torch.as_tensor(hb[k], device=dev)
                for k in ("input_values", "attention_mask", "labels")}

    quiet = dataclasses.replace(cfg, positional_dropout=0.0, hidden_dropout=0.0,
                                attention_dropout=0.0, activation_dropout=0.0,
                                apply_spec_augment=False)
    model = st5.asr_model_init(quiet, seed=0, device=dev).train()
    b0 = to_dev(host_batches[0])
    runs = {}
    for impl in ("flash", "dense"):
        for p in model.parameters():
            p.grad = None
        reset_counts()
        loss, aux = st5.asr_loss(model, b0["input_values"], b0["attention_mask"],
                                 b0["labels"], attn_impl=impl)
        loss.backward()
        torch.cuda.synchronize()
        grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
        runs[impl] = (loss.item(), train.global_norm(list(grads.values())).item(), grads,
                      counts())
    (fl, fg, fgr, fcnt), (dl, dg, dgr, dcnt) = runs["flash"], runs["dense"]
    check(np.isfinite(fl) and np.isfinite(fg), f"train step: loss {fl}, grad_norm {fg}")
    check(abs(fl - dl) <= LOSS_RTOL * abs(dl), f"train step: loss flash {fl} dense {dl}")
    check(abs(fg - dg) <= GNORM_RTOL * abs(dg), f"train step: grad_norm flash {fg} dense {dg}")
    worst, worst_name, grad_max_abs = grads_against(fgr, dgr, "train step")
    check(dcnt == {"B1": 0, "B2": 0, "B3/B4": 0, "B5": 0, "B5_bwd": 0},
          f"dense train pass launched {dcnt}")
    del runs, fgr, dgr
    step_counts = {}
    for frozen in (False, True):
        tx = train.adamw(1e-4)
        opt = tx.init(train.trainable_params(model, frozen))
        step = train.make_asr_train_step(quiet, tx, attn_impl="flash",
                                         freeze_feature_encoder=frozen)
        reset_counts()
        m = step(model, opt, b0)
        torch.cuda.synchronize()
        step_counts["frozen" if frozen else "trained"] = counts()
        check(np.isfinite(m["loss"].item()), "train step: non-finite loss")
        del opt
    n_enc, n_dec = cfg.encoder_layers, cfg.decoder_layers
    want = {"B1": n_enc + n_dec, "B2": 0, "B3/B4": n_enc + n_dec, "B5": n_dec, "B5_bwd": n_dec}
    check(step_counts["trained"] == want, f"train step launched {step_counts['trained']}, "
                                          f"expected {want}")
    check(step_counts["frozen"] == dict(want, B2=1),
          f"frozen-feature-encoder step launched {step_counts['frozen']}")
    step_rec = dict(batch=list(b0["input_values"].shape), labels=list(b0["labels"].shape),
                    loss_flash=fl, loss_dense=dl, grad_norm_flash=fg, grad_norm_dense=dg,
                    grad_max_abs_diff=grad_max_abs, grad_worst_excess=worst,
                    grad_worst=worst_name, launches_loss_backward=fcnt,
                    launches_per_step=step_counts)
    print(f"[train_step] {json.dumps(step_rec)}")
    del model

    # -- 9. training throughput ------------------------------------------
    model = st5.asr_model_init(cfg, seed=0, device=dev)
    tx = train.adamw(1e-4)                      # constant rate, no warmup
    opt = tx.init(train.trainable_params(model))
    step = train.make_asr_train_step(cfg, tx, attn_impl="flash")
    gen = torch.Generator(device=dev).manual_seed(0)
    dev_batches = [to_dev(hb) for hb in host_batches[1:]]
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, audio_s = [], [], 0.0
    for i, bt in enumerate(dev_batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(model, opt, bt, gen)
        losses.append(m["loss"].item())           # syncs
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i >= 3:
            audio_s += bt["attention_mask"].sum().item() / 16000.0
    check(all(np.isfinite(losses)), f"training losses {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last < first, f"loss did not fall: first 5 {first}, last 5 {last}")
    timed = step_ms[3:]
    tput = dict(steps=len(losses), batch=8, window_s=10, losses=losses,
                loss_first5=first, loss_last5=last, median_step_ms=statistics.median(timed),
                audio_s_per_wall_s=audio_s / (sum(timed) / 1e3),
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, card=smi)
    print(f"[train] {json.dumps(tput)}")
    prof = device_breakdown(lambda: step(model, opt, dev_batches[0], gen))
    print(f"[train] device breakdown of one step: {json.dumps(prof)}")
    del model, opt, dev_batches

    # -- 10. ASR training pipeline (the B3/B4 main path) --------------------
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "asr")
        flags = ["--train_dir", corpus["train"], "--dev_dir", corpus["dev"],
                 "--out_dir", out_dir, "--attn_impl", "flash",
                 "--conversation_seconds", "10", "--batch_size", "8",
                 "--save_every", "4", "--eval_every", "8", "--eval_batches", "2"]
        reset_counts()
        t0 = time.perf_counter()
        rc = train_asr.main([*flags, "--steps", "8"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        asr_launches = counts()
        check(rc == 0, f"train_asr returned {rc}")
        ckpt = os.path.join(out_dir, "ckpt")
        with open(os.path.join(ckpt, "status.json")) as f:
            check(json.load(f)["latest"] == 8, "status.json does not name step 8")
        check(all(os.path.exists(os.path.join(ckpt, f"step_{n}.npz")) for n in (4, 8)),
              "missing step_4.npz / step_8.npz")
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            evals = [json.loads(line) for line in f if "dev_wer" in line]
        check(evals and all(np.isfinite(r["dev_loss"]) and np.isfinite(r["dev_wer"])
                            for r in evals), f"dev metrics {evals}")
        check(asr_launches["B3/B4"] == 8 * (n_enc + n_dec) and asr_launches["B5_bwd"] == 8 * n_dec,
              f"8 training steps launched {asr_launches}")
        check(asr_launches["B1"] > asr_launches["B3/B4"] and asr_launches["B2"] > 0,
              f"pipeline launches {asr_launches}")
        t0 = time.perf_counter()
        rc = train_asr.main([*flags, "--steps", "12", "--resume"])
        resume_wall = time.perf_counter() - t0
        check(rc == 0, f"train_asr --resume returned {rc}")
        with open(os.path.join(ckpt, "status.json")) as f:
            check(json.load(f)["latest"] == 12, "resume did not reach step 12")
        with np.load(os.path.join(ckpt, "step_12.npz")) as z:
            check(int(z["opt_state.count"]) == 12, "optimizer count after resume")
        print(f"[asr_pipeline] {json.dumps(dict(launches=asr_launches, wall_s=wall, dev=evals[-1], resume_wall_s=resume_wall))}")
    # -- 11. TTS / voice conversion (the B7 main path) ------------------------
    cfg = SpeechT5Config(vocab_size=256)
    tts = st5.tts_init(cfg, seed=0, device=dev)
    s2s = st5.s2s_init(cfg, seed=1, device=dev)
    voc = vocoder.hifigan_init(vocoder.HifiGanConfig(), seed=2, device=dev)
    tok = load_tokenizer("char")
    tok.vocab_size = 256

    def text_batch(texts):
        ids = [tok.encode(t) + [cfg.eos_token_id] for t in texts]
        out = np.full((len(ids), max(map(len, ids))), cfg.pad_token_id, np.int64)
        for i, row in enumerate(ids):
            out[i, :len(row)] = row
        ids = torch.from_numpy(out).to(dev)
        return ids, (ids != cfg.pad_token_id).to(torch.int32)

    ids, text_mask = text_batch(win_texts)
    wav = torch.from_numpy(win_wav).to(dev)
    wav_mask = (torch.arange(wav.shape[1], device=dev)[None, :]
                < torch.tensor(win_lengths, device=dev)[:, None]).to(torch.int32)
    spk = torch.randn(8, cfg.speaker_embedding_dim, generator=g).to(dev)

    def b7_b1_b2():
        return {"B7": logmel.fused_log_mel.launches, "B1": fa.flash_rel_forward.launches,
                "B2": cf.conv1_instance_norm_gelu.launches, "B5": fc.flash_forward.launches,
                "B6": fc.flash_forward_nhd.launches}

    def teacher_forced(use_kernels):
        log_mel = logmel.fused_log_mel if use_kernels else logmel.fused_log_mel_plain
        dec_in = st5.shift_spectrograms_right(log_mel(wav), cfg.reduction_factor)
        t_out = st5.tts_forward(tts, ids, dec_in, spk, text_mask)
        v_out = st5.s2s_forward(s2s, wav, dec_in, spk, wav_mask, use_kernels=use_kernels)
        return dec_in, t_out, v_out

    with torch.inference_mode():
        reset_counts()
        logmel.fused_log_mel.launches = fc.flash_forward_nhd.launches = 0
        dec_in, t_out, v_out = teacher_forced(True)
        torch.cuda.synchronize()
        tf_launches = b7_b1_b2()
        want = {"B7": 1, "B1": cfg.encoder_layers, "B2": 1, "B5": 0, "B6": 0}
        check(tf_launches == want, f"teacher-forced TTS + VC launched {tf_launches}, expected {want}")
        _, pt_out, pv_out = teacher_forced(False)
        frames = 2 * dec_in.shape[1]
        tf_err = {}
        for tag, got, ref in (("tts", t_out, pt_out), ("s2s", v_out, pv_out)):
            check(tuple(got[1].shape) == (8, frames, 80) and tuple(got[2].shape) == (8, frames),
                  f"{tag}: mel {tuple(got[1].shape)}, stop {tuple(got[2].shape)}")
            check(all(bool(torch.isfinite(x).all()) for x in got), f"{tag}: non-finite output")
            tf_err[tag] = max((got[1] - ref[1]).abs().max().item(),
                              (got[2] - ref[2]).abs().max().item())
            check(tf_err[tag] <= TTS_TOL, f"{tag}: kernel vs plain path max abs {tf_err[tag]}")
        tts_ms = time_ms(lambda: st5.tts_forward(tts, ids, dec_in, spk, text_mask), reps=5, inner=2)
        s2s_ms = time_ms(lambda: st5.s2s_forward(s2s, wav, dec_in, spk, wav_mask), reps=5, inner=2)
        s2s_plain_ms = time_ms(lambda: st5.s2s_forward(s2s, wav, dec_in, spk, wav_mask,
                                                       use_kernels=False), reps=5, inner=2)
        rec = dict(batch=list(wav.shape), text=list(ids.shape), decoder_frames=dec_in.shape[1],
                   mel_frames=frames, launches=tf_launches, max_abs=tf_err, tol=TTS_TOL,
                   tts_forward_ms=tts_ms, s2s_forward_ms=s2s_ms, s2s_plain_forward_ms=s2s_plain_ms,
                   card=smi)
        print(f"[tts] teacher-forced {json.dumps(rec)}")
        del t_out, v_out, pt_out, pv_out

        # (b) synthesis: ~100-character transcripts, a fixed number of steps
        syn_ids, syn_mask = text_batch([t[:100] for t in win_texts[:4]])
        r = cfg.reduction_factor
        st5.tts_generate(tts, syn_ids, spk[:4], syn_mask, minlenratio=0.5, maxlenratio=0.5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mel, lens = st5.tts_generate(tts, syn_ids, spk[:4], syn_mask, minlenratio=4.0,
                                     maxlenratio=4.0)
        torch.cuda.synchronize()
        gen_ms = (time.perf_counter() - t0) * 1e3
        steps = int(syn_ids.shape[1] * 4.0 / r)
        check(tuple(mel.shape) == (4, steps * r, 80) and bool((lens == steps * r).all()),
              f"synthesis: mel {tuple(mel.shape)}, lengths {lens.tolist()}")
        check(bool(torch.isfinite(mel).all()), "synthesis: non-finite mel")
        vocoder.hifigan(voc, mel)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        audio = vocoder.hifigan(voc, mel)
        torch.cuda.synchronize()
        voc_ms = (time.perf_counter() - t0) * 1e3
        check(tuple(audio.shape) == (4, steps * r * 256), f"vocoder output {tuple(audio.shape)}")
        check(bool(torch.isfinite(audio).all()) and audio.abs().max().item() <= 1.0,
              "vocoder: non-finite or out-of-range samples")
        audio_s = audio.numel() / 16000.0
        mel_d, lens_d = st5.tts_generate(tts, syn_ids, spk[:4], syn_mask)
        maxlen = int(syn_ids.shape[1] * 20.0 / r)
        check(bool((lens_d % r == 0).all() and (lens_d >= r).all() and (lens_d <= maxlen * r).all())
              and mel_d.shape[1] == maxlen * r,
              f"default-threshold lengths {lens_d.tolist()} (maxlen {maxlen})")
        rec = dict(batch=4, text=list(syn_ids.shape), steps=steps, mel=list(mel.shape),
                   waveform=list(audio.shape), generate_ms=gen_ms, ms_per_step=gen_ms / steps,
                   vocoder_ms=voc_ms, audio_s=audio_s,
                   synthesis_rtfx=audio_s / ((gen_ms + voc_ms) / 1e3),
                   default_threshold_lengths=lens_d.tolist(), card=smi)
        print(f"[tts] synthesis {json.dumps(rec)}")
        prof = device_breakdown(lambda: vocoder.hifigan(voc, st5.tts_generate(
            tts, syn_ids, spk[:4], syn_mask, minlenratio=0.5, maxlenratio=0.5)[0]))
        print(f"[tts] device breakdown of a {int(syn_ids.shape[1] * 0.5 / r)}-step synthesis "
              f"+ vocoder: {json.dumps(prof)}")
        del mel, audio, mel_d

        # (c) copy synthesis of the corpus windows through B7 and the vocoder
        logmel.fused_log_mel.launches = 0
        copy = vocoder.hifigan(voc, logmel.fused_log_mel(wav))
        torch.cuda.synchronize()
        copy_b7 = logmel.fused_log_mel.launches
        check(copy_b7 == 1, f"copy synthesis launched B7 {copy_b7}x")
        n_frames = 1 + wav.shape[1] // 256
        check(tuple(copy.shape) == (8, 256 * n_frames) and bool(torch.isfinite(copy).all()),
              f"copy synthesis: {tuple(copy.shape)} or non-finite")
        print(f"[tts] copy synthesis {json.dumps(dict(waveform=list(copy.shape), b7_launches=copy_b7))}")
        b7_launches = tf_launches["B7"] + copy_b7
        del copy, tts, s2s, voc

    # -- 12. ASR decoding with GPT-2 fusion and carry-over ------------------
    decode_launches = decode_phase(corpus, win_wav, win_lengths, smi, dev)
    tmp_corpus.cleanup()

    # -- 13. LM training at gpt2 width, the LoCo experiment ------------------
    lm_train_launches = lm_training_phase(smi, dev)

    # -- 14. SLURP intent classification at full width -----------------------
    intent_launches = intent_phase(smi, dev)

    # -- 15. the LoCo decodes on the reference's trained weights -------------
    reference_launches = loco_reference_phase(smi, dev)

    # -- 16. summary -------------------------------------------------------
    def entry(name, source, replaces, tpu_kernel, kernel, case, n):
        main_rec = next(c for c in checks if c["kernel"] == kernel and c["case"] == case)
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    tpu_kernel=tpu_kernel, launches=n,
                    max_abs_err=max(c["max_abs_err"] for c in checks if c["kernel"] == kernel),
                    ms=main_rec["ms"], kernel_ms=main_rec["ms"], plain_ms=main_rec["plain_ms"],
                    device_ms=main_rec.get("device_ms"),
                    bound_ms=main_rec["bound_ms"], bound_by=main_rec["bound_by"],
                    library_ms=main_rec["library_ms"],
                    partial_library_ms=main_rec.get("partial_library_ms"))

    def bwd_entry(name, replaces, tpu_kernel, which):
        """B3 or B4 at the encoder's padded case: its own device time; the
        plain column is the whole plain backward (one function computes dq,
        dk, dv and dpe together).  No PyTorch call computes the rel-band
        backward, so the library column is null here; the mask-only and
        causal cases above carry SDPA's."""
        main_rec = next(c for c in checks if c["kernel"] == "B3/B4" and c["case"] == "enc_padded")
        bms, by = main_rec[f"{which}_bound"]
        return dict(name=name, route="cuda", source="loco_asr_tpu_torch/csrc/flash_rel_bwd.cu",
                    replaces=replaces, tpu_kernel=tpu_kernel, launches=asr_launches["B3/B4"],
                    max_abs_err=max(c["max_abs_err"] for c in checks if c["kernel"] == "B3/B4"),
                    ms=main_rec[f"{which}_ms"], kernel_ms=main_rec[f"{which}_ms"],
                    wrapper_ms=main_rec["ms"], plain_ms=main_rec["plain_ms"],
                    bound_ms=bms, bound_by=by, library_ms=main_rec["library_ms"])

    # B1's and B2's launches on the decode path: phase 12's six decode_asr
    # runs, phase 13's LoCo ASR stage and phase 15's decodes on the
    # reference weights; on the intent slice's audio extraction (phase 14);
    # B1's time at head dim 8 (the LoCo encoder's) beside the main case's
    d8 = next(c for c in checks if c["case"] == "loco_d8")
    kernels = [
        dict(entry("flash_rel_forward", "loco_asr_tpu_torch/csrc/flash_rel.cu",
                   "loco_asr_tpu/ops/pallas/flash_attention.py:518",
                   "flash_attention.py::_flash_rel_kernel", "B1", "rel_padded", launches["B1"]),
             decode_launches=decode_launches["B1"],
             loco_launches=lm_train_launches["loco_asr"]["B1"],
             loco_reference_launches=reference_launches["B1"],
             intent_launches=intent_launches["B1"],
             d8_ms=d8["ms"], d8_device_ms=d8["device_ms"], d8_plain_ms=d8["plain_ms"],
             d8_bound_ms=d8["bound_ms"]),
        dict(entry("conv1_instance_norm_gelu", "loco_asr_tpu_torch/csrc/conv_frontend.cu",
                   "loco_asr_tpu/ops/pallas/conv_frontend.py:56",
                   "conv_frontend.py::_kernel", "B2", "main", launches["B2"]),
             decode_launches=decode_launches["B2"],
             loco_launches=lm_train_launches["loco_asr"]["B2"],
             loco_reference_launches=reference_launches["B2"],
             intent_launches=intent_launches["B2"]),
        entry("flash_forward", "loco_asr_tpu_torch/csrc/flash_causal.cu",
              "loco_asr_tpu/ops/pallas/flash_attention.py:40",
              "flash_attention.py::_flash_kernel", "B5", "gpt2xl", lm_launches["B5"]),
        bwd_entry("flash_rel_backward (B3)", "loco_asr_tpu/ops/pallas/flash_attention.py:799",
                  "flash_attention.py::_rel_bwd_dq_kernel", "b3"),
        bwd_entry("flash_rel_backward (B4)", "loco_asr_tpu/ops/pallas/flash_attention.py:902",
                  "flash_attention.py::_rel_bwd_dkv_kernel", "b4"),
        dict(entry("flash_forward_nhd", "loco_asr_tpu_torch/csrc/flash_causal.cu",
                   "loco_asr_tpu/ops/pallas/flash_attention.py:168",
                   "flash_attention.py::_flash_pair_kernel", "B6", "gpt2_max_len",
                   lm_launches["B6"]),
             train_step_launches=lm_train_launches["train_step"]["B6"],
             train_lm_launches=lm_train_launches["train_lm"]["B6"],
             train_lm_backward_calls=lm_train_launches["train_lm"]["B6_bwd"]),
        entry("fused_log_mel", "loco_asr_tpu_torch/csrc/logmel.cu",
              "loco_asr_tpu/ops/pallas/logmel.py:40",
              "logmel.py::_logmel_kernel", "B7", "corpus_10s", b7_launches),
    ]
    print(f"[summary] card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def kernel_cases_main() -> int:
    """``--kernel-cases``: the build, then phase 3's B2 and B7 cases alone
    (:func:`b2_case_checks`, :func:`b7_case_checks`) with the
    ``loco_asr_tpu_torch`` beside this file.  A copy of this file placed at
    the root of another checkout runs that checkout's B2 and B7 through the
    same cases and inputs (their wrappers' signatures are unchanged)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from loco_asr_tpu_torch.ops.cuda import _build
    from loco_asr_tpu_torch.ops.cuda import conv_frontend as cf
    from loco_asr_tpu_torch.ops.cuda import logmel

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] nvidia-smi: {smi}; kernels of {os.path.relpath(cf.__file__)}")
    _build.build()
    _build.library()
    with tempfile.TemporaryDirectory() as tmp:
        win_wav = corpus_windows(relocate_corpus(tmp)["train"], 8)[0]
    warm_up(torch.device("cuda"))
    recs = b2_case_checks(cf, smi) + b7_case_checks(logmel, win_wav, smi)
    for rec in recs:
        print(f"[kernels] {json.dumps(rec)}")
    print(json.dumps({"kernel_cases": recs}))
    return 0


if __name__ == "__main__":
    sys.exit(kernel_cases_main() if sys.argv[1:] == ["--kernel-cases"] else main())
