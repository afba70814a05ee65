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
on the reference's trained weights), SLURP intent classification
(``extract_embeddings`` -> ``train_classifier`` -> ``slurp_sweep``),
conversation-scale ASR training (``train_asr --conversation_seconds 164
--attn_impl flash --remat lite``), long-form episode transcription
(``transcribe_episodes``), the trainers' Adafactor, NaN recovery and
HF-weight options, and Fisher corpus ingest (shorten-coded SPHERE through
``fisher_prep`` and its ``sph_decode`` pipes into ``train_asr``,
``decode_asr`` and ``eval_ppl``) with the generic feature encoder.
Phases, in order (any failure raises and exits non-zero):

1. environment: card name and power limit, torch / CUDA versions, TF32
   flags (both set False: every comparison here is float32);
2. build: nvcc for sm_90a, build seconds and ptxas register/smem lines;
   for B1's twenty kernels (sixteen mma.sync: f32 at head dims 8-128 and
   bf16 at 8-32; four wgmma: bf16 at 64 and 128) and B3's and B4's forty
   (thirty-two mma.sync, eight wgmma, as B1's; rel band and mask-only),
   their block shapes, registers, spill, shared memory at L=160 (and at
   L=512: the wgmma forms' the same) and blocks per SM (the wgmma ones
   with their threads and stages from their launch plan); the same for B2's two
   kernels and B7's warp kernels, with their static SASS counts where
   cuobjdump exists, and for B5/B6's two wgmma kernels (bf16 at head dims
   64 and 128: threads, K/V stages and shared memory from their launch
   plan);
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
   and ``beam_search`` (K = 5, 100 steps) of the 8 corpus windows, kernel
   path against plain path: launch counts of one encode + decode (12 B1,
   1 B2, none else), encoder outputs within 1e-3 (max) and 1e-4 (mean),
   greedy tokens equal, each beam row's step-by-step choices equal with
   scores within 1e-4 (atol + rtol) or parting at a near-tie (the two
   candidates within 1e-3 of each other in the plain path's own scores,
   and within 1e-3 between the paths; listed), ms per step and RTFx, the
   device time by kernel group and busy share of 25-step greedy and beam
   windows, peak memory; the first 6 of one dev recording's 10 utterances
   through ``ConversationContext`` (``max_positions=256``, two or more
   refreshes), kernel path against plain path; (b) ``encode_speech`` of
   dev utterances at the pipeline's batch shapes ([8, 16000] and the
   batcher's admission buckets [4 | 2 | 1, 16000]), kernel path against
   plain path within 1e-3 (max) and 1e-4 (mean); ``decode_asr`` on the
   dev corpus's first batch (``--limit_batches 1``: 8 of its 120
   utterances of <= 1 s, ``--max_seconds 1`` so that static batches and
   the batcher pad alike) with a seeded gpt2-width LM ``.npz``, in six
   modes (static greedy and beam 5, ``--continuous`` greedy and beam 5,
   ``--continuous --conversation`` greedy and beam 5): 8 hyp.text lines,
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
   --skip_training --fusion_weights 1.0``) on copies of the committed orbax
   steps ``exp/loco/{asr,asr_lm}/ckpt`` (read by the port's own orbax
   reader), the reference's trained weights: 2 B1 (head dim 8) and 1 B2 (64
   channels) an encode and nothing else, the ``nofusion``, ``carry``,
   ``nocarry`` and ``oracle`` entries of ``exp/loco/results.json`` to
   every digit, wall seconds; then the same decodes through the plain
   versions on the card: the same entries, and no hypothesis parting
   from the kernel path's;
16. mixed precision, the bf16 forms of B1-B6: (a) each at the f32
   cases' shapes (B1 ``rel_padded``, mask-only and ``vl0`` at
   [16, 12, 249, 64], L = 160, and mask-only at the decoder's
   cross-attention [8, 12, 160, 64] over 500 keys, each with its f32 form,
   plain version and SDPA beside; also causal, at [16, 6, 249, 128] and
   at L = 512 ([2, 12 | 6, 600, 64 | 128], past the 272 / 242 that B3's
   former table allowed; B3/B4 held there too); B3/B4 at
   [8, 12, 500, 64], L = 160, and mask-only at [8, 12, 160, 64] over 500
   keys; B5 at [8, 25, 1024, 64] causal; B6 on
   [8, 1024, 12, 64] qkv views; B2 at [16, 80000]) against its plain
   version (max |d| <= 2^-7 max |plain|, lse within 1e-3) and, with it,
   against a float64 evaluation on the same bf16 inputs (the kernel's
   error at most twice the plain version's); CUDA-event and device ms
   beside the f32 form's, the bound (bytes over 3.35 TB/s or products
   over 989 TFLOP/s in one pass), SDPA in bf16 (B5, B6, mask-only B1; its
   backward beside B3/B4); B1, B3/B4, B5 and B6 run their wgmma form
   (``form``, one launch of it counted a B1 and a B3/B4 case);
   (b) the full-width ASR step under
   ``compute_dtype=bfloat16`` with the feature encoder frozen: kernels +
   flash against plain + dense in bf16 (loss rtol 1e-2), the inputs of
   each kernel form it launches (B1 with the band and mask-only, their
   B3/B4, B5, B2) captured and replayed against the plain versions by
   the same checks as (a), every parameter's gradient within twice the
   plain + dense bf16 step's distance from the f32 step's, against the
   f32 step under the JAX test's contract (loss rtol 5e-2, grad norm
   15 %), launches by form (18 B1, 18 B3/B4, 6 B5, 1 B2, all bf16; the
   18 B1, 18 B3/B4 and 6 B5 all of the wgmma form; each replay names its form), 10
   steps' median ms, audio-s/s, busy share, kernels a step, the slowest
   kernels, the casts' host ms and peak memory beside the f32 step's;
   ``train_asr --compute_dtype bfloat16 --freeze_feature_encoder
   --opt_mu_dtype bfloat16`` for 8 steps and ``--resume`` to 12, which
   reads back a bf16 first moment; (c) the gpt2-width LM step in bf16
   (12 bf16 B6 launches, all of the wgmma form, each captured and held
   as in (b); loss against f32 within 5e-2, ms and tokens/s),
   ``train_lm`` with both flags for 10 steps (120 wgmma B6), ``eval_ppl
   --compute_dtype bfloat16`` on its checkpoint against f32 (mean |d NLL|
   < 5e-2; every B6 of the wgmma form); (d) ``extract_embeddings -m audio --dtype bfloat16`` on 8
   seeded SLURP wavs, B1 and B2 in their f32 forms (JAX's promotion),
   the card against a CPU run of the same command (1e-3 max, 1e-4 mean);
17. conversation-scale ASR training: (a) B3/B4 at head dims 8 ([8, 4,
   398, 8], L = 20), 16 and 32 ([8, 8, 500, D], L = 160), 128 ([8, 6, 500,
   128], L = 160) and 12 (padded to 16; [8, 4, 398, 12], L = 20), f32 and
   bf16, rel band and mask-only, two rows padded, each against its plain
   version (f32 within 1e-4, dpe relative; bf16 as phase 16), each in
   the form ``kernel_form`` gives it (bf16 at 128: wgmma; one launch of
   that form counted), with each kernel's device time, the wrapper's and
   the plain version's, SDPA's backward beside the mask-only cases, the
   bounds, registers and spill;
   (b) head dim 8: one step at the LoCo ASR widths (``train_asr --tiny``
   with the experiment's conv front end, 4 s windows), kernels + flash
   against plain + dense (phase 8's limits), launches by head dim (4 B1,
   4 B3/B4, 2 B5 at D = 8); ``train_asr --tiny --attn_impl flash`` and
   the same with the LoCo conv overrides, 3 steps each (12 B3/B4 at
   D = 8); ``decode_asr --tiny`` (head dim 12, B1 padded to 16) on the
   dev corpus, and the tiny encoder kernel vs plain path; (c) the
   full-width step at B = 1 x 164 s of seeded audio (2,624,000 samples,
   8,199 frames) and 2,048 seeded labels, flash, dropout and SpecAugment
   on: each remat policy's loss and gradients against ``none``'s (loss
   rtol 1e-6, gradients rtol 1e-5 + atol 1e-6, the JAX test's; with
   cuDNN's deterministic algorithms, and the spread of two ``none``
   steps measured with and without them), the live generator where
   ``none`` leaves it; the gpt2-width LM step ([8, 1024], dropout on)
   under ``full`` and ``lite`` against ``none`` (B6 24 and 12 times a
   step, 12 blockwise backward calls); dropout
   off under ``full``, kernels + flash against plain + dense at the
   longest window that fits (164 s first; phase 8's limits); dropout off,
   the bf16 step under ``none`` (B1 and B3/B4 in their wgmma forms at
   conversation length: 18 each) against the f32 step on the same
   weights (loss rtol 5e-2), with its ms and peak memory; per policy
   the launches (B1 30 under full/dots/hybrid, 18 under none/lite; 18
   B3/B4; 6 B5), the median ms of 2 steps taken in two turns (none ..
   lite, lite .. none), audio-s/s, peak memory, busy share and device
   time by kernel group; (d) ``train_asr
   --conversation_seconds 164 --attn_impl flash --remat lite
   --batch_size 1`` for 6 steps, then ``--resume`` to 8, on a Kaldi
   directory of the committed train utterances concatenated into
   recording-channels of >= 200 s: finite losses, windows of <= 164 s,
   labels up to 2,624, its launches (no B1 recompute under lite);
18. long-form episodes and the rest of the trainer options: (a)
   ``transcribe_episodes --vocab_size 50257 --lm_model gpt2 --attn_impl
   flash --batch_seconds 120 --max_decode_len 340`` at SpeechT5-base +
   gpt2 width (random weights from seed 0) on two seeded WAV episodes
   (noise bursts between silences): one with manifest timestamps and
   texts, three bursts of 122-130 s (each cropped to 120 s), one left to
   the energy endpointer (9.3 s, padded to 10 s).  Per episode: 12 B1 and 1 B2 a segment and nothing
   else, one cross-attention projection a segment, two or more refreshes
   of the conversation cache (its re-primings counted), RTFx; every greedy
   step's two best fused candidates traced, and the kernel path's tokens
   held to the plain path's on the manifest episode's first two segments
   (``use_kernels=False`` through ``transcribe_long_audio``, its decoder K
   projections counted) by phase 12's near-tie rule.  ``--continuous --slots 4`` greedy: B1/B2 an
   admission, one projection an admission, two or more refreshes, its
   tokens on the manifest episode held by the same rule to the per-episode
   ones (each of those segments fills the bucket, so both modes encode it
   alike; per episode pads to whole seconds, and the padding enters the
   first conv layer's instance norm); ``--beam_size 4`` (to 50 tokens a
   segment); corpus RTFx and WER.  B1's device time at
   the 120 s segment (B = 1), the busy share of one segment's decode, and
   dense attention's peak memory at 120, 240 and 480 s until it runs out;
   (b) one Adafactor step at SpeechT5-base width (dropout off, B = 2 x 4
   s) on the card against the CPU (loss rtol 1e-5, parameters atol 1e-5
   where the CPU gradient is live, noise-driven entries within lr); the
   full-width ASR step at B = 8 x 10 s under AdamW and Adafactor in
   turns; gpt2-xl widths (vocabulary 256) at [4, 1024] under AdamW and
   Adafactor (peak memory, state bytes, ms, 48 B5 launches a forward:
   25 heads), ``train_lm --model gpt2-xl --optimizer adafactor --attn_impl
   flash`` for 2 steps; ``train_asr --optimizer adafactor --attn_impl
   flash --checkpoint <HF .safetensors> --nan_recovery --nan_inject_step
   3 --save_every 2 --steps 6``: one ``nan_rollback`` at step 3, the live
   parameters after it equal to step 2's save and the optimizer's count
   2, every other loss finite, its launches, then ``average_last_k``;
19. Fisher corpus ingest at SpeechT5-base width (``fisher_phase``): (a)
   an LDC-layout tree of 4 calls (``fe_03_00001-4``) from the committed
   train recordings resampled to 8 kHz, 6 a channel (~59 s), shorten-coded
   by the port's encoder (three ``pcm,embedded-shorten-v2.00``, one
   ``ulaw,...``), with LDC transcripts, ``calldata.tbl``,
   ``filetable.txt`` and ``{train,dev}.recids``; (b) ``python -m
   loco_asr_tpu_torch.pipelines.fisher_prep --calldata --split_dir
   --strict``: every wav.scp line names the port's ``sph_decode``, every
   channel's pipe returns the seeded samples exactly, the pipe process
   loads no torch, JAX or ``loco_asr_tpu`` (``-X importtime``), and the
   native core (which must build) equals the pure-Python decoder bit for
   bit on each file's first 10 s; M samples/s of both, seconds a pipe and
   the extrapolation to 11,699 ten-minute calls; (c) ``train_asr
   --attn_impl flash --batch_size 8 --max_seconds 10 --steps 8
   --eval_every 4 --eval_batches 1`` on the train split (finite losses,
   18 B1 and 18 B3/B4 a step, 12 B1 + 1 B2 a dev encode; median step ms,
   the last step's busy share, the seconds the loop waits on the
   prefetching stream after its first batch, the recordings its pipes
   load; then the input stream alone, seconds a batch); (d)
   ``decode_asr --beam_size 4`` of 16 dev utterances on (c)'s checkpoint,
   kernel path against plain path by phase 12's near-tie rule, WER; (e)
   ``eval_ppl --model gpt2 --context_type max_len`` on the dev text, flash
   against dense (NLL 1e-4, B6's launches); (f) ``encode_speech`` with the
   generic feature encoder (``feat_extract_norm="layer"``,
   ``conv_bias``) at B = 16 x 5 s, kernels against plain (1e-3 max, 1e-4
   mean; 12 B1, 0 B2);
20. orbax step directories, read without orbax, tensorstore or a zstd
   module: (a) the five committed steps under ``exp/loco/*/ckpt`` through
   ``utils/orbax.restore_step`` (``asr`` and ``asr_lm`` equal to
   ``fixtures/loco_reference``'s ``.npz`` bit for bit, ``asr_lm2`` equal to
   ``asr_lm``, ``asr_lm_big`` read whole), each step's read seconds and the
   native Zstandard decoder's MB/s over every zstd value; (b) ``eval_ppl``
   on the committed LoCo LM, read from orbax, with the LM stage's flags
   (``--model tiny --tokenizer char --max_len 256 --bsize 32``) on
   ``exp/loco/lm_corpus/dev.txt``, ``indep`` and ``max_len``, under
   ``--attn_impl flash`` (its head dim of 16 routes to B5, as JAX's
   ``flash_attention_nhd`` does; launches counted) and dense: every
   recording's perplexity within 1e-4 relative of
   ``fixtures/loco_reference/lm_ppl.json`` (the JAX ``eval_ppl`` on the CPU),
   and the gap to the committed ``exp/loco/ppl_*/rec_id2ppl.json`` printed;
   (c) phase 15 above reads its weights from orbax; (d)
   ``utils/profiling.device_time_per_iter`` on B1 at phase 3's
   ``rel_padded`` shape beside ``time_ms``; (e) the four examples
   (``loco_asr_tpu_torch/examples/01-04 --tiny``) on the card, their lines
   checked and their B1 / B2 launches counted;
21. the (data, fsdp, tensor) mesh (``loco_asr_tpu_torch/parallel/``):
   four ranks on the one card over gloo (a card a rank would take NCCL;
   here ranks share it, so every collective is staged through host
   memory, and their times say nothing of NCCL): (a) the sharded ASR step
   at SpeechT5-base width (vocabulary 256, flash, dropout on) on 8 corpus
   windows of <= 10 s under meshes (2, 1, 2) and (1, 2, 2), 2 steps each
   held to the single-device step on the card (loss 1e-4, ``grad_norm``
   1e-3 relative), each rank's launches of one step (18 B1, 18 B3/B4, 6
   B5, all at 6 heads), step ms, peak memory and the exact bytes of its
   parameters plus AdamW state (the partition rules' figure); (b) the
   gpt2-width LM step at [8, 1024] under (1, 2, 2), 2 steps (the second
   holds the first's sharded AdamW update), 12 B6 at 6 heads a rank,
   held the same way; (c) ``train_asr --mesh 2,1,2 --attn_impl flash`` 2
   steps and ``--resume`` to 3 on the committed corpus, run by the same
   ranks, then the single-device trainer resumes the saved step; (e)
   ``dryrun_multichip(4)`` on the same ranks; (d) on ranks 0 and 1 of
   the same start, regrouped as two, ``decode_asr`` (greedy, 8 dev
   utterances: equal tokens but at near-ties), ``extract_embeddings -m
   audio`` (24 seeded wavs, 1e-5) and ``eval_ppl --context_type max_len``
   (gpt2 width, char, 1e-6 relative) at ``--data_parallel 2`` against 1;
22. sequence parallelism (``parallel/sp.py``), run by phase 21's four
   ranks after (e) (the sequence axis; gloo through host memory): (a) the
   SpeechT5-base ASR step (vocabulary 256, the feature encoder frozen,
   dropout on) at B = 1 x 164.005 s (8,200 frames, the count nearest 164
   s that divides 4; 2,048 labels), 2 steps under ring and 2 under
   Ulysses, each held to the single-device flash step on the same batches
   (loss and grad norm within 1e-5 relative), with each rank's step ms,
   peak memory, bytes through gloo and launches (Ulysses: 12 B1 and 12
   B3/B4 at 3 heads and B2; ring: B2 only); (b) ``eval_ppl
   --sequence_parallel 4`` at gpt2 width ([8, 1024] windows, 16
   recordings of the LM dev text) under both schemes against one device
   (PPLs within 1e-5 relative; Ulysses' B5 at 3 heads counted) and
   ``train_lm --attn_impl ring --sp_devices 4`` one step at [8, 1024]
   against the flash step's loss; (c) phase 21 (e)'s dry run holds its
   sequence-parallel sections; then the Ulysses launches' inputs (B1 and
   B3/B4 at [1, 3, 8200, 64], B2, B5 at [8, 3, 1024, 64]), captured on
   rank 0, against their plain versions;
23. summary: one ``{"kernels": [...]}`` line (B1 and B2 also with their
   ``decode_launches`` of phase 12, ``loco_launches`` of phase 13 (d),
   ``intent_launches`` of phase 14 and ``loco_reference_launches`` of
   phase 15, B1 with its head-dim-8 time, B6 with its phase 13 launches,
   B1, B3/B4 and B5 with phase 17 (d)'s launches, B3/B4 with phase 17
   (a)'s head dims and phase 17 (b)'s head-dim-8 launches, B1 and B2 with
   phase 18's episode launches, B1 with its 120 s decode time, B1 and
   B3/B4 with the Adafactor ``train_asr`` run's, B5 with the gpt2-xl
   steps', B1, B2, B3/B4 and B6 with phase 19's ``fisher_launches``;
   B1 and B2 with phase 20's ``examples_launches``, B5 with its
   ``orbax_eval_ppl_launches``; B1, B3/B4, B5 and B6 with phase 21's
   ``mesh_rank_step_launches``; B1, B2, B3/B4 and B5 with phase 22's
   launches a rank and the error of their captured Ulysses launches;
   then the six bf16 forms with phase 16's launches, times and
   bounds: B1, B3/B4, B5 and B6 as their wgmma form, its launches in the
   bf16 ASR and LM steps, B3/B4 with the mask-only pair beside), then last
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when no CUDA device is present.

    python3 chip_smoke.py --kernel-cases

runs only the build and phase 3's B2 and B7 cases, and ends with one
``{"kernel_cases": [...]}`` line.  Copied to the root of another checkout
(an earlier commit unpacked with ``git archive``, from the one that added
``loco_asr_tpu_torch/utils/profiling.py`` on, which times the cases), it
runs that checkout's B2 and B7 through the same cases and inputs.

    python3 chip_smoke.py --mesh-phase

runs only the build and phases 21-22, and ends with one
``{"mesh_phase": {...}}`` line.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import itertools
import json
import os
import pickle
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

# device time by kernel; PROFILER_WINDOWS counts the run's profiler windows
# and the empty ones, which the summary prints
from loco_asr_tpu_torch.utils.profiling import (PROFILER_WINDOWS, busy_ms, device_breakdown,
                                                kernel_device_ms, profiled)

# H100 SXM data-sheet peaks used for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12       # CUDA cores
TF32_FLOP_PER_S = 495e12     # tensor cores, dense
BF16_FLOP_PER_S = 989e12     # tensor cores, dense

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
DECODE_ASR_BATCHES = 1    # phase 12's decode_asr runs: 8 of the dev corpus's 120 utterances
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


def bound(nbytes: float, flops: float, products: bool = False, bf16: bool = False):
    """(least ms, what binds it): the bytes over the memory rate, or the
    operations over the peak rate for them.  With ``products`` the flops are
    matrix products, whose least time at f32 accuracy is three TF32 passes
    on the tensor cores, 3 flops / 495 TFLOP/s (six bf16 passes at 989 give
    the same), and on bf16 operands (``bf16``) one pass at 989 TFLOP/s;
    other flops run on the CUDA cores at 67 TFLOP/s."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if products and bf16:
        t_ops = flops / BF16_FLOP_PER_S * 1e3
    else:
        t_ops = (3 * flops / TF32_FLOP_PER_S if products else flops / F32_FLOP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cores_ms(flops: float) -> float:
    """The flops on the CUDA cores at 67 TFLOP/s, printed beside a products
    bound."""
    return flops / F32_FLOP_PER_S * 1e3


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
    """Bytes moved (q, k, v, out, pe in their dtype, lse and valid_len in
    4 bytes, once each) and FLOP this run's data needs: q.k^T and p.v over
    the keys each row may see, plus q.pe^T over the distinct table cells
    those keys reach (none for the mask-only variant, ``pe`` None)."""
    b, h, tq, d = q.shape
    pe_numel = 0 if pe is None else pe.numel()
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel() + pe_numel) + 4 * (b * h * tq + b)
    keys, pe_cols = visible(tq, k.shape[2], 2 if pe is None else pe.shape[0], vl, causal)
    return nbytes, h * 2 * d * (2 * keys + (0 if pe is None else pe_cols))


def b34_work(q, k, pe, vl, causal, mask_only):
    """Bounds of B3 and B4 from this run's data.  Both read q, g, k, v, pe,
    lse, delta and valid_len once (q, g, k, v, pe in their dtype).  B3
    writes dq and the band gradient dqpe [B, H, Tq, 2L] (float32) and needs
    s, dp and ds.k over the visible pairs plus q.pe^T over the reached
    cells; B4 writes dk, dv (float32) and needs s, dp, p^T.g and ds^T.q over
    the pairs plus the same band product.  The mask-only variant reads no
    pe, writes no dqpe and takes no band product."""
    b, h, tq, d = q.shape
    reads = (q.element_size() * (2 * q.numel() + 2 * k.numel() + (0 if mask_only else pe.numel()))
             + 4 * (2 * b * h * tq + b))
    keys, pe_cols = visible(tq, k.shape[2], pe.shape[0], vl, causal)
    if mask_only:
        pe_cols = 0
    dqpe = 0 if mask_only else b * h * tq * pe.shape[0]
    b3 = (reads + 4 * (q.numel() + dqpe), h * 2 * d * (3 * keys + pe_cols))
    b4 = (reads + 4 * 2 * k.numel(), h * 2 * d * (4 * keys + pe_cols))
    return b3, b4


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


# the element type in a mangled kernel name: float or bf16
ELEM = r"(f|13__nv_bfloat16)"


def b1_build_records(build) -> list:
    """B1's sixteen flash_rel_fwd_kernels of the mma.sync form (f32 at head
    dims 8-128, bf16 at 8-32, rel band and mask-only) and the four of the
    wgmma form (bf16 at 64 and 128), with their shared memory at L = 160
    and 512 and the blocks that fit on one SM of this card (CUDA's
    occupancy API); the wgmma form's threads and stages from its C launch
    plan (``loco_flash_rel_fwd_wgmma_plan``)."""
    import ctypes

    from loco_asr_tpu_torch.ops.cuda import flash_causal as fc

    lib = build.library()

    def at_l(mask_only, d, bf16):
        return dict(
            smem_bytes_l160=lib.loco_flash_rel_smem_bytes(320, mask_only, d, bf16),
            smem_bytes_l512=lib.loco_flash_rel_smem_bytes(1024, mask_only, d, bf16),
            blocks_per_sm_l160=lib.loco_flash_rel_blocks_per_sm(320, mask_only, d, bf16),
            blocks_per_sm_l512=lib.loco_flash_rel_blocks_per_sm(1024, mask_only, d, bf16))

    def describe(m):
        bf16, mask_only, d = int(m.group(1) != "f"), int(m.group(2)), int(m.group(3))
        return dict(kernel="B1", form="mma_sync", dtype=("float32", "bfloat16")[bf16],
                    mask_only=bool(mask_only), head_dim=d,
                    shape="4 warps, 64-key tiles, 2 stages" if mask_only
                    else "4 warps, 32-key tiles, 1 stage", **at_l(mask_only, d, bf16))

    def describe_wgmma(m):
        mask_only, d = int(m.group(1)), int(m.group(2))
        plan = (ctypes.c_longlong * 35)()
        lib.loco_flash_rel_fwd_wgmma_plan(fc.stride_buffer((0,) * 12), 1, 1, 249, 249, d, 320,
                                          0, mask_only, (ctypes.c_int * 1)(249),
                                          ctypes.addressof(plan))
        threads, stages, consumers = plan[32], plan[33], plan[34]
        return dict(kernel="B1", form="wgmma", dtype="bfloat16", mask_only=bool(mask_only),
                    head_dim=d, threads=threads, stages=stages,
                    shape=f"{consumers} consumer warpgroups on one block's 64 query rows, "
                          f"64-key tiles in turn, a producer warpgroup, {stages} TMA stages"
                          + ("" if mask_only else " of K, V and the band's window"),
                    **at_l(mask_only, d, 1))
    return (kernel_build_records(build, r"flash_rel_fwd_kernelI" + ELEM + r"Lb([01])ELi(\d+)E",
                                 describe, 16)
            + kernel_build_records(build, r"flash_rel_fwd_wgmma_kernelILb([01])ELi(\d+)E",
                                   describe_wgmma, 4))


def b34_build_records(build) -> list:
    """The same for B3's and B4's kernels: the thirty-two of the mma.sync
    form (flash_rel_bwd_dq_kernel, flash_rel_bwd_dkv_kernel; f32 at head
    dims 8-128 and bf16 at 8-32, rel band and mask-only) and the eight of
    the wgmma form (bf16 at 64 and 128), the latter with their threads and
    stages from the C launch plan (``loco_flash_rel_bwd_wgmma_plan``)."""
    import ctypes

    from loco_asr_tpu_torch.ops.cuda import flash_causal as fc

    lib = build.library()
    b3 = "4 warps of 16 query rows, 32-key tiles, K double-buffered, V single"
    b4 = "4 warps of 16 keys, 32-query tiles double-buffered"

    def describe(m):
        kernel, bf16 = int(m.group(1) == "dkv"), int(m.group(2) != "f")
        mask_only, d = int(m.group(3)), int(m.group(4))
        shape = (b3, b4)[kernel] + ("" if mask_only else
                                    (", the q.pe table", ", the pe band")[kernel])
        if kernel:
            shape += (", k and v in shared memory" if d >= 128 else
                      ", k and v in registers" if bf16 else ", v in shared memory")
        elif d >= 128 and not bf16:
            shape += ", q and g in shared memory"
        return dict(kernel=("B3", "B4")[kernel], form="mma_sync",
                    dtype=("float32", "bfloat16")[bf16],
                    mask_only=bool(mask_only), head_dim=d, shape=shape,
                    smem_bytes_l160=lib.loco_flash_rel_bwd_smem_bytes(320, mask_only, kernel,
                                                                      d, bf16),
                    blocks_per_sm_l160=lib.loco_flash_rel_bwd_blocks_per_sm(320, mask_only,
                                                                            kernel, d, bf16))

    def describe_wgmma(m):
        kernel, mask_only, d = int(m.group(1) == "dkv"), int(m.group(2)), int(m.group(3))
        plan = (ctypes.c_longlong * 47)()
        lib.loco_flash_rel_bwd_wgmma_plan(fc.stride_buffer((0,) * 21), 1, 1, 500, 500, d, 320,
                                          0, mask_only, (ctypes.c_int * 1)(500),
                                          ctypes.addressof(plan))
        threads, stages = plan[43 + kernel], plan[45 + kernel]
        consumers = threads // 128 - 1
        shape = ((f"{consumers} consumer warpgroups on one block's 64 query rows, 64-key "
                  "tiles in turn, each with its band window" if kernel == 0 else
                  f"{consumers} consumer warpgroup(s) on one block's 64 keys, 64-query tiles "
                  "in turn") + f", a producer warpgroup, {stages} TMA stages")
        return dict(kernel=("B3", "B4")[kernel], form="wgmma", dtype="bfloat16",
                    mask_only=bool(mask_only), head_dim=d, shape=shape, threads=threads,
                    stages=stages, smem_bytes_l160=plan[41 + kernel],
                    smem_bytes_l512=lib.loco_flash_rel_bwd_smem_bytes(1024, mask_only, kernel,
                                                                      d, 1),
                    blocks_per_sm_l160=lib.loco_flash_rel_bwd_blocks_per_sm(320, mask_only,
                                                                            kernel, d, 1),
                    blocks_per_sm_l512=lib.loco_flash_rel_bwd_blocks_per_sm(1024, mask_only,
                                                                            kernel, d, 1))
    return (kernel_build_records(build, r"flash_rel_bwd_(dq|dkv)_kernelI" + ELEM
                                 + r"Lb([01])ELi(\d+)E", describe, 32)
            + kernel_build_records(build, r"flash_rel_bwd_(dq|dkv)_wgmma_kernelILb([01])ELi(\d+)E",
                                   describe_wgmma, 8))


def b56_wgmma_build_records(build) -> list:
    """The same for B5/B6's two wgmma kernels (bf16 at head dims 64 and
    128), with the block's shared memory, threads and stages from the C
    launch plan (``loco_flash_causal_wgmma_plan``)."""
    import ctypes

    from loco_asr_tpu_torch.ops.cuda import flash_causal as fc

    lib = build.library()

    def describe(m):
        d = int(m.group(1))
        plan = (ctypes.c_longlong * 30)()
        lib.loco_flash_causal_wgmma_plan(fc.stride_buffer((0,) * 12), 1, 1, 1, 1, d, 1,
                                         ctypes.addressof(plan))
        return dict(kernel="B5/B6 wgmma", dtype="bfloat16", head_dim=d,
                    shape=f"2 consumer warpgroups of 64 query rows + 1 producer, 128-key "
                          f"tiles of {plan[2]} keys, {plan[29]} K/V stages, TMA",
                    dynamic_smem_bytes=plan[27], threads=plan[28], blocks_per_sm=1)
    return kernel_build_records(build, r"flash_causal_fwd_wgmma_kernelILi(\d+)E", describe, 2)


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
    """B2's kernels and B7's warp kernels: registers and spill (ptxas),
    shared memory and blocks an SM at the main path's shapes (CUDA's
    occupancy API; B2's statistics at [16, 80000]'s 1024-frame chunk, B7 at
    80 mel bins of stride 25), no clusters, and the static SASS count: for
    form 0's output kernel (f32) over the 2 x 64 outputs of a thread's two
    unrolled bodies (full tile, edge tile; prologue included), for form 1's
    (bf16, ``conv_out_mma_kernel``) over the 4 x 16 outputs of a thread's
    tile (prologue, staging and both store paths included), for B7 a whole
    kernel."""
    import torch
    from loco_asr_tpu_torch.ops.cuda import conv_frontend as cf
    from loco_asr_tpu_torch.ops.cuda import logmel

    lib = build.library()
    chunk = cf.stat_chunk(16, 15999, torch.cuda.get_device_properties(0).multi_processor_count)
    stride = logmel._host_constants(16000, 1024, 1024, 80, 80.0, 7600.0)[3].shape[1]

    def b2(m):
        phase = int(m.group(1) == "out")
        return dict(kernel="B2", phase=("statistics", "output")[phase],
                    dtype=("float32", "bfloat16")[m.group(2) != "f"],
                    form=(None, "ffma")[phase],
                    shape=(f"256 threads, {chunk}-frame chunks at [16, 80000]",
                           "8 warps x 16 channels x 4 frames a thread, 128-frame tiles")[phase],
                    dynamic_smem_bytes=((chunk * 5 + 5) * 4, 0)[phase], cluster=None,
                    blocks_per_sm=lib.loco_conv_frontend_blocks_per_sm(phase, chunk))

    def b2_mma(m):
        return dict(kernel="B2", phase="output", dtype="bfloat16", form="mma_sync",
                    shape="8 warps x 16 channels (one alignment class mod 8 a warp) x 128 "
                          "frames, a bf16 m16n8k16 per 16 channels x 8 frames, each warp's "
                          "rows staged and written 256 bytes a row a lane group",
                    dynamic_smem_bytes=B2_MMA_STAGE_BYTES, cluster=None,
                    blocks_per_sm=lib.loco_conv_frontend_blocks_per_sm(2, chunk))

    def b7(m):
        log2_m = int(m.group(1))
        return dict(kernel="B7", m=1 << log2_m, shape="8 warps, a warp a frame, persistent",
                    smem_bytes_80_mels=lib.loco_logmel_smem_bytes(log2_m, 80, stride),
                    blocks_per_sm_80_mels=lib.loco_logmel_blocks_per_sm(log2_m, 80, stride),
                    cluster=None)

    recs = (kernel_build_records(build, r"conv_(stats|out)_kernelILi10E" + ELEM + "E", b2, 3)
            + kernel_build_records(build, r"conv_out_mma_kernel", b2_mma, 1)
            + kernel_build_records(build, r"logmel_warp_kernelILi(\d)E", b7, 5))
    sass = sass_counts(build.library_path(), ("conv_out_kernelILi10EfE", "conv_out_mma_kernel",
                                              "logmel_warp_kernelILi9E"))
    for name, n in sass.items():
        if "conv_out_kernel" in name:
            recs.append(dict(kernel="B2", form="ffma", sass_instructions_output_kernel=n,
                             sass_per_output=n / 128))
        elif "conv_out_mma_kernel" in name:
            recs.append(dict(kernel="B2", form="mma_sync", sass_instructions_output_kernel=n,
                             sass_per_output=n / 64))
        else:
            recs.append(dict(kernel="B7", sass_instructions_m512=n))
    return recs


def b2_work(wav, c, k, f):
    b = wav.shape[0]
    nbytes = wav.element_size() * (wav.numel() + c * k + 2 * c + b * c * f)
    # conv (2K), folded affine (2) and GELU (~4) per output, tap statistics
    flops = b * c * f * (2 * k + 6) + 2 * b * f * (k + k * (k + 1) // 2)
    return nbytes, flops


# conv_frontend.cu's MT_STAGE_BYTES: the bf16 output kernel's dynamic
# shared memory (8 warps x 16 rows x 128 bf16 frames)
B2_MMA_STAGE_BYTES = 32768
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


def causal_work(b, h, tq, tk, d, causal, elem: int = 4):
    """Bytes moved (q, k, v, out of ``elem`` bytes, lse of 4, once each)
    and FLOP of q.k^T and p.v over the key pairs each row may see (row i
    sees keys 0..i if causal)."""
    pairs = sum(min(i + 1, tk) for i in range(tq)) if causal else tq * tk
    nbytes = elem * (2 * b * h * tq * d + 2 * b * h * tk * d) + 4 * b * h * tq
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
    for fn in (fc.flash_forward, fc.flash_forward_nhd, fa.flash_rel_forward,
               fa.flash_rel_backward):
        fn.launches_by_form = dict.fromkeys(fc.FORMS, 0)


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


CARRY_UTTERANCES = 6    # phase 12 (a)'s carry-over, 3 refreshes of the context:
                        # a depth cut for time (the recording holds 10)


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
    k, max_len = 5, 100   # steps: a depth cut for the script's time limit

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

        # (a) carry-over: the first CARRY_UTTERANCES of one recording's 10
        # through ConversationContext
        ds = KaldiAsrDataset(corpus["dev"])
        rec_id = sorted(ds.examples, key=lambda e: e.utt_id)[0].utt_id.split("-")[0]
        utts = sorted((e for e in ds.examples if e.utt_id.split("-")[0] == rec_id),
                      key=lambda e: e.utt_id)
        check(len(utts) == 10, f"recording {rec_id}: {len(utts)} utterances")
        utts = utts[:CARRY_UTTERANCES]
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
        # (the first batch, 8 of the 120 utterances: the depth cut to keep
        # the whole script inside its time limit)
        common = ["--data_dir", corpus["dev"], "--lm_model", "gpt2", "--lm_checkpoint", lm_path,
                  "--max_decode_len", "64", "--batch_size", "8", "--max_seconds", "1",
                  "--limit_batches", str(DECODE_ASR_BATCHES)]
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
            check(len(lines) == 8 * DECODE_ASR_BATCHES, f"{name}: {len(lines)} lines in hyp.text")
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
    weights (the committed orbax steps ``exp/loco/{asr,asr_lm}/ckpt``, read by
    ``utils/orbax.py``), through B1 at head dim 8 and B2 at
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
                shutil.copytree(os.path.join(ROOT, "exp", "loco", name, "ckpt"),
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

ORBAX_STEPS = ("asr", "asr_lm", "asr_lm2", "asr_lm_big", "lm")
PPL_REL_TOL = 1e-4     # eval_ppl on the card against the JAX run's perplexities
EXAMPLE_LINES = {      # each example's lines, as the JAX script prints them
    "01_speecht5_demo": ("ASR beam tokens:", "TTS mel: (1, 20, 8) frames:",
                         "Vocoder waveform: (1,", "VC mel: (1, 8, 8)"),
    "02_shared_embedding_space": ("speech x text cosine similarity matrix:",) + (" [",) * 4
    + ("per-frame PCA: speech (6396, 3), text (20, 3);",
       "pooled PCA coordinates (first 4 rows = speech, last 4 = text):") + ("[",) * 8
    + ("kmeans(k=2) over pooled space:",),
    "03_slurp_embeddings": ("dataset: 8 utterances, 3 intents",
                            "  slurp_id=0 frames=639 intent=alarm_set (class 3)",
                            "  slurp_id=1 frames=639 intent=play_music (class 66)",
                            "  slurp_id=2 frames=639 intent=weather_query (class 98)",
                            "  slurp_id=3 frames=639 intent=alarm_set (class 3)"),
    "04_checkpoint_mapping": ("HF import: strict key+shape match, 101 leaves",
                              "fairseq encoder import: strict key+shape match,"),
}


def orbax_reads(smi: str) -> dict:
    """Phase 20 (a): the five committed steps through the port's reader;
    ``asr`` and ``asr_lm`` against the fixture ``.npz`` and ``asr_lm2``
    against ``asr_lm``, bit for bit; the native decoder's MB/s over every
    zstd value of the five."""
    from loco_asr_tpu_torch import native
    from loco_asr_tpu_torch.utils.checkpoint import flatten
    from loco_asr_tpu_torch.utils.ocdbt import OcdbtStore
    from loco_asr_tpu_torch.utils.orbax import restore_step

    check(native.available(), f"the native core did not build: {native.build_error}")
    steps, states = {}, {}
    for name in ORBAX_STEPS:
        ckpt = os.path.join(ROOT, "exp", "loco", name, "ckpt")
        with open(os.path.join(ckpt, "status.json")) as f:
            step_dir = os.path.join(ckpt, f"step_{json.load(f)['latest']}")
        t0 = time.perf_counter()
        state = restore_step(step_dir)
        read_s = time.perf_counter() - t0
        flat = flatten(state)
        with open(os.path.join(step_dir, "_METADATA")) as f:
            n_meta = len(json.load(f)["tree_metadata"])
        check(len(flat) == n_meta, f"orbax {name}: {len(flat)} leaves, _METADATA names {n_meta}")
        nbytes = sum(v.nbytes for v in flat.values() if isinstance(v, np.ndarray))
        states[name] = flat
        steps[name] = dict(step=os.path.basename(step_dir), leaves=len(flat),
                           array_bytes=nbytes, read_s=read_s)
    for name in ("asr", "asr_lm"):
        (fixture,) = [f for f in os.listdir(os.path.join(ROOT, "fixtures", "loco_reference", name))
                      if f.endswith(".npz")]
        check(fixture[:-4] == steps[name]["step"], f"fixture {fixture} against {steps[name]}")
        with np.load(os.path.join(ROOT, "fixtures", "loco_reference", name, fixture)) as z:
            for key in z.files:
                got = states[name][key]
                check(got.dtype == z[key].dtype and got.tobytes() == z[key].tobytes(),
                      f"orbax {name}: {key} differs from the fixture")
            steps[name]["fixture_arrays_equal"] = len(z.files)
    a, b = states["asr_lm"], states["asr_lm2"]
    check(a.keys() == b.keys() and all(
        (a[k] is None and b[k] is None) or a[k].tobytes() == b[k].tobytes() for k in a),
        "orbax asr_lm2 differs from asr_lm")
    values = []
    for name in ORBAX_STEPS:
        ckpt = os.path.join(ROOT, "exp", "loco", name, "ckpt")
        store = OcdbtStore(os.path.join(ckpt, steps[name]["step"]))
        values += [v for v in (store.read(k) for k in store.keys()) if v[:4] == b"\x28\xb5\x2f\xfd"]
    t0 = time.perf_counter()
    out_bytes = sum(len(native.zstd_decompress(v)) for v in values)
    decode_s = time.perf_counter() - t0
    rec = dict(steps=steps, zstd_values=len(values), zstd_in_mb=sum(map(len, values)) / 1e6,
               zstd_out_mb=out_bytes / 1e6, zstd_decode_s=decode_s,
               zstd_mb_per_s=out_bytes / 1e6 / decode_s, host_cpus=os.cpu_count(), card=smi)
    print(f"[orbax] reads {json.dumps(rec)}")
    return rec


def orbax_eval_ppl(smi: str) -> dict:
    """Phase 20 (b): ``eval_ppl`` on the committed LoCo LM, read from orbax,
    at the LM stage's flags, ``indep`` and ``max_len``, flash and dense;
    every perplexity within PPL_REL_TOL of the JAX run's (the fixture), and
    the gap to the committed files.  Returns the flash runs' launches."""
    import torch

    from loco_asr_tpu_torch.pipelines import eval_ppl

    with open(os.path.join(ROOT, "fixtures", "loco_reference", "lm_ppl.json")) as f:
        jax_ppl = json.load(f)
    runs, flash_launches = {}, {k: 0 for k in all_launches()}
    with tempfile.TemporaryDirectory() as tmp:
        for context in ("indep", "max_len"):
            with open(os.path.join(ROOT, "exp", "loco", f"ppl_{context}", "rec_id2ppl.json")) as f:
                committed = json.load(f)
            want = jax_ppl[context]
            for impl in ("flash", "dense"):
                out = os.path.join(tmp, f"{context}_{impl}")
                reset_all_launches()
                t0 = time.perf_counter()
                rc = eval_ppl.main(["-i", os.path.join(ROOT, "exp", "loco", "lm_corpus", "dev.txt"),
                                    "-o", out, "--model", "tiny", "--tokenizer", "char",
                                    "--max_len", "256", "--bsize", "32", "--context_type", context,
                                    "--attn_impl", impl,
                                    "--checkpoint", os.path.join(ROOT, "exp", "loco", "lm", "ckpt")])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = all_launches()
                check(rc == 0, f"eval_ppl {context} {impl} returned {rc}")
                with open(os.path.join(out, "rec_id2ppl.json")) as f:
                    got = json.load(f)
                check(sorted(got) == sorted(want), f"eval_ppl {context}: recordings differ")
                rel = max(abs(got[k] - want[k]) / want[k] for k in want)
                gap = max(abs(got[k] - committed[k]) / committed[k] for k in committed)
                check(rel <= PPL_REL_TOL, f"eval_ppl {context} {impl}: perplexity {rel} relative "
                                          f"from the JAX run's > {PPL_REL_TOL}")
                if impl == "flash":
                    check(launches["B5"] > 0 and launches["B6"] == 0,
                          f"eval_ppl {context} flash launched {launches}")
                    flash_launches = {k: flash_launches[k] + v for k, v in launches.items()}
                else:
                    check(not any(launches.values()), f"eval_ppl {context} dense launched {launches}")
                runs[f"{context}_{impl}"] = dict(
                    wall_s=wall, recordings=len(got), max_rel_to_jax=rel,
                    max_rel_to_committed=gap, mean_ppl=float(np.mean(list(got.values()))),
                    launches={k: v for k, v in launches.items() if v})
    rec = dict(runs=runs, tol=PPL_REL_TOL, card=smi)
    print(f"[orbax] eval_ppl {json.dumps(rec)}")
    return flash_launches


def examples_run(smi: str) -> dict:
    """Phase 20 (e): the four examples at ``--tiny`` on the card, their
    lines against the JAX scripts', B1 / B2 launches counted."""
    import importlib

    import torch

    recs, total = {}, {k: 0 for k in all_launches()}
    for name, want in EXAMPLE_LINES.items():
        module = importlib.import_module(f"loco_asr_tpu_torch.examples.{name}")
        buf = io.StringIO()
        reset_all_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = module.main(["--tiny"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = all_launches()
        lines = buf.getvalue().splitlines()
        check(rc == 0 and len(lines) == len(want)
              and all(line.lstrip().startswith(w.lstrip()) for line, w in zip(lines, want)),
              f"example {name}: {lines}")
        encodes = name != "04_checkpoint_mapping"
        check((launches["B1"] > 0 and launches["B2"] > 0) == encodes
              and not any(v for k, v in launches.items() if k not in ("B1", "B2")),
              f"example {name} launched {launches}")
        total = {k: total[k] + v for k, v in launches.items()}
        recs[name] = dict(wall_s=wall, lines=lines[:2],
                          launches={k: v for k, v in launches.items() if v})
    print(f"[orbax] examples {json.dumps(dict(examples=recs, card=smi))}")
    return total


def orbax_phase(smi: str, dev) -> dict:
    """Phase 20: orbax step directories and the A8 utilities on the card
    ((a), (b), (d), (e) above; (c) is phase 15).  Returns the launches of
    (b)'s flash runs and of (e)."""
    import torch

    from loco_asr_tpu_torch.ops.cuda import flash_attention as fa
    from loco_asr_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    reads = orbax_reads(smi)
    ppl_launches = orbax_eval_ppl(smi)
    # (d) B1 at phase 3's rel_padded shape: CUDA events around one call
    # (device_time_per_iter) beside five back-to-back calls (time_ms)
    g = torch.Generator().manual_seed(20)
    q, k, v = ((torch.randn(16, 12, 249, 64, generator=g) * 0.3).to(dev) for _ in range(3))
    pe = (torch.randn(320, 64, generator=g) * 0.3).to(dev)
    vl = torch.tensor([249] * 10 + [230, 200, 180, 120, 60, 17], dtype=torch.int32, device=dev)
    b1 = dict(shape=[16, 12, 249, 64], two_l=320,
              device_time_per_iter_ms=1e3 * profiling.device_time_per_iter(
                  lambda *a: fa.flash_rel_forward(*a, causal=False, scale=1.0),
                  q, k, v, pe, vl, iters=50, warmup_iters=5),
              time_ms=time_ms(lambda: fa.flash_rel_forward(q, k, v, pe, vl, causal=False,
                                                           scale=1.0)),
              card=smi)
    print(f"[orbax] b1_timers {json.dumps(b1)}")
    example_launches = examples_run(smi)
    wall = time.perf_counter() - t0
    print(f"[orbax] phase 20 {wall:.1f} s; decoder {reads['zstd_mb_per_s']:.1f} MB/s; card {smi}")
    return dict(reads=reads, eval_ppl_launches=ppl_launches, examples_launches=example_launches,
                b1_timers=b1, wall_s=wall)


BF16_REL_TOL = 2.0 ** -7   # bf16 kernel vs its plain version, of max |plain|
BF16_LSE_TOL = 1e-3
BF16_STEP_RTOL = 1e-2      # bf16 step, kernels + flash vs plain + dense: loss
MP_LOSS_RTOL, MP_GNORM_REL = 5e-2, 0.15   # bf16 vs f32 step (the JAX test's contract)
BF16_NLL_DELTA = 5e-2      # eval_ppl, bf16 vs f32: mean |d NLL| (the JAX test's bound)


@contextlib.contextmanager
def counted_forms():
    """A tally of kernel launches by form: every launch path calls
    ``_build.bf16_flag`` once to pick its kernel's form; the tally counts
    those calls by ``caller:form`` while the block runs."""
    from loco_asr_tpu_torch.ops.cuda import _build

    real = _build.bf16_flag
    tally: dict = {}

    def spy(dtype, what):
        flag = real(dtype, what)
        key = f"{what}:{'bf16' if flag else 'f32'}"
        tally[key] = tally.get(key, 0) + 1
        return flag

    _build.bf16_flag = spy
    try:
        yield tally
    finally:
        _build.bf16_flag = real


def held(what: str, got, plain, exact, lse=None, plain_lse=None, *,
         f32_tol: float = B1_TOL) -> dict:
    """A kernel's output against its plain version on the same inputs.
    bf16: max |d| <= 2^-7 max |plain|, lse within 1e-3, and both against a
    float64 evaluation (the kernel's error at most twice the plain
    version's).  f32: max |d| and the lse's within ``f32_tol``, the limits
    of phases 3 and 8; the float64 errors are recorded."""
    import torch

    check(bool(torch.isfinite(got.float()).all()), f"{what}: non-finite output")
    check(got.dtype == plain.dtype, f"{what}: dtype {got.dtype}, plain {plain.dtype}")
    bf16 = got.dtype == torch.bfloat16
    err = (got.float() - plain.float()).abs().max().item()
    lim = BF16_REL_TOL * plain.float().abs().max().item() if bf16 else f32_tol
    check(err <= lim, f"{what}: max abs err {err} > {lim}")
    k_err = (got.double() - exact).abs().max().item()
    p_err = (plain.double() - exact).abs().max().item()
    check(not bf16 or k_err <= 2 * p_err,
          f"{what}: error against float64 {k_err} > 2 x plain {p_err}")
    rec = dict(max_abs_err=err, tol=lim, f64_err=k_err, plain_f64_err=p_err)
    if lse is not None:
        rec["lse_err"] = (lse - plain_lse).abs().max().item()
        lse_lim = BF16_LSE_TOL if bf16 else f32_tol
        check(rec["lse_err"] <= lse_lim, f"{what}: lse err {rec['lse_err']} > {lse_lim}")
    return rec


def b1_f64(q, k, v, table, vl, causal: bool, scale: float, dtype=None):
    """B1's output in float64 on the same inputs (``table``: the rel-pos
    table, zeros for the mask-only variant)."""
    import torch

    from loco_asr_tpu_torch.ops.cuda import flash_attention as fa

    s = fa._scores(q.double(), k.double(), table.double(), scale)
    s = s.masked_fill(fa._masked(vl, q.shape[2], k.shape[2], causal, q.device), fa.NEG_INF)
    return torch.softmax(s, -1) @ v.double()


def hold_b1(what: str, q, k, v, pe, vl, *, causal: bool, scale: float) -> dict:
    """B1 (``pe`` None: mask-only) on these inputs, held by :func:`held`
    (f32: within B1_TOL)."""
    import torch

    from loco_asr_tpu_torch.ops.cuda import flash_attention as fa

    table = pe if pe is not None else torch.zeros(2, q.shape[-1], dtype=q.dtype, device=q.device)
    out, lse = fa.flash_rel_forward(q, k, v, pe, vl, causal=causal, scale=scale)
    pout, plse = fa.flash_rel_forward_plain(q, k, v, table, vl, causal=causal, scale=scale)
    return held(what, out, pout, b1_f64(q, k, v, table, vl, causal, scale), lse, plse)


def hold_b34(what: str, q, k, v, pe, vl, out, lse, g, *, causal: bool, scale: float,
             mask_only: bool) -> dict:
    """B3 + B4 (the wrapper's dq, dk, dv) against the plain backward and the
    float64 gradient of :func:`b1_f64`, each by :func:`held` (f32: within
    B34_TOL, and with the band, dpe relative to its max within B34_TOL)."""
    import torch

    from loco_asr_tpu_torch.ops.cuda import flash_attention as fa

    with_dpe = q.dtype == torch.float32 and not mask_only
    got = fa.flash_rel_backward(q, k, v, pe, vl, out, lse, g, causal=causal, scale=scale,
                                need_dpe=with_dpe, mask_only=mask_only)
    dq, dk, dv, dpe = rel_bwd_reference(q, k, v, pe, vl, out, lse, g, causal, scale, mask_only)
    plain = tuple(x.to(q.dtype) for x in (dq, dk, dv))
    leaves = [x.double().requires_grad_() for x in (q, k, v)]
    exact = torch.autograd.grad(b1_f64(*leaves, pe, vl, causal, scale), leaves, g.double())
    errs = {n: held(f"{what} {n}", a, p_, e, f32_tol=B34_TOL)
            for n, a, p_, e in zip(("dq", "dk", "dv"), got, plain, exact)}
    rec = dict(max_abs_err=max(r["max_abs_err"] for r in errs.values()), errs=errs)
    if with_dpe:
        rel = (got[3] - dpe).abs().max().item() / dpe.abs().max().item()
        check(rel <= B34_TOL, f"{what} dpe: error {rel} of its max > {B34_TOL}")
        errs["dpe"] = dict(max_abs_err=rel)
    return rec


def hold_b5(what: str, q, k, v, *, causal: bool, scale: float, nhd: bool = False) -> dict:
    """B5 ([B, H, T, D]) or B6 (``nhd``: [B, T, H, D]) by :func:`held`
    (f32: within B56_TOL)."""
    import torch

    from loco_asr_tpu_torch.ops.cuda import flash_causal as fc

    fn, plain_fn = ((fc.flash_forward_nhd, fc.flash_forward_nhd_plain) if nhd
                    else (fc.flash_forward, fc.flash_forward_plain))
    out, lse = fn(q, k, v, causal=causal, scale=scale)
    pout, plse = plain_fn(q, k, v, causal=causal, scale=scale)
    qs, ks, vs = ((x.transpose(1, 2) if nhd else x).double() for x in (q, k, v))
    s = (qs @ ks.transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(torch.ones(s.shape[-2:], dtype=torch.bool, device=q.device).triu(1),
                          -1e30)
    exact = torch.softmax(s, -1) @ vs
    return held(what, out, pout, exact.transpose(1, 2) if nhd else exact, lse, plse,
                f32_tol=B56_TOL)


def hold_b2(what: str, wav, w, sc, bi, *, stride: int = 5) -> dict:
    """B2 by :func:`held`; the float64 evaluation is the plain version
    on float64 copies."""
    from loco_asr_tpu_torch.ops.cuda import conv_frontend as cf

    out = cf.conv1_instance_norm_gelu(wav, w, sc, bi, stride=stride)
    pout = cf.conv1_instance_norm_gelu_plain(wav, w, sc, bi, stride=stride)
    exact = cf.conv1_instance_norm_gelu_plain(*(t.double() for t in (wav, w, sc, bi)),
                                              stride=stride)
    return held(what, out, pout, exact, f32_tol=B2_TOL)


@contextlib.contextmanager
def captured_launches():
    """The inputs of the first launch of each kernel form and shape while
    the block runs (B1 and B3/B4 by variant and q/k shapes, B5, B2), copied
    at the launch: the wrappers' launch paths are wrapped for the block.
    B3/B4's record takes ``out`` from the B1 launch of the same q (autograd
    saves it for the backward)."""
    from loco_asr_tpu_torch.ops.cuda import conv_frontend as cf
    from loco_asr_tpu_torch.ops.cuda import flash_attention as fa
    from loco_asr_tpu_torch.ops.cuda import flash_causal as fc

    real = (fa._launch_forward, fa._launch_backward, fc._launch, cf._launch)
    cases: dict = {}
    outs: dict = {}

    def keep(key, **tensors):
        if key not in cases:
            cases[key] = {n: (t.detach().clone() if hasattr(t, "detach") else t)
                          for n, t in tensors.items()}

    def b1(q, k, v, pe, valid_len, causal, scale, *, mask_only):
        out, lse = real[0](q, k, v, pe, valid_len, causal, scale, mask_only=mask_only)
        outs[q.data_ptr()] = out
        keep(("B1", "mask-only" if mask_only else "band", tuple(q.shape), tuple(k.shape)),
             q=q, k=k, v=v, pe=None if mask_only else pe, vl=valid_len, causal=causal,
             scale=scale)
        return out, lse

    def b34(q, k, v, pe, valid_len, lse, delta, g, causal, scale, *, mask_only):
        keep(("B3/B4", "mask-only" if mask_only else "band", tuple(q.shape), tuple(k.shape)),
             q=q, k=k, v=v, pe=pe, vl=valid_len, out=outs[q.data_ptr()], lse=lse, g=g,
             causal=causal, scale=scale, mask_only=mask_only)
        return real[1](q, k, v, pe, valid_len, lse, delta, g, causal, scale,
                       mask_only=mask_only)

    def b5(q, k, v, dims, *, t_axis, causal, scale, what):
        keep(("B5" if t_axis == 2 else "B6", tuple(q.shape), tuple(k.shape)), q=q, k=k, v=v,
             causal=causal, scale=scale, nhd=t_axis == 1)
        return real[2](q, k, v, dims, t_axis=t_axis, causal=causal, scale=scale, what=what)

    def b2(wav, weight, scale, bias, k, stride):
        keep(("B2", tuple(wav.shape)), wav=wav, w=weight, sc=scale, bi=bias, stride=stride)
        return real[3](wav, weight, scale, bias, k, stride)

    fa._launch_forward, fa._launch_backward, fc._launch, cf._launch = b1, b34, b5, b2
    try:
        yield cases
    finally:
        fa._launch_forward, fa._launch_backward, fc._launch, cf._launch = real
        outs.clear()


def hold_captured(cases: dict) -> list:
    """Each captured launch (:func:`captured_launches`) replayed through its
    wrapper and held against its plain version by the ``hold_*`` checks;
    B3/B4's and B5/B6's records name the form the replay took."""
    from loco_asr_tpu_torch.ops.cuda import flash_causal as fc

    recs = []
    for key, c in cases.items():
        dtype = next(t.dtype for t in c.values() if hasattr(t, "dtype"))
        what = f"{key[0]} {dtype} at the step's {' '.join(map(str, key[1:]))}"
        if key[0] == "B1":
            rec = hold_b1(what, c["q"], c["k"], c["v"], c["pe"], c["vl"], causal=c["causal"],
                          scale=c["scale"])
        elif key[0] == "B3/B4":
            rec = hold_b34(what, c["q"], c["k"], c["v"], c["pe"], c["vl"], c["out"], c["lse"],
                           c["g"], causal=c["causal"], scale=c["scale"],
                           mask_only=c["mask_only"])
        elif key[0] == "B2":
            rec = hold_b2(what, c["wav"], c["w"], c["sc"], c["bi"], stride=c["stride"])
        else:
            rec = hold_b5(what, c["q"], c["k"], c["v"], causal=c["causal"], scale=c["scale"],
                          nhd=c["nhd"])
        if key[0] in ("B1", "B3/B4", "B5", "B6"):
            rec["form"] = fc.kernel_form(dtype, fc.kernel_head_dim(c["q"].shape[-1], key[0]))
        recs.append(dict(kernel=key[0], case=[str(x) for x in key[1:]],
                         dtype=str(dtype), **({"form": rec["form"]} if "form" in rec else {}),
                         **{n: rec[n] for n in ("max_abs_err", "tol", "f64_err",
                                                "plain_f64_err") if n in rec},
                         **({"errs": {n: r["max_abs_err"] for n, r in rec["errs"].items()}}
                            if "errs" in rec else {})))
    return recs


def grads_by_leaf(got: dict, plain: dict, f32: dict, what: str) -> dict:
    """Each parameter's gradient of the kernel path in bf16 (``got``)
    against the f32 step's (``f32``): its distance at most twice the plain
    + dense bf16 path's (``plain``), plus 2^-8 of the f32 gradient's norm.
    The attention key biases are left out after showing that their f32
    gradient is rounding noise (at most 2^-8 of the same block's value
    bias's): the softmax cancels a per-query shift, so the exact gradient
    is 0.  Returns the worst ratio and the leaves held."""
    check(got.keys() == plain.keys() == f32.keys(), f"{what}: different parameters")
    worst, worst_name, held = 0.0, "", 0
    for k in f32:
        ref = f32[k].double()
        if k.endswith("k_proj.bias"):
            signal = f32[k.replace("k_proj", "v_proj")].double().norm().item()
            check(ref.norm().item() <= 2.0 ** -8 * signal,
                  f"{what}: {k}'s f32 gradient {ref.norm().item()} is not noise ({signal})")
            continue
        e_got = (got[k].double() - ref).norm().item()
        e_plain = (plain[k].double() - ref).norm().item()
        lim = 2 * e_plain + 2.0 ** -8 * ref.norm().item()
        check(e_got <= lim, f"{what}: {k} off the f32 gradient by {e_got} > {lim} "
                            f"(plain + dense bf16 {e_plain})")
        held += 1
        if e_got / lim > worst:
            worst, worst_name = e_got / lim, k
    return dict(leaves_held=held, worst_share_of_limit=worst, worst=worst_name)


def mixed_precision_phase(corpus: dict, host_batches: list, smi: str, dev) -> dict:
    """Phase 16: the bf16 forms of B1-B6 at the main path's shapes, the
    full-width ASR step and ``train_asr`` under the JAX README's
    mixed-precision flags, the gpt2-width LM step, ``train_lm`` and
    ``eval_ppl`` in bf16, and ``extract_embeddings --dtype bfloat16``.
    Returns the kernel records and the main paths' launches."""
    import torch
    import torch.nn.functional as F

    from loco_asr_tpu_torch.models.gpt2 import model as gm
    from loco_asr_tpu_torch.models.speecht5 import model as st5
    from loco_asr_tpu_torch.models.speecht5.config import SpeechT5Config
    from loco_asr_tpu_torch.ops.cuda import conv_frontend as cf
    from loco_asr_tpu_torch.ops.cuda import flash_attention as fa
    from loco_asr_tpu_torch.ops.cuda import flash_causal as fc
    from loco_asr_tpu_torch.parallel import train
    from loco_asr_tpu_torch.pipelines import eval_ppl, extract_embeddings, train_asr, train_lm

    bf = torch.bfloat16
    t_phase = time.perf_counter()
    g = torch.Generator().manual_seed(16)
    sdpa = F.scaled_dot_product_attention

    def randn(*shape, sc=0.3):
        return (torch.randn(*shape, generator=g) * sc).to(dev, bf)

    def counts():
        return {"B1": fa.flash_rel_forward.launches, "B2": cf.conv1_instance_norm_gelu.launches,
                "B3/B4": fa.flash_rel_backward.launches, "B5": fc.flash_forward.launches,
                "B5_bwd": fc.flash_backward.launches, "B6": fc.flash_forward_nhd.launches}

    def reset():
        fa.flash_rel_forward.launches = cf.conv1_instance_norm_gelu.launches = 0
        fa.flash_rel_backward.launches = fc.flash_forward.launches = 0
        fc.flash_backward.launches = fc.flash_forward_nhd.launches = 0
        for fn in (fc.flash_forward, fc.flash_forward_nhd, fa.flash_rel_forward,
                   fa.flash_rel_backward):
            fn.launches_by_form = dict.fromkeys(fc.FORMS, 0)
        cf.conv1_instance_norm_gelu.launches_by_form = dict.fromkeys(cf.FORMS, 0)

    def by_form():
        return {"B1": dict(fa.flash_rel_forward.launches_by_form),
                "B2": dict(cf.conv1_instance_norm_gelu.launches_by_form),
                "B5": dict(fc.flash_forward.launches_by_form),
                "B6": dict(fc.flash_forward_nhd.launches_by_form),
                "B3/B4": dict(fa.flash_rel_backward.launches_by_form)}

    recs = {}

    # (a) the bf16 kernels at the f32 cases' shapes, B1 mask-only at the
    # decoder's cross-attention shape (160 label positions over 500
    # frames), causal, at head dim 128 and at L = 512 (past the 272 and 242
    # the mma.sync forms' table allowed B3; there B3/B4 run beside B1): every
    # bf16 B1 at head dims 64 and 128 in the wgmma form (one launch of it a
    # hold, counted)
    rel_lens = [249] * 10 + [230, 200, 180, 120, 60, 17]
    for name, b, h, tq, tk, L, vls, causal, d in (
            ("rel_padded", 16, 12, 249, 249, 160, rel_lens, False, 64),
            ("mask_only", 16, 12, 249, 249, 0, [249] * 12 + [200, 150, 99, 40], False, 64),
            ("vl0", 16, 12, 249, 249, 160, [249] * 12 + [0, 120, 0, 60], False, 64),
            ("cross_mask_only", 8, 12, 160, 500, 0, [500] * 6 + [430, 310], False, 64),
            ("rel_causal", 16, 12, 249, 249, 160, [249] * 14 + [200, 100], True, 64),
            ("rel_padded_d128", 16, 6, 249, 249, 160, rel_lens, False, 128),
            ("rel_l512", 2, 12, 600, 600, 512, [600, 555], False, 64),
            ("rel_l512_d128", 2, 6, 600, 600, 512, [600, 555], False, 128)):
        q = randn(b, h, tq, d)
        k, v = (randn(b, h, tk, d) for _ in range(2))
        pe = randn(2 * L, d) if L else None
        table = pe if L else torch.zeros(2, d, dtype=bf, device=dev)
        vl = torch.tensor(vls, dtype=torch.int32, device=dev)
        kw = dict(causal=causal, scale=1.0)

        def run():
            return fa.flash_rel_forward(q, k, v, pe, vl, **kw)

        before = dict(fa.flash_rel_forward.launches_by_form)
        rec = hold_b1(f"B1 bf16 {name}", q, k, v, pe, vl, **kw)
        form = fc.kernel_form(bf, d)
        check(form == "wgmma" and fa.flash_rel_forward.launches_by_form
              == {**before, form: before[form] + 1},
              f"B1 bf16 {name}: launches by form {fa.flash_rel_forward.launches_by_form}")
        nbytes, flops = b1_work(q, k, pe, vl, causal)
        bms, by = bound(nbytes, flops, products=True, bf16=True)
        ms = time_ms(run)
        dev_ms = kernel_device_ms(run, ("flash_rel_fwd",))["flash_rel_fwd"]
        rec.update(kernel="B1 bf16", case=name, form=form, shape=[b, h, tq, d], tk=tk,
                   two_l=2 * L or "mask-only", causal=causal, ms=ms, device_ms=dev_ms,
                   bound_ms=bms, bound_by=by, bound_share=bms / ms,
                   device_bound_share=bms / dev_ms, card=smi)
        if name in ("rel_padded", "mask_only", "vl0", "cross_mask_only"):   # phase 3's cases
            lib_ms = None
            if not L:
                keep = (torch.arange(tk, device=dev)[None, :] < vl[:, None])[:, None, None, :]
                lib_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=keep, scale=1.0))
            q32, k32, v32 = q.float(), k.float(), v.float()
            pe32 = None if pe is None else pe.float()
            rec.update(f32_ms=time_ms(lambda: fa.flash_rel_forward(q32, k32, v32, pe32, vl,
                                                                    **kw)),
                       plain_ms=time_ms(lambda: fa.flash_rel_forward_plain(q, k, v, table, vl,
                                                                           **kw)),
                       library_ms=lib_ms)
            del q32, k32, v32
        if name.startswith("rel_l512"):   # C4: the backward at the same L
            gg = randn(b, h, tq, d, sc=1.0)
            out, lse = fa.flash_rel_forward(q, k, v, pe, vl, **kw)
            before = dict(fa.flash_rel_backward.launches_by_form)
            rec["b34"] = hold_b34(f"B3/B4 bf16 {name}", q, k, v, pe, vl, out, lse, gg,
                                  mask_only=False, **kw)
            check(fa.flash_rel_backward.launches_by_form == {**before, form: before[form] + 1},
                  f"B3/B4 bf16 {name}: launches by form {fa.flash_rel_backward.launches_by_form}")
            rec["b34_device_ms"] = kernel_device_ms(
                lambda: fa.flash_rel_backward(q, k, v, pe, vl, out, lse, gg, **kw),
                ("flash_rel_bwd_dq", "flash_rel_bwd_dkv"))
            del gg, out, lse
        recs.setdefault("B1", rec)
        recs.setdefault("B1 cases", []).append(rec)
        print(f"[bf16] {json.dumps(rec)}")
        del q, k, v

    # B3/B4 at the encoder's training shape, two rows padded, and the
    # mask-only pair at the cross-attention's 160 label positions over 500
    # frames: both in the wgmma form (one launch of it each, counted)
    for name, tq, L in (("enc_padded", 500, 160), ("cross_mask_only", 160, 0)):
        mask_only = L == 0
        q, gg = randn(8, 12, tq, 64), randn(8, 12, tq, 64, sc=1.0)
        k, v = randn(8, 12, 500, 64), randn(8, 12, 500, 64)
        pe = torch.zeros(2, 64, dtype=bf, device=dev) if mask_only else randn(2 * L, 64)
        vl = torch.tensor([500] * 6 + [430, 310], dtype=torch.int32, device=dev)
        out, lse = fa.flash_rel_forward(q, k, v, None if mask_only else pe, vl, causal=False,
                                        scale=1.0)
        kw = dict(causal=False, scale=1.0, need_dpe=not mask_only, mask_only=mask_only)

        def run():
            return fa.flash_rel_backward(q, k, v, pe, vl, out, lse, gg, **kw)

        before = dict(fa.flash_rel_backward.launches_by_form)
        rec = hold_b34(f"B3/B4 bf16 {name}", q, k, v, pe, vl, out, lse, gg, causal=False,
                       scale=1.0, mask_only=mask_only)
        form = fc.kernel_form(bf, 64)
        check(form == "wgmma" and fa.flash_rel_backward.launches_by_form
              == {**before, form: before[form] + 1},
              f"B3/B4 bf16 {name}: launches by form {fa.flash_rel_backward.launches_by_form}")
        keep = (torch.arange(500, device=dev)[None, :] < vl[:, None])[:, None, None, :]
        sl = [x.detach().clone().requires_grad_() for x in (q, k, v)]

        def sdpa_fb():
            torch.autograd.grad(sdpa(*sl, attn_mask=keep, scale=1.0), sl, gg)

        with torch.no_grad():
            sdpa_f_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=keep, scale=1.0))
        q32, k32, v32, g32, pe32 = (x.float() for x in (q, k, v, gg, pe))
        out32, lse32 = fa.flash_rel_forward(q32, k32, v32, None if mask_only else pe32, vl,
                                            causal=False, scale=1.0)
        pair = ("flash_rel_bwd_dq", "flash_rel_bwd_dkv")
        split = kernel_device_ms(run, pair)
        split32 = kernel_device_ms(lambda: fa.flash_rel_backward(
            q32, k32, v32, pe32, vl, out32, lse32, g32, **kw), pair)
        (b3b, b3f), (b4b, b4f) = b34_work(q, k, pe, vl, False, mask_only)
        ms = time_ms(run)
        b34 = dict(kernel="B3/B4 bf16", case=name, form=form, shape=[8, 12, tq, 64], tk=500,
                   two_l=2 * L or "mask-only", **rec, ms=ms, b3_ms=split[pair[0]],
                   b4_ms=split[pair[1]], b3_f32_ms=split32[pair[0]],
                   b4_f32_ms=split32[pair[1]],
                   plain_ms=time_ms(lambda: fa.flash_rel_backward_plain(
                       q, k, v, pe, vl, out, lse, gg, causal=False, scale=1.0)),
                   library_ms=time_ms(sdpa_fb) - sdpa_f_ms,
                   b3_bound=bound(b3b, b3f, products=True, bf16=True),
                   b4_bound=bound(b4b, b4f, products=True, bf16=True), card=smi)
        recs["B3/B4" if name == "enc_padded" else "B3/B4 mask-only"] = b34
        print(f"[bf16] {json.dumps(b34)}")
        del q, k, v, gg, out, sl, q32, k32, v32, g32, out32

    # B5 at [8, 25, 1024, 64] causal, B6 on [8, 1024, 12, 64] qkv views
    for kern in ("B5", "B6"):
        if kern == "B5":
            q, k, v = (randn(8, 25, 1024, 64, sc=0.5) for _ in range(3))
            fn, plain_fn = fc.flash_forward, fc.flash_forward_plain
            qs, ks, vs = q, k, v
            h = 25
        else:
            x = randn(8, 1024, 3 * 768, sc=0.5)
            q, k, v = (y.reshape(8, 1024, 12, 64) for y in x.split(768, dim=-1))
            fn, plain_fn = fc.flash_forward_nhd, fc.flash_forward_nhd_plain
            qs, ks, vs = (y.transpose(1, 2) for y in (q, k, v))
            h = 12
        kw = dict(causal=True, scale=0.125)
        rec = hold_b5(f"{kern} bf16", q, k, v, nhd=kern == "B6", **kw)
        nbytes, flops = causal_work(8, h, 1024, 1024, 64, True, elem=2)
        bms, by = bound(nbytes, flops, products=True, bf16=True)
        f32 = [y.float() for y in (q, k, v)]
        if kern == "B6":   # the f32 form on views of one f32 projection, as scoring reads it
            x32 = x.float()
            f32 = [y.reshape(8, 1024, 12, 64) for y in x32.split(768, dim=-1)]
        ms = time_ms(lambda: fn(q, k, v, **kw))
        dev_ms = kernel_device_ms(lambda: fn(q, k, v, **kw), ("flash_causal_fwd_wgmma",))
        rec.update(kernel=f"{kern} bf16", case="causal_1024", shape_bhtd=[8, h, 1024, 64],
                   form=fc.kernel_form(bf, 64), ms=ms,
                   device_ms=dev_ms["flash_causal_fwd_wgmma"],
                   f32_ms=time_ms(lambda: fn(*f32, **kw)),
                   plain_ms=time_ms(lambda: plain_fn(q, k, v, **kw), reps=5, inner=2),
                   library_ms=time_ms(lambda: sdpa(qs, ks, vs, is_causal=True, scale=0.125)),
                   bound_ms=bms, bound_by=by, bound_share=bms / ms,
                   device_bound_share=bms / dev_ms["flash_causal_fwd_wgmma"], card=smi)
        recs[kern] = rec
        print(f"[bf16] {json.dumps(rec)}")
        del q, k, v, qs, ks, vs, f32

    # B2 in its bf16 form ("mma_sync") at the B2_CASES shapes, at the
    # conversation-length row of a sequence-parallel step and at 200
    # channels, each held against its plain version; f32, plain and conv1d
    # beside the main shape's
    b2_cases = []
    for name, b, t in B2_CASES + (("conversation", 1, 2624080),):
        b2_cases += [(name, b, t, 512)] + ([("c200", 4, 64000, 200)] if name == "pipeline" else [])
    for name, b, t, c in b2_cases:
        wav = randn(b, t, sc=0.1)
        w, sc_, bi = randn(c, 1, 10), randn(c, sc=0.2) + 1.0, randn(c, sc=0.1)

        def run():
            return cf.conv1_instance_norm_gelu(wav, w, sc_, bi)

        before = dict(cf.conv1_instance_norm_gelu.launches_by_form)
        rec = hold_b2(f"B2 bf16 {name}", wav, w, sc_, bi)
        now = cf.conv1_instance_norm_gelu.launches_by_form
        check(now["mma_sync"] == before["mma_sync"] + 1 and now["ffma"] == before["ffma"],
              f"B2 bf16 {name}: forms {before} -> {now}")
        f = (t - 10) // 5 + 1
        nbytes, flops = b2_work(wav, c, 10, f)
        bms, by = bound(nbytes, flops)
        ms = time_ms(run)
        split = kernel_device_ms(run, ("conv_stats", "conv_out_mma"), optional=("Memset",))
        dev_ms = sum(split.values())
        rec.update(kernel="B2 bf16", case=name, shape=[b, t], channels=c,
                   form=cf.kernel_form(bf), ms=ms, device_ms=dev_ms, device_ms_by_launch=split,
                   bound_ms=bms, bound_by=by, bound_share=bms / ms,
                   device_bound_share=bms / dev_ms, card=smi)
        if name == "main":
            f32 = [t_.float() for t_ in (wav, w, sc_, bi)]
            rec.update(f32_ms=time_ms(lambda: cf.conv1_instance_norm_gelu(*f32)),
                       plain_ms=time_ms(lambda: cf.conv1_instance_norm_gelu_plain(wav, w, sc_,
                                                                                 bi)),
                       library_ms=None, partial_library_ms=time_ms(
                           lambda: F.conv1d(wav[:, None], w, stride=5)))
            recs["B2"] = rec
            del f32
        else:
            recs["B2"].setdefault("cases", []).append(rec)
        print(f"[bf16] {json.dumps(rec)}")
        del wav

    # (b) the full-width ASR step under the JAX README's realistic
    # fine-tuning flags: bf16 compute, frozen feature encoder, flash.  The
    # kernel launches of its kernel path are captured and each replayed
    # against its plain version; every gradient is held to the f32 step's
    cfg = SpeechT5Config(vocab_size=256)
    quiet = dataclasses.replace(cfg, positional_dropout=0.0, hidden_dropout=0.0,
                                attention_dropout=0.0, activation_dropout=0.0,
                                apply_spec_augment=False)

    def to_dev(hb):
        return {k: torch.as_tensor(hb[k], device=dev)
                for k in ("input_values", "attention_mask", "labels")}

    b0 = to_dev(host_batches[0])
    model = st5.asr_model_init(quiet, seed=0, device=dev).train()
    runs = {}
    for name, impl, dtype in (("flash_bf16", "flash", bf), ("dense_bf16", "dense", bf),
                              ("flash_f32", "flash", None)):
        tx = train.adamw(0.0, weight_decay=0.0)            # rate 0: the weights stay
        opt = tx.init(train.trainable_params(model, True))
        step = train.make_asr_train_step(quiet, tx, attn_impl=impl, freeze_feature_encoder=True,
                                         compute_dtype=dtype)
        with counted_forms() as tally, captured_launches() as cases:
            reset()
            m = step(model, opt, b0)
            torch.cuda.synchronize()
            launched = counts()
            if name == "flash_bf16":
                asr_forms = by_form()
        grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
        runs[name] = (m["loss"].item(), m["grad_norm"].item(), launched, dict(tally), grads,
                      dict(cases))
        check(all(p.dtype == torch.float32 for p in model.parameters()), "master weights not f32")
        check(all(t.dtype == torch.float32 for t in opt["mu"].values()), "Adam state not f32")
        del opt, cases
    (l16, g16, c16, f16, gr16, cap16), (ld, gd, cd, _, grd, _), (l32, g32_, _, _, gr32, _) = (
        runs["flash_bf16"], runs["dense_bf16"], runs["flash_f32"])
    check(np.isfinite(l16) and np.isfinite(g16), f"bf16 step: loss {l16}, grad_norm {g16}")
    check(abs(l16 - ld) <= BF16_STEP_RTOL * abs(ld), f"bf16 step: flash {l16} dense {ld}")
    check(abs(l16 - l32) <= MP_LOSS_RTOL * abs(l32), f"bf16 step {l16} vs f32 {l32}")
    check(abs(g16 - g32_) <= MP_GNORM_REL * g32_, f"bf16 grad_norm {g16} vs f32 {g32_}")
    n_enc, n_dec = cfg.encoder_layers, cfg.decoder_layers
    want = {"B1": n_enc + n_dec, "B2": 1, "B3/B4": n_enc + n_dec, "B5": n_dec,
            "B5_bwd": n_dec, "B6": 0}
    check(c16 == want, f"bf16 step launched {c16}, expected {want}")
    want_forms = {"flash_rel_forward:bf16": n_enc + n_dec, "conv_frontend:bf16": 1,
                  "flash_rel_backward:bf16": n_enc + n_dec, "flash_forward:bf16": n_dec}
    check(f16 == want_forms, f"bf16 step forms {f16}, expected {want_forms}")
    # every B1, B5 and B3/B4 launch at head dim 64 in bf16 takes the wgmma form
    check(asr_forms["B1"] == {"mma_sync": 0, "wgmma": n_enc + n_dec},
          f"bf16 step B1 forms {asr_forms['B1']}")
    check(asr_forms["B5"] == {"mma_sync": 0, "wgmma": n_dec},
          f"bf16 step B5 forms {asr_forms['B5']}")
    check(asr_forms["B3/B4"] == {"mma_sync": 0, "wgmma": n_enc + n_dec},
          f"bf16 step B3/B4 forms {asr_forms['B3/B4']}")
    # and its one B2 launch the bf16 form on the tensor cores
    check(asr_forms["B2"] == {"ffma": 0, "mma_sync": 1}, f"bf16 step B2 forms {asr_forms['B2']}")
    check(all(v == 0 for v in cd.values()), f"dense bf16 launched {cd}")
    # every captured form: B1 with the band (encoder) and mask-only over
    # Tq != Tk (the decoder's cross-attention), their B3/B4, B5 (decoder), B2
    check(sorted({(key[0], key[1]) if key[0] in ("B1", "B3/B4") else (key[0],) for key in cap16})
          == [("B1", "band"), ("B1", "mask-only"), ("B2",), ("B3/B4", "band"),
              ("B3/B4", "mask-only"), ("B5",)], f"captured {sorted(cap16)}")
    step_holds = hold_captured(cap16)
    for r in step_holds:
        print(f"[bf16_step_kernels] {json.dumps(r)}")
    leaf_rec = grads_by_leaf(gr16, grd, gr32, "bf16 step")
    step_launches = c16
    del model, runs, gr16, grd, gr32, cap16
    tput = {}
    for name, dtype, mu in (("bf16", bf, bf), ("f32", None, None)):
        model = st5.asr_model_init(cfg, seed=0, device=dev)
        tx = train.adamw(1e-4, mu_dtype=mu)
        opt = tx.init(train.trainable_params(model, True))
        step = train.make_asr_train_step(cfg, tx, attn_impl="flash", freeze_feature_encoder=True,
                                         compute_dtype=dtype)
        gen = torch.Generator(device=dev).manual_seed(0)
        batches = [to_dev(hb) for hb in host_batches[1:14]]
        torch.cuda.reset_peak_memory_stats()
        step_ms, losses, audio_s = [], [], 0.0
        for i, bt in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(step(model, opt, bt, gen)["loss"].item())
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if i >= 3:
                audio_s += bt["attention_mask"].sum().item() / 16000.0
        check(all(np.isfinite(losses)), f"{name} training losses {losses}")
        prof = device_breakdown(lambda: step(model, opt, batches[0], gen))
        cast_ms = None
        if dtype is not None:   # the host's share: the parameter and batch casts alone
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                train.cast_compute(model, batches[0], dtype)
            torch.cuda.synchronize()
            cast_ms = (time.perf_counter() - t0) * 1e3 / 10
        tput[name] = dict(median_step_ms=statistics.median(step_ms[3:]),
                          audio_s_per_wall_s=audio_s / (sum(step_ms[3:]) / 1e3),
                          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                          busy_share=prof["busy_share"], device_ms=prof["kernel_ms_sum"],
                          kernels=prof["kernels"], device_groups_ms=prof["groups_ms"],
                          top_kernels=prof["top_kernels"][:4], cast_compute_ms=cast_ms,
                          losses=losses)
        del model, opt, batches
    print(f"[bf16_train] {json.dumps(dict(step=dict(loss_flash_bf16=l16, loss_dense_bf16=ld, loss_flash_f32=l32, grad_norm_bf16=g16, grad_norm_f32=g32_, grads_by_leaf=leaf_rec, launches=c16, forms=f16), throughput=tput, card=smi))}")
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "asr")
        flags = ["--train_dir", corpus["train"], "--dev_dir", corpus["dev"],
                 "--out_dir", out_dir, "--attn_impl", "flash", "--compute_dtype", "bfloat16",
                 "--freeze_feature_encoder", "--opt_mu_dtype", "bfloat16",
                 "--conversation_seconds", "10", "--batch_size", "8",
                 "--save_every", "4", "--eval_every", "8", "--eval_batches", "2"]
        with counted_forms() as tally:
            t0 = time.perf_counter()
            check(train_asr.main([*flags, "--steps", "8"]) == 0, "bf16 train_asr failed")
            wall = time.perf_counter() - t0
            check(train_asr.main([*flags, "--steps", "12", "--resume"]) == 0,
                  "bf16 train_asr --resume failed")
        ckpt = os.path.join(out_dir, "ckpt")
        with np.load(os.path.join(ckpt, "step_12.npz")) as z:
            check(int(z["opt_state.count"]) == 12, "bf16 resume: optimizer count")
            mu = {z[k].dtype for k in z.files if k.startswith("opt_state.mu.")}
            par = {z[k].dtype for k in z.files if k.startswith("params.")}
        check(mu == {np.dtype("V2")} and par == {np.dtype(np.float32)},
              f"bf16 checkpoint: mu {mu}, params {par}")
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            evals = [json.loads(line) for line in f if "dev_wer" in line]
        check(evals and all(np.isfinite(r["dev_loss"]) for r in evals), f"dev metrics {evals}")
        check(tally.get("flash_rel_backward:bf16", 0) == 12 * (n_enc + n_dec),
              f"train_asr bf16 forms {tally}")
        print(f"[bf16_train_asr] {json.dumps(dict(wall_s=wall, forms=tally, dev=evals[-1]))}")

    # (c) the gpt2-width LM step in bf16, train_lm and eval_ppl
    lcfg = dataclasses.replace(gm.PRESETS["gpt2"], vocab_size=256, embd_pdrop=0.0,
                               attn_pdrop=0.0, resid_pdrop=0.0)
    rng = np.random.default_rng(16)
    B, T = 8, 1024

    def make_batch():
        lengths = rng.integers(T // 2, T + 1, B)
        lengths[0] = T
        return {"ids": torch.as_tensor(rng.integers(0, 256, (B, T)), device=dev),
                "lengths": torch.as_tensor(lengths, device=dev)}

    lm = gm.gpt2_init(lcfg, seed=0, device=dev)
    batch = make_batch()
    lruns = {}
    for name, dtype in (("bf16", bf), ("f32", None)):
        tx = train.adamw(0.0, weight_decay=0.0)
        opt = tx.init(dict(lm.named_parameters()))
        step = train.make_lm_train_step(lcfg, tx, attn_impl="flash", compute_dtype=dtype)
        with counted_forms() as tally, captured_launches() as cases:
            reset()
            m = step(lm, opt, batch)
            torch.cuda.synchronize()
            lruns[name] = (m["loss"].item(), m["grad_norm"].item(), counts(), dict(tally),
                           by_form(), dict(cases))
        del opt, cases
    (ll16, lg16, lc16, lf16, lm_forms, lcap), (ll32, lg32, *_) = lruns["bf16"], lruns["f32"]
    check(lm_forms["B6"] == {"mma_sync": 0, "wgmma": lcfg.n_layer},
          f"bf16 LM step B6 forms {lm_forms['B6']}")
    check(sorted(key[0] for key in lcap) == ["B6"], f"LM step captured {sorted(lcap)}")
    lm_holds = hold_captured(lcap)
    for r in lm_holds:
        print(f"[bf16_step_kernels] {json.dumps(r)}")
    step_holds += lm_holds
    del lruns, lcap
    check(abs(ll16 - ll32) <= MP_LOSS_RTOL * abs(ll32), f"LM bf16 loss {ll16} vs f32 {ll32}")
    want = {"B1": 0, "B2": 0, "B3/B4": 0, "B5": 0, "B5_bwd": lcfg.n_layer, "B6": lcfg.n_layer}
    check(lc16 == want, f"bf16 LM step launched {lc16}, expected {want}")
    check(lf16 == {"flash_forward_nhd:bf16": lcfg.n_layer}, f"bf16 LM step forms {lf16}")
    lm_step_launches = lc16
    ltput = {}
    for name, dtype, mu in (("bf16", bf, bf), ("f32", None, None)):
        tx = train.adamw(3e-4, mu_dtype=mu)
        opt = tx.init(dict(lm.named_parameters()))
        step = train.make_lm_train_step(lcfg, tx, attn_impl="flash", compute_dtype=dtype)
        batches = [make_batch() for _ in range(8)]
        torch.cuda.reset_peak_memory_stats()
        step_ms = []
        for bt in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            check(np.isfinite(step(lm, opt, bt)["loss"].item()), f"LM {name} loss")
            step_ms.append((time.perf_counter() - t0) * 1e3)
        med = statistics.median(step_ms[3:])
        ltput[name] = dict(median_step_ms=med, tokens_per_s=B * T / (med / 1e3),
                           peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        del opt, batches
    del lm
    print(f"[bf16_lm] {json.dumps(dict(loss_bf16=ll16, loss_f32=ll32, grad_norm_bf16=lg16, grad_norm_f32=lg32, launches=lc16, forms=lf16, b6_by_form=lm_forms['B6'], throughput=ltput, card=smi))}")
    lm_corpus = os.path.join(ROOT, "exp", "loco", "lm_corpus")
    train_txt, dev_txt = (os.path.join(lm_corpus, f) for f in ("train.txt", "dev.txt"))
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "lm")
        before = fc.flash_forward_nhd.launches_by_form["wgmma"]
        with counted_forms() as tally:
            rc = train_lm.main(["--train_file", train_txt, "--dev_file", dev_txt,
                                "--out_dir", out_dir, "--model", "gpt2", "--tokenizer", "char",
                                "--attn_impl", "flash", "--compute_dtype", "bfloat16",
                                "--opt_mu_dtype", "bfloat16", "--seq_len", str(T),
                                "--batch_size", "8", "--steps", "10", "--warmup_steps", "2",
                                "--eval_every", "1000", "--save_every", "1000",
                                "--log_every", "5"])
        check(rc == 0 and tally.get("flash_forward_nhd:bf16", 0) == 10 * lcfg.n_layer,
              f"bf16 train_lm: rc {rc}, forms {tally}")
        train_lm_wgmma = fc.flash_forward_nhd.launches_by_form["wgmma"] - before
        check(train_lm_wgmma == 10 * lcfg.n_layer, f"bf16 train_lm: {train_lm_wgmma} wgmma")
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            lm_metrics = [json.loads(line) for line in f]
        check(all(np.isfinite(r.get("loss", 0.0)) for r in lm_metrics), f"train_lm {lm_metrics}")
        nlls = {}
        for name, extra in (("f32", []), ("bf16", ["--compute_dtype", "bfloat16"])):
            ppl_dir = os.path.join(tmp, f"ppl_{name}")
            reset()
            with counted_forms() as ptally:
                rc = eval_ppl.main(["-i", dev_txt, "-o", ppl_dir, "--model", "gpt2",
                                    "--tokenizer", "char", "--checkpoint",
                                    os.path.join(out_dir, "ckpt"), "--context_type", "max_len",
                                    "--bsize", "8", "--attn_impl", "flash", *extra])
            check(rc == 0, f"eval_ppl {name} returned {rc}")
            with open(os.path.join(ppl_dir, "rec_id2nlls.pkl"), "rb") as f:
                nlls[name] = (pickle.load(f), dict(ptally), by_form()["B6"])
        (n32, _, _), (n16, t16, ppl_forms) = nlls["f32"], nlls["bf16"]
        check(ppl_forms["mma_sync"] == 0 and ppl_forms["wgmma"] == t16.get(
            "flash_forward_nhd:bf16", -1) > 0, f"eval_ppl bf16 B6 forms {ppl_forms}")
        check(list(n16) == list(n32), "eval_ppl bf16: recordings differ")
        d = np.concatenate([np.abs(np.asarray(n16[r]) - np.asarray(n32[r])) for r in n32])
        check(d.mean() < BF16_NLL_DELTA, f"eval_ppl bf16: mean |d NLL| {d.mean()}")
        check(set(t16) == {"flash_forward_nhd:bf16"}, f"eval_ppl bf16 forms {t16}")
        print(f"[bf16_lm_pipelines] {json.dumps(dict(train_lm_forms=tally, train_lm=lm_metrics[-1], eval_ppl_mean_abs_dnll=float(d.mean()), eval_ppl_max_abs_dnll=float(d.max()), eval_ppl_forms=t16, eval_ppl_b6_by_form=ppl_forms, train_lm_wgmma=train_lm_wgmma))}")

    # (d) extract_embeddings -m audio --dtype bfloat16: the weights cast, the
    # waveform not, so the encoder runs in f32 (B1 and B2 in their f32 forms)
    with tempfile.TemporaryDirectory() as tmp:
        write_slurp(tmp, 8, seed=14)
        stores = {}
        for device in ("cuda", "cpu"):
            with counted_forms() as tally:
                rc = extract_embeddings.main(["-m", "audio", "-s", "train", "--data_path", tmp,
                                              "--out_dir", os.path.join(tmp, device),
                                              "--batch_size", "8", "--dtype", "bfloat16",
                                              "--device", device])
            check(rc == 0, f"extract_embeddings --dtype bfloat16 on {device}: {rc}")
            stores[device] = (extract_store(os.path.join(tmp, device)), dict(tally))
        (gpu, forms), (cpu, _) = stores["cuda"], stores["cpu"]
        check(forms == {"flash_rel_forward:f32": cfg.encoder_layers, "conv_frontend:f32": 1},
              f"bf16 extraction forms {forms}")
        diffs = [np.abs(a - b) for a, b in zip(gpu, cpu, strict=True)]
        mx, mean = max(x.max() for x in diffs), np.mean([x.mean() for x in diffs])
        check(all(a.dtype == np.float32 for a in gpu), "bf16 extraction: not float32")
        check(mx <= ENC_MAX_TOL and mean <= ENC_MEAN_TOL,
              f"bf16 extraction: card vs CPU max {mx} mean {mean}")
        print(f"[bf16_extract] {json.dumps(dict(forms=forms, max_abs_diff=float(mx), mean_abs_diff=float(mean)))}")
    print(f"[bf16] phase wall s {time.perf_counter() - t_phase:.1f}")
    return dict(recs=recs, asr_step=step_launches, lm_step=lm_step_launches,
                asr_forms=asr_forms, lm_forms=lm_forms, eval_ppl_forms=ppl_forms,
                step_kernels=step_holds)


# the bf16 forms in the kernels line: (name, phase 16's record, launches
# key, source, the TPU kernel's line); B1, B3/B4, B5 and B6 at head dim 64
# are the wgmma form's, B2 the mma_sync form's, their launches its own count
BF16_FORMS = (
    ("flash_rel_forward (bf16, wgmma)", "B1", ("asr_forms", "B1"), "flash_rel.cu", 518),
    ("conv1_instance_norm_gelu (bf16, mma_sync)", "B2", ("asr_forms", "B2"), "conv_frontend.cu",
     None),
    ("flash_rel_backward (B3, bf16, wgmma)", "B3", ("asr_forms", "B3/B4"), "flash_rel_bwd.cu",
     799),
    ("flash_rel_backward (B4, bf16, wgmma)", "B4", ("asr_forms", "B3/B4"), "flash_rel_bwd.cu",
     902),
    ("flash_forward (bf16, wgmma)", "B5", ("asr_forms", "B5"), "flash_causal.cu", 40),
    ("flash_forward_nhd (bf16, wgmma)", "B6", ("lm_forms", "B6"), "flash_causal.cu", 168),
)


def bf16_entries(mixed: dict) -> list:
    """The kernels line's entries of the bf16 forms: phase 16's records,
    and the launches of its main paths (the full-width ASR step for B1-B5,
    the gpt2-width LM step for B6)."""
    out = []
    for name, kern, (path, key), src, line in BF16_FORMS:
        rec = mixed["recs"]["B3/B4" if kern in ("B3", "B4") else kern]
        replaces = ("loco_asr_tpu/ops/pallas/conv_frontend.py:56" if kern == "B2"
                    else f"loco_asr_tpu/ops/pallas/flash_attention.py:{line}")
        launches = mixed[path][key]
        if isinstance(launches, dict):   # by form
            launches = launches[rec["form"]]
        e = dict(name=name, route="cuda", source=f"loco_asr_tpu_torch/csrc/{src}",
                 replaces=replaces, launches=launches, max_abs_err=rec["max_abs_err"],
                 ms=rec["ms"], plain_ms=rec["plain_ms"], library_ms=rec["library_ms"])
        e["form"] = rec["form"]
        step = [r["max_abs_err"] for r in mixed["step_kernels"]
                if r["kernel"] == ("B3/B4" if kern in ("B3", "B4") else kern)]
        if step:   # the same form replayed on the ASR step's own inputs
            e["step_max_abs_err"] = max(step)
        if kern in ("B3", "B4"):
            # its own device time; the wrapper's CUDA-event time beside it;
            # the mask-only pair at the cross-attention's shape
            which = kern.lower()
            e.update(ms=rec[f"{which}_ms"], device_ms=rec[f"{which}_ms"], wrapper_ms=rec["ms"],
                     f32_ms=rec[f"{which}_f32_ms"])
            e["bound_ms"], e["bound_by"] = rec[f"{which}_bound"]
            mo = mixed["recs"]["B3/B4 mask-only"]
            e["mask_only"] = dict(shape=mo["shape"], tk=mo["tk"], device_ms=mo[f"{which}_ms"],
                                  wrapper_ms=mo["ms"], f32_ms=mo[f"{which}_f32_ms"],
                                  bound_ms=mo[f"{which}_bound"][0],
                                  bound_by=mo[f"{which}_bound"][1], plain_ms=mo["plain_ms"],
                                  library_ms=mo["library_ms"], max_abs_err=mo["max_abs_err"])
        else:
            e.update(device_ms=rec["device_ms"], f32_ms=rec["f32_ms"], bound_ms=rec["bound_ms"],
                     bound_by=rec["bound_by"])
        out.append(e)
    return out


# ---- phase 17: conversation-scale ASR training ----------------------------

LONG_SECONDS = 164          # the JAX README's long-context recipe: B = 1 x 164 s
LONG_LABELS = 2048
POLICIES = ("none", "full", "dots", "hybrid", "lite")
# remat against none, the JAX test's limits (tests/test_remat_policies.py)
REMAT_LOSS_RTOL, REMAT_GRAD_RTOL, REMAT_GRAD_ATOL = 1e-6, 1e-5, 1e-6
# the LoCo experiment's ASR model (loco_experiment.py): train_asr --tiny
# (hidden 32, 4 heads of 8) with this conv front end
LOCO_CONV = {"conv_dim": [64, 64, 64], "conv_stride": [5, 4, 2],
             "conv_kernel": [10, 8, 4], "max_speech_positions": 2048}


@contextlib.contextmanager
def launches_by_head_dim():
    """Kernel launches by ``kernel:head dim:form`` while the block runs: the
    launch paths of B1, B3/B4 and B5/B6 are wrapped for the block (the
    head dim is the caller's, before any padding)."""
    import torch

    from loco_asr_tpu_torch.ops.cuda import flash_attention as fa
    from loco_asr_tpu_torch.ops.cuda import flash_causal as fc

    real = (fa._launch_forward, fa._launch_backward, fc._launch)
    tally: dict = {}

    def count(kern, q):
        key = f"{kern}:d{q.shape[-1]}:{'bf16' if q.dtype is torch.bfloat16 else 'f32'}"
        tally[key] = tally.get(key, 0) + 1

    def b1(q, *a, **kw):
        count("B1", q)
        return real[0](q, *a, **kw)

    def b34(q, *a, **kw):
        count("B3/B4", q)
        return real[1](q, *a, **kw)

    def b5(q, *a, t_axis, **kw):
        count("B5" if t_axis == 2 else "B6", q)
        return real[2](q, *a, t_axis=t_axis, **kw)

    fa._launch_forward, fa._launch_backward, fc._launch = b1, b34, b5
    try:
        yield tally
    finally:
        fa._launch_forward, fa._launch_backward, fc._launch = real


def conv_frames(samples: int, cfg) -> int:
    """Frames of the speech prenet's conv stack for ``samples`` samples."""
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        samples = (samples - k) // s + 1
    return samples


def kernel_counts() -> dict:
    from loco_asr_tpu_torch.ops.cuda import conv_frontend as cf
    from loco_asr_tpu_torch.ops.cuda import flash_attention as fa
    from loco_asr_tpu_torch.ops.cuda import flash_causal as fc

    return {"B1": fa.flash_rel_forward.launches, "B2": cf.conv1_instance_norm_gelu.launches,
            "B3/B4": fa.flash_rel_backward.launches, "B5": fc.flash_forward.launches,
            "B5_bwd": fc.flash_backward.launches}


def rel_bwd_reference(q, k, v, pe, vl, out, lse, gg, causal, scale, mask_only):
    """The plain B3 + B4 with the band's matmuls: (dq, dk, dv, dpe or None),
    as ``flash_rel_backward`` returns them."""
    import torch

    from loco_asr_tpu_torch.ops.cuda import flash_attention as fa

    dq, dk, dv, dqpe = fa.flash_rel_backward_plain(q, k, v, pe, vl, out, lse, gg,
                                                   causal=causal, scale=scale)
    if mask_only:
        return dq, dk, dv, None
    return (dq + (dqpe @ pe.float()) * scale, dk, dv,
            torch.einsum("bhim,bhid->md", dqpe, q.float()) * scale)


def b34_dims_cases(b34_recs: list, smi: str, dev) -> list:
    """Phase 17 (a): B3 + B4 at head dims 8, 16, 32, 128 and 12 (padded to
    16), f32 and bf16, rel band and mask-only, each against its plain
    version (f32: dq, dk, dv within B34_TOL, dpe relative to its max; bf16:
    :func:`hold_b34`), with each kernel's device time, the wrapper's
    CUDA-event time, the plain version's, SDPA's backward for the mask-only
    cases, the bounds and each kernel's registers and spill."""
    import torch
    import torch.nn.functional as F

    from loco_asr_tpu_torch.ops.cuda import flash_attention as fa
    from loco_asr_tpu_torch.ops.cuda import flash_causal as fc

    g = torch.Generator().manual_seed(17)
    sdpa = F.scaled_dot_product_attention
    # (D, B, H, T, L): the LoCo encoder's widths at D = 8, the encoder's
    # training length at 16-128, tiny_config's D = 12 (padded)
    cases = [(8, 8, 4, 398, 20), (16, 8, 8, 500, 160), (32, 8, 8, 500, 160),
             (128, 8, 6, 500, 160), (12, 8, 4, 398, 20)]
    recs = []
    for d, b, h, t, L in cases:
        kd = fc.kernel_head_dim(d, "b34_dims")
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype is torch.bfloat16

            def randn(*shape, sc=0.3):
                return (torch.randn(*shape, generator=g) * sc).to(dev, dtype)

            for mask_only in (False, True):
                q, k, v, gg = randn(b, h, t, d), randn(b, h, t, d), randn(b, h, t, d), \
                    randn(b, h, t, d, sc=1.0)
                pe = torch.zeros(2, d, device=dev, dtype=dtype) if mask_only else randn(2 * L, d)
                vl = torch.tensor([t] * (b - 2) + [t - 70, t - 190], dtype=torch.int32,
                                  device=dev)
                out, lse = fa.flash_rel_forward(q, k, v, None if mask_only else pe, vl,
                                                causal=False, scale=1.0)
                kw = dict(causal=False, scale=1.0, need_dpe=not mask_only, mask_only=mask_only)

                def run():
                    return fa.flash_rel_backward(q, k, v, pe, vl, out, lse, gg, **kw)

                def plain():
                    return rel_bwd_reference(q, k, v, pe, vl, out, lse, gg, False, 1.0,
                                             mask_only)

                name = f"d{d}_{'bf16' if bf16 else 'f32'}_{'mask_only' if mask_only else 'band'}"
                form = fc.kernel_form(dtype, kd)   # wgmma: bf16 at kernel head dims 64, 128
                before = dict(fa.flash_rel_backward.launches_by_form)
                got = run()
                torch.cuda.synchronize()
                check(fa.flash_rel_backward.launches_by_form == {**before, form: before[form] + 1},
                      f"B3/B4 {name}: launches by form {fa.flash_rel_backward.launches_by_form}")
                check(all(x.shape == q.shape for x in got[:3]), f"B3/B4 {name}: shapes")
                if bf16:
                    held = hold_b34(f"B3/B4 {name}", q, k, v, pe, vl, out, lse, gg,
                                    causal=False, scale=1.0, mask_only=mask_only)
                    err, errs, tol = held["max_abs_err"], held["errs"], "2^-7 max|plain|"
                else:
                    want = plain()
                    errs = {n: (a - w).abs().max().item()
                            for n, a, w in zip("q k v".split(), got, want)}
                    if not mask_only:
                        errs["pe"] = ((got[3] - want[3]).abs().max().item()
                                      / want[3].abs().max().item())
                    check(all(bool(torch.isfinite(x).all()) for x in got if x is not None),
                          f"B3/B4 {name}: non-finite gradient")
                    err, tol = max(errs.values()), B34_TOL
                    check(err <= B34_TOL, f"B3/B4 {name}: errors {errs} > {B34_TOL} "
                                          "(dpe relative to its max)")
                split = kernel_device_ms(run, ("flash_rel_bwd_dq", "flash_rel_bwd_dkv"))
                (b3b, b3f), (b4b, b4f) = b34_work(q, k, pe, vl, False, mask_only)
                lib_ms = None
                if mask_only:
                    keep = (torch.arange(t, device=dev)[None, :] < vl[:, None])[:, None, None, :]
                    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]

                    def fb():
                        o = sdpa(*leaves, attn_mask=keep, scale=1.0)
                        torch.autograd.grad(o, leaves, gg)

                    def f():
                        with torch.no_grad():
                            sdpa(q, k, v, attn_mask=keep, scale=1.0)
                    lib_ms = time_ms(fb, reps=5) - time_ms(f, reps=5)
                build = {r["kernel"]: {x: r.get(x) for x in ("registers", "spill_stores",
                                                            "spill_loads", "blocks_per_sm_l160",
                                                            "smem_bytes_l160")}
                         for r in b34_recs if r["head_dim"] == kd and r["mask_only"] == mask_only
                         and r["dtype"] == ("bfloat16" if bf16 else "float32")
                         and r["form"] == form}
                rec = dict(kernel="B3/B4", case=name, form=form, head_dim=d, kernel_head_dim=kd,
                           dtype=str(dtype).split(".")[-1], mask_only=mask_only,
                           shape=[b, h, t, d], two_l="mask-only" if mask_only else 2 * L,
                           max_abs_err=err, errs=errs, tol=tol, ms=time_ms(run, reps=5),
                           plain_ms=time_ms(plain, reps=3, inner=2), library_ms=lib_ms,
                           b3_ms=split["flash_rel_bwd_dq"], b4_ms=split["flash_rel_bwd_dkv"],
                           b3_bound=bound(b3b, b3f, products=True, bf16=bf16),
                           b4_bound=bound(b4b, b4f, products=True, bf16=bf16),
                           build=build, card=smi)
                recs.append(rec)
                print(f"[long] b34 {json.dumps(rec)}")
                del q, k, v, gg, out, got
    return recs


def long_corpus(train_dir: str, dst: str, seconds: float = 330.0) -> str:
    """A Kaldi dir of recording-channels of >= ``seconds`` of audio each:
    the committed train utterances, cropped by their segments, concatenated
    in order (16-bit PCM, 16 kHz), with their transcripts and new segments
    and timestamped utterance ids."""
    from loco_asr_tpu_torch.data.asr_dataset import KaldiAsrDataset

    ds = KaldiAsrDataset(train_dir)
    os.makedirs(dst)
    recs, cur = [], []
    for ex in ds.examples:
        cur.append(ex)
        if sum(e.end - e.start for e in cur) >= seconds:
            recs.append(cur)
            cur = []
    if cur:
        recs[-1].extend(cur)
    text, segs, scp = [], [], []
    for r, exs in enumerate(recs):
        reco = f"long{r:03d}-A"
        parts, t = [], 0
        for ex in exs:
            wav = ds.load_waveform(ex)
            a, z = t / 16000.0, (t + len(wav)) / 16000.0
            utt = f"{reco}-{int(a * 100):06d}-{int(z * 100):06d}"
            text.append(f"{utt} {ex.text}")
            segs.append(f"{utt} {reco} {a:.4f} {z:.4f}")
            parts.append(wav)
            t += len(wav)
        path = os.path.join(dst, f"{reco}.wav")
        pcm = np.clip(np.round(np.concatenate(parts) * 32768.0), -32768, 32767).astype(np.int16)
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(pcm.tobytes())
        scp.append(f"{reco} {path}")
    for name, lines in (("text", text), ("segments", segs), ("wav.scp", scp)):
        with open(os.path.join(dst, name), "w") as f:
            f.write("\n".join(sorted(lines)) + "\n")
    return dst


def long_context_phase(corpus: dict, b34_recs: list, smi: str, dev) -> dict:
    """Phase 17: B3/B4 at every head dim, the D = 8 training paths and
    ``decode_asr --tiny`` (D = 12), the remat policies on the full-width
    long step, and ``train_asr --conversation_seconds 164 --attn_impl flash
    --remat lite``.  Returns the records and launches for the summary."""
    import torch

    from loco_asr_tpu_torch.data.asr_dataset import ConversationAsrDataset
    from loco_asr_tpu_torch.data.tokenizer import load_tokenizer
    from loco_asr_tpu_torch.models.gpt2 import model as gm
    from loco_asr_tpu_torch.models.speecht5 import model as st5
    from loco_asr_tpu_torch.models.speecht5.config import SpeechT5Config, tiny_config
    from loco_asr_tpu_torch.ops.cuda import conv_frontend as cf
    from loco_asr_tpu_torch.ops.cuda import flash_attention as fa
    from loco_asr_tpu_torch.ops.cuda import flash_causal as fc
    from loco_asr_tpu_torch.parallel import train
    from loco_asr_tpu_torch.pipelines import decode_asr, train_asr

    t_phase = time.perf_counter()
    out: dict = {}

    def reset_counts():
        fa.flash_rel_forward.launches = fa.flash_rel_backward.launches = 0
        fc.flash_forward.launches = fc.flash_backward.launches = 0
        cf.conv1_instance_norm_gelu.launches = 0

    def quiet(cfg):
        return dataclasses.replace(cfg, positional_dropout=0.0, hidden_dropout=0.0,
                                   attention_dropout=0.0, activation_dropout=0.0,
                                   apply_spec_augment=False)

    # (a) B3/B4 at every head dim, both forms, band and mask-only
    out["b34_dims"] = b34_dims_cases(b34_recs, smi, dev)
    t_a = time.perf_counter()

    # (b) head dim 8: the LoCo ASR widths, one step kernels + flash against
    # plain + dense, then the trainers that run it; decode_asr --tiny (D = 12)
    tok = load_tokenizer("char")
    tok.vocab_size = 256
    loco = quiet(dataclasses.replace(
        tiny_config(vocab_size=256, hidden_size=32, encoder_attention_heads=4,
                    decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64),
        **{k: tuple(v) if isinstance(v, list) else v for k, v in LOCO_CONV.items()}))
    hb = next(ConversationAsrDataset(corpus["train"], window_seconds=4).batches(
        tok, 8, max_seconds=4, max_label_len=64, shuffle=True, seed=0, eos_id=2))
    batch = {k: torch.as_tensor(hb[k], device=dev)
             for k in ("input_values", "attention_mask", "labels")}
    model = st5.asr_model_init(loco, seed=0, device=dev).train()
    runs = {}
    for impl in ("flash", "dense"):
        for p in model.parameters():
            p.grad = None
        with launches_by_head_dim() as tally:
            loss, _ = st5.asr_loss(model, batch["input_values"], batch["attention_mask"],
                                   batch["labels"], attn_impl=impl)
            loss.backward()
            torch.cuda.synchronize()
        grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
        runs[impl] = (loss.item(), train.global_norm(list(grads.values())).item(), grads,
                      dict(tally))
    (fl, fg, fgr, ftally), (dl, dg, dgr, dtally) = runs["flash"], runs["dense"]
    check(np.isfinite(fl) and abs(fl - dl) <= LOSS_RTOL * abs(dl),
          f"D=8 step: loss flash {fl} dense {dl}")
    check(abs(fg - dg) <= GNORM_RTOL * abs(dg), f"D=8 step: grad_norm flash {fg} dense {dg}")
    worst, worst_name, grad_max_abs = grads_against(fgr, dgr, "D=8 step")
    n_enc, n_dec = loco.encoder_layers, loco.decoder_layers
    want = {"B1:d8:f32": n_enc + n_dec, "B3/B4:d8:f32": n_enc + n_dec, "B5:d8:f32": n_dec}
    check(ftally == want and dtally == {}, f"D=8 step launched {ftally} (dense {dtally}), "
                                           f"expected {want}")
    out["d8_step"] = dict(batch=list(batch["input_values"].shape),
                          labels=list(batch["labels"].shape), loss_flash=fl, loss_dense=dl,
                          grad_norm_flash=fg, grad_norm_dense=dg, grad_max_abs_diff=grad_max_abs,
                          grad_worst_excess=worst, grad_worst=worst_name, launches=ftally)
    print(f"[long] d8_step {json.dumps(out['d8_step'])}")
    del model, runs, fgr, dgr

    with tempfile.TemporaryDirectory() as tmp:
        conv_json = os.path.join(tmp, "loco_conv.json")
        with open(conv_json, "w") as f:
            json.dump(LOCO_CONV, f)
        d8_runs = {}
        for tag, extra in (("tiny", []), ("loco", ["--config_json", conv_json])):
            run_dir = os.path.join(tmp, tag)
            reset_counts()
            with launches_by_head_dim() as tally:
                rc = train_asr.main(["--train_dir", corpus["train"], "--dev_dir", corpus["dev"],
                                     "--out_dir", run_dir, "--tiny", *extra, "--attn_impl",
                                     "flash", "--conversation_seconds", "4", "--batch_size", "8",
                                     "--steps", "3", "--save_every", "3", "--eval_every", "3",
                                     "--eval_batches", "1", "--decode_max_len", "16"])
                torch.cuda.synchronize()
            check(rc == 0, f"train_asr --tiny ({tag}) returned {rc}")
            with open(os.path.join(run_dir, "metrics.jsonl")) as f:
                evals = [json.loads(line) for line in f if "dev_loss" in line]
            check(evals and all(np.isfinite(r["dev_loss"]) for r in evals),
                  f"train_asr --tiny ({tag}): dev metrics {evals}")
            counts = kernel_counts()
            check(tally.get("B3/B4:d8:f32", 0) == 3 * 4 and counts["B3/B4"] == 12
                  and tally.get("B1:d8:f32", 0) > 12,
                  f"train_asr --tiny ({tag}) launched {tally} ({counts})")
            d8_runs[tag] = dict(launches=counts, by_head_dim=dict(tally), dev=evals[-1])
        # decode_asr --tiny: tiny_config's head dim 12 runs B1 padded to 16
        reset_counts()
        dec_dir = os.path.join(tmp, "decode")
        with launches_by_head_dim() as tally:
            rc = decode_asr.main(["--data_dir", corpus["dev"], "--out_dir", dec_dir, "--tiny",
                                  "--beam_size", "1", "--max_decode_len", "16",
                                  "--max_seconds", "1"])
            torch.cuda.synchronize()
        check(rc == 0, f"decode_asr --tiny returned {rc}")
        with open(os.path.join(dec_dir, "hyp.text")) as f:
            n_hyp = sum(1 for _ in f)
        check(n_hyp == 120 and tally.get("B1:d12:f32", 0) > 0 and set(tally) == {"B1:d12:f32"},
              f"decode_asr --tiny: {n_hyp} hypotheses, launches {tally}")
        d8_runs["decode_asr_tiny"] = dict(launches=kernel_counts(), by_head_dim=dict(tally),
                                          hypotheses=n_hyp)
    # the tiny encoder (head dim 12) on a dev batch, kernel path vs plain path
    tiny = st5.asr_model_init(tiny_config(vocab_size=256, apply_spec_augment=False), seed=0,
                              device=dev)
    dev_b = next(ConversationAsrDataset(corpus["dev"], window_seconds=1).batches(
        tok, 8, max_seconds=1, max_label_len=64, eos_id=2))
    hid, msk = st5.encode_speech(tiny, dev_b["input_values"], dev_b["attention_mask"])
    ref, _ = st5.encode_speech(tiny, dev_b["input_values"], dev_b["attention_mask"],
                               use_kernels=False)
    d8_runs["tiny_encoder_d12"] = encoder_error(hid, ref, msk, "tiny encoder (D = 12)")
    out["d8_runs"] = d8_runs
    print(f"[long] d8_runs {json.dumps(d8_runs)}")
    del tiny
    t_b = time.perf_counter()

    # (c) the full-width long step: SpeechT5-base, B = 1 x 164 s, 2048 labels
    cfg = dataclasses.replace(SpeechT5Config(vocab_size=256), attention_dropout=0.0)
    g = torch.Generator().manual_seed(164)
    wav = (torch.randn(1, LONG_SECONDS * 16000, generator=g) * 0.1).to(dev)
    mask = torch.ones_like(wav, dtype=torch.int32)
    labels = torch.randint(3, 256, (1, LONG_LABELS), generator=g).to(dev)
    long_batch = {"input_values": wav, "attention_mask": mask, "labels": labels}
    model = st5.asr_model_init(cfg, seed=0, device=dev).train()

    def value_grad(spec, m=model, impl="flash", generator=True):
        for p in m.parameters():
            p.grad = None
        gen = torch.Generator(device=dev).manual_seed(17) if generator else None
        loss, _ = st5.asr_loss(m, wav, mask, labels, attn_impl=impl, generator=gen, remat=spec)
        loss.backward()
        torch.cuda.synchronize()
        grads = {k: p.grad.detach().clone() for k, p in m.named_parameters()
                 if p.grad is not None}
        return loss.item(), grads, None if gen is None else gen.get_state()

    def none_spread():
        """Two none steps: their losses, and each gradient's largest spread."""
        la, ga, _ = value_grad("none")
        lb, gb, _ = value_grad("none")
        spread = {k: (gb[k] - ga[k]).abs().max().item() for k in ga}
        varying = sorted(k for k, x in spread.items() if x > 0)
        return spread, dict(loss=[la, lb], params_varying=len(varying), varying=varying[:12],
                            max_spread=max(spread.values()))

    # two none steps as the card runs them by default, then the comparison
    # with cuDNN's deterministic algorithms (two none steps agree there, so
    # each policy is held to the JAX test's limits; a parameter beyond them
    # would be held to the spread of the two none steps)
    _, default_spread = none_spread()
    torch.backends.cudnn.deterministic = True
    spread, det_spread = none_spread()
    check(det_spread["loss"][0] == det_spread["loss"][1], f"two none steps: {det_spread}")
    exact = {"none_vs_none_default": default_spread, "none_vs_none": det_spread}
    l0, g0, s0 = value_grad("none")
    for spec in POLICIES[1:]:
        l1, g1, s1 = value_grad(spec)
        check(abs(l1 - l0) <= REMAT_LOSS_RTOL * abs(l0) + 1e-7,
              f"remat {spec}: loss {l1} against none {l0}")
        check(torch.equal(s1, s0), f"remat {spec}: the generator moved on in the recompute")
        worst, worst_name, beyond = 0.0, "", []
        for k in g0:
            diff = (g1[k] - g0[k]).abs()
            excess = (diff - REMAT_GRAD_RTOL * g0[k].abs() - REMAT_GRAD_ATOL).max().item()
            if excess > 0:
                # a parameter whose none steps differ: held to their spread
                check(diff.max().item() <= spread[k],
                      f"remat {spec}: {k} off by {diff.max().item()} (none vs none "
                      f"{spread[k]})")
                beyond.append(k)
            if excess > worst:
                worst, worst_name = excess, k
        exact[spec] = dict(loss=l1, loss_rel_diff=abs(l1 - l0) / abs(l0),
                           grad_worst_excess=worst, grad_worst=worst_name,
                           held_to_spread=beyond)
        del g1
    del g0
    torch.backends.cudnn.deterministic = False

    # the gpt2-width LM step's gradients under full and lite against none
    # (dropout on; flash: B6 and its blockwise backward, B6 run again in
    # the backward under full)
    lcfg = dataclasses.replace(gm.PRESETS["gpt2"], vocab_size=256, attn_pdrop=0.0)
    lm = gm.gpt2_init(lcfg, seed=1, device=dev).train()
    ids = torch.randint(0, 256, (8, 1024), generator=g).to(dev)
    lm_grads = {}
    for spec in ("none", "full", "lite"):
        for p in lm.parameters():
            p.grad = None
        gen = torch.Generator(device=dev).manual_seed(5)
        fc.flash_forward_nhd.launches = fc.flash_backward.launches = 0
        hidden, _ = gm.gpt2_forward(lm, ids, deterministic=False, generator=gen,
                                    attn_impl="flash", remat=spec)
        loss = gm.token_nll_from_hidden(lm.wte.weight, hidden, ids,
                                        checkpoint_chunks=True).mean()
        loss.backward()
        torch.cuda.synchronize()
        n = lcfg.n_layer
        want = (n * (2 if spec == "full" else 1), n)
        got = (fc.flash_forward_nhd.launches, fc.flash_backward.launches)
        check(got == want, f"gpt2 step {spec}: B6 and backward calls {got}, expected {want}")
        lm_grads[spec] = (loss.item(), {k: p.grad.clone() for k, p in lm.named_parameters()},
                          gen.get_state())
    l_none, g_none, s_none = lm_grads["none"]
    for spec in ("full", "lite"):
        l1, g1, s1 = lm_grads[spec]
        check(abs(l1 - l_none) <= REMAT_LOSS_RTOL * abs(l_none) + 1e-7,
              f"gpt2 remat {spec}: loss {l1} against none {l_none}")
        check(torch.equal(s1, s_none), f"gpt2 remat {spec}: the generator moved on")
        excess = max((((g1[k] - g_none[k]).abs() - REMAT_GRAD_RTOL * g_none[k].abs()
                       - REMAT_GRAD_ATOL).max().item()) for k in g_none)
        check(excess <= 0, f"gpt2 remat {spec}: gradient beyond the limits by {excess}")
        exact[f"gpt2_{spec}"] = dict(loss=l1, grad_worst_excess=excess,
                                     b6_launches=lcfg.n_layer * (2 if spec == "full" else 1))
    del lm, lm_grads, g_none, g1
    out["remat_exact"] = exact
    print(f"[long] remat_exact {json.dumps(exact)}")

    # dropout off under "full": kernels + flash against plain + dense at the
    # longest window that fits (164 s first)
    qcfg = quiet(SpeechT5Config(vocab_size=256))
    qmodel = st5.asr_model_init(qcfg, seed=0, device=dev).train()
    vs_plain = None

    def flash_and_dense(n):
        res = {}
        for impl in ("flash", "dense"):
            for p in qmodel.parameters():
                p.grad = None
            loss, _ = st5.asr_loss(qmodel, wav[:, :n], mask[:, :n], labels, attn_impl=impl,
                                   remat="full")
            loss.backward()
            torch.cuda.synchronize()
            grads = {k: p.grad.detach().clone() for k, p in qmodel.named_parameters()
                     if p.grad is not None}
            res[impl] = (loss.item(), train.global_norm(list(grads.values())).item(), grads)
        return res

    for seconds in (LONG_SECONDS, 120, 80):
        torch.cuda.reset_peak_memory_stats()
        try:
            res = flash_and_dense(seconds * 16000)
        except torch.cuda.OutOfMemoryError:
            res = None
        if res is None:   # the frames of the failed call are gone: free their cache
            for p in qmodel.parameters():
                p.grad = None
            torch.cuda.empty_cache()
            print(f"[long] plain + dense at {seconds} s does not fit in device memory")
            continue
        (fl, fg, fgr), (dl, dg, dgr) = res["flash"], res["dense"]
        check(abs(fl - dl) <= LOSS_RTOL * abs(dl), f"long step: loss flash {fl} dense {dl}")
        check(abs(fg - dg) <= GNORM_RTOL * abs(dg), f"long step: grad_norm {fg} dense {dg}")
        worst, worst_name, grad_max_abs = grads_against(fgr, dgr, f"long step {seconds} s")
        vs_plain = dict(seconds=seconds, loss_flash=fl, loss_dense=dl, grad_norm_flash=fg,
                        grad_norm_dense=dg, grad_max_abs_diff=grad_max_abs,
                        grad_worst_excess=worst, grad_worst=worst_name,
                        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        del res, fgr, dgr
        break
    check(vs_plain is not None, "plain + dense fits at no window")
    out["long_vs_plain"] = vs_plain
    print(f"[long] vs_plain {json.dumps(vs_plain)}")

    # the bf16 step at 164 s under remat none, where B1 and B3/B4 run their
    # wgmma forms at conversation length (2L = 320 pe rows, 8,199 frames):
    # launches by form, ms, peak memory, and its loss against the f32 step's
    # on the same weights within phase 16's bf16-against-f32 limit
    bf16_long = {}
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        tx = train.adamw(0.0, weight_decay=0.0)            # rate 0: the weights stay
        opt = tx.init(train.trainable_params(qmodel))
        step = train.make_asr_train_step(qcfg, tx, attn_impl="flash", remat="none",
                                         compute_dtype=dtype)
        rec = {}
        for turn in range(2):   # the second is timed: the first pays the casts' set-up
            reset_counts()
            for fn in (fa.flash_rel_forward, fa.flash_rel_backward):
                fn.launches_by_form = dict.fromkeys(fc.FORMS, 0)
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(qmodel, opt, long_batch)["loss"].item()
            rec = dict(loss=loss, ms=(time.perf_counter() - t0) * 1e3,
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                       launches=kernel_counts(),
                       forms={"B1": dict(fa.flash_rel_forward.launches_by_form),
                              "B3/B4": dict(fa.flash_rel_backward.launches_by_form)})
            check(np.isfinite(loss), f"long {name} step: loss {loss}")
        bf16_long[name] = rec
        del opt, step
    n_attn = qcfg.encoder_layers + qcfg.decoder_layers
    for kern in ("B1", "B3/B4"):
        check(bf16_long["bf16"]["forms"][kern] == {"mma_sync": 0, "wgmma": n_attn},
              f"long bf16 step {kern} forms {bf16_long['bf16']['forms'][kern]}")
    l16, l32 = bf16_long["bf16"]["loss"], bf16_long["f32"]["loss"]
    check(abs(l16 - l32) <= MP_LOSS_RTOL * abs(l32), f"long bf16 step {l16} vs f32 {l32}")
    bf16_long.update(loss_rel_diff=abs(l16 - l32) / abs(l32), card=smi)
    out["long_bf16"] = bf16_long
    print(f"[long] bf16_step {json.dumps(bf16_long)}")
    del qmodel

    # each policy's train step: launches, median ms of 2 steps taken in two
    # turns (none .. lite, then lite .. none, 1 step a turn, so that drift
    # of the card or host between turns falls on every policy alike),
    # audio-s/s, peak memory, busy share and device time by kernel group
    per_policy = {spec: dict(step_ms=[], peak_mem_gb=0.0) for spec in POLICIES}
    n_enc, n_dec = cfg.encoder_layers, cfg.decoder_layers
    for spec in POLICIES + POLICIES[::-1]:
        rec = per_policy[spec]
        tx = train.adamw(1e-4)
        opt = tx.init(train.trainable_params(model))
        step = train.make_asr_train_step(cfg, tx, attn_impl="flash", remat=spec)
        gen = torch.Generator(device=dev).manual_seed(0)
        reset_counts()
        m = step(model, opt, long_batch, gen)
        torch.cuda.synchronize()
        launches = kernel_counts()
        check(np.isfinite(m["loss"].item()), f"long step {spec}: loss {m['loss'].item()}")
        recompute = n_enc if spec in ("full", "dots", "hybrid") else 0
        want = {"B1": n_enc + n_dec + recompute, "B2": 0, "B3/B4": n_enc + n_dec, "B5": n_dec,
                "B5_bwd": n_dec}
        check(launches == want, f"long step {spec} launched {launches}, expected {want}")
        rec["launches"] = launches
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(model, opt, long_batch, gen)
        loss = m["loss"].item()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        check(np.isfinite(loss), f"long step {spec}: loss {loss}")
        rec["peak_mem_gb"] = max(rec["peak_mem_gb"], torch.cuda.max_memory_allocated() / 1e9)
        if "busy_share" not in rec:
            prof = device_breakdown(lambda: step(model, opt, long_batch, gen))
            rec.update(busy_share=prof["busy_share"], device_ms=prof["kernel_ms_sum"],
                       kernels=prof["kernels"], groups_ms=prof["groups_ms"])
        del opt, step
    for spec, rec in per_policy.items():
        med = statistics.median(rec["step_ms"])
        rec.update(median_step_ms=med, audio_s_per_wall_s=LONG_SECONDS / (med / 1e3), card=smi)
        print(f"[long] step {spec} {json.dumps(rec)}")
    out["per_policy"] = per_policy
    out["long_shape"] = dict(samples=LONG_SECONDS * 16000, labels=LONG_LABELS,
                             frames=conv_frames(LONG_SECONDS * 16000, cfg))
    del model, wav, mask, labels, long_batch
    torch.cuda.empty_cache()
    t_c = time.perf_counter()

    # (d) train_asr --conversation_seconds 164 --attn_impl flash --remat lite
    with tempfile.TemporaryDirectory() as tmp:
        long_dir = long_corpus(corpus["train"], os.path.join(tmp, "long"))
        out_dir = os.path.join(tmp, "asr164")
        flags = ["--train_dir", long_dir, "--dev_dir", long_dir, "--out_dir", out_dir,
                 "--conversation_seconds", str(LONG_SECONDS), "--attn_impl", "flash",
                 "--remat", "lite", "--batch_size", "1", "--eval_every", "1000",
                 "--eval_batches", "1", "--decode_max_len", "64"]
        seen = []
        real_make = train.make_asr_train_step

        def recording_make(*a, **kw):   # each step's loss and batch shape
            step = real_make(*a, **kw)

            def recorded(model, opt_state, batch, generator=None):
                m = step(model, opt_state, batch, generator)
                seen.append(dict(loss=m["loss"].item(),
                                 samples=int(batch["input_values"].shape[1]),
                                 labels=int((batch["labels"] != -100).sum().item()),
                                 label_cols=int(batch["labels"].shape[1])))
                return m
            return recorded

        train.make_asr_train_step = recording_make
        try:
            reset_counts()
            t0 = time.perf_counter()
            rc = train_asr.main([*flags, "--steps", "6"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run_launches = kernel_counts()
            check(rc == 0, f"train_asr 164 s returned {rc}")
            t0 = time.perf_counter()
            rc = train_asr.main([*flags, "--steps", "8", "--resume"])
            resume_wall = time.perf_counter() - t0
            check(rc == 0, f"train_asr 164 s --resume returned {rc}")
        finally:
            train.make_asr_train_step = real_make
        ckpt = os.path.join(out_dir, "ckpt")
        with open(os.path.join(ckpt, "status.json")) as f:
            check(json.load(f)["latest"] == 8, "the 164 s run's resume did not reach step 8")
        with np.load(os.path.join(ckpt, "step_8.npz")) as z:
            check(int(z["opt_state.count"]) == 8, "optimizer count after resume")
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            evals = [json.loads(line) for line in f if "dev_loss" in line]
        check(len(seen) == 8 and all(np.isfinite(s["loss"]) for s in seen),
              f"164 s steps {seen}")
        check(all(s["samples"] <= LONG_SECONDS * 16000 and s["label_cols"] <= 16 * LONG_SECONDS
                  for s in seen), f"164 s batches {seen}")
        check(evals and all(np.isfinite(r["dev_loss"]) for r in evals), f"dev metrics {evals}")
        # 6 steps under lite (no B1 recompute), then one dev batch: its loss
        # and its encode (each with B2: no gradient there)
        n_enc, n_dec = cfg.encoder_layers, cfg.decoder_layers
        want = {"B1": 7 * (n_enc + n_dec) + n_enc, "B2": 2, "B3/B4": 6 * (n_enc + n_dec),
                "B5": 7 * n_dec, "B5_bwd": 6 * n_dec}
        check(run_launches == want, f"train_asr 164 s launched {run_launches}, expected {want}")
        ds = ConversationAsrDataset(long_dir, window_seconds=LONG_SECONDS)
        out["train_asr_164"] = dict(launches=run_launches, steps=seen, wall_s=wall,
                                    resume_wall_s=resume_wall, dev=evals[-1],
                                    windows=len(ds),
                                    window_seconds=[w.seconds for w in ds.windows],
                                    recordings=len(set(w.reco_id for w in ds.windows)),
                                    card=smi)
        print(f"[long] train_asr_164 {json.dumps(out['train_asr_164'])}")
    out["wall_s"] = dict(a=t_a - t_phase, b=t_b - t_a, c=t_c - t_b,
                         d=time.perf_counter() - t_c, total=time.perf_counter() - t_phase)
    print(f"[long] phase wall s {json.dumps(out['wall_s'])}")
    return out


# ---- phase 18: long-form episodes, the rest of the trainer options ----------

EPISODE_SEED = 18
EPISODE_BATCH_SECONDS = 120          # transcribe_episodes --batch_seconds
BEAM_DECODE_LEN = 50                 # the beam pass's --max_decode_len (a depth cut for
                                     # time: it holds launches, segments and metrics)
PLAIN_SEGMENTS = 2                   # the plain pass decodes the manifest episode's first
                                     # two segments (a depth cut for time: all four
                                     # before the wgmma B1's phase 16 and 17 cases)
EPISODE_DECODE_LEN = 340             # --max_decode_len: gpt2's 1,024 positions less
                                     # the 348 reserved: every segment after the
                                     # first refreshes the context (400 before the
                                     # depth cut of sequence parallelism's phase 22)
# the bursts, in seconds, between 1.5 s silences: the manifest episode's
# each past --batch_seconds (cropped to it, so that both modes encode them
# at one padding), the endpointer's one, padded to whole seconds per episode
EPISODE_BURSTS = {"ep_manifest": (122.0, 130.0, 125.0), "ep_endpointer": (9.3,)}
EPISODE_GAP = 1.5
EPISODE_WORDS = ("so", "we", "talked", "about", "the", "model", "and", "then", "it",
                 "was", "long", "context", "really", "good", "you", "know")
XL_BATCH = 4                         # gpt2-xl training rows of 1,024 tokens


def write_episodes(root: str, seed: int = EPISODE_SEED, sr: int = 16000):
    """Seeded speech-like episodes as 16-bit WAVs and a manifest: amplitude-
    modulated noise bursts between silences.  ``ep_manifest`` carries each
    burst's timestamps and a reference text, ``ep_endpointer`` none.
    Returns (manifest path, {episode: (waveform, [(start, end)])})."""
    from loco_asr_tpu_torch.data import podcasts

    rng = np.random.default_rng(seed)
    episodes, waves = [], {}
    for eid, bursts in EPISODE_BURSTS.items():
        parts, spans, t = [], [], 0.0
        for sec in bursts:
            parts.append(np.zeros(int(EPISODE_GAP * sr), np.float32))
            t += EPISODE_GAP
            n = int(sec * sr)
            env = 0.4 + 0.6 * np.abs(np.sin(np.linspace(0.0, 3.0 * sec * np.pi, n)))
            parts.append((rng.standard_normal(n) * 0.2 * env).astype(np.float32))
            spans.append((t, t + sec))
            t += sec
        parts.append(np.zeros(int(EPISODE_GAP * sr), np.float32))
        wav = np.concatenate(parts)
        path = os.path.join(root, f"{eid}.wav")
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sr)
            w.writeframes((np.clip(wav, -1.0, 1.0) * 32767).astype(np.int16).tobytes())
        segs = ([podcasts.EpisodeSegment(a, b, " ".join(rng.choice(EPISODE_WORDS, 12)))
                 for a, b in spans] if eid == "ep_manifest" else [])
        episodes.append(podcasts.Episode(eid, f"{eid}.wav", duration=len(wav) / sr,
                                         segments=segs))
        # the waveform as the pipeline reads it back (16-bit rounding)
        from loco_asr_tpu_torch.ops.audio import load_audio
        waves[eid] = (load_audio(path, sr)[0], spans)
    manifest = os.path.join(root, "manifest.jsonl")
    podcasts.write_manifest(manifest, episodes)
    return manifest, waves


@contextlib.contextmanager
def greedy_trace():
    """For every step of the B = 1 greedy loops with fusion run inside, the
    top two fused candidates (the decoder's log-probs plus the LM's weighted
    ones, the sum ``greedy_decode`` takes its argmax of), as lists per
    decode (a new list where the step index is 0): [[(values [2], ids [2])
    per step] per decode], on the device."""
    import torch

    from loco_asr_tpu_torch.decode import fusion as fusion_mod
    from loco_asr_tpu_torch.models.speecht5 import model as st5

    trace, pending = [], []
    step_fn, lm_step = st5.asr_decode_step, fusion_mod.FusionLM.step

    def asr_step(model, tok, t, *a, **kw):
        logits = step_fn(model, tok, t, *a, **kw)
        if isinstance(t, int) and t == 0:
            trace.append([])
        pending.append(torch.log_softmax(logits.float(), dim=-1))
        return logits

    def fused_step(self, *a, **kw):
        lm_logp, cache = lm_step(self, *a, **kw)
        if pending:
            vals, ids = torch.topk(pending.pop() + lm_logp, 2, dim=-1)
            trace[-1].append((vals[0], ids[0]))
        return lm_logp, cache

    st5.asr_decode_step, fusion_mod.FusionLM.step = asr_step, fused_step
    try:
        yield trace
    finally:
        st5.asr_decode_step, fusion_mod.FusionLM.step = step_fn, lm_step


def greedy_agreement(got_ids, want_ids, got_trace, want_trace, what: str):
    """Segment token ids of one greedy path against another's, in order,
    over one conversation (the LM context carries, so a parting changes
    every later segment): equal, or parting at a near-tie, the rule of
    :func:`beam_agreement` for K = 1.  At the first step where the two
    argmaxes differ, the token taken on the ``got`` path is the ``want``
    path's second candidate, the ``want`` path's two candidates lie within
    DECODE_TIE_ATOL, and (where ``got_trace`` is given) the two paths'
    scores of both candidates within DECODE_TIE_ATOL of each other; until
    then the chosen scores agree within DECODE_SCORE_TOL.  Returns
    [segment, step, gap, drift] of the parting, or None."""
    for s, (gi, wi) in enumerate(zip(got_ids, want_ids)):
        wt = want_trace[s]
        gt = got_trace[s] if got_trace is not None else None
        if gt is not None:
            n = min(len(gt), len(wt))
            gids = [int(gt[t][1][0]) for t in range(n)]
        else:   # the ids the other path emitted (no trace of it)
            n = min(len(gi), len(wt))
            gids = list(gi[:n])
        for t in range(n):
            wv, wids = wt[t]
            if gids[t] == int(wids[0]):
                if gt is not None:
                    err = abs(gt[t][0][0].item() - wv[0].item())
                    check(err <= DECODE_SCORE_TOL * (1 + abs(wv[0].item())),
                          f"{what}: segment {s} step {t} score drift {err}")
                continue
            gap = (wv[0] - wv[1]).item()
            check(gids[t] == int(wids[1]) and gap <= DECODE_TIE_ATOL,
                  f"{what}: segment {s} parts at step {t} where the candidates lie "
                  f"{gap} apart (or on a third candidate): not a near-tie")
            drift = 0.0
            if gt is not None:
                gv, g_ids = gt[t]
                drift = max(abs(gv[j].item() - wv[int((wids == g_ids[j]).nonzero()[0])].item())
                            for j in range(2) if bool((wids == g_ids[j]).any()))
                check(drift <= DECODE_TIE_ATOL, f"{what}: segment {s} step {t} drift {drift}")
            return [s, t, gap, drift]
        check(list(gi) == list(wi), f"{what}: segment {s} token ids differ past the trace")
    check(len(got_ids) == len(want_ids), f"{what}: {len(got_ids)} against {len(want_ids)} "
                                         "segments")
    return None


@contextlib.contextmanager
def cross_projections():
    """Rows of every projection of the decoder's cross-attention K/V made
    inside (``decoder.init_cross_cache``: each layer's k and v of those
    rows), a list of row counts, one per call, whatever model makes them."""
    from loco_asr_tpu_torch.models.speecht5 import decoder as dec

    calls, real = [], dec.init_cross_cache

    def counted(module, encoder_hidden):
        calls.append(int(encoder_hidden.shape[0]))
        return real(module, encoder_hidden)

    dec.init_cross_cache = counted
    try:
        yield calls
    finally:
        dec.init_cross_cache = real


@contextlib.contextmanager
def k_projections(model):
    """Calls of the decoder's cross-attention K projections of ``model``
    inside (forward hooks): a per-step projection would show here."""
    calls = []
    hooks = [lyr.encoder_attn.k_proj.register_forward_hook(
        lambda mod, inp, out: calls.append(int(inp[0].shape[0])))
        for lyr in model.decoder.wrapped_decoder.layers]
    try:
        yield calls
    finally:
        for h in hooks:
            h.remove()


def episode_outputs(out_dir: str, episodes) -> tuple:
    """({episode: [token ids per segment]}, {episode: [(start, end)]},
    {episode: metrics row}) of a ``transcribe_episodes`` run."""
    ids, spans = {}, {}
    for eid in episodes:
        with open(os.path.join(out_dir, f"{eid}.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        ids[eid] = [r["token_ids"] for r in lines]
        spans[eid] = [(r["start"], r["end"]) for r in lines]
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        rows = {r["episode"]: r for r in map(json.loads, f) if "episode" in r}
    return ids, spans, rows


def episodes_phase(smi: str, dev) -> dict:
    """Phase 18 (a): ``transcribe_episodes`` at SpeechT5-base + gpt2 width
    (vocabulary 50257, random weights from seed 0) on seeded episodes,
    ``--attn_impl flash --batch_seconds 120``, per episode and
    ``--continuous --slots 4`` (greedy and beam 4)."""
    import torch

    from loco_asr_tpu_torch.decode.fusion import FusionLM
    from loco_asr_tpu_torch.decode.long_audio import transcribe_long_audio
    from loco_asr_tpu_torch.models.gpt2 import model as gm
    from loco_asr_tpu_torch.models.speecht5 import model as st5
    from loco_asr_tpu_torch.models.speecht5.config import SpeechT5Config
    from loco_asr_tpu_torch.pipelines import transcribe_episodes

    t_phase = time.perf_counter()
    sr, bs, L = 16000, EPISODE_BATCH_SECONDS, EPISODE_DECODE_LEN
    cfg = SpeechT5Config(vocab_size=50257)
    n_dec = cfg.decoder_layers
    # the CLI's weights: both inits from seed 0
    model = st5.asr_model_init(cfg, seed=0, device=dev)
    lm = FusionLM(gm.gpt2_init(gm.PRESETS["gpt2"], seed=0, device=dev), weight=0.3)
    tmp = tempfile.TemporaryDirectory()
    manifest, waves = write_episodes(tmp.name)
    flags = ["--manifest", manifest, "--vocab_size", "50257", "--lm_model", "gpt2",
             "--attn_impl", "flash", "--batch_seconds", str(bs), "--max_decode_len", str(L)]
    primes, real_prime = [], FusionLM.prime

    def counted_prime(self, *a, **kw):   # a refresh re-primes the kept tail
        primes.append(1)
        return real_prime(self, *a, **kw)

    def run(name, extra):
        out_dir = os.path.join(tmp.name, name)
        primes.clear()
        reset_all_launches()
        torch.cuda.reset_peak_memory_stats()
        with cross_projections() as proj:
            t0 = time.perf_counter()
            rc = transcribe_episodes.main([*flags, "--out_dir", out_dir, *extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        check(rc == 0, f"transcribe_episodes {extra} returned {rc}")
        ids, spans, rows = episode_outputs(out_dir, waves)
        return dict(ids=ids, spans=spans, rows=rows, wall_s=wall, launches=all_launches(),
                    refreshes=len(primes), projections=list(proj),
                    peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30)

    FusionLM.prime = counted_prime
    try:
        # (a) per episode, kernel path: the CLI, every greedy step traced
        with greedy_trace() as ktrace:
            per = run("per_episode", [])
        n_segs = sum(len(v) for v in per["ids"].values())
        check([len(per["ids"][e]) for e in waves] == [len(b) for b in EPISODE_BURSTS.values()],
              f"per-episode segments {[len(v) for v in per['ids'].values()]}")
        want = {"B1": cfg.encoder_layers * n_segs, "B2": n_segs, "B3/B4": 0, "B5": 0,
                "B5_bwd": 0, "B6": 0, "B7": 0}
        check(per["launches"] == want,
              f"per-episode launched {per['launches']}, expected {want}")
        check(per["refreshes"] >= 2, f"the conversation cache refreshed {per['refreshes']}x")
        check(per["projections"] == [1] * n_segs,
              f"cross projections {per['projections']}: once a segment expected")
        check(len(ktrace) == n_segs, f"{len(ktrace)} traced decodes for {n_segs} segments")
        check(all(np.isfinite(r["rtfx"]) and r["rtfx"] > 0 for r in per["rows"].values()),
              f"per-episode metrics {per['rows']}")

        # the plain path on the same weights and the manifest episode's
        # first PLAIN_SEGMENTS segments, its context carried between them:
        # B2's plain version, dense attention; the decoder's K projections
        # counted
        reset_all_launches()
        wav, _ = waves["ep_manifest"]
        with greedy_trace() as ptrace, k_projections(model) as kproj:
            t0 = time.perf_counter()
            segs = transcribe_long_audio(model, wav, sr,
                                         segments=per["spans"]["ep_manifest"][:PLAIN_SEGMENTS],
                                         fusion=lm, max_decode_len=L, batch_seconds=bs,
                                         use_kernels=False)
            plain_ids = [s.token_ids for s in segs]
            torch.cuda.synchronize()
            plain_wall = time.perf_counter() - t0
        check(all(v == 0 for v in all_launches().values()),
              f"the plain path launched {all_launches()}")
        check(kproj == [1] * (n_dec * PLAIN_SEGMENTS), f"decoder K projections {len(kproj)} "
                                                       f"calls, expected "
                                                       f"{n_dec * PLAIN_SEGMENTS} of one row")
        # ktrace follows the episodes in order: the manifest episode's first
        ties = {"ep_manifest": greedy_agreement(
            per["ids"]["ep_manifest"][:PLAIN_SEGMENTS], plain_ids, ktrace[:PLAIN_SEGMENTS],
            ptrace, "per-episode ep_manifest, kernel vs plain")}

        # (b) --continuous greedy.  Per episode pads each segment to whole
        # seconds, the batcher to its bucket, and the padding enters the first
        # conv layer's instance norm: the modes encode a segment alike only
        # where it fills the bucket, as the manifest episode's cropped ones
        # do.  There the per-episode decodes are the batcher's reference
        # (the same carry-over, ``ConversationContext`` one segment at a time)
        cont = run("continuous", ["--continuous", "--slots", "4"])
        check(cont["refreshes"] >= 2, f"the continuous run refreshed {cont['refreshes']}x")
        check(cont["launches"]["B1"] == cfg.encoder_layers * cont["launches"]["B2"] > 0
              and all(cont["launches"][k] == 0 for k in ("B3/B4", "B5", "B5_bwd", "B6", "B7")),
              f"continuous launched {cont['launches']}")
        check(len(cont["projections"]) == cont["launches"]["B2"]
              and n_segs <= sum(cont["projections"]) <= 2 * n_segs,
              f"continuous cross projections {cont['projections']}: once an admission")
        n_a = len(per["ids"]["ep_manifest"])
        cont_tie = greedy_agreement(cont["ids"]["ep_manifest"], per["ids"]["ep_manifest"],
                                    None, ktrace[:n_a], "continuous against per episode")

        # --continuous --beam_size 4, to BEAM_DECODE_LEN tokens a segment
        beam = run("beam", ["--continuous", "--slots", "4", "--beam_size", "4",
                            "--max_decode_len", str(BEAM_DECODE_LEN)])
        check(beam["launches"]["B1"] == cfg.encoder_layers * beam["launches"]["B2"] > 0
              and all(beam["launches"][k] == 0 for k in ("B3/B4", "B5", "B5_bwd", "B6", "B7")),
              f"beam launched {beam['launches']}")
        check([len(beam["ids"][e]) for e in waves] == [len(cont["ids"][e]) for e in waves],
              "beam segments")
        for rows in (cont["rows"], beam["rows"]):
            check(all(np.isfinite(r["corpus_rtfx"]) for r in rows.values())
                  and np.isfinite(rows["ep_manifest"]["wer"])
                  and "wer" not in rows["ep_endpointer"], f"continuous metrics {rows}")
    finally:
        FusionLM.prime = real_prime

    # (c) B1 at the 120 s segment in decoding (B = 1, inference mode), the
    # device's busy share over one segment's decode, and dense attention's
    # peak memory by length until it stops fitting
    wav, spans = waves["ep_manifest"]
    a = int(spans[1][0] * sr)
    xt = torch.from_numpy(np.ascontiguousarray(wav[None, a:a + bs * sr])).to(dev)
    mt = torch.ones_like(xt, dtype=torch.int32)
    dense = {}
    with torch.inference_mode():
        b1_ms = kernel_device_ms(lambda: st5.encode_speech(model, xt, mt, attn_impl="flash"),
                                 ("flash_rel_fwd",), n=2)["flash_rel_fwd"]
        enc_ms = time_ms(lambda: st5.encode_speech(model, xt, mt, attn_impl="flash"),
                         reps=3, inner=1)
        frames = int(st5.encode_speech(model, xt, mt)[1].sum())
        hd = cfg.hidden_size // cfg.encoder_attention_heads
        q = torch.empty(1, cfg.encoder_attention_heads, frames, hd, device="meta")
        pe = torch.empty(2 * cfg.encoder_max_relative_position, hd, device="meta")
        b1_bound = bound(*b1_work(q, q, pe, torch.tensor([frames]), False), products=True)
        first = wav[int(spans[0][0] * sr): int(spans[0][1] * sr)]
        prof = device_breakdown(lambda: transcribe_long_audio(
            model, first, sr, fusion=lm, max_decode_len=min(64, L), batch_seconds=bs,
            segments=[(0.0, len(first) / sr)], attn_impl="flash"))
        for secs in (bs, 2 * bs, 4 * bs):
            xd = torch.zeros((1, secs * sr), device=dev)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            try:   # a measurement: where dense stops fitting is its result
                st5.encode_speech(model, xd, None, attn_impl="dense")
                torch.cuda.synchronize()
                dense[secs] = torch.cuda.max_memory_allocated() / 2 ** 30
            except torch.cuda.OutOfMemoryError:
                dense[secs] = "out of memory"
                break
            finally:
                del xd
    torch.cuda.empty_cache()
    audio_s = sum(len(w) for w, _ in waves.values()) / sr
    out = dict(
        segments=n_segs, audio_s=audio_s, max_decode_len=L, batch_seconds=bs,
        per_episode=dict(launches=per["launches"], refreshes=per["refreshes"],
                         wall_s=per["wall_s"], rtfx={e: r["rtfx"] for e, r in per["rows"].items()},
                         peak_gb=per["peak_gb"], cross_projection_calls=per["projections"],
                         decode_steps=sum(len(t) for t in ktrace),
                         ms_per_step=1e3 * per["wall_s"] / sum(len(t) for t in ktrace),
                         kernel_vs_plain_parting=ties, plain_wall_s=plain_wall),
        continuous=dict(launches=cont["launches"], refreshes=cont["refreshes"],
                        wall_s=cont["wall_s"], corpus_rtfx=cont["rows"]["ep_manifest"]["corpus_rtfx"],
                        wer=cont["rows"]["ep_manifest"]["wer"], peak_gb=cont["peak_gb"],
                        cross_projection_rows=cont["projections"],
                        against_per_episode_parting=cont_tie,
                        segments_equal_to_per_episode={e: sum(
                            x == y for x, y in zip(per["ids"][e], cont["ids"][e]))
                            for e in waves}),
        beam=dict(launches=beam["launches"], wall_s=beam["wall_s"], peak_gb=beam["peak_gb"],
                  corpus_rtfx=beam["rows"]["ep_manifest"]["corpus_rtfx"],
                  wer=beam["rows"]["ep_manifest"]["wer"]),
        b1_120s=dict(frames=frames, device_ms=b1_ms, encode_ms=enc_ms, bound_ms=b1_bound[0],
                     bound_by=b1_bound[1], device_bound_share=b1_bound[0] / b1_ms),
        segment_decode=dict(steps=min(64, L), busy_share=prof["busy_share"], wall_ms=prof["wall_ms"],
                            kernels=prof["kernels"], groups_ms=prof["groups_ms"]),
        dense_peak_gb=dense, card=smi, wall_s=time.perf_counter() - t_phase)
    print(f"[episodes] {json.dumps(out)}")
    tmp.cleanup()
    return out


def state_bytes(opt_state) -> int:
    """Bytes of an optimizer state's tensors."""
    return sum(t.numel() * t.element_size() for k, v in opt_state.items() if k != "count"
               for t in v.values())


def trainer_options_phase(corpus: dict, smi: str, dev) -> dict:
    """Phase 18 (b): Adafactor on the card against the CPU step; gpt2-xl
    training under Adafactor (``train_lm``) beside AdamW's memory; and
    ``train_asr --optimizer adafactor --checkpoint <HF .safetensors>
    --nan_recovery --nan_inject_step 3`` at SpeechT5-base width, then
    ``average_last_k`` over its checkpoints."""
    import copy

    import torch

    from loco_asr_tpu_torch.models.gpt2 import model as gm
    from loco_asr_tpu_torch.models.speecht5 import convert
    from loco_asr_tpu_torch.models.speecht5 import model as st5
    from loco_asr_tpu_torch.models.speecht5.config import SpeechT5Config
    from loco_asr_tpu_torch.parallel import train
    from loco_asr_tpu_torch.pipelines import common, train_asr, train_lm
    from loco_asr_tpu_torch.utils import checkpoint as ckpt_lib

    t_phase = time.perf_counter()
    out = {}
    # (a) one Adafactor step at SpeechT5-base width, dropout and SpecAugment
    # off, on the card (kernels, flash) against the CPU (plain versions,
    # dense) from the same weights and batch: loss rtol 1e-5; parameters
    # atol 1e-5 where the step is fixed by the gradient, that is where the
    # CPU gradient exceeds 100 times its difference from the card's.
    # Elsewhere the gradient is rounding noise (the key biases', whose exact
    # gradient is 0 as the softmax cancels a shift), which Adafactor's first
    # step normalises to a full step of either sign: there each side moves
    # by no more than the CPU step's largest move in that tensor (and the
    # rounding of p - lr u), on at most 1 % of the entries
    cfg = dataclasses.replace(SpeechT5Config(vocab_size=256), hidden_dropout=0.0,
                              attention_dropout=0.0, activation_dropout=0.0,
                              feat_proj_dropout=0.0, positional_dropout=0.0,
                              apply_spec_augment=False)
    hb = asr_host_batches(corpus["train"], n=1)[0]
    n_rows, n_samp = 2, 4 * 16000
    small = {"input_values": hb["input_values"][:n_rows, :n_samp],
             "attention_mask": hb["attention_mask"][:n_rows, :n_samp],
             "labels": hb["labels"][:n_rows, :48]}
    lr = 1e-4
    runs = {}
    for where, impl in ((dev, "flash"), (torch.device("cpu"), "dense")):
        model = st5.asr_model_init(cfg, seed=5, device=where)
        tx = train.adafactor(lr, weight_decay=0.01)
        opt = tx.init(train.trainable_params(model))
        step = train.make_asr_train_step(cfg, tx, attn_impl=impl)
        batch = {k: torch.as_tensor(v, device=where) for k, v in small.items()}
        t0 = time.perf_counter()
        met = step(model, opt, batch)
        loss = met["loss"].item()
        runs[impl] = dict(loss=loss, s=time.perf_counter() - t0,
                          params={k: p.detach().cpu() for k, p in model.named_parameters()},
                          grads={k: (p.grad.detach().cpu() if p.grad is not None
                                     else torch.zeros(p.shape)) for k, p in model.named_parameters()},
                          state_bytes=state_bytes(opt))
        del model, opt
    init = {k: p.detach() for k, p in st5.asr_model_init(cfg, seed=5, device="cpu")
            .named_parameters()}
    card, cpu = runs["flash"], runs["dense"]
    check(abs(card["loss"] - cpu["loss"]) <= 1e-5 * abs(cpu["loss"]),
          f"Adafactor step loss: card {card['loss']} against CPU {cpu['loss']}")
    worst, dead, total = 0.0, 0, 0
    for k, want in cpu["params"].items():
        g = cpu["grads"][k]
        live = (g - card["grads"][k]).abs() * 100 <= g.abs()
        got = card["params"][k]
        if live.any():
            worst = max(worst, (got - want)[live].abs().max().item())
        dead += int((~live).sum())
        total += live.numel()
        if not live.all():
            widest = (want - init[k]).abs().max()
            slack = 2.4e-7 * (1 + init[k][~live].abs())
            check(bool(((got - init[k])[~live].abs() <= widest + slack).all()),
                  f"Adafactor step {k}: a noise-driven entry moved past the CPU step's widest")
    check(worst <= 1e-5, f"Adafactor step parameters: card against CPU max abs {worst}")
    check(dead <= 0.01 * total, f"Adafactor step: {dead} of {total} entries noise-driven")
    out["adafactor_step"] = dict(loss=card["loss"], cpu_loss=cpu["loss"], max_abs_param=worst,
                                 noise_entries=dead, batch=[n_rows, n_samp],
                                 state_bytes=card["state_bytes"], card_s=card["s"],
                                 cpu_s=cpu["s"], card=smi)
    print(f"[trainer] adafactor step {json.dumps(out['adafactor_step'])}")
    del runs, init

    # the full-width step at B = 8 x 10 s, flash, dropout on, under AdamW and
    # Adafactor in turns of 3 steps: AdamW, Adafactor (warm-ups), then
    # Adafactor, AdamW (timed)
    model = st5.asr_model_init(SpeechT5Config(vocab_size=256), seed=5, device=dev)
    batch = {k: torch.as_tensor(hb[k], device=dev)
             for k in ("input_values", "attention_mask", "labels")}
    gen = torch.Generator(device=dev).manual_seed(0)
    opts = {}
    for name, tx in (("adamw", train.adamw(1e-4)), ("adafactor", train.adafactor(1e-4))):
        opts[name] = (tx.init(train.trainable_params(model)),
                      train.make_asr_train_step(model.cfg, tx, attn_impl="flash"))
    timed = {"adamw": [], "adafactor": []}
    for turn, name in enumerate(("adamw", "adafactor", "adafactor", "adamw")):
        opt, step = opts[name]
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(model, opt, batch, gen)
            torch.cuda.synchronize()
            if turn in (2, 3):
                timed[name].append((time.perf_counter() - t0) * 1e3)
    out["asr_step_ms"] = {name: dict(median_ms=statistics.median(ms), ms=ms,
                                     state_gb=state_bytes(opts[name][0]) / 2 ** 30)
                          for name, ms in timed.items()}
    out["asr_step_ms"].update(batch=list(batch["input_values"].shape), card=smi)
    print(f"[trainer] asr step {json.dumps(out['asr_step_ms'])}")
    del model, opts, batch
    torch.cuda.empty_cache()

    # (b) gpt2-xl widths (vocabulary 256) at [XL_BATCH, 1024]: 2 steps under
    # AdamW and under Adafactor from the same init, peak memory, state
    # bytes, ms a step; then train_lm --model gpt2-xl --optimizer adafactor
    xl = gm.GPT2Config(**{**gm.PRESETS["gpt2-xl"].__dict__, "vocab_size": 256})
    model = gm.gpt2_init(xl, seed=0, device=dev)
    ids = torch.randint(0, 256, (XL_BATCH, 1024), generator=torch.Generator().manual_seed(1))
    batch = {"ids": ids.to(dev), "lengths": torch.full((XL_BATCH,), 1024, device=dev)}
    xl_runs = {}
    for name, tx in (("adamw", train.adamw(1e-5)), ("adafactor", train.adafactor(1e-5))):
        opt = tx.init(dict(model.named_parameters()))
        step = train.make_lm_train_step(xl, tx, attn_impl="flash")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        ms, losses = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            met = step(model, opt, batch)
            losses.append(met["loss"].item())
            ms.append((time.perf_counter() - t0) * 1e3)
        xl_runs[name] = dict(peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                             state_gb=state_bytes(opt) / 2 ** 30, ms=ms, losses=losses,
                             launches=all_launches())
        check(all(np.isfinite(losses)), f"gpt2-xl {name} losses {losses}")
        del opt, step
        for p in model.parameters():
            p.grad = None
        torch.cuda.empty_cache()
    check(xl_runs["adafactor"]["launches"]["B5"] == 2 * xl.n_layer,
          f"gpt2-xl steps launched {xl_runs['adafactor']['launches']} (B5: 25 heads, odd)")
    n_params = sum(p.numel() for p in model.parameters())
    del model
    torch.cuda.empty_cache()
    lm_dir = os.path.join(ROOT, "exp", "loco", "lm_corpus")
    with tempfile.TemporaryDirectory() as tmp:
        reset_all_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = train_lm.main(["--train_file", os.path.join(lm_dir, "train.txt"),
                            "--out_dir", tmp, "--model", "gpt2-xl", "--tokenizer", "char",
                            "--optimizer", "adafactor", "--attn_impl", "flash",
                            "--seq_len", "1024", "--batch_size", str(XL_BATCH), "--steps", "2",
                            "--warmup_steps", "1", "--log_every", "1",
                            "--eval_every", "1000", "--save_every", "1000"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(rc == 0, f"train_lm gpt2-xl returned {rc}")
        cli_launches = all_launches()
        with open(os.path.join(tmp, "metrics.jsonl")) as f:
            losses = [r["loss"] for r in map(json.loads, f) if "loss" in r]
        check(len(losses) == 2 and all(np.isfinite(losses)), f"train_lm gpt2-xl losses {losses}")
        check(cli_launches["B5"] == 2 * xl.n_layer and cli_launches["B5_bwd"] == 2 * xl.n_layer,
              f"train_lm gpt2-xl launched {cli_launches}")
        with np.load(os.path.join(tmp, "ckpt", "step_2.npz")) as z:
            saved = {k for k in z.files if k.startswith("opt_state.")}
        check(any(k.startswith("opt_state.v_row.") for k in saved), "adafactor state not saved")
        out["gpt2_xl"] = dict(params=n_params, batch=[XL_BATCH, 1024], steps=xl_runs,
                              train_lm=dict(losses=losses, launches=cli_launches, wall_s=wall,
                                            peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30),
                              card=smi)
    print(f"[trainer] gpt2-xl {json.dumps(out['gpt2_xl'])}")

    # (c) train_asr at SpeechT5-base width: adafactor, flash, from an HF
    # .safetensors, a NaN batch at step 3 rolled back to step 2's save;
    # then average_last_k over its saves
    with tempfile.TemporaryDirectory() as tmp:
        seeded = st5.asr_model_init(SpeechT5Config(vocab_size=256), seed=9, device="cpu")
        hf_path = os.path.join(tmp, "asr.safetensors")
        save_safetensors(hf_path, hf_speecht5_state(convert.asr_to_jax_params(seeded)))
        del seeded
        out_dir = os.path.join(tmp, "asr")
        seen, rollbacks = [], []
        real_make, real_call = train.make_asr_train_step, common.NanRollback.__call__

        def recording_make(*a, **kw):
            step = real_make(*a, **kw)

            def recorded(model, opt_state, batch, generator=None):
                m = step(model, opt_state, batch, generator)
                seen.append(m["loss"].item())
                return m
            return recorded

        def checked_call(self, step, loss):
            rolled = real_call(self, step, loss)
            if rolled:   # the live state is the latest save's, exactly
                saved = self.ckpt.restore()
                live = convert.asr_to_jax_params(self.model)
                flat = ckpt_lib.flatten(saved["params"])
                same = all(np.array_equal(live[k], np.asarray(flat[k])) for k in live)
                rollbacks.append(dict(step=step, restored=int(saved["step"]), same=same,
                                      count=self.opt_state["count"]))
            return rolled

        train.make_asr_train_step, common.NanRollback.__call__ = recording_make, checked_call
        try:
            reset_all_launches()
            t0 = time.perf_counter()
            rc = train_asr.main(["--train_dir", corpus["train"], "--out_dir", out_dir,
                                 "--checkpoint", hf_path, "--attn_impl", "flash",
                                 "--optimizer", "adafactor", "--nan_recovery",
                                 "--nan_inject_step", "3", "--save_every", "2",
                                 "--steps", "6", "--warmup_steps", "1",
                                 "--conversation_seconds", "10", "--batch_size", "8",
                                 "--eval_every", "1000"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            train.make_asr_train_step, common.NanRollback.__call__ = real_make, real_call
        check(rc == 0, f"train_asr adafactor returned {rc}")
        asr_launches = all_launches()
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            events = [(r["step"], r["event"]) for r in map(json.loads, f) if "event" in r]
        check(events == [(3, "nan_rollback")], f"rollback events {events}")
        check(rollbacks == [dict(step=3, restored=2, same=True, count=2)],
              f"rollback restored {rollbacks}")
        check(len(seen) == 7 and not np.isfinite(seen[2])
              and all(np.isfinite(seen[:2] + seen[3:])), f"train_asr losses {seen}")
        ckpt = ckpt_lib.Checkpointer(os.path.join(out_dir, "ckpt"))
        check(ckpt.steps() == [2, 4, 6], f"saved steps {ckpt.steps()}")
        avg = ckpt_lib.flatten(ckpt_lib.average_last_k(ckpt, k=3))
        states = [ckpt_lib.flatten(ckpt.restore(s)["params"]) for s in (2, 4, 6)]
        key = "encoder.wrapped_encoder.layers.0.attention.q_proj.kernel"
        mean = np.mean([np.asarray(s[key], np.float64) for s in states], axis=0)
        check(np.array_equal(avg[key], mean.astype(np.float32))
              and all(np.isfinite(np.asarray(v)).all() for v in avg.values()),
              "average_last_k")
        enc, dec = SpeechT5Config().encoder_layers, SpeechT5Config().decoder_layers
        out["train_asr"] = dict(losses=seen, events=events, rollbacks=rollbacks,
                                launches=asr_launches, wall_s=wall, averaged=len(avg),
                                card=smi)
        want = {"B1": 7 * (enc + dec), "B2": 0, "B3/B4": 7 * (enc + dec), "B5": 7 * dec,
                "B5_bwd": 7 * dec, "B6": 0, "B7": 0}   # 6 steps and the rolled-back one
        check(asr_launches == want, f"train_asr adafactor launched {asr_launches}, "
                                    f"expected {want}")
    print(f"[trainer] train_asr {json.dumps(out['train_asr'])}")
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# ---- phase 19: Fisher corpus ingest (shorten SPHERE -> fisher_prep -> train,
# decode, perplexity), then the generic feature encoder ----------------------

FISHER_CALLS = 4            # fe_03_00001-4: three pcm-shorten, the last ulaw-shorten
FISHER_RECS_PER_CHANNEL = 6
FISHER_FULL_CALLS = 11699   # the full corpus (pipelines/fisher_prep.py --strict)
FISHER_CALL_S = 600.0       # the extrapolation's call length
FISHER_PY_SECONDS = 10.0    # the pure-Python decoder's share of each file


def linear_to_ulaw(pcm: np.ndarray) -> np.ndarray:
    """int16 PCM -> G.711 mu-law bytes."""
    bias, clip = 0x84, 32635
    x = pcm.astype(np.int32)
    sign = np.where(x < 0, 0x80, 0)
    x = np.clip(np.abs(x), 0, clip) + bias
    exponent = np.clip(np.floor(np.log2(x / 128.0)).astype(np.int32), 0, 7)
    mantissa = (x >> (exponent + 3)) & 0x0F
    return (~(sign | (exponent << 4) | mantissa)).astype(np.uint8)


def encode_call(x: np.ndarray, ulaw: bool) -> bytes:
    """A call's [n, 2] internal samples as one shorten stream (``TYPE_AU2``
    for mu-law, else ``TYPE_S16LH``), every command the codec has in use."""
    from loco_asr_tpu_torch.ops import shorten as shn

    return shn.encode(x, shn.TYPE_AU2 if ulaw else shn.TYPE_S16LH, nmean=4, maxnlpc=2,
                      qlpc=[56, -24], commands=[shn.FN_DIFF1, shn.FN_DIFF2, shn.FN_QLPC,
                                                shn.FN_DIFF3])


def write_shorten_sphere(path: str, stream: bytes, n: int, ulaw: bool) -> None:
    """A two-channel 8 kHz SPHERE file of ``n`` samples a channel around a
    shorten ``stream``: ``pcm,embedded-shorten-v2.00`` (16-bit) or
    ``ulaw,embedded-shorten-v2.00``."""
    coding = ("ulaw" if ulaw else "pcm") + ",embedded-shorten-v2.00"
    header = (f"NIST_1A\n   1024\nchannel_count -i 2\nsample_count -i {n}\n"
              f"sample_rate -i 8000\nsample_n_bytes -i {1 if ulaw else 2}\n"
              f"sample_coding -s{len(coding)} {coding}\nend_head\n")
    with open(path, "wb") as f:
        f.write(header.encode().ljust(1024, b" ") + stream)


def write_fisher(root: str) -> dict:
    """An LDC-layout Fisher tree of ``FISHER_CALLS`` calls from the committed
    train recordings (16 kHz WAV, ~9.8 s, 10 segments each), resampled to 8
    kHz with the port's resampler, ``FISHER_RECS_PER_CHANNEL`` back to back
    a channel: shorten-coded SPHERE (``pcm,embedded-shorten-v2.00``, 16-bit
    ``TYPE_S16LH``; the last call ``ulaw,embedded-shorten-v2.00``,
    ``TYPE_AU2``), transcripts ``# fe_03_0000N.sph`` then ``start end
    A|B: words`` shifted by each recording's offset, a ``calldata.tbl`` row
    for call 3 (its utterances take the speakers' pins), a
    ``filetable.txt``, and ``train.recids`` (calls 1-3, and call 3's pins,
    which the remapped utterance ids carry as their recording id) /
    ``dev.recids`` (call 4).  Returns the seeded internal samples by call,
    the calls' paths, the split dir and the encode seconds."""
    from loco_asr_tpu_torch.data import kaldi
    from loco_asr_tpu_torch.ops import audio_io
    from loco_asr_tpu_torch.ops import shorten as shn

    src = os.path.join(ROOT, "exp", "loco", "asr_corpus", "train")
    texts = kaldi.read_key_value_file(os.path.join(src, "text"))
    segments = kaldi.read_segments(os.path.join(src, "segments"))
    by_reco: dict = {}
    for utt, (reco, start, end) in segments.items():
        by_reco.setdefault(reco, []).append((start, end, texts[utt]))
    recos = sorted(by_reco)[:FISHER_CALLS * 2 * FISHER_RECS_PER_CHANNEL]
    trans = os.path.join(root, "fe_03_p1_tran", "data", "trans", "000")
    audio = os.path.join(root, "fe_03_p1_sph1", "audio", "000")
    doc = os.path.join(root, "fe_03_p1_tran", "doc")
    splits = os.path.join(root, "splits")
    for d in (trans, audio, doc, splits):
        os.makedirs(d)
    samples, paths, encode_s, seconds = {}, {}, 0.0, 0.0
    for c in range(FISHER_CALLS):
        call = f"fe_03_{c + 1:05d}"
        chans, lines = [], []
        for ch, side in enumerate("AB"):
            pcm, offset = [], 0.0
            for j in range(FISHER_RECS_PER_CHANNEL):
                reco = recos[(2 * c + ch) * FISHER_RECS_PER_CHANNEL + j]
                wav, sr = audio_io.read_wav(os.path.join(src, "wav", f"{reco}.wav"))
                x = audio_io.resample(wav, sr, 8000)
                pcm.append(np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int32))
                for start, end, words in sorted(by_reco[reco]):
                    lines.append((offset + start, offset + end, side, words))
                offset += len(pcm[-1]) / 8000.0
            chans.append(np.concatenate(pcm))
        n = max(len(x) for x in chans)
        x = np.stack([np.pad(v, (0, n - len(v))) for v in chans], axis=1)   # [n, 2]
        ulaw = c == FISHER_CALLS - 1
        if ulaw:   # mu-law bytes, stored as their G.711 expansion
            x = np.stack([shn.ulaw_bytes_to_internal(linear_to_ulaw(x[:, k])) for k in (0, 1)], 1)
        t0 = time.perf_counter()
        stream = encode_call(x, ulaw)
        encode_s += time.perf_counter() - t0
        paths[call] = os.path.join(audio, f"{call}.sph")
        write_shorten_sphere(paths[call], stream, n, ulaw)
        with open(os.path.join(trans, f"{call}.txt"), "w") as f:
            f.write(f"# {call}.sph\n\n")
            for start, end, side, words in sorted(lines):
                f.write(f"{start:.2f} {end:.2f} {side}: {words}\n")
        samples[call] = x
        seconds += n / 8000.0
    with open(os.path.join(doc, "fe_03_p1_calldata.tbl"), "w") as f:
        f.write("00003,x,x,x,x, 71003 ,x,x,x,x, 72003 ,x\n")
    with open(os.path.join(root, "fe_03_p1_sph1", "filetable.txt"), "w") as f:
        for c, g in enumerate(("fm", "mm", "ff", "mf")):
            f.write(f"pin{c} fe_03_{c + 1:05d}.sph {g}\n")
    with open(os.path.join(splits, "train.recids"), "w") as f:
        f.write("fe_03_00001\nfe_03_00002\nfe_03_00003\nfe_03_71003\nfe_03_72003\n")
    with open(os.path.join(splits, "dev.recids"), "w") as f:
        f.write("fe_03_00004\n")
    return dict(samples=samples, paths=paths, splits=splits, encode_s=encode_s,
                channel_seconds=seconds / FISHER_CALLS, recordings=len(recos))


def pipe_env() -> dict:
    """The environment the port's dataset gives a wav.scp pipe."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def release_call_load(tmp: str, corpus: dict, pipe_line: str) -> dict:
    """One recording load of the port's ``KaldiAsrDataset`` on a call of the
    release's length (``FISHER_CALL_S`` a channel: call 1's samples
    repeated, shorten-coded as call 1), as a trainer meets it on the
    shuffled corpus, where nearly every utterance misses the 5-recording
    cache: the wav.scp pipe ``fisher_prep`` wrote for call 1 (``sph_decode``
    of the whole file) pointed at it, then the 8 -> 16 kHz resampler, each
    timed; and a pipe's start-up, timed on a call of 0.1 s."""
    from loco_asr_tpu_torch.data.asr_dataset import KaldiAsrDataset
    from loco_asr_tpu_torch.ops import audio_io

    src = corpus["paths"]["fe_03_00001"]
    check(src in pipe_line, f"call 1's pipe does not name its file: {pipe_line}")
    x = corpus["samples"]["fe_03_00001"]
    n = int(FISHER_CALL_S * 8000)
    long = np.tile(x, (-(-n // len(x)), 1))[:n]
    t0 = time.perf_counter()
    stream = encode_call(long, False)
    encode_s = time.perf_counter() - t0
    release, short = os.path.join(tmp, "fe_03_90000.sph"), os.path.join(tmp, "fe_03_90001.sph")
    write_shorten_sphere(release, stream, n, False)
    write_shorten_sphere(short, encode_call(long[:800], False), 800, False)
    start_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = subprocess.run(pipe_line.replace(src, short).rstrip()[:-1], shell=True,
                             capture_output=True, cwd=ROOT, env=pipe_env(), timeout=120)
        start_s.append(time.perf_counter() - t0)
        check(out.returncode == 0, f"the 0.1 s pipe returned {out.returncode}")
    data = os.path.join(tmp, "release")
    os.makedirs(data)
    utt = "fe_03_90000-A-000000-000100"
    for name, line in (("wav.scp", f"fe_03_90000-A {pipe_line.replace(src, release)}"),
                       ("text", f"{utt} words"), ("segments", f"{utt} fe_03_90000-A 0.00 1.00")):
        with open(os.path.join(data, name), "w") as f:
            f.write(line.rstrip("\n") + "\n")
    ds = KaldiAsrDataset(data)
    real, spent = audio_io.resample, []

    def timed_resample(*a, **kw):
        t0 = time.perf_counter()
        try:
            return real(*a, **kw)
        finally:
            spent.append(time.perf_counter() - t0)

    audio_io.resample = timed_resample
    try:
        t0 = time.perf_counter()
        wav = ds._load_recording("fe_03_90000-A")
        load_s = time.perf_counter() - t0
    finally:
        audio_io.resample = real
    check(len(spent) == 1 and np.array_equal(
        wav, real(long[:, 0].astype(np.float32) / 32768.0, 8000, 16000)),
        "the release-length load differs from the seeded channel resampled")
    return dict(release_call_s=FISHER_CALL_S, release_encode_s=encode_s,
                release_load_s=load_s, release_resample_s=spent[0],
                release_pipe_s=load_s - spent[0], pipe_start_s=statistics.median(start_s),
                pipe_start_s_all=start_s)


def fisher_ingest(tmp: str, smi: str):
    """Phase 19 (a) and (b), host work only: the shorten-coded LDC tree
    (:func:`write_fisher`) under ``tmp``; ``fisher_prep --calldata
    --split_dir --strict`` into ``tmp/data``; every wav.scp pipe against the
    seeded samples, the pipe process's imports, and the native core (which
    must build) against the pure-Python decoder.  Returns (the Kaldi data
    dir, the record printed)."""
    from loco_asr_tpu_torch import native
    from loco_asr_tpu_torch.data import kaldi
    from loco_asr_tpu_torch.ops import shorten as shn

    root, data = os.path.join(tmp, "ldc"), os.path.join(tmp, "data")
    corpus = write_fisher(root)
    print(f"[fisher] corpus {json.dumps(dict(calls=FISHER_CALLS, recordings=corpus['recordings'], channel_seconds=corpus['channel_seconds'], encode_s=corpus['encode_s'], codings=['pcm'] * (FISHER_CALLS - 1) + ['ulaw']))}")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "loco_asr_tpu_torch.pipelines.fisher_prep", root,
                           "--out_dir", os.path.join(data, "train_all"), "--calldata",
                           "--split_dir", corpus["splits"], "--split_out", data,
                           "--sets", "train", "dev", "--expected_count", str(FISHER_CALLS),
                           "--strict"], cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env=pipe_env())
    prep_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"fisher_prep returned {proc.returncode}: {proc.stderr[-2000:]}")
    scp = {}
    for split in ("train_all", "train", "dev"):
        scp[split] = kaldi.read_key_value_file(os.path.join(data, split, "wav.scp"))
        check(scp[split] and all("-m loco_asr_tpu_torch.pipelines.sph_decode " in v
                                 for v in scp[split].values()),
              f"{split}/wav.scp does not name the port's sph_decode: {list(scp[split].values())[:2]}")
    check(len(scp["train_all"]) == 2 * FISHER_CALLS and len(scp["dev"]) == 2,
          f"wav.scp lines: {[len(v) for v in scp.values()]}")
    utts = {s: len(kaldi.read_key_value_file(os.path.join(data, s, "text")))
            for s in ("train_all", "train", "dev")}
    check(utts["train"] + utts["dev"] == utts["train_all"] and utts["dev"] > 0,
          f"utterances by split {utts}")
    check(any(k.startswith("fe_03_71003-00003-A") for k in kaldi.read_key_value_file(
        os.path.join(data, "train", "text"))), "the calldata remap is missing from train")
    pipe_s = []
    for reco, cmd in sorted(scp["train_all"].items()):
        call, side = reco.rsplit("-", 1)
        t0 = time.perf_counter()
        out = subprocess.run(cmd.rstrip()[:-1], shell=True, capture_output=True, cwd=ROOT,
                             env=pipe_env(), timeout=120)
        pipe_s.append(time.perf_counter() - t0)
        check(out.returncode == 0, f"pipe of {reco} returned {out.returncode}: {out.stderr[-500:]}")
        with wave.open(io.BytesIO(out.stdout)) as w:
            check(w.getframerate() == 8000 and w.getnchannels() == 1, f"pipe of {reco}: header")
            pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        want = corpus["samples"][call][:, "AB".index(side)]
        check(np.array_equal(pcm.astype(np.int32), want),
              f"pipe of {reco}: decoded samples differ from the seeded ones")
    probe = subprocess.run(f"{sys.executable} -X importtime -m "
                           f"loco_asr_tpu_torch.pipelines.sph_decode -c 1 "
                           f"{corpus['paths']['fe_03_00001']} {os.path.join(tmp, 'probe.wav')}",
                           shell=True, capture_output=True, text=True, cwd=ROOT, env=pipe_env(),
                           timeout=120)
    loaded = {line.split("|")[-1].strip() for line in probe.stderr.splitlines()
              if line.startswith("import time:")}
    heavy = sorted(m for m in loaded if m.split(".")[0] in ("torch", "jax", "loco_asr_tpu"))
    check(probe.returncode == 0 and "loco_asr_tpu_torch.native" in loaded and not heavy,
          f"the sph_decode process: rc {probe.returncode}, loaded {heavy}")
    check(native.available(), f"the native ingest core did not build: {native.build_error}")
    n_py = int(FISHER_PY_SECONDS * 8000)
    nat_s = py_s = 0.0
    nat_samples = py_samples = 0
    for call, path in sorted(corpus["paths"].items()):
        t0 = time.perf_counter()
        native.read_sphere(path, None)           # decodes both channels
        nat_s += time.perf_counter() - t0
        nat_samples += corpus["samples"][call].size
        with open(path, "rb") as f:
            raw = f.read()[1024:]
        t0 = time.perf_counter()
        dec, ftype = shn.decode(raw, max_samples=n_py)
        py_s += time.perf_counter() - t0
        py_samples += dec.size
        ref = shn.internal_to_float(dec[:n_py], ftype)
        for ch in (0, 1):
            got = native.read_sphere(path, ch)[0][:n_py]
            check(np.array_equal(got, ref[:, ch]),
                  f"{call} channel {ch}: native and Python decoders differ on the first "
                  f"{FISHER_PY_SECONDS:.0f} s")
    nat_rate, py_rate = nat_samples / nat_s, py_samples / py_s
    full = 2 * FISHER_CALL_S * 8000            # samples a 10-minute call's pipe decodes
    release = release_call_load(tmp, corpus, scp["train_all"]["fe_03_00001-A"])
    rec = dict(prep_s=prep_s, utterances=utts, pipes=len(pipe_s),
               pipe_s_median=statistics.median(pipe_s), pipe_s_max=max(pipe_s),
               channel_seconds=corpus["channel_seconds"],
               native_msamples_per_s=nat_rate / 1e6, python_msamples_per_s=py_rate / 1e6,
               native_equals_python_s=FISHER_PY_SECONDS, pipe_loads=sorted(
                   m for m in loaded if m.startswith("loco_asr_tpu_torch")),
               **release,
               corpus_pipe_hours_native=FISHER_FULL_CALLS * 2 * release["release_pipe_s"] / 3600,
               corpus_pipe_hours_python=FISHER_FULL_CALLS * 2 * (
                   release["pipe_start_s"] + full / py_rate) / 3600,
               card=smi)
    print(f"[fisher] preparation and pipes {json.dumps(rec)}")
    return data, rec


def fisher_phase(smi: str, dev) -> dict:
    """Phase 19: the port's Fisher ingest path at SpeechT5-base width.  (a)
    a shorten-coded LDC tree (:func:`write_fisher`); (b) ``python -m
    loco_asr_tpu_torch.pipelines.fisher_prep --calldata --split_dir
    --strict``: every wav.scp pipe names the port's ``sph_decode``, decodes
    its channel losslessly and loads no torch, JAX or ``loco_asr_tpu``; the
    native core (which must build) equals the pure-Python decoder on each
    file's first 10 s; (c) ``train_asr --attn_impl flash`` on the prepared
    train split (18 B1, 18 B3/B4 a step, 12 B1 + 1 B2 a dev encode); (d)
    ``decode_asr --beam_size 4`` of the dev split on its checkpoint, kernel
    path against plain by phase 12's near-tie rule; (e) ``eval_ppl --model
    gpt2 --context_type max_len`` on the dev text, flash against dense;
    (f) ``encode_speech`` with the generic feature encoder
    (``feat_extract_norm="layer"``, ``conv_bias``), kernels against plain.
    Returns the launches by kernel."""
    import torch

    from loco_asr_tpu_torch.data.asr_dataset import KaldiAsrDataset
    from loco_asr_tpu_torch.data.tokenizer import load_tokenizer
    from loco_asr_tpu_torch.decode import beam as beam_mod
    from loco_asr_tpu_torch.models.speecht5 import model as st5
    from loco_asr_tpu_torch.models.speecht5.config import SpeechT5Config
    from loco_asr_tpu_torch.parallel import train
    from loco_asr_tpu_torch.pipelines import decode_asr, eval_ppl, train_asr
    from loco_asr_tpu_torch.utils import prefetch as prefetch_mod

    t_phase = time.perf_counter()
    launches = {k: 0 for k in all_launches()}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    tmp = tempfile.TemporaryDirectory()
    # -- (a), (b): the corpus, its preparation, the pipes and decoders
    data, prep_rec = fisher_ingest(tmp.name, smi)
    utts = prep_rec["utterances"]

    # -- (c) train_asr on the prepared train split, through the prefetch
    steps, waits, step_ms, losses, step_counts, enc_counts, busy = [], [], [], [], [], [], []
    misses, captured = [], {}
    real_make, real_next = train.make_asr_train_step, prefetch_mod.PrefetchIterator.__next__
    real_encode, real_load = st5.encode_speech, KaldiAsrDataset._load_recording

    def make_step(*a, **kw):
        step = real_make(*a, **kw)

        def counted_step(*sa, **skw):
            torch.cuda.synchronize()
            before = all_launches()
            t0 = time.perf_counter()
            if len(steps) == 7:   # the last step inside a profiler window
                out = []
                prof, wall_ms = profiled(lambda: out.append(step(*sa, **skw)))
                busy_ms_, n_kernels = busy_ms(prof)
                busy.append((busy_ms_ / wall_ms if n_kernels else None, n_kernels))
                m = out[0]
            elif not steps:       # the first step's launches, replayed after the run
                with captured_launches() as cases:
                    m = step(*sa, **skw)
                    torch.cuda.synchronize()
                captured.update(cases)
            else:
                m = step(*sa, **skw)
            losses.append(float(m["loss"]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            after = all_launches()
            step_counts.append({k: after[k] - before[k] for k in after})
            steps.append(1)
            return m
        return counted_step

    def timed_next(self):
        t0 = time.perf_counter()
        try:
            return real_next(self)
        finally:
            waits.append(time.perf_counter() - t0)

    def counted_encode(*a, **kw):
        before = all_launches()
        out = real_encode(*a, **kw)
        torch.cuda.synchronize()
        after = all_launches()
        enc_counts.append({k: after[k] - before[k] for k in after})
        return out

    def counted_load(self, reco):
        if reco not in self._reco_cache:
            t0 = time.perf_counter()
            wav = real_load(self, reco)
            misses.append((reco, time.perf_counter() - t0))
            return wav
        return real_load(self, reco)

    cfg = SpeechT5Config(vocab_size=256)
    run_dir = os.path.join(tmp.name, "asr")
    train.make_asr_train_step, prefetch_mod.PrefetchIterator.__next__ = make_step, timed_next
    st5.encode_speech, KaldiAsrDataset._load_recording = counted_encode, counted_load
    try:
        reset_all_launches()
        t0 = time.perf_counter()
        rc = train_asr.main(["--train_dir", os.path.join(data, "train"),
                             "--dev_dir", os.path.join(data, "dev"), "--out_dir", run_dir,
                             "--attn_impl", "flash", "--batch_size", "8", "--max_seconds", "10",
                             "--steps", "8", "--eval_every", "4", "--eval_batches", "1",
                             "--vocab_size", "256"])
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t0
        train_launches = all_launches()
    finally:
        train.make_asr_train_step, prefetch_mod.PrefetchIterator.__next__ = real_make, real_next
        st5.encode_speech, KaldiAsrDataset._load_recording = real_encode, real_load
    check(rc == 0 and len(steps) == 8, f"train_asr returned {rc} after {len(steps)} steps")
    check(all(np.isfinite(losses)), f"train_asr losses {losses}")
    bad = [c for c in step_counts if not (c["B1"] == 18 and c["B3/B4"] == 18 and c["B2"] == 0)]
    check(not bad, f"train_asr steps launched {bad[:2]}")
    # dev evals at steps 4 and 8, and the closing one after the loop
    check(len(enc_counts) == 3 and all(c["B1"] == cfg.encoder_layers and c["B2"] == 1
                                       for c in enc_counts),
          f"dev encodes launched {enc_counts}")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        evals = [json.loads(line) for line in f if "dev_wer" in line]
    check(len(evals) >= 2 and all(np.isfinite(r["dev_loss"]) for r in evals), f"dev {evals}")
    add(train_launches)
    # every kernel form of the first step, at the step's own shapes (~49
    # frames of B = 8 x 1 s: one partial tile with key padding), replayed
    # against its plain version at the limits of phases 3 and 8
    check(sorted({(key[0], key[1]) if key[0] in ("B1", "B3/B4") else (key[0],)
                  for key in captured})
          == [("B1", "band"), ("B1", "mask-only"), ("B3/B4", "band"), ("B3/B4", "mask-only"),
              ("B5",)], f"the Fisher step captured {sorted(captured)}")
    step_holds = hold_captured(captured)
    for r in step_holds:
        print(f"[fisher_step_kernels] {json.dumps(r)}")
    del captured
    # one step's loss and gradients on a prepared Fisher batch (dropout
    # off): kernels + flash against plain + dense, at phase 8's limits
    tok = load_tokenizer("char")
    tok.vocab_size = cfg.vocab_size
    hb = next(KaldiAsrDataset(os.path.join(data, "train")).batches(
        tok, 8, max_seconds=10, max_label_len=128, shuffle=True, seed=0,
        eos_id=cfg.eos_token_id))
    quiet = dataclasses.replace(cfg, positional_dropout=0.0, hidden_dropout=0.0,
                                attention_dropout=0.0, activation_dropout=0.0,
                                apply_spec_augment=False)
    model = st5.asr_model_init(quiet, seed=0, device=dev).train()
    batch = {k: torch.as_tensor(hb[k], device=dev)
             for k in ("input_values", "attention_mask", "labels")}
    grad_runs = {}
    for impl in ("flash", "dense"):
        for p in model.parameters():
            p.grad = None
        reset_all_launches()
        loss, _ = st5.asr_loss(model, batch["input_values"], batch["attention_mask"],
                               batch["labels"], attn_impl=impl)
        loss.backward()
        torch.cuda.synchronize()
        grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
        grad_runs[impl] = (loss.item(), train.global_norm(list(grads.values())).item(), grads,
                           all_launches())
    (fl, fg, fgr, fcnt), (dl, dg, dgr, dcnt) = grad_runs["flash"], grad_runs["dense"]
    check(np.isfinite(fl) and abs(fl - dl) <= LOSS_RTOL * abs(dl),
          f"Fisher step: loss flash {fl} dense {dl}")
    check(abs(fg - dg) <= GNORM_RTOL * abs(dg), f"Fisher step: grad_norm flash {fg} dense {dg}")
    g_worst, g_name, g_max = grads_against(fgr, dgr, "Fisher step")
    check(fcnt["B1"] == fcnt["B3/B4"] == 18 and not any(dcnt.values()),
          f"Fisher step launched {fcnt} (flash), {dcnt} (dense)")
    step_check = dict(samples_max=int(hb["attention_mask"].sum(1).max()), loss=fl,
                      loss_dense=dl, grad_norm=fg, grad_norm_dense=dg, grad_worst_excess=g_worst,
                      grad_worst=g_name, grad_max_abs=g_max)
    print(f"[fisher] step against plain + dense {json.dumps(step_check)}")
    del model, grad_runs, fgr, dgr, batch
    timed = step_ms[2:7]
    train_loads = [t for reco, t in misses if not reco.startswith("fe_03_00004")]
    # the input stream alone: the shuffled train split's first 8 batches
    # through the same prefetch, with no step to hide behind
    t0 = time.perf_counter()
    n_stream = sum(1 for _ in itertools.islice(prefetch_mod.prefetch(KaldiAsrDataset(
        os.path.join(data, "train")).batches(tok, 8, max_seconds=10, max_label_len=128,
                                              shuffle=True, seed=0, eos_id=cfg.eos_token_id),
        depth=4), 8))
    stream_s = (time.perf_counter() - t0) / n_stream
    train_rec = dict(train_utterances=utts["train"], steps=len(steps), losses=losses,
                     median_step_ms=statistics.median(timed), step_ms=step_ms,
                     busy_share=busy[0][0], busy_kernels=busy[0][1],
                     prefetch_first_s=waits[0], prefetch_wait_after_first_s=sum(waits[1:len(steps)]),
                     prefetch_waits_s=waits[:len(steps)],
                     train_recording_loads=len(train_loads),
                     dev_recording_loads=len(misses) - len(train_loads),
                     recording_load_s_median=statistics.median(s for _, s in misses),
                     stream_alone_s_per_batch=stream_s,
                     launches=train_launches, per_step=step_counts[0], per_dev_encode=enc_counts[0],
                     step_kernels_held=len(step_holds), step_against_dense=step_check,
                     dev=evals[-1], wall_s=train_wall, card=smi)
    print(f"[fisher] train_asr {json.dumps(train_rec)}")
    ckpt = os.path.join(run_dir, "ckpt")

    # -- (d) decode_asr of the dev split on (c)'s checkpoint, kernels vs plain
    runs = {}
    for path in ("kernels", "plain"):
        calls, encodes = [], []
        real_search = beam_mod.beam_search

        def plain_encode(model, wav, mask=None, use_kernels=True, **kw):
            encodes.append(1)
            return real_encode(model, wav, mask, use_kernels=path == "kernels", **kw)

        with beam_trace() as trace:
            def traced_search(*a, **kw):
                start = len(trace)
                hyp = real_search(*a, **kw)
                calls.append(dict(hyp=hyp, trace=trace[start:]))
                return hyp

            beam_mod.beam_search, st5.encode_speech = traced_search, plain_encode
            try:
                reset_all_launches()
                t0 = time.perf_counter()
                out_dir = os.path.join(tmp.name, f"dec_{path}")
                rc = decode_asr.main(["--data_dir", os.path.join(data, "dev"), "--out_dir",
                                      out_dir, "--checkpoint", ckpt, "--beam_size", "4",
                                      "--max_decode_len", "64", "--limit_batches", "2"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                dl = all_launches()
            finally:
                beam_mod.beam_search, st5.encode_speech = real_search, real_encode
        check(rc == 0, f"decode_asr ({path}) returned {rc}")
        with open(os.path.join(out_dir, "wer.json")) as f:
            details = json.load(f)
        with open(os.path.join(out_dir, "hyp.text")) as f:
            lines = f.read().splitlines()
        n = len(encodes)
        want = (dict({k: 0 for k in dl}, B1=cfg.encoder_layers * n, B2=n) if path == "kernels"
                else {k: 0 for k in dl})
        check(n == 2 and len(calls) == 2 and dl == want,
              f"decode_asr ({path}): {n} encodes, {len(calls)} searches, launched {dl}")
        runs[path] = dict(calls=calls, lines=lines, wer=details["wer"], rtfx=details["rtfx"],
                          wall_s=wall, launches=dl)
    ties, score_err = [], 0.0
    for i, (kern, plain) in enumerate(zip(runs["kernels"]["calls"], runs["plain"]["calls"])):
        t, e = beam_agreement(kern, plain)
        ties += [[i, *tie] for tie in t]
        score_err = max(score_err, e)
    if not ties:
        check(runs["kernels"]["lines"] == runs["plain"]["lines"], "decode_asr hypotheses differ")
    add(runs["kernels"]["launches"])
    dec_rec = dict(utterances=len(runs["kernels"]["lines"]), wer=runs["kernels"]["wer"],
                   plain_wer=runs["plain"]["wer"], rtfx=runs["kernels"]["rtfx"],
                   wall_s=runs["kernels"]["wall_s"], plain_wall_s=runs["plain"]["wall_s"],
                   launches=runs["kernels"]["launches"], near_ties=ties,
                   max_score_diff=score_err, card=smi)
    print(f"[fisher] decode_asr {json.dumps(dec_rec)}")
    del runs

    # -- (e) eval_ppl on the dev text, flash against dense
    nlls, ppl_launches = {}, {}
    for impl in ("flash", "dense"):
        out_dir = os.path.join(tmp.name, f"ppl_{impl}")
        reset_all_launches()
        rc = eval_ppl.main(["-i", os.path.join(data, "dev", "text"), "-o", out_dir, "--model",
                            "gpt2", "--context_type", "max_len", "--attn_impl", impl])
        torch.cuda.synchronize()
        ppl_launches[impl] = all_launches()
        check(rc == 0, f"eval_ppl ({impl}) on the Fisher dev text returned {rc}")
        with open(os.path.join(out_dir, "rec_id2nlls.pkl"), "rb") as f:
            nlls[impl] = pickle.load(f)
    check(list(nlls["flash"]) == list(nlls["dense"]) == ["fe_03_00004"],
          f"eval_ppl recordings {list(nlls['flash'])}")
    nll_err = max(float(np.max(np.abs(np.asarray(nlls["flash"][r]) - np.asarray(nlls["dense"][r]))))
                  for r in nlls["dense"])
    check(nll_err <= NLL_TOL, f"eval_ppl on the Fisher dev text: flash vs dense NLL {nll_err}")
    check(ppl_launches["flash"]["B6"] > 0 and not any(ppl_launches["dense"].values()),
          f"eval_ppl launches {ppl_launches}")
    add(ppl_launches["flash"])
    ppl_rec = dict(tokens=sum(len(v) for v in nlls["flash"].values()), nll_max_abs=nll_err,
                   tol=NLL_TOL, launches=ppl_launches["flash"], card=smi)
    print(f"[fisher] eval_ppl {json.dumps(ppl_rec)}")
    del nlls

    # -- (f) the generic feature encoder, kernels against plain
    gcfg = SpeechT5Config(vocab_size=256, feat_extract_norm="layer", conv_bias=True)
    enc = st5.asr_init(gcfg, seed=0, device=dev)
    g = torch.Generator().manual_seed(19)
    wav = (torch.randn(16, 80000, generator=g) * 0.1).to(dev)
    lengths = torch.tensor([80000] * 12 + [70000, 52000, 31000, 16000], device=dev)
    mask = (torch.arange(80000, device=dev)[None, :] < lengths[:, None]).to(torch.int32)
    with torch.inference_mode():
        reset_all_launches()
        hid, hmask = st5.encode_speech(enc, wav, mask)
        torch.cuda.synchronize()
        gl = all_launches()
        phid, pmask = st5.encode_speech(enc, wav, mask, use_kernels=False)
        check(torch.equal(hmask, pmask) and bool(torch.isfinite(hid).all()),
              "generic encoder: frame masks differ or non-finite output")
        err = encoder_error(hid, phid, hmask, "generic feature encoder")
        check(gl == dict({k: 0 for k in gl}, B1=gcfg.encoder_layers),
              f"generic encoder launched {gl}")
        ms = time_ms(lambda: st5.encode_speech(enc, wav, mask), reps=5, inner=2)
        plain_ms = time_ms(lambda: st5.encode_speech(enc, wav, mask, use_kernels=False),
                           reps=3, inner=1)
    add(gl)
    gen_rec = dict(batch=[16, 80000], feat_extract_norm="layer", conv_bias=True,
                   max_abs=err[0], mean_abs=err[1], launches=gl, forward_ms=ms,
                   plain_forward_ms=plain_ms, rtfx=16 * 5.0 / (ms / 1e3), card=smi)
    print(f"[fisher] generic encoder {json.dumps(gen_rec)}")
    del enc, hid, phid
    tmp.cleanup()
    print(f"[fisher] phase 19 took {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, prep=prep_rec, train=train_rec, decode=dec_rec,
                ppl=ppl_rec, generic=gen_rec)


def asr_host_batches(train_dir: str, n: int = 31) -> list:
    """``n`` host batches of 8 conversation windows of <= 10 s (the char
    tokenizer, vocabulary 256), epochs 0-2 shuffled by their seeds."""
    from loco_asr_tpu_torch.data.asr_dataset import ConversationAsrDataset
    from loco_asr_tpu_torch.data.tokenizer import load_tokenizer

    tok = load_tokenizer("char")
    tok.vocab_size = 256
    ds = ConversationAsrDataset(train_dir, window_seconds=10)
    eos = 2   # SpeechT5Config().eos_token_id
    return list(itertools.islice(itertools.chain.from_iterable(
        ds.batches(tok, 8, max_seconds=10, max_label_len=160, shuffle=True, seed=e,
                   eos_id=eos) for e in range(3)), n))


def extract_store(path: str) -> list:
    """The embeddings of an ``extract_embeddings`` store, in record order."""
    from loco_asr_tpu_torch.data.embedding_store import EmbeddingStore

    store = EmbeddingStore(path)
    return [store[i][1] for i in range(len(store))]


# -- phase 21: the (data, fsdp, tensor) mesh on one card ---------------------

MESH_RANKS = 4                 # ranks of phase 21, all on cuda:0 over gloo
MESH_STEPS = 2                 # sharded ASR steps held to the single-device step
MESH_LM_STEPS = 2              # sharded LM steps (the second reads the first's update)
MESH_LOSS_ATOL, MESH_GNORM_RTOL = 1e-4, 1e-3   # the JAX dry run's bounds
MESH_LR = 1e-4
MESH_HEADS = 12                # SpeechT5-base's and gpt2's attention heads
DP_EMB_ATOL, DP_PPL_RTOL = 1e-5, 1e-6          # --data_parallel 2 against 1


_MESH_INITS: dict = {}


def mesh_models(kind: str, meta: bool = False):
    """(config, whole model on the host, step factory) of phase 21 (a)/(b):
    SpeechT5-base with a 256 vocabulary, or gpt2 width, seeded; dropout on
    (a copy of one seeded draw a process).  ``meta``: the model's shapes
    only."""
    import torch

    from loco_asr_tpu_torch.models.gpt2 import model as gm
    from loco_asr_tpu_torch.models.speecht5 import model as st5
    from loco_asr_tpu_torch.models.speecht5.config import SpeechT5Config
    from loco_asr_tpu_torch.parallel import train

    if kind == "asr":
        cfg = SpeechT5Config(vocab_size=256)
        if meta:
            with torch.device("meta"):
                return cfg, st5.AsrModel(cfg), None
        if kind not in _MESH_INITS:
            _MESH_INITS[kind] = st5.asr_model_init(cfg, seed=21, device="cpu")
        return cfg, copy.deepcopy(_MESH_INITS[kind]), train.make_asr_train_step
    cfg = dataclasses.replace(gm.PRESETS["gpt2"], vocab_size=256)
    if meta:
        with torch.device("meta"):
            return cfg, gm.GPT2Model(cfg), None
    return cfg, gm.gpt2_init(cfg, seed=21, device="cpu"), train.make_lm_train_step


@contextlib.contextmanager
def launches_by_heads():
    """Attention-kernel launches by ``kernel:heads:head dim`` while the
    block runs (B1, B3/B4 and B5 read [B, H, T, D], B6 [B, T, H, D])."""
    from loco_asr_tpu_torch.ops.cuda import flash_attention as fa
    from loco_asr_tpu_torch.ops.cuda import flash_causal as fc

    real = (fa._launch_forward, fa._launch_backward, fc._launch)
    tally: dict = {}

    def count(kern, heads, d):
        key = f"{kern}:h{heads}:d{d}"
        tally[key] = tally.get(key, 0) + 1

    def b1(q, *a, **kw):
        count("B1", q.shape[1], q.shape[-1])
        return real[0](q, *a, **kw)

    def b34(q, *a, **kw):
        count("B3/B4", q.shape[1], q.shape[-1])
        return real[1](q, *a, **kw)

    def b5(q, *a, t_axis, **kw):
        count("B5" if t_axis == 2 else "B6", q.shape[1 if t_axis == 2 else 2], q.shape[-1])
        return real[2](q, *a, t_axis=t_axis, **kw)

    fa._launch_forward, fa._launch_backward, fc._launch = b1, b34, b5
    try:
        yield tally
    finally:
        fa._launch_forward, fa._launch_backward, fc._launch = real


def mesh_steps(kind: str, batches: list, dev, mesh=None) -> dict:
    """``len(batches)`` flash steps of AdamW(1e-4) from the seeded init,
    sharded on ``mesh`` (this rank's rows) or on one device; per step the
    loss, grad_norm, ms (CUDA-synchronised wall time) and, for the first
    step, the launches by kernel and head count; the peak memory and the
    bytes of the local parameters plus optimizer state."""
    import torch

    from loco_asr_tpu_torch.parallel import partition, train

    cfg, model, make = mesh_models(kind)
    if mesh is None:
        model.to(dev)
    else:
        partition.shard_params(model, mesh)
    tx = train.adamw(MESH_LR)
    params = train.trainable_params(model)
    opt_state = tx.init(params, layout=train.layout(model))
    state_bytes = partition.local_bytes(list(params.values()) + list(opt_state["mu"].values())
                                        + list(opt_state["nu"].values()))
    step = make(cfg, tx, attn_impl="flash", mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(21)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    rec = {"loss": [], "grad_norm": [], "ms": [], "state_bytes": state_bytes}
    for i, host in enumerate(batches):
        batch = (train.shard_batch(host, mesh) if mesh is not None
                 else {k: torch.as_tensor(v, device=dev) for k, v in host.items()})
        reset_all_launches()
        with launches_by_heads() as heads:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(model, opt_state, batch, gen)
            loss = float(m["loss"])
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            rec["launches"], rec["by_head_dim"] = all_launches(), dict(heads)
        rec["loss"].append(loss)
        rec["grad_norm"].append(float(m["grad_norm"]))
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    if mesh is not None:
        rec["expected_state_bytes"] = 3 * partition.local_param_bytes(
            mesh_models(kind, meta=True)[1], mesh)
    return rec


def mesh_rank_cases(out: str, cases: list, batches_path: str, train_runs: list,
                    dp: tuple, sp_path: str) -> int:
    """Phase 21 on one rank: each case ``(name, kind, dims)`` of (a) and (b)
    runs :func:`mesh_steps` sharded on that mesh; then each argv of
    ``train_runs`` through ``train_asr.main`` (these ranks are its ranks, as
    ``torchrun``'s would be), then ``dryrun_multichip(4)``; the rank writes
    its record, then phase 22 (:func:`sp_rank_cases`, the batches in
    ``sp_path``).  Then (d): ranks 0 and 1 leave the group of four for one of
    their own, as a start of two ranks would give them, and run
    :func:`dp_ranks` on ``dp`` ``(runs, trace_path)``, while ranks 2 and 3
    wait to form the group of four again (which the rank's exit closes)."""
    import torch
    import torch.distributed as dist

    from loco_asr_tpu_torch.parallel import launch
    from loco_asr_tpu_torch.parallel import mesh as meshlib
    from loco_asr_tpu_torch.parallel.dryrun import dryrun_multichip

    dev = torch.device("cuda", torch.cuda.current_device())
    no_tf32()
    batches = pickle.load(open(batches_path, "rb"))
    recs = {}
    for name, kind, dims in cases:
        mesh = meshlib.make_mesh(*dims, device=dev)
        recs[name] = mesh_steps(kind, batches[kind], dev, mesh)
        recs[name]["mesh"] = dict(mesh.shape)
        torch.cuda.empty_cache()
    from loco_asr_tpu_torch.pipelines import train_asr

    for i, argv in enumerate(train_runs):
        t0 = time.perf_counter()
        check(train_asr.main(argv) == 0, f"train_asr {argv}")
        recs[f"train_asr_{i}_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    no_tf32()
    t0 = time.perf_counter()
    recs["dryrun"] = {**dryrun_multichip(dist.get_world_size(), "cuda"),
                      "s": time.perf_counter() - t0}
    no_tf32()
    recs["sp"] = sp_rank_cases(out, sp_path)
    rank = dist.get_rank()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(recs, f)

    def regroup(world: int, store: str) -> None:
        os.environ.update(WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
        dist.init_process_group("gloo", init_method="file://" + os.path.join(out, store),
                                rank=rank, world_size=world, timeout=launch.TIMEOUT)

    dist.barrier()
    dist.destroy_process_group()
    if rank < 2:
        regroup(2, "dp_store")
        threads = torch.get_num_threads()
        torch.set_num_threads(2 * threads)       # two ranks now share the cores
        t0 = time.perf_counter()
        dp_ranks(*dp)
        dist.barrier()
        if rank == 0:
            with open(os.path.join(out, "dp_s.json"), "w") as f:
                json.dump(time.perf_counter() - t0, f)
        torch.set_num_threads(threads)
        dist.destroy_process_group()
    regroup(MESH_RANKS, "end_store")
    return 0


def no_tf32() -> None:
    """Float32 products and convolutions, as the rest of the script runs."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dp_ranks(runs: list, trace_path: str) -> int:
    """Phase 21 (d) on one started rank (as under ``torchrun``), TF32 off as
    in this process: each ``(module, argv)`` pipeline's ``main`` in turn,
    ``decode_asr`` with each decode step's top two log-probs per row
    recorded (:func:`row_trace`) for the near-tie rule."""
    import importlib

    import torch.distributed as dist

    no_tf32()
    for module, argv in runs:
        with row_trace() as trace:
            check(importlib.import_module(module).main(argv) == 0, f"{module} {argv}")
        if module.endswith("decode_asr"):
            with open(f"{trace_path}.rank{dist.get_rank()}", "wb") as f:
                pickle.dump(trace, f)
    return 0


@contextlib.contextmanager
def row_trace():
    """For every static greedy decode run inside: per step the top two
    log-probs and ids of every row ([B, 2] each, on the host)."""
    import torch

    from loco_asr_tpu_torch.models.speecht5 import model as st5

    trace, real = [], st5.asr_decode_step

    def step(model, tok, t, *a, **kw):
        logits = real(model, tok, t, *a, **kw)
        if isinstance(t, int) and t == 0:
            trace.append([])
        vals, ids = torch.topk(torch.log_softmax(logits.float(), dim=-1), 2, dim=-1)
        trace[-1].append((vals.cpu(), ids.cpu()))
        return logits

    st5.asr_decode_step = step
    try:
        yield trace
    finally:
        st5.asr_decode_step = real


def rows_agree(got_rows, want_rows, eos: int, what: str):
    """Traced greedy rows (:func:`traced_rows`) of a data-parallel decode
    against the single run's, each cut at its first EOS: equal, or parting
    at a near-tie (phase 12's rule, K = 1: the ``got`` token is ``want``'s
    second candidate and ``want``'s two candidates lie within
    DECODE_TIE_ATOL).  Returns the partings [(row, step, gap)]."""
    def tokens(row):
        ids = [int(i[0]) for _, i in row]
        return ids[:ids.index(eos) + 1] if eos in ids else ids

    parts = []
    for r, (grow, wrow) in enumerate(zip(got_rows, want_rows)):
        g, w = tokens(grow), tokens(wrow)
        if g == w:
            continue
        t = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), min(len(g), len(w)))
        check(t < min(len(g), len(w)), f"{what}: row {r} ends at another step")
        vals, ids = wrow[t]
        gap = float(vals[0] - vals[1])
        check(int(g[t]) == int(ids[1]) and gap <= DECODE_TIE_ATOL,
              f"{what}: row {r} parts at step {t} where the candidates lie {gap} "
              "apart (or on a third candidate): not a near-tie")
        parts.append([r, t, gap])
    return parts


def traced_rows(trace, batch_rows: list) -> list:
    """Per utterance (in batch order) its steps' (values, ids) from a
    :func:`row_trace` of the decodes of consecutive batches."""
    rows = []
    for steps, n in zip(trace, batch_rows):
        for r in range(n):
            rows.append([(v[r], i[r]) for v, i in steps])
    return rows


def mesh_phase(corpus: dict, smi: str, dev) -> dict:
    """Phase 21: four ranks on one card over gloo (``parallel/launch.py``:
    ranks share the card, so collectives are staged through host memory;
    their times say nothing of NCCL).  One start of four ranks runs (a),
    (b), (c), (e) and phase 22 (sequence parallelism, its single-device
    references made here first), then two of them (d).  Phase 22's
    record is ``res["sp"]``."""
    import torch

    from loco_asr_tpu_torch.parallel import launch
    from loco_asr_tpu_torch.pipelines import train_asr

    t_phase = time.perf_counter()
    res = {"card": smi, "collectives": "gloo, staged through host memory, 4 ranks on one card"}
    host = asr_host_batches(corpus["train"], MESH_STEPS)
    rng = np.random.default_rng(21)
    lm = [{"ids": rng.integers(0, 256, (8, 1024)), "lengths": np.full(8, 1024)}
          for _ in range(MESH_LM_STEPS)]
    batches = {"asr": [{k: b[k] for k in ("input_values", "attention_mask", "labels")}
                       for b in host], "lm": lm}
    cases = [("asr_2,1,2", "asr", (2, 1, 2)), ("asr_1,2,2", "asr", (1, 2, 2)),
             ("lm_1,2,2", "lm", (1, 2, 2))]
    with tempfile.TemporaryDirectory() as tmp:
        # (a), (b): the single-device steps on the card, (d)'s single runs,
        # then the ranks, which go on with (c), (e) and (d)
        t0 = time.perf_counter()
        single = {kind: mesh_steps(kind, batches[kind], dev) for kind in ("asr", "lm")}
        torch.cuda.empty_cache()
        res["single_s"] = time.perf_counter() - t0
        dp = dp_single(corpus, tmp)
        sp = sp_single(tmp, smi, dev)
        path = os.path.join(tmp, "batches.pkl")
        with open(path, "wb") as f:
            pickle.dump(batches, f)
        out = os.path.join(tmp, "asr")
        common = ["--train_dir", corpus["train"], "--out_dir", out, "--attn_impl", "flash",
                  "--batch_size", "8", "--conversation_seconds", "10", "--eval_every", "100",
                  "--warmup_steps", "2", "--lr", "1e-4"]
        train_runs = [[*common, "--mesh", "2,1,2", "--steps", "2", "--save_every", "2"],
                      [*common, "--mesh", "2,1,2", "--steps", "3", "--resume",
                       "--save_every", "3"]]
        t0 = time.perf_counter()
        launch.spawn(mesh_rank_cases, (tmp, cases, path, train_runs,
                                       (dp["runs"], dp["trace_path"]), sp["batches_path"]),
                     MESH_RANKS, "cuda")
        res["ranks_wall_s"] = time.perf_counter() - t0
        ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json"))) for r in range(MESH_RANKS)]
        t0 = time.perf_counter()
        res["sp"] = sp_check(sp, [r["sp"] for r in ranks], tmp, smi)
        res["sp"]["check_s"] = time.perf_counter() - t0
        res["sp"]["wall_s"] = (res["sp"]["single_s"] + max(res["sp"]["ranks_sp_wall_s"])
                               + res["sp"]["check_s"])
        print(f"[sp] phase 22 {res['sp']['wall_s']:.1f} s (single-device references "
              f"{res['sp']['single_s']:.1f} s, ranks {max(res['sp']['ranks_sp_wall_s']):.1f} s, "
              f"checks {res['sp']['check_s']:.1f} s); card {smi}")
        dp["res"]["data_parallel_s"] = json.load(open(os.path.join(tmp, "dp_s.json")))
        res["dp"] = dp_check(dp, smi)
        # (c): the single-device trainer resumes the mesh run's step 6
        # (strict loads of the parameters and the optimizer state), no step
        t0 = time.perf_counter()
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            check(train_asr.main([*common, "--steps", "3", "--resume"]) == 0,
                  "single-device train_asr --resume of the mesh run")
        check("resumed at step 3" in err.getvalue(), "the single trainer did not resume")
        with np.load(os.path.join(out, "ckpt", "step_3.npz")) as z3:
            check(int(z3["opt_state.count"]) == 3, "the resumed mesh run's count")
            keys = [k for k in z3.files if k.startswith("params.")]
            check(all(np.isfinite(z3[k]).all() for k in keys), "non-finite saved params")
        res["train_asr"] = {"mesh_run_s": ranks[0]["train_asr_0_s"],
                            "resume_run_s": ranks[0]["train_asr_1_s"],
                            "single_resume_s": time.perf_counter() - t0, "params": len(keys)}
        print(f"[mesh] train_asr --mesh 2,1,2: 2 steps + --resume to 3, resumed by the "
              f"single trainer: {json.dumps(res['train_asr'])}; card {smi}")
    for name, kind, dims in cases:
        ref = single[kind]
        per = [r[name] for r in ranks]
        for r, rec in enumerate(per):
            for i, (a, b) in enumerate(zip(rec["loss"], ref["loss"])):
                check(abs(a - b) <= MESH_LOSS_ATOL, f"{name} rank {r} step {i}: loss {a} vs {b}")
            for i, (a, b) in enumerate(zip(rec["grad_norm"], ref["grad_norm"])):
                check(abs(a - b) <= MESH_GNORM_RTOL * b,
                      f"{name} rank {r} step {i}: grad_norm {a} vs {b}")
            check(rec["state_bytes"] == rec["expected_state_bytes"],
                  f"{name} rank {r}: {rec['state_bytes']} bytes of state, the rules give "
                  f"{rec['expected_state_bytes']}")
            h = MESH_HEADS // dims[2]
            want = ({f"B1:h{h}:d64": 18, f"B3/B4:h{h}:d64": 18, f"B5:h{h}:d64": 6}
                    if kind == "asr" else {f"B6:h{h}:d64": 12})
            check(rec["by_head_dim"] == want, f"{name} rank {r}: launches {rec['by_head_dim']}")
        res[name] = {
            "mesh": per[0]["mesh"], "heads_per_rank": MESH_HEADS // dims[2],
            "loss": per[0]["loss"], "single_loss": ref["loss"],
            "d_loss": max(abs(a - b) for rec in per for a, b in zip(rec["loss"], ref["loss"])),
            "d_grad_norm_rel": max(abs(a - b) / b for rec in per
                                   for a, b in zip(rec["grad_norm"], ref["grad_norm"])),
            "launches_per_rank_step": per[0]["launches"], "by_head_dim": per[0]["by_head_dim"],
            "step_ms_by_rank": [rec["ms"] for rec in per], "single_step_ms": ref["ms"],
            "max_memory_allocated_by_rank": [rec["max_memory_allocated"] for rec in per],
            "single_max_memory_allocated": ref["max_memory_allocated"],
            "state_bytes_by_rank": [rec["state_bytes"] for rec in per],
            "single_state_bytes": ref["state_bytes"]}
        print(f"[mesh] {name} {json.dumps(res[name])} (card {smi}; collectives gloo, "
              "staged through host memory)")
    # (e) ran on the same ranks after (a) and (b)
    dry = ranks[0]["dryrun"]
    check(dry["sharded"]["d_loss"] < 1e-4 and dry["sharded"]["d_grad_norm_rel"] < 1e-3,
          f"dryrun_multichip(4): {dry}")
    check(dry["asr_ring"]["d_loss"] < 1e-4 and dry["asr_ring"]["d_grad_norm_rel"] < 1e-3
          and abs(dry["ulysses_mean_nll"] - dry["ring_mean_nll"]) < 1e-4
          and abs(dry["dp_sp_mean_nll"] - dry["ring_mean_nll"]) < 1e-4,
          f"dryrun_multichip(4), sequence parallelism: {dry}")
    res["dryrun"] = dry
    res["wall_s"] = time.perf_counter() - t_phase
    print(f"[mesh] phase 21 {res['wall_s']:.1f} s; dryrun {json.dumps(res['dryrun'])}; "
          f"card {smi}")
    return res


def dp_single(corpus: dict, tmp: str) -> dict:
    """Phase 21 (d), first half: ``decode_asr`` (greedy, a full-width random
    model), ``extract_embeddings -m audio`` and ``eval_ppl --context_type
    max_len`` at ``--data_parallel 1`` in this process (``decode_asr``'s
    rows traced); returns the ``--data_parallel 2`` runs for the ranks
    (:func:`mesh_rank_cases`) and what :func:`dp_check` holds them to."""
    from loco_asr_tpu_torch.pipelines import decode_asr, eval_ppl, extract_embeddings

    res = {}
    slurp = os.path.join(tmp, "slurp")
    write_slurp(slurp, 24, seed=21)
    argv = {
        "decode_asr": ["--data_dir", corpus["dev"], "--beam_size", "1",
                       "--max_decode_len", "24", "--batch_size", "8",
                       "--limit_batches", "1", "--max_seconds", "10"],
        "extract_embeddings": ["-m", "audio", "-s", "train", "--data_path", slurp,
                               "--batch_size", "8"],
        "eval_ppl": ["-i", os.path.join(ROOT, "exp", "loco", "lm_corpus", "dev.txt"),
                     "--model", "gpt2", "--tokenizer", "char", "--context_type", "max_len",
                     "--max_len", "256", "--bsize", "8", "--limit_recordings", "2"]}
    outs = {(name, n): ["--out_dir" if name != "eval_ppl" else "-o",
                        os.path.join(tmp, f"{name}{n}"), "--data_parallel", str(n)]
            for name in argv for n in (1, 2)}
    t0 = time.perf_counter()
    with row_trace() as one_trace:
        check(decode_asr.main([*argv["decode_asr"], *outs["decode_asr", 1]]) == 0,
              "decode_asr")
    check(extract_embeddings.main([*argv["extract_embeddings"],
                                   *outs["extract_embeddings", 1]]) == 0,
          "extract_embeddings")
    check(eval_ppl.main([*argv["eval_ppl"], *outs["eval_ppl", 1]]) == 0, "eval_ppl")
    res["single_s"] = time.perf_counter() - t0
    return {"res": res, "tmp": tmp, "one_trace": one_trace,
            "trace_path": os.path.join(tmp, "trace"),
            "runs": [(f"loco_asr_tpu_torch.pipelines.{name}", [*argv[name], *outs[name, 2]])
                     for name in argv]}


def dp_check(dp: dict, smi: str) -> dict:
    """Phase 21 (d), second half: each ``--data_parallel 2`` run (on two
    ranks) held to its single run."""
    res, tmp, one_trace, trace_path = dp["res"], dp["tmp"], dp["one_trace"], dp["trace_path"]
    hyp = lambda d: [l.split(None, 1) for l in open(os.path.join(tmp, d, "hyp.text"))]
    h1, h2 = hyp("decode_asr1"), hyp("decode_asr2")
    check([a[0] for a in h1] == [a[0] for a in h2], "decode_asr: utterance order")
    ties = []
    if h1 != h2:     # hold the rows to the near-tie rule
        want_rows = traced_rows(one_trace, [8] * len(one_trace))
        rank_traces = [pickle.load(open(f"{trace_path}.rank{r}", "rb")) for r in range(2)]
        got_rows = []
        for b in range(len(one_trace)):
            for r in range(2):
                got_rows += [[(v[i], ids[i]) for v, ids in rank_traces[r][b]]
                             for i in range(4)]
        ties = rows_agree(got_rows, want_rows, 2, "decode_asr --data_parallel 2")
    res["decode_asr"] = {"utterances": len(h1), "equal_hyps": h1 == h2, "near_ties": ties}

    emb = {n: extract_store(os.path.join(tmp, f"extract_embeddings{n}")) for n in (1, 2)}
    err = max(float(np.abs(a - b).max()) for a, b in zip(emb[1], emb[2]))
    check(len(emb[1]) == len(emb[2]) == 24 and err <= DP_EMB_ATOL,
          f"extract_embeddings --data_parallel 2: max |diff| {err}")
    res["extract_embeddings"] = {"records": 24, "max_abs_err": err}

    ppl = {n: json.load(open(os.path.join(tmp, f"eval_ppl{n}", "rec_id2ppl.json")))
           for n in (1, 2)}
    rel = max(abs(ppl[2][k] - v) / v for k, v in ppl[1].items())
    check(ppl[1].keys() == ppl[2].keys() and rel <= DP_PPL_RTOL,
          f"eval_ppl --data_parallel 2: relative PPL gap {rel}")
    res["eval_ppl"] = {"recordings": len(ppl[1]), "max_rel_ppl_gap": rel}
    print(f"[mesh] data parallel {json.dumps(res)}; card {smi}")
    return res


# -- phase 22: sequence parallelism on the same four ranks --------------------

SP_RANKS = 4                   # the sequence axis of phase 22: phase 21's ranks
SP_STEPS = 2                   # ASR steps a scheme, each held to the single-device step
SP_FRAMES = 8200               # ~164 s: the nearest frame count to 164 s that divides 4
SP_LABELS = 2048               # the 164 s step's labels (phase 17's)
SP_RTOL = 1e-5                 # loss, grad norm, PPL: relative to the single-device run
SP_IMPLS = ("ring", "ulysses")


def sp_samples(cfg, frames: int) -> int:
    """The fewest samples whose conv frame count is ``frames``."""
    n = frames * 320
    while cfg.feat_extract_output_length(n) < frames:
        n += 1
    while cfg.feat_extract_output_length(n - 1) == frames:
        n -= 1
    return n


def sp_asr_model():
    """(config, seeded SpeechT5-base ASR model on the host): vocabulary 256,
    dropout and SpecAugment at their defaults (a copy of one seeded draw a
    process)."""
    from loco_asr_tpu_torch.models.speecht5 import model as st5
    from loco_asr_tpu_torch.models.speecht5.config import SpeechT5Config

    cfg = SpeechT5Config(vocab_size=256)
    if "sp_asr" not in _MESH_INITS:
        _MESH_INITS["sp_asr"] = st5.asr_model_init(cfg, seed=22, device="cpu")
    return cfg, copy.deepcopy(_MESH_INITS["sp_asr"])


def sp_asr_steps(batches: list, dev, impl: str, mesh=None, capture: bool = False) -> dict:
    """Phase 22 (a): ``SP_STEPS`` ASR steps (AdamW 1e-4, the feature encoder
    frozen, dropout on) from the seeded init on ``batches`` (B = 1 at
    ~164 s): ``impl`` "flash" on one device, or "ring" / "ulysses" over the
    sequence axis of ``mesh``; per step the loss, grad norm, ms and bytes
    through gloo, the first step's launches by kernel and head count (its
    kernel inputs captured when ``capture``), and the peak memory."""
    import torch

    from loco_asr_tpu_torch.parallel import train

    cfg, model = sp_asr_model()
    model.to(dev)
    tx = train.adamw(MESH_LR)
    params = train.trainable_params(model, freeze_feature_encoder=True)
    opt_state = tx.init(params)
    step = train.make_asr_train_step(cfg, tx, attn_impl=impl, freeze_feature_encoder=True,
                                     mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(22)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    rec = {"loss": [], "grad_norm": [], "ms": [], "gloo_bytes": [], "captured": {}}
    for i, host in enumerate(batches):
        batch = (train.shard_batch(host, mesh) if mesh is not None
                 else {k: torch.as_tensor(v, device=dev) for k, v in host.items()})
        reset_all_launches()
        grab = captured_launches() if capture and i == 0 else contextlib.nullcontext({})
        with launches_by_heads() as heads, gloo_traffic() as traffic, grab as cases:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(model, opt_state, batch, gen)
            loss = float(m["loss"])
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            rec["launches"], rec["by_head_dim"] = all_launches(), dict(heads)
            rec["captured"] = cases
        rec["loss"].append(loss)
        rec["grad_norm"].append(float(m["grad_norm"]))
        rec["gloo_bytes"].append(traffic["bytes"])
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    del model, opt_state
    torch.cuda.empty_cache()
    return rec


@contextlib.contextmanager
def gloo_traffic():
    """Bytes this rank hands to ``torch.distributed`` while the block runs:
    all-reduce and all-gather buffers, point-to-point sends (the ring's
    shifts, gloo's all-to-all)."""
    import torch.distributed as dist

    real = {n: getattr(dist, n) for n in ("all_reduce", "all_gather", "batch_isend_irecv")}
    tally = {"bytes": 0}

    def nbytes(t):
        return t.numel() * t.element_size()

    def all_reduce(t, *a, **kw):
        tally["bytes"] += nbytes(t)
        return real["all_reduce"](t, *a, **kw)

    def all_gather(parts, t, *a, **kw):
        tally["bytes"] += nbytes(t)
        return real["all_gather"](parts, t, *a, **kw)

    def batch_isend_irecv(ops):
        tally["bytes"] += sum(nbytes(op.tensor) for op in ops if op.op is dist.isend)
        return real["batch_isend_irecv"](ops)

    dist.all_reduce, dist.all_gather, dist.batch_isend_irecv = (all_reduce, all_gather,
                                                                batch_isend_irecv)
    try:
        yield tally
    finally:
        for n, fn in real.items():
            setattr(dist, n, fn)


def sp_text_argv(out: str) -> dict:
    """Phase 22 (b)'s command lines: ``eval_ppl`` at gpt2 width on 16
    recordings of the committed LM dev text (windows of 1,024), and one
    ``train_lm`` step at [8, 1024]."""
    text = os.path.join(ROOT, "exp", "loco", "lm_corpus", "dev.txt")
    return {
        "eval_ppl": ["-i", text, "--model", "gpt2", "--tokenizer", "char",
                     "--context_type", "max_len", "--max_len", "1024", "--bsize", "8",
                     "--limit_recordings", "16"],
        "train_lm": ["--train_file", text, "--model", "gpt2", "--tokenizer", "char",
                     "--seq_len", "1024", "--batch_size", "8", "--steps", "1", "--lr", "1e-4",
                     "--warmup_steps", "1", "--log_every", "1", "--eval_every", "100",
                     "--save_every", "100", "--out_dir", os.path.join(out, "lm_sp")]}


def sp_single(tmp: str, smi: str, dev) -> dict:
    """Phase 22, the single-device references, in this process before the
    ranks start: (a)'s flash steps on the 164 s batches and (b)'s
    ``eval_ppl`` and ``train_lm --attn_impl flash`` runs."""
    import torch

    from loco_asr_tpu_torch.pipelines import eval_ppl, train_lm

    t0 = time.perf_counter()
    cfg = sp_asr_model()[0]
    n = sp_samples(cfg, SP_FRAMES)
    rng = np.random.default_rng(22)
    batches = [{"input_values": (rng.standard_normal((1, n)) * 0.1).astype(np.float32),
                "attention_mask": np.ones((1, n), np.int32),
                "labels": rng.integers(3, cfg.vocab_size, (1, SP_LABELS))}
               for _ in range(SP_STEPS)]
    path = os.path.join(tmp, "sp_batches.pkl")
    with open(path, "wb") as f:
        pickle.dump(batches, f)
    res = {"samples": n, "seconds": n / 16000, "frames": SP_FRAMES, "labels": SP_LABELS,
           "batches_path": path}
    # the flash step, and each scheme on a sequence axis of this one device:
    # the same arithmetic as the four ranks' (ring: float32 matmul blocks;
    # Ulysses: B1 and B3/B4 on all 12 heads), the decoder dense in both
    for impl in ("flash",) + SP_IMPLS:
        res[impl] = sp_asr_steps(batches, dev, impl)
        res[impl].pop("captured")
    argv = sp_text_argv(tmp)
    out = os.path.join(tmp, "ppl_single")
    check(eval_ppl.main([*argv["eval_ppl"], "-o", out]) == 0, "eval_ppl (single)")
    res["ppl"] = json.load(open(os.path.join(out, "rec_id2ppl.json")))
    lm_out = os.path.join(tmp, "lm_single")
    lm_argv = [a if a != os.path.join(tmp, "lm_sp") else lm_out for a in argv["train_lm"]]
    check(train_lm.main([*lm_argv, "--attn_impl", "flash"]) == 0, "train_lm (single)")
    res["lm_loss"] = [json.loads(l)["loss"] for l in open(os.path.join(lm_out, "metrics.jsonl"))
                      if '"loss"' in l][0]
    torch.cuda.empty_cache()
    res["single_s"] = time.perf_counter() - t0
    return res


def sp_rank_cases(out: str, batches_path: str) -> dict:
    """Phase 22 on one of phase 21's ranks (the world of four is the
    sequence axis): (a) the 164 s ASR steps under ring and Ulysses (rank
    0 captures the Ulysses step's kernel inputs); (b) ``eval_ppl
    --sequence_parallel 4`` under each scheme (rank 0 captures Ulysses'
    B5 inputs) and ``train_lm --attn_impl ring --sp_devices 4``, each
    launch counted on this rank.  Returns this rank's record."""
    import torch
    import torch.distributed as dist

    from loco_asr_tpu_torch.parallel import mesh as meshlib
    from loco_asr_tpu_torch.pipelines import eval_ppl, train_lm

    dev = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank()
    t_sp = time.perf_counter()
    batches = pickle.load(open(batches_path, "rb"))
    mesh = meshlib.make_sp_mesh(SP_RANKS, 1, device=dev)
    rec, captured = {}, {}
    for impl in SP_IMPLS:
        r = sp_asr_steps(batches, dev, impl, mesh, capture=rank == 0 and impl == "ulysses")
        captured.update(r.pop("captured"))
        rec[impl] = r
    argv = sp_text_argv(out)
    for impl in SP_IMPLS:
        reset_all_launches()
        grab = (captured_launches() if rank == 0 and impl == "ulysses"
                else contextlib.nullcontext({}))
        with launches_by_heads() as heads, grab as cases:
            t0 = time.perf_counter()
            check(eval_ppl.main([*argv["eval_ppl"], "-o", os.path.join(out, f"ppl_{impl}"),
                                 "--sequence_parallel", str(SP_RANKS), "--sp_impl", impl]) == 0,
                  f"eval_ppl --sp_impl {impl}")
            rec[f"eval_ppl_{impl}"] = {"s": time.perf_counter() - t0, "launches": all_launches(),
                                       "by_head_dim": dict(heads)}
        captured.update(cases)
    reset_all_launches()
    with gloo_traffic() as traffic:
        t0 = time.perf_counter()
        check(train_lm.main([*argv["train_lm"], "--attn_impl", "ring",
                             "--sp_devices", str(SP_RANKS)]) == 0, "train_lm --attn_impl ring")
        rec["train_lm"] = {"s": time.perf_counter() - t0, "launches": all_launches(),
                           "gloo_bytes": traffic["bytes"]}
    if rank == 0:
        torch.save(captured, os.path.join(out, "sp_captured.pt"))
    rec["wall_s"] = time.perf_counter() - t_sp
    torch.cuda.empty_cache()
    return rec


def sp_check(single: dict, ranks: list, out: str, smi: str) -> dict:
    """Phase 22, held: every rank's losses and grad norms within
    ``SP_RTOL`` of the same scheme's on one device (the same arithmetic),
    and against the single-device flash step the losses within ``SP_RTOL``
    and the grad norms within ``GNORM_RTOL`` (phases 8 and 17's bound
    between the kernels' and the plain arithmetic: at 164 s flash and dense
    differ by ~4e-5 in the grad norm, PR 13); the launches a rank and step
    (ring: B2 only, the encoder's blocks are matmuls; Ulysses: 12 B1 and 12
    B3/B4 at 3 heads, B2); the perplexities of both schemes and the ring
    ``train_lm`` step's loss within ``SP_RTOL`` of the single-device runs,
    Ulysses' B5 at 3 heads in ``eval_ppl``; then the captured kernel inputs
    replayed against their plain versions."""
    import torch

    flash = single["flash"]
    res = {"card": smi, "collectives": f"gloo, staged through host memory, {SP_RANKS} ranks "
                                       "on one card",
           "window": {k: single[k] for k in ("samples", "seconds", "frames", "labels")},
           "single_s": single["single_s"]}
    for impl in ("flash",) + SP_IMPLS:
        res[f"single_{impl}"] = {k: single[impl][k] for k in (
            "loss", "grad_norm", "ms", "max_memory_allocated", "launches", "by_head_dim")}
    heads = MESH_HEADS // SP_RANKS
    want = {"ring": {}, "ulysses": {f"B1:h{heads}:d64": 12, f"B3/B4:h{heads}:d64": 12}}
    rel = lambda a, b: abs(a - b) / abs(b)
    for impl in SP_IMPLS:
        per = [r[impl] for r in ranks]
        one = single[impl]
        for r, rec in enumerate(per):
            for i in range(SP_STEPS):
                for key in ("loss", "grad_norm"):
                    check(rel(rec[key][i], one[key][i]) <= SP_RTOL,
                          f"{impl} rank {r} step {i}: {key} {rec[key][i]} vs one device's "
                          f"{one[key][i]}")
                check(rel(rec["loss"][i], flash["loss"][i]) <= SP_RTOL,
                      f"{impl} rank {r} step {i}: loss {rec['loss'][i]} vs flash "
                      f"{flash['loss'][i]}")
                check(rel(rec["grad_norm"][i], flash["grad_norm"][i]) <= GNORM_RTOL,
                      f"{impl} rank {r} step {i}: grad_norm {rec['grad_norm'][i]} vs flash "
                      f"{flash['grad_norm'][i]}")
            check(rec["by_head_dim"] == want[impl] and rec["launches"]["B2"] == 1,
                  f"{impl} rank {r}: launches {rec['by_head_dim']} {rec['launches']}")
        pairs = lambda ref, key: [rel(a, b) for rec in per for a, b in zip(rec[key], ref[key])]
        res[impl] = {
            "loss": per[0]["loss"], "grad_norm": per[0]["grad_norm"],
            "d_loss_rel_one_device": max(pairs(one, "loss")),
            "d_grad_norm_rel_one_device": max(pairs(one, "grad_norm")),
            "d_loss_rel_flash": max(pairs(flash, "loss")),
            "d_grad_norm_rel_flash": max(pairs(flash, "grad_norm")),
            "step_ms_by_rank": [rec["ms"] for rec in per],
            "max_memory_allocated_by_rank": [rec["max_memory_allocated"] for rec in per],
            "gloo_bytes_by_rank_step": [rec["gloo_bytes"] for rec in per],
            "launches_per_rank_step": per[0]["launches"], "by_head_dim": per[0]["by_head_dim"]}
        print(f"[sp] {impl} train step at {single['seconds']:.3f} s ({SP_FRAMES} frames) "
              f"{json.dumps(res[impl])}; one device {json.dumps(res[f'single_{impl}'])}; "
              f"flash {json.dumps(res['single_flash'])} (card {smi}; gloo, staged through "
              "host memory)")
        ppl = json.load(open(os.path.join(out, f"ppl_{impl}", "rec_id2ppl.json")))
        check(ppl.keys() == single["ppl"].keys(), f"eval_ppl {impl}: recordings")
        gap = max(abs(ppl[k] - v) / v for k, v in single["ppl"].items())
        check(gap <= SP_RTOL, f"eval_ppl --sp_impl {impl}: relative PPL gap {gap}")
        ev = [r[f"eval_ppl_{impl}"] for r in ranks]
        b5 = {f"B5:h{heads}:d64": ev[0]["by_head_dim"].get(f"B5:h{heads}:d64", 0)}
        check(all(e["by_head_dim"] == (b5 if impl == "ulysses" else {}) for e in ev)
              and (impl == "ring" or b5[f"B5:h{heads}:d64"] > 0),
              f"eval_ppl {impl} launches {[e['by_head_dim'] for e in ev]}")
        res[f"eval_ppl_{impl}"] = {"recordings": len(ppl), "max_rel_ppl_gap": gap,
                                   "s_by_rank": [e["s"] for e in ev],
                                   "by_head_dim": ev[0]["by_head_dim"]}
    lm_loss = [json.loads(l)["loss"] for l in open(os.path.join(out, "lm_sp", "metrics.jsonl"))
               if '"loss"' in l][0]
    check(abs(lm_loss - single["lm_loss"]) <= SP_RTOL * abs(single["lm_loss"]),
          f"train_lm --attn_impl ring: loss {lm_loss} vs flash {single['lm_loss']}")
    res["train_lm_ring"] = {"loss": lm_loss, "flash_loss": single["lm_loss"],
                            "s_by_rank": [r["train_lm"]["s"] for r in ranks],
                            "gloo_bytes_by_rank": [r["train_lm"]["gloo_bytes"] for r in ranks]}
    captured = torch.load(os.path.join(out, "sp_captured.pt"), weights_only=False)
    res["held"] = hold_captured(captured)
    res["ranks_sp_wall_s"] = [r["wall_s"] for r in ranks]
    text = {k: res[k] for k in ("eval_ppl_ring", "eval_ppl_ulysses", "train_lm_ring")}
    print(f"[sp] eval_ppl / train_lm {json.dumps(text)}; held {json.dumps(res['held'])}; "
          f"card {smi}")
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from loco_asr_tpu_torch.data import lm_datasets
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

    t_run = time.perf_counter()
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

    print(f"[time] phase 2 from {time.perf_counter() - t_run:.1f} s")
    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    print(f"[build] {os.path.relpath(path)} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {'ran' if _build.build_seconds is not None else 'skipped: cached'})")
    for line in _build.build_log.splitlines():
        if any(w in line for w in ("registers", "Compiling entry", "spill")):
            print(f"[build] {line.strip()}")
    b34_recs = b34_build_records(_build)
    for rec in (b1_build_records(_build) + b34_recs + b2_b7_build_records(_build)
                + b56_wgmma_build_records(_build)):
        print(f"[build] {rec['kernel']} {json.dumps(rec)}")

    # the committed ASR corpus, with its wav.scp pointing into this checkout
    tmp_corpus = tempfile.TemporaryDirectory()
    corpus = relocate_corpus(tmp_corpus.name)
    win_wav, win_lengths, win_texts = corpus_windows(corpus["train"], 8)

    print(f"[time] phase 3 from {time.perf_counter() - t_run:.1f} s")
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
        (b3b, b3f), (b4b, b4f) = b34_work(q, k, pe, vl, causal, mask_only)
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

    print(f"[time] phase 4 from {time.perf_counter() - t_run:.1f} s")
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

    print(f"[time] phase 5 from {time.perf_counter() - t_run:.1f} s")
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

    print(f"[time] phase 6 from {time.perf_counter() - t_run:.1f} s")
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

    print(f"[time] phase 7 from {time.perf_counter() - t_run:.1f} s")
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

    print(f"[time] phase 8 from {time.perf_counter() - t_run:.1f} s")
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
    host_batches = asr_host_batches(corpus["train"])

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

    print(f"[time] phase 9 from {time.perf_counter() - t_run:.1f} s")
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

    print(f"[time] phase 10 from {time.perf_counter() - t_run:.1f} s")
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
    print(f"[time] phase 11 from {time.perf_counter() - t_run:.1f} s")
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

    print(f"[time] phase 12 from {time.perf_counter() - t_run:.1f} s")
    # -- 12. ASR decoding with GPT-2 fusion and carry-over ------------------
    decode_launches = decode_phase(corpus, win_wav, win_lengths, smi, dev)
    tmp_corpus.cleanup()

    print(f"[time] phase 13 from {time.perf_counter() - t_run:.1f} s")
    # -- 13. LM training at gpt2 width, the LoCo experiment ------------------
    lm_train_launches = lm_training_phase(smi, dev)

    print(f"[time] phase 14 from {time.perf_counter() - t_run:.1f} s")
    # -- 14. SLURP intent classification at full width -----------------------
    intent_launches = intent_phase(smi, dev)

    print(f"[time] phase 15 from {time.perf_counter() - t_run:.1f} s")
    # -- 15. the LoCo decodes on the reference's trained weights -------------
    reference_launches = loco_reference_phase(smi, dev)

    print(f"[time] phase 16 from {time.perf_counter() - t_run:.1f} s")
    # -- 16. mixed precision: the bf16 forms of B1-B6 ----------------------
    tmp_corpus = tempfile.TemporaryDirectory()
    corpus = relocate_corpus(tmp_corpus.name)
    mixed = mixed_precision_phase(corpus, host_batches, smi, dev)

    print(f"[time] phase 17 from {time.perf_counter() - t_run:.1f} s")
    # -- 17. conversation-scale ASR training: B3/B4 at every head dim, the
    # remat policies, train_asr --conversation_seconds 164 ----------------
    long = long_context_phase(corpus, b34_recs, smi, dev)

    print(f"[time] phase 18 from {time.perf_counter() - t_run:.1f} s")
    # -- 18. long-form episodes (transcribe_episodes), Adafactor, NaN
    # recovery, train_asr from HF weights, checkpoint averaging -----------
    episodes = episodes_phase(smi, dev)
    trainer = trainer_options_phase(corpus, smi, dev)
    tmp_corpus.cleanup()

    print(f"[time] phase 19 from {time.perf_counter() - t_run:.1f} s")
    # -- 19. Fisher corpus ingest: shorten SPHERE, fisher_prep, the sph_decode
    # pipes, train_asr / decode_asr / eval_ppl on the prepared splits; the
    # generic feature encoder --------------------------------------------
    fisher = fisher_phase(smi, dev)

    print(f"[time] phase 20 from {time.perf_counter() - t_run:.1f} s")
    # -- 20. orbax step directories (read without orbax), eval_ppl on the
    # committed LM, the profiling timer on B1, the examples -----------------
    orbax = orbax_phase(smi, dev)

    print(f"[time] phase 21 from {time.perf_counter() - t_run:.1f} s")
    # -- 21. the (data, fsdp, tensor) mesh: four ranks on the card over gloo;
    # 22. sequence parallelism (ring, Ulysses) on the same ranks ---------
    tmp_corpus = tempfile.TemporaryDirectory()
    mesh = mesh_phase(relocate_corpus(tmp_corpus.name), smi, dev)
    tmp_corpus.cleanup()
    mesh_launches = {k: mesh[name]["by_head_dim"].get(f"{k}:h6:d64", 0)
                     for name, kinds in (("asr_2,1,2", ("B1", "B3/B4", "B5")),
                                         ("lm_1,2,2", ("B6",))) for k in kinds}
    sp = mesh["sp"]
    h_sp = MESH_HEADS // SP_RANKS
    sp_launches = {k: sp["ulysses"]["by_head_dim"].get(f"{k}:h{h_sp}:d64", 0)
                   for k in ("B1", "B3/B4")}
    sp_launches["B5"] = sp["eval_ppl_ulysses"]["by_head_dim"].get(f"B5:h{h_sp}:d64", 0)
    sp_launches["B2"] = sp["ulysses"]["launches_per_rank_step"]["B2"]

    def sp_held(kernel):
        """Phase 22's captured launches of ``kernel``: the largest error
        against the plain version, with the shapes."""
        recs = [r for r in sp["held"] if r["kernel"] == kernel]
        return dict(max_abs_err=max(r["max_abs_err"] for r in recs),
                    cases=[r["case"] for r in recs]) if recs else None

    print(f"[time] phase 23 from {time.perf_counter() - t_run:.1f} s")
    # -- 23. summary -------------------------------------------------------
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
        causal cases above carry SDPA's.  ``head_dims``: phase 17 (a)'s
        forms at the other head dims; ``d8_launches``: phase 17 (b)'s
        training runs at head dim 8; ``train_asr_164_launches``: phase 17
        (d)'s long-context run."""
        main_rec = next(c for c in checks if c["kernel"] == "B3/B4" and c["case"] == "enc_padded")
        bms, by = main_rec[f"{which}_bound"]
        dims = [dict(case=r["case"], form=r["form"], shape=r["shape"], ms=r[f"{which}_ms"],
                     wrapper_ms=r["ms"], plain_ms=r["plain_ms"], library_ms=r["library_ms"],
                     bound_ms=r[f"{which}_bound"][0], bound_by=r[f"{which}_bound"][1],
                     max_abs_err=r["max_abs_err"], build=r["build"].get(which.upper()))
                for r in long["b34_dims"]]
        return dict(name=name, route="cuda", source="loco_asr_tpu_torch/csrc/flash_rel_bwd.cu",
                    replaces=replaces, tpu_kernel=tpu_kernel, launches=asr_launches["B3/B4"],
                    max_abs_err=max(c["max_abs_err"] for c in checks if c["kernel"] == "B3/B4"),
                    ms=main_rec[f"{which}_ms"], kernel_ms=main_rec[f"{which}_ms"],
                    wrapper_ms=main_rec["ms"], plain_ms=main_rec["plain_ms"],
                    bound_ms=bms, bound_by=by, library_ms=main_rec["library_ms"],
                    d8_launches=sum(r["by_head_dim"].get("B3/B4:d8:f32", 0)
                                    for r in long["d8_runs"].values() if "by_head_dim" in r),
                    train_asr_164_launches=long["train_asr_164"]["launches"]["B3/B4"],
                    adafactor_train_asr_launches=trainer["train_asr"]["launches"]["B3/B4"],
                    fisher_launches=fisher["launches"]["B3/B4"], head_dims=dims,
                    mesh_rank_step_launches=mesh_launches["B3/B4"],
                    sp_ulysses_rank_step_launches=sp_launches["B3/B4"],
                    sp_ulysses_held=sp_held("B3/B4"))

    # B1's and B2's launches on the decode path: phase 12's six decode_asr
    # runs, phase 13's LoCo ASR stage and phase 15's decodes on the
    # reference weights; on the intent slice's audio extraction (phase 14);
    # B1's time at head dim 8 (the LoCo encoder's) beside the main case's
    # phase 18's launches: B1 and B2 over the episode runs (per episode,
    # continuous greedy and beam), B5 in the gpt2-xl steps and train_lm run,
    # B3/B4 in the Adafactor train_asr run
    ep_launches = {k: sum(episodes[m]["launches"][k] for m in ("per_episode", "continuous", "beam"))
                   for k in ("B1", "B2")}
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
             d8_bound_ms=d8["bound_ms"],
             train_asr_164_launches=long["train_asr_164"]["launches"]["B1"],
             d12_decode_launches=long["d8_runs"]["decode_asr_tiny"]["launches"]["B1"],
             episode_launches=ep_launches["B1"],
             episode_120s_device_ms=episodes["b1_120s"]["device_ms"],
             adafactor_train_asr_launches=trainer["train_asr"]["launches"]["B1"],
             fisher_launches=fisher["launches"]["B1"],
             examples_launches=orbax["examples_launches"]["B1"],
             device_time_per_iter_ms=orbax["b1_timers"]["device_time_per_iter_ms"],
             mesh_rank_step_launches=mesh_launches["B1"],
             sp_ulysses_rank_step_launches=sp_launches["B1"], sp_ulysses_held=sp_held("B1")),
        dict(entry("conv1_instance_norm_gelu", "loco_asr_tpu_torch/csrc/conv_frontend.cu",
                   "loco_asr_tpu/ops/pallas/conv_frontend.py:56",
                   "conv_frontend.py::_kernel", "B2", "main", launches["B2"]),
             decode_launches=decode_launches["B2"],
             loco_launches=lm_train_launches["loco_asr"]["B2"],
             loco_reference_launches=reference_launches["B2"],
             intent_launches=intent_launches["B2"], episode_launches=ep_launches["B2"],
             fisher_launches=fisher["launches"]["B2"],
             examples_launches=orbax["examples_launches"]["B2"],
             sp_rank_step_launches=sp_launches["B2"], sp_held=sp_held("B2")),
        dict(entry("flash_forward", "loco_asr_tpu_torch/csrc/flash_causal.cu",
                   "loco_asr_tpu/ops/pallas/flash_attention.py:40",
                   "flash_attention.py::_flash_kernel", "B5", "gpt2xl", lm_launches["B5"]),
             train_asr_164_launches=long["train_asr_164"]["launches"]["B5"],
             gpt2_xl_train_launches=(trainer["gpt2_xl"]["steps"]["adafactor"]["launches"]["B5"]
                                     + trainer["gpt2_xl"]["steps"]["adamw"]["launches"]["B5"]
                                     + trainer["gpt2_xl"]["train_lm"]["launches"]["B5"]),
             orbax_eval_ppl_launches=orbax["eval_ppl_launches"]["B5"],
             mesh_rank_step_launches=mesh_launches["B5"],
             sp_ulysses_eval_ppl_launches=sp_launches["B5"], sp_ulysses_held=sp_held("B5")),
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
             train_lm_backward_calls=lm_train_launches["train_lm"]["B6_bwd"],
             fisher_launches=fisher["launches"]["B6"],
             mesh_rank_step_launches=mesh_launches["B6"]),
        entry("fused_log_mel", "loco_asr_tpu_torch/csrc/logmel.cu",
              "loco_asr_tpu/ops/pallas/logmel.py:40",
              "logmel.py::_logmel_kernel", "B7", "corpus_10s", b7_launches),
    ] + bf16_entries(mixed)
    print(f"[summary] card: {smi}; profiler windows "
          f"{json.dumps(PROFILER_WINDOWS)}")
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


def mesh_phase_main() -> int:
    """``--mesh-phase``: the build, then phases 21 and 22 alone."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from loco_asr_tpu_torch.ops.cuda import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] nvidia-smi: {smi}")
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print(f"[env] build {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        res = mesh_phase(relocate_corpus(tmp), smi, torch.device("cuda"))
    print(json.dumps({"mesh_phase": res}))
    return 0


if __name__ == "__main__":
    sys.exit(kernel_cases_main() if sys.argv[1:] == ["--kernel-cases"]
             else mesh_phase_main() if sys.argv[1:] == ["--mesh-phase"] else main())
