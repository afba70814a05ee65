"""Run the LoCo context-gain experiment end to end on one GPU: the port of
``loco_asr_tpu.pipelines.loco_experiment``.

Conversation-level context should make language modelling, and with it
ASR, better.  ``data/synthetic_conversations.py`` builds corpora where that
is true by construction (a per-conversation name: unpredictable within an
utterance, a copy given the history; dev names disjoint from train), and
this pipeline runs the comparison with the port's own pipelines:

LM half:   make_lm_corpus -> train_lm (tiny GPT-2 on conversation
           streams) -> eval_ppl --context_type {indep,max_len,streaming}
           on held-out conversations -> PPL(max_len) < PPL(indep).
ASR half:  make_asr_corpus (clean first mention, degraded repeats) ->
           train_asr --tiny --config_json -> train_lm --eos_id 2 on a
           text-only corpus -> decode the dev conversations with the same
           fusion LM: decode_conversations (carry-over) against
           decode_continuous (context reset each utterance), no fusion,
           and an oracle pass whose LM is primed with the true history.

Same flags, stages and ``results.json`` / ``asr_hyps.json`` keys as the JAX
pipeline, plus ``--device`` (default cuda; cpu runs the plain PyTorch
versions).  On the GPU every encode of the decodes runs kernels B2 and B1
(head dim 8 here); the trainers run ``--attn_impl dense``, as in JAX.
``--skip_training`` reuses ``asr/ckpt`` and ``asr_lm/ckpt`` when their
latest step is a ``.npz`` (this package trains and reads ``.npz`` steps;
an orbax directory there is refused, not overwritten).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import sys
import time
from typing import Dict, List, Tuple

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="LoCo context-gain experiment (synthetic conversations, CUDA)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--stage", choices=["all", "lm", "asr"], default="all")
    p.add_argument("--seed", type=int, default=0)
    # LM half
    p.add_argument("--lm_convs", type=int, default=600)
    p.add_argument("--lm_dev_convs", type=int, default=40)
    p.add_argument("--lm_utts", type=int, default=16)
    p.add_argument("--lm_steps", type=int, default=4000)
    p.add_argument("--lm_batch", type=int, default=16)
    p.add_argument("--lm_n_embd", type=int, default=128,
                   help="tiny-LM hidden size (train_lm --tiny_n_embd)")
    p.add_argument("--lm_n_layer", type=int, default=4)
    p.add_argument("--seq_len", type=int, default=256,
                   help="LM train seq len = eval context window")
    # ASR half
    p.add_argument("--asr_convs", type=int, default=200,
                   help="training conversations")
    p.add_argument("--asr_dev_convs", type=int, default=12)
    p.add_argument("--asr_utts", type=int, default=10)
    p.add_argument("--asr_lm_convs", type=int, default=2000,
                   help="text-only conversations for the fusion LM")
    p.add_argument("--asr_steps", type=int, default=4000)
    p.add_argument("--asr_batch", type=int, default=8)
    p.add_argument("--asr_lr", type=float, default=1e-3,
                   help="tiny-ASR learning rate")
    p.add_argument("--asr_lm_steps", type=int, default=8000)
    p.add_argument("--asr_lm_seq_len", type=int, default=256)
    p.add_argument("--fusion_weight", type=float, default=0.4)
    p.add_argument("--fusion_weights", default=None,
                   help="comma list: decode the dev set at each weight and "
                        "report all (one training, many decodes)")
    p.add_argument("--skip_training", action="store_true",
                   help="reuse the .npz checkpoints under out_dir/asr and "
                        "out_dir/asr_lm (decode-only reruns)")
    p.add_argument("--decode_max_len", type=int, default=40)
    p.add_argument("--rng_impl", default=None,
                   choices=[None, "threefry", "rbg", "unsafe_rbg"],
                   help="forwarded to the trainers, which ignore it")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch versions")
    return p.parse_args(argv)


# the ASR front end of the experiment: 3 conv layers of 64 channels (a
# ~150 Hz resolution at a 400 Hz frame rate) under the tiny transformer;
# train_asr --config_json applies it and the decodes rebuild the same config
CONV_OVER = {"conv_dim": [64, 64, 64], "conv_stride": [5, 4, 2],
             "conv_kernel": [10, 8, 4], "max_speech_positions": 2048}


def _mean_nll(out_dir: str) -> Tuple[float, float]:
    """(overall token-mean NLL, avg per-recording PPL) from eval_ppl
    artifacts."""
    with open(os.path.join(out_dir, "rec_id2nlls.pkl"), "rb") as f:
        rec_id2nlls = pickle.load(f)
    flat = [x for nlls in rec_id2nlls.values() for utt in nlls for x in
            (utt if isinstance(utt, list) else [utt])]
    with open(os.path.join(out_dir, "rec_id2ppl.json")) as f:
        rec_id2ppl = json.load(f)
    return float(np.mean(flat)), float(np.mean(list(rec_id2ppl.values())))


def _trainer_flags(args) -> List[str]:
    return ["--device", args.device] + (["--rng_impl", args.rng_impl] if args.rng_impl else [])


def run_lm_stage(args) -> Dict:
    from ..data.synthetic_conversations import make_lm_corpus
    from . import eval_ppl, train_lm

    corpus = os.path.join(args.out_dir, "lm_corpus")
    train_txt, dev_txt = make_lm_corpus(
        corpus, n_train=args.lm_convs, n_dev=args.lm_dev_convs,
        n_utts=args.lm_utts, seed=args.seed)
    lm_dir = os.path.join(args.out_dir, "lm")
    rc = train_lm.main([
        "--train_file", train_txt, "--dev_file", dev_txt,
        "--model", "tiny", "--tokenizer", "char",
        "--seq_len", str(args.seq_len), "--batch_size", str(args.lm_batch),
        "--steps", str(args.lm_steps), "--out_dir", lm_dir,
        "--eval_every", str(max(args.lm_steps // 2, 1)),
        "--save_every", str(args.lm_steps),
        "--tiny_n_embd", str(args.lm_n_embd),
        "--tiny_n_layer", str(args.lm_n_layer),
        "--log_every", "100", "--seed", str(args.seed), *_trainer_flags(args)])
    if rc != 0:
        raise RuntimeError("train_lm failed")

    results: Dict = {}
    for ctx in ("indep", "max_len", "streaming"):
        out = os.path.join(args.out_dir, f"ppl_{ctx}")
        rc = eval_ppl.main([
            "--in_file", dev_txt, "--out_dir", out,
            "--model", "tiny", "--tokenizer", "char",
            "--checkpoint", os.path.join(lm_dir, "ckpt"),
            "--context_type", ctx, "--max_len", str(args.seq_len),
            "--bsize", "32", "--device", args.device])
        if rc != 0:
            raise RuntimeError(f"eval_ppl {ctx} failed")
        nll, rec_ppl = _mean_nll(out)
        results[f"nll_{ctx}"] = nll
        results[f"ppl_{ctx}"] = float(np.exp(nll))
        results[f"avg_rec_ppl_{ctx}"] = rec_ppl
    results["context_gain_nats"] = results["nll_indep"] - results["nll_max_len"]
    results["ppl_ratio_indep_over_max_len"] = (
        results["ppl_indep"] / results["ppl_max_len"])
    print(f"LM: PPL indep {results['ppl_indep']:.2f} vs max_len "
          f"{results['ppl_max_len']:.2f} vs streaming "
          f"{results['ppl_streaming']:.2f} "
          f"(context gain {results['context_gain_nats']:.3f} nats/token)",
          file=sys.stderr)
    return results


def _hyp_text(tokenizer, row: np.ndarray, length: int, eos: int) -> str:
    ids = [int(t) for t in np.asarray(row)[:int(length)] if int(t) != eos]
    return " ".join(tokenizer.decode(ids).split())


def _conv_name(texts: List[str]) -> str:
    """The conversation's name = the word over ASR_NAME_CHARS (present in
    every utterance by construction)."""
    from ..data.synthetic_conversations import ASR_NAME_CHARS

    for text in texts:
        for w in text.split():
            if all(c in ASR_NAME_CHARS for c in w):
                return w
    return ""


def _reuse(args, run_dir: str) -> bool:
    """Whether ``--skip_training`` reuses ``run_dir/ckpt``: a training
    directory whose latest step is a ``.npz`` (a checkpoint of another
    format there is refused by ``eval_ppl.training_dir_params``, not
    trained over)."""
    from .eval_ppl import training_dir_params

    if not (args.skip_training
            and os.path.exists(os.path.join(run_dir, "ckpt", "status.json"))):
        return False
    training_dir_params(os.path.join(run_dir, "ckpt"))
    print("skip_training: reusing", run_dir, file=sys.stderr)
    return True


def run_asr_stage(args) -> Dict:
    import torch

    from ..data.asr_dataset import KaldiAsrDataset, _utt_time_key
    from ..data.synthetic_conversations import (ASR_NAME_CHARS, make_asr_corpus,
                                                make_asr_lm_text)
    from ..data.tokenizer import load_tokenizer
    from ..decode.batcher import decode_continuous, decode_conversations
    from ..decode.beam import greedy_decode
    from ..decode.fusion import FusionLM
    from ..models.gpt2 import convert as gconvert, model as g
    from ..models.speecht5 import convert as sconvert
    from ..models.speecht5 import model as st5
    from ..models.speecht5.config import tiny_config
    from ..utils.device import resolve_device
    from ..utils.wer import wer
    from . import train_asr, train_lm
    from .eval_ppl import training_dir_params

    dev_t = resolve_device(args.device)
    corpus = os.path.join(args.out_dir, "asr_corpus")
    tr_dir, dev_dir = make_asr_corpus(
        corpus, n_train=args.asr_convs, n_dev=args.asr_dev_convs,
        n_utts=args.asr_utts, seed=args.seed)

    cfg_path = os.path.join(args.out_dir, "asr_config.json")
    with open(cfg_path, "w") as f:
        json.dump(CONV_OVER, f)
    asr_dir = os.path.join(args.out_dir, "asr")
    if not _reuse(args, asr_dir):
        rc = train_asr.main([
            "--config_json", cfg_path,
            "--train_dir", tr_dir, "--tiny", "--tokenizer", "char",
            "--batch_size", str(args.asr_batch), "--steps", str(args.asr_steps),
            "--out_dir", asr_dir, "--max_seconds", "4.0",
            "--eval_every", str(10 * args.asr_steps),
            "--save_every", str(args.asr_steps), "--lr", str(args.asr_lr),
            "--seed", str(args.seed), *_trainer_flags(args)])
        if rc != 0:
            raise RuntimeError("train_asr failed")

    # the fusion LM trains on a large text-only corpus of the same
    # distribution, dev names excluded: the carry-over gain can only be
    # in-context copying
    dev_names = set()
    with open(os.path.join(dev_dir, "text")) as f:
        for line in f:
            for w in line.split()[1:]:
                if all(c in ASR_NAME_CHARS for c in w):
                    dev_names.add(w)
    lm_text = make_asr_lm_text(
        os.path.join(corpus, "lm_text.txt"), n_convs=args.asr_lm_convs,
        n_utts=args.asr_utts, seed=args.seed, exclude=sorted(dev_names))
    lm_dir = os.path.join(args.out_dir, "asr_lm")
    if not _reuse(args, lm_dir):
        rc = train_lm.main([
            "--train_file", lm_text,
            "--model", "tiny", "--tokenizer", "char",
            "--seq_len", str(args.asr_lm_seq_len),
            "--batch_size", "16", "--steps", str(args.asr_lm_steps),
            "--out_dir", lm_dir, "--eval_every", str(10 * args.asr_lm_steps),
            "--save_every", str(args.asr_lm_steps), "--log_every", "100",
            "--tiny_n_embd", str(args.lm_n_embd),
            "--tiny_n_layer", str(args.lm_n_layer),
            # the stream separator must be the ASR decoder's eos/start token
            # (2): the fusion LM sees utterances delimited by exactly that id
            "--eos_id", str(2),
            "--seed", str(args.seed), *_trainer_flags(args)])
        if rc != 0:
            raise RuntimeError("train_lm (fusion LM) failed")

    # trained weights under the exact training-time configs
    cfg = tiny_config(vocab_size=256, hidden_size=32,
                      encoder_attention_heads=4, decoder_attention_heads=4,
                      encoder_ffn_dim=64, decoder_ffn_dim=64)
    cfg = dataclasses.replace(cfg, **{k: tuple(v) if isinstance(v, list) else v
                                      for k, v in CONV_OVER.items()})
    asr = st5.asr_model_init(cfg, device=dev_t)
    asr.load_state_dict(sconvert.asr_from_jax_params(
        training_dir_params(os.path.join(asr_dir, "ckpt")), cfg), strict=True)
    lm_cfg = g.tiny_gpt2_config(vocab_size=256,
                                n_positions=max(args.asr_lm_seq_len, 64),
                                n_embd=args.lm_n_embd,
                                n_layer=args.lm_n_layer, n_head=4)
    lm = g.gpt2_init(lm_cfg, device=dev_t)
    lm.load_state_dict(gconvert.from_jax_params(
        training_dir_params(os.path.join(lm_dir, "ckpt")), lm_cfg), strict=True)

    tokenizer = load_tokenizer("char")
    tokenizer.vocab_size = 256
    eos = cfg.eos_token_id

    # dev conversations in chronological utterance order
    dev = KaldiAsrDataset(dev_dir)
    groups: Dict[str, List] = {}
    for ex in dev.examples:
        groups.setdefault(ex.reco_id, []).append(ex)
    convs, refs_by_utt, flat_utts = [], {}, []
    utt_order: Dict[str, List[str]] = {}
    for reco in groups:
        exs = sorted(groups[reco], key=lambda e: _utt_time_key(e.utt_id, e.start, e.end))
        wavs = [dev.load_waveform(e) for e in exs]
        convs.append((reco, wavs))
        utt_order[reco] = [e.utt_id for e in exs]
        for u, (e, w) in enumerate(zip(exs, wavs)):
            refs_by_utt[e.utt_id] = (reco, u, e.text)
            flat_utts.append((e.utt_id, w))
    bucket = max(len(w) for _, wavs in convs for w in wavs)

    def decode_at(weight):
        fusion = FusionLM(lm, weight=weight)
        carry = decode_conversations(
            asr, convs, fusion=fusion, slots=4, chunk_steps=16,
            max_len=args.decode_max_len, audio_samples=bucket,
            max_positions=lm_cfg.n_positions, decode_reserve=args.decode_max_len + 8)
        nocarry = decode_continuous(
            asr, flat_utts, slots=4, chunk_steps=16, max_len=args.decode_max_len,
            audio_samples=bucket, fusion=fusion)
        return carry, nocarry

    def decode_oracle(weight):
        """Carry-over with the true transcripts as history: the upper bound
        of the carry mechanism, without error compounding in the decoded
        history.  The history is primed left-aligned into a fixed [1, P]
        buffer from position 0 (the live carry layout) and written into the
        cache in place: positions at and past its length L hold the pads'
        keys and values until the decode, which starts at L, overwrites each
        before any query can see it (the causal bias hides every position
        above the query's own)."""
        fusion = FusionLM(lm, weight=weight)
        sep = cfg.eos_token_id
        P = lm_cfg.n_positions - args.decode_max_len - 8
        zero = torch.zeros((1,), dtype=torch.int64, device=dev_t)
        out = {}
        for reco, wavs in convs:
            hist: List[int] = []
            for uid, wav in zip(utt_order[reco], wavs):
                cache = fusion.init_cache(1, lm_cfg.n_positions)
                L = len(hist)
                ids = np.zeros((1, P), np.int64)
                if L:
                    ids[0, :L] = hist
                fusion.prime(torch.as_tensor(ids, device=dev_t), cache, zero)
                w = np.zeros((1, bucket), np.float32)
                m = np.zeros((1, bucket), np.int32)
                w[0, :len(wav)] = wav
                m[0, :len(wav)] = 1
                enc, msk = st5.encode_speech(asr, w, m)
                toks, lens = greedy_decode(
                    asr, enc, msk, max_len=args.decode_max_len, fusion=fusion,
                    lm_cache=cache, lm_start=torch.tensor([L], device=dev_t))
                out[uid] = (toks[0].cpu().numpy(), int(lens[0]))
                # true-history growth (tokens + separator)
                hist.extend(tokenizer(refs_by_utt[uid][2])["input_ids"])
                hist.append(sep)
                hist = hist[-P:] if len(hist) > P else hist
        return out

    nofusion = decode_continuous(
        asr, flat_utts, slots=4, chunk_steps=16, max_len=args.decode_max_len,
        audio_samples=bucket, fusion=None)

    # ground-truth degradation labels (only some later occurrences are)
    with open(os.path.join(dev_dir, "degraded.txt")) as f:
        degraded_ids = {line.strip() for line in f if line.strip()}

    def collect(hyp_by_utt: Dict[str, str]) -> Dict:
        buckets = {"all": ([], []), "clean": ([], []), "degraded": ([], [])}
        name_hits = name_total = 0
        for uid, (reco, u, ref) in refs_by_utt.items():
            hyp = hyp_by_utt.get(uid, "")
            deg = uid in degraded_ids
            for key in ("all", "degraded" if deg else "clean"):
                buckets[key][0].append(ref)
                buckets[key][1].append(hyp)
            if deg:
                name = _conv_name([ref])
                name_total += 1
                if name and name in hyp.split():
                    name_hits += 1
        out = {f"wer_{k}": wer(r, h) for k, (r, h) in buckets.items()}
        out["name_recovery"] = name_hits / max(name_total, 1)
        return out

    def from_continuous(res) -> Dict[str, str]:
        return {uid: _hyp_text(tokenizer, row, L, eos) for uid, (row, L) in res.items()}

    def from_conversations(res) -> Dict[str, str]:
        out = {}
        for reco, per_utt in res.items():
            for uid, (row, L) in zip(utt_order[reco], per_utt):
                out[uid] = _hyp_text(tokenizer, row, L, eos)
        return out

    weights = ([float(w) for w in args.fusion_weights.split(",")]
               if args.fusion_weights else [args.fusion_weight])
    results: Dict = {"nofusion": collect(from_continuous(nofusion))}
    dump: Dict = {}
    for uid, hyp in from_continuous(nofusion).items():
        dump.setdefault(uid, {"ref": refs_by_utt[uid][2]})["nofusion"] = hyp
    for wi, w in enumerate(weights):
        carry, nocarry = decode_at(w)
        c_hyps = from_conversations(carry)
        n_hyps = from_continuous(nocarry)
        o_hyps = from_continuous(decode_oracle(w))
        key = "" if wi == 0 else f"_w{w:g}"
        for label, hyps in ((f"carry{key}", c_hyps), (f"nocarry{key}", n_hyps),
                            (f"oracle{key}", o_hyps)):
            results[label] = collect(hyps)
            for uid, hyp in hyps.items():
                dump[uid][label] = hyp
        print(f"ASR w={w:g}: WER degraded carry "
              f"{results[f'carry{key}']['wer_degraded']:.3f} vs no-carry "
              f"{results[f'nocarry{key}']['wer_degraded']:.3f} "
              f"(oracle-history {results[f'oracle{key}']['wer_degraded']:.3f}, "
              f"no-fusion {results['nofusion']['wer_degraded']:.3f}); "
              f"name recovery {results[f'carry{key}']['name_recovery']:.2f} / "
              f"{results[f'nocarry{key}']['name_recovery']:.2f} / "
              f"oracle {results[f'oracle{key}']['name_recovery']:.2f}",
              file=sys.stderr)
    with open(os.path.join(args.out_dir, "asr_hyps.json"), "w") as f:
        json.dump(dump, f, indent=1)
    results["wer_gain_degraded"] = (results["nocarry"]["wer_degraded"]
                                    - results["carry"]["wer_degraded"])
    return results


def main(argv=None) -> int:
    args = parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    results: Dict = {}
    for stage, run in (("lm", run_lm_stage), ("asr", run_asr_stage)):
        if args.stage in ("all", stage):
            t0 = time.perf_counter()
            results[stage] = run(args)
            print(f"{stage} stage: {time.perf_counter() - t0:.1f} s of wall time",
                  file=sys.stderr)
    path = os.path.join(args.out_dir, "results.json")
    with open(path, "w") as f:
        json.dump(results, f, indent=2)
    print(f"results written to {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
