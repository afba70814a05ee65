"""Fisher LM evaluation datasets: a copy of ``loco_asr_tpu.data.lm_datasets``
(numpy only), so that the port imports nothing of the JAX package.

Behavioral ports of the reference's two IterableDatasets (lms/src/utils.py):

* :class:`IndepTextDataset` — per-utterance scoring.  Tokenize each
  ``utt_id text`` line with BOS/EOS (utils.py:57-59), drop duplicates
  (first occurrence wins, utils.py:53-54), sort by token length, then batch
  within equal-length bins (utils.py:18,23-38) so no padding is needed.

* :class:`MaxLenTextDataset` — conversation-level scoring.  Rebuild each
  *recording* as one chronological token stream (utterances sorted by the
  lexicographic "rec-start-end" key, utils.py:110-112; EOS appended after
  every utterance, utils.py:129-130), then emit stride-1 sliding windows of
  ``max_len`` tokens with first/last flags (utils.py:141-178).

Replicated quirks (kept bit-for-bit for parity; see tests):
  * a recording with exactly ``max_len`` tokens yields NO windows
    (the reference's ``len(v) < max_len`` guard plus an empty loop range);
  * for longer recordings the final token of the stream is never scored
    (the loop stops before the last window slides onto it), so a recording
    of T tokens contributes T-2 scored tokens.

Additions over the reference: padded-bucket batching for the indep mode
(few distinct shapes; masked NLL keeps numerics identical because causal
attention makes right-padding inert) and a windows-as-matrix view for the
max_len mode enabling large fixed-shape batches.
"""

from __future__ import annotations

import sys
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def load_key_text(fname: str) -> "OrderedDict[str, str]":
    """'utt_id text' file -> ordered dict, first duplicate wins (warns)."""
    out: "OrderedDict[str, str]" = OrderedDict()
    with open(fname, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            utt_id, text = line.split(None, 1)
            if utt_id in out:
                print(f"Duplicate utt id: {utt_id} ignoring", file=sys.stderr)
            else:
                out[utt_id] = text
    return out


class IndepTextDataset:
    """Independent-utterance LM scoring set (reference FisherTextDatasetIndep)."""

    def __init__(self, fname: str, tokenizer, batch_size: int = 128):
        self.batch_size = batch_size
        self.tokenizer = tokenizer
        utt2text = load_key_text(fname)
        text_ids, lengths, utt_ids = [], [], []
        for utt_id, text in utt2text.items():
            ids = list(tokenizer(text)["input_ids"])
            ids.insert(0, tokenizer.bos_token_id)
            ids.append(tokenizer.eos_token_id)
            if len(ids) > 1:
                utt_ids.append(utt_id)
                text_ids.append(ids)
                lengths.append(len(ids))
        order = np.argsort(np.asarray(lengths), kind="stable")
        self.text_ids = [text_ids[i] for i in order]
        self.utt_ids = [utt_ids[i] for i in order]
        self.lengths = np.asarray(lengths)[order]
        self.bins, self.counts = np.unique(self.lengths, return_counts=True)

    def __iter__(self) -> Iterator[List[List[int]]]:
        """Equal-length batches (exact reference iteration order)."""
        offset = 0
        for _bin, count in zip(self.bins, self.counts):
            for i in range(offset, offset + count, self.batch_size):
                yield self.text_ids[i:min(i + self.batch_size, offset + count)]
            offset += count

    def padded_batches(self, batch_size: Optional[int] = None,
                       pad_id: int = 0, multiple: int = 16):
        """TPU-friendly batches: (ids [B, L], lengths [B], utt_index [B]).

        L is the batch max length rounded up to ``multiple`` — a handful of
        static shapes instead of one per length bin.  Right-padding with any
        token is numerics-neutral for causal LMs when NLLs are masked to
        ``lengths``.
        """
        bs = batch_size or self.batch_size
        n = len(self.text_ids)
        for i in range(0, n, bs):
            chunk = self.text_ids[i:i + bs]
            lens = np.asarray([len(c) for c in chunk])
            L = int(-(-lens.max() // multiple) * multiple)
            ids = np.full((len(chunk), L), pad_id, np.int32)
            for j, c in enumerate(chunk):
                ids[j, :len(c)] = c
            yield ids, lens, np.arange(i, i + len(chunk))


class MaxLenTextDataset:
    """Conversation-stream sliding-window scoring set
    (reference FisherTextDatasetMaxLen)."""

    def __init__(self, fname: str, tokenizer, max_len: int = 1024,
                 batch_size: int = 5):
        self.max_len = max_len
        self.batch_size = batch_size
        self.tokenizer = tokenizer
        self.rec_id2tokens, self.nsentence = self._load(fname)
        self.nrecording = len(self.rec_id2tokens)

    def _load(self, fname: str):
        utt2text = load_key_text(fname)

        def time_key(utt_id: str) -> str:
            rec, _chan, start, end = utt_id.split("-")
            return "-".join((rec, start, end))

        rec_id2tokens: "OrderedDict[str, List[int]]" = OrderedDict()
        for utt_id in sorted(utt2text, key=time_key):
            rec_id = utt_id.split("-", 1)[0]
            toks = rec_id2tokens.setdefault(rec_id, [])
            toks.extend(self.tokenizer(utt2text[utt_id])["input_ids"])
            toks.append(self.tokenizer.eos_token_id)

        nsentence = 0
        for v in rec_id2tokens.values():
            nsentence += 1 if len(v) < self.max_len else 1 + (len(v) - self.max_len)
        return rec_id2tokens, nsentence

    def recording_windows(self, tokens: Sequence[int]) -> np.ndarray:
        """All stride-1 windows of one recording as a [N, max_len] matrix
        (N = len - max_len; row i = tokens[i:i+max_len]); empty if the
        recording is shorter than or equal to max_len."""
        T, M = len(tokens), self.max_len
        if T <= M:
            return np.empty((0, M), np.int32)
        arr = np.asarray(tokens, np.int32)
        idx = np.arange(T - M)[:, None] + np.arange(M)[None, :]
        return arr[idx]

    def __iter__(self):
        """Exact reference batch stream: (window_batch, rec_ids, first, last)."""
        for rec_id, v in self.rec_id2tokens.items():
            if len(v) < self.max_len:
                yield [list(v)], [rec_id], True, True
                continue
            windows = self.recording_windows(v)
            n = len(windows)
            if n == 0:  # len(v) == max_len: reference yields nothing
                continue
            # first window alone, then groups of batch_size
            yield [windows[0].tolist()], [rec_id], True, n == 1
            batch: List[List[int]] = []
            for i in range(1, n):
                batch.append(windows[i].tolist())
                last = i == n - 1
                if len(batch) == self.batch_size or last:
                    yield batch, [rec_id] * len(batch), False, last
                    batch = []


def compute_ppl_per_recording(nlls: List[List[float]],
                              utt_ids: List[str]) -> Tuple[Dict, Dict]:
    """Aggregate token NLLs to per-recording PPL = exp(mean(nll))
    (reference lms/src/utils.py:195-233; rec_id = utt_id.split('-')[0])."""
    rec_id2nlls: Dict[str, List[float]] = {}
    for nll_list, utt_id in zip(nlls, utt_ids):
        rec_id = utt_id.split("-", 1)[0]
        rec_id2nlls.setdefault(rec_id, []).extend(nll_list)
    rec_id2ppl = {r: float(np.exp(np.mean(v))) for r, v in rec_id2nlls.items()}
    return rec_id2nlls, rec_id2ppl
