"""Tokenizers of ``loco_asr_tpu.data.tokenizer``: GPT-2 byte-level BPE
from vocab.json + merges.txt, and the byte-level char fallback.

API as in the reference's usage: ``tokenizer(text)["input_ids"]`` plus
bos/eos token-id attributes.  The BPE tokenizer imports ``regex`` when it
is built, so the char path runs without it.  The SentencePiece unigram
tokenizer (SpeechT5 text) is not ported yet.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import Dict, List, Tuple

# GPT-2 pre-tokenization pattern (public constant of the BPE scheme),
# compiled with ``regex`` (it needs \p{..} classes).
_GPT2_SPLIT = (
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (GPT-2 scheme: printable
    ASCII/latin-1 kept, the rest remapped above U+0100)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class GPT2BPETokenizer:
    """Byte-level BPE from vocab.json + merges.txt (GPT-2 family)."""

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 bos_token: str = "<|endoftext|>", eos_token: str = "<|endoftext|>"):
        self.encoder = vocab
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bos_token_id = vocab[bos_token]
        self.eos_token_id = vocab[eos_token]
        self.vocab_size = len(vocab)
        self._cache: Dict[str, Tuple[str, ...]] = {}
        import regex  # only the BPE path needs it

        self._split = regex.compile(_GPT2_SPLIT)

    @classmethod
    def from_files(cls, vocab_file: str, merges_file: str, **kw) -> "GPT2BPETokenizer":
        with open(vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(merges_file, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        return cls(vocab, merges, **kw)

    @classmethod
    def from_pretrained_dir(cls, path: str, **kw) -> "GPT2BPETokenizer":
        return cls.from_files(os.path.join(path, "vocab.json"),
                              os.path.join(path, "merges.txt"), **kw)

    def _bpe(self, token: str) -> Tuple[str, ...]:
        if token in self._cache:
            return self._cache[token]
        word: Tuple[str, ...] = tuple(token)
        pairs = _get_pairs(word)
        while pairs:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            a, b = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(a, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                if j < len(word) - 1 and word[j + 1] == b:
                    new_word.append(a + b)
                    i = j + 2
                else:
                    new_word.append(word[j])
                    i = j + 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        self._cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in self._split.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[p] for p in self._bpe(mapped))
        return ids

    def decode(self, ids: List[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        data = bytearray(self.byte_decoder[c] for c in text)
        return data.decode("utf-8", errors="replace")

    def __call__(self, text: str) -> Dict[str, List[int]]:
        return {"input_ids": self.encode(text)}


class CharTokenizer:
    """Byte-level fallback tokenizer (tests / vocab-free smoke runs).

    Fully invertible at the default vocab (2 specials + 256 bytes); with a
    smaller vocab, bytes fold modulo the span and decode is best-effort.
    """

    def __init__(self, vocab_size: int = 258, bos_token_id: int = 0,
                 eos_token_id: int = 1):
        self.vocab_size = vocab_size
        self.bos_token_id = bos_token_id
        self.eos_token_id = eos_token_id

    def encode(self, text: str) -> List[int]:
        lo = 2
        span = self.vocab_size - lo
        return [lo + (b % span) for b in text.encode("utf-8")]

    def decode(self, ids: List[int]) -> str:
        data = bytes(i - 2 for i in ids
                     if 2 <= i < self.vocab_size and i - 2 < 256)
        return data.decode("utf-8", errors="replace")

    def __call__(self, text: str) -> Dict[str, List[int]]:
        return {"input_ids": self.encode(text)}


def load_tokenizer(spec: str):
    """'char' | dir with vocab.json+merges.txt (GPT-2 BPE).  A
    SentencePiece ``.model`` spec (SpeechT5 text) is not ported yet."""
    if spec == "char":
        return CharTokenizer()
    if os.path.isdir(spec):
        return GPT2BPETokenizer.from_pretrained_dir(spec)
    if spec.endswith(".model"):
        raise NotImplementedError("SentencePiece tokenizers are not ported yet")
    raise ValueError(f"unknown tokenizer spec: {spec}")
