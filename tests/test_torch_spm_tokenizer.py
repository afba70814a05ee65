"""The port's SentencePiece unigram tokenizer against the JAX package's on
hand-built ``.model`` protos (``chip_smoke.py``'s writer, which the card
runs too): parsed pieces, ids and decoded text equal, on the toy model of
``tests/test_spm_tokenizer.py`` and on seeded random models and strings."""

import numpy as np
import pytest

pytest.importorskip("torch")

from chip_smoke import SLURP_SPM_PIECES, sentencepiece_piece, write_sentencepiece_model
from loco_asr_tpu.data import tokenizer as jtok
from loco_asr_tpu_torch.data import tokenizer as ttok


TOY = [
    ("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3), ("<pad>", 0.0, 3),
    ("▁", -3.0, 1),
    ("▁the", -1.0, 1), ("▁cat", -1.5, 1), ("▁ca", -4.0, 1),
    ("t", -2.0, 1), ("c", -3.0, 1), ("a", -3.0, 1),
    ("▁lo", -2.0, 1), ("w", -2.0, 1), ("▁low", -2.5, 1),
]


def random_model(seed: int) -> bytes:
    """Specials, then every letter of a small alphabet and ~60 random
    multi-letter pieces (with and without the word-start mark), scored from
    a seed."""
    rng = np.random.default_rng(seed)
    letters = "abcdeilmnorst"
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3), ("▁", -4.0, 1)]
    pieces += [(c, float(-rng.uniform(3, 6)), 1) for c in letters]
    seen = {p for p, _, _ in pieces}
    while len(pieces) < 80:
        piece = ("▁" if rng.random() < 0.5 else "") + "".join(
            rng.choice(list(letters), int(rng.integers(2, 6))))
        if piece not in seen:
            seen.add(piece)
            pieces.append((piece, float(-rng.uniform(0.5, 8)), 1))
    return b"".join(sentencepiece_piece(p, s, t) for p, s, t in pieces)


def _pair(data: bytes, tmp_path, name: str):
    path = tmp_path / f"{name}.model"
    path.write_bytes(data)
    return jtok.load_tokenizer(str(path)), ttok.load_tokenizer(str(path))


def test_toy_model_matches_jax(tmp_path):
    data = b"".join(sentencepiece_piece(p, s, t) for p, s, t in TOY)
    assert ttok.parse_sentencepiece_model(data) == jtok.parse_sentencepiece_model(data)
    want, got = _pair(data, tmp_path, "toy")
    assert isinstance(got, ttok.SentencePieceUnigramTokenizer)
    assert (got.bos_token_id, got.eos_token_id, got.unk_id, got.vocab_size) == (
        want.bos_token_id, want.eos_token_id, want.unk_id, want.vocab_size) == (1, 2, 0, 14)
    for text in ("the cat", "low", "the Zat", "  the   cat  low ", "", "ﬁ the"):
        ids = got(text)["input_ids"]
        assert ids == want(text)["input_ids"], text
        assert got.decode(ids) == want.decode(ids), text
    assert [got.pieces[i][0] for i in got.encode("the cat")] == ["▁the", "▁cat"]


def test_slurp_model_of_chip_smoke_matches_jax(tmp_path):
    path = str(tmp_path / "slurp.model")
    write_sentencepiece_model(path, SLURP_SPM_PIECES)
    want, got = jtok.load_tokenizer(path), ttok.load_tokenizer(path)
    for text in ("alarm set 12", "iot coffee 3", "weather query 0", "general qa 7 x"):
        ids = got(text)["input_ids"]
        assert ids == want(text)["input_ids"] and max(ids) < 81, text


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_model_and_strings_match_jax(seed, tmp_path):
    want, got = _pair(random_model(seed), tmp_path, f"r{seed}")
    rng = np.random.default_rng(100 + seed)
    alphabet = list("abcdeilmnorst   ") + ["X", "é", "Ω", "\t"]
    for _ in range(50):
        text = "".join(rng.choice(alphabet, int(rng.integers(0, 40))))
        ids = got(text)["input_ids"]
        assert ids == want(text)["input_ids"], repr(text)
        assert got.decode(ids) == want.decode(ids), repr(text)
