"""``ConversationAsrDataset`` at the long-context recipe's window
(``train_asr --conversation_seconds 164``) against the JAX package's, over
a synthetic Kaldi directory of three recording-channels of 190-400 s of
seeded audio in utterances of 0.5-9 s: the same windows (each at most
164 s of audio) and the same batches -- waveforms, masks and labels up to
the recipe's cap of 16 x 164 = 2624 tokens -- for the same seed."""

import os
import wave

import numpy as np
import pytest

pytest.importorskip("torch")

from loco_asr_tpu.data import asr_dataset as jds
from loco_asr_tpu.data.tokenizer import load_tokenizer as jtok
from loco_asr_tpu_torch.data import asr_dataset as tds
from loco_asr_tpu_torch.data.tokenizer import load_tokenizer as ttok

SR = 16000
WINDOW = 164.0
MAX_LABEL = int(16 * WINDOW)   # train_asr's default cap in conversation mode
WORDS = ["yeah", "so", "the", "weather", "was", "really", "nice", "and", "then", "we",
         "went", "out", "to", "dinner", "with", "my", "sister", "uh", "huh", "right"]


@pytest.fixture(scope="module")
def long_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("long_corpus")
    rng = np.random.default_rng(164)
    text, segs, scp = [], [], []
    for r, seconds in enumerate((400.0, 190.0, 260.0)):
        reco = f"conv{r:04d}-{'AB'[r % 2]}"
        path = root / f"{reco}.wav"
        pcm = (rng.standard_normal(int(seconds * SR)) * 3000).astype(np.int16)
        with wave.open(str(path), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(SR)
            w.writeframes(pcm.tobytes())
        scp.append(f"{reco} {path}")
        t = 0.3
        while True:
            dur = float(rng.uniform(0.5, 9.0))
            if t + dur > seconds:
                break
            start, end = round(t, 2), round(t + dur, 2)
            utt = f"{reco}-{int(start * 100):06d}-{int(end * 100):06d}"
            n = max(1, int(dur * 3))
            text.append(f"{utt} {' '.join(rng.choice(WORDS, n))}")
            segs.append(f"{utt} {reco} {start:.2f} {end:.2f}")
            t = end + float(rng.uniform(0.05, 1.5))
    # Kaldi files are sorted by key
    for name, lines in (("text", text), ("segments", segs), ("wav.scp", scp)):
        (root / name).write_text("\n".join(sorted(lines)) + "\n")
    return str(root)


def test_windows_equal_jax_and_stay_within_164_seconds(long_dir):
    j = jds.ConversationAsrDataset(long_dir, window_seconds=WINDOW)
    t = tds.ConversationAsrDataset(long_dir, window_seconds=WINDOW)
    assert len(t) == len(j) >= 6
    for a, b in zip(t.windows, j.windows, strict=True):
        assert (a.window_id, a.reco_id, a.utt_ids, a.texts, a.segs) == \
            (b.window_id, b.reco_id, b.utt_ids, b.texts, b.segs)
        assert a.seconds == pytest.approx(b.seconds) and a.seconds <= WINDOW
    assert max(w.seconds for w in t.windows) > 150.0


@pytest.mark.parametrize("batch_size,shuffle", [(1, True), (2, False)])
def test_batches_equal_jax_at_164_seconds(long_dir, batch_size, shuffle):
    kw = dict(max_seconds=WINDOW, max_label_len=MAX_LABEL, shuffle=shuffle, seed=5, eos_id=2)
    j = jds.ConversationAsrDataset(long_dir, window_seconds=WINDOW)
    t = tds.ConversationAsrDataset(long_dir, window_seconds=WINDOW)
    n, longest = 0, 0
    for jb, tb in zip(j.batches(jtok("char"), batch_size, **kw),
                      t.batches(ttok("char"), batch_size, **kw), strict=True):
        assert jb.keys() == tb.keys()
        for k in jb:
            if isinstance(jb[k], np.ndarray):
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
            else:
                assert tb[k] == jb[k], k
        assert tb["input_values"].shape[1] <= WINDOW * SR
        assert tb["labels"].shape[1] <= MAX_LABEL
        longest = max(longest, int((tb["labels"] != -100).sum(1).max()))
        n += 1
    assert n == -(-len(t) // batch_size)
    assert longest > 1000   # long transcripts reach the label arrays
