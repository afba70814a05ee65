"""The port's copy of the synthetic conversation generators
(``loco_asr_tpu_torch.data.synthetic_conversations``) writes the JAX
module's files byte for byte: every file of ``make_lm_corpus``,
``make_asr_corpus`` (text, wav.scp, segments, degraded.txt, the wavs) and
``make_asr_lm_text``, for two seeds, each generated into the same path by
both modules in turn; ``render_utterance`` and ``name_positions`` equal."""

import os
import shutil

import numpy as np
import pytest

from loco_asr_tpu.data import synthetic_conversations as jsc
from loco_asr_tpu_torch.data import synthetic_conversations as tsc


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _both(root, make):
    """make(module) into ``root`` for the JAX module, then the port's ->
    (JAX files, port files, JAX return value, port return value)."""
    outs = []
    for mod in (jsc, tsc):
        if os.path.exists(root):
            shutil.rmtree(root)
        ret = make(mod)
        outs.append((_files(root), ret))
    (jf, jr), (tf, tr) = outs
    return jf, tf, jr, tr


@pytest.mark.parametrize("seed", [0, 11])
def test_lm_corpus_is_byte_identical(seed, tmp_path):
    root = str(tmp_path / "lm")
    jf, tf, jr, tr = _both(root, lambda m: m.make_lm_corpus(
        root, n_train=7, n_dev=3, n_utts=5, seed=seed))
    assert sorted(jf) == ["dev.txt", "train.txt"] and jr == tr
    assert tf == jf


@pytest.mark.parametrize("seed", [0, 11])
def test_asr_corpus_is_byte_identical(seed, tmp_path):
    root = str(tmp_path / "asr")
    jf, tf, jr, tr = _both(root, lambda m: m.make_asr_corpus(
        root, n_train=3, n_dev=2, n_utts=3, seed=seed))
    assert jr == tr
    assert {"train/text", "train/wav.scp", "train/segments", "train/degraded.txt",
            "dev/text", "dev/wav.scp"} <= set(jf)
    assert sum(k.endswith(".wav") for k in jf) == 5
    assert sorted(tf) == sorted(jf)
    for name in jf:
        assert tf[name] == jf[name], name


@pytest.mark.parametrize("seed", [0, 11])
def test_asr_lm_text_is_byte_identical(seed, tmp_path):
    path = str(tmp_path / "lm" / "lm_text.txt")
    exclude = ["klmno", "onmlk", "kkkkk"]
    jf, tf, jr, tr = _both(str(tmp_path / "lm"), lambda m: m.make_asr_lm_text(
        path, n_convs=25, n_utts=4, seed=seed, exclude=exclude))
    assert jr == tr == path
    assert tf == jf
    assert not any(w in exclude for line in jf["lm_text.txt"].decode().splitlines()
                   for w in line.split()[1:])


def test_render_utterance_and_name_positions_equal():
    for degrade in ("", "klmn"):
        want = jsc.render_utterance("ab klmn cd", np.random.default_rng(3),
                                    degrade_name=degrade)
        got = tsc.render_utterance("ab klmn cd", np.random.default_rng(3),
                                   degrade_name=degrade)
        np.testing.assert_array_equal(got, want)
    for text, name in (("aa klmno bb", "klmno"), ("aa bb", "klmno"), ("klmno", "klmno")):
        assert tsc.name_positions(text, name) == jsc.name_positions(text, name)
    assert (tsc.ASR_NAME_CHARS, tsc.NAME_CHARS, tsc.SR) == (jsc.ASR_NAME_CHARS,
                                                            jsc.NAME_CHARS, jsc.SR)
