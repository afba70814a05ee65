"""The port's Fisher ingest path against the JAX package's, on the LDC-style
tree of ``tests/test_fisher_prep_cli.py`` plus one shorten-coded call:
the ``fisher_prep`` CLI's manifests (byte-identical but for the wav.scp
pipes' module name), the calldata remap and the topic split, the
``--strict`` and count checks, ``sph_decode``'s output bytes on both its
lanes and the modules its process loads, and the prepared directory
through ``KaldiAsrDataset``."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

from loco_asr_tpu.data import fisher_speakerid as jspk
from loco_asr_tpu.data import fisher_split as jsplit
from loco_asr_tpu.data.asr_dataset import KaldiAsrDataset as JDataset
from loco_asr_tpu.ops import shorten as jshn
from loco_asr_tpu.pipelines import fisher_prep as jcli
from loco_asr_tpu.pipelines import sph_decode as jsph
from loco_asr_tpu_torch import native as tnative
from loco_asr_tpu_torch.data import fisher_speakerid as tspk
from loco_asr_tpu_torch.data import fisher_split as tsplit
from loco_asr_tpu_torch.data.asr_dataset import KaldiAsrDataset as TDataset
from loco_asr_tpu_torch.pipelines import fisher_prep as tcli
from loco_asr_tpu_torch.pipelines import sph_decode as tsph
from tests.test_fisher_prep_cli import _make_corpus
from tests.test_torch_native import jax_native, write_sphere  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CMD = "python -m loco_asr_tpu.pipelines.sph_decode"
PORT_CMD = "python -m loco_asr_tpu_torch.pipelines.sph_decode"
SHN_CALL = "fe_03_00003"
SHN_SECONDS = 3.0


def _add_shorten_call(root: str) -> np.ndarray:
    """A third call, shorten-coded 16-bit PCM at 8 kHz, with a transcript,
    a calldata row and a dev split entry; returns its samples [n, 2]."""
    n = int(SHN_SECONDS * 8000)
    rng = np.random.default_rng(3)
    t = np.arange(n)[:, None]
    x = (np.sin(t / np.array([13.0, 29.0])) * 6000 + rng.integers(-300, 300, (n, 2))
         ).astype(np.int32)
    audio = os.path.join(root, "fe_03_p1_sph1", "audio", "000", f"{SHN_CALL}.sph")
    stream = jshn.encode(x, jshn.TYPE_S16LH, nmean=4, commands=[jshn.FN_DIFF2, jshn.FN_DIFF1])
    write_sphere(audio, stream, "pcm,embedded-shorten-v2.00", 2, 2, sample_count=n)
    trans = os.path.join(root, "fe_03_p1_tran", "data", "trans", "000", f"{SHN_CALL}.txt")
    with open(trans, "w") as f:
        f.write(f"# {SHN_CALL}.sph\n\n0.20 1.35 A: so where are you calling from\n"
                "1.50 2.90 B: (( )) i am in philadelphia [laugh]\n"
                "1.60 2.40 A: oh nice [cough] yeah\n")
    with open(os.path.join(root, "fe_03_p1_tran", "doc", "calldata.tbl"), "a") as f:
        f.write("00003,x,x,x,x, 555 ,x,x,x,x, 666 ,x\n")
    with open(os.path.join(root, "splits", "dev.recids"), "a") as f:
        f.write(f"{SHN_CALL}\n")
    return x


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("fisher")
    corpus_dir, splits = _make_corpus(root)
    x = _add_shorten_call(corpus_dir)
    return corpus_dir, splits, x


def _prep(cli, corpus, out, extra=()):
    corpus_dir, splits, _ = corpus
    return cli.main([corpus_dir, "--out_dir", os.path.join(out, "train_all"), "--calldata",
                     "--split_dir", splits, "--split_out", out, "--sets", "train", "dev",
                     "--expected_count", "3", *extra])


@pytest.fixture(scope="module")
def prepared(corpus, tmp_path_factory):
    jout, tout = str(tmp_path_factory.mktemp("jax_prep")), str(tmp_path_factory.mktemp("port_prep"))
    assert _prep(jcli, corpus, jout) == 0
    assert _prep(tcli, corpus, tout) == 0
    return jout, tout


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_manifests_match_jax(prepared):
    jout, tout = prepared
    files = _tree(jout)
    assert files == _tree(tout)
    assert {"train_all/wav.scp", "train_all/text.old", "train_all/spk2gender",
            "dev/wav.scp", "train/text"} <= set(files)
    for rel in files:
        with open(os.path.join(jout, rel), "rb") as f:
            want = f.read()
        with open(os.path.join(tout, rel), "rb") as f:
            got = f.read()
        if rel.endswith("wav.scp"):
            lines = got.decode().splitlines()
            assert lines and all(f"{PORT_CMD} -c " in line for line in lines), rel
            got = got.replace(PORT_CMD.encode(), JAX_CMD.encode())
        assert got == want, rel


def test_speaker_remap_and_split_match_jax(prepared, tmp_path):
    jout, _ = prepared
    calldata = ["00001,x,x,x,x, 777 ,x,x,x,x, 888 ,x\n", "00003,x,x,x,x, 555 ,x,x,x,x, 666 ,x\n"]
    assert tspk.load_calldata(calldata) == jspk.load_calldata(calldata)
    dirs = {}
    for tag, mod in (("jax", jspk), ("port", tspk)):
        d = str(tmp_path / tag)
        shutil.copytree(os.path.join(jout, "train_all"), d)
        for name in os.listdir(d):        # the manifests as prepared, before the remap
            if name.endswith(".old"):
                os.replace(os.path.join(d, name), os.path.join(d, name[:-4]))
        missing = mod.fix_speaker_ids(mod.load_calldata(calldata), d, apply=True)
        dirs[tag] = (d, missing)
    assert dirs["jax"][1] == dirs["port"][1] == ["00002"]
    for rel in _tree(dirs["jax"][0]):
        with open(os.path.join(dirs["jax"][0], rel), "rb") as a, \
                open(os.path.join(dirs["port"][0], rel), "rb") as b:
            assert a.read() == b.read(), rel
    splits = str(tmp_path / "splits")
    os.makedirs(splits)
    with open(os.path.join(splits, "train.recids"), "w") as f:
        f.write("fe_03_777\nfe_03_00002\n")
    with open(os.path.join(splits, "test.recids"), "w") as f:
        f.write("fe_03_666\n")
    outs = {tag: mod.split_data_dir(splits, dirs["jax"][0], str(tmp_path / f"split_{tag}"),
                                    sets=("train", "test"))
            for tag, mod in (("jax", jsplit), ("port", tsplit))}
    for name in ("train", "test"):
        assert _tree(outs["jax"][name]) == _tree(outs["port"][name])
        for rel in _tree(outs["jax"][name]):
            with open(os.path.join(outs["jax"][name], rel), "rb") as a, \
                    open(os.path.join(outs["port"][name], rel), "rb") as b:
                assert a.read() == b.read(), (name, rel)


@pytest.mark.parametrize("case", ["count", "strict_default", "strict_ok", "unpaired_strict",
                                  "unpaired_loose"])
def test_checks_return_what_jax_returns(tmp_path, monkeypatch, case):
    corpus_dir, _ = _make_corpus(tmp_path)
    if case.startswith("unpaired"):
        audio = os.path.join(corpus_dir, "fe_03_p1_sph1", "audio", "000")
        shutil.move(os.path.join(audio, "fe_03_00002.sph"), os.path.join(audio, "fe_03_99999.sph"))
    flags = {"count": ["--expected_count", "11699"], "strict_default": ["--strict"],
             "strict_ok": ["--strict", "--expected_count", "2"],
             "unpaired_strict": ["--strict", "--expected_count", "2"],
             "unpaired_loose": ["--expected_count", "2"]}[case]
    monkeypatch.chdir(tmp_path)
    want = jcli.main([corpus_dir, "--out_dir", "jax/x", *flags])
    got = tcli.main([corpus_dir, "--out_dir", "port/x", *flags])
    assert got == want == {"count": 1, "strict_default": 1, "strict_ok": 0,
                           "unpaired_strict": 1, "unpaired_loose": 0}[case]


def _sph_out(mod, tmp_path, tag, args):
    out = str(tmp_path / f"{tag}.out")
    assert mod.main([*args, out]) == 0
    with open(out, "rb") as f:
        return f.read()


@pytest.mark.parametrize("call", ["fe_03_00001", SHN_CALL])
def test_sph_decode_bytes_match_jax(corpus, jax_native, tmp_path, monkeypatch, call):  # noqa: F811
    corpus_dir, _, x = corpus
    sph = os.path.join(corpus_dir, "fe_03_p1_sph1", "audio", "000", f"{call}.sph")
    for args in (["-c", "1"], ["-c", "2"], [], ["-f", "raw", "-p", "-c", "2"]):
        args = [*args, sph]
        native = {"jax": _sph_out(jsph, tmp_path, "jn", args),
                  "port": _sph_out(tsph, tmp_path, "tn", args)}
        with monkeypatch.context() as m:
            m.setattr(jax_native, "_lib", None)
            m.setattr(jax_native, "_build_failed", True)
            m.setattr(tnative, "_lib", None)
            m.setattr(tnative, "build_error", "disabled in this test")
            plain = {"jax": _sph_out(jsph, tmp_path, "jp", args),
                     "port": _sph_out(tsph, tmp_path, "tp", args)}
        assert native["port"] == native["jax"], args
        assert plain["port"] == plain["jax"], args
        if "-c" in args:
            assert native["port"] == plain["port"], args
        if call == SHN_CALL and "-c" in args:   # lossless
            ch = int(args[args.index("-c") + 1]) - 1
            pcm = np.frombuffer(native["port"][-2 * len(x):], "<i2")
            np.testing.assert_array_equal(pcm, x[:, ch])


def test_sph_decode_process_loads_no_torch_or_jax(corpus, tmp_path):
    corpus_dir, _, x = corpus
    sph = os.path.join(corpus_dir, "fe_03_p1_sph1", "audio", "000", f"{SHN_CALL}.sph")
    out = str(tmp_path / "a.wav")
    proc = subprocess.run([sys.executable, "-X", "importtime", "-m",
                           "loco_asr_tpu_torch.pipelines.sph_decode", "-c", "1", sph, out],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    loaded = {line.split("|")[-1].strip() for line in proc.stderr.splitlines()
              if line.startswith("import time:")}
    assert "loco_asr_tpu_torch.native" in loaded and "numpy" in loaded
    heavy = sorted(m for m in loaded if m.split(".")[0] in ("torch", "jax", "loco_asr_tpu"))
    assert not heavy, heavy
    with open(out, "rb") as f:
        np.testing.assert_array_equal(np.frombuffer(f.read()[44:], "<i2"), x[:, 0])


def test_prepared_dir_feeds_the_dataset_as_jax(prepared):
    """Both packages' prepared dev and train_all dirs through their
    datasets: the pipes run (the port's without torch or JAX), the
    recordings and the cropped utterances agree sample for sample."""
    jout, tout = prepared
    for split in ("dev", "train_all"):
        jds, tds = JDataset(os.path.join(jout, split)), TDataset(os.path.join(tout, split))
        assert [e.utt_id for e in tds.examples] == [e.utt_id for e in jds.examples]
        assert tds.examples
        for reco in sorted(tds.wav_scp):
            np.testing.assert_array_equal(tds._load_recording(reco), jds._load_recording(reco))
        for te, je in zip(tds.examples, jds.examples):
            np.testing.assert_array_equal(tds.load_waveform(te), jds.load_waveform(je))
    shn = [tds.load_waveform(e) for e in tds.examples if e.reco_id.startswith(SHN_CALL)]
    assert len(shn) == 2 and all(len(w) > 8000 for w in shn)   # the two kept lines
