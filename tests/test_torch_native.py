"""The port's C++ ingest core (``loco_asr_tpu_torch.native``) against the
JAX package's numpy readers and against the JAX package's own native core:
SPHERE in pcm, mu-law, A-law and shorten (with and without a
sample_count header, 1 and 2 channels, across many blocks); and its
build: into the ignored ``native/build`` directory, atomic when two
processes load it at once.  The JAX core is built into a temporary directory here, never in
place."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from loco_asr_tpu.ops import audio as jaudio
from loco_asr_tpu.ops import shorten as jshn
from loco_asr_tpu_torch import native as tnative
from loco_asr_tpu_torch.ops import audio_io as taudio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ compiler")


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's binding, its library built under a temporary path
    (so no test writes into the JAX package)."""
    from loco_asr_tpu import native as jn

    mp = pytest.MonkeyPatch()
    mp.setattr(jn, "_LIB_PATH", str(tmp_path_factory.mktemp("jax_native") / "libloco_audio.so"))
    mp.setattr(jn, "_lib", None)
    mp.setattr(jn, "_build_failed", False)
    assert jn.available()
    yield jn
    mp.undo()


def write_sphere(path, payload: bytes, coding: str, n_bytes: int, channels: int,
                 sample_count=None, rate: int = 8000, byte_format: str = "01") -> None:
    """A NIST SPHERE file: a 1024-byte header, then ``payload``."""
    count = "" if sample_count is None else f"sample_count -i {sample_count}\n"
    header = (f"NIST_1A\n   1024\nsample_rate -i {rate}\nchannel_count -i {channels}\n"
              f"{count}sample_n_bytes -i {n_bytes}\n"
              f"sample_coding -s{len(coding)} {coding}\n"
              f"sample_byte_format -s2 {byte_format}\nend_head\n")
    with open(path, "wb") as f:
        f.write(header.encode().ljust(1024, b" ") + payload)


def shorten_payload(n: int, channels: int, ulaw: bool, seed: int = 0):
    """(stream, internal samples [n, channels]) of a speech-like signal."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)[:, None]
    x = (np.sin(t / (11.0 + 4 * np.arange(channels))) * 7000
         + rng.integers(-400, 400, (n, channels)))
    if ulaw:
        ub = np.clip(x / 256 + 128, 0, 255).astype(np.uint8)
        lin = np.stack([jshn.ulaw_bytes_to_internal(ub[:, c]) for c in range(channels)], 1)
        return jshn.encode(lin, jshn.TYPE_AU2, nmean=4, maxnlpc=2, qlpc=[50, -20],
                           commands=[jshn.FN_DIFF1, jshn.FN_QLPC, jshn.FN_DIFF2]), lin
    lin = x.astype(np.int32)
    return jshn.encode(lin, jshn.TYPE_S16LH, nmean=4,
                       commands=[jshn.FN_DIFF2, jshn.FN_DIFF3, jshn.FN_DIFF1]), lin


def _sphere_case(tmp_path, name):
    rng = np.random.default_rng(len(name))
    path = str(tmp_path / f"{name}.sph")
    n = 40000 if name.endswith("long") else 1777
    if name.startswith("shorten"):
        channels = 1 if "mono" in name else 2
        stream, lin = shorten_payload(n, channels, ulaw="ulaw" in name)
        coding = ("ulaw" if "ulaw" in name else "pcm") + ",embedded-shorten-v2.00"
        count = None if "nocount" in name else n - 77
        write_sphere(path, stream, coding, 2, channels, sample_count=count)
        return path, channels
    coding, n_bytes, channels, fmt = {
        "pcm": ("pcm", 2, 2, "01"), "pcm_be": ("pcm", 2, 1, "10"),
        "ulaw": ("ulaw", 1, 2, "01"), "alaw": ("alaw", 1, 1, "01"),
        "pcm_mono": ("pcm", 2, 1, "01"), "pcm_be_stereo": ("pcm", 2, 2, "10"),
        "ulaw_mono": ("ulaw", 1, 1, "01"), "alaw_stereo": ("alaw", 1, 2, "01")}[name]
    payload = rng.integers(0, 256, n * n_bytes * channels, dtype=np.uint8).tobytes()
    write_sphere(path, payload, coding, n_bytes, channels, sample_count=n, byte_format=fmt)
    return path, channels


SPHERES = ["pcm", "pcm_be", "ulaw", "alaw", "pcm_mono", "pcm_be_stereo", "ulaw_mono",
           "alaw_stereo", "shorten_pcm", "shorten_ulaw", "shorten_pcm_mono", "shorten_ulaw_mono",
           "shorten_pcm_nocount_mono", "shorten_pcm_nocount", "shorten_ulaw_nocount",
           "shorten_pcm_long", "shorten_ulaw_long"]


@pytest.mark.parametrize("name", SPHERES)
def test_sphere_matches_jax_readers_and_jax_core(tmp_path, jax_native, name):
    path, channels = _sphere_case(tmp_path, name)
    for channel in (None, 0, 1) if channels > 1 else (None,):
        got, rate = tnative.read_sphere(path, channel)
        want_c, want_rate = jax_native.read_sphere(path, channel)
        assert rate == want_rate == 8000
        np.testing.assert_array_equal(got, want_c)        # the same C++ code
        ref, _ = jaudio.read_sphere(path, channel)
        port_np, _ = taudio.read_sphere(path, channel)
        np.testing.assert_array_equal(port_np, ref)
        assert len(got) == len(ref)
        if channel is not None and name.startswith("shorten"):
            np.testing.assert_array_equal(got, ref)       # lossless: bit for bit
        elif channel is not None:
            np.testing.assert_allclose(got, ref, atol=1e-6)
        else:   # the numpy mix of int16 channels truncates to int16
            np.testing.assert_allclose(got, ref, atol=1.0 / 32768 + 1e-7)


def test_no_sample_count_grows_the_buffer(tmp_path):
    """Without sample_count the core returns an estimate (rc 1) and the
    binding grows its buffer until the one decode fits; a stream of long
    zero runs compresses far past the estimate's 8 samples a byte."""
    n = 40000
    x = np.zeros((n, 1), np.int32)
    x[::5000] = 100
    stream = jshn.encode(x, jshn.TYPE_S16LH, commands=[jshn.FN_ZERO])
    path = str(tmp_path / "zeros.sph")
    write_sphere(path, stream, "pcm,embedded-shorten-v2.00", 2, 1)
    assert len(stream) * 8 + 4096 < n
    got, _ = tnative.read_sphere(path)
    np.testing.assert_array_equal(got, x[:, 0].astype(np.float32) / 32768.0)


def test_library_builds_into_the_ignored_build_dir():
    path = tnative.library_path()
    assert os.path.dirname(path) == tnative.BUILD_DIR == os.path.join(
        ROOT, "loco_asr_tpu_torch", "native", "build")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "loco_asr_tpu_torch/native/build/" in f.read().split()
    assert tnative.available() and os.path.exists(path)


_LOADER = """
import sys, numpy as np
from loco_asr_tpu_torch import native
native.BUILD_DIR = sys.argv[1]
wav, rate = native.read_sphere(sys.argv[2], 1)
print(rate, len(wav), float(np.abs(wav).sum()))
"""


def test_two_processes_build_and_load_at_once(tmp_path):
    path, _ = _sphere_case(tmp_path, "shorten_ulaw")
    build_dir = str(tmp_path / "build")
    procs = [subprocess.Popen([sys.executable, "-c", _LOADER, build_dir, path], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[0][0] == outs[1][0] and outs[0][0].split()[:2] == ["8000", "1700"]
    built = sorted(os.listdir(build_dir))
    assert built == [".lock", os.path.basename(tnative.library_path(build_dir))]
