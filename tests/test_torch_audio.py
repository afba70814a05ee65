"""The port's numpy audio decode/resample against loco_asr_tpu.ops.audio."""

import wave

import numpy as np
import pytest

pytest.importorskip("torch")

from loco_asr_tpu.ops import audio as jaudio
from loco_asr_tpu_torch.ops import audio as taudio


def _write_sphere(path, payload, coding, n_bytes, channels=1, rate=8000):
    header = (f"NIST_1A\n   1024\nsample_count -i {len(payload) // (n_bytes * channels)}\n"
              f"channel_count -i {channels}\nsample_rate -i {rate}\n"
              f"sample_n_bytes -i {n_bytes}\nsample_coding -s{len(coding)} {coding}\n"
              "sample_byte_format -s2 01\nend_head\n").encode()
    with open(path, "wb") as f:
        f.write(header.ljust(1024, b" ") + payload)


@pytest.mark.parametrize("width", [1, 2, 3, 4])
def test_read_wav(tmp_path, width):
    rng = np.random.default_rng(width)
    raw = rng.integers(0, 256, size=2 * width * 500, dtype=np.uint8).tobytes()
    path = str(tmp_path / "a.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(width)
        w.setframerate(22050)
        w.writeframes(raw)
    got, sr = taudio.read_wav(path)
    want, want_sr = jaudio.read_wav(path)
    assert sr == want_sr == 22050
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("coding,n_bytes,channels", [("pcm", 2, 1), ("pcm", 2, 2),
                                                     ("ulaw", 1, 1), ("alaw", 1, 2)])
def test_read_sphere(tmp_path, coding, n_bytes, channels):
    rng = np.random.default_rng(n_bytes + channels)
    payload = rng.integers(0, 256, size=n_bytes * channels * 400, dtype=np.uint8).tobytes()
    path = str(tmp_path / "a.sph")
    _write_sphere(path, payload, coding, n_bytes, channels)
    for channel in (None, 0) if channels > 1 else (None,):
        got, sr = taudio.read_sphere(path, channel)
        want, want_sr = jaudio.read_sphere(path, channel)
        assert sr == want_sr
        np.testing.assert_array_equal(got, want)


def test_shorten_sphere_is_not_ported(tmp_path):
    path = str(tmp_path / "a.sph")
    _write_sphere(path, b"\0" * 64, "pcm,embedded-shorten-v2.00", 2)
    with pytest.raises(NotImplementedError, match="shorten"):
        taudio.read_sphere(path)


@pytest.mark.parametrize("sr_in", [8000, 22050, 16000])
def test_load_audio_resamples(tmp_path, sr_in):
    rng = np.random.default_rng(sr_in)
    pcm = (rng.standard_normal(sr_in // 20) * 3000).astype(np.int16)
    path = str(tmp_path / "a.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr_in)
        w.writeframes(pcm.tobytes())
    got, sr = taudio.load_audio(path, 16000)
    want, _ = jaudio.load_audio(path, 16000)
    assert sr == 16000
    np.testing.assert_array_equal(got, want)
