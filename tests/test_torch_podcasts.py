"""The port's episode-corpus adapter (``loco_asr_tpu_torch.data.podcasts``)
against the JAX package's: the manifest round trip (a relative audio path
resolving against the manifest's folder) read by both, the windows of
``stream_windows``, and ``segment_by_energy`` on seeded signals, equal
float for float (the same numpy arithmetic)."""

import numpy as np
import pytest

from loco_asr_tpu.data import podcasts as jpodcasts
from loco_asr_tpu_torch.data import podcasts


def test_manifest_round_trip(tmp_path):
    (tmp_path / "audio").mkdir()
    eps = [podcasts.Episode("ep1", "audio/a.wav", duration=10.0,
                            segments=[podcasts.EpisodeSegment(0.0, 2.5, "hi"),
                                      podcasts.EpisodeSegment(3.0, 4.25)]),
           podcasts.Episode("ep2", str(tmp_path / "b.wav"))]
    path = str(tmp_path / "manifest.jsonl")
    podcasts.write_manifest(path, eps)
    back, jback = podcasts.load_manifest(path), jpodcasts.load_manifest(path)
    assert [vars(e) | {"segments": [vars(s) for s in e.segments]} for e in back] == \
        [vars(e) | {"segments": [vars(s) for s in e.segments]} for e in jback]
    assert back[0].audio_path == str(tmp_path / "audio" / "a.wav")
    assert back[0].segments[1] == podcasts.EpisodeSegment(3.0, 4.25, "")
    assert back[1].segments == [] and back[1].duration is None


@pytest.mark.parametrize("n, window, hop", [(100000, 2.0, 1.0), (100000, 2.0, None),
                                            (16000, 30.0, None), (1, 1.0, None)])
def test_stream_windows_match_jax(n, window, hop):
    wav = np.arange(n, dtype=np.float32)
    got = list(podcasts.stream_windows(wav, 16000, window_seconds=window, hop_seconds=hop))
    want = list(jpodcasts.stream_windows(wav, 16000, window_seconds=window, hop_seconds=hop))
    assert [s for s, _ in got] == [s for s, _ in want]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, want))
    start, last = got[-1]
    assert int(start * 16000) + len(last) == n


def _signal(case, rng):
    sr = 16000
    burst = lambda s: (rng.standard_normal(int(s * sr)) * 0.3).astype(np.float32)
    sil = lambda s: np.zeros(int(s * sr), np.float32)
    if case == "gaps":        # two runs, a gap too short to split, a quiet tail
        return np.concatenate([sil(0.5), burst(1.0), sil(0.1), burst(0.6), sil(0.5),
                               burst(0.4), sil(0.2), burst(0.2) * 0.001]), sr, {}
    if case == "long_run":    # one run longer than max_segment_s
        return np.concatenate([sil(0.3), burst(7.3), sil(0.3)]), sr, {"max_segment_s": 2.0}
    if case == "short":       # shorter than one frame
        return burst(0.01), sr, {}
    return sil(1.0), sr, {}   # silence only


@pytest.mark.parametrize("case", ["gaps", "long_run", "short", "silence"])
def test_segment_by_energy_matches_jax(case):
    wav, sr, kw = _signal(case, np.random.default_rng(7))
    got = podcasts.segment_by_energy(wav, sr, **kw)
    assert got == jpodcasts.segment_by_energy(wav, sr, **kw)
    if case == "gaps":
        assert len(got) == 2
    if case == "long_run":
        assert len(got) == 4 and all(e - s <= 2.0 + 1e-9 for s, e in got)
    if case == "short":
        assert got == [(0.0, 0.01)]
    assert podcasts.segment_by_energy(wav[:0], sr) == []
