"""The port's long-form transcription against the JAX package's on the CPU:
``transcribe_long_audio`` on the same tiny weights (dense and flash; the
JAX flash encoder in Pallas interpret mode, the port's plain versions),
through a crop, an empty segment and the energy endpointer, and with a
tiny fusion LM whose window is small enough that the conversation cache
rolls over twice; then the ``transcribe_episodes`` pipeline of both
packages on one synthetic manifest, per episode and ``--continuous``
(with and without an LM): every ``{episode}.jsonl`` line equal, the
``metrics.jsonl`` keys equal and the WERs equal (RTFx aside).  Token ids
are compared for equality: the encoders agree to ~1e-6 and no decode here
meets a near-tie."""

import dataclasses
import json
import wave

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from loco_asr_tpu.decode.fusion import FusionLM as JFusionLM
from loco_asr_tpu.decode.long_audio import transcribe_long_audio as jtranscribe
from loco_asr_tpu.models.gpt2 import model as jg
from loco_asr_tpu.models.speecht5 import model as jm
from loco_asr_tpu.models.speecht5.config import SpeechT5Config as JConfig
from loco_asr_tpu.pipelines import transcribe_episodes as jepisodes
from loco_asr_tpu.utils.checkpoint import save_npz
from loco_asr_tpu.utils.pytree import flatten_with_paths, unflatten_from_paths
from loco_asr_tpu_torch.data import podcasts
from loco_asr_tpu_torch.decode import context as tcontext
from loco_asr_tpu_torch.decode.fusion import FusionLM
from loco_asr_tpu_torch.decode.long_audio import transcribe_long_audio
from loco_asr_tpu_torch.models.gpt2 import convert as gconvert
from loco_asr_tpu_torch.models.gpt2 import model as tg
from loco_asr_tpu_torch.models.speecht5 import convert
from loco_asr_tpu_torch.models.speecht5 import model as tm
from loco_asr_tpu_torch.models.speecht5.config import tiny_config
from loco_asr_tpu_torch.pipelines import transcribe_episodes

SR = 16000


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def episode_wave(rng, bursts, gap=0.25):
    """Speech-like noise bursts of the given seconds between silences of
    ``gap`` s -> (wave, [(start, end)] of the bursts)."""
    parts, spans, t = [], [], 0.0
    for sec in bursts:
        parts.append(np.zeros(int(gap * SR), np.float32))
        t += gap
        n = int(sec * SR)
        env = 0.5 + 0.5 * np.sin(np.linspace(0.0, 6.0 * np.pi, n)) ** 2
        parts.append((rng.standard_normal(n) * 0.3 * env).astype(np.float32))
        spans.append((t, t + sec))
        t += sec
    parts.append(np.zeros(int(gap * SR), np.float32))
    return np.concatenate(parts), spans


@pytest.fixture(scope="module")
def asr():
    cfg = tiny_config(vocab_size=256, apply_spec_augment=False, mask_time_prob=0.0)
    jcfg = JConfig(**dataclasses.asdict(cfg))
    flat = {k: np.asarray(v) for k, v in
            flatten_with_paths(jm.asr_init(jax.random.PRNGKey(0), jcfg)).items()}
    model = tm.AsrModel(cfg)
    model.load_state_dict(convert.asr_from_jax_params(flat, cfg), strict=True)
    jparams = unflatten_from_paths({k: jnp.asarray(v) for k, v in flat.items()})
    return cfg, jcfg, jparams, model.eval()


def _lm_pair(n_positions, vocab_size=256, seed=1):
    jcfg = jg.tiny_gpt2_config(vocab_size=vocab_size, n_embd=32, n_head=4,
                               n_positions=n_positions)
    jparams = jg.gpt2_init(jax.random.PRNGKey(seed), jcfg)
    flat = {k: np.asarray(v) for k, v in flatten_with_paths(jparams).items()}
    cfg = tg.GPT2Config(**jcfg.__dict__)
    model = tg.GPT2Model(cfg)
    model.load_state_dict(gconvert.from_jax_params(flat, cfg), strict=True)
    return jparams, jcfg, model.eval()


def _ids(segs):
    return [(s.start, s.end, s.token_ids) for s in segs]


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
@pytest.mark.parametrize("segmented", ["manifest", "endpointer"])
def test_transcribe_long_audio_matches_jax(asr, attn_impl, segmented):
    """Given segments (one of 1.4 s cropped to ``batch_seconds`` 1, one past
    the end of the wave, so empty) or the energy endpointer's."""
    cfg, jcfg, jparams, model = asr
    wav, spans = episode_wave(np.random.default_rng(3), [0.5, 1.4, 0.7])
    segments = None
    if segmented == "manifest":
        end = len(wav) / SR
        segments = spans + [(end + 1.0, end + 2.0)]
    kw = dict(segments=segments, max_decode_len=6, batch_seconds=1.0,
              attn_impl=attn_impl)
    got = transcribe_long_audio(model, wav, SR, **kw)
    want = jtranscribe(jparams, jcfg, wav, SR, **kw)
    assert len(got) == (3 if segmented == "manifest" else len(want)) and len(got) >= 3
    assert _ids(got) == _ids(want)


def test_transcribe_long_audio_with_fusion_rolls_the_context_like_jax(asr, monkeypatch):
    """A tiny LM of 40 positions, ``decode_reserve`` 14: the context window
    (26 positions) fills every four segments of 6 tokens, so eight segments
    refresh the cache twice."""
    cfg, jcfg, jparams, model = asr
    lm_jparams, lm_jcfg, lm_model = _lm_pair(n_positions=40, vocab_size=cfg.vocab_size)
    wav, spans = episode_wave(np.random.default_rng(4), [0.4] * 8)
    refreshes = []
    real = tcontext.ConversationContext._refresh

    def counted(self):
        refreshes.append(self.history_len)
        real(self)

    monkeypatch.setattr(tcontext.ConversationContext, "_refresh", counted)
    kw = dict(segments=spans, max_decode_len=6, batch_seconds=1.0)
    got = transcribe_long_audio(model, wav, SR, fusion=FusionLM(lm_model, weight=0.5), **kw)
    want = jtranscribe(jparams, jcfg, wav, SR,
                       fusion=JFusionLM(lm_jparams, lm_jcfg, weight=0.5), **kw)
    assert len(got) == 8 and len(refreshes) >= 2
    assert _ids(got) == _ids(want)


def _write_wav(path, wav):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((np.clip(wav, -1, 1) * 30000).astype(np.int16).tobytes())


@pytest.fixture(scope="module")
def episodes(tmp_path_factory):
    """Two episodes: ``ep0`` with timestamps and texts (its audio named
    relative to the manifest), ``ep1`` left to the endpointer; the ASR and
    tiny-LM weights as JAX ``.npz`` files."""
    root = tmp_path_factory.mktemp("episodes")
    rng = np.random.default_rng(5)
    eps = []
    for e, bursts in enumerate([[0.5, 0.6, 0.4], [0.5, 0.7]]):
        wav, spans = episode_wave(rng, bursts)
        _write_wav(root / f"ep{e}.wav", wav)
        segs = ([podcasts.EpisodeSegment(a, b, f"ref text {e} {i}")
                 for i, (a, b) in enumerate(spans)] if e == 0 else [])
        eps.append(podcasts.Episode(f"ep{e}", f"ep{e}.wav", duration=len(wav) / SR,
                                    segments=segs))
    podcasts.write_manifest(str(root / "manifest.jsonl"), eps)
    # the pipelines' --tiny config (SpecAugment's mask embedding included)
    cli_cfg = JConfig(**dataclasses.asdict(tiny_config(vocab_size=256,
                                                       apply_spec_augment=False)))
    save_npz(str(root / "asr.npz"), jm.asr_init(jax.random.PRNGKey(0), cli_cfg))
    lm_jparams, _, _ = _lm_pair(n_positions=512)
    save_npz(str(root / "lm.npz"), lm_jparams)
    return root


def _episode_run(main, root, name, extra):
    out = root / name
    assert main(["--manifest", str(root / "manifest.jsonl"), "--out_dir", str(out),
                 "--tiny", "--checkpoint", str(root / "asr.npz"), "--max_decode_len", "6",
                 "--batch_seconds", "1.0", *extra]) == 0
    lines = {ep: [json.loads(l) for l in open(out / f"{ep}.jsonl")] for ep in ("ep0", "ep1")}
    rows = [json.loads(l) for l in open(out / "metrics.jsonl")]
    return lines, {r["episode"]: r for r in rows}


@pytest.mark.parametrize("mode", ["per_episode_lm", "continuous", "continuous_lm"])
def test_transcribe_episodes_matches_jax(episodes, mode):
    extra = {"per_episode_lm": ["--lm_checkpoint", str(episodes / "lm.npz")],
             "continuous": ["--continuous", "--slots", "2", "--chunk_steps", "3"],
             "continuous_lm": ["--continuous", "--slots", "2", "--chunk_steps", "3",
                               "--lm_checkpoint", str(episodes / "lm.npz")]}[mode]
    lines, rows = _episode_run(transcribe_episodes.main, episodes, f"port_{mode}",
                               [*extra, "--device", "cpu"])
    jlines, jrows = _episode_run(jepisodes.main, episodes, f"jax_{mode}", extra)
    assert len(lines["ep0"]) == 3 and lines["ep1"]
    assert lines == jlines
    rate = "corpus_rtfx" if mode.startswith("continuous") else "rtfx"
    for ep, row in rows.items():
        assert row.keys() == jrows[ep].keys()
        assert row["segments"] == jrows[ep]["segments"] and row[rate] > 0
    if mode.startswith("continuous"):
        assert rows["ep0"]["wer"] == jrows["ep0"]["wer"] and np.isfinite(rows["ep0"]["wer"])
        assert "wer" not in rows["ep1"]


def test_transcribe_episodes_refuses_an_lm_of_another_vocabulary(episodes):
    with pytest.raises(SystemExit, match="vocabulary"):
        transcribe_episodes.main(["--manifest", str(episodes / "manifest.jsonl"),
                                  "--out_dir", str(episodes / "vocab"), "--tiny",
                                  "--vocab_size", "300", "--device", "cpu",
                                  "--lm_checkpoint", str(episodes / "lm.npz")])


def test_padding_reaches_the_encoder_in_both_packages(asr):
    """The first conv layer's instance norm reads the padded frames, so one
    segment padded to 1 s (per episode) and to a 2 s bucket (continuous)
    encodes differently, by the same amount in both packages: the two
    modes' tokens differ by design."""
    cfg, jcfg, jparams, model = asr
    x = (np.random.default_rng(6).standard_normal(8000) * 0.3).astype(np.float32)
    got, want = [], []
    for total in (SR, 2 * SR):
        w = np.zeros((1, total), np.float32)
        w[0, :8000] = x
        m = (np.arange(total) < 8000).astype(np.int32)[None]
        h, fm = tm.encode_speech(model, w, m)
        n = int(fm.sum())
        got.append(h[0, :n].numpy())
        jh, _ = jm.encode_speech(jparams, jcfg, jnp.asarray(w), jnp.asarray(m))
        want.append(np.asarray(jh)[0, :n])
    gap, jgap = np.abs(got[0] - got[1]).max(), np.abs(want[0] - want[1]).max()
    assert gap > 0.05 and abs(gap - jgap) <= 1e-4, (gap, jgap)
