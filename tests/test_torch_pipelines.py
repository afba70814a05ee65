"""The port's extract_embeddings on a synthetic SLURP directory
(``--device cpu``), its ``--dtype bfloat16`` against the JAX pipeline's,
and the device rules of its entry points."""

import json
import os
import pickle
import wave

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from loco_asr_tpu.models.speecht5.config import SpeechT5Config as JConfig
from loco_asr_tpu.models.speecht5.prenets import reduce_attention_mask
from loco_asr_tpu_torch.data.embedding_store import EmbeddingStore
from loco_asr_tpu_torch.models.speecht5 import model as tm
from loco_asr_tpu_torch.models.speecht5.config import tiny_config
from loco_asr_tpu_torch.pipelines import extract_embeddings

N_UTT = 5
SECONDS = [0.3 + 0.05 * (i % 3) for i in range(N_UTT)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_wav(path, seconds, seed):
    rng = np.random.default_rng(seed)
    pcm = (rng.standard_normal(int(16000 * seconds)) * 3000).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())


@pytest.fixture(scope="module")
def slurp_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("slurp")
    (root / "dataset/slurp").mkdir(parents=True)
    real = root / "audio/slurp_real"
    real.mkdir(parents=True)
    intents = ["alarm_set", "play_music", "weather_query"]
    with open(root / "dataset/slurp/train.jsonl", "w") as f:
        for i in range(N_UTT):
            fname = f"train_{i}.wav"
            _write_wav(real / fname, SECONDS[i], seed=i)
            f.write(json.dumps({"slurp_id": 100 + i, "sentence": f"sentence {i}",
                                "intent": intents[i % 3],
                                "recordings": [{"file": fname}]}) + "\n")
    return str(root)


def _expected_frames():
    """Per-utterance frame counts from the JAX reduce_attention_mask."""
    lengths = [int(16000 * s) for s in SECONDS]
    mask = np.zeros((N_UTT, 16000), np.int32)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1
    frames = JConfig().feat_extract_output_length(16000)
    return np.asarray(reduce_attention_mask(JConfig(), frames, jnp.asarray(mask))).sum(-1)


@pytest.mark.parametrize("fmt", ["npz", "pickle"])
def test_extract_embeddings_audio(slurp_root, tmp_path, fmt, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / f"emb_{fmt}"
    rc = extract_embeddings.main([
        "-m", "audio", "-s", "train", "--data_path", slurp_root, "--out_dir", str(out),
        "--batch_size", "3", "--format", fmt, "--device", "cpu"])
    assert rc == 0
    frames = _expected_frames()
    if fmt == "npz":
        store = EmbeddingStore(str(out))
        records = [store[i] for i in range(len(store))]
    else:
        records = []
        for name in os.listdir(out):
            if name.endswith(".pickle"):
                with open(out / name, "rb") as f:
                    d = pickle.load(f)
                records.append((d["id"], d["embedding"], d["target"]))
        records.sort(key=lambda r: int(r[0]))
    assert len(records) == N_UTT
    for i, (utt_id, emb, tgt) in enumerate(records):
        assert int(utt_id) == 100 + i
        assert emb.shape == (frames[i], 768) and tgt.shape == (101,)
        assert np.isfinite(emb).all()
    with open(out / "metrics.jsonl") as f:
        assert json.loads(f.readline())["records"] == N_UTT


# the modality: (the seeded JAX init it reads, the embeddings' tolerance:
# the audio encoder computes in float32 on bf16 weights, as JAX's promotes
# with the float32 waveform; the text encoder computes in bf16)
BF16_MODALITIES = {"audio": ("asr_init", 1e-4), "text": ("tts_init", 5e-2)}


@pytest.mark.parametrize("modality", sorted(BF16_MODALITIES))
def test_extract_embeddings_bf16_matches_jax(modality, slurp_root, tmp_path, monkeypatch):
    """``--dtype bfloat16`` (the weights cast, the inputs not), port against
    JAX's CLI under the same flag from one seeded JAX checkpoint, with the
    tiny config in both pipelines: the same records and targets, float32
    embeddings within the modality's tolerance."""
    import jax

    from loco_asr_tpu.models.speecht5 import config as jconfig
    from loco_asr_tpu.models.speecht5 import model as jst5
    from loco_asr_tpu.pipelines import extract_embeddings as jextract
    from loco_asr_tpu.utils.checkpoint import save_npz
    from loco_asr_tpu_torch.models.speecht5 import config as tconfig

    for lib in (jconfig, tconfig):
        full, tiny = lib.SpeechT5Config, lib.tiny_config()
        monkeypatch.setattr(lib, "SpeechT5Config",
                            lambda *a, _t=tiny, _f=full, **kw: _f(*a, **kw) if a or kw else _t)
    init, tol = BF16_MODALITIES[modality]
    ckpt = str(tmp_path / "init.npz")
    save_npz(ckpt, getattr(jst5, init)(jax.random.PRNGKey(5), jconfig.tiny_config()))
    flags = ["-m", modality, "-s", "train", "--data_path", slurp_root, "--batch_size", "3",
             "--checkpoint", ckpt, "--dtype", "bfloat16"]
    monkeypatch.chdir(tmp_path)
    assert jextract.main([*flags, "--out_dir", str(tmp_path / "jax")]) == 0
    assert extract_embeddings.main([*flags, "--out_dir", str(tmp_path / "port"),
                                    "--device", "cpu"]) == 0
    want, got = EmbeddingStore(str(tmp_path / "jax")), EmbeddingStore(str(tmp_path / "port"))
    assert len(got) == len(want) == N_UTT
    for i in range(N_UTT):
        (wid, wemb, wtgt), (gid, gemb, gtgt) = want[i], got[i]
        assert int(gid) == int(wid) and gemb.shape == wemb.shape
        assert gemb.dtype == wemb.dtype == np.float32
        np.testing.assert_array_equal(gtgt, wtgt)
        np.testing.assert_allclose(gemb, wemb, atol=tol, rtol=tol)


@pytest.mark.parametrize("flags", [["-m", "audio", "--data_parallel", "2"]])
def test_unported_options_raise(flags, slurp_root):
    with pytest.raises(SystemExit, match="not supported"):
        extract_embeddings.main([*flags, "-s", "train", "--data_path", slurp_root,
                                 "--device", "cpu"])


def test_entry_points_need_a_gpu_unless_asked_for_cpu(slurp_root, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.asr_init(tiny_config())
    with pytest.raises(RuntimeError, match="CUDA"):
        extract_embeddings.main(["-m", "audio", "-s", "train", "--data_path", slurp_root,
                                 "--out_dir", str(tmp_path / "o")])
    model = tm.asr_init(tiny_config(), device="cpu")
    hidden, _ = tm.encode_speech(model, np.zeros((1, 800), np.float32))
    assert hidden.device.type == "cpu" and hidden.shape == (1, 79, 24)
