"""Real-weight import in the port (``models/speecht5/import_torch.py``,
``pipelines/common.py::load_speecht5_params``, ``utils/safetensors.py``)
and ``extract_embeddings -m text``, against the JAX package on the CPU.

* HF: random tiny ``transformers`` SpeechT5 models (ASR and TTS), saved as
  ``pytorch_model.bin`` / ``model.safetensors`` directories and files; both
  packages' ``load_speecht5_params`` read them, and the encoder outputs
  agree within 1e-5 (and with HF's own within 1e-4).
* fairseq: a synthetic ``speecht5_base.pt`` built by inverse-renaming a
  tiny JAX model (the construction of ``tests/test_fairseq_import.py``,
  copied), grafted by both packages into their inits: the speech and text
  encoder outputs agree, and equal the source model's.
* The safetensors reader equals ``safetensors.torch.load_file``.
* ``extract_embeddings -m text`` on a SLURP directory (char and
  SentencePiece tokenizers, a JAX ``.npz`` and an HF directory) writes the
  JAX pipeline's embeddings within 1e-4; the config is the tiny one in
  both packages (patched on the test side), so the weights stay small.
"""

import json
import re
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax
import jax.numpy as jnp
from transformers import SpeechT5Config as HFConfig
from transformers.models.speecht5.modeling_speecht5 import (
    SpeechT5ForSpeechToText, SpeechT5ForTextToSpeech)

from chip_smoke import write_sentencepiece_model
from loco_asr_tpu.models.speecht5 import config as jconfig
from loco_asr_tpu.models.speecht5 import model as jst5
from loco_asr_tpu.pipelines import common as jcommon
from loco_asr_tpu.pipelines import extract_embeddings as jextract
from loco_asr_tpu.utils.checkpoint import save_npz
from loco_asr_tpu.utils.pytree import flatten_with_paths
from loco_asr_tpu_torch.data.embedding_store import EmbeddingStore
from loco_asr_tpu_torch.models.speecht5 import config as tconfig
from loco_asr_tpu_torch.models.speecht5 import import_torch as timport
from loco_asr_tpu_torch.models.speecht5 import model as tst5
from loco_asr_tpu_torch.pipelines import common as tcommon
from loco_asr_tpu_torch.pipelines import extract_embeddings as textract
from loco_asr_tpu_torch.utils import safetensors as tsafetensors

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def hf_tiny_config():
    return HFConfig(
        vocab_size=37, hidden_size=24, encoder_layers=2, encoder_attention_heads=2,
        encoder_ffn_dim=48, decoder_layers=2, decoder_attention_heads=2, decoder_ffn_dim=48,
        conv_dim=[16, 16], conv_stride=[5, 2], conv_kernel=[10, 3],
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        max_speech_positions=256, max_text_positions=64, encoder_max_relative_position=20,
        speech_decoder_prenet_units=16, speech_decoder_postnet_units=16, num_mel_bins=8,
        speaker_embedding_dim=12, hidden_dropout=0.0, attention_dropout=0.0,
        activation_dropout=0.0, positional_dropout=0.0, feat_proj_dropout=0.0,
        encoder_layerdrop=0.0, decoder_layerdrop=0.0, apply_spec_augment=False)


def jtiny():
    return jconfig.tiny_config(apply_spec_augment=False, mask_time_prob=0.0)


def ttiny():
    return tconfig.tiny_config(apply_spec_augment=False, mask_time_prob=0.0)


def _wav(seed=0, b=2, t=640):
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal((b, t)) * 0.1).astype(np.float32)
    mask = np.ones((b, t), np.int32)
    mask[1, 450:] = 0
    wav[1, 450:] = 0.0
    return wav, mask


IDS = np.array([[0, 4, 7, 9, 12, 2, 1, 1], [0, 5, 6, 30, 2, 1, 1, 1]], np.int64)


def _speech_pair(jparams, tmodel):
    """Both packages' encoder outputs on valid frames."""
    wav, mask = _wav()
    want, jmask = jst5.encode_speech(jparams, jtiny(), jnp.asarray(wav), jnp.asarray(mask))
    got, tmask = tst5.encode_speech(tmodel, wav, mask)
    valid = np.asarray(jmask).astype(bool)
    np.testing.assert_array_equal(tmask.numpy().astype(bool), valid)
    return got.numpy()[valid], np.asarray(want)[valid]


def _text_pair(jparams, tmodel):
    mask = (IDS != 1).astype(np.int64)
    want = jst5.encode_text(jparams, jtiny(), jnp.asarray(IDS), jnp.asarray(mask))
    with torch.no_grad():
        got = tst5.encode_text(tmodel, torch.from_numpy(IDS), torch.from_numpy(mask))
    valid = mask.astype(bool)
    return got.numpy()[valid], np.asarray(want)[valid]


@pytest.fixture(scope="module")
def hf_models(tmp_path_factory):
    """Random tiny HF ASR and TTS models, each saved three ways."""
    from safetensors.torch import save_file

    root = tmp_path_factory.mktemp("hf")
    out = {}
    for name, cls, seed in (("asr", SpeechT5ForSpeechToText, 0),
                            ("tts", SpeechT5ForTextToSpeech, 1)):
        torch.manual_seed(seed)
        hf = cls(hf_tiny_config()).eval()
        state = {k: v.clone().contiguous() for k, v in hf.state_dict().items()}
        (root / f"{name}_bin").mkdir()
        torch.save(state, root / f"{name}_bin" / "pytorch_model.bin")
        (root / f"{name}_st").mkdir()
        save_file(state, str(root / f"{name}_st" / "model.safetensors"))
        save_file(state, str(root / f"{name}.safetensors"))
        out[name] = (hf, {"bin_dir": str(root / f"{name}_bin"),
                          "safetensors_dir": str(root / f"{name}_st"),
                          "safetensors": str(root / f"{name}.safetensors"),
                          "bin": str(root / f"{name}_bin" / "pytorch_model.bin")})
    return out


@pytest.mark.parametrize("source", ["bin_dir", "safetensors_dir", "safetensors", "bin"])
@pytest.mark.parametrize("variant", ["asr", "encoder"])
def test_hf_asr_load_matches_jax(hf_models, source, variant):
    hf, paths = hf_models["asr"]
    jparams = jcommon.load_speecht5_params(paths[source], "asr", jtiny())
    tmodel = tcommon.load_speecht5_params(paths[source], ttiny(), device="cpu",
                                          variant=variant)
    got, want = _speech_pair(jparams, tmodel)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    wav, mask = _wav()
    with torch.no_grad():
        ref = hf.speecht5.encoder(input_values=torch.from_numpy(wav),
                                  attention_mask=torch.from_numpy(mask)).last_hidden_state
    np.testing.assert_allclose(got, ref.numpy()[np.asarray(
        jst5.encode_speech(jparams, jtiny(), jnp.asarray(wav), jnp.asarray(mask))[1]
    ).astype(bool)], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("source", ["bin_dir", "safetensors_dir", "safetensors"])
def test_hf_tts_load_matches_jax(hf_models, source):
    hf, paths = hf_models["tts"]
    jparams = jcommon.load_speecht5_params(paths[source], "tts", jtiny())
    tmodel = tcommon.load_speecht5_params(paths[source], ttiny(), device="cpu",
                                          variant="tts")
    got, want = _text_pair(jparams, tmodel)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    mask = (IDS != 1).astype(np.int64)
    with torch.no_grad():
        ref = hf.speecht5.encoder(input_values=torch.from_numpy(IDS),
                                  attention_mask=torch.from_numpy(mask)).last_hidden_state
    np.testing.assert_allclose(got, ref.numpy()[mask.astype(bool)], atol=1e-4, rtol=1e-4)


def test_shape_mismatch_raises(hf_models):
    _, paths = hf_models["asr"]
    with pytest.raises(ValueError, match="shape mismatch"):
        tcommon.load_speecht5_params(paths["safetensors"], tconfig.tiny_config(hidden_size=32),
                                     device="cpu", variant="asr")


@pytest.mark.parametrize("old,new", [
    ("attention.k_proj.", "attention.key_proj."),          # inside a module the model has
    ("speecht5.encoder.prenet.", "speecht5.encoder_prenet."),  # under no model half
])
def test_mis_mapped_key_raises(hf_models, tmp_path, old, new):
    """A loaded key that overlays nothing raises, naming it, rather than
    leaving the parameter it was meant for at its seeded init."""
    from safetensors.torch import save_file

    hf, _ = hf_models["asr"]
    state = {k.replace(old, new, 1): v.clone().contiguous() for k, v in hf.state_dict().items()}
    assert state.keys() != hf.state_dict().keys()
    save_file(state, str(tmp_path / "w.safetensors"))
    with pytest.raises(KeyError, match="name no parameter"):
        tcommon.load_speecht5_params(str(tmp_path / "w.safetensors"), ttiny(), device="cpu",
                                     variant="asr")


def test_keys_of_absent_modules_are_dropped(hf_models):
    """The ASR model's weights under the ``tts`` variant: the speech prenet,
    the text decoder prenet and postnet have no module there and are
    dropped; the shared encoder stack is read."""
    hf, paths = hf_models["asr"]
    tmodel = tcommon.load_speecht5_params(paths["safetensors"], ttiny(), device="cpu",
                                          variant="tts")
    want = hf.speecht5.encoder.wrapped_encoder.state_dict()
    got = tmodel.encoder.wrapped_encoder.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


# -- fairseq (the construction of tests/test_fairseq_import.py) ------------

def to_fairseq_state(params) -> dict:
    """A JAX ASR or TTS tree -> synthetic fairseq ckpt['model'] naming."""
    out = {}
    enc = flatten_with_paths(params["encoder"]["wrapped_encoder"])
    for k, v in enc.items():
        v = np.asarray(v)
        fk = k.replace("embed_positions.pe_k", "pos_emb.pe_k")
        fk = re.sub(r"layers\.(\d+)\.attention\.", r"layers.\1.self_attn.", fk)
        fk = re.sub(r"layers\.(\d+)\.layer_norm\.", r"layers.\1.self_attn_layer_norm.", fk)
        fk = re.sub(r"layers\.(\d+)\.feed_forward\.intermediate_dense\.", r"layers.\1.fc1.", fk)
        fk = re.sub(r"layers\.(\d+)\.feed_forward\.output_dense\.", r"layers.\1.fc2.", fk)
        if fk.endswith(".kernel"):
            v, fk = v.T, fk[: -len(".kernel")] + ".weight"
        fk = re.sub(r"\.scale$", ".weight", fk)
        out["encoder." + fk] = torch.from_numpy(np.array(v))

    pre = flatten_with_paths(params["encoder"]["prenet"])
    for k, v in pre.items():
        v = np.asarray(v)
        if k == "masked_spec_embed":
            fk = "mask_emb"
        elif k.startswith("feature_projection.layer_norm."):
            fk = "layer_norm." + k.rsplit(".", 1)[1].replace("scale", "weight")
        elif k == "feature_projection.projection.kernel":
            fk, v = "post_extract_proj.weight", v.T
        elif k == "feature_projection.projection.bias":
            fk = "post_extract_proj.bias"
        elif k.startswith("feature_encoder.conv_layers."):
            m = re.match(r"feature_encoder\.conv_layers\.(\d+)\."
                         r"(conv|layer_norm)\.(weight|scale|bias)", k)
            sub = "0" if m.group(2) == "conv" else "2"
            leaf = m.group(3).replace("scale", "weight")
            fk = f"feature_extractor.conv_layers.{m.group(1)}.{sub}.{leaf}"
        elif k.startswith("pos_conv_embed.conv."):
            fk = "pos_conv.0." + k[len("pos_conv_embed.conv."):]
        else:
            continue
        out["speech_encoder_prenet." + fk] = torch.from_numpy(np.array(v))
    return out


@pytest.fixture(scope="module")
def fairseq_ckpt(tmp_path_factory):
    """A fairseq checkpoint whose speech side is a seeded JAX ASR model and
    whose text table is seeded, saved with ``torch.save``; and the source."""
    src = jst5.asr_init(jax.random.PRNGKey(0), jtiny())
    state = to_fairseq_state(src)
    table = np.random.default_rng(4).standard_normal((37, 24)).astype(np.float32)
    state["text_encoder_prenet.encoder_prenet.0.weight"] = torch.from_numpy(table)
    path = tmp_path_factory.mktemp("fairseq") / "speecht5_base.pt"
    torch.save({"model": state, "cfg": {"note": "synthetic"}}, path)
    return str(path), src, table


@pytest.mark.parametrize("variant", ["asr", "encoder"])
def test_fairseq_speech_graft_matches_jax(fairseq_ckpt, variant):
    path, src, _ = fairseq_ckpt
    jparams = jcommon.load_speecht5_params(path, "asr", jtiny())
    tmodel = tcommon.load_speecht5_params(path, ttiny(), device="cpu", variant=variant)
    got, want = _speech_pair(jparams, tmodel)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    wav, mask = _wav()
    ref, rmask = jst5.encode_speech(src, jtiny(), jnp.asarray(wav), jnp.asarray(mask))
    np.testing.assert_allclose(got, np.asarray(ref)[np.asarray(rmask).astype(bool)],
                               atol=TOL, rtol=TOL)
    # the graft replaced the port's own seeded init
    init = tst5.asr_init(ttiny(), device="cpu")
    plain, _ = tst5.encode_speech(init, wav, mask)
    assert np.abs(plain.numpy()[np.asarray(rmask).astype(bool)] - got).max() > 1e-3


def test_fairseq_text_graft_matches_jax(fairseq_ckpt):
    path, src, table = fairseq_ckpt
    jparams = jcommon.load_speecht5_params(path, "tts", jtiny())
    tmodel = tcommon.load_speecht5_params(path, ttiny(), device="cpu", variant="tts")
    np.testing.assert_array_equal(
        tmodel.encoder.prenet.embed_tokens.weight.detach().numpy(), table)
    got, want = _text_pair(jparams, tmodel)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_fairseq_loaders_match_jax(fairseq_ckpt):
    from loco_asr_tpu.models.speecht5 import import_torch as jimport

    path, _, _ = fairseq_ckpt
    ckpt = torch.load(path, weights_only=False)
    want = jimport.load_fairseq_checkpoint(ckpt)
    got = timport.load_fairseq_checkpoint(ckpt)
    for part in ("encoder", "speech_prenet", "text_prenet"):
        w = {k: np.asarray(v) for k, v in flatten_with_paths(want[part]).items()}
        assert got[part].keys() == w.keys(), part
        for k in w:
            np.testing.assert_array_equal(got[part][k], w[k], err_msg=k)


# -- the .safetensors reader ---------------------------------------------------

def test_safetensors_reader_equals_the_package(tmp_path):
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(0)
    tensors = {"f32": torch.randn(3, 5, generator=g),
               "f16": torch.randn(7, generator=g).half(),
               "bf16": torch.randn(2, 2, 3, generator=g).bfloat16(),
               "i64": torch.randint(-10**12, 10**12, (4,), generator=g),
               "scalar": torch.tensor(2.5),
               "empty": torch.zeros(0, 3)}
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    want = load_file(path)
    got = tsafetensors.load_file(path)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_safetensors_reader_refuses_other_dtypes(tmp_path):
    header = json.dumps({"x": {"dtype": "I8", "shape": [2], "data_offsets": [0, 2]}}).encode()
    path = tmp_path / "i8.safetensors"
    path.write_bytes(struct.pack("<Q", len(header)) + header + b"\x01\x02")
    with pytest.raises(ValueError, match="I8"):
        tsafetensors.load_file(str(path))


# -- extract_embeddings -m text ----------------------------------------------

def _spm_model(path):
    """A SentencePiece .model proto whose ids stay inside the tiny vocab."""
    pieces = [("<s>", 0.0, 3), ("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2),
              ("▁", -3.0, 1)] + [(c, -2.5, 1) for c in "abcdefghijklmnopqrstuvwxyz"] + [
              ("▁wake", -1.0, 1), ("▁me", -1.2, 1), ("▁up", -1.1, 1), ("▁play", -1.3, 1),
              ("▁the", -0.9, 1)]
    write_sentencepiece_model(str(path), pieces)
    return len(pieces)


@pytest.fixture(scope="module")
def text_slurp(tmp_path_factory):
    root = tmp_path_factory.mktemp("slurp_text")
    (root / "dataset/slurp").mkdir(parents=True)
    (root / "audio/slurp_real").mkdir(parents=True)
    sentences = ["wake me up at seven", "play the next song please", "what's the weather",
                 "turn the lights off", "ÀLARM 9 am", "make me a coffee now"]
    intents = ["alarm_set", "play_music", "weather_query", "iot_hue_lightoff",
               "alarm_set", "iot_coffee"]
    with open(root / "dataset/slurp/train.jsonl", "w") as f:
        for i, (s, intent) in enumerate(zip(sentences, intents)):
            f.write(json.dumps({"slurp_id": 500 + i, "sentence": s, "intent": intent,
                                "recordings": [{"file": f"u{i}.wav"}]}) + "\n")
    return str(root)


@pytest.mark.parametrize("tokenizer,source", [("char", "npz"), ("spm", "npz"),
                                              ("char", "hf")])
def test_text_extraction_matches_jax(text_slurp, hf_models, tmp_path, monkeypatch,
                                     tokenizer, source):
    # the tiny config in both pipelines (they build SpeechT5Config() inside)
    for lib, tiny in ((jconfig, jtiny()), (tconfig, ttiny())):
        full = lib.SpeechT5Config
        monkeypatch.setattr(lib, "SpeechT5Config",
                            lambda *a, _t=tiny, _f=full, **kw: _f(*a, **kw) if a or kw else _t)
    if source == "npz":
        ckpt = str(tmp_path / "tts.npz")
        save_npz(ckpt, jst5.tts_init(jax.random.PRNGKey(3), jtiny()))
    else:
        ckpt = hf_models["tts"][1]["safetensors_dir"]
    tok = "char"
    if tokenizer == "spm":
        tok = str(tmp_path / "spm.model")
        assert _spm_model(tmp_path / "spm.model") <= 37
    flags = ["-m", "text", "-s", "train", "--data_path", text_slurp, "--batch_size", "4",
             "--checkpoint", ckpt, "--tokenizer", tok]
    monkeypatch.chdir(tmp_path)
    assert jextract.main([*flags, "--out_dir", str(tmp_path / "jax")]) == 0
    assert textract.main([*flags, "--out_dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    want, got = EmbeddingStore(str(tmp_path / "jax")), EmbeddingStore(str(tmp_path / "port"))
    assert len(got) == len(want) == 6
    for i in range(6):
        (wid, wemb, wtgt), (gid, gemb, gtgt) = want[i], got[i]
        assert int(gid) == int(wid) and gemb.shape == wemb.shape
        np.testing.assert_array_equal(gtgt, wtgt)
        np.testing.assert_allclose(gemb, wemb, atol=1e-4, rtol=1e-4)
    with open(tmp_path / "port" / "metrics.jsonl") as f:
        rec = json.loads(f.readline())
    assert rec["modality"] == "text" and rec["records"] == 6
