"""Weight bridge: JAX SpeechT5 params (flat ``flatten_with_paths`` dicts
and ``save_npz`` checkpoints) -> the port's SpeechEncoder state dict."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from loco_asr_tpu.models.speecht5 import model as jm
from loco_asr_tpu.models.speecht5.config import tiny_config as jtiny
from loco_asr_tpu.utils.checkpoint import save_npz
from loco_asr_tpu.utils.pytree import flatten_with_paths
from loco_asr_tpu_torch.models.speecht5 import convert
from loco_asr_tpu_torch.models.speecht5 import model as tm
from loco_asr_tpu_torch.models.speecht5.config import tiny_config
from loco_asr_tpu_torch.pipelines import common


@pytest.fixture(scope="module")
def jax_params():
    return jm.asr_init(jax.random.PRNGKey(1), jtiny())


@pytest.fixture(scope="module")
def flat(jax_params):
    return {k: np.asarray(v) for k, v in flatten_with_paths(jax_params).items()}


def test_every_encoder_leaf_is_consumed(flat):
    cfg = tiny_config()
    state = convert.from_jax_params(flat, cfg)
    model_keys = set(tm.SpeechEncoder(cfg).state_dict())
    assert set(state) == model_keys
    enc_leaves = [k for k in flat if k.startswith("encoder.")]
    assert len(enc_leaves) == len(state)
    for key in enc_leaves:
        name, transpose = convert._port_key(key)
        want = flat[key].T if transpose else flat[key]
        np.testing.assert_array_equal(state[name].numpy(), want)


def test_transposes_dense_kernels(flat):
    state = convert.from_jax_params(flat, tiny_config())
    k = flat["encoder.wrapped_encoder.layers.0.feed_forward.intermediate_dense.kernel"]
    w = state["wrapped_encoder.layers.0.feed_forward.intermediate_dense.weight"]
    assert k.shape == (24, 48) and tuple(w.shape) == (48, 24)


def test_missing_key_raises(flat):
    broken = dict(flat)
    del broken["encoder.wrapped_encoder.layers.1.final_layer_norm.scale"]
    with pytest.raises(KeyError, match="missing"):
        convert.from_jax_params(broken, tiny_config())


def test_unexpected_key_raises(flat):
    broken = dict(flat)
    broken["encoder.wrapped_encoder.layers.2.layer_norm.scale"] = np.ones(24, np.float32)
    with pytest.raises(KeyError, match="unexpected"):
        convert.from_jax_params(broken, tiny_config())


def test_shape_mismatch_raises(flat):
    broken = dict(flat)
    broken["encoder.prenet.feature_projection.projection.bias"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="shape"):
        convert.from_jax_params(broken, tiny_config())


def test_non_encoder_keys_are_ignored(flat):
    enc_only = {k: v for k, v in flat.items() if k.startswith("encoder.")}
    a = convert.from_jax_params(flat, tiny_config())
    b = convert.from_jax_params(enc_only, tiny_config())
    assert a.keys() == b.keys()


def test_save_npz_checkpoint_loads(jax_params, flat, tmp_path):
    path = str(tmp_path / "ckpt.npz")
    save_npz(path, jax_params)
    model = common.load_speecht5_params(path, tiny_config(), device="cpu")
    state = model.state_dict()
    np.testing.assert_array_equal(
        state["wrapped_encoder.embed_positions.pe_k.weight"].numpy(),
        flat["encoder.wrapped_encoder.embed_positions.pe_k.weight"])


def test_other_checkpoint_formats_raise(tmp_path):
    # every format of the JAX loader is read (tests/test_torch_import_torch.py);
    # a directory without weights, a missing file and an unknown variant raise
    with pytest.raises(FileNotFoundError, match="no weights"):
        common.load_speecht5_params(str(tmp_path), tiny_config(), device="cpu")
    with pytest.raises(FileNotFoundError):
        common.load_speecht5_params(str(tmp_path / "model.safetensors"), tiny_config(),
                                    device="cpu")
    with pytest.raises(ValueError, match="variant"):
        common.load_speecht5_params(None, tiny_config(), device="cpu", variant="s2s")
