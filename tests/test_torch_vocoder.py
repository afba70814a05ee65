"""The port's HiFi-GAN vocoder against the JAX package's on the same
weights (carried by the bridge) and spectrograms: ``tiny_hifigan_config``
batched and unbatched at 1e-5, ``HifiGanConfig()`` (the
microsoft/speecht5_hifigan layout) at 1e-4, with the input normalisation's
mean and scale set away from 0 and 1; and the bridge's round trip."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from loco_asr_tpu.models.speecht5 import vocoder as jvoc
from loco_asr_tpu.utils.pytree import flatten_with_paths, unflatten_from_paths
from loco_asr_tpu_torch.models.speecht5 import convert
from loco_asr_tpu_torch.models.speecht5 import vocoder as tvoc


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(tcfg, jcfg, seed):
    flat = {k: np.asarray(v) for k, v in
            flatten_with_paths(jvoc.hifigan_init(jax.random.PRNGKey(seed), jcfg)).items()}
    rng = np.random.default_rng(seed)
    n = jcfg.model_in_dim
    flat["mean"] = (rng.standard_normal(n) * 0.5).astype(np.float32)
    flat["scale"] = (1.0 + rng.random(n)).astype(np.float32)
    for k, v in flat.items():
        if k.endswith("bias"):
            flat[k] = (rng.standard_normal(v.shape) * 0.05).astype(np.float32)
    model = tvoc.HifiGan(tcfg).eval()
    model.load_state_dict(convert.hifigan_from_jax_params(flat, tcfg))
    return unflatten_from_paths({k: jnp.asarray(v) for k, v in flat.items()}), flat, model


@pytest.fixture(scope="module")
def tiny():
    return _pair(tvoc.tiny_hifigan_config(), jvoc.tiny_hifigan_config(), 0)


@pytest.mark.parametrize("shape", [(2, 12, 8), (5, 8)])
def test_hifigan_tiny(tiny, shape):
    params, _, model = tiny
    mel = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = np.asarray(jvoc.hifigan(params, jvoc.tiny_hifigan_config(), jnp.asarray(mel)))
    with torch.no_grad():
        got = tvoc.hifigan(model, torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (*shape[:-2], shape[-2] * 16)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_hifigan_published_layout():
    """Weights drawn by the port and carried to JAX (the JAX init draws a
    13.6M-parameter tree slowly on the CPU)."""
    model = tvoc.HifiGan(tvoc.HifiGanConfig(), torch.Generator().manual_seed(2)).eval()
    rng = np.random.default_rng(2)
    model.mean.copy_(torch.from_numpy((rng.standard_normal(80) * 0.5).astype(np.float32)))
    model.scale.copy_(torch.from_numpy((1.0 + rng.random(80)).astype(np.float32)))
    params = unflatten_from_paths({k: jnp.asarray(v) for k, v in
                                   convert.hifigan_to_jax_params(model).items()})
    mel = rng.standard_normal((1, 6, 80)).astype(np.float32)
    want = np.asarray(jvoc.hifigan(params, jvoc.HifiGanConfig(), jnp.asarray(mel)))
    with torch.no_grad():
        got = tvoc.hifigan(model, torch.from_numpy(mel)).numpy()
    assert got.shape == (1, 6 * 256)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_bridge_round_trip(tiny):
    _, flat, model = tiny
    back = convert.hifigan_to_jax_params(model)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    with pytest.raises(KeyError, match="conv_post.bias"):
        convert.hifigan_from_jax_params({k: v for k, v in flat.items() if k != "conv_post.bias"},
                                        tvoc.tiny_hifigan_config())
