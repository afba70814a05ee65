"""Kernel B2's plain version (loco_asr_tpu_torch.ops.cuda.conv_frontend)
against the JAX Pallas kernel in interpret mode and the XLA gram form,
atol/rtol 2e-5 as the JAX package's own test."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from loco_asr_tpu.models.speecht5.prenets import conv1_instance_norm_gelu_gram
from loco_asr_tpu.ops.pallas.conv_frontend import conv1_instance_norm_gelu as pallas_b2
from loco_asr_tpu_torch.ops.cuda import conv_frontend as cf

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(t, c=32, b=2, seed=0):
    rng = np.random.default_rng(seed)
    wav = rng.standard_normal((b, t)).astype(np.float32) * 0.1
    w = rng.standard_normal((c, 1, 10)).astype(np.float32) * 0.3
    scale = rng.standard_normal(c).astype(np.float32) * 0.2 + 1.0
    bias = rng.standard_normal(c).astype(np.float32) * 0.1
    return wav, w, scale, bias


@pytest.mark.parametrize("t,chunk", [(8000, 256), (5003, 128)])
def test_plain_matches_pallas_interpret(t, chunk):
    wav, w, scale, bias = _inputs(t)
    want = np.asarray(pallas_b2(*map(jnp.asarray, (wav, w, scale, bias)),
                                chunk_frames=chunk, interpret=True))
    got = cf.conv1_instance_norm_gelu_plain(*map(torch.from_numpy, (wav, w, scale, bias)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("t", [8000, 5003, 16000])
def test_plain_matches_gram_form(t):
    wav, w, scale, bias = _inputs(t, c=64, b=3, seed=t)
    wav[2, t // 2:] = 0.0        # padded row: the norm still spans all frames
    want = np.asarray(conv1_instance_norm_gelu_gram(*map(jnp.asarray, (wav, w, scale, bias))))
    got = cf.conv1_instance_norm_gelu_plain(*map(torch.from_numpy, (wav, w, scale, bias)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    wav, w, scale, bias = _inputs(4000)
    args = tuple(map(torch.from_numpy, (wav, w, scale, bias)))
    before = cf.conv1_instance_norm_gelu.launches
    got = cf.conv1_instance_norm_gelu(*args)
    assert cf.conv1_instance_norm_gelu.launches == before
    torch.testing.assert_close(got, cf.conv1_instance_norm_gelu_plain(*args),
                               atol=0, rtol=0)


@pytest.mark.parametrize("fn", [cf.conv1_instance_norm_gelu_plain,
                                cf.conv1_instance_norm_gelu])
def test_rejects_bad_geometry(fn):
    with pytest.raises(ValueError, match="2\\*stride"):
        fn(torch.zeros(1, 100), torch.zeros(4, 1, 8), torch.ones(4), torch.zeros(4))
