"""loco_asr_tpu_torch.ops.layers against loco_asr_tpu.ops.layers on the same
numpy inputs (f32, tolerance 1e-6)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from loco_asr_tpu.ops import layers as jl
from loco_asr_tpu_torch.ops import layers as tl

TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_gelu():
    x = (_rng().standard_normal((4, 33)) * 3).astype(np.float32)
    np.testing.assert_allclose(tl.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.gelu(jnp.asarray(x))), **TOL)


def test_gelu_new():
    x = (_rng(7).standard_normal((4, 257)) * 4).astype(np.float32)
    assert tl.ACTIVATIONS["gelu_new"] is tl.gelu_new and tl.ACTIVATIONS["gelu"] is tl.gelu
    np.testing.assert_allclose(tl.gelu_new(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.gelu_new(jnp.asarray(x))), **TOL)


def test_dense():
    r = _rng(1)
    x = r.standard_normal((3, 5, 16)).astype(np.float32)
    k = r.standard_normal((16, 8)).astype(np.float32)
    b = r.standard_normal(8).astype(np.float32)
    want = np.asarray(jl.dense({"kernel": jnp.asarray(k), "bias": jnp.asarray(b)},
                               jnp.asarray(x)))
    got = tl.dense(torch.from_numpy(x), torch.from_numpy(k.T.copy()),
                   torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)


def test_layer_norm():
    r = _rng(2)
    x = (r.standard_normal((2, 7, 24)) * 2 + 0.5).astype(np.float32)
    s = r.standard_normal(24).astype(np.float32)
    b = r.standard_normal(24).astype(np.float32)
    want = np.asarray(jl.layer_norm({"scale": jnp.asarray(s), "bias": jnp.asarray(b)},
                                    jnp.asarray(x), eps=1e-5))
    got = tl.layer_norm(torch.from_numpy(x), torch.from_numpy(s),
                        torch.from_numpy(b), eps=1e-5).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("stride,padding,groups", [(1, 0, 1), (2, 0, 1), (1, 8, 4)])
def test_conv1d_and_nhc(stride, padding, groups):
    r = _rng(3)
    x = (r.standard_normal((2, 40, 16)) * 0.5).astype(np.float32)       # [B,T,C]
    w = (r.standard_normal((16, 16 // groups, 16 if padding else 3)) * 0.2).astype(np.float32)
    b = r.standard_normal(16).astype(np.float32)
    want = np.asarray(jl.conv1d_nhc(jnp.asarray(x), jnp.asarray(w), stride=stride,
                                    padding=padding, groups=groups,
                                    bias=jnp.asarray(b)))
    got = tl.conv1d_nhc(torch.from_numpy(x), torch.from_numpy(w), stride=stride,
                        padding=padding, groups=groups, bias=torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-6)
    want_nch = np.asarray(jl.conv1d({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                                    jnp.asarray(x.transpose(0, 2, 1)), stride=stride,
                                    padding=padding, groups=groups))
    got_nch = tl.conv1d(torch.from_numpy(x.transpose(0, 2, 1).copy()), torch.from_numpy(w),
                        torch.from_numpy(b), stride=stride, padding=padding, groups=groups)
    np.testing.assert_allclose(got_nch.numpy(), want_nch, atol=1e-5, rtol=1e-6)


def test_weight_norm_conv1d_weight():
    r = _rng(4)
    v = r.standard_normal((24, 6, 16)).astype(np.float32)
    g = np.abs(r.standard_normal((1, 1, 16))).astype(np.float32)
    want = np.asarray(jl.weight_norm_conv1d_weight(
        {"weight_g": jnp.asarray(g), "weight_v": jnp.asarray(v)}))
    got = tl.weight_norm_conv1d_weight(torch.from_numpy(g), torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n,dim,pad", [(4004, 768, 1), (259, 24, 1), (30, 7, None)])
def test_sinusoidal_table(n, dim, pad):
    np.testing.assert_array_equal(tl.sinusoidal_table(n, dim, padding_idx=pad),
                                  jl.sinusoidal_table(n, dim, padding_idx=pad))


@pytest.mark.parametrize("n,dim", [(4000, 768), (450, 768), (64, 24)])
def test_interleaved_sinusoidal_table(n, dim):
    np.testing.assert_array_equal(tl.interleaved_sinusoidal_table(n, dim),
                                  jl.interleaved_sinusoidal_table(n, dim))


def test_positions_from_padding():
    m = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1], [1, 0, 0, 0, 0, 0]], np.int32)
    want = np.asarray(jl.positions_from_padding(jnp.asarray(m), 1))
    got = tl.positions_from_padding(torch.from_numpy(m), 1).numpy()
    np.testing.assert_array_equal(got, want)
