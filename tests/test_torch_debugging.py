"""``loco_asr_tpu_torch.utils.debugging`` against the JAX package's
``utils/debugging.py``: ``nan_checks`` raises at the first op whose output
holds a NaN, naming it, in the forward and in the backward, as
``jax_debug_nans`` raises in JAX; ``assert_all_finite`` and
``check_deterministic`` answer as JAX's on the same trees and functions."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from loco_asr_tpu.utils import debugging as jdebug
from loco_asr_tpu_torch.utils import debugging as tdebug


def test_nan_checks_raise_at_the_op_in_the_forward():
    x = torch.tensor([1.0, 0.0])
    with pytest.raises(FloatingPointError, match="aten.div"):
        with tdebug.nan_checks():
            y = x * 2
            _ = y / x.clone() * 0 + (y - y) / (x - x)
    with pytest.raises(FloatingPointError):
        with jdebug.nan_checks():
            jnp.asarray([0.0]) / jnp.asarray([0.0])


def test_nan_checks_raise_in_the_backward():
    a = torch.tensor([0.0, 4.0], requires_grad=True)
    loss = (torch.sqrt(a) * torch.tensor([0.0, 1.0])).sum()   # finite; d sqrt at 0 is 0 / 0
    with pytest.raises(FloatingPointError, match="NaN in the output of aten.div"):
        with tdebug.nan_checks():
            loss.backward()


def test_nan_checks_off_and_finite_pass():
    x = torch.tensor([0.0])
    with tdebug.nan_checks(False):
        assert torch.isnan(x / x).all()
    with tdebug.nan_checks():
        assert torch.isinf(torch.tensor([1.0]) / x).all()       # infinities pass, as in JAX


@pytest.mark.parametrize("bad", [None, np.nan, np.inf])
def test_assert_all_finite_answers_as_jax(bad):
    tree = {"a": np.ones((2, 2), np.float32), "b": [np.arange(3), np.zeros(2, np.float32)]}
    if bad is not None:
        tree["b"][1][1] = bad
    ttree = {"a": torch.from_numpy(tree["a"]), "b": [torch.from_numpy(tree["b"][0]),
                                                     torch.from_numpy(tree["b"][1]).bfloat16()]}
    for check, t in ((jdebug.assert_all_finite, tree), (tdebug.assert_all_finite, tree),
                     (tdebug.assert_all_finite, ttree)):
        if bad is None:
            check(t, "params")
        else:
            with pytest.raises(FloatingPointError, match="params: non-finite values in leaf 2"):
                check(t, "params")


def test_check_deterministic_answers_as_jax():
    gen = torch.Generator().manual_seed(0)
    assert tdebug.check_deterministic(lambda: torch.randn(4, generator=torch.Generator()
                                                          .manual_seed(1)), runs=3)
    assert not tdebug.check_deterministic(lambda: {"x": torch.randn(4, generator=gen)})
    assert jdebug.check_deterministic(lambda: jax.random.normal(jax.random.PRNGKey(1), (4,)))
    counter = iter(range(10))
    assert not jdebug.check_deterministic(lambda: jnp.asarray(float(next(counter))))
