"""The port's Ulysses attention (``parallel/ulysses.py``) on gloo CPU ranks
against the JAX package's ``ulysses_attention`` on its virtual CPU
devices, from the same numpy-seeded q/k/v: causal and non-causal, with the
SpeechT5 relative-position table and key padding (a row with no valid key
too), over two and four ranks.  The output within 2e-5 (the JAX tests'
bound, ``tests/test_ulysses.py:40-41``) and the gradients within 1e-5 of
``jax.grad``'s, though the local attention is another form of the same
function: the port's flash dispatch (kernel B1 with the table or key
padding, B5 without, on the card; their plain versions here) where JAX
gathers a [T, T, D] relative-key tensor.  One departure is B1's: a batch
row with no valid key sends no gradient to v (ROADMAP §C), where JAX's
dense form spreads it over every key; such a row carries no label in
training.  Heads that do not divide, and a sequence that does not, raise
JAX's errors."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sp_reference as ref
from loco_asr_tpu.parallel.ulysses import ulysses_attention as julysses


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return ref.port_results(tmp_path_factory, "ulysses")


@pytest.mark.parametrize("name", sorted(ref.CASES))
def test_ulysses_attention_matches_jax(results, name):
    data, got = results
    ref.check_case(julysses, data, got, name, b1_empty_rows=True)


@pytest.mark.parametrize("name", sorted(ref.ERRORS))
def test_indivisible_heads_or_sequence_raise_jax_error(results, name):
    data, got = results
    want = ref.jax_error(julysses, data[name], ref.ERRORS[name])
    assert want.startswith({"uneven_2": "sequence length 15",
                            "three_heads_2": "num heads 3 not divisible by mesh axis 2"}[name])
    assert got[name] == {"error": want}


def test_ulysses_equals_ring_on_the_same_blocks(results, tmp_path_factory):
    """Both schemes compute exact attention: on every case Ulysses' output
    and gradients are ring's within the bounds above (dv but on rows with
    no valid key, B1's rule)."""
    data, got = results
    _, ring = ref.port_results(tmp_path_factory, "ring")
    for name in ref.CASES:
        for k in ("out", "dq", "dk", "dv", "dpe"):
            if got[name][k] is None:
                assert ring[name][k] is None
                continue
            want = ring[name][k].numpy().copy()
            if k == "dv":
                want[ref.empty_rows(data[name])] = 0.0
            np.testing.assert_allclose(got[name][k].numpy(), want,
                                       atol=2e-5, rtol=0, err_msg=f"{name} {k}")
