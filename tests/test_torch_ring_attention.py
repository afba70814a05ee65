"""The port's ring attention (``parallel/ring_attention.py``) on gloo CPU
ranks against the JAX package's ``ring_attention`` on its virtual CPU
devices, from the same numpy-seeded q/k/v: causal and non-causal, with the
SpeechT5 relative-position table and key padding (a row with no valid key
too), over two and four ranks.  The output within 2e-5 (the JAX tests'
bound, ``tests/test_ring_attention.py:39-40``), the gradients of
``sum(out * g)`` with respect to q, k, v and the table within 1e-5 of
``jax.grad``'s: the backward is the port's own (it re-runs the ring and
returns each block's dK/dV to its owner).  A sequence that does not divide
raises JAX's error.  Also the collectives the schemes use: the ring shift
and the all-to-all, with their adjoints."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sp_reference as ref
import torch_sp_worker as worker
from loco_asr_tpu.parallel.ring_attention import ring_attention as jring


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    data, got = ref.port_results(tmp_path_factory, "ring")
    out = str(tmp_path_factory.mktemp("collectives"))
    worker.spawn(out, 4, [("collectives", {})])
    recs = [torch.load(os.path.join(out, f"sp_collectives.rank{r}.pt"), weights_only=False)
            for r in range(4)]
    return data, got, recs


@pytest.mark.parametrize("name", sorted(ref.CASES))
def test_ring_attention_matches_jax(results, name):
    data, got, _ = results
    ref.check_case(jring, data, got, name)


def test_uneven_sequence_raises_jax_error(results):
    data, got, _ = results
    want = ref.jax_error(jring, data["uneven_2"], ref.ERRORS["uneven_2"])
    assert want == "sequence length 15 not divisible by mesh axis 2"
    assert got["uneven_2"] == {"error": want}


def test_ring_runs_with_heads_that_ulysses_cannot_split(results):
    data, got, _ = results
    spec = ref.ERRORS["three_heads_2"]
    want, grads = ref.jax_attention(jring, data["three_heads_2"], spec)
    np.testing.assert_allclose(got["three_heads_2"]["out"].numpy(), want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got["three_heads_2"]["dq"].numpy(), grads["dq"], atol=1e-5,
                               rtol=0)


def test_ring_shift_and_all_to_all_with_their_adjoints(results):
    """Rank r holds x_r = arange(24).reshape(2, 4, 3) + 100 r.  The shift
    gives x_{r-1}, and its gradient under sum(y * w_r) is w_{r+1} (the
    reverse shift); the all-to-all splitting dim 1 and concatenating dim 2
    gives [x_0, x_1, x_2, x_3]'s r-th column blocks side by side, and its
    backward is the inverse all-to-all; bf16 moves bit for bit."""
    _, _, recs = results
    n = len(recs)
    x = [torch.arange(24.0).reshape(2, 4, 3) + 100 * r for r in range(n)]
    w = [torch.arange(24.0).reshape(2, 4, 3) * (r + 1) for r in range(n)]
    for r, rec in enumerate(recs):
        assert torch.equal(rec["permute"], x[(r - 1) % n])
        assert torch.equal(rec["permute_grad"], w[(r + 1) % n])
        want = torch.cat([x[j][:, r:r + 1] for j in range(n)], dim=2)
        assert torch.equal(rec["exchange"], want)
        assert torch.equal(rec["bf16_shift"], x[(r - 2) % n].to(torch.bfloat16))
    # the adjoint: d(sum(y_r * c)) / dx_r, c = arange(numel) in y's shape
    c = torch.arange(24.0).reshape(2, 1, 12)
    for r, rec in enumerate(recs):
        want = torch.cat([c[:, :, 3 * r:3 * r + 3] for _ in range(n)], dim=1)
        assert torch.equal(rec["exchange_grad"], want)
