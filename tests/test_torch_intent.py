"""The port's intent classifier (``loco_asr_tpu_torch.models.intent``) and
``reference_adam`` against the JAX package on the CPU, on the same
weights (carried across by ``intent_from_jax_params``): pooling, logits,
loss and accuracy for the three poolings, masked and unmasked, with the
linear and the MLP head, within 1e-5 (``tests/test_intent.py``'s
tolerance); the loss's gradients; 20 optimizer steps against the JAX
optax chain within 1e-6."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from loco_asr_tpu.models import intent as jintent
from loco_asr_tpu.parallel.train import reference_adam as jreference_adam
from loco_asr_tpu.utils.pytree import flatten_with_paths
from loco_asr_tpu_torch.models import intent as tintent
from loco_asr_tpu_torch.parallel.train import reference_adam

TOL = 1e-5
D, C = 16, 7


def _flat(params) -> dict:
    return {k: np.array(v) for k, v in flatten_with_paths(params).items()}


def _pair(hidden=(), seed=0):
    params = jintent.intent_classifier_init(jax.random.PRNGKey(seed), embedding_size=D,
                                            num_classes=C, hidden_dims=hidden)
    # a larger query than the init's 0.001 scale, so attention pooling weighs frames unevenly
    params["q"] = params["q"] * 1000.0
    return params, tintent.intent_from_jax_params(_flat(params))


def _inputs(seed=1, b=4, t=9):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, D)).astype(np.float32)
    lengths = np.array([t, 5, 1, 7][:b], np.int32)
    onehot = np.eye(C, dtype=np.float32)[rng.integers(0, C, b)]
    onehot[0] = 0.5 * onehot[0] + 0.5 / C          # a soft target
    return x, lengths, onehot


@pytest.mark.parametrize("hidden", [(), (12, 10)], ids=["linear", "mlp"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("method", tintent.POOLINGS)
def test_pool_forward_loss_match_jax(method, masked, hidden):
    params, model = _pair(hidden)
    x, lengths, onehot = _inputs()
    jl = jnp.asarray(lengths) if masked else None
    tl = torch.from_numpy(lengths) if masked else None
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(
        tintent.pool(model, tx, method, tl).detach().numpy(),
        np.asarray(jintent.pool(params, jnp.asarray(x), method, jl)), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(
        tintent.intent_forward(model, tx, method=method, lengths=tl).detach().numpy(),
        np.asarray(jintent.intent_forward(params, jnp.asarray(x), method=method, lengths=jl)),
        atol=TOL, rtol=TOL)
    loss, correct = tintent.intent_loss_and_acc(model, tx, torch.from_numpy(onehot),
                                                method=method, lengths=tl)
    jloss, jcorrect = jintent.intent_loss_and_acc(params, jnp.asarray(x), jnp.asarray(onehot),
                                                  method=method, lengths=jl)
    assert float(loss.detach()) == pytest.approx(float(jloss), abs=TOL, rel=TOL)
    assert float(correct) == float(jcorrect)
    # the gradients of the loss, parameter by parameter (None where the
    # pooling does not read q: JAX's zeros)
    loss.backward()
    jgrads = _flat(jax.grad(lambda p: jintent.intent_loss_and_acc(
        p, jnp.asarray(x), jnp.asarray(onehot), method=method, lengths=jl)[0])(params))
    for name, p in model.named_parameters():
        key = name[: -len("weight")] + "kernel" if name.endswith(".weight") else name
        g = torch.zeros_like(p) if p.grad is None else p.grad
        g = g.t() if name.endswith(".weight") else g
        np.testing.assert_allclose(g.numpy(), jgrads[key], atol=TOL, rtol=TOL, err_msg=key)


def test_masked_pooling_ignores_padding():
    _, model = _pair((12,))
    x, lengths, _ = _inputs()
    garbage = x.copy()
    for i, n in enumerate(lengths):
        garbage[i, n:] = 99.0
    for method in tintent.POOLINGS:
        a = tintent.intent_forward(model, torch.from_numpy(x), method=method,
                                   lengths=torch.from_numpy(lengths))
        b = tintent.intent_forward(model, torch.from_numpy(garbage), method=method,
                                   lengths=torch.from_numpy(lengths))
        torch.testing.assert_close(a, b, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("hidden", [(), (12, 10)], ids=["linear", "mlp"])
def test_bridge_round_trip_and_init(hidden):
    params, model = _pair(hidden)
    back = tintent.intent_to_jax_params(model)
    want = _flat(params)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])
    m = tintent.intent_classifier_init(D, C, hidden, seed=3, device="cpu")
    again = tintent.intent_classifier_init(D, C, hidden, seed=3, device="cpu")
    for a, b in zip(m.state_dict().values(), again.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    flat = tintent.intent_to_jax_params(m)
    assert flat.keys() == want.keys()
    assert float(np.abs(flat["q"]).max()) < 0.01
    dims = [D, *hidden, C]
    kernels = (["classifier.kernel"] if not hidden
               else [f"classifier.{i}.kernel" for i in range(len(dims) - 1)])
    for key, n_in in zip(kernels, dims[:-1]):
        assert float(np.abs(flat[key]).max()) <= n_in ** -0.5
        assert float(np.abs(flat[key[: -len("kernel")] + "bias"]).max()) == 0.0


def test_entry_needs_a_gpu_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tintent.intent_classifier_init(D, C)


@pytest.mark.parametrize("weight_decay", [1e-4, 0.1])
def test_reference_adam_matches_jax_over_20_steps(weight_decay):
    import optax

    params, model = _pair((12,))
    tx_j = jreference_adam(1e-2, weight_decay)
    state_j = tx_j.init(params)
    tx_t = reference_adam(1e-2, weight_decay)
    named = dict(model.named_parameters())
    state_t = tx_t.init(named)
    rng = np.random.default_rng(5)
    for _ in range(20):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)), params)
        flat = _flat(grads)
        tgrads = {name: torch.from_numpy(
            flat[name[: -len("weight")] + "kernel"].T.copy() if name.endswith(".weight")
            else flat[name]) for name in named}
        updates, state_j = tx_j.update(grads, state_j, params)
        params = optax.apply_updates(params, updates)
        tx_t.update(named, tgrads, state_t)
    want = _flat(params)
    got = tintent.intent_to_jax_params(model)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-6, rtol=1e-6, err_msg=key)
