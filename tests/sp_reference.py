"""The JAX side of the port's sequence-parallel attention tests
(``tests/test_torch_ring_attention.py``, ``test_torch_ulysses.py``): the
cases' inputs, made with numpy from a seed, and the JAX scheme's output
and gradients on the virtual CPU devices of ``tests/conftest.py``."""

from __future__ import annotations

import os

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import torch_sp_worker as worker

# name -> (sequence ranks, causal, scale, [B, H, T, D], rel-pos table rows
# or 0, valid key counts or None)
CASES = {
    "causal_2": (2, True, None, (2, 4, 16, 8), 0, None),
    "noncausal_2": (2, False, None, (2, 4, 16, 8), 0, None),
    "rel_pad_2": (2, False, 1.0, (2, 4, 24, 8), 10, (24, 13)),
    "causal_4": (4, True, None, (2, 4, 32, 8), 0, None),
    "rel_pad_4": (4, False, 1.0, (2, 4, 32, 16), 40, (32, 5)),
    "causal_pad_4": (4, True, 0.3, (2, 4, 32, 8), 0, (17, 32)),
    "empty_row_2": (2, False, 1.0, (2, 4, 16, 8), 6, (0, 16)),
}
# cases the schemes refuse with JAX's text
ERRORS = {"uneven_2": (2, False, None, (1, 4, 15, 8), 0, None),
          "three_heads_2": (2, True, None, (1, 3, 16, 8), 0, None)}


def inputs(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for name, (_, _, _, shape, rows, vl) in {**CASES, **ERRORS}.items():
        x = {k: rng.standard_normal(shape).astype(np.float32) for k in ("q", "k", "v", "g")}
        x["pe"] = rng.standard_normal((rows, shape[-1])).astype(np.float32) if rows else None
        x["kvl"] = None if vl is None else np.asarray(vl, np.int32)
        out[name] = x
    return out


def port_results(tmp_path_factory, impl: str) -> tuple:
    """(inputs, rank 0's records) of every case under ``impl`` on four gloo
    ranks, started once."""
    out = str(tmp_path_factory.mktemp(impl))
    data = inputs()
    path = os.path.join(out, "inputs.pt")
    import torch

    torch.save(data, path)
    cases = [(name, impl, spec[0], dict(causal=spec[1], scale=spec[2]))
             for name, spec in {**CASES, **ERRORS}.items()]
    worker.spawn(out, 4, [("sp_attention", dict(inputs=path, cases=cases))])
    return data, torch.load(os.path.join(out, "sp_attention.rank0.pt"), weights_only=False)


def jax_attention(fn, x: dict, spec: tuple):
    """(output, {dq, dk, dv, dpe}) of the JAX scheme ``fn`` on the case's
    whole arrays, over its sequence ranks of the virtual devices; the
    gradients of sum(out * g)."""
    seq, causal, scale = spec[:3]
    mesh = Mesh(np.asarray(jax.devices()[:seq]), ("sequence",))
    kvl = None if x["kvl"] is None else jnp.asarray(x["kvl"])

    def loss(q, k, v, pe):
        o = fn(q, k, v, mesh=mesh, axis_name="sequence", causal=causal, scale=scale,
               kv_valid_len=kvl, rel_pe=pe)
        return jnp.sum(o * x["g"]), o

    pe = None if x["pe"] is None else jnp.asarray(x["pe"])
    argnums = (0, 1, 2, 3) if pe is not None else (0, 1, 2)
    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=argnums, has_aux=True))(
        jnp.asarray(x["q"]), jnp.asarray(x["k"]), jnp.asarray(x["v"]), pe)
    names = ("dq", "dk", "dv", "dpe")
    return np.asarray(out), {n: np.array(g) for n, g in zip(names, grads)}


def jax_error(fn, x: dict, spec: tuple) -> str:
    try:
        jax_attention(fn, x, spec)
    except ValueError as e:
        return str(e)
    raise AssertionError("the JAX scheme did not raise")


def empty_rows(x: dict) -> np.ndarray:
    """The batch rows with no valid key."""
    return np.zeros(x["q"].shape[0], bool) if x["kvl"] is None else x["kvl"] == 0


def check_case(fn, data: dict, got: dict, name: str, b1_empty_rows: bool = False) -> None:
    """The port's output within 2e-5 and its gradients within 1e-5 of
    JAX's (the JAX tests' own output bound; absolute).  ``b1_empty_rows``:
    a batch row with no valid key sends no gradient to v, kernel B1's rule
    (ROADMAP §C), where JAX's dense form spreads it over every key."""
    want, grads = jax_attention(fn, data[name], CASES[name])
    if b1_empty_rows:
        grads["dv"][empty_rows(data[name])] = 0.0
    rec = got[name]
    np.testing.assert_allclose(rec["out"].numpy(), want, atol=2e-5, rtol=0, err_msg="out")
    for k, g in grads.items():
        np.testing.assert_allclose(rec[k].numpy(), g, atol=1e-5, rtol=0, err_msg=k)
    if "dpe" not in grads:
        assert rec["dpe"] is None
