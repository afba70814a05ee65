"""The port's GPT-2 (loco_asr_tpu_torch.models.gpt2) against the JAX one on
the same weights, on the CPU: the weight bridges, ``gpt2_logits`` under
dense and flash attention at 1e-4 (the JAX package's own GPT-2 parity
tolerance), the chunked lm head at 1e-5, and a right-padded batch under
flash (kernel B1's route)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from loco_asr_tpu.models.gpt2 import import_torch as jimport
from loco_asr_tpu.models.gpt2 import model as jg
from loco_asr_tpu.utils.pytree import flatten_with_paths
from loco_asr_tpu_torch.models.gpt2 import convert
from loco_asr_tpu_torch.models.gpt2 import model as tg

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port_config(jcfg):
    return tg.GPT2Config(**jcfg.__dict__)


def _pair(jcfg, seed=0):
    """JAX params and the port's model on the same weights."""
    params = jg.gpt2_init(jax.random.PRNGKey(seed), jcfg)
    flat = {k: np.asarray(v) for k, v in flatten_with_paths(params).items()}
    cfg = _port_config(jcfg)
    with torch.device("meta"):
        model = tg.GPT2Model(cfg)
    model.load_state_dict(convert.from_jax_params(flat, cfg), strict=True, assign=True)
    return params, model.eval()


def _ids(b, t, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)


def test_from_jax_params_round_trip():
    jcfg = jg.tiny_gpt2_config()
    params = jg.gpt2_init(jax.random.PRNGKey(3), jcfg)
    flat = {k: np.asarray(v) for k, v in flatten_with_paths(params).items()}
    cfg = _port_config(jcfg)
    state = convert.from_jax_params(flat, cfg)
    renamed = {}
    for k in flat:
        parts = k.split(".")
        if parts[-1] in ("kernel", "scale"):
            parts[-1] = "weight"
        renamed[".".join(parts)] = k
    assert set(state) == set(renamed) == set(tg.GPT2Model(cfg).state_dict())
    for name, jkey in renamed.items():
        np.testing.assert_array_equal(state[name].numpy(), flat[jkey])


@pytest.mark.parametrize("fault", ["missing", "unexpected", "shape"])
def test_from_jax_params_rejects_mismatch(fault):
    jcfg = jg.tiny_gpt2_config()
    flat = {k: np.asarray(v) for k, v in
            flatten_with_paths(jg.gpt2_init(jax.random.PRNGKey(0), jcfg)).items()}
    if fault == "missing":
        del flat["h.1.mlp.c_fc.bias"]
    elif fault == "unexpected":
        flat["h.2.ln_1.scale"] = np.ones(16, np.float32)
    else:
        flat["wpe.weight"] = np.zeros((31, 16), np.float32)
    with pytest.raises((KeyError, ValueError)):
        convert.from_jax_params(flat, _port_config(jcfg))


# (name, JAX config, T): D=8 takes kernel B5's route, D=64 with an even
# head count kernel B6's, and the full gpt2 width with 2 layers
LOGIT_CASES = {
    "tiny_d8": (jg.tiny_gpt2_config(), 32),
    "w128_h2_d64": (jg.tiny_gpt2_config(n_embd=128, n_head=2, n_positions=64), 64),
    "gpt2_width_2_layers": (jg.GPT2Config(n_layer=2, vocab_size=256), 64),
}


@pytest.mark.parametrize("case", sorted(LOGIT_CASES))
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_gpt2_logits_match_jax(case, impl):
    jcfg, t = LOGIT_CASES[case]
    params, model = _pair(jcfg)
    ids = _ids(2, t, jcfg.vocab_size, seed=t)
    want, _ = jg.gpt2_logits(params, jcfg, jnp.asarray(ids), attn_impl=impl)
    with torch.no_grad():
        got, caches = tg.gpt2_logits(model, torch.from_numpy(ids), attn_impl=impl)
    assert caches is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("chunk", [1, 4, 7, 28, 256])
def test_score_tokens_equals_token_nll(chunk):
    jcfg = jg.tiny_gpt2_config()
    params, model = _pair(jcfg, seed=1)
    ids = _ids(3, 30, jcfg.vocab_size, seed=chunk)   # 29 targets: ragged last chunk
    with torch.no_grad():
        logits, _ = tg.gpt2_logits(model, ids)
        want = tg.token_nll(logits, ids)
        got = tg.score_tokens(model, ids, chunk=chunk)
    assert got.shape == (3, 29)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    jwant = jg.score_tokens(params, jcfg, jnp.asarray(ids), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), **TOL)


def test_padded_batch_under_flash_matches_jax_dense():
    """attention_mask under flash runs kernel B1 (causal, valid-key counts);
    on the valid prefix it equals the JAX dense path with its padding bias."""
    jcfg = jg.tiny_gpt2_config(n_embd=128, n_head=2, n_positions=48)
    params, model = _pair(jcfg, seed=2)
    ids = _ids(3, 40, jcfg.vocab_size, seed=4)
    mask = np.ones_like(ids)
    mask[1, 25:] = 0
    mask[2, 9:] = 0
    want, _ = jg.gpt2_logits(params, jcfg, jnp.asarray(ids),
                             attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        got, _ = tg.gpt2_logits(model, ids, attention_mask=mask, attn_impl="flash")
        dense, _ = tg.gpt2_logits(model, ids, attention_mask=mask)
    valid = mask.astype(bool)
    for out in (got, dense):
        np.testing.assert_allclose(out.numpy()[valid], np.asarray(want)[valid], **TOL)


def _hf_state_dict(jcfg, seed):
    """A synthetic HF GPT2LMHeadModel state dict: ``transformer.`` keys,
    Conv1D weights [in, out], mask buffers and the tied lm head."""
    rng = np.random.default_rng(seed)
    d, sd = jcfg.n_embd, {}

    def put(name, *shape):
        sd[name] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.1)

    put("transformer.wte.weight", jcfg.vocab_size, d)
    put("transformer.wpe.weight", jcfg.n_positions, d)
    for i in range(jcfg.n_layer):
        p = f"transformer.h.{i}."
        for ln in ("ln_1", "ln_2"):
            put(p + ln + ".weight", d)
            put(p + ln + ".bias", d)
        for name, n_in, n_out in (("attn.c_attn", d, 3 * d), ("attn.c_proj", d, d),
                                  ("mlp.c_fc", d, 4 * d), ("mlp.c_proj", 4 * d, d)):
            put(p + name + ".weight", n_in, n_out)
            put(p + name + ".bias", n_out)
        sd[p + "attn.bias"] = torch.tril(torch.ones(1, 1, jcfg.n_positions, jcfg.n_positions))
        sd[p + "attn.masked_bias"] = torch.tensor(-1e4)
    put("transformer.ln_f.weight", d)
    put("transformer.ln_f.bias", d)
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    return sd


def test_load_hf_gpt2_matches_jax_import():
    jcfg = jg.tiny_gpt2_config()
    sd = _hf_state_dict(jcfg, seed=5)
    params = jimport.load_hf_gpt2(sd)
    cfg = _port_config(jcfg)
    with torch.device("meta"):
        model = tg.GPT2Model(cfg)
    model.load_state_dict(convert.load_hf_gpt2(sd, cfg), strict=True, assign=True)
    ids = _ids(2, 20, jcfg.vocab_size, seed=6)
    want, _ = jg.gpt2_logits(params, jcfg, jnp.asarray(ids))
    with torch.no_grad():
        got, _ = tg.gpt2_logits(model.eval(), ids)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_refusals():
    cfg = tg.tiny_gpt2_config()
    model = tg.gpt2_init(cfg, device="cpu")
    ids = np.zeros((1, 8), np.int32)
    with pytest.raises(ValueError, match="n_positions"):
        tg.gpt2_forward(model, np.zeros((1, 33), np.int32))
    with pytest.raises(ValueError, match="attn_pdrop"):
        tg.gpt2_forward(model, ids, attn_impl="flash", deterministic=False)
    with pytest.raises(ValueError, match="go together"):
        tg.gpt2_forward(model, ids, cache_index=0)
    with pytest.raises(ValueError, match="past the cache"):
        tg.gpt2_forward(model, ids, kv_caches=tg.init_kv_cache(model, 1, 4), cache_index=0)
    # JAX: "attn_impl='ring' needs ring=(mesh, axis_name[, batch_axis]), got None"
    with pytest.raises(ValueError, match="attn_impl='ring' needs a sequence-parallel group"):
        tg.gpt2_forward(model, ids, attn_impl="ring")


def test_gpt2_init_is_seeded_and_needs_a_gpu_unless_asked_for_cpu(monkeypatch):
    cfg = tg.tiny_gpt2_config()
    a, b = (tg.gpt2_init(cfg, seed=4, device="cpu").state_dict() for _ in range(2))
    for name in a:
        torch.testing.assert_close(a[name], b[name], rtol=0, atol=0)
    assert float(a["h.0.attn.c_attn.bias"].abs().sum()) == 0.0
    assert float(a["h.0.ln_1.weight"].min()) == 1.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tg.gpt2_init(cfg)
