"""The port's GPT-2 incremental KV-cache mode and ``FusionLM`` against the
JAX ones on the same weights, on the CPU, at 1e-4 (the JAX package's
GPT-2 parity tolerance): a scalar ``cache_index``, a [B] index with one
token and with several (the conversation prime), ``attention_mask`` over
cache positions, ragged carry-over against each stream alone, and
``FusionLM.step`` / ``prime``.  Also the cache write's bounds and the
per-row write mask of the conversation batcher."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from loco_asr_tpu.decode.fusion import FusionLM as JFusionLM
from loco_asr_tpu.models.gpt2 import model as jg
from loco_asr_tpu.utils.pytree import flatten_with_paths
from loco_asr_tpu_torch.decode.fusion import FusionLM
from loco_asr_tpu_torch.models.gpt2 import convert
from loco_asr_tpu_torch.models.gpt2 import model as tg

TOL = dict(atol=1e-4, rtol=1e-4)
P = 24   # cache length


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """JAX params and the port's model on the same weights."""
    jcfg = jg.tiny_gpt2_config(vocab_size=32, n_positions=32)
    params = jg.gpt2_init(jax.random.PRNGKey(0), jcfg)
    flat = {k: np.asarray(v) for k, v in flatten_with_paths(params).items()}
    cfg = tg.GPT2Config(**jcfg.__dict__)
    model = tg.GPT2Model(cfg)
    model.load_state_dict(convert.from_jax_params(flat, cfg), strict=True)
    return jcfg, params, model.eval()


def _ids(b, t, seed):
    return np.random.default_rng(seed).integers(0, 32, (b, t)).astype(np.int32)


def _index(x):
    """The same cache index for both packages: int, or [B] arrays."""
    if isinstance(x, int):
        return x, x
    x = np.asarray(x, np.int32)
    return jnp.asarray(x), torch.as_tensor(x, dtype=torch.int64)


def _same_caches(tc, jcache, **tol):
    for i, layer in jcache.items():
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[i][name].numpy(), np.asarray(layer[name]),
                                       err_msg=f"layer {i} {name}", **tol)


def _run_both(pair, chunks, mask=None):
    """Feed ``chunks`` of (ids [B, T], cache_index) through both packages'
    ``gpt2_logits`` in cache mode; compare logits after each and the
    caches at the end."""
    jcfg, params, model = pair
    b = chunks[0][0].shape[0]
    jcache = jg.init_kv_cache(jcfg, b, P)
    tcache = tg.init_kv_cache(model, b, P)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.as_tensor(mask)
    for n, (ids, index) in enumerate(chunks):
        ji, ti = _index(index)
        want, jcache = jg.gpt2_logits(params, jcfg, jnp.asarray(ids), attention_mask=jmask,
                                      kv_caches=jcache, cache_index=ji)
        with torch.no_grad():
            got, back = tg.gpt2_logits(model, ids, attention_mask=tmask,
                                       kv_caches=tcache, cache_index=ti)
        assert back is tcache
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"chunk {n}",
                                   **TOL)
    _same_caches(tcache, jcache, **TOL)


def test_scalar_index_matches_jax(pair):
    ids = _ids(2, 9, 1)
    _run_both(pair, [(ids[:, :4], 0)] + [(ids[:, t:t + 1], t) for t in range(4, 9)])


def test_vector_index_one_token_matches_jax(pair):
    ids = _ids(3, 6, 2)
    off = np.array([0, 5, 11])
    _run_both(pair, [(ids[:, t:t + 1], off + t) for t in range(6)])


def test_vector_index_prime_matches_jax(pair):
    """A [B] zero offset with T > 1 (``ConversationContext._refresh``), then
    ragged offsets with T > 1 and single steps."""
    ids = _ids(2, 14, 3)
    _run_both(pair, [(ids[:, :5], [0, 0]), (ids[:, 5:8], [5, 2]),
                     (ids[:, 8:9], [8, 5]), (ids[:, 9:14], [9, 6])])


def test_attention_mask_over_cache_matches_jax(pair):
    mask = np.ones((2, P), np.int32)
    mask[0, 2:4] = 0
    mask[1, 0] = 0
    ids = _ids(2, 8, 4)
    _run_both(pair, [(ids[:, :5], [0, 0])] + [(ids[:, t:t + 1], [t, t]) for t in range(5, 8)],
              mask=mask)
    _run_both(pair, [(ids[:, :5], 0)] + [(ids[:, t:t + 1], t) for t in range(5, 8)], mask=mask)


def test_ragged_carryover_matches_solo_streams(pair):
    """Two streams with different history lengths batched together score
    the next utterance as each stream alone (per-row offsets keep stale pad
    KVs out of every softmax), and as the JAX package does."""
    jcfg, params, model = pair
    lm, jlm = FusionLM(model, weight=1.0), JFusionLM(params, jcfg, weight=1.0)
    utt1 = np.array([[5, 6, 7, 8, 9], [11, 12, 13, 2, 2]])   # 2 = pad steps
    lens1 = np.array([5, 3])
    utt2 = np.array([[20, 21, 22, 23], [24, 25, 26, 27]])

    cache, jcache = lm.init_cache(2, 32), jlm.init_cache(2, 32)
    for t in range(utt1.shape[1]):
        lm.step(torch.as_tensor(utt1[:, t:t + 1]), torch.full((2,), t), cache)
        _, jcache = jlm.step(jnp.asarray(utt1[:, t:t + 1]), jnp.full((2,), t, jnp.int32),
                             jcache)
    got, jgot = [], []
    for t in range(utt2.shape[1]):
        lp, cache = lm.step(torch.as_tensor(utt2[:, t:t + 1]),
                            torch.as_tensor(lens1 + t), cache)
        jlp, jcache = jlm.step(jnp.asarray(utt2[:, t:t + 1]),
                               jnp.asarray(lens1 + t, jnp.int32), jcache)
        got.append(lp.numpy())
        jgot.append(np.asarray(jlp))
    got = np.stack(got, axis=1)
    np.testing.assert_allclose(got, np.stack(jgot, axis=1), **TOL)
    for s in range(2):
        solo = lm.init_cache(1, 32)
        for t in range(int(lens1[s])):
            lm.step(torch.as_tensor(utt1[s:s + 1, t:t + 1]), torch.tensor([t]), solo)
        for t in range(utt2.shape[1]):
            lp, solo = lm.step(torch.as_tensor(utt2[s:s + 1, t:t + 1]),
                               torch.tensor([int(lens1[s]) + t]), solo)
            np.testing.assert_allclose(got[s, t], lp.numpy()[0], atol=1e-6, rtol=1e-6,
                                       err_msg=f"stream {s} step {t}")


def test_fusion_step_and_prime_match_jax(pair):
    jcfg, params, model = pair
    lm, jlm = FusionLM(model, weight=0.3), JFusionLM(params, jcfg, weight=0.3)
    ctx = _ids(2, 7, 5)
    cache, jcache = lm.init_cache(2, P), jlm.init_cache(2, P)
    cache, nxt = lm.prime(torch.as_tensor(ctx), cache, torch.zeros(2, dtype=torch.int64))
    jcache, jnxt = jlm.prime(jnp.asarray(ctx), jcache, jnp.zeros((2,), jnp.int32))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
    _same_caches(cache, jcache, **TOL)
    tok = _ids(2, 1, 6)
    lp, cache = lm.step(torch.as_tensor(tok), nxt, cache)
    jlp, jcache = jlm.step(jnp.asarray(tok), jnxt, jcache)
    assert lp.dtype == torch.float32 and lp.shape == (2, 32)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), **TOL)
    _same_caches(cache, jcache, **TOL)
    # a scalar start, as greedy_decode primes nothing and starts at 0
    c0, j0 = lm.init_cache(2, P), jlm.init_cache(2, P)
    lp0, _ = lm.step(torch.as_tensor(tok), 0, c0)
    jlp0, _ = jlm.step(jnp.asarray(tok), 0, j0)
    np.testing.assert_allclose(lp0.numpy(), np.asarray(jlp0), **TOL)


def test_cache_write_past_the_end_raises(pair):
    _, _, model = pair
    ids = _ids(2, 4, 7)
    cache = tg.init_kv_cache(model, 2, 8)
    with pytest.raises(ValueError, match="past the cache"):
        tg.gpt2_forward(model, ids, kv_caches=cache, cache_index=5)
    with pytest.raises(ValueError, match="past the cache"):
        tg.gpt2_forward(model, ids, kv_caches=cache, cache_index=torch.tensor([0, 5]))
    with pytest.raises(ValueError, match="past the cache"):
        tg.gpt2_forward(model, ids[:, :1], kv_caches=cache, cache_index=torch.tensor([8, 0]))
    with pytest.raises(ValueError, match="go together"):
        tg.gpt2_forward(model, ids, kv_caches=cache)
    # a cache longer than n_positions (32): a [B] position past it raises
    long_cache = tg.init_kv_cache(model, 2, 40)
    with pytest.raises(ValueError, match="exceed n_positions"):
        tg.gpt2_forward(model, ids[:, :1], kv_caches=long_cache,
                        cache_index=torch.tensor([32, 0]))


def test_write_mask_skips_rows(pair):
    """Rows with a False write mask keep their cache; the others match an
    unmasked step."""
    _, _, model = pair
    lm = FusionLM(model)
    ctx = torch.as_tensor(_ids(3, 4, 8))
    tok = torch.as_tensor(_ids(3, 1, 9))
    pos = torch.tensor([4, 4, 4])
    a, _ = lm.prime(ctx, lm.init_cache(3, P), torch.zeros(3, dtype=torch.int64))
    b, _ = lm.prime(ctx, lm.init_cache(3, P), torch.zeros(3, dtype=torch.int64))
    before = {i: {n: c.clone() for n, c in layer.items()} for i, layer in a.items()}
    lp_masked, _ = lm.step(tok, pos, a, write_mask=torch.tensor([True, False, True]))
    lp_full, _ = lm.step(tok, pos, b)
    np.testing.assert_allclose(lp_masked[[0, 2]].numpy(), lp_full[[0, 2]].numpy(),
                               atol=1e-6, rtol=1e-6)
    for i, layer in a.items():
        for n, c in layer.items():
            torch.testing.assert_close(c[1], before[i][n][1], rtol=0, atol=0)
            torch.testing.assert_close(c[[0, 2]], b[i][n][[0, 2]], rtol=0, atol=0)
