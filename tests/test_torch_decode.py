"""The port's decoding (loco_asr_tpu_torch.decode) against the JAX package's
on the same weights and encoder output, on the CPU: ``greedy_decode`` with
and without GPT-2 fusion and with a carried LM cache (tokens equal, the
returned LM cache within 1e-5 below each row's ``start + length``);
``beam_search`` at K = 1, 3, 5 with and without fusion (tokens and lengths
equal, scores and normalized scores within 1e-4); its early stop against
the full-length loop; ``ConversationContext`` over ragged streams through
two or more refreshes and ``beam_decode_with_context``; and
``decode_utterance_batch``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from loco_asr_tpu.decode import beam as jbeam
from loco_asr_tpu.decode import context as jcontext
from loco_asr_tpu.decode.fusion import FusionLM as JFusionLM
from loco_asr_tpu.models.gpt2 import model as jg
from loco_asr_tpu.models.speecht5 import model as jm
from loco_asr_tpu.models.speecht5.config import SpeechT5Config as JConfig
from loco_asr_tpu.utils.pytree import flatten_with_paths, unflatten_from_paths
from loco_asr_tpu_torch.decode import beam as tbeam
from loco_asr_tpu_torch.decode import context as tcontext
from loco_asr_tpu_torch.decode.fusion import FusionLM
from loco_asr_tpu_torch.models.gpt2 import convert as gconvert
from loco_asr_tpu_torch.models.gpt2 import model as tg
from loco_asr_tpu_torch.models.speecht5 import convert
from loco_asr_tpu_torch.models.speecht5 import model as tm
from loco_asr_tpu_torch.models.speecht5.config import tiny_config

SCORE_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)
EOS_BIAS = 0.4   # pulls the decoder toward EOS, so that searches finish early


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _asr_pair(flat, cfg):
    model = tm.AsrModel(cfg)
    model.load_state_dict(convert.asr_from_jax_params(flat, cfg), strict=True)
    return _jax_params(flat), model.eval()


def _jax_params(flat):
    return unflatten_from_paths({k: jnp.asarray(v) for k, v in flat.items()})


@pytest.fixture(scope="module")
def asr():
    """Both packages' tiny ASR model on the same weights (plain and with an
    EOS bias), the JAX encoder output of 3 rows (one padded), and a tiny
    GPT-2 of the ASR vocabulary on the same weights."""
    cfg = tiny_config(apply_spec_augment=False, mask_time_prob=0.0)
    jcfg = JConfig(**dataclasses.asdict(cfg))
    flat = {k: np.asarray(v) for k, v in
            flatten_with_paths(jm.asr_init(jax.random.PRNGKey(0), jcfg)).items()}
    eos_flat = dict(flat)
    u = np.random.default_rng(1).standard_normal(cfg.hidden_size).astype(np.float32)
    last = f"decoder.wrapped_decoder.layers.{cfg.decoder_layers - 1}.final_layer_norm.bias"
    eos_flat[last] = u
    head = flat["text_decoder_postnet.lm_head.kernel"].copy()
    head[:, cfg.eos_token_id] += EOS_BIAS * u / np.linalg.norm(u)
    eos_flat["text_decoder_postnet.lm_head.kernel"] = head

    rng = np.random.default_rng(0)
    wav = (rng.standard_normal((3, 1600)) * 0.1).astype(np.float32)
    mask = np.ones((3, 1600), np.int32)
    mask[2, 1000:] = 0
    jparams, model = _asr_pair(flat, cfg)
    enc, enc_mask = jm.encode_speech(jparams, jcfg, jnp.asarray(wav), jnp.asarray(mask))

    lm_jcfg = jg.tiny_gpt2_config(vocab_size=cfg.vocab_size, n_positions=64)
    lm_params = jg.gpt2_init(jax.random.PRNGKey(1), lm_jcfg)
    lm_flat = {k: np.asarray(v) for k, v in flatten_with_paths(lm_params).items()}
    lm_cfg = tg.GPT2Config(**lm_jcfg.__dict__)
    lm_model = tg.GPT2Model(lm_cfg)
    lm_model.load_state_dict(gconvert.from_jax_params(lm_flat, lm_cfg), strict=True)
    return dict(cfg=cfg, jcfg=jcfg, flat=flat, eos_flat=eos_flat, jparams=jparams,
                model=model, enc=np.asarray(enc), enc_mask=np.asarray(enc_mask),
                wav=wav, mask=mask, lm_jcfg=lm_jcfg, lm_params=lm_params,
                lm_model=lm_model.eval())


def _fusions(asr, weight=0.5):
    return (FusionLM(asr["lm_model"], weight=weight),
            JFusionLM(asr["lm_params"], asr["lm_jcfg"], weight=weight))


def _inputs(asr):
    return ((torch.tensor(asr["enc"]), torch.tensor(asr["enc_mask"])),
            (jnp.asarray(asr["enc"]), jnp.asarray(asr["enc_mask"])))


def _same_tokens(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    if not np.array_equal(got, want):
        first = np.argwhere(got != want)[0].tolist()
        raise AssertionError(f"{what}: tokens differ first at {first}; port "
                             f"{got.tolist()} JAX {want.tolist()}")


def _cache_rows_below(cache, jcache, limit):
    """Each row's cache positions below ``limit[row]`` agree at 1e-5."""
    for i, layer in jcache.items():
        for name in ("k", "v"):
            a, b = cache[i][name].numpy(), np.asarray(layer[name])
            for r, n in enumerate(limit):
                np.testing.assert_allclose(a[r, :, :n], b[r, :, :n],
                                           err_msg=f"layer {i} {name} row {r}", **CACHE_TOL)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fusion"])
def test_greedy_matches_jax(asr, fused):
    (enc, mask), (jenc, jmask) = _inputs(asr)
    lm, jlm = _fusions(asr) if fused else (None, None)
    toks, lens = tbeam.greedy_decode(asr["model"], enc, mask, max_len=12, fusion=lm)
    jtoks, jlens = jbeam.greedy_decode(asr["jparams"], asr["jcfg"], jenc, jmask,
                                       max_len=12, fusion=jlm)
    _same_tokens(toks, jtoks, "greedy")
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))


def test_greedy_carried_lm_cache_matches_jax(asr):
    """A ragged primed history ([B] offsets), the decode writing the cache
    it is given, and the cache handed back."""
    (enc, mask), (jenc, jmask) = _inputs(asr)
    lm, jlm = _fusions(asr)
    hist = np.random.default_rng(2).integers(3, 37, (3, 6))
    start = np.array([6, 2, 4])
    cache, _ = lm.prime(torch.as_tensor(hist), lm.init_cache(3, 40),
                        torch.zeros(3, dtype=torch.int64))
    jcache, _ = jlm.prime(jnp.asarray(hist), jlm.init_cache(3, 40), jnp.zeros((3,), jnp.int32))
    toks, lens, cache = tbeam.greedy_decode(
        asr["model"], enc, mask, max_len=12, fusion=lm, lm_cache=cache,
        lm_start=torch.as_tensor(start), return_lm_cache=True)
    jtoks, jlens, jcache = jbeam.greedy_decode(
        asr["jparams"], asr["jcfg"], jenc, jmask, max_len=12, fusion=jlm, lm_cache=jcache,
        lm_start=jnp.asarray(start, jnp.int32), return_lm_cache=True)
    _same_tokens(toks, jtoks, "carried greedy")
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    _cache_rows_below(cache, jcache, start + lens.numpy())


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fusion"])
def test_beam_search_matches_jax(asr, k, fused):
    (enc, mask), (jenc, jmask) = _inputs(asr)
    lm, jlm = _fusions(asr) if fused else (None, None)
    hyp = tbeam.beam_search(asr["model"], enc, mask, beam_size=k, max_len=10, fusion=lm)
    jhyp = jbeam.beam_search(asr["jparams"], asr["jcfg"], jenc, jmask, beam_size=k,
                             max_len=10, fusion=jlm)
    _same_tokens(hyp.tokens, jhyp.tokens, f"beam {k}")
    np.testing.assert_array_equal(hyp.lengths.numpy(), np.asarray(jhyp.lengths))
    np.testing.assert_allclose(hyp.scores.numpy(), np.asarray(jhyp.scores), **SCORE_TOL)
    np.testing.assert_allclose(hyp.normalized.numpy(), np.asarray(jhyp.normalized),
                               **SCORE_TOL)


def test_beam_one_equals_greedy(asr):
    (enc, mask), _ = _inputs(asr)
    lm, _ = _fusions(asr)
    for fusion in (None, lm):
        # tokens only, as the JAX test holds them: greedy's length is the
        # non-pad count, which a random model's emitted pad id shortens
        toks, _ = tbeam.greedy_decode(asr["model"], enc, mask, max_len=12, fusion=fusion)
        hyp = tbeam.beam_search(asr["model"], enc, mask, beam_size=1, max_len=12,
                                fusion=fusion)
        np.testing.assert_array_equal(hyp.tokens[:, 0].numpy(), toks.numpy())


def test_beam_early_stop_matches_full_loop(asr, monkeypatch):
    """With every beam finished early, the loop that stops at the first
    all-finished check gives the full-length loop's hypotheses, scores and
    lengths, and its LM cache rows below each row's start + length; the
    full-length loop matches JAX's."""
    _, eos_model = _asr_pair(asr["eos_flat"], asr["cfg"])
    enc, mask = tm.encode_speech(eos_model, asr["wav"], asr["mask"], use_kernels=False)
    lm, _ = _fusions(asr, weight=0.3)   # at 0.5 one beam runs to max_len
    k, max_len = 3, 24
    start = torch.tensor([3, 0, 5])
    hist = torch.as_tensor(np.random.default_rng(3).integers(3, 37, (3, 5)))
    runs = {}
    for every in (tbeam.CHECK_EVERY, max_len + 1):
        monkeypatch.setattr(tbeam, "CHECK_EVERY", every)
        steps = []
        step_fn = tm.asr_decode_step
        monkeypatch.setattr(tbeam.st5, "asr_decode_step",
                            lambda *a, **kw: steps.append(1) or step_fn(*a, **kw))
        primed, _ = lm.prime(hist, lm.init_cache(3, 40), torch.zeros(3, dtype=torch.int64))
        runs[every] = tbeam.beam_search(eos_model, enc, mask, beam_size=k, max_len=max_len,
                                        fusion=lm, lm_cache=tbeam.tile_rows(primed, k),
                                        lm_start=start, return_lm_cache=True) + (len(steps),)
        monkeypatch.undo()
    (early, early_cache, n_early), (full, full_cache, n_full) = runs.values()
    assert n_full == max_len and n_early < max_len, (n_early, n_full)
    for name in ("tokens", "scores", "lengths", "normalized"):
        torch.testing.assert_close(getattr(early, name), getattr(full, name), rtol=0, atol=0)
    limit = (start.repeat_interleave(k) + full.lengths.reshape(-1)).tolist()
    for i, layer in full_cache.items():
        for name, c in layer.items():
            for r, n in enumerate(limit):
                torch.testing.assert_close(early_cache[i][name][r, :, :n], c[r, :, :n],
                                           rtol=0, atol=0)
    # and the full-length loop is JAX's
    jparams = _jax_params(asr["eos_flat"])
    _, jlm = _fusions(asr, weight=0.3)
    jprimed, _ = jlm.prime(jnp.asarray(hist.numpy()), jlm.init_cache(3, 40),
                           jnp.zeros((3,), jnp.int32))
    jhyp, jcache = jbeam.beam_search(
        jparams, asr["jcfg"], jnp.asarray(enc.numpy()), jnp.asarray(mask.numpy()),
        beam_size=k, max_len=max_len, fusion=jlm,
        lm_cache=jax.tree_util.tree_map(lambda c: jnp.repeat(c, k, axis=0), jprimed),
        lm_start=jnp.asarray(start.numpy(), jnp.int32), return_lm_cache=True)
    _same_tokens(full.tokens, jhyp.tokens, "eos-biased beam")
    np.testing.assert_allclose(full.scores.numpy(), np.asarray(jhyp.scores), **SCORE_TOL)
    _cache_rows_below(early_cache, jcache, limit)


def _contexts(asr, **kw):
    lm, jlm = _fusions(asr, weight=0.7)
    return (tcontext.ConversationContext(lm, batch=2, **kw),
            jcontext.ConversationContext(jlm, batch=2, **kw))


def _utterances(asr, n, seed):
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal((n, 2, 1200)) * 0.1).astype(np.float32)
    out = []
    for w in wav:
        enc, mask = jm.encode_speech(asr["jparams"], asr["jcfg"], jnp.asarray(w))
        out.append((np.array(enc), mask))
    return out


def test_conversation_context_matches_jax(asr, monkeypatch):
    """Two ragged streams through enough utterances for at least two
    refreshes of a 48-position window."""
    _, eos_model = _asr_pair(asr["eos_flat"], asr["cfg"])
    jeos = _jax_params(asr["eos_flat"])
    ctx, jctx = _contexts(asr, max_positions=48, decode_reserve=13)
    refreshes = []
    refresh = ctx._refresh
    monkeypatch.setattr(ctx, "_refresh", lambda: refreshes.append(1) or refresh())
    for u, (enc, _) in enumerate(_utterances(asr, 8, 4)):
        # the EOS-prone model on even utterances makes the streams ragged
        cache, start = ctx.state()
        jcache, jstart = jctx.state()
        toks, lens, cache = tbeam.greedy_decode(
            asr["model"] if u % 2 else eos_model, torch.as_tensor(enc), None, max_len=12,
            fusion=ctx.lm, lm_cache=cache, lm_start=start, return_lm_cache=True)
        jtoks, jlens, jcache = jbeam.greedy_decode(
            asr["jparams"] if u % 2 else jeos, asr["jcfg"], jnp.asarray(enc), None,
            max_len=12, fusion=jctx.lm, lm_cache=jcache, lm_start=jstart,
            return_lm_cache=True)
        _same_tokens(toks, jtoks, f"utterance {u}")
        ctx.append(toks, lens, cache)
        jctx.append(jtoks, jlens, jcache)
        np.testing.assert_array_equal(ctx.state()[1].numpy(), np.asarray(jctx.state()[1]))
        _cache_rows_below(ctx.state()[0], jctx.state()[0], ctx.state()[1].tolist())
    assert len(refreshes) >= 2, refreshes


def test_beam_decode_with_context_matches_jax(asr, monkeypatch):
    ctx, jctx = _contexts(asr, max_positions=48, decode_reserve=13)
    refreshes = []
    refresh = ctx._refresh
    monkeypatch.setattr(ctx, "_refresh", lambda: refreshes.append(1) or refresh())
    for u, (enc, _) in enumerate(_utterances(asr, 6, 5)):
        hyp = tcontext.beam_decode_with_context(asr["model"], torch.as_tensor(enc), None,
                                                ctx, beam_size=3, max_len=10)
        jhyp = jcontext.beam_decode_with_context(asr["jparams"], asr["jcfg"],
                                                 jnp.asarray(enc), None, jctx, beam_size=3,
                                                 max_len=10)
        _same_tokens(hyp.tokens, jhyp.tokens, f"utterance {u}")
        np.testing.assert_allclose(hyp.scores.numpy(), np.asarray(jhyp.scores), **SCORE_TOL)
        np.testing.assert_array_equal(ctx.state()[1].numpy(), np.asarray(jctx.state()[1]))
        _cache_rows_below(ctx.state()[0], jctx.state()[0], ctx.state()[1].tolist())
    assert refreshes, "no refresh in six utterances"


@pytest.mark.parametrize("k", [1, 3])
def test_decode_utterance_batch_matches_jax(asr, k):
    toks, lens = tbeam.decode_utterance_batch(asr["model"], asr["wav"], asr["mask"],
                                              beam_size=k, max_len=8)
    jtoks, jlens = jbeam.decode_utterance_batch(asr["jparams"], asr["jcfg"],
                                                jnp.asarray(asr["wav"]),
                                                jnp.asarray(asr["mask"]), beam_size=k,
                                                max_len=8)
    _same_tokens(toks, jtoks, f"decode_utterance_batch k={k}")
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))


def test_top_k_puts_the_lower_index_first():
    x = torch.tensor([[0.0, -1e9, 0.0, 3.0, -1e9, 3.0]])
    vals, idx = tbeam.top_k_lower_first(x, 4)
    jvals, jidx = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("k", [1, 3], ids=["greedy", "beam"])
def test_decode_refuses_lm_without_room(asr, k):
    """A carried LM cache (or the LM's n_positions) without room for
    max_len more positions from a row's offset is refused before the loop,
    not left to a per-step write that the GPU does not read back."""
    (enc, mask), _ = _inputs(asr)
    lm, _ = _fusions(asr)
    max_len = 8

    def decode(cache_len, start):
        cache = lm.init_cache(3 * k, cache_len)
        if k == 1:
            return tbeam.greedy_decode(asr["model"], enc, mask, max_len=max_len, fusion=lm,
                                       lm_cache=cache, lm_start=start)
        return tbeam.beam_search(asr["model"], enc, mask, beam_size=k, max_len=max_len,
                                 fusion=lm, lm_cache=cache, lm_start=start)

    with pytest.raises(ValueError, match="runs past the LM"):
        decode(20, torch.tensor([0, 13, 2]))            # 13 + 8 > cache length 20
    with pytest.raises(ValueError, match="runs past the LM"):
        decode(80, torch.tensor([0, 60, 2]))            # 60 + 8 > n_positions 64
    decode(20, torch.tensor([0, 12, 2]))                # 12 + 8 fits
