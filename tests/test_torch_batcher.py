"""The port's continuous batcher (loco_asr_tpu_torch.decode.batcher) on the
CPU: ``decode_continuous`` and ``decode_continuous_beam`` (with its
``early_stop_lp``), with and without GPT-2 fusion, give each utterance the
tokens of the port's own static ``greedy_decode`` / ``beam_search`` of
that utterance alone, and the JAX batcher's tokens on the same weights;
``decode_conversations`` (greedy and beam, through rolling refreshes and
more conversations than slots) gives each conversation the tokens of
``ConversationContext`` run sequentially, and the JAX batcher's."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from loco_asr_tpu.decode import batcher as jbatcher
from loco_asr_tpu.decode.fusion import FusionLM as JFusionLM
from loco_asr_tpu.models.gpt2 import model as jg
from loco_asr_tpu.models.speecht5 import model as jm
from loco_asr_tpu.models.speecht5.config import SpeechT5Config as JConfig
from loco_asr_tpu.utils.pytree import flatten_with_paths, unflatten_from_paths
from loco_asr_tpu_torch.decode import batcher
from loco_asr_tpu_torch.decode import beam as tbeam
from loco_asr_tpu_torch.decode.context import ConversationContext, beam_decode_with_context
from loco_asr_tpu_torch.decode.fusion import FusionLM
from loco_asr_tpu_torch.models.gpt2 import convert as gconvert
from loco_asr_tpu_torch.models.gpt2 import model as tg
from loco_asr_tpu_torch.models.speecht5 import convert
from loco_asr_tpu_torch.models.speecht5 import model as tm
from loco_asr_tpu_torch.models.speecht5.config import tiny_config

BUCKET = 3200
EOS_BIAS = 0.35   # some utterances end early, so slots retire at different steps


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config(apply_spec_augment=False, mask_time_prob=0.0)
    jcfg = JConfig(**dataclasses.asdict(cfg))
    flat = {k: np.array(v) for k, v in
            flatten_with_paths(jm.asr_init(jax.random.PRNGKey(0), jcfg)).items()}
    u = np.random.default_rng(1).standard_normal(cfg.hidden_size).astype(np.float32)
    flat[f"decoder.wrapped_decoder.layers.{cfg.decoder_layers - 1}.final_layer_norm.bias"] = u
    flat["text_decoder_postnet.lm_head.kernel"][:, cfg.eos_token_id] += \
        EOS_BIAS * u / np.linalg.norm(u)
    model = tm.AsrModel(cfg)
    model.load_state_dict(convert.asr_from_jax_params(flat, cfg), strict=True)
    jparams = unflatten_from_paths({k: jnp.asarray(v) for k, v in flat.items()})

    lm_jcfg = jg.tiny_gpt2_config(vocab_size=cfg.vocab_size, n_positions=64)
    lm_params = jg.gpt2_init(jax.random.PRNGKey(7), lm_jcfg)
    lm_cfg = tg.GPT2Config(**lm_jcfg.__dict__)
    lm_model = tg.GPT2Model(lm_cfg)
    lm_model.load_state_dict(gconvert.from_jax_params(
        {k: np.asarray(v) for k, v in flatten_with_paths(lm_params).items()}, lm_cfg))
    rng = np.random.default_rng(0)
    utts = [(f"utt{i}", (rng.standard_normal(n) * 0.1).astype(np.float32))
            for i, n in enumerate([3200, 2400, 3200, 1600, 2800, 3200])]
    return dict(cfg=cfg, jcfg=jcfg, model=model.eval(), jparams=jparams,
                lm=FusionLM(lm_model.eval(), weight=0.4),
                jlm=JFusionLM(lm_params, lm_jcfg, weight=0.4), utts=utts)


def _encode(model, wav):
    """One utterance padded to the bucket, as the batcher encodes it."""
    w = np.zeros((1, BUCKET), np.float32)
    w[0, :len(wav)] = wav
    m = np.zeros((1, BUCKET), np.int32)
    m[0, :len(wav)] = 1
    return tm.encode_speech(model, w, m)


def _check(results, jresults, reference, what):
    """Port results equal the port's reference and the JAX batcher's."""
    assert results.keys() == jresults.keys() == reference.keys()
    for key, (toks, length) in results.items():
        ref_toks, ref_len = reference[key]
        assert length == ref_len, f"{what} {key}: length {length} != {ref_len}"
        np.testing.assert_array_equal(toks, ref_toks, err_msg=f"{what} {key} vs static")
        np.testing.assert_array_equal(toks, np.asarray(jresults[key][0]),
                                      err_msg=f"{what} {key} vs JAX")
        assert length == int(jresults[key][1])


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fusion"])
def test_continuous_greedy_matches_static_and_jax(setup, fused):
    model, utts = setup["model"], setup["utts"]
    lm, jlm = (setup["lm"], setup["jlm"]) if fused else (None, None)
    results = batcher.decode_continuous(model, utts, slots=2, chunk_steps=4, max_len=10,
                                        audio_samples=BUCKET, fusion=lm)
    reference = {}
    for uid, wav in utts:
        enc, mask = _encode(model, wav)
        toks, lens = tbeam.greedy_decode(model, enc, mask, max_len=10, fusion=lm)
        reference[uid] = (toks[0].numpy(), int(lens[0]))
    assert len({length for _, length in reference.values()}) > 1, reference
    jresults = jbatcher.decode_continuous(setup["jparams"], setup["jcfg"], utts, slots=2,
                                          chunk_steps=4, max_len=10, audio_samples=BUCKET,
                                          fusion=jlm)
    _check(results, jresults, reference, "greedy")


@pytest.mark.parametrize("fused,k", [(False, 3), (True, 2)], ids=["plain", "fusion"])
def test_continuous_beam_matches_static_and_jax(setup, fused, k):
    """``length_penalty`` drives the batcher's early stop; the static search
    runs without it."""
    model, utts = setup["model"], setup["utts"]
    lm, jlm = (setup["lm"], setup["jlm"]) if fused else (None, None)
    kw = dict(slots=2, beam_size=k, chunk_steps=3, max_len=9, length_penalty=1.0,
              audio_samples=BUCKET)
    results = batcher.decode_continuous_beam(model, utts, fusion=lm, **kw)
    reference = {}
    for uid, wav in utts:
        enc, mask = _encode(model, wav)
        hyp = tbeam.beam_search(model, enc, mask, beam_size=k, max_len=9, fusion=lm)
        reference[uid] = (hyp.tokens[0, 0].numpy(), int(hyp.lengths[0, 0]))
    jresults = jbatcher.decode_continuous_beam(setup["jparams"], setup["jcfg"], utts,
                                               fusion=jlm, **kw)
    _check(results, jresults, reference, f"beam {k}")


def _conversations(setup):
    wavs = [w for _, w in setup["utts"]]
    return [("convA", wavs + wavs[::-1]), ("convB", wavs[3:]), ("convC", wavs[1:3]),
            ("empty", [])]


def _sequential(setup, wavs, beam_size, **kw):
    ctx = ConversationContext(setup["lm"], batch=1, **kw)
    out = []
    for wav in wavs:
        enc, mask = _encode(setup["model"], wav)
        if beam_size == 1:
            cache, start = ctx.state()
            toks, lens, cache = tbeam.greedy_decode(setup["model"], enc, mask, max_len=8,
                                                    fusion=ctx.lm, lm_cache=cache,
                                                    lm_start=start, return_lm_cache=True)
            ctx.append(toks, lens, cache)
            out.append((toks[0].numpy(), int(lens[0])))
        else:
            hyp = beam_decode_with_context(setup["model"], enc, mask, ctx,
                                           beam_size=beam_size, max_len=8)
            out.append((hyp.tokens[0, 0].numpy(), int(hyp.lengths[0, 0])))
    return out


@pytest.mark.parametrize("beam_size", [1, 2])
def test_conversations_match_sequential_and_jax(setup, beam_size):
    """Three conversations over two slots, a 16-position window with a
    9-position reserve (rolling refreshes within the long conversation)."""
    convs = _conversations(setup)
    kw = dict(max_positions=16, decode_reserve=9)
    opts = dict(slots=2, chunk_steps=3, max_len=8, beam_size=beam_size,
                audio_samples=BUCKET, **kw)
    results = batcher.decode_conversations(setup["model"], convs, fusion=setup["lm"],
                                           **opts)
    jresults = jbatcher.decode_conversations(setup["jparams"], setup["jcfg"], convs,
                                             fusion=setup["jlm"], **opts)
    assert results.keys() == jresults.keys() == {c for c, _ in convs}
    assert results["empty"] == [] == jresults["empty"]
    for cid, wavs in convs:
        ref = _sequential(setup, wavs, beam_size, **kw)
        assert len(results[cid]) == len(wavs) == len(jresults[cid])
        for u, ((toks, length), (rt, rl), (jt, jl)) in enumerate(
                zip(results[cid], ref, jresults[cid])):
            assert length == rl == int(jl), f"{cid} utterance {u}"
            np.testing.assert_array_equal(toks, rt, err_msg=f"{cid} {u} vs sequential")
            np.testing.assert_array_equal(toks, np.asarray(jt), err_msg=f"{cid} {u} vs JAX")
    # the window rolled: the long conversation's history passed 16 - 9
    assert sum(length for _, length in results["convA"]) > 7, results["convA"]


def test_conversations_refuse_what_does_not_fit(setup):
    convs = _conversations(setup)
    with pytest.raises(ValueError, match="fusion LM"):
        batcher.decode_conversations(setup["model"], convs, fusion=None)
    with pytest.raises(ValueError, match="decode_reserve"):
        batcher.decode_conversations(setup["model"], convs, fusion=setup["lm"], max_len=8,
                                     decode_reserve=8)
    with pytest.raises(ValueError, match="does not fit"):
        batcher.decode_conversations(setup["model"], convs, fusion=setup["lm"], max_len=70,
                                     decode_reserve=71)
    with pytest.raises(ValueError, match="bucket"):
        batcher.decode_continuous(setup["model"], setup["utts"], audio_samples=100)
    assert batcher.decode_conversations(setup["model"], [("e", [])],
                                        fusion=setup["lm"]) == {"e": []}
    assert batcher.decode_continuous(setup["model"], []) == {}


def test_admission_bucket_is_a_capped_power_of_two():
    assert [batcher._admission_bucket(n, 8) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 8]
