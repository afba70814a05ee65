"""The port's generic speech feature encoder against the JAX
``feature_encoder`` on bridged weights, at ``tiny_config``: a layer norm
after every conv with conv biases (``feat_extract_norm="layer"``) and a
group norm after a first conv other than k = 2*stride.  Encoder outputs,
``asr_loss`` and its gradients within 1e-5; the weight bridge carries the
per-layer norms and the conv biases both ways; B2's route keeps the
group / k = 2*stride case only."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from loco_asr_tpu.models.speecht5 import model as jm
from loco_asr_tpu.models.speecht5 import prenets as jpre
from loco_asr_tpu.models.speecht5.config import SpeechT5Config as JConfig
from loco_asr_tpu.utils.pytree import flatten_with_paths
from loco_asr_tpu_torch.models.speecht5 import convert
from loco_asr_tpu_torch.models.speecht5 import model as tm
from loco_asr_tpu_torch.models.speecht5 import prenets as tpre
from loco_asr_tpu_torch.models.speecht5.config import tiny_config
from loco_asr_tpu_torch.ops.cuda import conv_frontend as cf

TOL = dict(atol=1e-5, rtol=1e-5)
QUIET = dict(positional_dropout=0.0, hidden_dropout=0.0, attention_dropout=0.0,
             activation_dropout=0.0, feat_proj_dropout=0.0, apply_spec_augment=False)
FRONTENDS = {
    "layer": dict(feat_extract_norm="layer", conv_bias=True),
    "group_k7_bias": dict(conv_kernel=(7, 3), conv_stride=(4, 2), conv_bias=True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(FRONTENDS))
def pair(request):
    cfg = tiny_config(**FRONTENDS[request.param], **QUIET)
    jcfg = JConfig(**dataclasses.asdict(cfg))
    params = jm.asr_init(jax.random.PRNGKey(7), jcfg)
    # non-trivial norms and biases, so that a dropped one shows
    rng = np.random.default_rng(1)
    flat = {}
    for k, v in flatten_with_paths(params).items():
        v = np.asarray(v)
        if k.startswith("encoder.prenet.feature_encoder.") and not k.endswith(".weight"):
            v = (v + rng.standard_normal(v.shape) * 0.1).astype(np.float32)
        flat[k] = v
    params = _unflatten(flat)
    model = tm.AsrModel(cfg)
    model.load_state_dict(convert.asr_from_jax_params(flat, cfg))
    return cfg, jcfg, params, flat, model


def _unflatten(flat):
    out = {}
    for key, v in flat.items():
        node = out
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(v)
    return out


def _batch(cfg, b=3, t=2000, seed=0):
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal((b, t)) * 0.2).astype(np.float32)
    lengths = [t, t - 300, t // 2][:b]
    mask = (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    labels = rng.integers(3, cfg.vocab_size, (b, 9)).astype(np.int64)
    labels[1, 6:] = -100
    return wav, mask, labels


def test_feature_encoder_matches_jax(pair):
    cfg, jcfg, params, _, model = pair
    wav = _batch(cfg)[0]
    fe = params["encoder"]["prenet"]["feature_encoder"]
    want = np.asarray(jpre.feature_encoder(fe, jcfg, jnp.asarray(wav)))
    with torch.no_grad():
        got = model.encoder.prenet.feature_encoder(torch.from_numpy(wav))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_encode_speech_matches_jax(pair):
    cfg, jcfg, params, _, model = pair
    wav, mask, _ = _batch(cfg)
    want, want_mask = jm.encode_speech(params, jcfg, jnp.asarray(wav), jnp.asarray(mask))
    got, got_mask = tm.encode_speech(model.eval(), wav, mask)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    valid = np.asarray(want_mask).astype(bool)
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], **TOL)


def test_asr_loss_and_gradients_match_jax(pair):
    cfg, jcfg, params, _, model = pair
    wav, mask, labels = _batch(cfg, seed=2)

    def f(p):
        return jm.asr_loss(p, jcfg, jnp.asarray(wav), jnp.asarray(mask),
                           jnp.asarray(labels), deterministic=True)[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(f))(params)
    jgrads = {k: np.asarray(v) for k, v in flatten_with_paths(jgrads).items()}
    model.train()
    model.zero_grad()
    loss, _ = tm.asr_loss(model, torch.from_numpy(wav), torch.from_numpy(mask),
                          torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    names = convert.jax_names(model)
    checked = 0
    for name, p in model.named_parameters():
        key, transpose = names[name]
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        g = g.t() if transpose else g
        np.testing.assert_allclose(g.numpy(), jgrads[key], atol=1e-5, rtol=1e-4,
                                   err_msg=f"grad {key}")
        checked += key.startswith("encoder.prenet.feature_encoder.")
    assert checked == len([k for k in jgrads if k.startswith("encoder.prenet.feature_encoder.")])


def test_bridge_carries_norms_and_biases_both_ways(pair):
    cfg, _, _, flat, model = pair
    back = convert.asr_to_jax_params(model)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    fe = [k for k in flat if k.startswith("encoder.prenet.feature_encoder.")]
    norms = [k for k in fe if ".layer_norm." in k]
    biases = [k for k in fe if k.endswith(".conv.bias")]
    n = len(cfg.conv_dim)
    assert len(norms) == 2 * (n if cfg.feat_extract_norm == "layer" else 1)
    assert len(biases) == (n if cfg.conv_bias else 0)
    enc = tm.SpeechEncoder(cfg)
    enc.load_state_dict(convert.from_jax_params(flat, cfg))
    enc_back = convert.encoder_to_jax_params(enc)
    for k in fe:
        np.testing.assert_array_equal(enc_back[k], flat[k], err_msg=k)


def test_generic_route_launches_no_b2_and_fused_route_keeps_it(pair, monkeypatch):
    cfg, _, _, _, model = pair
    taken = []
    for name in ("conv1_instance_norm_gelu", "conv1_instance_norm_gelu_plain"):
        real = getattr(cf, name)
        monkeypatch.setattr(cf, name, lambda *a, _f=real, _n=name, **k:
                            (taken.append(_n), _f(*a, **k))[1])
    wav = torch.zeros(1, 1600)
    with torch.no_grad():
        model.encoder.prenet.feature_encoder(wav)
    assert not tpre.fused_frontend(cfg) and taken == []
    fused = tm.SpeechEncoder(tiny_config(conv_bias=True))
    assert tpre.fused_frontend(fused.cfg)
    with torch.no_grad():
        fused.prenet.feature_encoder(wav)
    assert taken[:1] == ["conv1_instance_norm_gelu"]


def test_unknown_norm_raises():
    with pytest.raises(ValueError, match="feat_extract_norm"):
        tm.SpeechEncoder(tiny_config(feat_extract_norm="batch"))
