"""The port's partition rules (``loco_asr_tpu_torch.parallel.partition``)
against the JAX package's: the same spec for every parameter path of the
tiny SpeechT5 and GPT-2, ``validate_spec``'s drop / relocate / warn cases
(``tests/test_sharding.py``'s and gpt2-xl's ``wte``) with the same
results and log lines, every local shard of ``shard_params`` of the shape
JAX's ``NamedSharding(mesh, spec).shard_shape`` gives under (2, 2, 2),
``gather_params(shard_params(p)) == p`` bit for bit on 8 gloo ranks (GPT-2's
``c_attn`` included, whose tensor blocks hold their heads' q | k | v
columns; a bf16 GPT-2 too), and the per-rank bytes of parameters plus AdamW state at the
widths the chip runs (SpeechT5 with a 256 vocabulary, gpt2) against JAX's
per-device accounting (``scripts/fsdp_memory.py``'s rule)."""

import logging
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import optax
from jax.sharding import NamedSharding as JNamedSharding

import torch_dist_worker as worker

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from loco_asr_tpu.models.gpt2 import model as jg
from loco_asr_tpu.models.speecht5 import model as jm
from loco_asr_tpu.models.speecht5.config import SpeechT5Config as JConfig
from loco_asr_tpu.models.speecht5.config import tiny_config as jtiny
from loco_asr_tpu.parallel import mesh as jmesh, partition as jpart
from loco_asr_tpu.utils.pytree import flatten_with_paths
from loco_asr_tpu_torch.models.gpt2 import convert as gconvert, model as tg
from loco_asr_tpu_torch.models.speecht5 import convert as sconvert
from loco_asr_tpu_torch.models.speecht5 import model as tm
from loco_asr_tpu_torch.models.speecht5.config import SpeechT5Config, tiny_config
from loco_asr_tpu_torch.parallel import mesh as tmesh, partition as tpart

RANKS = list(range(8))


def _jax_tiny_asr():
    return jm.asr_init(jax.random.PRNGKey(0), jtiny(hidden_size=32, encoder_attention_heads=4,
                                                    decoder_attention_heads=4,
                                                    encoder_ffn_dim=64, decoder_ffn_dim=64))


def _port_models():
    cfg = tiny_config(hidden_size=32, encoder_attention_heads=4, decoder_attention_heads=4,
                      encoder_ffn_dim=64, decoder_ffn_dim=64)
    return {"asr": tm.asr_model_init(cfg, seed=0, device="cpu"),
            "gpt2": tg.gpt2_init(tg.tiny_gpt2_config(n_positions=32, n_embd=32, n_head=4),
                                 seed=0, device="cpu")}


def _jax_params(name):
    if name == "asr":
        return _jax_tiny_asr()
    return jg.gpt2_init(jax.random.PRNGKey(0), jg.tiny_gpt2_config(n_positions=32, n_embd=32,
                                                                   n_head=4))


@pytest.mark.parametrize("name", ["asr", "gpt2"])
def test_rules_give_jax_specs(name):
    flat = flatten_with_paths(_jax_params(name))
    for key in flat:
        assert tuple(tpart.spec_for(key, tpart.TRANSFORMER_RULES)) == tuple(
            jpart.spec_for(key, jpart.TRANSFORMER_RULES)), key
    specs = tpart.partition_specs({k: 0 for k in flat})
    assert tuple(specs["text_decoder_postnet"]["lm_head"]["kernel"]
                 if name == "asr" else specs["h"]["0"]["attn"]["c_attn"]["kernel"]) \
        == ("fsdp", "tensor")


# (spec, shape, mesh (data, fsdp, tensor)): test_sharding.py's cases, and more
VALIDATE = [
    (("fsdp", "tensor"), (2, 5), (2, 2, 2)),          # drop, warn REPLICATED
    (("fsdp", "tensor"), (50257, 1600), (1, 8, 1)),   # gpt2-xl wte: relocate
    (("fsdp", "tensor"), (50257, 1600), (1, 4, 2)),
    (("fsdp", "tensor"), (768, 2304), (2, 2, 2)),     # divisible: unchanged
    (("tensor", None, None), (768, 48, 128), (1, 1, 8)),
    ((None, "tensor"), (37, 6), (1, 1, 4)),           # neither dim divides: drop
    (("fsdp", "tensor", None), (8, 8), (1, 2, 2)),    # rule longer than the array
    ((("fsdp", "tensor"),), (12,), (1, 2, 2)),
    ((("fsdp", "tensor"),), (6,), (1, 2, 2)),
    (("tensor", "fsdp"), (3000, 1024), (1, 4, 2)),    # 3000 % 2 ok, warn-sized
]


@pytest.mark.parametrize("case", range(len(VALIDATE)))
def test_validate_spec_matches_jax(case, caplog):
    spec, shape, dims = VALIDATE[case]
    sizes = dict(zip(("data", "fsdp", "tensor"), dims))
    with caplog.at_level(logging.INFO):
        want = jpart.validate_spec(jax.sharding.PartitionSpec(*spec), shape, sizes, "p.kernel")
        jlog = [(r.levelno, r.getMessage()) for r in caplog.records]
        caplog.clear()
        got = tpart.validate_spec(tpart.P(*spec), shape, sizes, "p.kernel")
        tlog = [(r.levelno, r.getMessage()) for r in caplog.records]
    assert tuple(got) == tuple(want)
    assert tlog == jlog


@pytest.mark.parametrize("name", ["asr", "gpt2"])
def test_local_shards_have_jax_shard_shapes(name):
    """Rank 0 of (2, 2, 2): shard_params needs no collective to cut."""
    jm8 = jmesh.make_mesh(2, 2, 2)
    flat = {k: np.shape(v) for k, v in flatten_with_paths(_jax_params(name)).items()}
    model = _port_models()[name]
    layout = (gconvert if name == "gpt2" else sconvert).jax_names(model)
    tpart.shard_params(model, tmesh.make_mesh(2, 2, 2, devices=RANKS))
    assert {key for key, _ in layout.values()} == set(flat)
    for pname, p in model.named_parameters():
        key, transpose = layout[pname]
        spec = jpart.validate_spec(jpart.spec_for(key, jpart.TRANSFORMER_RULES), flat[key],
                                   dict(jm8.shape), key)
        want = JNamedSharding(jm8, spec).shard_shape(flat[key])
        got = tuple(p.shape)
        assert (got[::-1] if transpose else got) == tuple(want), pname


@pytest.fixture(scope="module")
def roundtrip(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("partition"))
    worker.spawn(out, 8, [("partition_roundtrip", {})])
    return [torch.load(os.path.join(out, f"partition_roundtrip.rank{r}.pt"),
                       weights_only=False) for r in RANKS]


@pytest.mark.parametrize("name", ["asr", "gpt2", "gpt2_bf16"])
def test_gather_of_shards_is_the_tree_bit_for_bit(roundtrip, name):
    for rank in RANKS:
        rec = roundtrip[rank][name]
        assert rec["gathered"].keys() == rec["whole"].keys()
        for k, v in rec["whole"].items():
            assert torch.equal(rec["gathered"][k], v), (rank, k)
    local = roundtrip[0][name]["local"]
    assert all(shape == tuple(s) for shape, s in
               zip(local.values(), roundtrip[1][name]["local"].values()))


def test_c_attn_blocks_hold_their_heads_q_k_v(roundtrip):
    """(2, 2, 2): c_attn [32, 96] is split fsdp x tensor; a rank's block is
    rows of its fsdp half and, of each of q, k, v, its tensor half's
    columns (2 of the 4 heads)."""
    for rank in RANKS:
        rec = roundtrip[rank]["gpt2"]
        assert rec["tp"] == 2
        whole = rec["whole"]["h.0.attn.c_attn.weight"]
        f, t = (rank // 2) % 2, rank % 2
        rows = whole[16 * f:16 * (f + 1)]
        want = torch.cat([rows[:, part * 32 + 16 * t: part * 32 + 16 * (t + 1)]
                          for part in range(3)], dim=1)
        assert torch.equal(rec["c_attn"], want), rank


def _jax_per_device(params, dims):
    """scripts/fsdp_memory.py's accounting for any tree: each leaf of the
    params and of optax AdamW's state over the product of its validated
    spec's axis sizes."""
    from scripts.fsdp_memory import _path_str, shard_factor

    sizes = dict(zip(("data", "fsdp", "tensor"), dims))
    opt = jax.eval_shape(optax.adamw(1e-4).init, params)
    total = 0
    for tree in (params, opt):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = _path_str(path)
            nbytes = int(np.prod(leaf.shape, dtype=np.int64)) * np.dtype(leaf.dtype).itemsize
            total += nbytes // shard_factor(key, leaf.shape, sizes, jpart.TRANSFORMER_RULES)
    return total


@pytest.mark.parametrize("dims", [(1, 2, 2), (2, 1, 2), (1, 2, 1)])
@pytest.mark.parametrize("name", ["asr", "gpt2"])
def test_state_bytes_per_rank_are_jax_per_device_figure(name, dims):
    """Parameters plus AdamW's mu and nu of one rank, from the port's
    validated specs, equal JAX's per-device bytes less the 4 of optax's
    int32 step count (the port keeps it as a Python int)."""
    if name == "asr":
        cfg = SpeechT5Config(vocab_size=256)
        abstract = jax.eval_shape(lambda r: jm.asr_init(r, JConfig(vocab_size=256)),
                                  jax.random.PRNGKey(0))
        with torch.device("meta"):
            model = tm.AsrModel(cfg)
    else:
        abstract = jax.eval_shape(lambda r: jg.gpt2_init(r, jg.PRESETS["gpt2"]),
                                  jax.random.PRNGKey(0))
        with torch.device("meta"):
            model = tg.GPT2Model(tg.PRESETS["gpt2"])
    got = 3 * tpart.local_param_bytes(model, tmesh.make_mesh(*dims, devices=RANKS))
    assert got == _jax_per_device(abstract, dims) - 4
