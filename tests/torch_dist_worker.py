"""Rank-side code of the port's multi-rank CPU tests.

The tests (``tests/test_torch_mesh.py``, ``test_torch_partition.py``,
``test_torch_sharded_train.py``, ``test_torch_data_parallel.py``) start
gloo ranks on the CPU through ``loco_asr_tpu_torch.parallel.launch.spawn``;
each rank runs one function of this module, which imports only torch,
numpy and the port (never JAX), and writes what it measured under
``out``: ``rank{r}.pt`` per rank, and what rank 0 gathered.  :func:`spawn`
runs a list of such cases in one start of the ranks, so a test file pays
the start-up once."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch


def spawn(out: str, nprocs: int, cases) -> None:
    """Run ``cases`` ([(function name, kwargs)]) in order on ``nprocs``
    fresh CPU ranks."""
    from loco_asr_tpu_torch.parallel import launch

    launch.spawn(_run_cases, (out, list(cases)), nprocs, "cpu")


def _run_cases(out: str, cases) -> int:
    torch.set_num_threads(1)
    for name, kwargs in cases:
        globals()[name](out, **kwargs)
    return 0


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank()


def _save(out: str, name: str, obj) -> None:
    torch.save(obj, os.path.join(out, f"{name}.rank{_rank()}.pt"))


# -- the mesh and its collectives -------------------------------------------

MESHES = {"2,2,2": dict(kind="mesh", dims=(2, 2, 2)),
          "-1,1,2": dict(kind="mesh", dims=(-1, 1, 2)),
          "1,-1,1": dict(kind="mesh", dims=(1, -1, 1)),
          "ms4,1,2": dict(kind="multislice", dims=(4, 1, 2), num_slices=2),
          "ms2,2,2": dict(kind="multislice", dims=(2, 2, 2), num_slices=2)}


def mesh_layout(out: str) -> None:
    """This rank's coordinates and the members of its axis groups on each
    mesh of :data:`MESHES`."""
    from loco_asr_tpu_torch.parallel import mesh as M

    rec = {}
    for name, spec in MESHES.items():
        if spec["kind"] == "mesh":
            m = M.make_mesh(*spec["dims"])
        else:
            m = M.make_multislice_mesh(*spec["dims"], num_slices=spec["num_slices"])
        rec[name] = {"shape": dict(m.shape), "coords": m.coords,
                     "groups": {a: list(g.members) for a, g in m.groups.items()},
                     "dp": list(m.dp.members)}
    _save(out, "mesh_layout", rec)


def collectives(out: str) -> None:
    """The collectives and their adjoints on a (1, 2, 2) mesh: rank r holds
    rows filled with r."""
    from loco_asr_tpu_torch.parallel import collectives as coll, mesh as M

    m = M.make_mesh(1, 2, 2)
    r = _rank()
    x = torch.full((2, 3), float(r), requires_grad=True)
    w = torch.arange(12.0).reshape(4, 3) + r
    rec = {}
    for axis in ("fsdp", "tensor"):
        g = m.groups[axis]
        y = coll.gather(x, g, 0, m)
        (y * w).sum().backward()
        rec[axis] = {"gather": y.detach(), "grad": x.grad.clone(),
                     "reduce_scatter": coll.reduce_scatter(w.clone(), g, 0, m),
                     "all_reduce": coll.all_reduce(w.clone(), g, m)}
        x.grad = None
    g = m.groups["tensor"]
    z = coll.copy_to(x, g, m)
    (z * (r + 1)).sum().backward()
    rec["copy_to_grad"] = x.grad.clone()
    x.grad = None
    z = coll.reduce_from(x, g, m)
    (z * (r + 1)).sum().backward()
    rec["reduce_from"], rec["reduce_from_grad"] = z.detach(), x.grad.clone()
    _save(out, "collectives", rec)


# -- partition ---------------------------------------------------------------

def _tiny_asr_cfg(dropout: bool = False, **over):
    from loco_asr_tpu_torch.models.speecht5.config import tiny_config

    cfg = tiny_config(hidden_size=32, encoder_attention_heads=4, decoder_attention_heads=4,
                      encoder_ffn_dim=64, decoder_ffn_dim=64, **over)
    if not dropout:
        cfg = dataclasses.replace(cfg, positional_dropout=0.0, hidden_dropout=0.0,
                                  attention_dropout=0.0, activation_dropout=0.0,
                                  feat_proj_dropout=0.0, apply_spec_augment=False)
    return cfg


def _tiny_gpt2_cfg(dropout: bool = False):
    from loco_asr_tpu_torch.models.gpt2 import model as g

    cfg = g.tiny_gpt2_config(n_positions=32, n_embd=32, n_head=4)
    if not dropout:
        cfg = dataclasses.replace(cfg, embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)
    return cfg


def partition_roundtrip(out: str) -> None:
    """Tiny SpeechT5 and GPT-2 (also in bf16, whose blocks gloo moves as
    2-byte floats) sharded on (2, 2, 2) and gathered back; the local
    shapes, and each rank's c_attn block."""
    from loco_asr_tpu_torch.models.gpt2 import model as g
    from loco_asr_tpu_torch.models.speecht5 import model as st5
    from loco_asr_tpu_torch.ops.layers import cast_parameters
    from loco_asr_tpu_torch.parallel import mesh as M, partition

    m = M.make_mesh(2, 2, 2)
    rec = {}
    bf16 = cast_parameters(g.gpt2_init(_tiny_gpt2_cfg(), seed=1, device="cpu"), torch.bfloat16)
    for name, model in (("asr", st5.asr_model_init(_tiny_asr_cfg(), seed=0, device="cpu")),
                        ("gpt2", g.gpt2_init(_tiny_gpt2_cfg(), seed=0, device="cpu")),
                        ("gpt2_bf16", bf16)):
        whole = {k: v.clone() for k, v in model.state_dict().items()}
        partition.shard_params(model, m)
        rec[name] = {"local": {k: tuple(p.shape) for k, p in model.named_parameters()},
                     "gathered": partition.gather_params(model),
                     "whole": whole}
        if name == "gpt2":
            rec[name]["c_attn"] = model.h[0].attn.c_attn.weight.detach().clone()
            rec[name]["tp"] = model.h[0].attn.tp
    _save(out, "partition_roundtrip", rec)


# -- sharded training steps --------------------------------------------------

def sgd(lr: float):
    """Plain gradient descent on the trainers' optimizer interface: a step
    moves each parameter by lr times its gradient, so two steps' parameters
    differ by lr times their gradients' difference (the dropout cases'
    comparison stays as well conditioned as the gradients')."""
    from loco_asr_tpu_torch.parallel import train

    class SGD(train.Optimizer):
        def init(self, params, layout=None):
            return {"count": 0}

        @torch.no_grad()
        def update(self, params, grads, state, norm=None, layout=None):
            state["count"] += 1
            for k, p in params.items():
                if grads.get(k) is not None:
                    p.sub_(grads[k], alpha=lr)

    return SGD(lr, 0.0, 0, None, None)


def _grads(model):
    from loco_asr_tpu_torch.parallel import partition  # noqa: F401

    shards = model._param_shards
    return {k: (shards[k].full(p.grad) if p.grad is not None
                else torch.zeros(shards[k].shape)).clone()
            for k, p in model.named_parameters()}


def sharded_steps(out: str, inputs: str, cases) -> None:
    """Each case ``(name, kind, dims, kwargs)``: one sharded step from the
    weights and batch in ``inputs`` (written by the test from JAX's init);
    records the loss, grad_norm, the gathered gradients and parameters."""
    from loco_asr_tpu_torch.models.gpt2 import convert as gconvert, model as g
    from loco_asr_tpu_torch.models.speecht5 import convert, model as st5
    from loco_asr_tpu_torch.parallel import mesh as M, partition, train

    data = torch.load(inputs, weights_only=False)
    rec = {}
    for name, kind, dims, kw in cases:
        kw = dict(kw)
        mesh = M.make_mesh(*dims)
        opt = kw.pop("optimizer", "adamw")
        lr = kw.pop("lr", 1e-4)
        dropout = kw.pop("dropout", False)
        if kind == "asr":
            cfg = _tiny_asr_cfg(dropout)
            model = st5.AsrModel(cfg)
            model.load_state_dict(convert.asr_from_jax_params(data["asr_params"], cfg))
            batch = data["asr_batch"]
            make = train.make_asr_train_step
        else:
            cfg = _tiny_gpt2_cfg(dropout)
            model = g.GPT2Model(cfg)
            model.load_state_dict(gconvert.from_jax_params(data["lm_params"], cfg))
            batch = data["lm_batch"]
            make = train.make_lm_train_step
        partition.shard_params(model, mesh)
        tx = {"adamw": train.adamw, "adafactor": train.adafactor, "sgd": sgd}[opt](lr)
        freeze = kw.get("freeze_feature_encoder", False)
        params = (train.trainable_params(model, freeze) if kind == "asr"
                  else dict(model.named_parameters()))
        opt_state = tx.init(params, layout=train.layout(model))
        step = make(cfg, tx, mesh=mesh, **kw)
        gen = torch.Generator().manual_seed(11)
        m = step(model, opt_state, train.shard_batch(batch, mesh, kw.get("grad_accum", 1)),
                 gen)
        rec[name] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                     "ntokens": int(m["ntokens"]), "grads": _grads(model),
                     "params": partition.gather_params(model)}
    _save(out, "sharded_steps", rec)


def adafactor_factored(out: str) -> None:
    """Adafactor's factored statistics on sharded matrices of two factored
    shapes and a 3-D tensor, under (1, 2, 2): two updates, then the
    gathered parameters and state."""
    from loco_asr_tpu_torch.parallel import mesh as M, train
    from loco_asr_tpu_torch.parallel.tensor_parallel import ParamShard

    m = M.make_mesh(1, 2, 2)
    shapes = {"a": ((256, 160), ("fsdp", "tensor")), "b": ((160, 384), ("tensor", "fsdp")),
              "c": ((256, 8, 136), ("tensor", None, "fsdp")), "d": ((96,), ("tensor",))}
    rng = np.random.default_rng(4)
    whole = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for k, (s, _) in shapes.items()}
    grads = [{k: torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.1)
              for k, (s, _) in shapes.items()} for _ in range(2)]
    layout = {k: ParamShard(m, s, spec) for k, (s, spec) in shapes.items()}
    params = {k: layout[k].local(v) for k, v in whole.items()}
    tx = train.adafactor(1e-2, clip_norm=1.0)
    state = tx.init(params, layout=layout)
    for gr in grads:
        local = {k: layout[k].local(v) for k, v in gr.items()}
        norm = train.sharded_global_norm(local, layout, m)
        tx.update(params, local, state, norm=norm, layout=layout)
    rec = {"params": {k: layout[k].full(p) for k, p in params.items()},
           "state": train.gather_opt_state(state, tx, layout),
           "whole": whole, "grads": grads}
    _save(out, "adafactor_factored", rec)


# -- pipelines run by ranks that are already started --------------------------

def pipeline(out: str, module: str, argv, patch: str = "") -> None:
    """``module.main(argv)`` on every rank (as under ``torchrun``), after
    ``patch``: ``tiny_speecht5`` makes the argument-less ``SpeechT5Config()``
    the tiny config, ``gpt2_no_dropout`` zeroes the tiny GPT-2's dropout
    (the JAX side of a test patches its package alike)."""
    import importlib

    if patch == "tiny_speecht5":
        from loco_asr_tpu_torch.models.speecht5 import config

        full, tiny = config.SpeechT5Config, config.tiny_config()
        config.SpeechT5Config = lambda *a, **kw: full(*a, **kw) if a or kw else tiny
    elif patch == "gpt2_no_dropout":
        from loco_asr_tpu_torch.models.gpt2 import model as g

        real = g.tiny_gpt2_config
        g.tiny_gpt2_config = lambda **kw: real(**{**kw, "embd_pdrop": 0.0,
                                                  "attn_pdrop": 0.0, "resid_pdrop": 0.0})
    assert importlib.import_module(module).main(list(argv)) == 0
