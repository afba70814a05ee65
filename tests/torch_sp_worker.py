"""Rank-side code of the port's sequence-parallel CPU tests
(``tests/test_torch_ring_attention.py``, ``test_torch_ulysses.py``,
``test_torch_sequence_parallel.py``).

As in ``torch_dist_worker.py``, :func:`spawn` starts gloo ranks on the
CPU once for a list of cases; each function runs on every rank, imports
only torch, numpy and the port, reads the inputs the test wrote with numpy
from a seed, and saves what it computed: ``{name}.rank{r}.pt``."""

from __future__ import annotations

import torch

from torch_dist_worker import _rank, _save, _tiny_asr_cfg, _tiny_gpt2_cfg


def spawn(out: str, nprocs: int, cases) -> None:
    """Run ``cases`` ([(function name, kwargs)]) of this module in order on
    ``nprocs`` fresh CPU ranks."""
    from loco_asr_tpu_torch.parallel import launch

    launch.spawn(_run_cases, (out, list(cases)), nprocs, "cpu")


def _run_cases(out: str, cases) -> int:
    torch.set_num_threads(1)
    for name, kwargs in cases:
        globals()[name](out, **kwargs)
    return 0


def _sp(sequence: int, data: int = 1):
    from loco_asr_tpu_torch.parallel import mesh as M
    from loco_asr_tpu_torch.parallel.sp import SequenceParallel

    mesh = M.make_sp_mesh(sequence, data)
    return mesh, SequenceParallel(mesh)


def sp_attention(out: str, inputs: str, cases) -> None:
    """Each case ``(name, impl, sequence, kwargs)``: the scheme on this
    rank's blocks of the whole q/k/v of ``inputs[name]``, its output and
    the gradients of ``sum(out * g)``, gathered whole (dpe summed); or the
    ``ValueError`` it raised."""
    from loco_asr_tpu_torch.parallel import collectives as coll

    data = torch.load(inputs, weights_only=False)
    rec = {}
    for name, impl, sequence, kw in cases:
        x = data[name]
        mesh, sp = _sp(sequence)
        pe = (torch.from_numpy(x["pe"]).requires_grad_() if x.get("pe") is not None
              else None)
        kvl = torch.from_numpy(x["kvl"]) if x.get("kvl") is not None else None
        try:
            blocks = {k: sp.block(torch.from_numpy(x[k]), 2).clone().requires_grad_()
                      for k in ("q", "k", "v")}
            o = sp.attention(impl, blocks["q"], blocks["k"], blocks["v"], causal=kw["causal"],
                             scale=kw.get("scale"), kv_valid_len=kvl, rel_pe=pe)
        except ValueError as e:
            rec[name] = {"error": str(e)}
            continue
        (o * sp.block(torch.from_numpy(x["g"]), 2)).sum().backward()
        full = lambda t: coll.all_gather(t.detach(), sp.group, 2, mesh)
        rec[name] = {"out": full(o), "dq": full(blocks["q"].grad),
                     "dk": full(blocks["k"].grad), "dv": full(blocks["v"].grad),
                     "dpe": (coll.all_reduce(pe.grad, sp.group, mesh)
                             if pe is not None else None)}
    _save(out, "sp_attention", rec)


def collectives(out: str) -> None:
    """The sequence-parallel collectives and their adjoints over a group of
    the world's ranks: rank r holds [2, 4, 3] filled with r."""
    from loco_asr_tpu_torch.parallel import collectives as coll

    mesh, sp = _sp(torch.distributed.get_world_size())
    r = _rank()
    x = (torch.arange(24.0).reshape(2, 4, 3) + 100 * r).requires_grad_()
    w = torch.arange(24.0).reshape(2, 4, 3) * (r + 1)
    rec = {}
    y = coll.permute(x, sp.group, mesh)
    (y * w).sum().backward()
    rec["permute"], rec["permute_grad"] = y.detach(), x.grad.clone()
    x.grad = None
    y = coll.exchange(x, sp.group, mesh, split_dim=1, concat_dim=2)
    (y * torch.arange(y.numel(), dtype=y.dtype).reshape(y.shape)).sum().backward()
    rec["exchange"], rec["exchange_grad"] = y.detach(), x.grad.clone()
    rec["bf16_shift"] = coll.ring_shift(x.detach().to(torch.bfloat16), sp.group, mesh, 2)
    _save(out, "sp_collectives", rec)


def _grads(model):
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().clone()
            for k, p in model.named_parameters()}


def sp_steps(out: str, inputs: str, cases) -> None:
    """Each case ``(name, kind, (data, sequence), kwargs)``: one
    sequence-parallel step from the JAX init and batch in ``inputs`` on a
    ("data", "sequence") mesh (kwargs: the step's, with ``dropout``,
    ``optimizer`` "sgd" | "identity" and ``lr``); the loss, grad norm,
    token count, the gradients and the parameters after the step."""
    from loco_asr_tpu_torch.models.gpt2 import convert as gconvert, model as g
    from loco_asr_tpu_torch.models.speecht5 import convert, model as st5
    from loco_asr_tpu_torch.parallel import mesh as M, train
    from torch_dist_worker import sgd

    data = torch.load(inputs, weights_only=False)
    rec = {}
    for name, kind, (dp, seq), kw in cases:
        kw = dict(kw)
        mesh = M.make_sp_mesh(seq, dp)
        lr = kw.pop("lr", 0.0)
        dropout = kw.pop("dropout", False)
        if kind == "asr":
            cfg = _tiny_asr_cfg(dropout)
            model = st5.AsrModel(cfg)
            model.load_state_dict(convert.asr_from_jax_params(data["asr_params"], cfg))
            batch, make = data["asr_batch"], train.make_asr_train_step
        else:
            cfg = _tiny_gpt2_cfg(dropout)
            model = g.GPT2Model(cfg)
            model.load_state_dict(gconvert.from_jax_params(data["lm_params"], cfg))
            batch, make = data["lm_batch"], train.make_lm_train_step
        tx = sgd(lr)
        opt_state = tx.init(dict(model.named_parameters()))
        step = make(cfg, tx, mesh=mesh, **kw)
        try:
            m = step(model, opt_state, train.shard_batch(batch, mesh, kw.get("grad_accum", 1)),
                     torch.Generator().manual_seed(11))
        except ValueError as e:
            rec[name] = {"error": str(e)}
            continue
        rec[name] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                     "ntokens": int(m["ntokens"]), "grads": _grads(model),
                     "params": {k: v.clone() for k, v in model.state_dict().items()}}
    _save(out, "sp_steps", rec)


def sp_models(out: str, inputs: str, cases) -> None:
    """Each case ``(name, kind, impl, (data, sequence))``: the SpeechT5
    encoder (``kind`` "encoder": this rank's block of the encodings,
    gathered) or GPT-2 scoring (``kind`` "gpt2": ``score_tokens`` of this
    rank's data rows, gathered over the data axis), in eval mode from the
    JAX weights in ``inputs``."""
    from loco_asr_tpu_torch.models.gpt2 import convert as gconvert, model as g
    from loco_asr_tpu_torch.models.speecht5 import convert, model as st5
    from loco_asr_tpu_torch.parallel import collectives as coll

    data = torch.load(inputs, weights_only=False)
    rec = {}
    for name, kind, impl, (dp, seq) in cases:
        mesh, sp = _sp(seq, dp)
        with torch.no_grad():
            if kind == "encoder":
                cfg = _tiny_asr_cfg()
                model = st5.SpeechEncoder(cfg)
                model.load_state_dict(convert.from_jax_params(data["enc_params"], cfg))
                model.eval()
                x = data["enc_batch"]
                block, mask = model(torch.from_numpy(x["wav"]), torch.from_numpy(x["mask"]),
                                    attn_impl=impl, sp=sp)
                rec[name] = {"hidden": coll.all_gather(block, sp.group, 1, mesh),
                             "mask": mask}
            else:
                cfg = data["gpt2_cfg"]
                model = g.GPT2Model(cfg)
                model.load_state_dict(gconvert.from_jax_params(data["gpt2_params"], cfg))
                model.eval()
                ids = torch.from_numpy(data["gpt2_ids"])
                rows = ids.shape[0] // mesh.size("data")
                mine = ids.narrow(0, mesh.index("data") * rows, rows)
                nll = g.score_tokens(model, mine, attn_impl=impl, sp=sp)
                rec[name] = {"nll": coll.all_gather(nll, mesh.groups["data"], 0, mesh)}
    _save(out, "sp_models", rec)
