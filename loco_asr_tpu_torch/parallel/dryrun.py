"""Multi-rank dry run: the port of the JAX
``__graft_entry__.dryrun_multichip``.

``dryrun_multichip(n)`` builds the mesh that the JAX dry run derives from
``n`` (tensor 2 when ``n`` is even, fsdp 2 when ``n`` divides by 4, data the
rest), runs the sharded ASR train step of the tiny config with dropout on,
one step from the seeded init, and holds it to the single-device step on
the same weights, batch and generator (loss within 1e-4, ``grad_norm``
within 1e-3 relative, the JAX dry run's bounds).  At ``n >= 8`` it does the
same on the two-slice mesh (``make_multislice_mesh(2, 2, 2,
num_slices=2)``).  Then its sequence-parallel sections (``sp.py``):
GPT-2 scoring (the tiny config, 64 positions, 4 heads) under ring
attention over 4 ranks (2 below 4), finite; Ulysses on the same window
within 1e-4 of the ring's mean NLL; the ASR ring step over 2 ranks on a
batch whose frame count divides 2 (JAX's loop over the length), here also
held to the single-device flash step by the bounds above; and at ``n >=
4`` DP x SP on a (2, 2) ("data", "sequence") mesh within 1e-4 of the
ring.  Called outside a process group it starts ``n`` local
ranks (``launch.py``) on the card (``cuda:{rank % cards}``), or over gloo
on the CPU with ``device="cpu"``.  Returns rank 0's numbers.

    python -m loco_asr_tpu_torch.parallel.dryrun 8 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Dict

import numpy as np
import torch


def mesh_dims(n_devices: int) -> tuple:
    """(data, fsdp, tensor) of the JAX dry run for ``n_devices``."""
    tensor = 2 if n_devices % 2 == 0 else 1
    fsdp = 2 if n_devices % 4 == 0 else 1
    return n_devices // (tensor * fsdp), fsdp, tensor


def _setup(data: int, fsdp: int):
    from ..models.speecht5.config import tiny_config

    cfg = tiny_config(hidden_size=32, encoder_attention_heads=4, decoder_attention_heads=4,
                      encoder_ffn_dim=64, decoder_ffn_dim=64)
    rng = np.random.default_rng(0)
    b = max(data * fsdp * 2, 4)
    batch = {"input_values": rng.standard_normal((b, 320)).astype(np.float32),
             "attention_mask": np.ones((b, 320), np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, 6))}
    return cfg, batch


def _step(cfg, batch, device, mesh=None, attn_impl: str = "dense") -> Dict[str, float]:
    """One adamw(1e-4) step from the seed-0 init, dropout drawn from a
    generator of seed 1; sharded on ``mesh`` when given (a
    sequence-parallel mesh under ring / Ulysses: the model whole)."""
    from ..models.speecht5 import model as st5
    from . import train

    tx = train.adamw(1e-4)
    if mesh is None or attn_impl in ("ring", "ulysses"):
        model = st5.asr_model_init(cfg, seed=0, device=device)
        b = ({k: torch.as_tensor(v, device=device) for k, v in batch.items()} if mesh is None
             else train.shard_batch(batch, mesh))
    else:
        model = train.init_sharded(st5.asr_model_init, 0, cfg, mesh)
        b = train.shard_batch(batch, mesh)
    opt_state = tx.init(train.trainable_params(model), layout=train.layout(model))
    step = train.make_asr_train_step(cfg, tx, mesh=mesh, attn_impl=attn_impl)
    gen = torch.Generator(device=device).manual_seed(1)
    m = step(model, opt_state, b, gen)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}


def _check(name: str, got: Dict[str, float], ref: Dict[str, float]) -> Dict[str, float]:
    d_loss = abs(got["loss"] - ref["loss"])
    d_gn = abs(got["grad_norm"] - ref["grad_norm"]) / max(ref["grad_norm"], 1e-9)
    assert np.isfinite(got["loss"]), f"{name}: non-finite loss {got['loss']}"
    assert d_loss < 1e-4, (name, got["loss"], ref["loss"])
    assert d_gn < 1e-3, (name, got["grad_norm"], ref["grad_norm"])
    return {**got, "d_loss": d_loss, "d_grad_norm_rel": d_gn}


def _run(n_devices: int, device: str, out: str) -> int:
    import torch.distributed as dist

    from . import launch
    from . import mesh as meshlib

    dev = launch.rank_device(device)
    data, fsdp, tensor = mesh_dims(n_devices)
    cfg, batch = _setup(data, fsdp)
    res = {"mesh": [data, fsdp, tensor]}
    mesh = meshlib.make_mesh(data, fsdp, tensor, devices=range(n_devices), device=dev)
    ref = _step(cfg, batch, dev)
    res["single"] = ref
    res["sharded"] = _check("sharded", _step(cfg, batch, dev, mesh), ref)
    if dist.get_rank() == 0:
        print(f"dryrun_multichip({n_devices}): mesh=({data},{fsdp},{tensor}) "
              f"loss={res['sharded']['loss']:.4f} "
              f"grad_norm={res['sharded']['grad_norm']:.4f} | single-device parity "
              f"d_loss={res['sharded']['d_loss']:.2e} "
              f"d_grad_norm(rel)={res['sharded']['d_grad_norm_rel']:.2e}")
    if n_devices >= 8:
        ms = meshlib.make_multislice_mesh(2, 2, 2, num_slices=2, devices=range(8),
                                          device=dev)
        res["multislice"] = _check("multislice", _step(cfg, batch, dev, ms), ref)
        if dist.get_rank() == 0:
            print(f"dryrun_multichip({n_devices}): multislice (2 slices) train step "
                  f"loss={res['multislice']['loss']:.4f} | single-device parity "
                  f"d_loss={res['multislice']['d_loss']:.2e} "
                  f"d_grad_norm(rel)={res['multislice']['d_grad_norm_rel']:.2e}")
    res.update(_sequence_parallel(n_devices, cfg, dev))
    if dist.get_rank() == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    return 0


def _sequence_parallel(n_devices: int, cfg, dev) -> Dict:
    """The dry run's sequence-parallel sections on this rank (ranks past a
    mesh's grid compute its numbers on their own)."""
    import torch.distributed as dist

    from ..models.gpt2 import model as g
    from . import mesh as meshlib
    from .sp import SequenceParallel

    rank0 = dist.get_rank() == 0
    rng = np.random.default_rng(1)
    n_sp = 4 if n_devices >= 4 else min(2, n_devices)
    gcfg = g.tiny_gpt2_config(n_positions=64, n_embd=32, n_head=4)
    model = g.gpt2_init(gcfg, seed=2, device=dev)
    ids = torch.as_tensor(rng.integers(0, gcfg.vocab_size, (2, 64)), device=dev)

    def score(impl, data, seq):
        mesh = meshlib.make_sp_mesh(seq, data, devices=range(n_devices), device=dev)
        if mesh.coords is None:      # a rank past the grid scores the window alone
            mesh = meshlib.make_sp_mesh(1, 1, devices=[dist.get_rank()], device=dev)
        rows = ids.shape[0] // mesh.size("data")
        mine = ids.narrow(0, mesh.index("data") * rows, rows)
        with torch.inference_mode():
            nll = g.score_tokens(model, mine, attn_impl=impl, sp=SequenceParallel(mesh))
        from .collectives import all_gather
        return all_gather(nll, mesh.groups["data"], 0, mesh)

    res = {"sp_devices": n_sp}
    ring = score("ring", 1, n_sp)
    res["ring_mean_nll"] = float(ring.mean())
    assert np.isfinite(res["ring_mean_nll"]), f"non-finite SP nll {res['ring_mean_nll']}"
    res["ulysses_mean_nll"] = float(score("ulysses", 1, n_sp).mean())
    assert abs(res["ulysses_mean_nll"] - res["ring_mean_nll"]) < 1e-4, res
    if rank0:
        print(f"dryrun_multichip({n_devices}): ring-SP GPT-2 scoring over {n_sp} devices "
              f"mean_nll={res['ring_mean_nll']:.4f}; ulysses-SP "
              f"mean_nll={res['ulysses_mean_nll']:.4f}")

    # the ASR ring step over 2 ranks: SP shards encoder frames, so the
    # frame count must divide the mesh
    t_sp = 1600
    while cfg.feat_extract_output_length(t_sp) % 2:
        t_sp += 16
    batch = {"input_values": (rng.standard_normal((2, t_sp)) * 0.1).astype(np.float32),
             "attention_mask": np.ones((2, t_sp), np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 6))}
    sp_mesh = meshlib.make_sp_mesh(min(2, n_devices), 1, devices=range(n_devices), device=dev)
    res["asr_ring"] = _check("asr_ring", _step(cfg, batch, dev, sp_mesh, attn_impl="ring"),
                             _step(cfg, batch, dev, attn_impl="flash"))
    if rank0:
        print(f"dryrun_multichip({n_devices}): ASR ring-SP train step over 2 devices "
              f"loss={res['asr_ring']['loss']:.4f} | single-device parity "
              f"d_loss={res['asr_ring']['d_loss']:.2e}")
    if n_devices >= 4:
        res["dp_sp_mean_nll"] = float(score("ring", 2, 2).mean())
        assert abs(res["dp_sp_mean_nll"] - res["ring_mean_nll"]) < 1e-4, res
        if rank0:
            print(f"dryrun_multichip({n_devices}): DPxSP (2,2) ring scoring "
                  f"mean_nll={res['dp_sp_mean_nll']:.4f}")
    return res


def dryrun_multichip(n_devices: int, device: str = "cuda") -> Dict:
    """Run the dry run on ``n_devices`` local ranks; rank 0's numbers.  On
    a machine without a card it raises unless ``device="cpu"``."""
    from . import launch

    launch.rank_device(device)          # no card: raise before any rank starts
    with tempfile.TemporaryDirectory(prefix="loco_dryrun_") as tmp:
        out = os.path.join(tmp, "result.json")
        if launch.is_rank():
            _run(n_devices, device, out)
        else:
            launch.prebuild(device)
            launch.spawn(_run, (n_devices, device, out), n_devices, device)
        if not os.path.exists(out):
            return {}
        with open(out) as f:
            return json.load(f)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Multi-rank dry run: the sharded ASR step and "
                                "sequence parallelism")
    p.add_argument("n_devices", nargs="?", type=int, default=8)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
