"""One process per mesh position: how the port's entry points become ranks.

Every multi-rank entry point (``train_asr`` / ``train_lm --mesh``,
``decode_asr`` / ``extract_embeddings`` / ``eval_ppl --data_parallel``)
calls :func:`run` first, with the rank count its flags ask for:

* under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` set) the
  process joins that group (``env://``);
* as a plain command with more than one rank wanted, it starts that many
  local ranks itself (``torch.multiprocessing``, start method ``spawn``),
  each running the same command line; they meet through a file store in a
  temporary directory, so concurrent runs never share a TCP port;
* with one rank, it runs as it always has.

Each rank's device is ``cuda:{local_rank % torch.cuda.device_count()}``,
or the CPU when the command asks for it.  One rule picks the backend, and
it is logged: NCCL when every rank has a card of its own, gloo when ranks
share a card or run on the CPU (then ``collectives.py`` stages CUDA tensors
through host memory).  Nothing falls back: a rank that cannot reach its
device, or a failed collective, ends the run non-zero.  Kernels are built
once: by the parent before it starts ranks, or by each node's local rank 0
under ``torchrun`` while the other ranks wait (:func:`prebuild`)."""

from __future__ import annotations

import atexit
import datetime
import importlib
import os
import sys
import tempfile
from typing import List, Optional

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=900)


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def rank_device(device: str) -> torch.device:
    """This rank's device: the CPU when asked, else its card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run "
                           "the plain PyTorch versions on the CPU")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def choose_backend(device: torch.device, local_world: int) -> tuple:
    """(backend, reason): NCCL when every local rank has a card of its own,
    gloo otherwise."""
    if device.type != "cuda":
        return "gloo", "ranks on the CPU"
    cards = torch.cuda.device_count()
    if local_world <= cards:
        return "nccl", f"{local_world} ranks on {cards} cards, one card each"
    return "gloo", (f"{local_world} ranks share {cards} card(s); collectives "
                    "staged through host memory")


def init(rank: int, world: int, device: str, init_method: str,
         local_world: Optional[int] = None) -> torch.device:
    """Join the process group as ``rank`` of ``world`` and return the
    rank's device (set as the current CUDA device)."""
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend, why = choose_backend(dev, local_world or world)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    if rank == 0:
        print(f"distributed: {world} ranks, backend {backend} ({why})", file=sys.stderr)
    return dev


def is_rank() -> bool:
    return dist.is_available() and dist.is_initialized()


def ranks_wanted(dims: List[int]) -> int:
    """The ranks a plain command starts for mesh ``dims`` (a -1 takes one;
    under a process group it absorbs the world instead, ``make_mesh``)."""
    n = 1
    for d in dims:
        n *= max(d, 1)
    return n


def run(module: str, argv: Optional[List[str]], nprocs: int, device: str) -> Optional[int]:
    """None: go on, as a rank (or the only process).  Otherwise ``nprocs``
    ranks of ``module.main(argv)`` were spawned and have ended; returns 0
    (a failed rank raises here)."""
    if is_rank():
        return None
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        init(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), device, "env://",
             int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"])))
        atexit.register(_finish)
        if torch.device(device).type == "cuda":
            if local_rank() == 0:     # one build a node; the others wait for it
                prebuild(device)
            dist.barrier()
        return None
    if nprocs <= 1:
        return None
    argv = list(sys.argv[1:] if argv is None else argv)
    prebuild(device)
    spawn(_entry, (module, argv), nprocs, device)
    return 0


def prebuild(device: str) -> None:
    """Build the CUDA kernels once, in this process, before ranks start."""
    if torch.device(device).type == "cuda":
        from ..ops.cuda import _build
        _build.build()


def spawn(fn, args: tuple, nprocs: int, device: str) -> None:
    """Run ``fn(*args)`` on ``nprocs`` fresh local ranks, each joined to one
    process group through a file store; raises if any rank fails."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="loco_ranks_") as tmp:
        store = "file://" + os.path.join(tmp, "store")
        mp.start_processes(_rank_main, (fn, args, nprocs, device, store), nprocs=nprocs,
                           join=True, start_method="spawn")


def _rank_main(rank: int, fn, args: tuple, world: int, device: str, store: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    # the local ranks share the host's cores
    torch.set_num_threads(max(1, torch.get_num_threads() // world))
    init(rank, world, device, store)
    try:
        rc = fn(*args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rc:
        sys.exit(rc)


def _entry(module: str, argv: List[str]) -> int:
    return importlib.import_module(module).main(argv)


def _finish() -> None:
    if is_rank():
        dist.destroy_process_group()
