"""Process groups for multi-process campaigns: PyTorch's form of
``jax.distributed.initialize`` (``benchmarks/multihost.py``).

The reference runs one JAX process per host, each driving a mesh of
devices.  The port runs one process per rank, each driving one device,
and sums its statistics with ``torch.distributed`` collectives:

* :func:`init_from_env` joins the group that ``python -m
  torch.distributed.run`` (torchrun) describes in ``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and
  ``MASTER_ADDR``/``MASTER_PORT``.  Without them the world is one rank,
  no process group is made and no collective runs.
* :func:`spawn` starts ``world_size`` local processes, one rank each, runs
  a function of the package in every one, joins them all and returns each
  rank's result; any rank's exception fails the call.

Each rank uses ``cuda:LOCAL_RANK % device_count`` unless it is asked for
the CPU.  The backend rule is explicit, with no quiet switch
(:func:`choose_backend`): ``None`` means ``"nccl"`` when the ranks are on
CUDA and no two share a card, and ``"gloo"`` on the CPU; ranks that share
a card (more ranks on a host than cards: NCCL refuses two ranks on one
device) raise unless the caller names ``"gloo"``, which runs
``all_reduce`` on CUDA tensors too.  The chosen backend is logged.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import pickle
import socket
import tempfile
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["World", "choose_backend", "free_port", "init_from_env",
           "init_process", "shutdown", "spawn"]

_log = logging.getLogger(__name__)

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in the group: its rank, the number of ranks,
    its rank on this host, its device, and the group's backend (None: one
    rank without a process group)."""

    rank: int
    world_size: int
    local_rank: int
    device: torch.device
    backend: Optional[str]


def rank_device(device, local_rank: int) -> torch.device:
    """``cuda:local_rank % device_count`` for a CUDA ``device``; a CPU
    device as it is.  Raises without CUDA (``resolve_device``)."""
    device = resolve_device(device)
    if device.type == "cuda":
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return device


def choose_backend(backend: Optional[str], device: torch.device,
                   local_world_size: int) -> str:
    """The backend for ranks on ``device``, ``local_world_size`` of them on
    this host (module docstring: the rule)."""
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")
    if device.type != "cuda":
        if backend == "nccl":
            raise ValueError("the nccl backend needs ranks on CUDA devices; "
                             f"these are on {device.type}: use gloo")
        return "gloo"
    cards = torch.cuda.device_count()
    shared = local_world_size > cards
    if shared and backend != "gloo":
        raise ValueError(
            f"{local_world_size} ranks share {cards} CUDA device(s) on this "
            "host: NCCL takes one card per rank; name backend='gloo' to run "
            "ranks that share a card")
    return backend or "nccl"


def init_process(rank: int, world_size: int, local_rank: int,
                 local_world_size: int, init_method: str,
                 backend: Optional[str] = None,
                 device=DEFAULT_DEVICE) -> World:
    """Join the default process group as ``rank`` of ``world_size`` through
    ``init_method`` (``"env://"`` or ``"tcp://host:port"``), on this rank's
    device and the backend :func:`choose_backend` picks."""
    dev = rank_device(device, local_rank)
    backend = choose_backend(backend, dev, local_world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    _log.info("rank %d of %d on %s, torch.distributed backend %s",
              rank, world_size, dev, backend)
    return World(rank, world_size, local_rank, dev, backend)


def init_from_env(backend: Optional[str] = None, device=DEFAULT_DEVICE) -> World:
    """Join the group torchrun's environment describes; without ``RANK``
    and ``WORLD_SIZE`` the world is this one rank and no group is made
    (``backend`` is still checked against ``device``)."""
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        dev = rank_device(device, 0)
        choose_backend(backend, dev, 1)
        return World(0, 1, 0, dev, None)
    world_size = int(env["WORLD_SIZE"])
    return init_process(int(env["RANK"]), world_size,
                        int(env.get("LOCAL_RANK", 0)),
                        int(env.get("LOCAL_WORLD_SIZE", world_size)),
                        "env://", backend, device)


def shutdown(world: World) -> None:
    """Leave the process group ``world`` joined (nothing for one rank
    without a group)."""
    if world.backend is not None and dist.is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    """A free TCP port on localhost, for a ``tcp://127.0.0.1:<port>``
    ``init_method``."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, world_size: int, backend, device: str,
               init_method: str, out_dir: str, args: tuple) -> None:
    world = init_process(rank, world_size, rank, world_size, init_method,
                         backend, device)
    try:
        result = fn(world, *args)
    finally:
        shutdown(world)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(fn: Callable, world_size: int, backend: Optional[str] = None,
          device=DEFAULT_DEVICE, args: tuple = ()) -> list:
    """Run ``fn(world, *args)`` in ``world_size`` new local processes, one
    rank each, and return the ranks' results in rank order.

    ``fn`` and ``args`` are pickled, ``fn`` by its import path: it must be
    a module-level function of an importable module (the package's own
    workers, such as ``dryrun.dryrun_rank``), so that a child imports no
    more than it needs.  Every rank is joined; if one raises, the others
    are terminated and the call raises
    ``torch.multiprocessing.ProcessRaisedException`` with its traceback.
    The backend is checked here, before any process starts."""
    choose_backend(backend, rank_device(device, 0), world_size)
    init_method = f"tcp://127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory() as out_dir:
        torch.multiprocessing.spawn(
            _rank_main, nprocs=world_size, join=True,
            args=(fn, world_size, backend, str(device), init_method, out_dir,
                  tuple(args)))
        results = []
        for rank in range(world_size):
            with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
