"""Process-group start-up under ``torchrun`` (counterpart of
``mc_nerf_tpu/parallel/distributed.py:38-105``; ref
``utils/distributed_init.py``).

One process per card, as the reference runs it::

    torchrun --nproc_per_node N -m mc_nerf_torch --train --root_data <dir> --data_name <scene>

The launcher sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` in each process,
and :func:`initialize_distributed` reads them.  ``WORLD_SIZE`` is the only
signal: with none, or 1, the run is one process and nothing is
initialized.  The JAX package also starts a cluster on weaker hints
(``SLURM_JOB_ID`` and others) and only warns when that fails; nothing here
reads such hints.  Under ``WORLD_SIZE`` > 1 a failed
``init_process_group`` raises, the counterpart of the JAX package's
multi-host raise: the ranks never go on as independent single-process
runs, each training alone and overwriting the others' checkpoints.

The rank's card and the backend each come from a rule
(:func:`rank_device`, :func:`choose_backend`), logged, never from a
failure: NCCL when every local rank has a card of its own, gloo on the CPU
or when ranks share a card (NCCL refuses two ranks on one card).
``ReduceOp.AVG`` exists under NCCL only, so means are sums divided by the
world size (``parallel/mesh.py``).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from mc_nerf_torch import resolve_device


class Topology(NamedTuple):
    """This process's place in the run."""

    rank: int
    world: int
    local_rank: int
    local_world: int
    device: torch.device
    backend: Optional[str]      # None: one process, no group
    created: bool               # this call created the group; its caller destroys it


def rank_device(start_device: int, local_rank: int, n_cards: int) -> torch.device:
    """The card of local rank ``local_rank``: ``cuda:(start_device +
    local_rank)``, the reference's rule (``utils/distributed_init.py:22-23``),
    where that card exists; ranks past the last card share the cards from
    ``start_device`` on in turn (on a one-card machine every rank is on
    ``cuda:0``)."""
    if not 0 <= start_device < n_cards:
        raise RuntimeError(f"start_device {start_device} is not one of the {n_cards} cards")
    return torch.device("cuda", start_device + local_rank % (n_cards - start_device))


def choose_backend(device: torch.device, start_device: int, local_world: int,
                   n_cards: int) -> str:
    """``nccl`` when the ranks run on CUDA and every local rank has a card
    of its own (``start_device + local_world <= n_cards``); ``gloo`` on the
    CPU, or when ranks share a card."""
    if device.type == "cuda" and start_device + local_world <= n_cards:
        return "nccl"
    return "gloo"


def _env_int(name: str, default: Optional[int] = None) -> int:
    value = os.environ.get(name)
    if value is None or value == "":
        if default is None:
            raise RuntimeError(f"{name} is not set: a multi-process run is started by torchrun, "
                               "which sets RANK, WORLD_SIZE, LOCAL_RANK and LOCAL_WORLD_SIZE")
        return default
    return int(value)


def initialize_distributed(start_device: int = 0, device=None, init_method: str = "env://",
                           timeout: Optional[datetime.timedelta] = None) -> Topology:
    """Join the run that ``torchrun``'s environment describes.

    ``device`` None puts the rank on :func:`rank_device`'s card (one
    process: ``cuda:<start_device>``); a device named by the caller (the
    tests' ``"cpu"``) is used as given.  A CUDA device becomes the current
    one.  With ``WORLD_SIZE`` > 1 the group is created with
    :func:`choose_backend`'s backend through ``init_method`` (``env://``
    reads ``MASTER_ADDR`` / ``MASTER_PORT``; the tests rendezvous through
    a ``file://`` store), or joined when it already exists; a failure
    raises."""
    world = _env_int("WORLD_SIZE", 1)
    if world <= 1:
        dev = resolve_device(f"cuda:{start_device}" if device is None else device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)     # the kernels launch on the current device
        return Topology(0, 1, 0, 1, dev, None, False)
    rank = _env_int("RANK")
    local_rank = _env_int("LOCAL_RANK", rank)
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    if device is None:
        resolve_device("cuda")             # raises without CUDA
        dev = rank_device(start_device, local_rank, torch.cuda.device_count())
    else:
        dev = resolve_device(device)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (rank, world):
            raise RuntimeError(f"the process group is rank {dist.get_rank()} of "
                               f"{dist.get_world_size()}; the environment says {rank} of {world}")
        return Topology(rank, world, local_rank, local_world, dev, dist.get_backend(), False)
    backend = choose_backend(dev, start_device, local_world, n_cards)
    logging.info("torch.distributed: rank %d of %d (local %d of %d) on %s, backend %s "
                 "(%d cards from start_device %d)", rank, world, local_rank, local_world, dev,
                 backend, n_cards, start_device)
    kw = {} if timeout is None else {"timeout": timeout}
    try:
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                                **kw)
    except Exception as e:      # any rendezvous fault: never carry on single-process
        raise RuntimeError(
            f"WORLD_SIZE={world}: init_process_group({backend!r}, {init_method!r}) failed on "
            f"rank {rank}; refusing to go on as {world} independent single-process runs") from e
    return Topology(rank, world, local_rank, local_world, dev, backend, True)
