"""The data axis over the ranks of the default process group (counterpart
of ``mc_nerf_tpu/parallel/mesh.py``).

The workload is data-parallel over images and rays, the only axis the
reference parallelizes (torch DDP, ``utils/distributed_init.py``).  The
JAX package lays it out as a 1-D mesh over axis ``"data"``: parameters
and scene tensors replicated, the step's batch sharded on its leading
axis by ``shard_batch``, the gradient reduced by the ``psum`` XLA
inserts.  Here each rank is one process with one card: every rank holds
the parameters and the scene, draws the global batch and keeps its
contiguous block (:func:`batch_slice`, as ``P("data")`` shards a leading
axis), and the step averages one flat gradient (:func:`all_reduce_mean_`).
The JAX package also splits each eval chunk's rays over its devices with
``shard_map`` (``mc_nerf_tpu/train/steps.py:334-343``); here the ranks
split it the same way, each rendering its contiguous block of every
chunk, and one gather of equal blocks (:func:`all_gather_blocks`) puts
the frame back together on every rank (``train/steps.py::FrameRender``).

Every helper works without a group as the one-process identity.  Sums
and means are SUM all-reduces (``ReduceOp.AVG`` is NCCL's alone); a
tensor given to a collective lies on the rank's device, which is CUDA
under NCCL.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

DATA_AXIS = "data"


def _group() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks in the default group; 1 without one."""
    return dist.get_world_size() if _group() else 1


def rank() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if _group() else 0


def check_data_parallel(parallel, world: int) -> int:
    """``ParallelConfig.data_parallel`` against the world size: 0 means the
    world size; any other value must equal it (a process group cannot
    train on fewer ranks than were launched).  Returns the data axis's
    size."""
    n = parallel.data_parallel or world
    if n != world:
        raise ValueError(f"parallel.data_parallel={parallel.data_parallel}, but {world} ranks "
                         "were launched: launch as many ranks as the data axis has, or set 0")
    if parallel.mesh_axis != DATA_AXIS:
        raise ValueError(f"parallel.mesh_axis={parallel.mesh_axis!r}: the one axis is "
                         f"{DATA_AXIS!r}")
    return n


def collectives_capturable() -> bool:
    """Whether the group's collectives can be captured in a CUDA graph:
    NCCL's are kernels on the card, gloo's run on the host."""
    return _group() and dist.get_backend() == "nccl"


def batch_slice(n_global: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s contiguous block of a leading axis of ``n_global``
    (``P("data")`` of the JAX mesh)."""
    if n_global % world:
        raise ValueError(f"{n_global} rows do not split into {world} equal blocks")
    n = n_global // world
    return slice(rank * n, (rank + 1) * n)


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place."""
    if world_size() > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def all_reduce_mean_(t: torch.Tensor) -> torch.Tensor:
    """``t`` averaged over the ranks, in place: a SUM, then a division by
    the world size, so every rank holds the same bits."""
    world = world_size()
    if world > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        t.div_(world)
    return t


def all_reduce_max(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` holding its largest value over the ranks."""
    out = t.detach().clone()
    if world_size() > 1:
        dist.all_reduce(out, op=dist.ReduceOp.MAX)
    return out


def all_gather_blocks(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) stacked along the
    leading axis in rank order, ``[world * n, ...]``, on every rank; ``t``
    itself without a group.  NCCL gathers into one tensor; gloo, which
    runs on the host for CPU and CUDA tensors alike, into a list that is
    then concatenated."""
    world = world_size()
    if world == 1:
        return t
    t = t.contiguous()
    if dist.get_backend() == "nccl":
        out = t.new_empty((world * t.shape[0], *t.shape[1:]))
        dist.all_gather_into_tensor(out, t)
        return out
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t)
    return torch.cat(parts)


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, in place."""
    if world_size() > 1:
        dist.broadcast(t, src)
    return t


def barrier() -> None:
    """Wait until every rank arrives."""
    if world_size() > 1:
        dist.barrier()
