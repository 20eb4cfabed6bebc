"""The port's process-group start-up (``mc_nerf_torch/parallel/distributed.py``)
and the data axis's helpers (``parallel/mesh.py``) on the CPU: the
counterpart of ``tests/test_distributed.py``.

Ranks run as gloo subprocesses (``parallel/dryrun.py::spawn_ranks``, the
environment ``torchrun`` gives) and rendezvous through a file store under
the test's ``tmp_path``, so that concurrent test workers cannot collide on
a port.  ``WORLD_SIZE`` is the only launcher signal: none or 1 starts
nothing; under 2, a failed rendezvous raises instead of running on as one
process.  The card and the backend come from rules, checked here case by
case: ``cuda:(start_device + LOCAL_RANK)`` where the card exists, NCCL
only when every local rank has a card of its own.
"""

import datetime
import textwrap

import pytest
import torch
import torch.distributed as dist

from mc_nerf_tpu import config as j_config

from mc_nerf_torch import config as t_config
from mc_nerf_torch.parallel import distributed as t_dist
from mc_nerf_torch.parallel import mesh as t_mesh
from mc_nerf_torch.parallel.dryrun import free_port, last_json, spawn_ranks

LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT")


@pytest.fixture
def no_launcher(monkeypatch):
    for k in LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@pytest.mark.parametrize("world", [None, "1"])
def test_one_process_initializes_nothing(no_launcher, world):
    if world is not None:
        no_launcher.setenv("WORLD_SIZE", world)
    calls = []
    no_launcher.setattr(dist, "init_process_group", lambda *a, **kw: calls.append(a))
    topo = t_dist.initialize_distributed(device="cpu")
    assert calls == [] and not dist.is_initialized()
    assert topo == t_dist.Topology(0, 1, 0, 1, torch.device("cpu"), None, False)
    # the helpers are the one-process identity
    assert (t_mesh.world_size(), t_mesh.rank()) == (1, 0)
    x = torch.tensor([1.0, -2.0])
    assert t_mesh.all_reduce_mean_(x) is x and x.tolist() == [1.0, -2.0]
    assert float(t_mesh.all_reduce_max(torch.tensor(3.0))) == 3.0
    assert not t_mesh.collectives_capturable()
    assert t_mesh.batch_slice(4, 0, 1) == slice(0, 4)
    t_mesh.barrier()


_GROUP = textwrap.dedent("""
    import json, sys
    import torch
    from mc_nerf_torch.parallel import distributed as d, mesh as m
    topo = d.initialize_distributed(device="cpu", init_method=sys.argv[1])
    r = topo.rank
    again = d.initialize_distributed(device="cpu", init_method=sys.argv[1])
    out = {"topo": [topo.rank, topo.world, topo.local_rank, topo.local_world, str(topo.device),
                    topo.backend, topo.created],
           "again_created": again.created, "ws": m.world_size(), "rank": m.rank(),
           "mean": m.all_reduce_mean_(torch.tensor([1.0 + r, 10.0 * r])).tolist(),
           "max": float(m.all_reduce_max(torch.tensor(float(r)))),
           "capturable": m.collectives_capturable(),
           "sum": m.all_reduce_sum_(torch.tensor([r + 1.0], dtype=torch.float64)).tolist(),
           "bcast": m.broadcast_(torch.tensor([100 + r])).tolist()}
    m.barrier()
    torch.distributed.destroy_process_group()
    print(json.dumps(out))
""")


def test_two_gloo_ranks_form_a_group_and_all_reduce(tmp_path):
    outs = spawn_ranks(2, ["-c", _GROUP, "file://" + str(tmp_path / "store")], str(tmp_path),
                       env={"OMP_NUM_THREADS": "1"}, timeout=120)
    for r, out in enumerate(outs):
        x = last_json(out)
        assert x["topo"] == [r, 2, r, 2, "cpu", "gloo", True]
        assert x["again_created"] is False            # an existing group is joined
        assert (x["ws"], x["rank"]) == (2, r)
        assert x["mean"] == [1.5, 5.0] and x["max"] == 1.0
        assert x["sum"] == [3.0] and x["bcast"] == [100]
        assert x["capturable"] is False     # gloo: collectives on the host


@pytest.mark.parametrize("case", ["MASTER_ADDR unset", "nothing listening"])
def test_a_failed_rendezvous_raises(no_launcher, case):
    """Under WORLD_SIZE=2 a rendezvous that cannot complete raises; the
    process never carries on alone."""
    no_launcher.setenv("WORLD_SIZE", "2")
    no_launcher.setenv("RANK", "0" if case == "MASTER_ADDR unset" else "1")
    if case == "nothing listening":
        no_launcher.setenv("MASTER_ADDR", "127.0.0.1")
        no_launcher.setenv("MASTER_PORT", str(free_port()))
    with pytest.raises(RuntimeError, match="refusing to go on as 2 independent single-process"):
        t_dist.initialize_distributed(device="cpu", timeout=datetime.timedelta(seconds=2))
    assert not dist.is_initialized()


@pytest.mark.parametrize("device,start_device,local_world,n_cards,want", [
    ("cpu", 0, 2, 0, "gloo"),
    ("cpu", 0, 2, 8, "gloo"),          # CPU ranks on a machine with cards
    ("cuda:0", 0, 2, 2, "nccl"),       # a card per rank
    ("cuda:5", 4, 4, 8, "nccl"),       # the cards from start_device on
    ("cuda:0", 0, 2, 1, "gloo"),       # two ranks on the one card
    ("cuda:1", 1, 2, 2, "gloo"),       # start_device leaves one card for two
])
def test_the_backend_rule(device, start_device, local_world, n_cards, want):
    assert t_dist.choose_backend(torch.device(device), start_device, local_world,
                                 n_cards) == want


@pytest.mark.parametrize("start_device,local_rank,n_cards,want", [
    (0, 0, 2, 0), (0, 1, 2, 1), (2, 1, 4, 3),       # start_device + LOCAL_RANK
    (0, 1, 1, 0), (1, 1, 2, 1), (0, 3, 2, 1),       # more ranks than cards: shared in turn
])
def test_the_device_rule(start_device, local_rank, n_cards, want):
    assert t_dist.rank_device(start_device, local_rank, n_cards) == torch.device("cuda", want)


def test_a_start_device_past_the_cards_raises():
    with pytest.raises(RuntimeError, match="start_device 2 is not one of the 2 cards"):
        t_dist.rank_device(2, 0, 2)


@pytest.mark.parametrize("n_cards,card,backend", [(2, 1, "nccl"), (1, 0, "gloo")])
def test_a_launched_rank_takes_its_card_and_the_rule_backend(no_launcher, n_cards, card,
                                                              backend):
    """Rank 1 of 2 under torchrun, no device named: its card by the device
    rule becomes the current device and the group gets the rule's backend
    (the card and the group faked: none here)."""
    for k, v in (("WORLD_SIZE", "2"), ("RANK", "1"), ("LOCAL_RANK", "1"),
                 ("LOCAL_WORLD_SIZE", "2")):
        no_launcher.setenv(k, v)
    seen = {}
    no_launcher.setattr(torch.cuda, "is_available", lambda: True)
    no_launcher.setattr(torch.cuda, "device_count", lambda: n_cards)
    no_launcher.setattr(torch.cuda, "set_device", lambda d: seen.setdefault("current", d))
    no_launcher.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend, **kw))
    topo = t_dist.initialize_distributed()
    assert topo == t_dist.Topology(1, 2, 1, 2, torch.device("cuda", card), backend, True)
    assert seen == {"current": torch.device("cuda", card), "backend": backend,
                    "init_method": "env://", "rank": 1, "world_size": 2}


@pytest.mark.parametrize("data_parallel,world,ok", [
    (0, 1, True), (0, 2, True), (2, 2, True), (1, 2, False), (4, 2, False)])
def test_parallel_config_is_held_to_the_world_size(data_parallel, world, ok):
    pc = t_config.ParallelConfig(data_parallel=data_parallel)
    j = j_config.ParallelConfig(data_parallel=data_parallel)
    assert (pc.data_parallel, pc.mesh_axis) == (j.data_parallel, j.mesh_axis)
    if ok:
        assert t_mesh.check_data_parallel(pc, world) == world
    else:
        with pytest.raises(ValueError, match=f"but {world} ranks were launched"):
            t_mesh.check_data_parallel(pc, world)


def test_batch_slice_gives_contiguous_blocks():
    assert [t_mesh.batch_slice(6, r, 3) for r in range(3)] == [slice(0, 2), slice(2, 4),
                                                                slice(4, 6)]
    with pytest.raises(ValueError, match="do not split into 2 equal blocks"):
        t_mesh.batch_slice(5, 0, 2)
