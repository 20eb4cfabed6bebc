"""A run driven on the CPU past the harness's look for a card, with the
timed path broken underneath, reads ``correct`` false: a step that
returns its state unchanged, half of the batch left out of the mean, the
exchange between the ranks left out, an answer altered where it is
produced.  The same runs unbroken read true (the port in float32, which
the fp32 reference follows to round-off)."""

import socket
import time

import pytest
import torch
import torch.multiprocessing as mp

import mc_nerf_torch.train.steps as steps
from mc_nerf_torch.train.optim import FlatRAdam
from portbench.run import Run, manifest, run_cell
from portbench.tests.conftest import tiny


def drive(workload, seed=2 ** 31 + 5, overrides=None):
    b = Run(workload, seed, 0.1, False, torch.device("cpu"), time.time(),
            overrides=overrides or tiny(workload, fp32=True))
    return run_cell(b, manifest())


@pytest.mark.parametrize("workload", ["train.importance", "train.grid", "frame.importance"])
def test_sound_runs_are_correct(workload, cpu_threads):
    assert drive(workload)["correct"]


@pytest.mark.parametrize("workload", ["train.importance", "train.grid"])
def test_a_step_that_returns_its_state_unchanged(workload, monkeypatch, cpu_threads):
    monkeypatch.setattr(FlatRAdam, "update", lambda self, g, state, p: state)
    r = drive(workload)
    assert not r["correct"]
    assert r["checks"]["change_gap"]["value"] > 0.5


@pytest.mark.parametrize("workload", ["train.importance", "train.grid"])
def test_half_the_batch_left_out_of_the_mean(workload, monkeypatch, cpu_threads):
    half = lambda pred, gt: torch.mean((pred[: len(pred) // 2] - gt[: len(gt) // 2]) ** 2)
    monkeypatch.setattr(steps, "rgb_loss", half)
    r = drive(workload)
    assert not r["correct"]


def test_an_answer_altered_where_it_is_produced(monkeypatch, cpu_threads):
    whole = steps.FrameRender._whole

    def altered(self, part):
        rgb, depth, opacity = whole(self, part)
        rgb[: rgb.shape[0] // 4] += 0.1       # a quarter of the rows off by 0.1
        return rgb, depth, opacity
    monkeypatch.setattr(steps.FrameRender, "_whole", altered)
    assert not drive("frame.importance")["correct"]


def _rank(r, world, port, fault, out):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=r,
                            world_size=world)
    if fault:
        steps.all_reduce_mean_ = lambda t: t          # the gradient's exchange left out
    ov = tiny("train.importance", fp32=True)
    ov["traffic"]["world"] = world          # the steps over 2 gloo ranks, one image each
    b = Run("train.importance", 2 ** 31 + 7, 0.1, False, torch.device("cpu"), time.time(),
            rank=r, overrides=ov)
    res = run_cell(b, manifest())
    dist.barrier()
    dist.destroy_process_group()
    if r == 0:
        out.put(res)


def _two_ranks(fault):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, 2, port, fault, out)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        res = out.get(timeout=240)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs)
    return res


@pytest.mark.parametrize("fault", [False, True], ids=["sound", "exchange_left_out"])
def test_the_exchange_between_ranks(fault):
    res = _two_ranks(fault)
    assert res["correct"] is (not fault)
    if fault:
        assert res["checks"]["rank_gap"]["value"] > 0
