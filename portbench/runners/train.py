"""The train runner: GLOBAL_OPTIM steps through the port's compiled epoch
(``make_stage_epoch``, one CUDA graph a step, replayed), on one card or on
NCCL ranks, one a card.

Set-up builds one epoch object over the train state and hands it to the
window: its first ``check_steps`` steps (epochs of one step, the capture
in the first) are the ones the reference follows; then it takes epochs of
``steps_per_epoch`` steps until the epoch that crosses ``--seconds``
ends.  ``train_rays_per_s`` is every ray of every step of the window over
all the window's time, summed over the ranks.
"""

from __future__ import annotations

import gc
import math
import time

import torch
import torch.distributed as dist

from portbench import checks, flops, profiling
from portbench.program import make_stage_epoch, port_config, train_setup
from portbench.reference import train as ref_train
from portbench.reference.nerf import no_tf32
from portbench.scene import draw_step, make_scene, step_generator


def _rank_max(x: float, world: int, dev) -> float:
    if world == 1:
        return x
    t = torch.tensor([x], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def run(b) -> dict:
    """One run of a train cell (see the module); ``b`` the run's settings
    (:class:`portbench.run.Run`).  Returns what every rank knows; only
    rank 0's carries the check."""
    cfg, tr, dev = b.config, b.traffic, b.device
    world, rank = tr["world"], b.rank
    sc = tr["scene"]
    h, w = sc["img_h"], sc["img_w"]
    ipb = tr["images_per_batch"]
    scene = make_scene(cfg["nerf"], sc, b.seed, dev)
    port_cfg = port_config(cfg, ipb)
    state, data, tx = train_setup(scene.params, scene.images_u8, scene.detections, port_cfg, tr,
                                  dev)
    culled = data.occ is not None
    if culled != is_culled(b):
        raise RuntimeError("the program's map is not the one the traffic states")
    stage = tr["stage"]
    gen = step_generator(b.seed, dev)
    epoch = make_stage_epoch(port_cfg, stage, tx, h, w, tr["total_steps"], 1, world=world)
    losses, mu1 = [], None
    for k in range(tr["check_steps"]):
        m = epoch(state, data, gen)
        losses.append({t: float(m[t]) for t in checks.LOSS_TERMS})
        if k == 0:
            mu1 = state.opt_states[stage].mu.clone()
    p_check = state.p_flat.clone()
    epoch.steps_per_epoch = n = tr["steps_per_epoch"]
    b.sync()
    setup_s = time.time() - b.t0

    rays_step = port_cfg.train.rays_per_batch * ipb * world
    steps = bad = 0
    trace = None
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    losses_seen = []

    def one_epoch():
        losses_seen.append(float(epoch(state, data, gen)["loss"]))    # the epoch-end read

    t0 = time.perf_counter()
    while True:
        if b.trace and trace is None and steps > 0:     # the window's second epoch
            trace = profiling.record(one_epoch, b.sync)
        else:
            one_epoch()
        steps += n
        bad += 0 if math.isfinite(losses_seen[-1]) else n
        done = time.perf_counter() - t0 >= b.seconds and (not b.trace or trace is not None)
        flag.fill_(int(done))
        if world > 1:
            dist.broadcast(flag, 0)
        if int(flag):
            break
    window_s = time.perf_counter() - t0

    out = {"attempted": steps, "failed": bad, "setup_s": setup_s,
           "e2e": {"train_rays_per_s": steps * rays_step / window_s, "setup_s": setup_s}}
    if trace is not None:
        s = profiling.summary(trace, b.layer_maps)
        rays_rank = port_cfg.train.rays_per_batch * ipb
        passes = flops.train_kernel_passes(cfg, rays_rank, culled)
        s.update(kind="train", units=n, world=world,
                 flops_per_unit=flops.train_step_flops(cfg, rays_rank, culled),
                 bound_s_per_unit=flops.least_time(passes))
        ranks = [s]
        if world > 1:
            ranks = [None] * world
            dist.all_gather_object(ranks, s)
        out["trace"] = ranks
    out["peak"] = _rank_max(float(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda"
                            else 0.0, world, dev)

    # the program's readings, then its state freed before the reference runs
    names = [(k, p.shape) for k, p in state.params.named_parameters()]
    rank_gap = 0.0
    if world > 1:
        every = [torch.empty_like(p_check) for _ in range(world)]
        dist.all_gather(every, p_check)
        rank_gap = max(float((e - every[0]).abs().max()) for e in every)
    prog = {"loss": losses, "grad": checks.leaves(mu1 / (1.0 - ref_train.B1), names),
            "params": checks.leaves(p_check, names)}
    epoch.release()
    del epoch, state, data, tx, mu1, p_check
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if rank != 0:
        return out
    out["readings"] = dict(reference_readings(b, scene, prog, culled), rank_gap=rank_gap)
    return out


def is_culled(b) -> bool:
    """Whether the steps' coarse pass samples the occupancy map: the
    importance mode on the traffic's all-occupied prior."""
    return b.config["train"]["fine_mode"] == "importance" and b.traffic["map"] == "uniform_prior"


def reference_draws(b, culled: bool, steps: int):
    """The draws of the program's first ``steps`` steps, from the same
    generator: every rank's block, the global batch."""
    cfg, tr = b.config, b.traffic
    sc = tr["scene"]
    gen = step_generator(b.seed, b.device)
    return [draw_step(cfg["nerf"], cfg["train"], sc["n_images"], sc["img_h"], sc["img_w"], culled,
                      tr["images_per_batch"] * tr["world"], gen) for _ in range(steps)]


def follow(b, scene, culled: bool, prec: str = "fp32", fault=None) -> dict:
    """The reference's run over the program's first steps."""
    no_tf32()
    cfg, tr = b.config, b.traffic
    occ = None
    if culled:
        g = cfg["nerf"]["occ_grid_size"]
        occ = torch.ones((g * g, g), device=b.device)      # the all-occupied prior
    return ref_train.follow(scene.params, cfg, tr["scene"], scene.images_u8, scene.detections,
                            reference_draws(b, culled, tr["check_steps"]), tr["start_step"],
                            tr["total_steps"], occ, prec, fault)


def reference_readings(b, scene, prog: dict, culled: bool) -> dict:
    ref = follow(b, scene, culled)
    return checks.train_readings(prog, ref, scene.params)
