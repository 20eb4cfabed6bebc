"""The hash-grid train runner: GLOBAL_OPTIM steps of the ``field:
hashgrid`` field (coarse-free, its samples from the occupancy PMF)
through the port's compiled epoch (``make_stage_epoch``, one CUDA graph a
step, replayed), on one card.

As ``runners/train.py`` for the MLP pair, with the field's own inputs
(``scene_ngp.py``), its occupancy map refreshed once in set-up from the
seeded field (``refresh_occupancy``, epoch 0's jitter, as the frame cell
does), its own operations and bytes (``flops_ngp.py``: the model FLOPs,
and the hash encode's least time a step, which ``roofline_share.hashgrid``
reads), and its own reference (``reference/ngp.py``).  Its check compares
the intrinsic and the RGB loss terms (there is no coarse pass; the
samples come from the map, which no precision moves), the first step's
gradient and the change over the steps, leaf by leaf (``checks.py``).
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from portbench import checks, flops_ngp, profiling
from portbench.program import make_stage_epoch, port_config, refresh_occupancy, train_setup
from portbench.reference import ngp as ref_ngp
from portbench.reference.nerf import no_tf32
from portbench.reference.train import B1
from portbench.scene import step_generator
from portbench.scene_ngp import draw_step, make_scene

# the loss terms compared: the intrinsic reprojection loss and the RGB loss
COMPARED_TERMS = ("loss_intr", "loss_rgb_f")


def run(b) -> dict:
    """One run of the cell (see the module); ``b`` the run's settings
    (:class:`portbench.run.Run`)."""
    cfg, tr, dev = b.config, b.traffic, b.device
    if tr["world"] != 1:
        raise ValueError("the hash-grid runner takes one card")
    port_cfg = port_config(cfg, tr["images_per_batch"])      # refuses a port without the field
    sc = tr["scene"]
    h, w = sc["img_h"], sc["img_w"]
    scene = make_scene(cfg["nerf"], sc, b.seed, dev)
    state, data, tx = train_setup(scene.params, scene.images_u8, scene.detections, port_cfg, tr,
                                  dev)
    data = data._replace(occ=refresh_occupancy(state.params.nerf, port_cfg, dev, 0))
    stage = tr["stage"]
    gen = step_generator(b.seed, dev)
    epoch = make_stage_epoch(port_cfg, stage, tx, h, w, tr["total_steps"], 1)
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

    rays_step = port_cfg.train.rays_per_batch * tr["images_per_batch"]
    steps = bad = 0
    trace = None
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
        if time.perf_counter() - t0 >= b.seconds and (not b.trace or trace is not None):
            break
    window_s = time.perf_counter() - t0

    out = {"attempted": steps, "failed": bad, "setup_s": setup_s,
           "e2e": {"train_rays_per_s": steps * rays_step / window_s, "setup_s": setup_s}}
    if trace is not None:
        s = profiling.summary(trace, b.layer_maps)
        s.update(kind="train", units=n, world=1,
                 flops_per_unit=flops_ngp.train_step_flops(cfg, rays_step),
                 bound_s_per_unit=0.0,       # no pass of K2-K5 runs
                 hashgrid_bound_s_per_unit=flops_ngp.least_time(
                     flops_ngp.encode_passes(cfg, rays_step)))
        out["trace"] = [s]
    out["peak"] = float(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0.0

    # the program's readings, then its state freed before the reference runs
    names = [(k, p.shape) for k, p in state.params.named_parameters()]
    prog = {"loss": losses, "grad": checks.leaves(mu1 / (1.0 - B1), names),
            "params": checks.leaves(p_check, names)}
    epoch.release()
    del epoch, state, data, tx, mu1, p_check
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["readings"] = dict(ngp_readings(prog, follow(b, scene), scene.params), rank_gap=0.0)
    return out


def reference_map(b, raw: dict, prec: str = "fp32") -> torch.Tensor:
    """The reference's own occupancy map of the seeded field, with the
    refresh's lattice jitter (the program's rule: a generator seeded from
    ``train.seed`` and epoch 0)."""
    nc = b.config["nerf"]
    g = nc["occ_grid_size"]
    st = np.random.SeedSequence([(b.config["train"]["seed"] ^ 0x0CC) & 0xFFFFFFFFFFFFFFFF, 0])
    seed = int(st.generate_state(1, np.uint64)[0]) & 0x7FFFFFFFFFFFFFFF
    gen = torch.Generator(device=b.device).manual_seed(seed)
    jitter = torch.rand((g ** 3, 3), generator=gen, device=b.device)
    return ref_ngp.occupancy_map(raw, nc, jitter, prec)


def follow(b, scene, prec: str = "fp32", fault=None) -> dict:
    """The reference's run over the program's first steps, from the same
    generator, its map its own."""
    no_tf32()
    cfg, tr = b.config, b.traffic
    sc = tr["scene"]
    gen = step_generator(b.seed, b.device)
    draws = [draw_step(cfg["nerf"], cfg["train"], sc["n_images"], sc["img_h"], sc["img_w"],
                       tr["images_per_batch"], gen) for _ in range(tr["check_steps"])]
    return ref_ngp.follow(scene.params, cfg, sc, scene.images_u8, scene.detections, draws,
                          tr["start_step"], tr["total_steps"],
                          reference_map(b, scene.params, prec), prec, fault)


def ngp_readings(prog: dict, ref: dict, params0: dict) -> dict:
    """``checks.train_readings`` over the field's terms: ``loss_gap`` the
    worst relative gap of :data:`COMPARED_TERMS` over the steps,
    ``grad_gap`` and ``change_gap`` the worst leaf's."""
    rel = lambda t: max(abs(p[t] - r[t]) / abs(r[t]) for p, r in zip(prog["loss"], ref["loss"]))
    keep, left_out = checks.counted_leaves(ref["grad"])
    dev = next(iter(ref["grad"].values())).device
    grad = checks.leaf_gaps({k: v.to(dev) for k, v in prog["grad"].items()}, ref["grad"], keep)
    change = checks.leaf_gaps({k: prog["params"][k].to(dev) - params0[k] for k in keep},
                              {k: ref["params"][k] - params0[k] for k in keep}, keep)
    g_leaf, c_leaf = max(grad, key=grad.get), max(change, key=change.get)
    return {"loss_gap": max(rel(t) for t in COMPARED_TERMS), "loss_total_gap": rel("loss"),
            **{f"{t}_gap": rel(t) for t in COMPARED_TERMS},
            "grad_gap": grad[g_leaf], "change_gap": change[c_leaf],
            "grad_gap_median": float(np.median(list(grad.values()))),
            "change_gap_median": float(np.median(list(change.values()))),
            "grad_leaf": g_leaf, "change_leaf": c_leaf, "left_out": left_out}
