"""Where one GLOBAL_OPTIM (or FINE_TUNE) train step spends its time on the card.

    python3 -m mc_nerf_torch.tools.profile_step [--steps N] [--top K] [--plain] [--grid]
                                                [--remat] [--stage 2] [--coarse-free]
                                                [--graph]

Takes ``--steps`` stage-1 steps (after two warm-up steps) at the library's
default ``Config()`` on the workload of ``tools/scene.train_workload``
(the one ``bench.py`` times: 7000 rays from one of 110 800x800 images,
culled 48 coarse + 32 fine samples) under ``torch.profiler``; prints the
card's name and power limit, the wall time per step, the summed device
time of every CUDA kernel by name (top K), and the device's busy share
(summed kernel time over wall time; kernels on one stream do not
overlap).  ``--plain`` profiles the plain route instead of the kernels;
``--grid`` the grid fine mode (128 uniform coarse samples, 26 bins x 5
fine samples per ray, no occupancy map) instead of the importance mode;
``--remat`` sets ``remat_shade`` (the shading passes recomputed in the
backward); ``--stage 2`` takes FINE_TUNE steps; ``--coarse-free`` takes
them under the hybrid schedule (``coarse_free_from_stage=2``,
``cf_uniform_samples=8``, the bitpacked map: the fine pass alone, from
the occupancy PMF).

``--graph`` takes the steps as epochs of ``--steps`` steps
(``train/steps.py:make_stage_epoch``) on both routes: the loop of eager
steps and the step captured once as a CUDA graph and replayed; it times
both in turns (loop, graph, graph, loop; host clock around a
synchronized epoch) and profiles one epoch of each, per step
(:func:`routes_in_turns` and :func:`profile_routes`).  In the importance
mode the occupancy refresh (``train/engine.py:refresh_grid`` and
``sampler_map`` from the coarse MLP: fresh, then the EMA-max) is timed on
its own as well, with CUDA events.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

# the order in which the two routes of an epoch are timed
TURNS = ("loop", "graph", "graph", "loop")
# the calls profile_fullest profiles to read one: the profiler lost a
# record in 1 of 16 replays of the hash-grid frame's graph (~5,000
# kernels, on an H100; PERF.md section 6), so three all lose one about
# once in 4,000
FULLEST_OF = 3


def profile_steps(step, n: int, steps_per_call: int = 1):
    """Run ``step()`` n times under the profiler, each call taking
    ``steps_per_call`` steps: (wall ms per step, [(device ms per step,
    calls per step, kernel name)] sorted by time, the same for host
    operations by self CPU time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n
    n *= steps_per_call
    wall /= steps_per_call
    # kernels only: a CPU-side op also reports its kernels' device time
    rows = [(e.self_device_time_total / n / 1e3, e.count // n, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    host = [(e.self_cpu_time_total / n / 1e3, e.count // n, e.key)
            for e in prof.key_averages() if e.self_cpu_time_total > 0]
    host.sort(reverse=True)
    return wall * 1e3, rows, host


def profile_fullest(step: Callable, steps_per_call: int = 1,
                    after: Optional[Callable] = None) -> list:
    """The kernel rows of :func:`profile_steps` for one call of ``step()``
    (taking ``steps_per_call`` steps), from the fullest of ``FULLEST_OF``
    calls each profiled on its own (``after()`` runs after each, outside
    the profiler).  For a launch count: a call of the same CUDA graph, or of
    the same eager step, launches the same kernels every time, and the
    profiler may lose a kernel's record but never adds one, so the call
    with the most kernel records reads the launches best.  A count from
    it is never above the launches, and is short of them only if every
    call lost a record of that kernel.  The number of calls is fixed, not
    a retry until some count comes out: ranks that run collectives in
    ``step`` stay in step."""
    best = None
    for _ in range(FULLEST_OF):
        _, rows, _ = profile_steps(step, 1, steps_per_call)
        if after is not None:
            after()
        if best is None or sum(r[1] for r in rows) > sum(r[1] for r in best):
            best = rows
    return best


def routes_in_turns(epochs: Dict[str, Callable], run: Callable,
                    steps: int) -> Dict[str, List[float]]:
    """Both routes of an epoch of ``steps`` steps, timed in turns.
    ``epochs`` maps "loop" and "graph" to their epoch functions;
    ``run(ep)`` runs one epoch of ``ep``.  Each route's first epoch (the
    graph's warm-up and capture) runs untimed, then ``TURNS``, each on the
    host's clock around a synchronized epoch.  Returns {route: [ms a step,
    one a turn, in the order timed]}."""
    def once(route):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(epochs[route])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    for route in epochs:
        once(route)
    turns = {route: [] for route in epochs}
    for route in TURNS:
        turns[route].append(once(route))
    return turns


def profile_routes(epochs: Dict[str, Callable], run: Callable, steps: int) -> dict:
    """One epoch of each route of ``epochs`` under the profiler
    (``run(ep)`` runs one epoch of ``steps`` steps): {route: wall ms a
    step, device ms of kernels a step, the busy share, kernels a step and
    the kernel rows of :func:`profile_steps` (a CUDA graph's kernel nodes
    are reported one by one)}."""
    out = {}
    for route, ep in epochs.items():
        wall, rows, _ = profile_steps(lambda: run(ep), 1, steps)
        busy = sum(r[0] for r in rows)
        out[route] = {"step_ms": wall, "kernel_ms": busy, "busy_share": busy / wall,
                      "kernels_a_step": sum(r[1] for r in rows), "rows": rows}
    return out


def count_named(rows, names: Sequence[str]) -> Dict[str, int]:
    """{name: calls} over the kernel rows of :func:`profile_steps` whose
    kernel name holds ``name`` as a word, for each of ``names`` found."""
    named = {k: sum(c for _, c, nm in rows if re.search(r"\b" + k + r"\b", nm)) for k in names}
    return {k: v for k, v in named.items() if v}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--grid", action="store_true")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--stage", type=int, choices=(1, 2), default=1)
    ap.add_argument("--coarse-free", action="store_true")
    ap.add_argument("--graph", action="store_true")
    args = ap.parse_args()
    stage = 2 if args.coarse_free else args.stage
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")

    from mc_nerf_torch.config import Config
    from mc_nerf_torch.tools.scene import STEPS_PER_EPOCH, TOTAL_STEPS, train_workload
    from mc_nerf_torch.train.optim import build_optimizers, counter, flatten_params
    from mc_nerf_torch.train.steps import (
        TrainState, draw_step, make_stage_epoch, make_stage_step)

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    cfg = Config()
    if args.plain:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, use_pallas=False))
    if args.grid or args.remat:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, fine_mode="grid" if args.grid else cfg.train.fine_mode,
            remat_shade=args.remat))
    if args.coarse_free:
        cfg = dataclasses.replace(cfg, nerf=dataclasses.replace(
            cfg.nerf, coarse_free=True, coarse_free_from_stage=2, cf_uniform_samples=8,
            occ_map_dtype="bitpack"))
    params, data = train_workload(cfg, 0, dev)
    p_flat = flatten_params(params)
    txs, states = build_optimizers(cfg, params, p_flat, STEPS_PER_EPOCH)
    state = TrainState(params, p_flat, states, counter(TOTAL_STEPS // 2, dev))
    gen = torch.Generator(device=dev).manual_seed(0)
    n_img = data.images_u8.shape[0]
    label = (f"stage-{stage} step ({'plain' if args.plain else 'kernel'} route, "
             f"{cfg.train.fine_mode} fine mode, coarse-free {cfg.nerf.coarse_free_at(stage)}, "
             f"remat_shade {cfg.train.remat_shade})")
    print(f"card: {card}")
    out = {"fine_mode": cfg.train.fine_mode, "remat_shade": cfg.train.remat_shade,
           "plain": args.plain, "stage": stage, "coarse_free": cfg.nerf.coarse_free_at(stage),
           "card": card}

    if args.graph:
        epochs = {route: make_stage_epoch(cfg, stage, txs[stage], 800, 800, TOTAL_STEPS,
                                          args.steps, graph=route == "graph")
                  for route in ("loop", "graph")}

        def run(ep):
            ep(state, data, gen)

        turns = routes_in_turns(epochs, run, args.steps)
        print(f"{label}, {args.steps} steps an epoch; ms a step in turns (loop, graph, graph, "
              f"loop): {turns['loop'][0]:.3f}, {turns['graph'][0]:.3f}, "
              f"{turns['graph'][1]:.3f}, {turns['loop'][1]:.3f}")
        out["turns_ms"] = turns
        for route, prof in profile_routes(epochs, run, args.steps).items():
            rows = prof.pop("rows")
            print(f"{route}: {prof['step_ms']:.3f} ms wall a step under the profiler, "
                  f"{prof['kernel_ms']:.3f} ms of CUDA kernels (busy share "
                  f"{prof['busy_share']:.3f}), {prof['kernels_a_step']} kernels")
            for ms, n, name in rows[: args.top]:
                print(f"{ms:10.3f} ms {n:6d} x  {name[:110]}")
            out[route] = {**prof, "top": [{"ms": ms, "calls": n, "name": name}
                                          for ms, n, name in rows[: args.top]]}
    else:
        step_fn = make_stage_step(cfg, stage, txs[stage], 800, 800, TOTAL_STEPS)

        def step():
            step_fn(state, data, draw_step(cfg, stage, n_img, 800, 800, data.occ is not None,
                                           gen))

        for _ in range(2):
            step()
        wall, rows, host = profile_steps(step, args.steps)
        busy = sum(r[0] for r in rows)
        torch.cuda.reset_peak_memory_stats()
        step()
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"{label}: {wall:.1f} ms wall, {busy:.1f} ms of CUDA kernels (busy share "
              f"{busy / wall:.3f}); peak device memory {peak:.2f} GiB")
        for ms, n, name in rows[: args.top]:
            print(f"{ms:10.3f} ms {n:6d} x  {name[:110]}")
        print("host operations by self CPU time:")
        for ms, n, name in host[:10]:
            print(f"{ms:10.3f} ms {n:6d} x  {name[:110]}")
        out.update({"step_ms": wall, "kernel_ms": busy, "busy_share": busy / wall,
                    "peak_gib": peak, "top": [{"ms": ms, "calls": n, "name": name}
                                              for ms, n, name in rows[: args.top]]})
    if data.occ is not None:
        out["refresh_ms"] = time_refresh(params.nerf, cfg, dev)
        print(f"occupancy refresh (G={cfg.nerf.occ_grid_size}, from the coarse MLP): fresh "
              f"{out['refresh_ms']['fresh']:.3f} ms, EMA-max {out['refresh_ms']['ema']:.3f} ms")
    print(json.dumps(out))


def time_refresh(nerf_params, cfg, dev, iters: int = 5) -> dict:
    """ms of one occupancy refresh with its sampler map
    (``train/engine.py:refresh_grid`` + ``sampler_map``), fresh and
    EMA-max, CUDA events over ``iters`` calls after one."""
    from mc_nerf_torch.ops.occupancy import sampler_map
    from mc_nerf_torch.train.engine import refresh_grid

    grid = refresh_grid(nerf_params, cfg, dev, 0)
    out = {}
    for kind, prior in (("fresh", None), ("ema", grid)):
        sampler_map(refresh_grid(nerf_params, cfg, dev, 1, prior), cfg.nerf)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            sampler_map(refresh_grid(nerf_params, cfg, dev, 2 + i, prior), cfg.nerf)
        end.record()
        end.synchronize()
        out[kind] = start.elapsed_time(end) / iters
    return out


if __name__ == "__main__":
    main()
