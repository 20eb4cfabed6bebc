"""Where one GLOBAL_OPTIM train step spends its time on the card.

    python3 -m mc_nerf_torch.tools.profile_step [--steps N] [--top K] [--plain] [--grid]
                                                [--remat]

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
backward).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import torch


def profile_steps(step, n: int):
    """Run ``step()`` n times under the profiler: (wall ms per step,
    [(device ms per step, calls per step, kernel name)] sorted by time,
    the same for host operations by self CPU time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n
    # kernels only: a CPU-side op also reports its kernels' device time
    rows = [(e.self_device_time_total / n / 1e3, e.count // n, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    host = [(e.self_cpu_time_total / n / 1e3, e.count // n, e.key)
            for e in prof.key_averages() if e.self_cpu_time_total > 0]
    host.sort(reverse=True)
    return wall * 1e3, rows, host


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--grid", action="store_true")
    ap.add_argument("--remat", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")

    from mc_nerf_torch.config import Config
    from mc_nerf_torch.tools.scene import STEPS_PER_EPOCH, TOTAL_STEPS, train_workload
    from mc_nerf_torch.train.optim import build_optimizers, flatten_params
    from mc_nerf_torch.train.steps import TrainState, draw_step, make_stage_step

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
    params, data = train_workload(cfg, 0, dev)
    p_flat = flatten_params(params)
    txs, states = build_optimizers(cfg, params, p_flat, STEPS_PER_EPOCH)
    state = TrainState(params, p_flat, states, TOTAL_STEPS // 2)
    step_fn = make_stage_step(cfg, 1, txs[1], 800, 800, TOTAL_STEPS)
    gen = torch.Generator(device=dev).manual_seed(0)
    n_img = data.images_u8.shape[0]

    def step():
        step_fn(state, data, draw_step(cfg, 1, n_img, 800, 800, data.occ is not None, gen))

    for _ in range(2):
        step()
    wall, rows, host = profile_steps(step, args.steps)
    busy = sum(r[0] for r in rows)
    print(f"card: {card}")
    torch.cuda.reset_peak_memory_stats()
    step()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"step ({'plain' if args.plain else 'kernel'} route, {cfg.train.fine_mode} fine "
          f"mode, remat_shade {cfg.train.remat_shade}): {wall:.1f} ms wall, "
          f"{busy:.1f} ms of CUDA kernels (busy share {busy / wall:.3f}); peak device memory "
          f"{peak:.2f} GiB")
    for ms, n, name in rows[: args.top]:
        print(f"{ms:10.3f} ms {n:6d} x  {name[:110]}")
    print("host operations by self CPU time:")
    for ms, n, name in host[:10]:
        print(f"{ms:10.3f} ms {n:6d} x  {name[:110]}")
    print(json.dumps({"step_ms": wall, "kernel_ms": busy, "busy_share": busy / wall,
                      "peak_gib": peak, "fine_mode": cfg.train.fine_mode,
                      "remat_shade": cfg.train.remat_shade, "plain": args.plain,
                      "card": card, "top": [{"ms": ms, "calls": n, "name": name}
                                            for ms, n, name in rows[: args.top]]}))


if __name__ == "__main__":
    main()
