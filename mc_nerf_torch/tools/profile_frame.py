"""Where one 800x800 demo frame spends its time on the card.

    python3 -m mc_nerf_torch.tools.profile_frame [--frames N] [--top K] [--grid]

Renders ``--frames`` frames (after a warm-up frame) with the library's
default ``Config()``, the seeded test scene and the occupancy refresh, as
``chip_smoke.py`` does, under ``torch.profiler`` (``--grid``: the grid fine
mode, 128 uniform coarse and 130 fine samples per ray, no occupancy map,
as ``chip_smoke.py``'s grid demo); prints the card's name
and power limit, the wall time per frame, the summed device time of every
CUDA kernel by name (top K), and the device's busy share (summed kernel
time over wall time; kernels on one stream do not overlap).  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--grid", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mc_nerf_torch.config import Config
    from mc_nerf_torch.tools.scene import orbit_views, scene_params
    from mc_nerf_torch.train.engine import refresh_occupancy
    from mc_nerf_torch.train.steps import make_render_fn

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    cfg = Config()
    if args.grid:
        cfg = dataclasses.replace(cfg, eval=dataclasses.replace(cfg.eval, fine_mode="grid"))
    params = scene_params(cfg.nerf, 0, device=dev)
    h = w = 800
    poses, K = orbit_views((0.3,), h, w)
    pose = poses[0]
    render = make_render_fn(cfg, h, w, device=dev)
    occ = None if args.grid else refresh_occupancy(params, cfg, dev, 0)
    render(params, pose, K, occ)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.frames):
            render(params, pose, K, occ)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.frames

    # kernels only: a CPU-side op also reports its kernels' device time
    rows = [(e.self_device_time_total / args.frames / 1e3, e.count // args.frames, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"card: {card}")
    print(f"frame ({cfg.eval.fine_mode} fine mode): {wall * 1e3:.1f} ms wall, {busy:.1f} ms of "
          f"CUDA kernels (busy share {busy / (wall * 1e3):.3f})")
    for ms, n, name in rows[: args.top]:
        print(f"{ms:10.3f} ms {n:6d} x  {name[:110]}")
    print(json.dumps({"frame_ms": wall * 1e3, "kernel_ms": busy, "fine_mode": cfg.eval.fine_mode,
                      "busy_share": busy / (wall * 1e3), "card": card,
                      "top": [{"ms": ms, "calls": n, "name": name}
                              for ms, n, name in rows[: args.top]]}))


if __name__ == "__main__":
    main()
