"""Where one demo frame spends its time on the card.

    python3 -m mc_nerf_torch.tools.profile_frame [--frames N] [--top K] [--grid] [--graph]
                                                 [--side S]

Renders ``--frames`` frames of ``--side`` x ``--side`` pixels (800 by
default; after a warm-up frame) with the library's default ``Config()``,
the seeded test scene and the occupancy refresh, as ``chip_smoke.py``
does, under ``torch.profiler`` (``--grid``: the grid fine mode, 128
uniform coarse and 130 fine samples per ray, no occupancy map, as
``chip_smoke.py``'s grid demo), through the chunk loop; with ``--graph``
also through the frame captured as a CUDA graph and replayed
(``train/steps.py::FrameRender``; its warm-up frame captures the graph), the
routes in turns (loop, graph, graph, loop).  Prints the card's name and
power limit and, per route and turn, the wall time per frame, the summed
device time of every CUDA kernel by name (top K) and the device's busy
share (summed kernel time over wall time; kernels on one stream do not
overlap); for the graph, the capture's seconds and the memory it
reserved.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess

import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--grid", action="store_true")
    ap.add_argument("--graph", action="store_true")
    ap.add_argument("--side", type=int, default=800)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")

    from mc_nerf_torch.config import Config
    from mc_nerf_torch.tools.profile_step import profile_steps
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
    h = w = args.side
    poses, K = orbit_views((0.3,), h, w)
    occ = None if args.grid else refresh_occupancy(params, cfg, dev, 0)
    frame = (params, poses[0], K, occ)
    renders = {"loop": make_render_fn(cfg, h, w, device=dev, graph=False)}
    if args.graph:
        renders["graph"] = make_render_fn(cfg, h, w, device=dev, graph=True)
    for render in renders.values():       # warm-up frames (the graph's capture)
        render(*frame)
    torch.cuda.synchronize()
    turns = ("loop", "graph", "graph", "loop") if args.graph else ("loop",)
    print(f"card: {card}")
    results = []
    for route in turns:
        wall, rows, _ = profile_steps(lambda: renders[route](*frame), args.frames)
        busy = sum(r[0] for r in rows)
        print(f"{h}x{w} frame ({cfg.eval.fine_mode} fine mode, {route}): {wall:.3f} ms wall, "
              f"{busy:.3f} ms of CUDA kernels (busy share {busy / wall:.3f})")
        for ms, n, name in rows[: args.top]:
            print(f"{ms:10.3f} ms {n:6d} x  {name[:110]}")
        results.append({"route": route, "frame_ms": wall, "kernel_ms": busy,
                        "busy_share": busy / wall, "kernels": sum(n for _, n, _ in rows),
                        "top": [{"ms": ms, "calls": n, "name": name}
                                for ms, n, name in rows[: args.top]]})
    captures = {str(k): v for k, v in renders["graph"].captures.items()} if args.graph else {}
    if captures:
        print(f"graph captures (warm-up s, capture s, MiB reserved): {captures}")
    print(json.dumps({"side": h, "fine_mode": cfg.eval.fine_mode, "card": card,
                      "turns": results, "captures": captures}))


if __name__ == "__main__":
    main()
