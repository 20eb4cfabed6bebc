"""The readings the hash-grid cell's limits are set from, on the card at
the cell's own size, one JSON line a seed (``control.py``'s, for the
runner ``train_ngp``):

    python3 -m portbench.control_ngp --workload train.ngp --seeds <n> [<n> ...]

For each seed: ``lower``, the run's own readings (the program's timed
path against the fp32 reference); ``control``, the reference with its
products in fp8 (e4m3, one scale a tensor), the nearest precision below
the configuration's bf16, against the fp32 reference; ``half_batch``,
the reference with its RGB mean over half the rays.  A step that returns
its state unchanged reads 1 in the change by definition.  Besides, once
a call, ``frame``: one 800x800 eval frame of the seeded field through the
port's ``make_render_fn`` (its map refreshed, as the demo does) against
the reference's, the widest and the mean rgb gap (``control`` the
reference in fp8).  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import checks
from portbench.program import make_render_fn, port_config, refresh_occupancy, train_setup
from portbench.reference import ngp as ref_ngp
from portbench.run import Run
from portbench.runners import train_ngp
from portbench.scene import orbit_views
from portbench.scene_ngp import make_scene


def readings(workload: str, seed: int, device) -> dict:
    b = Run(workload, seed, 0.0, False, device, time.time())
    got = {"lower": train_ngp.run(b)["readings"]}
    scene = make_scene(b.config["nerf"], b.traffic["scene"], seed, device)
    ref = train_ngp.follow(b, scene)
    for name, (prec, fault) in {"control": ("fp8", None),
                                "half_batch": ("fp32", "half_batch")}.items():
        got[name] = train_ngp.ngp_readings(train_ngp.follow(b, scene, prec, fault), ref,
                                           scene.params)
    for v in got.values():
        v.pop("left_out", None)
    return got


def frame(workload: str, seed: int, device, side: int = 800) -> dict:
    """One eval frame of the seeded field, the program's against the
    reference's (and the fp8 reference's)."""
    b = Run(workload, seed, 0.0, False, device, time.time())
    sc = dict(b.traffic["scene"], img_h=side, img_w=side)
    scene = make_scene(b.config["nerf"], sc, seed, device)
    cfg = port_config(b.config)
    state, _, _ = train_setup(scene.params, scene.images_u8, scene.detections, cfg, b.traffic,
                              device)
    occ = refresh_occupancy(state.params.nerf, cfg, device, 0)
    poses, K = orbit_views(sc["n_images"], side, side, sc["radius"], sc["elevation"])
    v = seed % sc["n_images"]
    pose = torch.as_tensor(poses[v], dtype=torch.float32, device=device)
    K = torch.as_tensor(K, dtype=torch.float32, device=device)
    render = make_render_fn(cfg, side, side, device=device)
    rgb = render(state.params.nerf, pose, K, occ)[0]
    t0 = time.perf_counter()
    render(state.params.nerf, pose, K, occ)[0].cpu()
    ms = (time.perf_counter() - t0) * 1e3
    render.release()
    out = {"view": v, "frame_ms": ms}
    ref_occ = train_ngp.reference_map(b, scene.params)
    fp32 = ref_ngp.render(scene.params, b.config, pose, K, side, side, ref_occ)[0]
    for name, other in (("lower", rgb),
                        ("control", ref_ngp.render(scene.params, b.config, pose, K, side, side,
                                                   train_ngp.reference_map(b, scene.params,
                                                                           "fp8"), "fp8")[0])):
        out[name] = checks.frame_readings([(other, fp32)])
    out["map_cells_differ"] = int((occ.float() != ref_occ).sum())
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="train.ngp")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frame", action="store_true", help="also one 800x800 frame, first seed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control_ngp: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **readings(args.workload, seed, dev)}), flush=True)
    if args.frame:
        print(json.dumps({"frame": frame(args.workload, args.seeds[0], dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
