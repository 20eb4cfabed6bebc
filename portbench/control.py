"""The readings the limits of ``correct`` are set from, on the card at the
cell's own size, one JSON line a seed:

    python3 -m portbench.control --workload <name> --seeds <n> [<n> ...]

For each seed: ``lower``, the run's own readings (the program's timed
path, one epoch or a few frames of window, against the fp32 reference);
``control``, the reference computed with its products in the nearest
precision below the configuration's bf16 (fp8 e4m3, one scale a tensor)
against the fp32 reference; and for a train cell ``half_batch``, the
reference with its RGB means over half the rays (the fault of a step
that leaves out half of the batch).  A step that returns its state
unchanged reads 1 in the change by definition and needs no run.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from portbench import checks
from portbench.runners import frame as frame_runner
from portbench.runners import train as train_runner
from portbench.run import Run, join_ranks, launch_ranks, leave_ranks, load
from portbench.scene import make_scene, nerf_weights


def readings(workload: str, seed: int, device, rank: int = 0, frames: int = 2) -> dict:
    """One seed's lower, control and fault readings (see the module); on
    ranks other than 0, only the program's part of the run."""
    b = Run(workload, seed, 0.0, False, device, time.time(), rank)
    if b.traffic["runner"] == "train":
        out = train_runner.run(b)
        if rank != 0:
            return {}
        scene = make_scene(b.config["nerf"], b.traffic["scene"], seed, device)
        culled = train_runner.is_culled(b)
        ref = train_runner.follow(b, scene, culled)
        planted = {"control": ("fp8", None), "half_batch": ("fp32", "half_batch")}
        got = {"lower": out["readings"]}
        for name, (prec, fault) in planted.items():
            got[name] = checks.train_readings(train_runner.follow(b, scene, culled, prec, fault),
                                              ref, scene.params)
    else:
        out = frame_runner.run(b)
        raw = nerf_weights(b.config["nerf"], seed, device)
        poses, K = frame_runner.views(b.traffic, device)
        vs = torch.randperm(poses.shape[0], generator=torch.Generator().manual_seed(seed))[:frames]
        ref = frame_runner.render_views(b, raw, vs.tolist(), poses, K)
        low = frame_runner.render_views(b, raw, vs.tolist(), poses, K, "fp8")
        got = {"lower": out["readings"], "control": checks.frame_readings(list(zip(low, ref)))}
    for v in got.values():
        v.pop("left_out", None)
    return got


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    need = load("workloads", args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench.control: {args.workload} takes {need} CUDA card(s)", file=sys.stderr)
        return 2
    if need > 1 and "RANK" not in os.environ:
        rc, text = launch_ranks("portbench.control", argv, need)
        print(text, end="", flush=True)
        return rc
    dev, rank = join_ranks(need)
    try:
        for seed in args.seeds:
            got = readings(args.workload, seed, dev, rank)
            if rank == 0:
                print(json.dumps({"workload": args.workload, "seed": seed, **got}), flush=True)
    finally:
        leave_ranks(need)
    return 0


if __name__ == "__main__":
    sys.exit(main())
