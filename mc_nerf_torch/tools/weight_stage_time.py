"""Time the weight-gradient stage of the MLP backwards alone on a CUDA card.

    python3 -m mc_nerf_torch.tools.weight_stage_time [--iters N]

The stage (``launch_weight_grads`` in ``csrc/mlp_bwd.cuh``: dW = xin^T @ d_a
of every layer, summed over the points, and the bias reduction) is the same
code in K3, K5 and K6; it reads only the workspace the points kernel filled.
This fills that workspace once per shape through the whole ``fused_mlp``
backward (K6) on the seeded scene's weights, then times ``mlp_bwd_weights``
with CUDA events at the train passes' shapes: the coarse full 4x128 pack over
7000 x 48 points and the fine 8x256 pack over 7000 x 32 (the importance
step's, K3's shapes), the coarse over 7000 x 128 and the fine over 7000 x 130
(the grid step's, K5's).  Beside each time: ``floor_ms``, the stage's bytes
(``tools/bwd_check.weight_stage_bytes``) over 3.35 TB/s.  Prints the card's
name and power limit, then one JSON line.  Two checkouts timed in one call
compare two versions of the stage.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

PEAK_BYTES = 3.35e12   # H100 SXM HBM3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("weight_stage_time: needs a CUDA card")
    from mc_nerf_torch.config import NerfConfig
    from mc_nerf_torch.ops.cuda.fused_mlp import (
        _flat_weights, _mlp_bwd_launch, _workspace, encode_kernel_order, mlp_bwd_weights,
        mlp_plain, pack_mlp_params)
    from mc_nerf_torch.tools.bwd_check import mlp_cotangent, weight_stage_bytes
    from mc_nerf_torch.tools.scene import scene_params

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    nc = NerfConfig()
    params = scene_params(nc, 0, device=dev)
    rng = np.random.default_rng(0)
    out = {}
    for label, mlp, depth, width, skips, s in (
            ("importance coarse", params.coarse, nc.coarse_depth, nc.coarse_width,
             nc.coarse_skips, 48),
            ("importance fine", params.fine, nc.fine_depth, nc.fine_width, nc.fine_skips, 32),
            ("grid coarse", params.coarse, nc.coarse_depth, nc.coarse_width, nc.coarse_skips, 128),
            ("grid fine", params.fine, nc.fine_depth, nc.fine_width, nc.fine_skips, 130)):
        p = 7000 * s
        packed = pack_mlp_params(mlp, nc.emb_freqs_xyz, skips)
        ws, bs = _flat_weights(packed)
        xyz = torch.as_tensor(rng.uniform(-3.5, 3.5, (p, 3)), dtype=torch.float32, device=dev)
        feat = encode_kernel_order(xyz, nc.emb_freqs_xyz)
        dout = mlp_cotangent(mlp_plain(packed, feat, depth, skips))
        work = _workspace(p, feat.shape[1], ws, skips, False, dev)
        _mlp_bwd_launch(ws, bs, feat, dout, depth, skips, work)
        mlp_bwd_weights(ws, bs, feat, skips, False, work)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            mlp_bwd_weights(ws, bs, feat, skips, False, work)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / args.iters
        floor = weight_stage_bytes(feat.shape[1], depth, width, skips, ws[-2].shape[1], p)
        out[label] = {"points": p, "ms": ms, "floor_ms": floor / PEAK_BYTES * 1e3}
        print(f"{label} ({p} points): {ms:.3f} ms, floor {floor / PEAK_BYTES * 1e3:.3f} ms",
              flush=True)
        del work, dout, feat
    print(json.dumps({"weight_stage": out, "card": card}))


if __name__ == "__main__":
    main()
