"""Time the points stage of the K3, K5 and K6 backwards alone, and the
forwards K1, K2 and K4, on a CUDA card.

    python3 -m mc_nerf_torch.tools.points_stage_time [--iters N] [--only K3 K4 ...]
        [--against DIR ...]

The points stage of K5 and K6 (``mcn_mlp_bwd_points`` in
``csrc/fused_mlp_bwd.cu``: the recompute, the heads-and-trunk backward and,
for K5, the per-ray dbasis sums; no weight stage) is timed with CUDA events
through ``mlp_bwd_points``, K3's (``fused_render``'s backward) through
``render_bwd_points`` (``mcn_render_bwd_points`` in
``csrc/fused_render_bwd.cu``), at the six train shapes: K5
(``fused_shaded_mlp``'s backward) at the grid step's coarse full 4x128 pack
over 7000 x 128 points and fine 8x256 pack over 7000 x 130; K6
(``fused_mlp``'s) and K3 at the importance step's, the coarse pack over
7000 x 48 and the fine over 7000 x 32, K3 with noise and the white
background on, as the train step runs it.  K4 (``fused_shaded_mlp``'s
forward, ``csrc/fused_shaded.cu``) is timed whole through
``fused_shaded_mlp`` at its three shapes: the grid step's coarse full
4x128 pass over 7000 x 128 points and fine 8x256 pass over 7000 x 130,
and the grid demo's eval chunk, 16384 x 130 at the fine pack; "K4 at K2"
runs it at K2's three shapes (the MLP and shading half of K2).  K2
(``fused_render``'s forward, ``csrc/fused_render.cu``) is timed whole
through ``fused_render`` at the importance step's coarse full 4x128 pass
over 7000 x 48 (noise, noise_sel and wsel, as the train step runs it) and
fine 8x256 pass over 7000 x 32 (noise), and at the importance demo's eval
chunk, 16384 x 32 (no noise).  K1 (``fused_mlp_apply``,
``csrc/fused_mlp.cu``) at the demos' sigma-only coarse 4x128 pass over an
eval chunk, 16384 x 128 (grid) and 16384 x 48 (importance), and as the
``fused_mlp`` VJP's forward, the coarse full pack over 7000 x 48 and the
fine over 7000 x 32.  The "... path" shapes time a frame's eval pass from
its rays and depths at the eval chunk (K1 at 48 and 128 samples, K2 at
32, K4 at 130): the rays entry point (``fused_mlp_apply_rays``,
``fused_render_rays``, ``fused_shaded_mlp_rays``: the encode in the
kernel) where the checkout has one, else ``encode_kernel_order`` of the
points and the feat entry point, as ``render_rays_eval`` ran them before.  Weights: the seeded scene
(``tools/scene.scene_params``); cotangents: ``tools/bwd_check``'s (K3's an
MSE's of the plain forward's rays).  Beside each time: ``bound_ms``, the
recompute and dX products the function needs over the bf16 peak (the
forwards: their forward products, and K2's and K4's shading over the fp32
peak; or their inputs and outputs over the memory rate, if longer), and
``floor_ms``, this design's bytes (``tools/bwd_check.points_stage_bytes``,
``render_points_stage_bytes``, ``shaded_forward_bytes``,
``render_forward_bytes``, ``mlp_forward_bytes``) over the memory rate.
``--only`` keeps the shapes whose label starts with one of its words.

``--against DIR`` adds other checkouts of the repository (unpacked into a
git-ignored directory, e.g. ``build/parent``): every checkout builds its
kernels first, all at once, then each is timed in its own process in turns
(this tree, the others, then the same in reverse order), so that versions
compare within one call on one card.  Prints the card's name and power limit,
each run's times, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12    # H100 SXM fp32 outside the tensor cores
RAYS = 7000
EVAL_RAYS = 16384          # rays of one eval chunk of the grid demo
# (label, pack, samples per ray, kind, rays, noise draws): K5 and K4 at the
# grid step's passes, K6 and K3 at the importance step's shapes, K4 also at
# the grid demo's eval chunk and at K2's shapes; K2 at the importance step's
# and demo's; K1 at both demos' (the sigma-only "coarse-sigma" pack) and
# the fused_mlp VJP's.  K2 with 2 draws (noise, noise_sel) emits wsel.
SHAPES = (("K5 coarse", "coarse", 128, "shaded", RAYS, 0),
          ("K5 fine", "fine", 130, "shaded", RAYS, 0),
          ("K6 coarse", "coarse", 48, "mlp", RAYS, 0), ("K6 fine", "fine", 32, "mlp", RAYS, 0),
          ("K3 coarse", "coarse", 48, "render", RAYS, 1),
          ("K3 fine", "fine", 32, "render", RAYS, 1),
          ("K4 coarse", "coarse", 128, "forward", RAYS, 0),
          ("K4 fine", "fine", 130, "forward", RAYS, 0),
          ("K4 eval", "fine", 130, "forward", EVAL_RAYS, 0),
          ("K4 at K2 coarse", "coarse", 48, "forward", RAYS, 0),
          ("K4 at K2 fine", "fine", 32, "forward", RAYS, 0),
          ("K4 at K2 eval", "fine", 32, "forward", EVAL_RAYS, 0),
          ("K2 coarse", "coarse", 48, "render_fwd", RAYS, 2),
          ("K2 fine", "fine", 32, "render_fwd", RAYS, 1),
          ("K2 eval", "fine", 32, "render_fwd", EVAL_RAYS, 0),
          ("K1 grid eval", "coarse-sigma", 128, "mlp_fwd", EVAL_RAYS, 0),
          ("K1 eval", "coarse-sigma", 48, "mlp_fwd", EVAL_RAYS, 0),
          ("K1 vjp coarse", "coarse", 48, "mlp_fwd", RAYS, 0),
          ("K1 vjp fine", "fine", 32, "mlp_fwd", RAYS, 0),
          ("K1 eval path", "coarse-sigma", 48, "mlp_path", EVAL_RAYS, 0),
          ("K1 grid eval path", "coarse-sigma", 128, "mlp_path", EVAL_RAYS, 0),
          ("K2 eval path", "fine", 32, "render_path", EVAL_RAYS, 0),
          ("K4 eval path", "fine", 130, "forward_path", EVAL_RAYS, 0))
ROOT = Path(__file__).resolve().parents[2]


def _shapes(only) -> tuple:
    return tuple(sh for sh in SHAPES if not only or any(sh[0].startswith(o) for o in only))


def _time_here(iters: int, only) -> dict:
    """Time the stage of the checkout on sys.path at every shape kept by
    ``only``: {label: ms}."""
    import numpy as np
    import torch

    from mc_nerf_torch.config import NerfConfig
    from mc_nerf_torch.models.sh import sh_basis
    from mc_nerf_torch.ops.cuda.fused_mlp import (
        BASIS_LANES, _flat_weights, _workspace, encode_kernel_order, fused_mlp_apply,
        fused_shaded_mlp, fused_shaded_mlp_plain, mlp_bwd_points, mlp_plain, pack_mlp_params)
    from mc_nerf_torch.ops.cuda.fused_render import (
        _bwd_fns, fused_render, fused_render_plain, render_bwd_points)
    from mc_nerf_torch.tools.bwd_check import mlp_cotangent, mse_cotangent, shaded_cotangent
    from mc_nerf_torch.tools.scene import scene_params

    try:
        from mc_nerf_torch.ops.cuda.fused_mlp import fused_mlp_apply_rays, fused_shaded_mlp_rays
        from mc_nerf_torch.ops.cuda.fused_render import fused_render_rays
    except ImportError:    # a checkout before the rays route: the encode, then feat
        fused_mlp_apply_rays = fused_shaded_mlp_rays = fused_render_rays = None

    dev = torch.device("cuda")
    nc = NerfConfig()
    params = scene_params(nc, 0, device=dev)
    nb = (nc.sh_deg + 1) ** 2
    out = {}
    for label, pack, s, kind, rays, draws in _shapes(only):
        mlp, depth, skips = ((params.fine, nc.fine_depth, nc.fine_skips) if pack == "fine"
                             else (params.coarse, nc.coarse_depth, nc.coarse_skips))
        rng = np.random.default_rng(s)
        d = torch.as_tensor(rng.normal(size=(rays, 3)), dtype=torch.float32, device=dev)
        d = d / d.norm(dim=-1, keepdim=True)
        z = torch.as_tensor(np.sort(rng.uniform(1.0, 8.0, (rays, s)), axis=-1),
                            dtype=torch.float32, device=dev)
        xyz = torch.tensor([0.0, 0.0, -4.0], device=dev) + d[:, None] * z[..., None]
        feat = encode_kernel_order(xyz.reshape(-1, 3), nc.emb_freqs_xyz)
        basis16 = torch.nn.functional.pad(sh_basis(nc.sh_deg, d),
                                          (0, BASIS_LANES - nb)).contiguous()
        packed = pack_mlp_params(mlp, nc.emb_freqs_xyz, skips, pack == "coarse-sigma")
        ws, bs = _flat_weights(packed)
        work = None
        o = torch.tensor([0.0, 0.0, -4.0], device=dev).expand(rays, 3).contiguous()

        def encoded():
            return encode_kernel_order((o[:, None] + d[:, None] * z[..., None]).reshape(-1, 3),
                                       nc.emb_freqs_xyz)
        if kind == "mlp_path":
            fn, args = ((lambda: fused_mlp_apply_rays(packed, o, d, z, depth, skips))
                        if fused_mlp_apply_rays else
                        (lambda: fused_mlp_apply(packed, encoded(), depth, skips))), ()
        elif kind == "render_path":
            fn, args = ((lambda: fused_render_rays(packed, o, d, basis16, z, depth, skips, s, nb,
                                                   nc.white_back))
                        if fused_render_rays else
                        (lambda: fused_render(packed, encoded(), basis16, z, None, None, depth,
                                              skips, s, nb, False, False, nc.white_back))), ()
        elif kind == "forward_path":
            fn, args = ((lambda: fused_shaded_mlp_rays(packed, o, d, z, basis16, depth, skips, s,
                                                       nb))
                        if fused_shaded_mlp_rays else
                        (lambda: fused_shaded_mlp(packed, encoded(), basis16, depth, skips, s,
                                                  nb))), ()
        elif kind == "forward":
            fn = fused_shaded_mlp
            args = (packed, feat, basis16, depth, skips, s, nb)
        elif kind == "mlp_fwd":
            fn = fused_mlp_apply
            args = (packed, feat, depth, skips)
        elif kind == "render_fwd":
            noise, noise_sel = (torch.as_tensor(rng.normal(size=(rays, s)), dtype=torch.float32,
                                                device=dev) for _ in range(2))
            fn = fused_render
            args = (packed, feat, basis16, z, noise, noise_sel, depth, skips, s, nb, draws > 0,
                    draws > 1, nc.white_back)
        elif kind == "render":
            noise = torch.as_tensor(rng.normal(size=(rays, s)), dtype=torch.float32, device=dev)
            dray = mse_cotangent(fused_render_plain(packed, feat, basis16, z, noise, None, depth,
                                                    skips, s, nb, True, False,
                                                    nc.white_back)[0], nc.far)
            nbytes = _bwd_fns()[0](rays, s, feat.shape[1], depth, sum(1 << i for i in skips),
                                   ws[0].shape[1], ws[-2].shape[1])
            work = torch.empty(nbytes, dtype=torch.uint8, device=dev)
            fn = render_bwd_points
            args = (ws, bs, feat, basis16, z, noise, dray, depth, skips, s, nb, nc.white_back,
                    work)
        else:
            shaded = kind == "shaded"
            if shaded:
                dout = shaded_cotangent(
                    fused_shaded_mlp_plain(packed, feat, basis16, depth, skips, s, nb), s)
            else:
                dout = mlp_cotangent(mlp_plain(packed, feat, depth, skips))
            work = _workspace(feat.shape[0], feat.shape[1], ws, skips, shaded, dev)
            fn = mlp_bwd_points
            args = (ws, bs, feat, basis16, dout, depth, skips, s, nb, shaded, work)
        fn(*args)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        out[label] = start.elapsed_time(end) / iters
        del work, args, feat
    return out


def _bounds(only) -> dict:
    """{label: (bound_ms, floor_ms)} of this tree's count of the work."""
    from mc_nerf_torch.config import NerfConfig
    from mc_nerf_torch.tools.bwd_check import (
        mlp_forward_bytes, needed_macs, points_stage_bytes, render_forward_bytes,
        render_points_stage_bytes, shaded_forward_bytes)

    nc = NerfConfig()
    enc = 4 + 6 * nc.emb_freqs_xyz
    nb = (nc.sh_deg + 1) ** 2
    out = {}
    for label, pack, s, kind, rays, draws in _shapes(only):
        depth, width, skips = ((nc.fine_depth, nc.fine_width, nc.fine_skips) if pack == "fine"
                               else (nc.coarse_depth, nc.coarse_width, nc.coarse_skips))
        sigma_only = pack == "coarse-sigma"
        head0 = width if sigma_only else 2 * width
        p = rays * s
        macs = needed_macs(nc, depth, width, skips, sigma_only)
        if kind.endswith("_path"):
            # the pass from its rays and depths: z in ([P] fp32), the
            # rays' origins, directions and basis, the outputs; bound only
            shade = 0.0 if kind == "mlp_path" else 2.0 * 3 * nb * p / PEAK_FP32_FLOPS
            ops_ms = (2.0 * macs * p / PEAK_BF16_FLOPS + shade) * 1e3
            out_bytes = {"forward_path": 8 * 4 * p, "render_path": 8 * 4 * rays,
                         "mlp_path": 32 * 4 * p}
            need = 4 * p + (24 + 16 * 4) * rays + out_bytes[kind]
            out[label] = (max(ops_ms, need / PEAK_BYTES * 1e3), None)
            continue
        if kind in ("forward", "render_fwd", "mlp_fwd"):
            # needed: feat in and the outputs (K4: [P, 8]; K2: the rays'
            # [P / s, 8] and wsel; K1: [P, 32]), the rays' basis and K2's
            # z and draws, fp32; the design's floor: this route's bytes
            shade = 0.0 if kind == "mlp_fwd" else 2.0 * 3 * nb * p / PEAK_FP32_FLOPS
            ops_ms = (2.0 * macs * p / PEAK_BF16_FLOPS + shade) * 1e3
            if kind == "forward":
                need = 2 * enc * p + 16 * 4 * rays + 8 * 4 * p
                nbytes = shaded_forward_bytes(enc, depth, width, skips, head0, p, s)
            elif kind == "render_fwd":
                need = (2 * enc * p + 16 * 4 * rays + 4 * (1 + draws) * p + 8 * 4 * rays
                        + (4 * p if draws > 1 else 0))
                nbytes = render_forward_bytes(enc, depth, width, skips, head0, p, s, draws,
                                              draws > 1)
            else:
                need = 2 * enc * p + 32 * 4 * p
                nbytes = mlp_forward_bytes(enc, depth, width, skips, head0, p)
            out[label] = (max(ops_ms, need / PEAK_BYTES * 1e3), nbytes / PEAK_BYTES * 1e3)
            continue
        nbytes = (render_points_stage_bytes(enc, depth, width, skips, 2 * width, p, s)
                  if kind == "render" else
                  points_stage_bytes(enc, depth, width, skips, 2 * width, p, kind == "shaded", s))
        out[label] = (2 * 2.0 * macs * p / PEAK_BF16_FLOPS * 1e3,
                      nbytes / PEAK_BYTES * 1e3)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--only", nargs="*", default=[],
                    help="shapes whose label starts with one of these (e.g. K3, K4)")
    ap.add_argument("--against", nargs="*", default=[],
                    help="other checkouts of the repository to time in turns with this one")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("points_stage_time: needs a CUDA card")
    if args.one:   # a worker: time the checkout on sys.path, print its JSON
        print(json.dumps(_time_here(args.iters, args.only)))
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    trees = [ROOT] + [Path(t).resolve() for t in args.against]
    builds = [subprocess.Popen([sys.executable, "-c",
                                "from mc_nerf_torch.ops.cuda import _build; _build.build_all()"],
                               cwd=t, env={**os.environ, "PYTHONPATH": str(t)},
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
              for t in trees]
    logs = [b.communicate()[0] for b in builds]
    failed = [(t, log) for t, b, log in zip(trees, builds, logs) if b.returncode]
    for t, log in failed:
        print(f"points_stage_time: {t} did not build, left out:\n{log[-3000:]}", flush=True)
    if any(t == ROOT for t, _ in failed):
        raise SystemExit("points_stage_time: this tree's kernels did not build")
    trees = [t for t in trees if t not in {f for f, _ in failed}]
    bounds = _bounds(args.only)
    order = trees + trees[::-1] if len(trees) > 1 else trees
    runs = []
    for tree in order:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one",
                               "--iters", str(args.iters), "--only", *args.only], cwd=tree, capture_output=True,
                              text=True, env={**os.environ, "PYTHONPATH": str(tree)})
        if proc.returncode:
            raise SystemExit(f"points_stage_time: {tree} failed:\n{proc.stderr[-4000:]}")
        ms = json.loads(proc.stdout.strip().splitlines()[-1])
        name = "this tree" if tree == ROOT else os.path.relpath(tree, ROOT)
        runs.append({"tree": name, "ms": ms})
        print(f"{name}: " + ", ".join(
            f"{k} {v:.3f} ms (bound {bounds[k][0]:.3f}"
            + (f", floor {bounds[k][1]:.3f})" if bounds[k][1] is not None else ")")
            for k, v in ms.items()), flush=True)
    print(json.dumps({"points_stage": runs, "bound_ms": {k: v[0] for k, v in bounds.items()},
                      "floor_ms": {k: v[1] for k, v in bounds.items()}, "card": card}))


if __name__ == "__main__":
    main()
