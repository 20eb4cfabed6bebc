"""Smoke test of the PyTorch port on one NVIDIA GPU: build, check, render.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the CUDA kernels from
   ``mc_nerf_torch/csrc`` (nvcc, sm_90a) and prints the build time.
2. Holds each kernel against its plain PyTorch version on the card, at the
   main path's widths: ``fused_mlp_apply`` (coarse sigma-only 4x128 and
   fine full 8x256, 65,536 points plus a ragged tail) and ``fused_render``
   (flags (F,F), (T,T), (T,F) at s=32 and s=48, 2,000 rays); then times
   both, and compares them again, on one main-path chunk of 16384 rays
   (48 coarse samples, 32 fine samples per ray).  Each check also measures
   planted faults (points mixed up inside a tile, the skip input dropped,
   the first layer lost, another ray's SH basis) against the same plain
   version, and fails if one of them would pass.
3. Drives the demo (``mc_nerf_torch.train.engine.demo``) at the library's
   default full width over two 800x800 views, with the occupancy refresh,
   and checks through the launch counters that both kernels ran; renders
   one chunk through the plain route and compares; times frames.

The weights are the seeded test scene of ``mc_nerf_torch.tools.scene``
(He-scaled, so the field's density and colour vary with the point).
4. Prints the ``kernels`` JSON line (time per launch, launches, bound,
   plain and library times), then ``{"ok": true, "device": ...}`` last.

Any failed check exits non-zero.  Needs one CUDA card; imports nothing of
the JAX package.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
SEED = 0
# Kernel vs plain: the same rounding points, sums in another order, so a
# bf16 activation may round the other way now and then.  Each tolerance is
# 4-8x the largest error measured on an H100 (PERF.md), and every planted
# fault measured there is 9x it or more.
MLP_RTOL = 2e-2            # max abs error over the max abs output (32 lanes)
RENDER_ATOL = 2e-2         # rgb / opacity / wsel
DEPTH_ATOL = 5e-2          # depth, in [near, far] = [1, 8]
# Kernel route vs the bf16 plain route on one chunk of the frame: two
# numeric routes whose importance samples land apart where the coarse
# weights differ a little, so the bound is the JAX package's own
# (tests/test_render_eval.py:131) on rgb, opacity and depth / (far - near),
# plus a bound on the mean.
SLICE_ATOL = 0.05
SLICE_MEAN_ATOL = 0.01


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int = 5) -> float:
    """Mean milliseconds per call on the card (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def needed_macs(nc, depth: int, width: int, skips, sigma_only: bool) -> int:
    """Multiply-adds per point that the MLP needs: the 3 + 6L real encode
    lanes (not the pack's pad lane) at layer 0 and at each skip, the trunk,
    head layer 0, and of the packed last head layer only its live blocks
    (the sigma column; with SH also the SH block), not its zeros."""
    enc = nc.embed_dim
    trunk = sum(((enc if i == 0 else width) + (enc if i in skips else 0)) * width
                for i in range(depth))
    heads = width * width + width if sigma_only else width * 2 * width + width * (1 + nc.sh_dim)
    return trunk + heads


def pack_bytes(packed) -> int:
    leaves = [*packed.trunk_w, *packed.trunk_b, packed.head_w0, packed.head_b0,
              packed.head_w1, packed.head_b1]
    return sum(t.numel() * t.element_size() for t in leaves)


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def over(errs: dict, tols: dict) -> float:
    """The largest error over its tolerance: a check passes at <= 1."""
    return max(errs[k] / tols[k] for k in errs)


def hold(label: str, errs: dict, tols: dict, plants: dict) -> None:
    """Fail unless every error is within its tolerance and every planted
    fault (measured against the same plain version) breaks one of them."""
    caught = {name: over(e, tols) for name, e in plants.items()}
    print(f"{label}: " + ", ".join(f"{k} {v:.3e} (tol {tols[k]})" for k, v in errs.items())
          + ("; planted faults, error over tolerance: "
             + ", ".join(f"{n} {r:.1f}" for n, r in caught.items()) if plants else ""),
          flush=True)
    if not over(errs, tols) <= 1.0:
        fail(f"{label}: the kernel disagrees with its plain version")
    missed = [n for n, r in caught.items() if not r > 1.0]
    if missed:
        fail(f"{label}: the check cannot see the planted faults {missed}")


def drop_skip(packed, skips):
    """A pack whose skip layers lose their feature rows (the skip input)."""
    ws = list(packed.trunk_w)
    for i in skips:
        ws[i] = ws[i].clone()
        ws[i][:packed.trunk_w[0].shape[0]] = 0
    return packed._replace(trunk_w=tuple(ws))


def drop_first(packed):
    """A pack whose first layer is lost: the output no longer depends on
    the point."""
    ws = list(packed.trunk_w)
    ws[0] = torch.zeros_like(ws[0])
    return packed._replace(trunk_w=tuple(ws))


def mlp_errs(out, ref) -> dict:
    return {"rel": float((out - ref).abs().max() / ref.abs().max())}


def render_errs(out, w, ref, ref_w) -> dict:
    if not (bool(torch.isfinite(out).all()) and float(out[:, 5:].abs().max()) == 0.0):
        fail("fused_render output is not finite or its last three lanes are not 0")
    errs = {"rgb/opacity": float((out[:, [0, 1, 2, 4]] - ref[:, [0, 1, 2, 4]]).abs().max()),
            "depth": float((out[:, 3] - ref[:, 3]).abs().max())}
    if ref_w is not None:
        errs["wsel"] = float((w - ref_w).abs().max())
    return errs


def library_mlp(packed, feat, depth, skips):
    """A bf16 torch.matmul chain computing the same MLP: a yardstick of
    speed, timed here and never called by the port."""
    ws = [*packed.trunk_w, packed.head_w0, packed.head_w1]
    bs = [b[0] for b in (*packed.trunk_b, packed.head_b0, packed.head_b1)]
    h = feat
    for i in range(depth):
        if i in skips:
            h = torch.cat([feat, h], dim=1)
        h = torch.relu(torch.addmm(bs[i], h, ws[i]))
    h1 = torch.relu(torch.addmm(bs[depth], h, ws[depth]))
    return torch.addmm(bs[depth + 1], h1, ws[depth + 1])


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    from mc_nerf_torch.config import Config
    from mc_nerf_torch.data.blender import SplitData
    from mc_nerf_torch.models.nerf import pack_eval_params, render_rays_eval
    from mc_nerf_torch.models.sh import sh_basis
    from mc_nerf_torch.cameras.rays import pixel_grid, rays_for_pixels
    from mc_nerf_torch.ops.cuda import _build
    from mc_nerf_torch.ops.cuda.fused_mlp import (
        BASIS_LANES, encode_kernel_order, fused_mlp_apply, mlp_plain)
    from mc_nerf_torch.ops.cuda.fused_render import fused_render, fused_render_plain
    from mc_nerf_torch.tools.scene import LEGO_FOV, orbit_views, scene_params
    from mc_nerf_torch.train.engine import demo, refresh_occupancy
    from mc_nerf_torch.train.steps import make_render_fn

    # full fp32 for the plain versions: TF32 would blur the comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)   # name, power limit: as nvidia-smi gives them
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    build_dir = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s into {build_dir}", flush=True)
    for log in sorted(build_dir.glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {log.stem}: {line.strip()}")

    cfg = Config()
    nc = cfg.nerf
    params = scene_params(nc, SEED, device=dev)
    packed_c, packed_f = pack_eval_params(params, nc)
    nb = (nc.sh_deg + 1) ** 2
    rng = np.random.default_rng(SEED)
    errs = {"fused_mlp_apply": 0.0, "fused_render": 0.0}   # max abs, for the kernels line
    mlp_tol = {"rel": MLP_RTOL}
    render_tol = {"rgb/opacity": RENDER_ATOL, "depth": DEPTH_ATOL, "wsel": RENDER_ATOL}

    # ---- kernel vs plain at the main path's widths
    n_pts = 65536 + 37
    xyz = torch.as_tensor(rng.uniform(-3.5, 3.5, (n_pts, 3)), dtype=torch.float32, device=dev)
    feat = encode_kernel_order(xyz, nc.emb_freqs_xyz)
    n_tiled = n_pts // 128 * 128
    for label, pk, depth, skips in (("coarse sigma-only", packed_c, nc.coarse_depth, nc.coarse_skips),
                                    ("fine full", packed_f, nc.fine_depth, nc.fine_skips)):
        ker = fused_mlp_apply(pk, feat, depth, skips)
        torch.cuda.synchronize()
        ref = mlp_plain(pk, feat, depth, skips)
        errs["fused_mlp_apply"] = max(errs["fused_mlp_apply"], float((ker - ref).abs().max()))
        mixed = torch.cat([ker[:n_tiled].view(-1, 128, ker.shape[1]).flip(1).reshape(n_tiled, -1),
                           ker[n_tiled:]])
        hold(f"fused_mlp_apply {label} P={n_pts}", mlp_errs(ker, ref), mlp_tol, {
            "points mixed in a tile": mlp_errs(mixed, ref),
            "skip input dropped": mlp_errs(mlp_plain(drop_skip(pk, skips), feat, depth, skips), ref),
            "first layer lost": mlp_errs(mlp_plain(drop_first(pk), feat, depth, skips), ref),
        })

    rays = 2000
    for s in (32, 48):
        d = torch.as_tensor(rng.normal(size=(rays, 3)), dtype=torch.float32, device=dev)
        d = d / d.norm(dim=-1, keepdim=True)
        o = torch.tensor([0.0, 0.0, -4.0], device=dev).expand(rays, 3)
        z = torch.sort(torch.as_tensor(rng.uniform(1.0, 8.0, (rays, s)), dtype=torch.float32,
                                       device=dev), dim=-1).values.contiguous()
        feat_r = encode_kernel_order((o[:, None] + d[:, None] * z[..., None]).reshape(-1, 3),
                                     nc.emb_freqs_xyz)
        basis16 = torch.nn.functional.pad(sh_basis(nc.sh_deg, d), (0, BASIS_LANES - nb)).contiguous()
        noise = torch.as_tensor(rng.normal(size=(rays, s)), dtype=torch.float32, device=dev)
        noise_sel = torch.as_tensor(rng.normal(size=(rays, s)), dtype=torch.float32, device=dev)
        # planted: the samples of ray pairs swapped (points mixed inside a block)
        feat_mixed = feat_r.view(rays, s, -1)[torch.arange(rays, device=dev).view(-1, 2).flip(1)
                                              .reshape(-1)].reshape(rays * s, -1)
        for with_noise, emit in ((False, False), (True, True), (True, False)):
            def args(pk=packed_f, ft=feat_r, bas=basis16):
                return (pk, ft, bas, z, noise, noise_sel, nc.fine_depth, nc.fine_skips, s, nb,
                        with_noise, emit, nc.white_back)
            k_out, k_w = fused_render(*args())
            torch.cuda.synchronize()
            p_out, p_w = fused_render_plain(*args())
            e = render_errs(k_out, k_w, p_out, p_w)
            errs["fused_render"] = max(errs["fused_render"], *e.values())
            hold(f"fused_render s={s} flags=({with_noise},{emit}) rays={rays}", e, render_tol, {
                "points mixed in a block": render_errs(*fused_render_plain(*args(ft=feat_mixed)),
                                                       p_out, p_w),
                "skip input dropped": render_errs(
                    *fused_render_plain(*args(pk=drop_skip(packed_f, nc.fine_skips))), p_out, p_w),
                "another ray's basis": render_errs(
                    *fused_render_plain(*args(bas=basis16.roll(1, 0))), p_out, p_w),
            })

    # ---- timings at the main path's shapes: one 16384-ray chunk
    chunk = cfg.eval.rays_per_chunk
    sc, sf = nc.occ_coarse_samples, cfg.eval.importance_samples
    emb = feat.shape[1]
    feat_c = encode_kernel_order(torch.as_tensor(rng.uniform(-3.5, 3.5, (chunk * sc, 3)),
                                                 dtype=torch.float32, device=dev), nc.emb_freqs_xyz)
    d = torch.as_tensor(rng.normal(size=(chunk, 3)), dtype=torch.float32, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    z_f = torch.sort(torch.as_tensor(rng.uniform(1.0, 8.0, (chunk, sf)), dtype=torch.float32,
                                     device=dev), dim=-1).values.contiguous()
    feat_f = encode_kernel_order((torch.tensor([0.0, 0.0, -4.0], device=dev)[None, None]
                                  + d[:, None] * z_f[..., None]).reshape(-1, 3), nc.emb_freqs_xyz)
    basis16 = torch.nn.functional.pad(sh_basis(nc.sh_deg, d), (0, BASIS_LANES - nb)).contiguous()
    fr_args = (packed_f, feat_f, basis16, z_f, None, None, nc.fine_depth, nc.fine_skips,
               sf, nb, False, False, nc.white_back)
    lib_c = (packed_c, feat_c, nc.coarse_depth, nc.coarse_skips)
    lib_f = (packed_f, feat_f, nc.fine_depth, nc.fine_skips)
    times = {
        "fused_mlp_apply": (cuda_ms(lambda: fused_mlp_apply(*lib_c)),
                            cuda_ms(lambda: mlp_plain(*lib_c), 3),
                            cuda_ms(lambda: library_mlp(*lib_c))),
        "fused_render": (cuda_ms(lambda: fused_render(*fr_args)),
                         cuda_ms(lambda: fused_render_plain(*fr_args), 3),
                         cuda_ms(lambda: library_mlp(*lib_f))),
    }
    p_c, p_f = chunk * sc, chunk * sf
    macs_c = needed_macs(nc, nc.coarse_depth, nc.coarse_width, nc.coarse_skips, True)
    macs_f = needed_macs(nc, nc.fine_depth, nc.fine_width, nc.fine_skips, False)
    print(f"MAC per point needed: coarse {macs_c}, fine {macs_f}")
    bounds = {
        "fused_mlp_apply": bound(2.0 * macs_c * p_c,
                                 p_c * emb * 2 + p_c * 32 * 4 + pack_bytes(packed_c)),
        "fused_render": bound(2.0 * macs_f * p_f,
                              p_f * emb * 2 + chunk * BASIS_LANES * 4 + p_f * 4
                              + chunk * 8 * 4 + pack_bytes(packed_f)),
    }
    for name, (ms, plain_ms, lib_ms) in times.items():
        print(f"{name} main-path chunk: {ms:.3f} ms (plain {plain_ms:.3f}, bf16 matmul chain "
              f"{lib_ms:.3f}, bound {bounds[name][0]:.3f} by {bounds[name][1]})", flush=True)
    # the same main-path chunks, kernel against plain
    ker, ref = fused_mlp_apply(*lib_c), mlp_plain(*lib_c)
    errs["fused_mlp_apply"] = max(errs["fused_mlp_apply"], float((ker - ref).abs().max()))
    hold("fused_mlp_apply main-path chunk", mlp_errs(ker, ref), mlp_tol, {})
    e = render_errs(*fused_render(*fr_args), *fused_render_plain(*fr_args))
    errs["fused_render"] = max(errs["fused_render"], *e.values())
    hold("fused_render main-path chunk", e, render_tol, {})

    # ---- the slice at full width: demo() over two 800x800 views
    h = w = 800
    poses, K = orbit_views((0.3, 2.2), h, w)   # radius 4, looking at the origin
    gt = np.full((2, h, w, 3), 255, np.uint8)   # a white target: the scores only need to be finite
    split = SplitData(gt, poses, np.stack([K, K]), np.full(2, LEGO_FOV, np.float32), h, w,
                      ["view0", "view1"])

    render = make_render_fn(cfg, h, w, device=dev)
    occ = refresh_occupancy(params, cfg, dev)
    occ_share = float(occ.float().mean())
    print(f"occupancy: {occ_share:.4f} of the G={nc.occ_grid_size} map's cells occupied "
          "(the rest culled)", flush=True)
    render(params, poses[0], K, occ)          # warm-up frame
    torch.cuda.synchronize()

    fused_mlp_apply.launches = 0
    fused_render.launches = 0
    t0 = time.perf_counter()
    result = demo(params, split, cfg, device=dev, cull=True)
    torch.cuda.synchronize()
    demo_s = time.perf_counter() - t0
    launches = {"fused_mlp_apply": fused_mlp_apply.launches,
                "fused_render": fused_render.launches}
    print(f"demo: {result} in {demo_s:.2f} s; launches {launches}", flush=True)
    if not all(n > 0 for n in launches.values()):
        fail(f"a kernel of the main path was not launched: {launches}")
    if not (result["count"] == 2 and math.isfinite(result["psnr"]) and math.isfinite(result["ssim"])):
        fail(f"demo result is not finite: {result}")

    frame_ms = cuda_ms(lambda: render(params, poses[1], K, occ), 2)
    rgb, depth, opac = render(params, poses[1], K, occ)
    if tuple(rgb.shape) != (h, w, 3) or not bool(torch.isfinite(rgb).all() & torch.isfinite(depth).all()):
        fail("frame is not finite or has the wrong shape")
    print(f"frame: {frame_ms:.1f} ms per 800x800 frame, {h * w / frame_ms * 1e3:.0f} rays/s "
          f"(occupancy culled, {math.ceil(h * w / chunk)} chunks of {chunk} rays); "
          f"rgb {float(rgb.min()):.3f}..{float(rgb.max()):.3f} (std {float(rgb.std()):.4f}), "
          f"opacity mean {float(opac.mean()):.4f}, depth std {float(depth.std()):.4f}")

    # one chunk of the frame through the plain route on the card
    pix = pixel_grid(h, w, device=dev)[h * w // 2 - chunk // 2: h * w // 2 + chunk // 2]
    rd, ro = rays_for_pixels(pix, torch.as_tensor(poses[1], device=dev), torch.as_tensor(K, device=dev))
    ker = render_rays_eval(params, rd, ro, nc, torch.bfloat16, importance_samples=sf,
                           packed=(packed_c, packed_f), occ=occ)

    def slice_errs(pln):
        span = nc.far - nc.near
        return {"max rgb/opacity": max(float((ker[i] - pln[i]).abs().max()) for i in (0, 2)),
                "max depth/(far-near)": float((ker[1] - pln[1]).abs().max()) / span,
                "mean rgb": float((ker[0] - pln[0]).abs().mean())}

    # planted: the fine MLP's skip layer loses its encode input
    broken = copy.deepcopy(params)
    with torch.no_grad():
        broken.fine.trunk[nc.fine_skips[0]].weight[:, :nc.embed_dim] = 0
    hold("slice chunk, kernel route vs bf16 plain route",
         slice_errs(render_rays_eval(params, rd, ro, nc, torch.bfloat16, importance_samples=sf,
                                     packed=None, occ=occ)),
         {"max rgb/opacity": SLICE_ATOL, "max depth/(far-near)": SLICE_ATOL,
          "mean rgb": SLICE_MEAN_ATOL},
         {"fine skip input dropped": slice_errs(render_rays_eval(
             broken, rd, ro, nc, torch.bfloat16, importance_samples=sf, packed=None, occ=occ))})

    replaces = {"fused_mlp_apply": "mc_nerf_tpu/ops/pallas/fused_mlp.py:241",
                "fused_render": "mc_nerf_tpu/ops/pallas/fused_render.py:211"}
    sources = {"fused_mlp_apply": "mc_nerf_torch/csrc/fused_mlp.cu",
               "fused_render": "mc_nerf_torch/csrc/fused_render.cu"}
    kernels = [{
        "name": name, "route": "cuda", "source": sources[name], "replaces": replaces[name],
        "launches": launches[name], "max_abs_err": errs[name], "ms": times[name][0],
        "plain_ms": times[name][1], "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
        "library_ms": times[name][2],
    } for name in ("fused_mlp_apply", "fused_render")]
    print(json.dumps({"frame_ms": frame_ms, "rays_per_s": h * w / frame_ms * 1e3,
                      "launches_per_frame": {k: v / 2 for k, v in launches.items()},
                      "occupied_share": occ_share, "card": smi}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
