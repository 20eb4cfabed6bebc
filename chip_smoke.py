"""Smoke test of the PyTorch port on one NVIDIA GPU: build, check, render, train,
in both fine modes, and the engine's three stages, resume and demo.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the CUDA kernels from
   ``mc_nerf_torch/csrc`` (nvcc, sm_90a, one process per source, in
   parallel) and prints the build time.
2. Holds each eval kernel against its plain PyTorch version on the card, at
   the main path's widths: ``fused_mlp_apply`` (coarse sigma-only 4x128 and
   fine full 8x256, 65,536 points plus a ragged tail) and ``fused_render``
   (flags (F,F), (T,T), (T,F) at s=32 and s=48, 2,000 rays); then times
   both, and compares them again, on one eval chunk of 16384 rays (48
   coarse, 32 fine samples per ray).
3. Drives the demo (``mc_nerf_torch.train.engine.demo``) at the library's
   default full width over two 800x800 views, with the occupancy refresh,
   and checks through the launch counters that both kernels ran; renders
   one chunk through the plain route and compares; times frames.
4. The training slice: ``fused_render`` at the training packs and flags
   (coarse full 4x128, s=48, noise + wsel; fine 8x256, s=32, noise; 7000
   rays); the backward's two launches (``render_bwd_points``,
   ``render_bwd_weights``) against ``fused_render_bwd_plain`` at the same
   shapes, beside the plain version's own fp32 spread; timings of each,
   each also against ``floor_ms``, the bytes its design must move over the
   memory rate (``tools/bwd_check.render_points_stage_bytes``,
   ``weight_stage_bytes``); ``render_bwd_points`` is K3's points stage
   (its forward, composite backward and K5's points stage), its numbers
   also kept under ``points_stage`` as K5's and K6's are.
5. The GLOBAL_OPTIM step at full width on the workload ``bench.py`` times
   (``tools/scene.train_workload``): the kernel route and the plain route
   timed in turns with CUDA events, the launch counts of the kernel route
   (each kernel twice per step), one step's loss and gradients on both
   routes compared, 20 steps on one fixed batch (the rgb loss must fall),
   one stage-0 and one stage-2 step, and a ``torch.profiler`` profile of
   both routes (device busy share, top device and host operations).
6. The grid fine mode (``fine_mode="grid"``: 128 uniform coarse samples,
   the first 26 above-threshold coarse bins x 5 fine samples per ray, no
   occupancy map): ``fused_shaded_mlp`` (K4) and its backward (K5) against
   their plain versions at the grid step's shapes (coarse full 4x128 over
   7000 x 128 points, fine 8x256 over 7000 x 130) and odd ones (53 rays x
   7, 7 rays x 1), with times; the differentiable ``fused_mlp`` driven
   through autograd (K1 forward, K6 backward; coarse full 4x128 over 7000
   x 48 points, fine 8x256 over 7000 x 32), K6 against its plain version;
   K5's and K6's weight stage (``launch_weight_grads``) timed apart on a
   filled workspace (``mlp_bwd_weights``) with its bound, ``floor_ms`` and
   a bf16 torch.mm chain of the dW products, kept under ``per_pass``;
   the demo in grid mode over the two 800x800 views with K1 and K4 counted,
   a frame timed, one chunk against the plain route, K1 and K4 at one eval
   chunk's shapes; the grid GLOBAL_OPTIM step as in 5 (K4 and K5 twice
   per step).
7. The engine (``mc_nerf_torch.train.engine.Engine``) at the default model
   and sampler widths on a scene the port's ``make_dataset`` writes under
   ``build/`` (8 train + 1 val + 2 test views at 200x200), cut to stages
   of 1 + 1 + 1 epochs of 16 steps with a 16-step occupancy warm-up: run
   A trains them (``fused_render`` and its two backward launches exactly
   twice per GLOBAL_OPTIM / FINE_TUNE step, ``fused_mlp_apply`` and
   ``fused_render`` in the validation renders), run B resumes from run
   A's epoch-0 checkpoint and must end on the same bits, the demo
   restores the latest checkpoint and scores the test views.  The calls
   of the kernels' entry points are recorded by path and shape; each
   kernel is then held against its plain version and timed on the inputs
   the engine gave it at each shape.
8. Prints the ``kernels`` JSON line, one entry per kernel and path (the
   demo; the train step; the grid demo; the grid train step; the
   fused_mlp VJP; the engine's training steps, validation renders and
   demo): that path's launches, time per launch at its shapes, bound,
   plain and library times; then ``{"ok": true, "device": ...}`` last.

Every kernel check also measures planted faults against the same plain
version (points mixed up, tiles swapped in pairs, the skip input dropped,
the first layer lost, another ray's SH basis, the forward composite's
prefix sums one sample late; for the backwards also a layer's dW
transposed or zeroed, the skip's dfeat share dropped, the suffix scan shifted by one,
one sample's dout8 moved to its neighbour, the sigmoid's derivative
dropped on one channel: ``tools/bwd_check.py``)
and fails if one of them would pass.  Bounds
count only the work the function needs (not the pad lane, the packed
head's zero blocks or the backward's workspace).  The weights are the seeded test
scene of ``mc_nerf_torch.tools.scene`` (He-scaled, so the field's density
and colour vary with the point).  Any failed check exits non-zero.  Needs
one CUDA card; imports nothing of the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12    # H100 SXM fp32 outside the tensor cores
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
# Backward kernels vs the plain backward under an MSE's cotangent, relative
# L2 per output (tools/bwd_check.bwd_errs), per pass: the same rounding
# points, fp32 sums in another order.  About 10x the error measured on an
# H100 (PERF.md), which is the size of the plain version's own
# fp32-against-float64 spread; every planted fault lands at 3.5x or more.
BWD_TOL = {"coarse": {"dW": 5e-4, "db": 3.5e-4, "last layer": 1.5e-4, "dfeat": 1.2e-2,
                      "dbasis": 1e-3},
           "fine": {"dW": 1e-2, "db": 6.3e-3, "last layer": 1.5e-4, "dfeat": 0.125,
                    "dbasis": 3.4e-3}}
# One train step, kernel route vs the bf16 plain route from the same params
# and draws: the plain route rounds sigma and SH to bf16 (the kernels keep
# them fp32), so its importance samples land apart a little.  About 10x
# the measured loss 2.6e-5 and worst leaf 1.4e-2 (PERF.md).
STEP_LOSS_RTOL = 3e-4
STEP_GRAD_TOL = {"grad rel L2 (worst leaf)": 0.15}
N_TRAIN = 10               # timed steps per round of a route
N_TRAIN_GRID = 5           # the same in the grid fine mode (~3x the importance step's time)
N_FIXED = 20               # steps on one fixed batch: the rgb loss must fall
# fused_shaded_mlp (K4) vs its plain version: sigma's max abs error over
# its largest magnitude, the rgb's max abs error; 3.7x and 5.2x the
# largest measured on an H100 (1.35e-2, 9.7e-3 at the eval chunk), every
# planted fault at 9.8x or more (PERF.md)
SHADED_TOL = {"sigma rel": 5e-2, "rgb": 5e-2}
# K5 (under tools/bwd_check.shaded_cotangent) and K6 (mlp_cotangent) vs
# their plain backwards, relative L2 per output and pass: about 10x the
# largest error measured on an H100 over this script's shapes (PERF.md);
# the skip's dfeat share dropped is the tight plant (~3x)
SHADED_BWD_TOL = {"coarse": {"dW": 1.2e-3, "db": 7.5e-4, "last layer": 1.9e-4, "dfeat": 2.5e-2,
                             "dbasis": 7.5e-4},
                  "fine": {"dW": 5.4e-2, "db": 6e-2, "last layer": 1.2e-3, "dfeat": 0.14,
                           "dbasis": 1.3e-3}}
MLP_BWD_TOL = {"coarse": {"dW": 2.2e-4, "db": 1.2e-4, "last layer": 1.1e-4, "dfeat": 2.3e-2},
               "fine": {"dW": 9e-4, "db": 5.3e-4, "last layer": 1.1e-4, "dfeat": 8.4e-2}}
# one grid-mode train step, kernel route vs the bf16 plain route: the
# plain route rounds sigma and SH to bf16, so a ray near the selection's
# threshold may pick another bin.  About 18x the measured loss error
# (5.6e-6) and 6x the worst leaf's (4.7e-2, PERF.md)
GRID_STEP_TOL = {"loss rel": 1e-4, "grad rel L2 (worst leaf)": 0.3}
# the engine phase's cuts of the protocol (52 epochs of 50 steps a train
# image, 3000 warm-up steps, 800x800 images, 200 test views)
ENGINE_CUTS = {"stages": (1, 1, 1), "steps_per_image_epoch": 2, "occ_warmup_steps": 16}
ENGINE_RES = 200
# improve_cameras on the card vs the CPU: the adoption masks exact, the
# adopted twists and focal multipliers (fp32, SVDs of 10 x 9 systems)
RESTART_ATOL = 1e-4
# calls per timing of a forward kernel on the engine's inputs
ENGINE_ITERS = 20


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def weight_stage_line(t: dict) -> str:
    """The two stages' numbers of a K5 or K6 pass, for its printed line."""
    return "".join(
        f"; {name.replace('_', ' ')} {w['ms']:.3f} ms (bf16 torch chain {w['library_ms']:.3f}, "
        f"bound {w['bound_ms']:.3f}, this design's floor {w['floor_ms']:.3f} by bytes)"
        for name, w in ((k, t.get(k)) for k in ("points_stage", "weight_stage")) if w)


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


def pack_bytes(packed) -> int:
    leaves = [*packed.trunk_w, *packed.trunk_b, packed.head_w0, packed.head_b0,
              packed.head_w1, packed.head_b1]
    return sum(t.numel() * t.element_size() for t in leaves)


def bound(flops: float, nbytes: float, fp32_flops: float = 0.0):
    """(least ms, "operations" or "bytes"): bf16 tensor-core FLOPs over the
    bf16 peak plus fp32 FLOPs outside the tensor cores over theirs, or the
    bytes over the memory rate, whichever is larger."""
    t_ops = flops / PEAK_BF16_FLOPS + fp32_flops / PEAK_FP32_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def over(errs: dict, tols: dict) -> float:
    """The largest error over its tolerance: a check passes at <= 1."""
    return max(errs[k] / tols[k] for k in errs)


def hold(label: str, errs: dict, tols: dict, plants: dict, bar: float = 1.0) -> None:
    """Fail unless every error is within its tolerance and every planted
    fault (measured against the same plain version) breaks one of them by
    more than ``bar`` times."""
    caught = {name: over(e, tols) for name, e in plants.items()}
    print(f"{label}: " + ", ".join(f"{k} {v:.3e} (tol {tols[k]})" for k, v in errs.items())
          + ("; planted faults, error over tolerance: "
             + ", ".join(f"{n} {r:.1f}" for n, r in caught.items()) if plants else ""),
          flush=True)
    if not over(errs, tols) <= 1.0:
        fail(f"{label}: the kernel disagrees with its plain version")
    missed = [n for n, r in caught.items() if not r > bar]
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


def render_inputs(nc, rays, s, rng, dev):
    """Rays from (0, 0, -4) in seeded directions, sorted depths in [1, 8],
    their features, SH basis and two noise draws."""
    from mc_nerf_torch.models.sh import sh_basis
    from mc_nerf_torch.ops.cuda.fused_mlp import BASIS_LANES, encode_kernel_order

    nb = (nc.sh_deg + 1) ** 2
    d = torch.as_tensor(rng.normal(size=(rays, 3)), dtype=torch.float32, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    z = torch.sort(torch.as_tensor(rng.uniform(1.0, 8.0, (rays, s)), dtype=torch.float32,
                                   device=dev), dim=-1).values.contiguous()
    feat = encode_kernel_order((torch.tensor([0.0, 0.0, -4.0], device=dev)[None, None]
                                + d[:, None] * z[..., None]).reshape(-1, 3), nc.emb_freqs_xyz)
    basis16 = torch.nn.functional.pad(sh_basis(nc.sh_deg, d), (0, BASIS_LANES - nb)).contiguous()
    noise = torch.as_tensor(rng.normal(size=(rays, s)), dtype=torch.float32, device=dev)
    noise_sel = torch.as_tensor(rng.normal(size=(rays, s)), dtype=torch.float32, device=dev)
    return feat, basis16, z, noise, noise_sel


def library_fwd(ws, bs, feat, depth, skips):
    """A bf16 torch.addmm chain of the MLP forward, keeping every layer's
    input and h1: (xins, h_last, h1).  A yardstick, never called by the
    port."""
    h, xins = feat, []
    for i in range(depth):
        if i in skips:
            h = torch.cat([feat, h], dim=1)
        xins.append(h)
        h = torch.relu(torch.addmm(bs[i][0], h, ws[i]))
    h1 = torch.relu(torch.addmm(bs[depth][0], h, ws[depth]))
    return xins, h, h1


def library_bwd_dx(ws, bs, feat, dout_b, depth, skips):
    """The recompute and dX products of the backward as a bf16
    torch.addmm / mm chain (the ReLU masks as multiplies): a yardstick.
    Returns what the dW products need."""
    xins, h_last, h1 = library_fwd(ws, bs, feat, depth, skips)
    torch.addmm(bs[depth + 1][0], h1, ws[depth + 1])
    d_h1 = (dout_b @ ws[depth + 1].t()) * (h1 > 0)
    d_a = (d_h1 @ ws[depth].t()) * (h_last > 0)
    das = [None] * depth
    e = feat.shape[1]
    for li in reversed(range(depth)):
        das[li] = d_a
        d_x = d_a @ ws[li].t()
        if li > 0:
            d_a = (d_x[:, e:] if li in skips else d_x) * (xins[li][:, -ws[li].shape[1]:] > 0)
    return xins, h_last, h1, d_h1, das


def library_bwd_dw(xins, h_last, h1, d_h1, das, dout_b):
    """The dW products of the backward as bf16 torch.mm: a yardstick."""
    return [x.t() @ d for x, d in zip(xins, das)] + [h_last.t() @ d_h1, h1.t() @ dout_b]


def train_passes(nc, params):
    """The two passes of a training step: (label, module, depth, width,
    skips, samples per ray, emit_wsel)."""
    return (("coarse", params.coarse, nc.coarse_depth, nc.coarse_width, nc.coarse_skips,
             nc.occ_coarse_samples, True),
            ("fine", params.fine, nc.fine_depth, nc.fine_width, nc.fine_skips, 32, False))


def per_launch(passes: dict) -> dict:
    """One kernel's numbers over a training step's launches (one per pass):
    each time and bound is the mean per launch; ``per_pass`` keeps each."""
    mean = {k: sum(p[k] for p in passes.values()) / len(passes)
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    by = max(passes.values(), key=lambda p: p["bound_ms"])["bound_by"]
    return {**mean, "bound_by": by, "per_pass": passes}


def check_train_forward(nc, params, dev, rng, rays, errs, render_tol):
    """fused_render at the training packs and flags (coarse full 4x128,
    s=48, noise + wsel; fine 8x256, s=32, noise) against the plain forward,
    with planted faults.  Returns per pass the kernel's ms, the plain
    version's, a bf16 matmul chain's and the bound at these shapes."""
    from mc_nerf_torch.tools.bwd_check import render_scan_late
    from mc_nerf_torch.ops.cuda.fused_mlp import pack_mlp_params
    from mc_nerf_torch.ops.cuda.fused_render import fused_render, fused_render_plain

    nb = (nc.sh_deg + 1) ** 2
    passes = {}
    for label, mlp, depth, _width, skips, s, emit in train_passes(nc, params):
        pk = pack_mlp_params(mlp, nc.emb_freqs_xyz, skips)
        feat, basis16, z, noise, noise_sel = render_inputs(nc, rays, s, rng, dev)
        feat_mixed = feat.view(rays, s, -1)[torch.arange(rays, device=dev).view(-1, 2).flip(1)
                                            .reshape(-1)].reshape(rays * s, -1)

        def args(pk=pk, ft=feat, bas=basis16):
            return (pk, ft, bas, z, noise, noise_sel, depth, skips, s, nb, True, emit,
                    nc.white_back)

        k_out, k_w = fused_render(*args())
        torch.cuda.synchronize()
        p_out, p_w = fused_render_plain(*args())
        e = render_errs(k_out, k_w, p_out, p_w)
        errs["fused_render"] = max(errs["fused_render"], *e.values())
        hold(f"fused_render training {label} s={s} rays={rays}", e, render_tol, {
            "points mixed in a block": render_errs(*fused_render_plain(*args(ft=feat_mixed)),
                                                   p_out, p_w),
            "skip input dropped": render_errs(*fused_render_plain(*args(pk=drop_skip(pk, skips))),
                                              p_out, p_w),
            "another ray's basis": render_errs(*fused_render_plain(*args(bas=basis16.roll(1, 0))),
                                               p_out, p_w),
            "scan one sample late": render_errs(*render_scan_late(*args()), p_out, p_w),
        }, 2.0)
        passes[label] = render_forward_numbers(nc, args())
    return passes


def bf16_pack(packed):
    """The pack with every leaf in bf16, as the kernels read it."""
    cast = lambda t: t.detach().to(torch.bfloat16)
    return type(packed)(*(tuple(map(cast, x)) if isinstance(x, tuple) else cast(x)
                          for x in packed))


def render_forward_numbers(nc, args, iters: int = 5) -> dict:
    """fused_render on ``args`` (its positional arguments): the kernel's
    ms, the plain version's, a bf16 matmul chain's of the same MLP (each
    of the two over ``iters`` calls) and the bound: the MLP's products, or
    the bytes read (feat, basis, z, the noise draws it takes, the bf16
    pack) and written (ray_out, wsel)."""
    from mc_nerf_torch.ops.cuda.fused_render import fused_render, fused_render_plain
    from mc_nerf_torch.tools.bwd_check import needed_macs

    pk, feat, basis16, z, noise, noise_sel, depth, skips, s, _nb, with_noise, emit = args[:12]
    rays, p, pk16 = basis16.shape[0], feat.shape[0], bf16_pack(pk)
    draws = (1 if with_noise else 0) + (1 if with_noise and emit else 0)
    nbytes = (p * feat.shape[1] * 2 + rays * basis16.shape[1] * 4 + p * 4 * (1 + draws)
              + rays * 8 * 4 + (p * 4 if emit else 0) + pack_bytes(pk16))
    t_bound, by = bound(2.0 * needed_macs(nc, depth, pk.trunk_w[0].shape[1], skips, False) * p,
                        nbytes)
    with torch.no_grad():
        return {"ms": cuda_ms(lambda: fused_render(*args), iters),
                "plain_ms": cuda_ms(lambda: fused_render_plain(*args), 3),
                "library_ms": cuda_ms(lambda: library_mlp(pk16, feat, depth, skips), iters),
                "bound_ms": t_bound, "bound_by": by}


def mlp_numbers(nc, pk, feat, depth, skips, iters: int = 5) -> dict:
    """fused_mlp_apply on these inputs: the kernel's ms, the plain
    version's, a bf16 matmul chain's (the two over ``iters`` calls) and
    the bound (the MLP's products, or feat and the pack read, the [P, 32]
    rows written)."""
    from mc_nerf_torch.ops.cuda.fused_mlp import fused_mlp_apply, mlp_plain
    from mc_nerf_torch.tools.bwd_check import needed_macs

    p, width = feat.shape[0], pk.trunk_w[0].shape[1]
    sigma_only = pk.head_w0.shape[1] == width
    t_bound, by = bound(2.0 * needed_macs(nc, depth, width, skips, sigma_only) * p,
                        p * feat.shape[1] * 2 + p * 32 * 4 + pack_bytes(pk))
    return {"ms": cuda_ms(lambda: fused_mlp_apply(pk, feat, depth, skips), iters),
            "plain_ms": cuda_ms(lambda: mlp_plain(pk, feat, depth, skips), 3),
            "library_ms": cuda_ms(lambda: library_mlp(pk, feat, depth, skips), iters),
            "bound_ms": t_bound, "bound_by": by}


def check_backward(nc, params, dev, rng, rays, bwd_tol):
    """The backward kernels against fused_render_bwd_plain at the training
    shapes of both passes on the scene's weights, beside the plain
    version's own fp32 spread (against float64 sums of the same rounding
    points), with planted faults, each at 2x a tolerance or more; the
    cotangent is an MSE's (``tools/bwd_check.mse_cotangent``).  Returns per pass (relative
    errors, inputs, the bf16 pack), and each launch's max abs error over
    both passes."""
    from mc_nerf_torch.ops.cuda.fused_mlp import _flat_weights, pack_mlp_params
    from mc_nerf_torch.ops.cuda.fused_render import (
        _render_plain_flat, fused_render_bwd, fused_render_bwd_plain)
    from mc_nerf_torch.tools.bwd_check import bwd_errs, mse_cotangent, planted_errs

    nb = (nc.sh_deg + 1) ** 2
    out, max_abs = {}, {"render_bwd_points": 0.0, "render_bwd_weights": 0.0}
    for label, mlp, depth, _width, skips, s, _emit in train_passes(nc, params):
        pk = pack_mlp_params(mlp, nc.emb_freqs_xyz, skips)
        ws, bs = _flat_weights(pk)
        feat, basis16, z, noise, _ = render_inputs(nc, rays, s, rng, dev)
        ray_out, _ = _render_plain_flat(ws, bs, feat, basis16, z, noise, None, depth, skips,
                                        s, nb, True, False, nc.white_back)
        dray = mse_cotangent(ray_out, nc.far)
        args = (ws, bs, feat, basis16, z, noise, dray, depth, skips, s, nb, True, nc.white_back)
        k = fused_render_bwd(*args)
        torch.cuda.synchronize()
        ref = fused_render_bwd_plain(*args)
        spread = bwd_errs(ref, fused_render_bwd_plain(*args[:6], dray.double(), *args[7:]))
        print(f"backward {label}: the plain version's own spread (fp32 against float64 "
              "sums): " + ", ".join(f"{n} {v:.3e}" for n, v in spread.items()), flush=True)
        e = bwd_errs(k, ref)
        hold(f"backward {label} s={s} rays={rays} (relative L2)", e, bwd_tol[label],
             planted_errs(args, ref), 2.0)
        out[label] = (e, args, pk)
        max_abs["render_bwd_points"] = max(max_abs["render_bwd_points"], *(
            float((a - b).abs().max()) for a, b in zip(k[2:], ref[2:])))
        max_abs["render_bwd_weights"] = max(max_abs["render_bwd_weights"], *(
            float((a - b).abs().max()) for a, b in zip([*k[0], *k[1]], [*ref[0], *ref[1]])))
    return out, max_abs


def time_backward(nc, bwd, rng, dev) -> dict:
    """Per backward launch and pass: ms, the whole plain backward's ms, a
    bf16 torch.addmm/mm chain of the same products (recompute + dX for
    ``render_bwd_points``, dW for ``render_bwd_weights``), and the bound
    of the work each launch's share of the function needs: recompute + dX
    products and the function's inputs and dfeat/dbasis for the first;
    the dW products and the weight gradients written for the second.  The
    workspace that the design passes between them is not needed work;
    each also gets ``floor_ms``, this design's floor: the bytes its stage
    must move (``tools/bwd_check.render_points_stage_bytes``: the points
    stage's workspace and dfeat, the forward's and the composite's buffer;
    ``weight_stage_bytes``: each job's X and D read once and dW written
    once), over the memory rate.  The first's numbers are K3's points
    stage, also kept under ``points_stage`` as K5's and K6's are."""
    from mc_nerf_torch.ops.cuda.fused_render import (
        _bwd_fns, fused_render_bwd_plain, render_bwd_points, render_bwd_weights)
    from mc_nerf_torch.tools.bwd_check import (
        needed_macs, render_points_stage_bytes, weight_stage_bytes)

    nb = (nc.sh_deg + 1) ** 2
    out = {"render_bwd_points": {}, "render_bwd_weights": {}}
    for label, (_e, args, pk) in bwd.items():
        ws, bs, feat, basis16, z, noise, dray, depth, skips, s = args[:10]
        rays, p, enc = basis16.shape[0], feat.shape[0], feat.shape[1]
        width = ws[0].shape[1]
        nbytes = _bwd_fns()[0](rays, s, enc, depth, sum(1 << i for i in skips), width,
                               ws[-2].shape[1])
        work = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        pts_args = (ws, bs, feat, basis16, z, noise, dray, depth, skips, s, nb, nc.white_back,
                    work)
        dout_b = torch.as_tensor(rng.normal(size=(p, 32)) * 1e-4, dtype=torch.bfloat16,
                                 device=dev)
        saved = library_bwd_dx(ws, bs, feat, dout_b, depth, skips)
        macs = needed_macs(nc, depth, width, skips, False)
        plain_ms = cuda_ms(lambda: fused_render_bwd_plain(*args), 3)
        b_pts = bound(2.0 * 2 * macs * p,
                      p * enc * 2 + 2 * p * 4 + rays * (basis16.shape[1] + 8) * 4
                      + pack_bytes(pk) + p * enc * 4 + rays * basis16.shape[1] * 4)
        b_w = bound(2.0 * macs * p, 2 * pack_bytes(pk))
        pts = {"ms": cuda_ms(lambda: render_bwd_points(*pts_args)),
               "library_ms": cuda_ms(lambda: library_bwd_dx(ws, bs, feat, dout_b, depth, skips)),
               "bound_ms": b_pts[0], "bound_by": b_pts[1],
               "floor_ms": render_points_stage_bytes(enc, depth, width, skips, ws[-2].shape[1],
                                                     p, s) / PEAK_BYTES * 1e3}
        out["render_bwd_points"][label] = {**pts, "plain_ms": plain_ms, "points_stage": pts}
        out["render_bwd_weights"][label] = {
            "ms": cuda_ms(lambda: render_bwd_weights(ws, bs, feat, rays, s, skips, work)),
            "plain_ms": plain_ms,
            "library_ms": cuda_ms(lambda: library_bwd_dw(*saved, dout_b)),
            "bound_ms": b_w[0], "bound_by": b_w[1],
            "floor_ms": weight_stage_bytes(enc, depth, width, skips, ws[-2].shape[1], p)
            / PEAK_BYTES * 1e3}
        del work, saved
    return out


def weight_stage_numbers(ws, bs, feat, skips, shaded: bool, fill, saved, dout_b, macs: int,
                         pk) -> dict:
    """The weight stage of K5 (``shaded``) or K6 timed apart at these
    shapes: ``mlp_bwd_weights`` on a workspace that ``fill(work)`` (the
    whole backward) filled, beside the bf16 torch.mm chain of the dW
    products (``library_bwd_dw``), the needed-work bound of
    ``render_bwd_weights`` (the dW products, the weight gradients written)
    and ``floor_ms``, this design's floor: the stage's bytes (each job's X
    and D read once, dW written once) over the memory rate."""
    from mc_nerf_torch.ops.cuda.fused_mlp import _workspace, mlp_bwd_weights
    from mc_nerf_torch.tools.bwd_check import weight_stage_bytes

    p, enc = feat.shape
    depth, width, head0 = len(ws) - 2, ws[0].shape[1], ws[-2].shape[1]
    work = _workspace(p, enc, ws, skips, shaded, feat.device)
    fill(work)
    b_w = bound(2.0 * macs * p, 2 * pack_bytes(pk))
    nums = {"ms": cuda_ms(lambda: mlp_bwd_weights(ws, bs, feat, skips, shaded, work)),
            "library_ms": cuda_ms(lambda: library_bwd_dw(*saved, dout_b)),
            "bound_ms": b_w[0], "bound_by": b_w[1],
            "floor_ms": weight_stage_bytes(enc, depth, width, skips, head0, p) / PEAK_BYTES * 1e3}
    del work
    return nums


def points_stage_numbers(args, shaded: bool, dout_b, macs: int) -> dict:
    """The points stage of K5 (``shaded``; ``args`` those of
    ``fused_shaded_mlp_bwd``) or K6 (``fused_mlp_bwd``'s) timed apart at
    these shapes: ``mlp_bwd_points`` (the recompute, the heads-and-trunk
    backward, K5's per-ray dbasis sums) beside the bf16 torch chain of the
    same products (``library_bwd_dx``), ``bound_ms`` (the recompute and dX
    products over the bf16 peak) and ``floor_ms``, this design's bytes
    (``tools/bwd_check.points_stage_bytes``) over the memory rate."""
    from mc_nerf_torch.ops.cuda.fused_mlp import _workspace, mlp_bwd_points
    from mc_nerf_torch.tools.bwd_check import points_stage_bytes

    if shaded:
        ws, bs, feat, basis16, dout, depth, skips, s, nb = args
    else:
        (ws, bs, feat, dout, depth, skips), basis16, s, nb = args, None, 1, 1
    p, enc = feat.shape
    width, head0 = ws[0].shape[1], ws[-2].shape[1]
    work = _workspace(p, enc, ws, skips, shaded, feat.device)
    pts = (ws, bs, feat, basis16, dout, depth, skips, s, nb, shaded, work)
    nums = {"ms": cuda_ms(lambda: mlp_bwd_points(*pts)),
            "library_ms": cuda_ms(lambda: library_bwd_dx(ws, bs, feat, dout_b, depth, skips)),
            "bound_ms": 2 * 2.0 * macs * p / PEAK_BF16_FLOPS * 1e3, "bound_by": "operations",
            "floor_ms": points_stage_bytes(enc, depth, width, skips, head0, p, shaded, s)
            / PEAK_BYTES * 1e3}
    del work
    return nums


def masked_below(plain, args, ref) -> dict:
    """The points stage's wrong-mask plant (``tools/bwd_check.planted_points``):
    each trunk layer l > 0 masked with layer l - 1's ReLU mask."""
    from mc_nerf_torch.tools.bwd_check import planted_points

    name = "a layer masked with the one below's"
    return {name: planted_points(plain, args, ref)[name]}


def last_tile_hold(label: str, kernel, plain, args, cot_at: int) -> None:
    """The backward under its cotangent zeroed outside the last 64-point
    tile (``tools/bwd_check.last_tile_cotangent``): its weight and bias sums
    within ``LAST_TILE_TOL``, and dW without that tile and the bias
    gradients without the last 128-point tile both at 2x it or more, at any
    point count."""
    from mc_nerf_torch.tools.bwd_check import (
        LAST_TILE_TOL, bwd_errs, last_tile_cotangent, planted_last_tile, planted_points)

    args = list(args)
    args[cot_at] = last_tile_cotangent(args[cot_at])
    k = kernel(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    stage = lambda e: {o: e[o] for o in LAST_TILE_TOL}
    hold(f"{label}, cotangent on the last tile only (relative L2)", stage(bwd_errs(k, ref)),
         LAST_TILE_TOL, {
             "dW without the last tile": stage(planted_last_tile(plain, args, ref)),
             "bias partials of the last tile dropped": stage(
                 planted_points(plain, args, ref)["bias partials of the last tile dropped"])},
         2.0)


def train_phase(cfg, dev, h: int, w: int, counters, n_steps: int, route_tol: dict) -> dict:
    """The GLOBAL_OPTIM step at full width on the workload bench.py times
    (``tools/scene.train_workload``; no occupancy map in the grid fine
    mode), from the middle of the schedule (the BARF gate half open):
    timed steps through the kernels with the launch counts of ``counters``
    (each must launch exactly twice per step), one step's loss and
    gradients against the plain route within ``route_tol``, the plain
    route timed, the rgb loss over 20 steps on one fixed batch, one stage-0
    and one stage-2 step, and a profile of both routes."""
    from mc_nerf_torch.tools.bwd_check import rel_l2
    from mc_nerf_torch.tools.profile_step import profile_steps
    from mc_nerf_torch.tools.scene import STEPS_PER_EPOCH, TOTAL_STEPS, train_workload
    from mc_nerf_torch.train.optim import build_optimizers, flatten_params
    from mc_nerf_torch.train.steps import TrainState, draw_step, make_loss_fn, make_stage_step

    mode = cfg.train.fine_mode
    params, data = train_workload(cfg, SEED, dev, img_h=h, img_w=w)
    p_flat = flatten_params(params)
    txs, states = build_optimizers(cfg, params, p_flat, STEPS_PER_EPOCH)
    state = TrainState(params, p_flat, states, TOTAL_STEPS // 2)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n_img = data.images_u8.shape[0]
    rays = cfg.train.rays_per_batch

    def draw(stage):
        return draw_step(cfg, stage, n_img, h, w, data.occ is not None, gen)

    cfg_plain = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, use_pallas=False))
    step_k = make_stage_step(cfg, 1, txs[1], h, w, TOTAL_STEPS)
    step_p = make_stage_step(cfg_plain, 1, txs[1], h, w, TOTAL_STEPS)
    for _ in range(3):
        step_k(state, data, draw(1))
    draws = [draw(1) for _ in range(n_steps)]

    def timed(step, ds):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for d in ds:
            m = step(state, data, d)
        end.record()
        end.synchronize()
        if not all(bool(torch.isfinite(v)) for v in m.values()):
            fail(f"train step metrics are not finite: {m}")
        return start.elapsed_time(end) / len(ds)

    # the two routes in turns (kernel, plain, plain, kernel): the step is
    # bound by the host, whose speed drifts on a shared machine
    rounds = {"kernel": [], "plain": []}
    launches = None
    for route in ("kernel", "plain", "plain", "kernel"):
        ds = draws if launches is None else [draw(1) for _ in range(n_steps)]
        if launches is None:
            for c in counters:
                c.launches = 0
        rounds[route].append(timed(step_k if route == "kernel" else step_p, ds))
        if launches is None:
            launches = {c.__name__: c.launches for c in counters}
            print(f"launches over {n_steps} kernel-route {mode} steps: {launches}", flush=True)
            if any(n != 2 * n_steps for n in launches.values()):
                fail(f"each kernel should launch twice per step: {launches}")
    step_ms = sum(rounds["kernel"]) / 2
    plain_ms = sum(rounds["plain"]) / 2
    print(f"{mode} train step ms per round (kernel, plain, plain, kernel): "
          f"{rounds['kernel'][0]:.3f}, "
          f"{rounds['plain'][0]:.3f}, {rounds['plain'][1]:.3f}, {rounds['kernel'][1]:.3f}; "
          f"kernel route {step_ms:.3f} ms ({rays / step_ms * 1e3:.0f} rays/s), plain route "
          f"{plain_ms:.3f} ms ({rays / plain_ms * 1e3:.0f} rays/s)", flush=True)

    # one step's loss and gradients, kernel route against the plain route
    d = draw(1)

    def loss_and_grads(c, prm):
        for p in prm.parameters():
            p.grad = None
        total, _ = make_loss_fn(c, 1, h, w, TOTAL_STEPS)(prm, data, d, state.step)
        total.backward()
        return float(total), {n: p.grad.detach().clone() for n, p in prm.named_parameters()}

    def route_errs(a, b):
        return {"loss rel": abs(a[0] - b[0]) / abs(b[0]),
                "grad rel L2 (worst leaf)": max(rel_l2(a[1][n], b[1][n]) for n in b[1]
                                                if float(b[1][n].norm()) > 0)}

    ker = loss_and_grads(cfg, params)
    pln = loss_and_grads(cfg_plain, params)
    broken = copy.deepcopy(params)
    with torch.no_grad():
        broken.nerf.fine.trunk[cfg.nerf.fine_skips[0]].weight[:, :cfg.nerf.embed_dim] = 0
    hold(f"{mode} train step, kernel route vs bf16 plain route", route_errs(ker, pln),
         route_tol, {"fine skip input dropped": route_errs(loss_and_grads(cfg_plain, broken), pln)})
    del broken
    per_leaf = {n: rel_l2(ker[1][n], pln[1][n]) for n in pln[1] if float(pln[1][n].norm()) > 0}
    print("  per-leaf gradient rel L2, kernel vs plain: "
          + ", ".join(f"{n} {v:.2e}" for n, v in per_leaf.items()), flush=True)

    # twenty kernel-route steps on one fixed batch, from a fresh optimizer
    state.opt_states = tuple(txs[i].init(p_flat) if i == 1 else o
                             for i, o in enumerate(state.opt_states))
    fixed = draw(1)
    rgb = []
    for _ in range(N_FIXED):
        m = step_k(state, data, fixed)
        rgb.append(float(m["loss_rgb_c"] + m["loss_rgb_f"]))
    print(f"{mode}: rgb loss (coarse + fine) over {N_FIXED} steps on one batch: {rgb[0]:.6f} -> "
          f"{rgb[-1]:.6f}", flush=True)
    if not rgb[-1] < rgb[0]:
        fail("the rgb loss did not fall over 20 steps on one fixed batch")

    others = {}
    for stage in (0, 2):
        m = make_stage_step(cfg, stage, txs[stage], h, w, TOTAL_STEPS)(state, data, draw(stage))
        others[stage] = {k: float(v) for k, v in m.items()}
        if not all(math.isfinite(v) for v in others[stage].values()):
            fail(f"stage {stage} step is not finite: {others[stage]}")
    print(f"{mode}: stage 0 step: {others[0]}\nstage 2 step: {others[2]}", flush=True)

    profiles = {}
    for route, step, n in (("kernel", step_k, 3), ("plain", step_p, 2)):
        wall, rows, host = profile_steps(lambda: step(state, data, draw(1)), n)
        busy = sum(r[0] for r in rows)
        profiles[route] = {"step_ms": wall, "kernel_ms": busy, "busy_share": busy / wall,
                           "top": [{"ms": ms, "calls": c, "name": nm[:80]}
                                   for ms, c, nm in rows[:8]],
                           "host_top": [{"ms": ms, "calls": c, "name": nm[:60]}
                                        for ms, c, nm in host[:6]]}
        print(f"profile, {mode} {route} route: {wall:.1f} ms wall, {busy:.1f} ms of kernels, busy "
              f"share {busy / wall:.3f}; top: " + "; ".join(
                  f"{nm[:60]} {ms:.2f} ms x{c}" for ms, c, nm in rows[:8])
              + "; host (self CPU): " + "; ".join(
                  f"{nm[:40]} {ms:.2f} ms x{c}" for ms, c, nm in host[:6]), flush=True)
    return {"train_step_ms": step_ms, "train_rays_per_s": rays / step_ms * 1e3,
            "plain_step_ms": plain_ms, "plain_rays_per_s": rays / plain_ms * 1e3,
            "rounds_ms": rounds,
            "route_errs": route_errs(ker, pln), "rgb_loss_fixed_batch": [rgb[0], rgb[-1]],
            "profiles": profiles, "launches": launches}


def engine_phase(dev, smi: str, counters: dict) -> dict:
    """The engine (``mc_nerf_torch.train.engine.Engine``) at ``Config()``'s
    model and sampler widths on a scene the port's ``make_dataset`` writes
    under ``build/`` (ball rig, analytic calibration, 8 train + 1 val + 2
    test views at ``ENGINE_RES``^2), with the cuts of ``ENGINE_CUTS``.
    Run A trains the three stages; run B resumes from run A's epoch-0
    checkpoint in a fresh weights directory and must end on the same bits;
    the demo restores the latest checkpoint and scores the test views.
    ``counters`` (name -> wrapper) count launches: run A's from 0 (the
    training steps and the validation renders apart), the demo's from 0.
    The kernels' entry points are wrapped where the engine's renders call
    them (``engine_recorder``): each path's calls are counted by shape and
    the first call at each shape keeps its inputs, on which
    ``engine_kernel_numbers`` then checks and times the kernel."""
    import os
    import pathlib
    import shutil

    import mc_nerf_torch.models.nerf as nerf_module
    import mc_nerf_torch.ops.cuda.fused_render as render_module

    from mc_nerf_torch.config import Config, NerfConfig, PathsConfig, StageConfig, TrainConfig
    from mc_nerf_torch.data.calibration import load_calibration
    from mc_nerf_torch.data.synthetic import make_dataset
    from mc_nerf_torch.train.engine import STAGE_NAMES, Engine
    from mc_nerf_torch.train.restarts import improve_cameras

    t_phase = time.perf_counter()
    work = pathlib.Path(__file__).resolve().parent / "build" / f"engine_smoke_{os.getpid()}"
    shutil.rmtree(work, ignore_errors=True)
    res = ENGINE_RES
    make_dataset(str(work / "Ball_Smoke"), n_train=8, n_val=1, n_test=2, img_h=res, img_w=res,
                 seed=SEED)
    stages, spi, warmup = ENGINE_CUTS["stages"], ENGINE_CUTS["steps_per_image_epoch"], \
        ENGINE_CUTS["occ_warmup_steps"]

    def paths(weights):
        return PathsConfig(root_weights=str(work / weights), root_out=str(work / "results"),
                           log_path=str(work / "log"), tb_path=str(work / "tb"))

    cfg = Config(data_root=str(work), data_name="Ball_Smoke", stages=StageConfig(*stages),
                 train=TrainConfig(steps_per_image_epoch=spi),
                 nerf=NerfConfig(occ_warmup_steps=warmup), paths=paths("weights_a"))
    print(f"engine: Config() model and sampler widths; cuts: stages {stages}, "
          f"steps_per_image_epoch {spi}, occ_warmup_steps {warmup}, {res}x{res} images, "
          "8 train + 1 val + 2 test views", flush=True)

    def launches():
        return {n: c.launches for n, c in counters.items()}

    def reset():
        for c in counters.values():
            c.launches = 0

    # the engine's calls of the kernels' entry points, by path and shape
    where, calls = [None], {}
    wrapped = {(nerf_module, "fused_render"): lambda a: f"{a[2].shape[0]} rays x {a[8]}",
               (nerf_module, "fused_mlp_apply"): lambda a: f"{a[1].shape[0]} points",
               (render_module, "fused_render_bwd"): lambda a: f"{a[3].shape[0]} rays x {a[9]}"}
    originals = {k: getattr(*k) for k in wrapped}
    for (module, name), shape_of in wrapped.items():
        setattr(module, name, engine_recorder(originals[module, name], name, shape_of, where,
                                              calls))

    # run A, the validation renders' launches counted apart
    eng_a = Engine(cfg, device=dev)
    spe = eng_a.steps_per_epoch
    val_launches = dict.fromkeys(counters, 0)
    validate = eng_a._validate

    def counted_validate(epoch):
        before = launches()
        where[0] = "engine_validation"
        out = validate(epoch)
        where[0] = "engine_train"
        for n, v in launches().items():
            val_launches[n] += v - before[n]
        return out

    eng_a._validate = counted_validate
    reset()
    where[0] = "engine_train"
    t0 = time.perf_counter()
    eng_a.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    where[0] = None
    total = launches()
    train_launches = {n: total[n] - val_launches[n] for n in counters}
    for h in eng_a.history:
        print(f"engine {STAGE_NAMES[h['stage']]} {h['epoch']}: loss {h['loss']:.6f} intr "
              f"{h['loss_intr']:.6f} extr {h['loss_extr']:.6f} rgb_c {h['loss_rgb_c']:.5f} rgb_f "
              f"{h['loss_rgb_f']:.5f}; {h['seconds']:.3f} s ({h['seconds'] / spe * 1e3:.2f} ms a "
              f"step, {h['rays_per_s']:.0f} rays/s), checkpoint save "
              f"{h['ckpt_seconds'] * 1e3:.1f} ms"
              + (f"; val PSNR {h['val_psnr']:.3f} SSIM {h['val_ssim']:.4f}" if "val_psnr" in h
                 else "") + f" ({smi})", flush=True)
    nerf_steps = spe * (stages[1] + stages[2])
    print(f"engine run A: {train_s:.2f} s; launches in the training steps {train_launches}, "
          f"in the validation renders {val_launches}", flush=True)
    for h in eng_a.history:
        if not all(math.isfinite(h[k]) for k in ("loss", "loss_rgb_c", "loss_rgb_f")):
            fail(f"engine epoch {h['epoch']} is not finite: {h}")
    if eng_a.state.step != spe * sum(stages) or len(eng_a.history) != sum(stages):
        fail(f"engine ran {eng_a.state.step} steps over {len(eng_a.history)} epochs")
    for n in ("fused_render", "render_bwd_points", "render_bwd_weights"):
        if train_launches[n] != 2 * nerf_steps:
            fail(f"{n}: {train_launches[n]} launches in {nerf_steps} GLOBAL_OPTIM / FINE_TUNE "
                 "steps, not 2 a step")
    if train_launches["fused_mlp_apply"] != 0 or not all(
            val_launches[n] > 0 for n in ("fused_mlp_apply", "fused_render")):
        fail(f"engine validation launches {val_launches}, training {train_launches}")

    # the camera restarts (which one CAM_PARAM epoch never reaches) on run
    # A's cameras: the card's answer against the CPU's
    cam_cpu = copy.deepcopy(eng_a.state.params.cam).cpu()
    got = improve_cameras(eng_a.state.params.cam, load_calibration(cfg.scene_dir, device=dev),
                          res, res)
    want = improve_cameras(cam_cpu, load_calibration(cfg.scene_dir, device="cpu"), res, res)
    restart_err = max(float((got[0][f].cpu() - want[0][f]).abs().max()) for f in want[0])
    print(f"engine restarts on the card: pose adopted {got[1].cpu().tolist()}, cube adopted "
          f"{got[2].cpu().tolist()}; the CPU's masks equal: "
          f"{torch.equal(got[1].cpu(), want[1]) and torch.equal(got[2].cpu(), want[2])}, "
          f"values within {restart_err:.2e}", flush=True)
    if not (torch.equal(got[1].cpu(), want[1]) and torch.equal(got[2].cpu(), want[2])
            and restart_err <= RESTART_ATOL):
        fail("the camera restarts on the card disagree with the CPU")

    # run B: resume from run A's epoch-0 checkpoint in a fresh directory
    eng_b = Engine(cfg.replace(paths=paths("weights_b")), device=dev)
    shutil.copytree(os.path.join(eng_a.ckpt_dir, "0"), os.path.join(eng_b.ckpt_dir, "0"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng_b.ckpt.restore(eng_b.state, 0)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    eng_b.train(resume=True)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    a, b = eng_a.state, eng_b.state
    same = {"p_flat": torch.equal(a.p_flat, b.p_flat), "step": a.step == b.step,
            **{f"stage {i} {f}": bool(torch.equal(getattr(x, f), getattr(y, f)))
               for i, (x, y) in enumerate(zip(a.opt_states, b.opt_states)) for f in ("mu", "nu")},
            **{f"stage {i} count": x.count == y.count
               for i, (x, y) in enumerate(zip(a.opt_states, b.opt_states))}}
    print(f"engine run B (resumed from epoch 0): {resume_s:.2f} s, restore {restore_ms:.1f} ms; "
          f"bit-identical to run A: {same}; p_flat max abs difference "
          f"{float((a.p_flat - b.p_flat).abs().max()):.3e}", flush=True)
    if not all(same.values()):
        fail(f"the resumed run does not end on run A's bits: {same}")

    # the demo from the latest checkpoint
    eng_d = Engine(cfg.replace(mode=1), device=dev)
    reset()
    where[0] = "engine_demo"
    t0 = time.perf_counter()
    demo = eng_d.demo()
    torch.cuda.synchronize()
    demo_s = time.perf_counter() - t0
    where[0] = None
    demo_launches = launches()
    for (module, name), fn in originals.items():
        setattr(module, name, fn)
    print(f"engine demo: {demo} in {demo_s:.2f} s ({smi}); launches {demo_launches}", flush=True)
    if not (demo["count"] == 2 and math.isfinite(demo["psnr"]) and math.isfinite(demo["ssim"])):
        fail(f"engine demo result is not finite: {demo}")
    if not (demo_launches["fused_mlp_apply"] > 0 and demo_launches["fused_render"] > 0
            and demo_launches["render_bwd_points"] == 0):
        fail(f"engine demo launches {demo_launches}")
    shutil.rmtree(work, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    print(f"engine phase: {seconds:.1f} s", flush=True)

    # every counted launch is a recorded call, on the path it was counted on
    counted = {"engine_train": train_launches, "engine_validation": val_launches,
               "engine_demo": demo_launches}
    for path, got in counted.items():
        seen = {name: sum(c["n"] for c in calls.get((path, name), {}).values())
                for name in ("fused_render", "fused_mlp_apply", "fused_render_bwd")}
        want = {"fused_render": got["fused_render"], "fused_mlp_apply": got["fused_mlp_apply"],
                "fused_render_bwd": got["render_bwd_points"]}
        if seen != want or got["render_bwd_points"] != got["render_bwd_weights"]:
            fail(f"{path}: recorded calls {seen} are not the launches counted {got}")
    return {"seconds": seconds, "train_s": train_s, "resume_s": resume_s,
            "restore_ms": restore_ms, "demo_s": demo_s, "demo": demo, "steps_per_epoch": spe,
            "epochs": eng_a.history, "train_launches": train_launches,
            "validation_launches": val_launches, "demo_launches": demo_launches,
            "resume_bit_identical": all(same.values()), "cuts": ENGINE_CUTS,
            "calls": calls, "nerf": cfg.nerf}


def engine_recorder(fn, name: str, shape_of, where: list, calls: dict):
    """``fn`` (a kernel's entry point, called with positional arguments)
    that, while ``where[0]`` names a path, counts its calls there by
    ``shape_of(args)`` and keeps detached copies of the first call's
    arguments at each shape in ``calls[(path, name)][shape]``."""
    def copy_arg(a):
        if isinstance(a, torch.Tensor):
            return a.detach().clone()
        if hasattr(a, "_fields"):
            return type(a)(*map(copy_arg, a))
        return type(a)(map(copy_arg, a)) if isinstance(a, (list, tuple)) else a

    def call(*args):
        if where[0] is not None:
            seen = calls.setdefault((where[0], name), {})
            rec = seen.setdefault(shape_of(args), {"n": 0})
            if rec["n"] == 0:
                rec["args"] = copy_arg(args)
            rec["n"] += 1
        return fn(*args)
    return call


def engine_kernel_numbers(engine: dict, rng, render_tol: dict, mlp_tol: dict) -> dict:
    """Each kernel on each engine path, checked and timed on the inputs
    the engine gave it: at every shape it was called at, the kernel held
    against its plain version (the tolerances of the other phases, no
    plants: those phases plant), its ms, the plain version's, the library
    call's and the bound, per launch.  The forward kernels are timed over
    ``ENGINE_ITERS`` calls, after a collection of the engine's garbage: on
    an H100, 5 calls of the engine's fine K2 once measured 1.251 ms, 20
    calls 0.646 (the train-step phase's K2 0.627 over 5, on a bf16 pack).
    Returns {(path, kernel):
    {shape: numbers with the shape's "launches" and "max_abs_err"}}."""
    import gc

    from mc_nerf_torch.ops.cuda.fused_mlp import PackedMLP, fused_mlp_apply, mlp_plain
    from mc_nerf_torch.ops.cuda.fused_render import (
        fused_render, fused_render_bwd, fused_render_bwd_plain, fused_render_plain)
    from mc_nerf_torch.tools.bwd_check import bwd_errs

    nc, out = engine["nerf"], {}
    gc.collect()
    for (path, name), shapes in engine["calls"].items():
        for shape, rec in shapes.items():
            a, n, label = rec["args"], rec["n"], f"{name} on the engine's {path} inputs ({shape})"
            if name == "fused_mlp_apply":
                ker = fused_mlp_apply(*a)
                torch.cuda.synchronize()
                ref = mlp_plain(*a)
                hold(label, mlp_errs(ker, ref), mlp_tol, {})
                nums = {name: {**mlp_numbers(nc, *a, iters=ENGINE_ITERS),
                               "max_abs_err": float((ker - ref).abs().max())}}
            elif name == "fused_render":
                with torch.no_grad():
                    k_out, k_w = fused_render(*a)
                    torch.cuda.synchronize()
                    p_out, p_w = fused_render_plain(*a)
                e = render_errs(k_out, k_w, p_out, p_w)
                hold(label, e, render_tol, {})
                nums = {name: {**render_forward_numbers(nc, a, ENGINE_ITERS),
                               "max_abs_err": max(e.values())}}
            else:
                ws, bs, depth = a[0], a[1], a[7]
                k = fused_render_bwd(*a)
                torch.cuda.synchronize()
                ref = fused_render_bwd_plain(*a)
                hold(label + " (relative L2)", bwd_errs(k, ref),
                     BWD_TOL["coarse" if depth == nc.coarse_depth else "fine"], {})
                pk = PackedMLP(tuple(ws[:depth]), tuple(bs[:depth]), ws[depth], bs[depth],
                               ws[depth + 1], bs[depth + 1])
                timed = time_backward(nc, {shape: (None, a, pk)}, rng, ws[0].device)
                nums = {kn: {**timed[kn][shape], "max_abs_err": max(
                    float((x - y).abs().max()) for x, y in pairs)}
                        for kn, pairs in (("render_bwd_points", zip(k[2:], ref[2:])),
                                          ("render_bwd_weights", zip([*k[0], *k[1]],
                                                                     [*ref[0], *ref[1]])))}
            for kn, x in nums.items():
                print(f"{kn} on the engine's {path} inputs ({shape}, {n} launches): "
                      f"{x['ms']:.3f} ms (plain {x['plain_ms']:.3f}, bf16 torch chain "
                      f"{x['library_ms']:.3f}, bound {x['bound_ms']:.3f} by {x['bound_by']}), "
                      f"max abs error {x['max_abs_err']:.3e}", flush=True)
                out.setdefault((path, kn), {})[shape] = {**x, "launches": n}
    return out


def per_launch_over_shapes(shapes: dict) -> dict:
    """One kernel's numbers on a path over the shapes it ran at: each time
    and bound the mean per launch (weighted by the launches at each
    shape), the largest error, ``per_shape`` keeping each."""
    n = sum(x["launches"] for x in shapes.values())
    mean = {k: sum(x[k] * x["launches"] for x in shapes.values()) / n
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    by = max(shapes.values(), key=lambda x: x["bound_ms"] * x["launches"])["bound_by"]
    return {"launches": n, "max_abs_err": max(x["max_abs_err"] for x in shapes.values()),
            **mean, "bound_by": by, "per_shape": shapes}


def shaded_errs(out, ref) -> dict:
    if not (bool(torch.isfinite(out).all()) and float(out[:, 4:].abs().max()) == 0.0):
        fail("fused_shaded_mlp output is not finite or its lanes 4..7 are not 0")
    return {"sigma rel": float((out[:, 0] - ref[:, 0]).abs().max() / ref[:, 0].abs().max()),
            "rgb": float((out[:, 1:4] - ref[:, 1:4]).abs().max())}


def grid_passes(nc, params):
    """The two shading passes of a grid-mode training step: (label, module,
    depth, width, skips, samples per ray)."""
    return (("coarse", params.coarse, nc.coarse_depth, nc.coarse_width, nc.coarse_skips,
             nc.samples_coarse),
            ("fine", params.fine, nc.fine_depth, nc.fine_width, nc.fine_skips, nc.samples_fine))


def max_abs(a, b) -> float:
    """The largest abs difference over a backward's outputs."""
    flat = lambda r: [*r[0], *r[1], *r[2:]]
    return max(float((x - y).abs().max()) for x, y in zip(flat(a), flat(b)))


def check_shaded(nc, params, dev, rng, rays, errs) -> dict:
    """fused_shaded_mlp (K4) and its backward (K5) against their plain
    versions at the grid training step's shapes (coarse full 4x128 pack,
    rays x 128 points; fine 8x256, rays x 130) and at odd ones (53 rays x
    7 samples, 7 rays x 1), with planted faults: points mixed in a tile,
    the skip input dropped, another ray's basis; for K5 also a layer's dW
    transposed or zeroed, the skip's dfeat share dropped and the sigmoid's
    derivative dropped on one channel.  Cotangent: a render-shaped loss
    (``tools/bwd_check.shaded_cotangent``).  Returns per pass the numbers
    of the kernels line (K4 and K5 at the training shapes) and K5's
    relative errors."""
    from mc_nerf_torch.tools.bwd_check import needed_macs
    from mc_nerf_torch.ops.cuda.fused_mlp import (
        _flat_weights, _shaded_bwd_launch, fused_shaded_mlp, fused_shaded_mlp_bwd,
        fused_shaded_mlp_bwd_plain, fused_shaded_mlp_plain, pack_mlp_params)
    from mc_nerf_torch.tools.bwd_check import (
        bwd_errs, mixed_in_tiles, pair_swapped, planted_errs_shaded, shaded_cotangent)

    nb = (nc.sh_deg + 1) ** 2
    fwd, bwd, rel = {}, {}, {}
    for label, mlp, depth, width, skips, s_main in grid_passes(nc, params):
        pk = pack_mlp_params(mlp, nc.emb_freqs_xyz, skips)
        ws, bs = _flat_weights(pk)
        for r, s in ((rays, s_main), (53, 7), (7, 1)):
            feat, basis16 = render_inputs(nc, r, s, rng, dev)[:2]

            def fargs(p=pk, b=basis16):
                return (p, feat, b, depth, skips, s, nb)

            k_out = fused_shaded_mlp(*fargs())
            torch.cuda.synchronize()
            p_out = fused_shaded_mlp_plain(*fargs())
            e = shaded_errs(k_out, p_out)
            errs["fused_shaded_mlp"] = max(errs["fused_shaded_mlp"],
                                           float((k_out - p_out).abs().max()))
            hold(f"fused_shaded_mlp {label} rays={r} s={s}", e, SHADED_TOL, {
                "points mixed in a tile": shaded_errs(mixed_in_tiles(k_out), p_out),
                "a pair's tiles swapped": shaded_errs(pair_swapped(k_out), p_out),
                "skip input dropped": shaded_errs(
                    fused_shaded_mlp_plain(*fargs(p=drop_skip(pk, skips))), p_out),
                "another ray's basis": shaded_errs(
                    fused_shaded_mlp_plain(*fargs(b=basis16.roll(1, 0))), p_out)}, 2.0)
            dout8 = shaded_cotangent(p_out, s)
            args = (ws, bs, feat, basis16, dout8, depth, skips, s, nb)
            k = fused_shaded_mlp_bwd(*args)
            torch.cuda.synchronize()
            ref = fused_shaded_mlp_bwd_plain(*args)
            e = bwd_errs(k, ref)
            errs["fused_shaded_mlp_bwd"] = max(errs["fused_shaded_mlp_bwd"], max_abs(k, ref))
            if r == rays:
                spread = bwd_errs(ref, fused_shaded_mlp_bwd_plain(*args[:4], dout8.double(),
                                                                  *args[5:]))
                print(f"shaded backward {label}: the plain version's own spread (fp32 against "
                      "float64 sums): " + ", ".join(f"{n} {v:.3e}" for n, v in spread.items()),
                      flush=True)
                rel[label] = e
            hold(f"shaded backward {label} rays={r} s={s} (relative L2)", e,
                 SHADED_BWD_TOL[label],
                 {**planted_errs_shaded(args, ref), **masked_below(
                     fused_shaded_mlp_bwd_plain, args, ref)})
            del k, ref
            if r == rays:
                last_tile_hold(f"shaded backward {label} rays={r} s={s}", fused_shaded_mlp_bwd,
                               fused_shaded_mlp_bwd_plain, args, 4)
        # times at the training shapes
        feat, basis16 = render_inputs(nc, rays, s_main, rng, dev)[:2]
        p = rays * s_main
        enc = feat.shape[1]
        fa = (pk, feat, basis16, depth, skips, s_main, nb)
        dout8 = shaded_cotangent(fused_shaded_mlp_plain(*fa), s_main)
        args = (ws, bs, feat, basis16, dout8, depth, skips, s_main, nb)
        macs = needed_macs(nc, depth, width, skips, False)
        shade_flops = 2.0 * 3 * nb * p
        t_fwd = bound(2.0 * macs * p,
                      p * enc * 2 + rays * 16 * 4 + p * 8 * 4 + pack_bytes(pk), shade_flops)
        # backward: recompute, dX and dW; reads feat, basis, dout8 and the
        # pack, writes dfeat, dbasis and the fp32 weight gradients
        t_bwd = bound(3 * 2.0 * macs * p,
                      p * enc * 2 + rays * 16 * 4 + p * 8 * 4 + pack_bytes(pk)
                      + p * enc * 4 + rays * 16 * 4 + 2 * pack_bytes(pk), 3 * shade_flops)
        dout_b = torch.as_tensor(rng.normal(size=(p, 32)) * 1e-4, dtype=torch.bfloat16,
                                 device=dev)

        def library_bwd():
            saved = library_bwd_dx(ws, bs, feat, dout_b, depth, skips)
            library_bwd_dw(*saved, dout_b)

        fwd[label] = {"ms": cuda_ms(lambda: fused_shaded_mlp(*fa)),
                      "plain_ms": cuda_ms(lambda: fused_shaded_mlp_plain(*fa), 3),
                      "library_ms": cuda_ms(lambda: library_mlp(pk, feat, depth, skips)),
                      "bound_ms": t_fwd[0], "bound_by": t_fwd[1]}
        bwd[label] = {"ms": cuda_ms(lambda: fused_shaded_mlp_bwd(*args), 3),
                      "plain_ms": cuda_ms(lambda: fused_shaded_mlp_bwd_plain(*args), 2),
                      "library_ms": cuda_ms(library_bwd, 3),
                      "bound_ms": t_bwd[0], "bound_by": t_bwd[1],
                      "points_stage": points_stage_numbers(args, True, dout_b, macs),
                      "weight_stage": weight_stage_numbers(
                          ws, bs, feat, skips, True,
                          lambda work: _shaded_bwd_launch(*args, work),
                          library_bwd_dx(ws, bs, feat, dout_b, depth, skips), dout_b, macs, pk)}
        torch.cuda.reset_peak_memory_stats()
        fused_shaded_mlp_bwd(*args)
        print(f"shaded backward {label} pass ({rays} x {s_main} points): peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the workspace included)",
              flush=True)
    return {"fused_shaded_mlp": fwd, "fused_shaded_mlp_bwd": bwd, "rel": rel}


def fused_mlp_vjp_phase(nc, params, dev, rng, rays, errs) -> dict:
    """The differentiable ``fused_mlp`` (K1 forward, K6 backward) through
    autograd at the coarse full 4x128 pack over rays x 48 points and the
    fine 8x256 pack over rays x 32, launches counted from 0 just before;
    then K6 against ``fused_mlp_bwd_plain`` at the same shapes under an MSE
    of the packed output (``tools/bwd_check.mlp_cotangent``), with planted
    faults, and its times."""
    from mc_nerf_torch.tools.bwd_check import needed_macs
    from mc_nerf_torch.ops.cuda.fused_mlp import (
        _flat_weights, _mlp_bwd_launch, fused_mlp, fused_mlp_apply, fused_mlp_bwd,
        fused_mlp_bwd_plain, mlp_plain, pack_mlp_params)
    from mc_nerf_torch.tools.bwd_check import (
        bwd_errs, mixed_in_tiles, mlp_cotangent, pair_swapped, planted_errs_mlp)

    passes = (("coarse", params.coarse, nc.coarse_depth, nc.coarse_width, nc.coarse_skips,
               nc.occ_coarse_samples),
              ("fine", params.fine, nc.fine_depth, nc.fine_width, nc.fine_skips, 32))
    inputs = {}
    for label, mlp, depth, width, skips, s in passes:
        pk = pack_mlp_params(mlp, nc.emb_freqs_xyz, skips)
        feat = render_inputs(nc, rays, s, rng, dev)[0]
        inputs[label] = (pk, feat, mlp_cotangent(mlp_plain(pk, feat, depth, skips)))
    torch.cuda.synchronize()
    fused_mlp_apply.launches = 0
    fused_mlp_bwd.launches = 0
    for label, mlp, depth, width, skips, s in passes:
        _pk, feat, dout = inputs[label]
        f = feat.detach().clone().requires_grad_()
        out = fused_mlp(pack_mlp_params(mlp, nc.emb_freqs_xyz, skips, dtype=torch.float32), f,
                        depth, skips)
        out.backward(dout)
        if not (bool(torch.isfinite(f.grad.float()).all())
                and all(bool(torch.isfinite(q.grad).all()) for q in mlp.parameters())):
            fail(f"fused_mlp VJP {label}: gradients are not finite")
        mlp.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    launches = {"fused_mlp_apply": fused_mlp_apply.launches,
                "fused_mlp_bwd": fused_mlp_bwd.launches}
    print(f"fused_mlp VJP (coarse {rays} x 48, fine {rays} x 32): launches {launches}", flush=True)
    if launches != {"fused_mlp_apply": 2, "fused_mlp_bwd": 2}:
        fail(f"fused_mlp's VJP should launch its forward and backward once per pack: {launches}")
    numbers, fwd, rel = {}, {}, {}
    for label, mlp, depth, width, skips, s in passes:
        pk, feat, dout = inputs[label]
        # K1, the VJP's forward, against its plain version and timed
        ker, ref = fused_mlp_apply(pk, feat, depth, skips), mlp_plain(pk, feat, depth, skips)
        errs["fused_mlp_apply"] = max(errs["fused_mlp_apply"], float((ker - ref).abs().max()))
        hold(f"fused_mlp_apply {label} full pack P={feat.shape[0]}", mlp_errs(ker, ref),
             {"rel": MLP_RTOL}, {"points mixed in a tile": mlp_errs(mixed_in_tiles(ker), ref),
                                 "a pair's tiles swapped": mlp_errs(pair_swapped(ker), ref)}, 2.0)
        del ker, ref
        p, enc = feat.shape
        t_f = bound(2.0 * needed_macs(nc, depth, width, skips, False) * p,
                    p * enc * 2 + p * 32 * 4 + pack_bytes(pk))
        fwd[label] = {"ms": cuda_ms(lambda: fused_mlp_apply(pk, feat, depth, skips)),
                      "plain_ms": cuda_ms(lambda: mlp_plain(pk, feat, depth, skips), 3),
                      "library_ms": cuda_ms(lambda: library_mlp(pk, feat, depth, skips)),
                      "bound_ms": t_f[0], "bound_by": t_f[1]}
        ws, bs = _flat_weights(pk)
        args = (ws, bs, feat, dout, depth, skips)
        k = fused_mlp_bwd(*args)
        torch.cuda.synchronize()
        ref = fused_mlp_bwd_plain(*args)
        spread = bwd_errs(ref, fused_mlp_bwd_plain(*args[:3], dout.double(), *args[4:]))
        print(f"fused_mlp backward {label}: the plain version's own spread (fp32 against "
              "float64 sums): " + ", ".join(f"{n} {v:.3e}" for n, v in spread.items()), flush=True)
        rel[label] = bwd_errs(k, ref)
        errs["fused_mlp_bwd"] = max(errs["fused_mlp_bwd"], max_abs(k, ref))
        hold(f"fused_mlp backward {label} P={feat.shape[0]} (relative L2)", rel[label],
             MLP_BWD_TOL[label],
             {**planted_errs_mlp(args, ref), **masked_below(fused_mlp_bwd_plain, args, ref)})
        last_tile_hold(f"fused_mlp backward {label} P={feat.shape[0]}", fused_mlp_bwd,
                       fused_mlp_bwd_plain, args, 3)
        p, enc = feat.shape
        macs = needed_macs(nc, depth, width, skips, False)
        t_b = bound(3 * 2.0 * macs * p, p * enc * 2 + p * 32 * 4 + pack_bytes(pk) + p * enc * 4
                    + 2 * pack_bytes(pk))
        dout_b = dout.bfloat16()

        def library_bwd():
            saved = library_bwd_dx(ws, bs, feat, dout_b, depth, skips)
            library_bwd_dw(*saved, dout_b)

        numbers[label] = {"ms": cuda_ms(lambda: fused_mlp_bwd(*args)),
                          "plain_ms": cuda_ms(lambda: fused_mlp_bwd_plain(*args), 3),
                          "library_ms": cuda_ms(library_bwd),
                          "bound_ms": t_b[0], "bound_by": t_b[1],
                          "points_stage": points_stage_numbers(args, False, dout_b, macs),
                          "weight_stage": weight_stage_numbers(
                              ws, bs, feat, skips, False,
                              lambda work: _mlp_bwd_launch(*args, work),
                              library_bwd_dx(ws, bs, feat, dout_b, depth, skips), dout_b, macs,
                              pk)}
    return {"launches": launches, "fused_mlp_apply": fwd, "fused_mlp_bwd": numbers, "rel": rel}


def grid_demo_phase(cfg, params, dev, split, poses, K, h: int, w: int, errs) -> dict:
    """The demo in the grid fine mode (``eval.fine_mode="grid"``: uniform
    128 coarse samples through the sigma-only ``fused_mlp_apply``, 26 bins
    x 5 fine samples per ray through ``fused_shaded_mlp``, no occupancy
    refresh) over two 800x800 views, K1 and K4 counted from 0 just before;
    one frame timed; one chunk of the frame through the plain route
    against the kernel route; K1 and K4 at one eval chunk's shapes
    (16384 x 128 coarse, 16384 x 130 fine) against their plain versions,
    and their times."""
    from mc_nerf_torch.tools.bwd_check import mixed_in_tiles, needed_macs, pair_swapped
    from mc_nerf_torch.cameras.rays import pixel_grid, rays_for_pixels
    from mc_nerf_torch.models.nerf import pack_eval_params, render_rays_eval
    from mc_nerf_torch.ops.cuda.fused_mlp import (
        encode_kernel_order, fused_mlp_apply, fused_shaded_mlp, fused_shaded_mlp_plain,
        mlp_plain)
    from mc_nerf_torch.train.engine import demo
    from mc_nerf_torch.train.steps import make_render_fn

    nc = cfg.nerf
    cfg_g = dataclasses.replace(cfg, eval=dataclasses.replace(cfg.eval, fine_mode="grid"))
    render = make_render_fn(cfg_g, h, w, device=dev)
    render(params, poses[0], K)               # warm-up frame
    torch.cuda.synchronize()
    fused_mlp_apply.launches = 0
    fused_shaded_mlp.launches = 0
    t0 = time.perf_counter()
    result = demo(params, split, cfg_g, device=dev, cull=True)
    torch.cuda.synchronize()
    demo_s = time.perf_counter() - t0
    launches = {"fused_mlp_apply": fused_mlp_apply.launches,
                "fused_shaded_mlp": fused_shaded_mlp.launches}
    print(f"grid demo: {result} in {demo_s:.2f} s; launches {launches}", flush=True)
    if not all(n > 0 for n in launches.values()):
        fail(f"a kernel of the grid demo was not launched: {launches}")
    if not (result["count"] == 2 and math.isfinite(result["psnr"])
            and math.isfinite(result["ssim"])):
        fail(f"grid demo result is not finite: {result}")
    frame_ms = cuda_ms(lambda: render(params, poses[1], K), 1)
    rgb, depth, opac = render(params, poses[1], K)
    if tuple(rgb.shape) != (h, w, 3) or not bool(torch.isfinite(rgb).all()
                                                 & torch.isfinite(depth).all()):
        fail("grid frame is not finite or has the wrong shape")
    chunk = cfg.eval.rays_per_chunk
    print(f"grid frame: {frame_ms:.1f} ms per 800x800 frame, {h * w / frame_ms * 1e3:.0f} rays/s "
          f"({math.ceil(h * w / chunk)} chunks of {chunk} rays); rgb {float(rgb.min()):.3f}.."
          f"{float(rgb.max()):.3f} (std {float(rgb.std()):.4f}), opacity mean "
          f"{float(opac.mean()):.4f}", flush=True)

    packed = pack_eval_params(params, nc)
    pix = pixel_grid(h, w, device=dev)[h * w // 2 - chunk // 2: h * w // 2 + chunk // 2]
    rd, ro = rays_for_pixels(pix, torch.as_tensor(poses[1], device=dev),
                             torch.as_tensor(K, device=dev))
    ker = render_rays_eval(params, rd, ro, nc, torch.bfloat16, fine_mode="grid", packed=packed)

    def slice_errs(pln):
        span = nc.far - nc.near
        return {"max rgb/opacity": max(float((ker[i] - pln[i]).abs().max()) for i in (0, 2)),
                "max depth/(far-near)": float((ker[1] - pln[1]).abs().max()) / span,
                "mean rgb": float((ker[0] - pln[0]).abs().mean())}

    broken = copy.deepcopy(params)
    with torch.no_grad():
        broken.fine.trunk[nc.fine_skips[0]].weight[:, :nc.embed_dim] = 0
    hold("grid slice chunk, kernel route vs bf16 plain route",
         slice_errs(render_rays_eval(params, rd, ro, nc, torch.bfloat16, fine_mode="grid")),
         {"max rgb/opacity": SLICE_ATOL, "max depth/(far-near)": SLICE_ATOL,
          "mean rgb": SLICE_MEAN_ATOL},
         {"fine skip input dropped": slice_errs(render_rays_eval(
             broken, rd, ro, nc, torch.bfloat16, fine_mode="grid"))})
    del broken

    # K1 and K4 at one eval chunk's shapes
    rng = np.random.default_rng(SEED + 1)
    nb = (nc.sh_deg + 1) ** 2
    sc, sf = nc.samples_coarse, nc.samples_fine
    feat_c = encode_kernel_order(torch.as_tensor(rng.uniform(-3.5, 3.5, (chunk * sc, 3)),
                                                 dtype=torch.float32, device=dev),
                                 nc.emb_freqs_xyz)
    feat_f, basis16 = render_inputs(nc, chunk, sf, rng, dev)[:2]
    lib_c = (packed[0], feat_c, nc.coarse_depth, nc.coarse_skips)
    sh_args = (packed[1], feat_f, basis16, nc.fine_depth, nc.fine_skips, sf, nb)
    ker_c, ref_c = fused_mlp_apply(*lib_c), mlp_plain(*lib_c)
    errs["fused_mlp_apply"] = max(errs["fused_mlp_apply"], float((ker_c - ref_c).abs().max()))
    hold(f"fused_mlp_apply grid eval chunk ({chunk} x {sc})", mlp_errs(ker_c, ref_c),
         {"rel": MLP_RTOL}, {"points mixed in a tile": mlp_errs(mixed_in_tiles(ker_c), ref_c),
                             "a pair's tiles swapped": mlp_errs(pair_swapped(ker_c), ref_c)}, 2.0)
    ker_f, ref_f = fused_shaded_mlp(*sh_args), fused_shaded_mlp_plain(*sh_args)
    errs["fused_shaded_mlp"] = max(errs["fused_shaded_mlp"], float((ker_f - ref_f).abs().max()))
    hold(f"fused_shaded_mlp grid eval chunk ({chunk} x {sf})", shaded_errs(ker_f, ref_f),
         SHADED_TOL, {"points mixed in a tile": shaded_errs(mixed_in_tiles(ker_f), ref_f),
                      "a pair's tiles swapped": shaded_errs(pair_swapped(ker_f), ref_f)}, 2.0)
    del ker_c, ref_c, ker_f, ref_f
    emb = feat_c.shape[1]
    p_c, p_f = chunk * sc, chunk * sf
    macs_c = needed_macs(nc, nc.coarse_depth, nc.coarse_width, nc.coarse_skips, True)
    macs_f = needed_macs(nc, nc.fine_depth, nc.fine_width, nc.fine_skips, False)
    b_c = bound(2.0 * macs_c * p_c, p_c * emb * 2 + p_c * 32 * 4 + pack_bytes(packed[0]))
    b_f = bound(2.0 * macs_f * p_f, p_f * emb * 2 + chunk * 16 * 4 + p_f * 8 * 4
                + pack_bytes(packed[1]), 2.0 * 3 * nb * p_f)
    numbers = {
        "fused_mlp_apply": {"ms": cuda_ms(lambda: fused_mlp_apply(*lib_c)),
                            "plain_ms": cuda_ms(lambda: mlp_plain(*lib_c), 2),
                            "library_ms": cuda_ms(lambda: library_mlp(*lib_c)),
                            "bound_ms": b_c[0], "bound_by": b_c[1]},
        "fused_shaded_mlp": {"ms": cuda_ms(lambda: fused_shaded_mlp(*sh_args)),
                             "plain_ms": cuda_ms(lambda: fused_shaded_mlp_plain(*sh_args), 2),
                             "library_ms": cuda_ms(lambda: library_mlp(
                                 packed[1], feat_f, nc.fine_depth, nc.fine_skips)),
                             "bound_ms": b_f[0], "bound_by": b_f[1]},
    }
    for name, t in numbers.items():
        print(f"{name} grid eval chunk: {t['ms']:.3f} ms (plain {t['plain_ms']:.3f}, bf16 "
              f"matmul chain {t['library_ms']:.3f}, bound {t['bound_ms']:.3f} by "
              f"{t['bound_by']})", flush=True)
    return {"launches": launches, "frame_ms": frame_ms, "rays_per_s": h * w / frame_ms * 1e3,
            "demo_s": demo_s, "result": result, "numbers": numbers}


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    from mc_nerf_torch.tools.bwd_check import needed_macs
    from mc_nerf_torch.config import Config
    from mc_nerf_torch.data.blender import SplitData
    from mc_nerf_torch.models.nerf import pack_eval_params, render_rays_eval
    from mc_nerf_torch.models.sh import sh_basis
    from mc_nerf_torch.cameras.rays import pixel_grid, rays_for_pixels
    from mc_nerf_torch.ops.cuda import _build
    from mc_nerf_torch.ops.cuda.fused_mlp import (
        BASIS_LANES, encode_kernel_order, fused_mlp_apply, fused_shaded_mlp, fused_shaded_mlp_bwd,
        mlp_plain)
    from mc_nerf_torch.ops.cuda.fused_render import (
        fused_render, fused_render_plain, max_samples, max_samples_bwd, render_bwd_points,
        render_bwd_weights)
    from mc_nerf_torch.tools.bwd_check import mixed_in_tiles, pair_swapped, render_scan_late
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
    print(f"samples per ray at the fine pack, at most: forward {max_samples(packed_f)}, "
          f"backward {max_samples_bwd(packed_f)} (2**31 - 1: no limit)")
    nb = (nc.sh_deg + 1) ** 2
    rng = np.random.default_rng(SEED)
    errs = {"fused_mlp_apply": 0.0, "fused_render": 0.0}   # max abs, for the kernels line
    mlp_tol = {"rel": MLP_RTOL}
    render_tol = {"rgb/opacity": RENDER_ATOL, "depth": DEPTH_ATOL, "wsel": RENDER_ATOL}

    # ---- kernel vs plain at the main path's widths
    n_pts = 65536 + 37
    xyz = torch.as_tensor(rng.uniform(-3.5, 3.5, (n_pts, 3)), dtype=torch.float32, device=dev)
    feat = encode_kernel_order(xyz, nc.emb_freqs_xyz)
    for label, pk, depth, skips in (("coarse sigma-only", packed_c, nc.coarse_depth, nc.coarse_skips),
                                    ("fine full", packed_f, nc.fine_depth, nc.fine_skips)):
        ker = fused_mlp_apply(pk, feat, depth, skips)
        torch.cuda.synchronize()
        ref = mlp_plain(pk, feat, depth, skips)
        errs["fused_mlp_apply"] = max(errs["fused_mlp_apply"], float((ker - ref).abs().max()))
        hold(f"fused_mlp_apply {label} P={n_pts}", mlp_errs(ker, ref), mlp_tol, {
            "points mixed in a tile": mlp_errs(mixed_in_tiles(ker), ref),
            "a pair's tiles swapped": mlp_errs(pair_swapped(ker), ref),
            "skip input dropped": mlp_errs(mlp_plain(drop_skip(pk, skips), feat, depth, skips), ref),
            "first layer lost": mlp_errs(mlp_plain(drop_first(pk), feat, depth, skips), ref),
        }, 2.0)

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
                "first layer lost": render_errs(
                    *fused_render_plain(*args(pk=drop_first(packed_f))), p_out, p_w),
                "another ray's basis": render_errs(
                    *fused_render_plain(*args(bas=basis16.roll(1, 0))), p_out, p_w),
                "scan one sample late": render_errs(*render_scan_late(*args()), p_out, p_w),
            }, 2.0)

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
    occ = refresh_occupancy(params, cfg, dev, 0)
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
    demo_launches = dict(launches)
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

    # ---- the training slice: forward at the training packs, the backward kernels
    t_rays = cfg.train.rays_per_batch
    train_numbers = {"fused_render": check_train_forward(nc, params, dev, rng, t_rays, errs,
                                                         render_tol)}
    bwd, bwd_max_abs = check_backward(nc, params, dev, rng, t_rays, BWD_TOL)
    errs.update(bwd_max_abs)
    train_numbers.update(time_backward(nc, bwd, rng, dev))
    for name, passes in train_numbers.items():
        for label, t in passes.items():
            print(f"{name}, training {label} pass ({t_rays} rays): {t['ms']:.3f} ms (plain "
                  f"{t['plain_ms']:.3f}, bf16 torch chain {t['library_ms']:.3f}, bound "
                  f"{t['bound_ms']:.3f} by {t['bound_by']}"
                  + (f", floor {t['floor_ms']:.3f}" if "floor_ms" in t else "") + ")",
                  flush=True)

    # ---- the GLOBAL_OPTIM train step at full width
    train = train_phase(cfg, dev, h, w, (fused_render, render_bwd_points, render_bwd_weights),
                        N_TRAIN, {"loss rel": STEP_LOSS_RTOL, **STEP_GRAD_TOL})

    # ---- the grid fine mode: its kernels, the demo, the train step
    errs.update({"fused_shaded_mlp": 0.0, "fused_shaded_mlp_bwd": 0.0, "fused_mlp_bwd": 0.0})
    shaded = check_shaded(nc, params, dev, rng, t_rays, errs)
    for name in ("fused_shaded_mlp", "fused_shaded_mlp_bwd"):
        for label, t in shaded[name].items():
            print(f"{name}, grid training {label} pass: {t['ms']:.3f} ms (plain "
                  f"{t['plain_ms']:.3f}, bf16 torch chain {t['library_ms']:.3f}, bound "
                  f"{t['bound_ms']:.3f} by {t['bound_by']})" + weight_stage_line(t), flush=True)
    vjp = fused_mlp_vjp_phase(nc, params, dev, rng, t_rays, errs)
    for label, t in vjp["fused_mlp_apply"].items():
        print(f"fused_mlp_apply, VJP {label} pack: {t['ms']:.3f} ms (plain {t['plain_ms']:.3f}, "
              f"bf16 torch chain {t['library_ms']:.3f}, bound {t['bound_ms']:.3f} by "
              f"{t['bound_by']})", flush=True)
    for label, t in vjp["fused_mlp_bwd"].items():
        print(f"fused_mlp_bwd, {label} pack: {t['ms']:.3f} ms (plain {t['plain_ms']:.3f}, bf16 "
              f"torch chain {t['library_ms']:.3f}, bound {t['bound_ms']:.3f} by "
              f"{t['bound_by']})" + weight_stage_line(t), flush=True)
    grid_demo = grid_demo_phase(cfg, params, dev, split, poses, K, h, w, errs)
    cfg_grid = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, fine_mode="grid"))
    grid_train = train_phase(cfg_grid, dev, h, w, (fused_shaded_mlp, fused_shaded_mlp_bwd),
                             N_TRAIN_GRID, GRID_STEP_TOL)

    # ---- the engine: three stages, a resume, the demo from a checkpoint
    engine = engine_phase(dev, smi, {k.__name__: k for k in (
        fused_render, render_bwd_points, render_bwd_weights, fused_mlp_apply)})

    replaces = {"fused_mlp_apply": "mc_nerf_tpu/ops/pallas/fused_mlp.py:241",
                "fused_render": "mc_nerf_tpu/ops/pallas/fused_render.py:211",
                "render_bwd_points": "mc_nerf_tpu/ops/pallas/fused_render.py:290",
                "render_bwd_weights": "mc_nerf_tpu/ops/pallas/fused_render.py:290",
                "fused_shaded_mlp": "mc_nerf_tpu/ops/pallas/fused_mlp.py:381",
                "fused_shaded_mlp_bwd": "mc_nerf_tpu/ops/pallas/fused_mlp.py:423",
                "fused_mlp_bwd": "mc_nerf_tpu/ops/pallas/fused_mlp.py:739"}
    sources = {"fused_mlp_apply": "mc_nerf_torch/csrc/fused_mlp.cu",
               "fused_render": "mc_nerf_torch/csrc/fused_render.cu",
               "render_bwd_points": "mc_nerf_torch/csrc/fused_render_bwd.cu",
               "render_bwd_weights": "mc_nerf_torch/csrc/fused_render_bwd.cu",
               "fused_shaded_mlp": "mc_nerf_torch/csrc/fused_shaded.cu",
               "fused_shaded_mlp_bwd": "mc_nerf_torch/csrc/fused_mlp_bwd.cu",
               "fused_mlp_bwd": "mc_nerf_torch/csrc/fused_mlp_bwd.cu"}

    def entry(name, path, launches, numbers):
        return {"name": name, "path": path, "route": "cuda", "source": sources[name],
                "replaces": replaces[name], "launches": launches, "max_abs_err": errs[name],
                **numbers}

    # one entry per kernel and path, each path's launches counted from 0
    # just before it ran: the demo (2 frames; times at one eval chunk, kept
    # in per_pass too) and the train step (N_TRAIN steps; times per launch,
    # the mean of the coarse and the fine pass, each pass kept in per_pass)
    kernels = []
    for name in ("fused_mlp_apply", "fused_render"):
        chunk_numbers = {"ms": times[name][0], "plain_ms": times[name][1],
                         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                         "library_ms": times[name][2]}
        kernels.append(entry(name, "demo", demo_launches[name],
                             {**chunk_numbers, "per_pass": {"eval chunk": chunk_numbers}}))
    kernels += [{
        "name": name, "path": "train_step", "route": "cuda", "source": sources[name],
        "replaces": replaces[name], "launches": train["launches"][name],
        "launches_per_step": train["launches"][name] / N_TRAIN, "max_abs_err": errs[name],
        **per_launch(train_numbers[name]),
    } for name in ("fused_render", "render_bwd_points", "render_bwd_weights")]
    # the grid paths: the demo (2 frames; times at one eval chunk), the
    # train step (N_TRAIN_GRID steps; per launch, the mean of both passes),
    # the fused_mlp VJP (one launch per pack; the mean of both packs)
    kernels += [entry(name, "demo_grid", grid_demo["launches"][name],
                      {**grid_demo["numbers"][name],
                       "per_pass": {"grid eval chunk": grid_demo["numbers"][name]}})
                for name in ("fused_mlp_apply", "fused_shaded_mlp")]
    kernels += [{**entry(name, "train_step_grid", grid_train["launches"][name],
                         per_launch(shaded[name])),
                 "launches_per_step": grid_train["launches"][name] / N_TRAIN_GRID}
                for name in ("fused_shaded_mlp", "fused_shaded_mlp_bwd")]
    kernels += [entry(name, "fused_mlp_vjp", vjp["launches"][name], per_launch(vjp[name]))
                for name in ("fused_mlp_apply", "fused_mlp_bwd")]
    # the engine: run A's training steps, its validation renders and the
    # demo, each kernel checked and timed on the inputs the engine gave it
    nerf_steps = engine["steps_per_epoch"] * sum(engine["cuts"]["stages"][1:])
    for (path, name), shapes in engine_kernel_numbers(engine, rng, render_tol, mlp_tol).items():
        numbers = per_launch_over_shapes(shapes)
        kernels.append({"name": name, "path": path, "route": "cuda", "source": sources[name],
                        "replaces": replaces[name], **numbers,
                        **({"launches_per_step": numbers["launches"] / nerf_steps}
                           if path == "engine_train" else {})})
    print(json.dumps({"grid_demo": {k: v for k, v in grid_demo.items() if k != "numbers"},
                      "grid_train": {k: v for k, v in grid_train.items() if k != "launches"},
                      "grid_train_launches": grid_train["launches"],
                      "shaded_bwd_rel_l2": shaded["rel"], "fused_mlp_bwd_rel_l2": vjp["rel"],
                      "card": smi}))
    print(json.dumps({"frame_ms": frame_ms, "rays_per_s": h * w / frame_ms * 1e3,
                      "launches_per_frame": {k: v / 2 for k, v in demo_launches.items()},
                      "occupied_share": occ_share, "card": smi}))
    print(json.dumps({"train": {k: v for k, v in train.items() if k != "launches"},
                      "train_launches": train["launches"],
                      "backward_rel_l2": {k: v[0] for k, v in bwd.items()}, "card": smi}))
    print(json.dumps({"engine": {k: v for k, v in engine.items()
                                 if not k.endswith("launches") and k not in ("calls", "nerf")},
                      "card": smi}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
