"""Smoke test of the PyTorch port on one NVIDIA GPU: build, check, render, train.

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
   shapes, beside the plain version's own fp32 spread; timings of each.
5. The GLOBAL_OPTIM step at full width on the workload ``bench.py`` times
   (``tools/scene.train_workload``): the kernel route and the plain route
   timed in turns with CUDA events, the launch counts of the kernel route
   (each kernel twice per step), one step's loss and gradients on both
   routes compared, 20 steps on one fixed batch (the rgb loss must fall),
   one stage-0 and one stage-2 step, and a ``torch.profiler`` profile of
   both routes (device busy share, top device and host operations).
6. Prints the ``kernels`` JSON line, one entry per kernel and path (the
   demo; the train step): that path's launches, time per launch at its
   shapes, bound, plain and library times; then
   ``{"ok": true, "device": ...}`` last.

Every kernel check also measures planted faults against the same plain
version (points mixed up, the skip input dropped, the first layer lost,
another ray's SH basis; for the backward also a layer's dW transposed or
zeroed, the skip's dfeat share dropped, the suffix scan shifted by one:
``tools/bwd_check.py``) and fails if one of them would pass.  Bounds
count only the work the function needs (not the pad lane, the packed
head's zero blocks or the backward's workspace).  The weights are the seeded test
scene of ``mc_nerf_torch.tools.scene`` (He-scaled, so the field's density
and colour vary with the point).  Any failed check exits non-zero.  Needs
one CUDA card; imports nothing of the JAX package.
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
N_FIXED = 20               # steps on one fixed batch: the rgb loss must fall


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
    from mc_nerf_torch.ops.cuda.fused_mlp import pack_mlp_params
    from mc_nerf_torch.ops.cuda.fused_render import fused_render, fused_render_plain

    nb = (nc.sh_deg + 1) ** 2
    passes = {}
    for label, mlp, depth, width, skips, s, emit in train_passes(nc, params):
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
        })
        p = rays * s
        # read: feat, basis, z, noise (and noise_sel), the pack; written:
        # ray_out (and wsel)
        nbytes = (p * feat.shape[1] * 2 + rays * basis16.shape[1] * 4 + p * 4 * (3 if emit else 2)
                  + rays * 8 * 4 + (p * 4 if emit else 0) + pack_bytes(pk))
        t_bound, by = bound(2.0 * needed_macs(nc, depth, width, skips, False) * p, nbytes)
        passes[label] = {"ms": cuda_ms(lambda: fused_render(*args())),
                         "plain_ms": cuda_ms(lambda: fused_render_plain(*args()), 3),
                         "library_ms": cuda_ms(lambda: library_mlp(pk, feat, depth, skips)),
                         "bound_ms": t_bound, "bound_by": by}
    return passes


def check_backward(nc, params, dev, rng, rays, bwd_tol):
    """The backward kernels against fused_render_bwd_plain at the training
    shapes of both passes on the scene's weights, beside the plain
    version's own fp32 spread (against float64 sums of the same rounding
    points), with planted faults; the cotangent is an MSE's
    (``tools/bwd_check.mse_cotangent``).  Returns per pass (relative
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
             planted_errs(args, ref))
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
    workspace that design (a) passes between them is not needed work."""
    from mc_nerf_torch.ops.cuda.fused_render import (
        _bwd_fns, fused_render_bwd_plain, render_bwd_points, render_bwd_weights)

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
        out["render_bwd_points"][label] = {
            "ms": cuda_ms(lambda: render_bwd_points(*pts_args)), "plain_ms": plain_ms,
            "library_ms": cuda_ms(lambda: library_bwd_dx(ws, bs, feat, dout_b, depth, skips)),
            "bound_ms": b_pts[0], "bound_by": b_pts[1]}
        out["render_bwd_weights"][label] = {
            "ms": cuda_ms(lambda: render_bwd_weights(ws, bs, feat, rays, s, skips, work)),
            "plain_ms": plain_ms,
            "library_ms": cuda_ms(lambda: library_bwd_dw(*saved, dout_b)),
            "bound_ms": b_w[0], "bound_by": b_w[1]}
        del work, saved
    return out


def train_phase(cfg, dev, h: int, w: int) -> dict:
    """The GLOBAL_OPTIM step at full width on the workload bench.py times
    (``tools/scene.train_workload``), from the middle of the schedule (the
    BARF gate half open): timed steps through the kernels with their launch
    counts, one step's loss and gradients against the plain route, the
    plain route timed, the rgb loss over 20 steps on one fixed batch, one
    stage-0 and one stage-2 step, and a profile of both routes."""
    import dataclasses

    from mc_nerf_torch.ops.cuda.fused_render import (
        fused_render, render_bwd_points, render_bwd_weights)
    from mc_nerf_torch.tools.bwd_check import rel_l2
    from mc_nerf_torch.tools.profile_step import profile_steps
    from mc_nerf_torch.tools.scene import STEPS_PER_EPOCH, TOTAL_STEPS, train_workload
    from mc_nerf_torch.train.optim import build_optimizers, flatten_params
    from mc_nerf_torch.train.steps import TrainState, draw_step, make_loss_fn, make_stage_step

    counters = (fused_render, render_bwd_points, render_bwd_weights)
    params, data = train_workload(cfg, SEED, dev, img_h=h, img_w=w)
    p_flat = flatten_params(params)
    txs, states = build_optimizers(cfg, params, p_flat, STEPS_PER_EPOCH)
    state = TrainState(params, p_flat, states, TOTAL_STEPS // 2)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n_img = data.images_u8.shape[0]
    rays = cfg.train.rays_per_batch

    def draw(stage):
        return draw_step(cfg, stage, n_img, h, w, True, gen)

    cfg_plain = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, use_pallas=False))
    step_k = make_stage_step(cfg, 1, txs[1], h, w, TOTAL_STEPS)
    step_p = make_stage_step(cfg_plain, 1, txs[1], h, w, TOTAL_STEPS)
    for _ in range(3):
        step_k(state, data, draw(1))
    draws = [draw(1) for _ in range(N_TRAIN)]

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
        ds = draws if launches is None else [draw(1) for _ in range(N_TRAIN)]
        if launches is None:
            for c in counters:
                c.launches = 0
        rounds[route].append(timed(step_k if route == "kernel" else step_p, ds))
        if launches is None:
            launches = {c.__name__: c.launches for c in counters}
            print(f"launches over {N_TRAIN} kernel-route steps: {launches}", flush=True)
            if any(n != 2 * N_TRAIN for n in launches.values()):
                fail(f"each kernel should launch twice per step: {launches}")
    step_ms = sum(rounds["kernel"]) / 2
    plain_ms = sum(rounds["plain"]) / 2
    print(f"train step ms per round (kernel, plain, plain, kernel): {rounds['kernel'][0]:.3f}, "
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
    hold("train step, kernel route vs bf16 plain route", route_errs(ker, pln),
         {"loss rel": STEP_LOSS_RTOL, **STEP_GRAD_TOL},
         {"fine skip input dropped": route_errs(loss_and_grads(cfg_plain, broken), pln)})
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
    print(f"rgb loss (coarse + fine) over {N_FIXED} steps on one batch: {rgb[0]:.6f} -> "
          f"{rgb[-1]:.6f}", flush=True)
    if not rgb[-1] < rgb[0]:
        fail("the rgb loss did not fall over 20 steps on one fixed batch")

    others = {}
    for stage in (0, 2):
        m = make_stage_step(cfg, stage, txs[stage], h, w, TOTAL_STEPS)(state, data, draw(stage))
        others[stage] = {k: float(v) for k, v in m.items()}
        if not all(math.isfinite(v) for v in others[stage].values()):
            fail(f"stage {stage} step is not finite: {others[stage]}")
    print(f"stage 0 step: {others[0]}\nstage 2 step: {others[2]}", flush=True)

    profiles = {}
    for route, step, n in (("kernel", step_k, 3), ("plain", step_p, 2)):
        wall, rows, host = profile_steps(lambda: step(state, data, draw(1)), n)
        busy = sum(r[0] for r in rows)
        profiles[route] = {"step_ms": wall, "kernel_ms": busy, "busy_share": busy / wall,
                           "top": [{"ms": ms, "calls": c, "name": nm[:80]}
                                   for ms, c, nm in rows[:8]],
                           "host_top": [{"ms": ms, "calls": c, "name": nm[:60]}
                                        for ms, c, nm in host[:6]]}
        print(f"profile, {route} route: {wall:.1f} ms wall, {busy:.1f} ms of kernels, busy "
              f"share {busy / wall:.3f}; top: " + "; ".join(
                  f"{nm[:60]} {ms:.2f} ms x{c}" for ms, c, nm in rows[:8])
              + "; host (self CPU): " + "; ".join(
                  f"{nm[:40]} {ms:.2f} ms x{c}" for ms, c, nm in host[:6]), flush=True)
    return {"train_step_ms": step_ms, "train_rays_per_s": rays / step_ms * 1e3,
            "plain_step_ms": plain_ms, "plain_rays_per_s": rays / plain_ms * 1e3,
            "rounds_ms": rounds,
            "route_errs": route_errs(ker, pln), "rgb_loss_fixed_batch": [rgb[0], rgb[-1]],
            "profiles": profiles, "launches": launches}


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
    from mc_nerf_torch.ops.cuda.fused_render import (
        fused_render, fused_render_plain, max_samples, max_samples_bwd)
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
          f"backward {max_samples_bwd(packed_f)} (the kernels' shared-memory layout)")
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
                  f"{t['bound_ms']:.3f} by {t['bound_by']})", flush=True)

    # ---- the GLOBAL_OPTIM train step at full width
    train = train_phase(cfg, dev, h, w)

    replaces = {"fused_mlp_apply": "mc_nerf_tpu/ops/pallas/fused_mlp.py:241",
                "fused_render": "mc_nerf_tpu/ops/pallas/fused_render.py:211",
                "render_bwd_points": "mc_nerf_tpu/ops/pallas/fused_render.py:290",
                "render_bwd_weights": "mc_nerf_tpu/ops/pallas/fused_render.py:290"}
    sources = {"fused_mlp_apply": "mc_nerf_torch/csrc/fused_mlp.cu",
               "fused_render": "mc_nerf_torch/csrc/fused_render.cu",
               "render_bwd_points": "mc_nerf_torch/csrc/fused_render_bwd.cu",
               "render_bwd_weights": "mc_nerf_torch/csrc/fused_render_bwd.cu"}
    # one entry per kernel and path, each path's launches counted from 0
    # just before it ran: the demo (2 frames; times at one eval chunk) and
    # the train step (N_TRAIN steps; times per launch, the mean of the
    # coarse and the fine pass, each pass kept in per_pass)
    kernels = [{
        "name": name, "path": "demo", "route": "cuda", "source": sources[name],
        "replaces": replaces[name], "launches": demo_launches[name],
        "max_abs_err": errs[name], "ms": times[name][0], "plain_ms": times[name][1],
        "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": times[name][2],
    } for name in ("fused_mlp_apply", "fused_render")]
    kernels += [{
        "name": name, "path": "train_step", "route": "cuda", "source": sources[name],
        "replaces": replaces[name], "launches": train["launches"][name],
        "launches_per_step": train["launches"][name] / N_TRAIN, "max_abs_err": errs[name],
        **per_launch(train_numbers[name]),
    } for name in ("fused_render", "render_bwd_points", "render_bwd_weights")]
    print(json.dumps({"frame_ms": frame_ms, "rays_per_s": h * w / frame_ms * 1e3,
                      "launches_per_frame": {k: v / 2 for k, v in demo_launches.items()},
                      "occupied_share": occ_share, "card": smi}))
    print(json.dumps({"train": {k: v for k, v in train.items() if k != "launches"},
                      "train_launches": train["launches"],
                      "backward_rel_l2": {k: v[0] for k, v in bwd.items()}, "card": smi}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
