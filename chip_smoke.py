"""Smoke test of the PyTorch port on NVIDIA GPUs: what only a drive of the
whole program on the card can show.

    python3 chip_smoke.py            # one card or more
    python3 chip_smoke.py --nccl     # the NCCL phase alone, on two cards or more
    python3 chip_smoke.py --ngp      # the hash-grid drive alone

It times nothing.  Each other check on the card has one home: end-to-end
and per-layer timing is ``portbench/`` (``python3 -m portbench.run
--workload <cell> ... --trace 1`` for the kernel breakdown); per-launch
kernel timing and A/B, ``mc_nerf_torch/tools/points_stage_time.py`` and
``weight_stage_time.py``; each kernel and route against its plain version
at odd shapes and the default widths, with planted faults, and each graph
against its loop bit for bit, ``tests/test_torch_gpu.py``,
``tests/test_torch_encode_rays_gpu.py`` and ``tests/test_torch_ngp_gpu.py``
(``python3 -m pytest --noconftest -m gpu <file>``).

1. Prints the card's name and power limit and the versions, builds the
   CUDA kernels from ``mc_nerf_torch/csrc`` (nvcc, sm_90a, one process per
   source, in parallel), and prints the build time and ptxas's register
   and spill lines.
2. The hash-grid field (``ngp_phase``) at the benchmark's instant-ngp-base
   configuration and train.ngp inputs (8 of its 800x800 images): the
   occupancy refresh from the field, the GLOBAL_OPTIM and FINE_TUNE step
   graphs (``make_stage_epoch``, 10 steps on each route) and the 800x800
   frame graph (``make_render_fn``, the same bits as its chunk loop); the
   encode's launches by path (``ops/cuda/hashgrid.py::launches`` zeroed
   before each: one forward and one backward a loop step, the warm-ups'
   and the capture's in a graph epoch, one forward a frame chunk; the
   profiler's in a replay of each graph).
3. The demo (``mc_nerf_torch.train.engine.demo``) at the library's default
   full width over two 800x800 views in both fine modes (``demo_phase``:
   importance with the occupancy refresh, grid without a map), through a
   renderer whose first frame captures the frame as a CUDA graph: K1, K2
   (grid: K4) and ``sample_pdf``'s kernel launched (the wrappers count the
   warm-up's and the capture's launches, the profiler those of a replay of
   the graph: ``replayed_frames``); an 800x800 frame again with
   ``sample_pdf``'s plain body against the kernel's (importance); one
   chunk of a frame through the bf16 plain route against the kernel
   route, the fine MLP's skip input dropped as the plant.
4. The engine (``mc_nerf_torch.train.engine.Engine``) at the default model
   and sampler widths on a scene the port's ``make_dataset`` writes under
   ``build/`` (8 train + 1 val + 2 test views at 200x200), cut to stages
   of 1 + 1 + 1 epochs of 16 steps with a 16-step occupancy warm-up: run
   A trains them, each stage's step captured once and replayed
   (``fused_render`` and its two backward launches exactly twice per
   GLOBAL_OPTIM / FINE_TUNE step of the warm-ups and captures, which the
   wrappers count, and twice in a replay of each stage's step graph,
   which the profiler counts after the run; ``fused_mlp_apply_rays`` and
   ``fused_render_rays`` in the validation frames, one graph replayed once a
   frame), run B resumes from run A's epoch-0 checkpoint and must end on
   the same bits, the demo restores the latest checkpoint and scores the
   test views.  The calls of the kernels' entry points are recorded by
   path and shape (the engine's training path keeps the first call at
   each shape, a warm-up step's before the capture: a replay calls no
   entry point; the CLI phases keep the last, a step graph's own tensors
   as its last replay, the profiled one after the run, left them); each
   kernel is then held against its plain version on the inputs the
   engine gave it at each shape.
5. The CLI (``mc_nerf_torch.main.main``, what ``python -m mc_nerf_torch``
   runs) on a reference-format scene: ``make_dataset(calibration_mode=
   "rendered")`` writes 4 train + 1 val + 2 test views at 200x200 with
   calib and coord cube images, its detection cache is deleted, and
   reference-schema ``config.yaml`` files carry the default widths; the
   importance ``--train`` (2 + 1 + 1 epochs of 200 steps: the engine
   builds the cache with the tag36h11 detector, a camera restart, a
   fresh and an EMA refresh) and ``--demo``, the grid ``--train`` (1 + 1
   + 0) and ``--demo``, and a resumed ``--train`` that takes no step.
   Checks the built cache against make_dataset's, the coord keypoints
   within 1 px of the ground-truth projection, checkpoint retention, one
   pose plot per camera table, finite demos, each kernel's launches on
   its path; then holds each kernel against its plain version on the
   inputs the CLI gave it, with the planted faults at 2x a tolerance or
   more; a frame's eval chunk again with its depths spread
   ``EVAL_SPREAD`` times, where the composite's planted scan fault must
   show.  Then the coarse-free hybrid through the CLI (GLOBAL_OPTIM
   two-pass, FINE_TUNE coarse-free, a bitpacked map): ``fused_render``
   and its two backward launches exactly twice a two-pass step and once
   a coarse-free one, ``fused_mlp_apply_rays`` never, the coarse MLP's
   parameters bit-stable through FINE_TUNE; its ``--demo`` with LPIPS on
   seeded random weights (against the CPU's fp32 value) and with the
   density PMF; each kernel held on those inputs as above.
6. Data parallelism (``dp_phase``): 2 gloo ranks on the one card, each a
   subprocess, ``main()`` ``--train`` / ``--demo`` on both (the step as a
   loop: gloo's collectives run on the host, one gradient all-reduce a
   step; every validation and demo frame split over the ranks, each
   rank's blocks one graph, the gather after its replay) against one
   process with twice the images; an 800x800 importance-culled and a grid
   frame split over the 2 ranks (``split_frames``), each bit for bit
   against one process in chunks of a block; and ``torchrun`` itself.
   With two cards or more (``nccl_phase``): ``torchrun`` of one rank a
   card over NCCL, four step kinds at full width, 7000 rays a rank,
   through the loop and the step as one graph, its collectives captured
   (the same bits on both routes and every rank, the profiled launches a
   step, one all-reduce a step on the host in the loop and none outside
   the graph); the four eval modes at 800x800 and 200x200 split over the
   ranks (the same bits on every rank and those of one process in chunks
   of a block, the launches a replay), each eval kernel held on rank 0's
   blocks; and ``-m mc_nerf_torch --train``, its validation split;
   skipped, and said so, on one card.
7. Prints one JSON line a phase, the ``kernels`` JSON line (one entry per
   kernel and recorded path: the calls recorded, the largest error
   against the plain version), then ``{"ok": true, "device": ...}`` last.

Every hold on recorded inputs also measures planted faults against the
same plain version (points mixed up, tiles swapped in pairs, the skip
input dropped, the first layer lost, another ray's SH basis, the forward
composite's prefix sums one sample late; for the backwards also a layer's
dW transposed or zeroed, the skip's dfeat share dropped, the suffix scan
shifted by one, one sample's dout8 moved to its neighbour, the sigmoid's
derivative dropped on one channel: ``tools/bwd_check.py``) and fails if
one of them would pass.  The weights of the demos and the split frames
are the seeded test scene of ``mc_nerf_torch.tools.scene`` (He-scaled, so
the field's density and colour vary with the point).  Any failed check
exits non-zero.  Needs a CUDA card; imports nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import gc
import hashlib
import json
import math
import re
import signal
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from mc_nerf_torch.tools.card_kinds import FRAME_LAUNCHES, FRAME_MODES, STEP_KINDS

SEED = 0
# Kernel vs plain: the same rounding points, sums in another order, so a
# bf16 activation may round the other way now and then.  Each tolerance is
# 4-8x the largest error measured on an H100 (PERF.md), and every planted
# fault measured there is 9x it or more.
MLP_RTOL = 2e-2            # max abs error over the max abs output (32 lanes)
RENDER_ATOL = 2e-2         # rgb / opacity / wsel
DEPTH_ATOL = 5e-2          # depth, in [near, far] = [1, 8]
MLP_TOL = {"rel": MLP_RTOL}
RENDER_TOL = {"rgb/opacity": RENDER_ATOL, "depth": DEPTH_ATOL, "wsel": RENDER_ATOL}
# sample_pdf's kernel vs its plain body (csrc/sample_pdf.cu): the PMF's
# sums in another order, so each draw is held within rounding of the plain
# body's by ops/cuda/sample_pdf.py::draw_gap (1 or less: its depth within
# 2e-5, or its place on the CDF within 4e-6), as tests/test_torch_gpu.py
SAMPLE_PDF_TOL = {"draw": 1.0}
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
# fused_shaded_mlp (K4) vs its plain version: sigma's max abs error over
# its largest magnitude, the rgb's max abs error; 3.7x and 5.2x the
# largest measured on an H100 (1.35e-2, 9.7e-3 at the eval chunk), every
# planted fault at 9.8x or more (PERF.md)
SHADED_TOL = {"sigma rel": 5e-2, "rgb": 5e-2}
# K5 (under tools/bwd_check.shaded_cotangent) vs its plain backward,
# relative L2 per output and pass: about 10x the largest error measured on
# an H100 at the grid step's shapes (PERF.md); the skip's dfeat share
# dropped is the tight plant (~3x)
SHADED_BWD_TOL = {"coarse": {"dW": 1.2e-3, "db": 7.5e-4, "last layer": 1.9e-4, "dfeat": 2.5e-2,
                             "dbasis": 7.5e-4},
                  "fine": {"dW": 5.4e-2, "db": 6e-2, "last layer": 1.2e-3, "dfeat": 0.14,
                           "dbasis": 1.3e-3}}
# K6 (fused_mlp's backward, under tools/bwd_check.mlp_cotangent) vs its
# plain backward, the same measure: about 10x the largest error measured
# on an H100 at the train batch's shapes (PERF.md)
MLP_BWD_TOL = {"coarse": {"dW": 2.2e-4, "db": 1.2e-4, "last layer": 1.1e-4, "dfeat": 2.3e-2},
               "fine": {"dW": 9e-4, "db": 5.3e-4, "last layer": 1.1e-4, "dfeat": 8.4e-2}}
# the step kinds of the NCCL phase (STEP_KINDS) and the eval modes of the
# frames split over ranks (FRAME_MODES), at the demo's size and the
# engine's and CLI's validation size (3 chunks, the last padded)
FRAME_SIDES = (800, 200)
# the eval paths' entry points (models/nerf.py::render_rays_eval), which
# encode each point in the kernel from its ray and depth, and each one's
# feat entry point: the route the oracle's features take
RAYS_FORMS = {"fused_mlp_apply_rays": "fused_mlp_apply", "fused_render_rays": "fused_render",
              "fused_shaded_mlp_rays": "fused_shaded_mlp"}
# a rays entry point's call by shape, as engine_recorder keys it
RAYS_SHAPES = {"fused_mlp_apply_rays": lambda a: f"{a[3].numel()} points",
               "fused_render_rays": lambda a: f"{a[1].shape[0]} rays x {a[7]}",
               "fused_shaded_mlp_rays": lambda a: f"{a[1].shape[0]} rays x {a[7]}"}
# the kernel of csrc/ each eval wrapper launches once a call, as the
# profiler names it: K1 the forward kernel's FWD_RAW, FEAT_RAYS instance,
# K2 its composite; K4 the FWD_SHADED, FEAT_RAYS instance, which K2 also
# runs
FRAME_SIGNATURE = {"fused_mlp_apply_rays": r"shaded_fwd_kernel<\D*1\D+1>",
                   "fused_render_rays": r"\bcomposite_fwd_kernel\b",
                   "fused_shaded_mlp_rays": r"shaded_fwd_kernel<\D*0\D+1>",
                   "sample_pdf_cuda": r"\binverse_cdf_kernel\b"}
# the engine phase's cuts of the protocol (52 epochs of 50 steps a train
# image, 3000 warm-up steps, 800x800 images, 200 test views)
ENGINE_CUTS = {"stages": (1, 1, 1), "steps_per_image_epoch": 2, "occ_warmup_steps": 16}
ENGINE_RES = 200
# improve_cameras on the card vs the CPU: the adoption masks exact, the
# adopted twists and focal multipliers (fp32, SVDs of 10 x 9 systems)
RESTART_ATOL = 1e-4
# planted faults that the CLI phase's trained field barely feels: the
# skip input dropped moves K2's composited rays by 1.6-2.0x RENDER_ATOL,
# and K3's fine dfeat by 1.7x BWD_TOL, on an H100 (PERF.md); held
# there at 1x (caught), at 2x like every other plant on the seeded scene
# of the other phases; the skip path of the kernel K2 and K3 share with
# K1 and K4 is held at 2x on the CLI's inputs through those two
CLI_WEAK_PLANTS = {"skip input dropped": 1.0, "the skip's dfeat share dropped": 1.0}
# the CLI phase: views of its reference-format scene (train, val, test,
# at ENGINE_RES) and its cuts of the protocol (52 epochs, 3000 warm-up
# steps, the newest 5 checkpoints kept)
CLI_VIEWS = (4, 1, 2)
CLI_CUTS = {"importance stages": (2, 1, 1), "grid stages": (1, 1, 0),
            "occ_warmup_steps": 200, "ckpt_max_keep": 2}
# the coarse-free CLI phase: the hybrid schedule (GLOBAL_OPTIM two-pass,
# FINE_TUNE coarse-free) on the bitpacked map, stages 1 + 1 + 1 of the
# protocol's 20 + 16 + 16, the CLI phase's views and warm-up (a fresh
# refresh from the coarse MLP follows the GLOBAL_OPTIM epoch); its demo
# again with the density PMF on a bf16 map.  LPIPS of the demo's views
# (seeded random weights) against the CPU's fp32 value, the bound of
# tests/test_lpips.py
CLI_CF = {"stages": (1, 1, 1),
          "train": {"coarse_free": "true", "coarse_free_from_stage": 2, "cf_uniform_samples": 8,
                    "occ_map_dtype": "bitpack"},
          "density demo": {"coarse_free": "true", "coarse_free_from_stage": 2,
                           "occ_pmf": "density", "occ_map_dtype": "bfloat16"}}
LPIPS_RTOL = 2e-4
# the forward composite's scan one sample late moves a frame's eval chunk
# by what neighbouring samples along a ray both absorb, which the field
# decides: on an H100 (PERF.md) 3.4-4.3x RENDER_ATOL on the CLI's two-pass
# chunks, 0.1x on a tree whose fine samples spread, 0.1-0.8x on the
# coarse-free chunks (noise-free samples spread over the PMF's support of
# a barely trained field).  So an eval chunk is held a second time with
# its depths spread EVAL_SPREAD times from each ray's first sample (the
# same points, features and basis; every delta, and so every sample's
# optical depth, times EVAL_SPREAD): there the plant is held with the
# others at 2x, and on the chunk as the path gave it every plant but it.
# Spread 4 / 16 / 64 / 256x, the plant landed at 0.2 / 0.9 / 3.3 / 9.3x
# on the coarse-free demo's chunk (the least of the CLI's five) and the
# kernel's rgb error fell (4.2e-4 to 2.3e-4)
EVAL_SPREAD = 256
# the data-parallel phase: 2 ranks on the one card (gloo: NCCL refuses two
# ranks on a card), the CLI phase's scene and views, stages 1 + 1 + 1 of
# 100 steps a rank (4 views x 50 / 2 images) with a 100-step warm-up, and
# a run of 1 + 1 + 0 epochs through torchrun itself
DP_WORLD = 2
DP_CUTS = {"stages": (1, 1, 1), "launch stages": (1, 1, 0), "occ_warmup_steps": 100}
# the 2-rank run against a 1-rank run with images_per_batch=2 from the
# same seed and draws (the order of the gradient's sums differs): each
# epoch's metrics (relative) and the parameters after each epoch (against
# their largest entry), ~10x what an H100 measured (1.3e-5 and 1.7e-3:
# RAdam turns rounding-level differences of near-zero gradient entries
# into whole steps); the demo's scores against the 1-rank demo of the
# same checkpoint (relative; measured equal)
DP_TOL = {"metrics rel": 1.5e-4, "params": 2e-2, "demo rel": 1e-6}
# the step kinds on NCCL ranks (nccl_kinds: STEP_KINDS, each rank's image of
# the global batch): steps an epoch of each route, and each kind's
# launches a step of the csrc/ kernel its wrappers launch once a call
# (SIGNATURE's), which the profiler counts in the graph route's replays
DP_STEPS = 5
# the route every stage of the gloo ranks' CLI run logs
GLOO_ROUTE = (f"the step as a loop ({DP_WORLD} gloo ranks: their collectives run on the "
              "host)")
DP_LAUNCHES = {
    "importance GLOBAL_OPTIM": {"composite_fwd_kernel": 2, "mlp_points_kernel": 2,
                                "weight_grad_kernel": 2},
    "grid GLOBAL_OPTIM": {"shaded_fwd_kernel": 2, "mlp_points_kernel": 2},
    "coarse-free FINE_TUNE": {"composite_fwd_kernel": 1, "mlp_points_kernel": 1,
                              "weight_grad_kernel": 1},
    "CAM_PARAM": {"composite_fwd_kernel": 0, "mlp_points_kernel": 0, "weight_grad_kernel": 0,
                  "shaded_fwd_kernel": 0}}
# the frame split over ranks (split_frames): the cells each phase splits
# over its ranks (dp_phase's 2 gloo ranks on the one card: the demo's size
# in both fine modes; nccl_phase's ranks, one a card: every eval mode at
# both sizes; FRAME_LAUNCHES a chunk's block)
DP_SPLIT_CELLS = (("importance culled", 800), ("grid", 800))
NCCL_SPLIT_CELLS = tuple((mode, side) for mode in FRAME_MODES for side in FRAME_SIDES)


def rays_wrappers() -> tuple:
    """The eval paths' rays entry points (``RAYS_FORMS``), the functions
    whose ``launches`` count K1, K2 and K4 there."""
    from mc_nerf_torch.ops.cuda.fused_mlp import fused_mlp_apply_rays, fused_shaded_mlp_rays
    from mc_nerf_torch.ops.cuda.fused_render import fused_render_rays

    return fused_mlp_apply_rays, fused_render_rays, fused_shaded_mlp_rays


def feat_form(name: str, a: tuple) -> tuple:
    """A rays entry point's recorded call ``a`` as its feat entry point's
    arguments (``RAYS_FORMS``), with the oracle's features:
    ``encode_kernel_order`` of the points from the recorded rays and
    depths."""
    from mc_nerf_torch.ops.cuda.fused_mlp import encode_kernel_order, pack_freqs, ray_points

    if name == "fused_mlp_apply_rays":
        pk, o, d, z, depth, skips = a
    elif name == "fused_render_rays":
        pk, o, d, basis16, z, depth, skips, s, nb, white_back = a
    else:
        pk, o, d, z, basis16, depth, skips, s, nb = a
    feat = encode_kernel_order(ray_points(o, d, z).reshape(-1, 3), pack_freqs(pk))
    if name == "fused_mlp_apply_rays":
        return pk, feat, depth, skips
    if name == "fused_render_rays":
        return pk, feat, basis16, z, None, None, depth, skips, s, nb, False, False, white_back
    return pk, feat, basis16, depth, skips, s, nb


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def over(errs: dict, tols: dict) -> float:
    """The largest error over its tolerance: a check passes at <= 1."""
    return max(errs[k] / tols[k] for k in errs)


def hold(label: str, errs: dict, tols: dict, plants: dict, bar: float = 1.0,
         failures: list = None, bars: dict = None) -> None:
    """Fail unless every error is within its tolerance and every planted
    fault (measured against the same plain version) breaks one of them by
    more than ``bar`` times (``bars``: another bar for the plants it
    names).  With ``failures``, a failure is appended to it instead, for
    the caller to fail on once it has checked the rest."""
    caught = {name: over(e, tols) for name, e in plants.items()}
    print(f"{label}: " + ", ".join(f"{k} {v:.3e} (tol {tols[k]})" for k, v in errs.items())
          + ("; planted faults, error over tolerance: "
             + ", ".join(f"{n} {r:.1f}" for n, r in caught.items()) if plants else ""),
          flush=True)
    report = fail if failures is None else failures.append
    if not over(errs, tols) <= 1.0:
        report(f"{label}: the kernel disagrees with its plain version")
    missed = [n for n, r in caught.items() if not r > (bars or {}).get(n, bar)]
    if missed:
        report(f"{label}: the check cannot see the planted faults {missed}")


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


def hold_render(label: str, a: tuple, tols: dict, plants: bool, failures: list,
                unplanted: tuple = (), out: tuple = None) -> dict:
    """``fused_render`` on the inputs ``a`` (or ``out``, the kernel's
    (ray_out, wsel) on them by another route) held against its plain
    version (``hold``), with the planted faults of the other phases but
    those in ``unplanted`` at 2x (``CLI_WEAK_PLANTS`` at theirs); returns
    the kernel's errors."""
    from mc_nerf_torch.ops.cuda.fused_render import fused_render, fused_render_plain
    from mc_nerf_torch.tools.bwd_check import render_scan_late

    k_out, k_w = fused_render(*a) if out is None else out
    torch.cuda.synchronize()
    p_out, p_w = fused_render_plain(*a)
    planted = {}
    if plants:
        pk, feat, basis16, skips, s = a[0], a[1], a[2], a[7], a[8]

        def plain(p=pk, f=feat, b=basis16):
            return render_errs(*fused_render_plain(p, f, b, *a[3:]), p_out, p_w)

        # neighbouring rays of a frame's chunk see nearly the same points:
        # the other ray is half the batch away
        half = basis16.shape[0] // 2
        faults = {
            "another ray's points": lambda: plain(
                f=feat.view(basis16.shape[0], s, -1).roll(half, 0).reshape(feat.shape)),
            "skip input dropped": lambda: plain(p=drop_skip(pk, skips)),
            "first layer lost": lambda: plain(p=drop_first(pk)),
            "another ray's basis": lambda: plain(b=basis16.roll(half, 0)),
            "scan one sample late": lambda: render_errs(*render_scan_late(*a), p_out, p_w)}
        planted = {n: f() for n, f in faults.items() if n not in unplanted}
    e = render_errs(k_out, k_w, p_out, p_w)
    hold(label, e, tols, planted, 2.0, failures, CLI_WEAK_PLANTS)
    return e


def hold_sample_pdf(label: str, args: tuple, plants: bool, failures: list = None) -> float:
    """sample_pdf_cuda on ``args`` (z, weights, K, uniforms or None, eps)
    against sample_pdf_plain: every draw within rounding of the plain
    body's (``draw_gap`` within SAMPLE_PDF_TOL); with ``plants``, each
    planted fault (the midpoints one bin late; the draws' jitter dropped,
    or added where there is none) at 2x it or more.  Returns the largest
    depth gap."""
    from mc_nerf_torch.ops.cuda.sample_pdf import draw_gap, sample_pdf_cuda
    from mc_nerf_torch.ops.volume import sample_pdf_plain

    z, w, k, u, eps = args
    ker = sample_pdf_cuda(*args)
    torch.cuda.synchronize()
    ref = sample_pdf_plain(z, w, k, u, eps=eps)

    def err(x):
        return {"draw": draw_gap(x, ref, z, w, eps)}

    planted = {}
    if plants:
        jitter = None if u is not None else torch.rand(
            (w.shape[0], k), generator=torch.Generator(device=w.device).manual_seed(SEED),
            device=w.device)
        planted = {"midpoints one bin late": err(sample_pdf_plain(z.roll(1, 1), w, k, u, eps=eps)),
                   "jitter " + ("dropped" if u is not None else "added"):
                   err(sample_pdf_plain(z, w, k, jitter, eps=eps))}
    e, depth = err(ker), float((ker - ref).abs().max())
    hold(f"{label} (max abs depth gap {depth:.3e}, {int((ker != ref).sum())} of {ker.numel()} "
         "depths differ)", e, SAMPLE_PDF_TOL, planted, 2.0, failures)
    return depth


def masked_below(plain, args, ref) -> dict:
    """The points stage's wrong-mask plant (``tools/bwd_check.planted_points``):
    each trunk layer l > 0 masked with layer l - 1's ReLU mask."""
    from mc_nerf_torch.tools.bwd_check import planted_points

    name = "a layer masked with the one below's"
    return {name: planted_points(plain, args, ref)[name]}


def kind_workload(dev, stage: int, train_kw: dict, nerf_kw: dict) -> tuple:
    """A step kind of ``STEP_KINDS`` on the workload bench.py times
    (``tools/scene.train_workload`` at ``Config()`` widths with the
    kind's changes), from step 143,000 of 286,000 (the BARF gate moves
    every step): (cfg, state, data, the optimizers, [p_flat, the stage's
    mu, nu and count, step])."""
    from mc_nerf_torch.config import Config
    from mc_nerf_torch.tools.scene import STEPS_PER_EPOCH, TOTAL_STEPS, train_workload
    from mc_nerf_torch.train.optim import build_optimizers, counter, flatten_params
    from mc_nerf_torch.train.steps import TrainState

    cfg = Config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, **train_kw),
                      nerf=dataclasses.replace(cfg.nerf, **nerf_kw))
    params, data = train_workload(cfg, SEED, dev)
    p_flat = flatten_params(params)
    txs, states = build_optimizers(cfg, params, p_flat, STEPS_PER_EPOCH)
    state = TrainState(params, p_flat, states, counter(TOTAL_STEPS // 2, dev))
    opt = state.opt_states[stage]
    return cfg, state, data, txs, [state.p_flat, opt.mu, opt.nu, opt.count, state.step]


def frame_launches_in(rows) -> dict:
    """The eval kernels' launches in profiler ``rows`` (``profile_steps``'),
    by wrapper: each wrapper's ``FRAME_SIGNATURE`` kernel; K2 runs the
    same ``shaded_fwd_kernel<FWD_SHADED, FEAT_RAYS>`` as K4 before its
    composite, so K4's are those beyond K2's."""
    found = {w: sum(c for _, c, name in rows if re.search(p, name))
             for w, p in FRAME_SIGNATURE.items()}
    found["fused_shaded_mlp_rays"] -= found["fused_render_rays"]
    return found


def replayed_frames(renders, path: str) -> tuple:
    """The launches that the frame graphs of ``renders``
    (``train/steps.py::FrameRender``) made on the card in a path's run:
    each graph replayed under the profiler (``profile_fullest``), its eval kernels
    counted (``frame_launches_in``), times the replays the run made
    (``FrameRender.captures``).  A replay writes only the graph's own
    outputs, from the inputs the run wrote last.  Returns ({wrapper:
    launches in the run's replays}, {graph: {"per_replay": {wrapper:
    launches}, "replays": n}})."""
    from mc_nerf_torch.tools.profile_step import profile_fullest

    total, graphs = dict.fromkeys(FRAME_SIGNATURE, 0), {}
    for render in renders:
        for key, (g, _, _) in render._graphs.items():
            found = frame_launches_in(profile_fullest(g.replay))
            n = render.captures[key]["replays"]
            graphs[f"{render.img_h}x{render.img_w} {key}"] = {"per_replay": found, "replays": n}
            for w, v in found.items():
                total[w] += v * n
    print(f"{path}: the frame graphs' eval kernels a replay (profiled) {graphs}; in the run's "
          f"replays {total}", flush=True)
    return total, graphs


def frame_cell(mode: str, side: int, dev) -> tuple:
    """A cell of the split frames: ``mode``'s change of ``Config()``
    (``FRAME_MODES``), the seeded scene's weights (``tools/scene.scene_params``)
    and, where the mode has one, a fresh map refreshed from them, and the
    orbit's pose at azimuth 0.3 with its K at ``side`` x ``side``.
    Returns (cfg, params, occ or None, poses, K)."""
    from mc_nerf_torch.config import Config
    from mc_nerf_torch.tools.scene import orbit_views, scene_params
    from mc_nerf_torch.train.engine import refresh_occupancy

    ev_kw, nerf_kw, with_map = FRAME_MODES[mode]
    cfg = Config()
    cfg = cfg.replace(eval=dataclasses.replace(cfg.eval, **ev_kw),
                      nerf=dataclasses.replace(cfg.nerf, **nerf_kw))
    params = scene_params(cfg.nerf, SEED, device=dev)
    occ = refresh_occupancy(params, cfg, dev, 0) if with_map else None
    poses, K = orbit_views((0.3,), side, side)
    return cfg, params, occ, poses, K


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
    ``path_kernel_holds`` then holds the kernel."""
    import os
    import pathlib
    import shutil

    import mc_nerf_torch.models.nerf as nerf_module
    import mc_nerf_torch.ops.cuda.fused_render as render_module
    import mc_nerf_torch.ops.volume as volume_module

    from mc_nerf_torch.config import Config, NerfConfig, PathsConfig, StageConfig, TrainConfig
    from mc_nerf_torch.data.calibration import load_calibration
    from mc_nerf_torch.data.synthetic import make_dataset
    from mc_nerf_torch.train.engine import STAGE_NAMES, Engine
    from mc_nerf_torch.train.restarts import improve_cameras

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
               (nerf_module, "fused_mlp_apply_rays"): RAYS_SHAPES["fused_mlp_apply_rays"],
               (nerf_module, "fused_render_rays"): RAYS_SHAPES["fused_render_rays"],
               (render_module, "fused_render_bwd"): lambda a: f"{a[3].shape[0]} rays x {a[9]}",
               (volume_module, "sample_pdf_cuda"): pdf_shape}
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
    eng_a.train()
    torch.cuda.synchronize()
    where[0] = None
    total = launches()
    train_launches = {n: total[n] - val_launches[n] for n in counters}
    for h in eng_a.history:
        print(f"engine {STAGE_NAMES[h['stage']]} {h['epoch']}: loss {h['loss']:.6f} intr "
              f"{h['loss_intr']:.6f} extr {h['loss_extr']:.6f} rgb_c {h['loss_rgb_c']:.5f} rgb_f "
              f"{h['loss_rgb_f']:.5f}"
              + (f"; val PSNR {h['val_psnr']:.3f} SSIM {h['val_ssim']:.4f}" if "val_psnr" in h
                 else ""), flush=True)
    nerf_steps = spe * (stages[1] + stages[2])
    print(f"engine run A: launches in the training steps {train_launches}, in the validation "
          f"renders {val_launches}", flush=True)
    for h in eng_a.history:
        if not all(math.isfinite(h[k]) for k in ("loss", "loss_rgb_c", "loss_rgb_f")):
            fail(f"engine epoch {h['epoch']} is not finite: {h}")
    if eng_a.state.step != spe * sum(stages) or len(eng_a.history) != sum(stages):
        fail(f"engine ran {int(eng_a.state.step)} steps over {len(eng_a.history)} epochs")
    # one process on the card: every stage's step captured once and
    # replayed; the wrappers count the launches of the warm-up and the
    # capture, a replay runs the captured launches without them
    routes = {STAGE_NAMES[st]: dict(ep.counts) for st, ep in sorted(eng_a._epoch_fns.items())}
    host = sum(host_steps(eng_a._epoch_fns[st].counts) for st in (1, 2))
    replays = sum(eng_a._epoch_fns[st].counts["replayed"] for st in (1, 2))
    print(f"engine run A's steps by route and stage: {routes}", flush=True)
    if not (all(c["captured"] == 1 and c["looped"] == 0 for c in routes.values())
            and sum(c["replayed"] for c in routes.values()) == spe * sum(stages)
            and replays == nerf_steps):
        fail(f"engine run A did not replay one captured step a stage: {routes}")
    # sample_pdf: a two-pass step's coarse draw from the map's PMF and its
    # fine draw
    train_wrappers = ("fused_render", "render_bwd_points", "render_bwd_weights", "sample_pdf_cuda")
    for n in train_wrappers:
        if train_launches[n] != 2 * host:
            fail(f"{n}: {train_launches[n]} launches in {host} GLOBAL_OPTIM / FINE_TUNE steps "
                 "of warm-up and capture, not 2 a step")
    graph_launches, per_replay = replayed_launches(
        eng_a, "engine_train", train_wrappers, {0: 0, 1: 2, 2: 2}, csrc_kernel_names())
    if train_launches["fused_mlp_apply_rays"] != 0 or train_launches["fused_render_rays"] != 0 \
            or val_launches["fused_render"] != 0 or not all(
            val_launches[n] > 0
            for n in ("fused_mlp_apply_rays", "fused_render_rays", "sample_pdf_cuda")):
        fail(f"engine validation launches {val_launches}, training {train_launches}")
    # the validation frames: one graph of the frame, captured once and
    # replayed once a frame (the wrappers count the warm-up and capture)
    frame_routes = {"engine_validation": [dict(r.counts) for r in eng_a._render_fns.values()]}
    val_frames, _ = replayed_frames(eng_a._render_fns.values(), "engine_validation")
    if not (frame_routes["engine_validation"] == [{"captured": 1, "replayed": stages[1] + stages[2],
                                                   "looped": 0}]
            and val_frames["fused_mlp_apply_rays"] > 0 and val_frames["fused_render_rays"] > 0
            and val_frames["sample_pdf_cuda"] > 0):
        fail(f"engine validation frames by route {frame_routes}, launches in their replays "
             f"{val_frames}")

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
    eng_b.ckpt.restore(eng_b.state, 0)
    eng_b.train(resume=True)
    torch.cuda.synchronize()
    a, b = eng_a.state, eng_b.state
    same = {"p_flat": torch.equal(a.p_flat, b.p_flat), "step": bool(a.step == b.step),
            **{f"stage {i} {f}": bool(torch.equal(getattr(x, f), getattr(y, f)))
               for i, (x, y) in enumerate(zip(a.opt_states, b.opt_states)) for f in ("mu", "nu")},
            **{f"stage {i} count": bool(x.count == y.count)
               for i, (x, y) in enumerate(zip(a.opt_states, b.opt_states))}}
    print(f"engine run B (resumed from epoch 0): bit-identical to run A: {same}; p_flat max abs "
          f"difference "
          f"{float((a.p_flat - b.p_flat).abs().max()):.3e}", flush=True)
    if not all(same.values()):
        fail(f"the resumed run does not end on run A's bits: {same}")

    # the demo from the latest checkpoint
    eng_d = Engine(cfg.replace(mode=1), device=dev)
    reset()
    where[0] = "engine_demo"
    demo = eng_d.demo()
    torch.cuda.synchronize()
    where[0] = None
    demo_launches = launches()
    for (module, name), fn in originals.items():
        setattr(module, name, fn)
    frame_routes["engine_demo"] = [dict(r.counts) for r in eng_d._render_fns.values()]
    demo_frames, _ = replayed_frames(eng_d._render_fns.values(), "engine_demo")
    print(f"engine demo: {demo} ({smi}); launches by the wrappers (warm-up "
          f"and capture) {demo_launches}, in the frame graphs' replays {demo_frames}; frames by "
          f"route {frame_routes}", flush=True)
    if not (demo["count"] == 2 and math.isfinite(demo["psnr"]) and math.isfinite(demo["ssim"])):
        fail(f"engine demo result is not finite: {demo}")
    if not (demo_launches["fused_mlp_apply_rays"] > 0 and demo_launches["fused_render_rays"] > 0
            and demo_launches["sample_pdf_cuda"] > 0 and demo_launches["render_bwd_points"] == 0
            and demo_launches["fused_render"] == 0
            and demo_frames["fused_mlp_apply_rays"] > 0 and demo_frames["fused_render_rays"] > 0
            and demo_frames["sample_pdf_cuda"] > 0
            and frame_routes["engine_demo"] == [{"captured": 1, "replayed": 2, "looped": 0}]):
        fail(f"engine demo launches {demo_launches}, in its frame graphs {demo_frames}; frames "
             f"by route {frame_routes['engine_demo']}")
    shutil.rmtree(work, ignore_errors=True)

    # every counted launch is a recorded call, on the path it was counted on
    counted = {"engine_train": train_launches, "engine_validation": val_launches,
               "engine_demo": demo_launches}
    for path, got in counted.items():
        seen = {name: sum(c["n"] for c in calls.get((path, name), {}).values())
                for name in ("fused_render", "fused_mlp_apply_rays", "fused_render_rays",
                             "fused_render_bwd", "sample_pdf_cuda")}
        want = {"fused_render": got["fused_render"],
                "fused_mlp_apply_rays": got["fused_mlp_apply_rays"],
                "fused_render_rays": got["fused_render_rays"],
                "fused_render_bwd": got["render_bwd_points"],
                "sample_pdf_cuda": got["sample_pdf_cuda"]}
        if seen != want or got["render_bwd_points"] != got["render_bwd_weights"]:
            fail(f"{path}: recorded calls {seen} are not the launches counted {got}")
    return {"demo": demo, "steps_per_epoch": spe,
            "epochs": untimed(eng_a.history), "train_launches": train_launches,
            "steps_by_route": routes, "graph_launches": {"engine_train": graph_launches},
            "per_replay": per_replay,
            "validation_launches": val_launches, "demo_launches": demo_launches,
            "frame_launches": {"engine_validation": val_frames, "engine_demo": demo_frames},
            "frames_by_route": frame_routes,
            "resume_bit_identical": all(same.values()), "cuts": ENGINE_CUTS,
            "calls": calls, "nerf": cfg.nerf}


def cli_yaml(res: int, fine_mode: str, stages, warmup: int, out, nerf_extra=None) -> str:
    """A reference-schema ``config.yaml`` for the CLI phases: ``Config()``'s
    model and sampler widths written out, the phase's cuts, outputs under
    ``out``, and ``nerf_extra``'s keys under ``model.nerf``."""
    from mc_nerf_torch.config import Config

    nc, tc = Config().nerf, Config().train
    flow = lambda t: "[" + ", ".join(map(str, t)) + "]"
    return f"""# MC-NeRF config (reference schema), written by chip_smoke.py's CLI phase
system:
  epoch: {{cam_param_stage: {stages[0]}, global_opt_stage: {stages[1]}, fine_tune_stage: {stages[2]}}}
  train_params:
    batch: {tc.rays_per_batch}
    fine_mode: {fine_mode}
    ckpt_max_keep: {CLI_CUTS["ckpt_max_keep"]}
  test_params: {{resolution_h: {res}, resolution_w: {res}, fine_mode: {fine_mode}}}
  weights_params: {{root_weights: '{out}/weights'}}
  out_params: {{root_out: '{out}/results'}}
  log_params: {{logpath: '{out}/log'}}
  tensorboard_params: {{tb_pth: '{out}/tb'}}
model:
  nerf:
    near: {nc.near}
    far: {nc.far}
    samples: {nc.samples_coarse}
    sample_scale: {nc.sample_scale}
    emb_freqs_xyz: {nc.emb_freqs_xyz}
    coarse_MLP_depth: {nc.coarse_depth}
    coarse_MLP_width: {nc.coarse_width}
    coarse_MLP_skip: {flow(nc.coarse_skips)}
    fine_MLP_depth: {nc.fine_depth}
    fine_MLP_width: {nc.fine_width}
    fine_MLP_skip: {flow(nc.fine_skips)}
    MLP_deg: {nc.sh_deg}
    occ_grid_size: {nc.occ_grid_size}   # G
    occ_coarse_samples: {nc.occ_coarse_samples}
    occ_warmup_steps: {warmup}
""" + "".join(f"    {k}: {v}\n" for k, v in (nerf_extra or {}).items())


def cli_phase(dev, smi: str, counters: dict) -> dict:
    """The port's CLI (``mc_nerf_torch.main.main``, what ``python -m
    mc_nerf_torch`` runs), in process, on a reference-format scene:
    ``make_dataset(calibration_mode="rendered")`` writes ``CLI_VIEWS``
    views at ``ENGINE_RES``^2 with calib and coord cube images under
    ``build/``, its detection cache is kept aside and deleted, and
    ``config.yaml`` files in the reference schema carry ``Config()``'s
    model and sampler widths with the cuts of ``CLI_CUTS``.  Runs, each
    path's launches counted from 0 just before it: ``cli_train``
    (importance ``--train``: the detection cache built by the engine, two
    CAM_PARAM epochs with a camera restart between them, a fresh and an
    EMA occupancy refresh), ``cli_demo``, ``cli_train_grid`` (grid fine
    mode, train and eval, fresh weights), ``cli_demo_grid``, and an
    importance ``--train`` again, which resumes at the end and takes no
    step.  Checks: the cache the engine built equals the one make_dataset
    wrote; every detected coord keypoint lies within 1 px of the
    projection through the ground-truth camera; the checkpoints kept are
    the retention's; one pose plot per camera table; both demos finite;
    each kernel launched on its paths and each launch a recorded call.
    The calls of the kernels' entry points are recorded by path and shape
    (``engine_recorder``, each shape's last call kept) for
    ``path_kernel_holds``."""
    import os
    import pathlib
    import shutil

    from mc_nerf_torch.config import Config
    from mc_nerf_torch.data.blender import load_scene
    from mc_nerf_torch.data.calibration import CACHE_NAME
    from mc_nerf_torch.data.cube import tag_world_points
    from mc_nerf_torch.data.synthetic import make_dataset
    from mc_nerf_torch.train.engine import STAGE_NAMES

    try:
        gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True, check=True)
    except (OSError, subprocess.CalledProcessError) as e:
        fail(f"g++ is not usable here ({e}): the tag36h11 detector builds with it")
    print(f"g++: {gxx.stdout.splitlines()[0]}", flush=True)

    work = pathlib.Path(__file__).resolve().parent / "build" / f"cli_smoke_{os.getpid()}"
    shutil.rmtree(work, ignore_errors=True)
    res, (n_train, n_val, n_test), name = ENGINE_RES, CLI_VIEWS, "Ball_Cli"
    scene_dir = work / "data" / name
    make_dataset(str(scene_dir), n_train=n_train, n_val=n_val, n_test=n_test, img_h=res,
                 img_w=res, seed=SEED, calibration_mode="rendered")
    written = dict(np.load(scene_dir / CACHE_NAME))
    os.remove(scene_dir / CACHE_NAME)
    runs = {"importance": (CLI_CUTS["importance stages"], "importance"),
            "grid": (CLI_CUTS["grid stages"], "grid")}
    for run, (stages, mode) in runs.items():
        (work / f"config_{run}").mkdir(parents=True)
        (work / f"config_{run}" / "config.yaml").write_text(
            cli_yaml(res, mode, stages, CLI_CUTS["occ_warmup_steps"], work / run))
    print(f"cli: the reference-format scene ({n_train} train + {n_val} val + {n_test} test "
          f"views at {res}x{res}, calib and coord cube images); Config() model and sampler "
          f"widths; cuts: stages {CLI_CUTS['importance stages']} "
          f"(importance) and {CLI_CUTS['grid stages']} (grid) of the protocol's (20, 16, 16), "
          f"occ_warmup_steps {CLI_CUTS['occ_warmup_steps']} of 3000, ckpt_max_keep "
          f"{CLI_CUTS['ckpt_max_keep']} of 5, {res}x{res} images of 800x800, {n_train} train "
          f"views ({n_train * 50} steps an epoch)", flush=True)

    with cli_recording(work, name, counters) as (cli, calls, builds, _, frames):
        state_i, l_train, eng_i = cli("cli_train", "importance", "--train")
        demo_i, l_demo, _ = cli("cli_demo", "importance", "--demo")
        state_g, l_train_g, eng_g = cli("cli_train_grid", "grid", "--train")
        demo_g, l_demo_g, _ = cli("cli_demo_grid", "grid", "--demo")
        state_r, l_resume, eng_r = cli(None, "importance", "--train")

    # the loader read the widths written out
    if eng_i.cfg.nerf != dataclasses.replace(Config().nerf,
                                             occ_warmup_steps=CLI_CUTS["occ_warmup_steps"]):
        fail(f"the CLI's config is not Config()'s widths: {eng_i.cfg.nerf}")
    # the cache the engine built from the cube images
    built = np.load(scene_dir / CACHE_NAME)
    if set(built) != set(written) or not all(np.array_equal(built[k], written[k])
                                             for k in written):
        fail("the detection cache the CLI built differs from the one make_dataset wrote")
    train_split = load_scene(str(scene_dir), load_test_images=False).train
    cube = tag_world_points(1.0)
    kp_err = 0.0
    for i in range(n_train):
        for t in np.flatnonzero(built["coord_valid"][i]):
            cam = cube[t] @ train_split.poses_w2c[i][:, :3].T + train_split.poses_w2c[i][:, 3]
            pix = cam @ train_split.K[i].T
            kp_err = max(kp_err, float(np.abs(pix[:, :2] / pix[:, 2:3]
                                              - built["coord_pts"][i, t]).max()))
    print(f"cli: detection cache built by the engine ({len(builds)} build); equals "
          f"make_dataset's; {int(built['calib_valid'].sum())} calib and "
          f"{int(built['coord_valid'].sum())} coord tags detected; coord keypoints within "
          f"{kp_err:.3f} px of the ground-truth projection ({smi})", flush=True)
    if not kp_err <= 1.0:
        fail(f"a detected coord keypoint lies {kp_err:.3f} px from its projection (bound 1)")

    summary = {"cache_builds": len(builds), "keypoint_err_px": kp_err}
    for run, eng, state, launches in (("importance", eng_i, state_i, l_train),
                                      ("grid", eng_g, state_g, l_train_g)):
        stages = runs[run][0]
        total, spe = sum(stages), eng.steps_per_epoch
        nerf_steps = spe * (stages[1] + stages[2])
        for h in eng.history:
            print(f"cli {run} {STAGE_NAMES[h['stage']]} {h['epoch']}: loss {h['loss']:.6f} "
                  f"rgb_f {h['loss_rgb_f']:.5f}"
                  + (f"; val PSNR {h['val_psnr']:.3f} SSIM {h['val_ssim']:.4f}"
                     if "val_psnr" in h else ""), flush=True)
            if not all(math.isfinite(h[k]) for k in ("loss", "loss_rgb_c", "loss_rgb_f")):
                fail(f"cli {run} epoch {h['epoch']} is not finite: {h}")
        if state.step != spe * total or len(eng.history) != total or spe != n_train * 50:
            fail(f"cli {run} ran {int(state.step)} steps over {len(eng.history)} epochs")
        routes = {STAGE_NAMES[st]: dict(ep.counts) for st, ep in sorted(eng._epoch_fns.items())}
        if not (all(c["captured"] == 1 and c["looped"] == 0 for c in routes.values())
                and sum(c["replayed"] for c in routes.values()) == spe * total):
            fail(f"cli {run} did not replay one captured step a stage: {routes}")
        keep = CLI_CUTS["ckpt_max_keep"]
        b = (stages[0] - 1, stages[0] + stages[1] - 1, total - 1)
        want = sorted({e for e in range(total) if e >= total - keep} | {e for e in b if e >= 0})
        plots = sorted(os.listdir(work / run / "results" / "img_rendered" / name / "cam_pose"))
        print(f"cli {run} --train: {total} epochs, {spe} steps an epoch; "
              f"checkpoints kept {eng.ckpt.epochs()}, pose plots {plots}; launches {launches}",
              flush=True)
        if eng.ckpt.epochs() != want:
            fail(f"cli {run}: checkpoints kept {eng.ckpt.epochs()}, the retention keeps {want}")
        if plots != sorted(f"epoch_{e}.png" for e in range(total)):
            fail(f"cli {run}: pose plots {plots}, one per camera table wanted")
        summary[run] = {"steps_per_epoch": spe, "nerf_steps": nerf_steps,
                        "epochs": untimed(eng.history), "steps_by_route": routes,
                        "host_nerf_steps": sum(host_steps(eng._epoch_fns[st].counts)
                                               for st in (1, 2) if st in eng._epoch_fns)}
    # the wrappers count the warm-ups' and the captures' launches; the
    # replays run the captured ones again without them, which the profiler
    # counts in one replay of each step graph
    host_i, host_g = summary["importance"]["host_nerf_steps"], summary["grid"]["host_nerf_steps"]
    # (K2 on features twice a step; K1 and K2 on rays in validation)
    if not (l_train["render_bwd_points"] == l_train["render_bwd_weights"] == 2 * host_i
            and l_train["fused_render"] == 2 * host_i and l_train["fused_render_rays"] > 0
            and l_train["fused_mlp_apply_rays"] > 0 and l_train["sample_pdf_cuda"] > 2 * host_i
            and l_train["fused_shaded_mlp"] == l_train["fused_shaded_mlp_bwd"] == 0):
        fail(f"cli_train launches {l_train} ({host_i} NeRF steps of warm-up and capture)")
    if not (l_train_g["fused_shaded_mlp_bwd"] == 2 * host_g
            and l_train_g["fused_shaded_mlp"] >= 2 * host_g
            and l_train_g["fused_shaded_mlp_rays"] > 0 and l_train_g["fused_mlp_apply_rays"] > 0
            and l_train_g["fused_render"] == l_train_g["render_bwd_points"]
            == l_train_g["sample_pdf_cuda"] == l_train_g["fused_render_rays"] == 0):
        fail(f"cli_train_grid launches {l_train_g} ({host_g} NeRF steps of warm-up and "
             "capture)")
    summary["graph_launches"] = {}
    for path, eng, wrappers in (
            ("cli_train", eng_i, ("fused_render", "render_bwd_points", "render_bwd_weights",
                                  "sample_pdf_cuda")),
            ("cli_train_grid", eng_g, ("fused_shaded_mlp", "fused_shaded_mlp_bwd"))):
        summary["graph_launches"][path] = replayed_launches(
            eng, path, wrappers, {0: 0, 1: 2, 2: 2}, csrc_kernel_names())[0]
    for path, result, launches, kernels in (
            ("cli_demo", demo_i, l_demo, ("fused_mlp_apply_rays", "fused_render_rays",
                                          "sample_pdf_cuda")),
            ("cli_demo_grid", demo_g, l_demo_g, ("fused_mlp_apply_rays",
                                                 "fused_shaded_mlp_rays"))):
        print(f"{path}: {result} ({smi}); launches {launches}", flush=True)
        if not (result["count"] == n_test and math.isfinite(result["psnr"])
                and math.isfinite(result["ssim"])):
            fail(f"{path} result is not finite: {result}")
        if sorted(n for n, v in launches.items() if v) != sorted(kernels):
            fail(f"{path} launches {launches}, only {kernels} wanted")
        summary[path] = {"psnr": result["psnr"], "ssim": result["ssim"]}
    # every frame on the graph route: one capture a renderer, a replay a frame
    for path, kernels, n_frames in (
            ("cli_train", ("fused_mlp_apply_rays", "fused_render_rays", "sample_pdf_cuda"),
             sum(runs["importance"][0][1:])),
            ("cli_demo", ("fused_mlp_apply_rays", "fused_render_rays", "sample_pdf_cuda"), n_test),
            ("cli_train_grid", ("fused_mlp_apply_rays", "fused_shaded_mlp_rays"),
             sum(runs["grid"][0][1:])),
            ("cli_demo_grid", ("fused_mlp_apply_rays", "fused_shaded_mlp_rays"), n_test)):
        fr = frames[path]
        print(f"{path}: frames by route {fr['routes']}, launches in the frame graphs' replays "
              f"{fr['launches']}", flush=True)
        if (fr["routes"] != [{"captured": 1, "replayed": n_frames, "looped": 0}]
                or sorted(k for k, v in fr["launches"].items() if v) != sorted(kernels)):
            fail(f"{path}: frames by route {fr['routes']} ({n_frames} replays of one capture "
                 f"wanted), launches in their replays {fr['launches']} ({kernels} wanted)")
    summary["frames"] = frames
    print(f"cli resumed --train: epochs trained {len(eng_r.history)}, step "
          f"{int(state_r.step)}; launches {l_resume}", flush=True)
    if eng_r.history or state_r.step != state_i.step or any(l_resume.values()):
        fail("the resumed CLI run trained again")

    # every counted launch is a recorded call, on the path it was counted on
    counted = {"cli_train": l_train, "cli_demo": l_demo, "cli_train_grid": l_train_g,
               "cli_demo_grid": l_demo_g}
    check_recorded(calls, counted)
    shutil.rmtree(work, ignore_errors=True)
    return {"summary": summary, "calls": calls, "nerf": eng_i.cfg.nerf, "launches": counted}


def lpips_weights(path) -> None:
    """Seeded random LPIPS(alex) weights in the port's ``.npz`` format
    (``mc_nerf_torch/eval/lpips.py``): the real ones are not in the repo."""
    rng = np.random.default_rng(SEED)
    out, cin = {}, 3
    for i, (cout, k) in enumerate(((64, 11), (192, 5), (384, 3), (256, 3), (256, 3))):
        out[f"conv{i + 1}_w"] = rng.normal(scale=0.05, size=(k, k, cin, cout)).astype(np.float32)
        out[f"conv{i + 1}_b"] = rng.normal(scale=0.05, size=(cout,)).astype(np.float32)
        out[f"lin{i}"] = np.abs(rng.normal(size=(cout,))).astype(np.float32)
        cin = cout
    out["shift"] = np.array([-0.030, -0.088, -0.188], np.float32)
    out["scale"] = np.array([0.458, 0.448, 0.450], np.float32)
    np.savez(path, **out)


def cli_cf_phase(dev, smi: str, counters: dict) -> dict:
    """The CLI's coarse-free paths on a scene of its own
    (``make_dataset(calibration_mode="rendered")``, the CLI phase's views
    and cuts, its cache deleted so that the engine builds it), with the
    weights of ``CLI_CF``: ``cli_train_cf`` (``--train`` under the hybrid
    schedule on the bitpacked map: GLOBAL_OPTIM two-pass, FINE_TUNE
    coarse-free, the refresh from the coarse MLP), ``cli_demo_cf``
    (``--demo`` of its checkpoint, coarse-free, LPIPS scored with seeded
    random weights that ``$MC_NERF_LPIPS_WEIGHTS`` points at) and
    ``cli_demo_density`` (the same checkpoint's ``--demo`` with the
    density PMF: demo mode is exempt from the training refusal).  Checks,
    each path's launches counted from 0 just before it: per training
    epoch, ``fused_render``, ``render_bwd_points`` and
    ``render_bwd_weights`` exactly 2 per GLOBAL_OPTIM step and 1 per
    FINE_TUNE step; the validation renders' ``fused_render`` launches one
    per eval chunk; ``fused_mlp_apply`` (K1) never, on every path (every
    eval render is coarse-free); the coarse MLP's slice of ``p_flat``
    bit-identical before and after the FINE_TUNE epoch (and moved by the
    GLOBAL_OPTIM one); the demos finite; each demo view's LPIPS on the
    card within ``LPIPS_RTOL`` of the CPU's fp32 value on the same
    images; every launch a recorded call."""
    import os
    import pathlib
    import shutil
    import tempfile

    import mc_nerf_torch.train.engine as engine_module
    from mc_nerf_torch.data.calibration import CACHE_NAME
    from mc_nerf_torch.data.synthetic import make_dataset
    from mc_nerf_torch.eval import lpips as lpips_net
    from mc_nerf_torch.train.engine import STAGE_NAMES

    work = pathlib.Path(__file__).resolve().parent / "build" / f"cli_cf_smoke_{os.getpid()}"
    shutil.rmtree(work, ignore_errors=True)
    res, (n_train, n_val, n_test), name = ENGINE_RES, CLI_VIEWS, "Ball_Cf"
    make_dataset(str(work / "data" / name), n_train=n_train, n_val=n_val, n_test=n_test,
                 img_h=res, img_w=res, seed=SEED, calibration_mode="rendered")
    os.remove(work / "data" / name / CACHE_NAME)
    stages, warmup = CLI_CF["stages"], CLI_CUTS["occ_warmup_steps"]
    for run, extra in (("cf", CLI_CF["train"]), ("density", CLI_CF["density demo"])):
        (work / f"config_{run}").mkdir(parents=True)
        (work / f"config_{run}" / "config.yaml").write_text(
            cli_yaml(res, "importance", stages, warmup, work / "cf", extra))
    print(f"cli_cf: the reference-format scene ({n_train} + {n_val} + {n_test} views at "
          f"{res}x{res}); Config() widths, {CLI_CF['train']}, "
          f"stages {stages} of (20, 16, 16), occ_warmup_steps {warmup} of 3000", flush=True)

    lpips_seen = []
    lpips_fn = engine_module.lpips

    def recorded_lpips(pred, gt, *a):
        out = lpips_fn(pred, gt, *a)
        lpips_seen.append((pred.detach().cpu(), gt.detach().cpu(), out))
        return out

    env = os.environ.get(lpips_net.ENV_VAR)
    with tempfile.TemporaryDirectory() as tmp, \
            cli_recording(work, name, counters) as (cli, calls, builds, epochs, frames):
        weights = os.path.join(tmp, "lpips_alex_seeded.npz")
        lpips_weights(weights)
        state, l_train, eng = cli("cli_train_cf", "cf", "--train")
        os.environ[lpips_net.ENV_VAR] = weights
        engine_module.lpips = recorded_lpips
        try:
            demo_cf, l_demo, _ = cli("cli_demo_cf", "cf", "--demo")
        finally:
            engine_module.lpips = lpips_fn
            if env is None:
                os.environ.pop(lpips_net.ENV_VAR)
            else:
                os.environ[lpips_net.ENV_VAR] = env
        demo_d, l_density, eng_d = cli("cli_demo_density", "density", "--demo")
        lpips_cpu = [float(lpips_net.lpips_distance(lpips_net.load(weights), p, g))
                     for p, g, _ in lpips_seen]

    nc = eng.cfg.nerf
    if not (nc.coarse_free and nc.coarse_free_from_stage == 2 and nc.occ_map_dtype == "bitpack"
            and nc.cf_uniform_samples == 8 and eng_d.cfg.nerf.occ_pmf == "density"):
        fail(f"the coarse-free CLI configs were not read: {nc}, {eng_d.cfg.nerf}")
    spe = eng.steps_per_epoch
    summary = {"cache_builds": len(builds), "steps_per_epoch": spe,
               "epochs": untimed(eng.history)}
    for h in eng.history:
        print(f"cli_cf {STAGE_NAMES[h['stage']]} {h['epoch']}: loss {h['loss']:.6f} rgb_c "
              f"{h['loss_rgb_c']:.5f} rgb_f {h['loss_rgb_f']:.5f}"
              + (f"; val PSNR {h['val_psnr']:.3f}" if "val_psnr" in h else ""), flush=True)
        if not all(math.isfinite(h[k]) for k in ("loss", "loss_rgb_c", "loss_rgb_f")):
            fail(f"cli_cf epoch {h['epoch']} is not finite: {h}")
        if h["stage"] and (h["stage"] == 2) != (h["loss_rgb_c"] == 0.0):
            fail(f"cli_cf epoch {h['epoch']}: rgb_c {h['loss_rgb_c']} in stage {h['stage']}")
    if state.step != spe * sum(stages) or len(eng.history) != sum(stages):
        fail(f"cli_cf ran {int(state.step)} steps over {len(eng.history)} epochs")

    # per training epoch: 2 launches a two-pass step, 1 a coarse-free step,
    # counted over the epoch's warm-up and capture; its replays run them
    # again without the wrappers, which the profiler counts in one replay
    # (sample_pdf: a two-pass step's draws from the map's PMF and from the
    # coarse weights; a coarse-free step's one mixture draw)
    trained = [(stage, n) for path, stage, n, *_ in epochs if path == "cli_train_cf"]
    routes = [(stage, c) for path, stage, _, _, c in epochs if path == "cli_train_cf"]
    per_step = {0: 0, 1: 2, 2: 1}
    wrappers = ("fused_render", "render_bwd_points", "render_bwd_weights", "sample_pdf_cuda")
    for (stage, n), (_, c) in zip(trained, routes):
        want = {k: per_step[stage] * host_steps(c) if k in wrappers else 0 for k in n}
        if n != want or c["captured"] != 1 or c["looped"] or c["replayed"] != spe:
            fail(f"cli_train_cf {STAGE_NAMES[stage]}: launches {n}, wanted {want}; steps by "
                 f"route {c}: one capture and {spe} replays wanted")
    if [s for s, _ in trained] != [0, 1, 2]:
        fail(f"cli_train_cf trained stages {[s for s, _ in trained]}")
    summary["graph_launches"], summary["per_replay"] = replayed_launches(
        eng, "cli_train_cf", wrappers, per_step, csrc_kernel_names())
    # the validation frames: the wrappers count a chunk of warm-up and the
    # capture's chunks, once (every validation renders coarse-free on the
    # bitpacked map: one graph); the profiler a chunk's launch a replay.
    # A coarse-free chunk: one draw from the map's PMF, K2 on it
    eval_wrappers = ("fused_render_rays", "sample_pdf_cuda")
    val = {k: l_train[k] - sum(n[k] for _, n in trained) for k in l_train}
    chunks = -(-res * res // eng.cfg.eval.rays_per_chunk)
    n_val = sum(1 for h in eng.history if h["stage"])
    fr = frames["cli_train_cf"]
    if (val != {k: (1 + chunks if k in eval_wrappers else 0) for k in val}
            or fr["routes"] != [{"captured": 1, "replayed": n_val, "looped": 0}]
            or fr["launches"] != {k: (chunks * n_val if k in eval_wrappers else 0)
                                  for k in fr["launches"]}):
        fail(f"cli_train_cf validation launches {val} ({1 + chunks} of {eval_wrappers} "
             f"wanted), frames by route {fr['routes']}, in their replays {fr['launches']} "
             f"({chunks} of {eval_wrappers} a view wanted)")
    for path, launches in (("cli_demo_cf", l_demo), ("cli_demo_density", l_density)):
        fr = frames[path]
        if not (launches["fused_render_rays"] > 0
                and launches["sample_pdf_cuda"] == launches["fused_render_rays"]
                and all(v == 0 for k, v in launches.items() if k not in eval_wrappers)
                and fr["routes"] == [{"captured": 1, "replayed": n_test, "looped": 0}]
                and all(fr["launches"][k] == chunks * n_test for k in eval_wrappers)
                and all(v == 0 for k, v in fr["launches"].items() if k not in eval_wrappers)):
            fail(f"{path} launches {launches}, in its frame graphs' replays {fr['launches']}, "
                 f"frames by route {fr['routes']}: {eval_wrappers} alike and only (K1 never) "
                 "wanted")
    print(f"cli_train_cf: launches {l_train} (by epoch {trained}, validation {val}); "
          f"{len(builds)} cache build", flush=True)

    # the coarse MLP: moved by GLOBAL_OPTIM, frozen through FINE_TUNE
    flat = {e: torch.load(os.path.join(eng.ckpt_dir, str(e), "state.pt"),
                          weights_only=True)["p_flat"] for e in range(3)}
    n_cam = sum(p.numel() for p in eng.state.params.cam.parameters())
    coarse = slice(n_cam, n_cam + sum(p.numel() for p in eng.state.params.nerf.coarse.parameters()))
    frozen = torch.equal(flat[1][coarse], flat[2][coarse])
    if not frozen or torch.equal(flat[0][coarse], flat[1][coarse]):
        fail("cli_cf: the coarse MLP moved in FINE_TUNE, or stood still in GLOBAL_OPTIM")

    # the demos, and LPIPS on the card against the CPU's fp32 value
    for path, result in (("cli_demo_cf", demo_cf), ("cli_demo_density", demo_d)):
        print(f"{path}: {result} ({smi})", flush=True)
        if not (result["count"] == n_test and math.isfinite(result["psnr"])
                and math.isfinite(result["ssim"])):
            fail(f"{path} result is not finite: {result}")
    if demo_d["lpips"] is not None:
        fail("cli_demo_density scored LPIPS without a weights file")
    card = [lp for _, _, lp in lpips_seen]
    rel = [abs(a - b) / abs(b) for a, b in zip(card, lpips_cpu)]
    print(f"cli_demo_cf LPIPS (seeded random weights) per view on the card {card}, on the CPU "
          f"{lpips_cpu}: relative error {max(rel):.3e} (bound {LPIPS_RTOL})", flush=True)
    if len(card) != n_test or demo_cf["lpips"] is None or not max(rel) <= LPIPS_RTOL:
        fail(f"cli_demo_cf LPIPS {demo_cf['lpips']}: card {card} against CPU {lpips_cpu}")

    counted = {"cli_train_cf": l_train, "cli_demo_cf": l_demo, "cli_demo_density": l_density}
    check_recorded(calls, counted)
    shutil.rmtree(work, ignore_errors=True)
    summary.update({"demo_cf": {k: demo_cf[k] for k in ("psnr", "ssim", "lpips")},
                    "demo_density": {k: demo_d[k] for k in ("psnr", "ssim")},
                    "lpips_card": card, "lpips_cpu": lpips_cpu, "lpips_rel_err": max(rel),
                    "coarse_frozen": frozen, "launches_by_epoch": trained,
                    "steps_by_route": routes, "validation_launches": val, "frames": frames})
    return {"summary": summary, "calls": calls, "nerf": nc, "launches": counted}


def nccl_kinds(dev, world: int, reduces: list) -> dict:
    """This rank's part of the data-parallel step kinds over NCCL: for
    each of ``STEP_KINDS``, on the workload bench.py times (``Config()``
    widths, 7000 rays a rank: each rank keeps its image of the global
    batch), epochs of ``DP_STEPS`` steps from one state and seed: the
    loop's, then two of the graph route (``graph=True``: one graph a step,
    its collectives captured in it), the first with its warm-up and
    capture, the second replays alone; then each route's launches a step
    from epochs under the profiler (``profile_fullest``: the fullest of
    ``FULLEST_OF``; the graph route's are its replays), and the graph is
    released (``StageEpoch.release``).  ``reduces`` is the list the rank's
    gradient all-reduces on the host append (numel, bytes an element) to.
    Returns {kind: the graph route's states against the loop's (the gap,
    bit for bit), the sha256 of each route's last state (p_flat, mu, nu,
    count, step), the profiled launches a step of each kernel of csrc/,
    the gradient all-reduces a step on the host by route, the steps by
    route and the route}."""
    from mc_nerf_torch.tools.profile_step import count_named, profile_fullest
    from mc_nerf_torch.tools.scene import TOTAL_STEPS
    from mc_nerf_torch.train.steps import make_stage_epoch

    names, n, out = csrc_kernel_names(), DP_STEPS, {}
    for kind, (stage, train_kw, nerf_kw) in STEP_KINDS.items():
        cfg, state, data, txs, live = kind_workload(dev, stage, train_kw, nerf_kw)
        grad_numel = state.p_flat.numel()
        start = [t.clone() for t in live]
        gen = torch.Generator(device=dev)
        eps = {route: make_stage_epoch(cfg, stage, txs[stage], 800, 800, TOTAL_STEPS, n, world,
                                       graph=route == "graph")
               for route in ("loop", "graph")}

        def run(route):
            """An epoch of ``route`` from the start state and seed: (the
            state after it, the gradient all-reduces on the host a step)."""
            with torch.no_grad():
                for t, v in zip(live, start):
                    t.copy_(v)
            gen.manual_seed(SEED + 1)
            i = len(reduces)
            m = eps[route](state, data, gen)
            if not all(math.isfinite(float(v)) for v in m.values()):
                fail(f"kinds {kind}: epoch metrics not finite: {m}")
            return [t.clone() for t in live], sum(r[0] == grad_numel for r in reduces[i:]) / n

        loop, loop_reduces = run("loop")
        graphs = [run("graph") for _ in range(2)]
        same = all(torch.equal(x, y) for e, _ in graphs for x, y in zip(e, loop))
        gap = max(float((x.double() - y.double()).abs().max())
                  for e, _ in graphs for x, y in zip(e, loop))
        named = {}
        for route, ep in eps.items():
            named[route] = count_named(profile_fullest(lambda: ep(state, data, gen), n), names)
        out[kind] = {
            "stage": stage, "gap": gap, "bit_identical": same,
            "digests": {"loop": [digest(t) for t in loop],
                        "graph": [digest(t) for t in graphs[-1][0]]},
            "named_a_step": named, "counts": {r: dict(ep.counts) for r, ep in eps.items()},
            "route": eps["graph"].route(dev),
            "grad_reduces": {"loop": loop_reduces, "graph": graphs[-1][1]}}
        eps["graph"].release()
        del eps, state, data, live, start
        torch.cuda.empty_cache()
    return out


def dp_rank(spec: dict) -> None:
    """One rank of ``dp_phase`` (``spec["cli"]``) or of ``nccl_phase``
    (``spec["kinds"]``), started with torchrun's environment (``python3
    chip_smoke.py --dp-rank <spec>``).  Joins the group
    (``initialize_distributed``: the rank's card by the device rule, the
    backend by the backend rule) and records the step's gradient
    all-reduces on the host (``steps.all_reduce_mean_``: not under
    capture, where NCCL's is captured in the step's graph).
    With ``spec["kinds"]`` it runs the step kinds (``nccl_kinds``).  With
    ``spec["cli"]`` it drives ``mc_nerf_torch.main.main`` under the CLI
    phases' instrumentation (``cli_recording``): ``dp_train``
    (``--train``) and ``dp_demo`` (``--demo``), each path's launches
    counted from 0 just before it, the demo's PNG writes recorded.  With
    ``spec["split"]`` it then renders frames split over the ranks
    (``split_rank``).  Writes ``rank<r>.json`` under the phase's
    directory, and on rank 0 the recorded kernel inputs (``calls.pt``;
    the CLI's checked against the launches counted)."""
    import pathlib

    import torch.distributed as dist

    import mc_nerf_torch.train.engine as engine_module
    import mc_nerf_torch.train.steps as steps_module
    from mc_nerf_torch.ops.cuda.fused_mlp import (
        fused_mlp_apply, fused_shaded_mlp, fused_shaded_mlp_bwd)
    from mc_nerf_torch.ops.cuda.fused_render import (
        fused_render, render_bwd_points, render_bwd_weights)
    from mc_nerf_torch.ops.cuda.sample_pdf import sample_pdf_cuda
    from mc_nerf_torch.parallel.distributed import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False    # as the parent's runs
    torch.backends.cudnn.allow_tf32 = False
    topo = initialize_distributed()
    work = pathlib.Path(spec["work"])
    counters = {k.__name__: k for k in (fused_render, render_bwd_points, render_bwd_weights,
                                        fused_mlp_apply, fused_shaded_mlp, fused_shaded_mlp_bwd,
                                        *rays_wrappers(), sample_pdf_cuda)}
    reduces, written = [], []
    mean_, write = steps_module.all_reduce_mean_, engine_module._write_pngs

    def recorded_mean_(t):
        if not torch.cuda.is_current_stream_capturing():
            reduces.append((t.numel(), t.element_size()))
        return mean_(t)

    def recorded_write(dirs, i, *a):
        written.append(i)
        return write(dirs, i, *a)

    steps_module.all_reduce_mean_, engine_module._write_pngs = recorded_mean_, recorded_write
    out = {"rank": topo.rank, "world": topo.world, "backend": dist.get_backend(),
           "device": str(topo.device), "current_device": torch.cuda.current_device()}
    try:
        if spec.get("kinds"):
            out["kinds"] = nccl_kinds(topo.device, topo.world, reduces)
        calls = {}
        if spec.get("cli"):
            with cli_recording(work, spec["name"], counters) as (cli, calls, builds, epochs,
                                                                 frames):
                state, l_train, eng = cli("dp_train", "dp", "--train")
                demo, l_demo, _ = cli("dp_demo", "dp", "--demo")
            grads = [n * size for n, size in reduces if n == state.p_flat.numel()]
            out.update({
                "steps_per_epoch": eng.steps_per_epoch, "step": int(state.step),
                "history": untimed(eng.history), "epochs": epochs,
                "final_occ": digest(eng._occ_map),
                "launches": {"dp_train": l_train, "dp_demo": l_demo}, "frames": frames,
                "routes": {s: ep.route(topo.device) for s, ep in eng._epoch_fns.items()},
                "demo": demo, "written": written, "cache_builds": len(builds),
                "kept": eng.ckpt.epochs(), "grad_reduces": len(grads),
                "p_flat_bytes": state.p_flat.numel() * state.p_flat.element_size(),
                "grad_reduce_bytes": grads[0] if grads else 0})
            if topo.rank == 0:
                check_recorded(calls, {"dp_train": l_train, "dp_demo": l_demo})
        if spec.get("split"):
            out["split"] = split_rank(topo, spec["split"], counters, calls)
        if topo.rank == 0:
            torch.save(calls, work / "calls.pt")
    finally:
        steps_module.all_reduce_mean_, engine_module._write_pngs = mean_, write
    (work / f"rank{topo.rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()


def split_rank(topo, which: str, counters: dict, calls: dict) -> dict:
    """A rank's split frames (``split_frames``) of ``which``'s cells ("dp":
    ``DP_SPLIT_CELLS``, "nccl": ``NCCL_SPLIT_CELLS``), the eval kernels'
    entry points recorded into ``calls`` as path ``<which>_split`` during
    each split graph's first frame (``engine_recorder``, each shape's last
    call: the graph's own tensors, as its last replay left them)."""
    where = [None]
    cells = {"dp": DP_SPLIT_CELLS, "nccl": NCCL_SPLIT_CELLS}[which]
    with recording_frames(where, calls):
        return split_frames(topo.device, topo.world, cells,
                            {k: counters[k] for k in FRAME_SIGNATURE}, (where, f"{which}_split"))


def split_frames(dev, world: int, cells, counters: dict, record=None) -> dict:
    """This rank's part of frames split over the ``world`` ranks of the
    group (``make_render_fn(..., world=world)``, the graph route: this
    rank's blocks one CUDA graph, the gather after its replay), one for
    each (mode, side) of ``cells`` (``frame_cell``).  For each: the split
    frame against this rank's own one-process frame in chunks of a block
    (``world=1``, no collective: the same rays in the same groups), bit for
    bit, and its digest, which the ranks must share; the eval kernels'
    launches a replay of the split graph (profiled, ``replayed_frames``)
    and in the run's replays, and the wrappers' (``counters``, set to 0
    just before) in its first frame: a block of warm-up and the capture.
    ``record``: (the kernels' recorders' path list, the path to name during
    that first frame).  Returns {"mode side": numbers}."""
    from mc_nerf_torch.train.steps import make_render_fn

    def one(mode, side) -> dict:
        cfg, params, occ, (pose,), K = frame_cell(mode, side, dev)
        split = make_render_fn(cfg, side, side, device=dev, world=world)
        ref = make_render_fn(cfg, side, side, rays_per_chunk=split.block, device=dev)
        for c in counters.values():
            c.launches = 0
        if record is not None:
            record[0][0] = record[1]
        frame = split(params, pose, K, occ)
        torch.cuda.synchronize()
        if record is not None:
            record[0][0] = None
        counted = {k: c.launches for k, c in counters.items()}
        want = ref(params, pose, K, occ)
        torch.cuda.synchronize()
        total, graphs = replayed_frames([split], f"split {mode} {side}x{side}")
        (replay,) = graphs.values()
        numbers = {
            "bit_identical": all(torch.equal(a, b) for a, b in zip(frame, want)),
            "gap": max(float((a - b).abs().max()) for a, b in zip(frame, want)),
            "finite": all(bool(torch.isfinite(t).all()) for t in frame),
            "digest": hashlib.sha256("".join(digest(t) for t in frame).encode()).hexdigest(),
            "chunk": split.chunk, "block": split.block, "chunks": split.n_chunks,
            "launches_a_replay": replay["per_replay"], "launches": total,
            "launches_counted": counted, "route": split.route(),
            "frames_by_route": dict(split.counts)}
        for r in (split, ref):
            r.release()
        return numbers

    out = {}
    for mode, side in cells:
        out[f"{mode} {side}"] = one(mode, side)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def check_split_frames(ranks: list, cells, smi: str, label: str) -> dict:
    """Checks and prints the split frames ``split_frames`` rendered on each
    rank of ``ranks`` (their ``rank<r>.json``'s ``"split"``): on every rank
    the frame equal to its one-process frame in chunks of a block, bit for
    bit, finite, the same bits on every rank; the graph route with the
    gather after its replay (``FrameRender.route``), captured once; each
    wrapper launched ``FRAME_LAUNCHES[mode]`` times a chunk's block in a
    replay (profiled), and no other.  Returns {cell: summary}."""
    world, out = len(ranks), {}
    for mode, side in cells:
        cell = f"{mode} {side}"
        xs = [r["split"][cell] for r in ranks]
        want = {k: FRAME_LAUNCHES[mode].get(k, 0) * xs[0]["chunks"] for k in FRAME_SIGNATURE}
        bad = [r for r, x in enumerate(xs) if not (
            x["bit_identical"] and x["finite"] and x["digest"] == xs[0]["digest"]
            and x["launches_a_replay"] == want
            and x["route"].startswith("one CUDA graph of the frame")
            and f"split over {world} ranks, one all-gather a frame" in x["route"]
            and x["frames_by_route"]["captured"] == 1 and x["frames_by_route"]["looped"] == 0)]
        summary = {
            "gap": [x["gap"] for x in xs], "bit_identical": [x["bit_identical"] for x in xs],
            "same_on_every_rank": len({x["digest"] for x in xs}) == 1,
            "launches_a_replay": [x["launches_a_replay"] for x in xs],
            "launches": [x["launches"] for x in xs],
            "launches_counted": [x["launches_counted"] for x in xs], "chunk": xs[0]["chunk"],
            "block": xs[0]["block"], "chunks": xs[0]["chunks"], "route": xs[0]["route"]}
        out[cell] = summary
        print(f"{label} split frame, {cell}x{side} over {world} ranks ({summary['chunks']} chunks "
              f"of {summary['chunk']} rays, {summary['block']} a rank): bit-identical to one "
              f"process in chunks of {summary['block']} {summary['bit_identical']}, the same on "
              f"every rank {summary['same_on_every_rank']}; launches a replay (profiled) "
              f"{summary['launches_a_replay']}; route {summary['route']!r} ({smi})", flush=True)
        if bad:
            fail(f"{label} split frame {cell}: ranks {bad} stray from the one-process frame, "
                 f"from each other or from the launches ({want} a replay) and route wanted: "
                 f"{[xs[r] for r in bad]}")
    return out


def check_nccl_kinds(ranks: list, smi: str) -> dict:
    """Checks and prints the step kinds ``nccl_kinds`` ran on each rank of
    ``ranks`` (their ``rank<r>.json``): on every rank the graph route's
    state equal to the loop's bit for bit after every epoch, the same
    bits on every rank, the graph captured once after its warm-up, one
    graph over the ranks, the profiled launches a step of the kernels of
    csrc/ the same on both routes and ``DP_LAUNCHES[kind]`` of each
    wrapper's ``SIGNATURE`` kernel, one gradient all-reduce a step on the
    host in the loop and none outside the graph.  Returns {kind:
    summary}."""
    from mc_nerf_torch.tools.profile_step import FULLEST_OF
    from mc_nerf_torch.train.steps import WARMUP_STEPS

    out = {}
    for kind in STEP_KINDS:
        xs = [r["kinds"][kind] for r in ranks]
        x = xs[0]
        want = DP_LAUNCHES[kind]
        got = [{k: y["named_a_step"]["graph"].get(k, 0) for k in want} for y in xs]
        bad = [r for r, y in enumerate(xs) if not (
            y["bit_identical"] and y["digests"] == x["digests"]
            and y["counts"]["graph"] == {"warmup": WARMUP_STEPS, "captured": 1,
                                         "replayed": (2 + FULLEST_OF) * DP_STEPS,
                                         "looped": 0}
            and f"one CUDA graph of the step over {len(xs)} ranks" in y["route"]
            and y["named_a_step"]["graph"] == y["named_a_step"]["loop"] and got[r] == want
            and y["grad_reduces"] == {"loop": 1.0, "graph": 0.0})]
        out[kind] = {"gap": [y["gap"] for y in xs],
                     "bit_identical": [y["bit_identical"] for y in xs],
                     "launches_a_step": got, "grad_reduces": [y["grad_reduces"] for y in xs],
                     "route": x["route"]}
        print(f"nccl {kind}: graph against loop {out[kind]['gap']} (bit-identical: "
              f"{out[kind]['bit_identical']}); launches a step {got}; gradient all-reduces a "
              f"step on the host (loop / graph) {out[kind]['grad_reduces']}; route "
              f"{x['route']!r} ({smi})", flush=True)
        if bad:
            fail(f"nccl {kind}: ranks {bad} stray from the loop, from each other or from "
                 f"the launches and route wanted: {[xs[r] for r in bad]}")
    return out


def dp_phase(dev, smi: str) -> dict:
    """Data parallelism on the one card: ``DP_WORLD`` ranks, subprocesses
    with torchrun's environment (``parallel/dryrun.py::spawn_ranks``), each
    ``dp_rank``: ``main()`` ``--train`` then ``--demo`` on the CLI phase's
    kind of scene (``make_dataset(calibration_mode="rendered")``, its cache
    deleted so that rank 0 builds it) at ``Config()``'s widths, 7000 rays a
    rank, stages ``DP_CUTS``.  Checks: the world, the backend (gloo: ranks
    share the card) and both ranks on ``cuda:0``; per rank and training
    epoch, ``fused_render``, ``render_bwd_points`` and
    ``render_bwd_weights`` exactly 2 a step in the NeRF stages and 0 in
    CAM_PARAM, every step on the loop (gloo's collectives run on the
    host: no graph holds them) and the route logged so, steps per epoch
    half the 1-rank run's; ``p_flat`` after
    every epoch and the occupancy map of every epoch the same bits on both
    ranks; rank 0 alone built the cache; the run against a 1-rank
    ``Engine`` with ``images_per_batch=2`` from the same seed and draws
    (``DP_TOL``); the demo: the same dict on both ranks, each view's PNGs
    written once under one stamped directory, the scores of the 1-rank
    demo of the same checkpoint; every validation and demo frame split
    over the ranks, on each rank one graph of its blocks, captured once
    and replayed once a frame; the split frames of ``DP_SPLIT_CELLS``
    (``split_frames``, ``check_split_frames``: bit for bit against one
    process in chunks of a block); then ``torchrun`` itself (``python -m
    torch.distributed.run --standalone``) trains stages ``DP_CUTS["launch
    stages"]`` to the end.  Returns the summary, rank 0's recorded kernel
    inputs and the launches."""
    import os
    import pathlib
    import shutil

    from mc_nerf_torch.config import build_argparser, from_args
    from mc_nerf_torch.data.calibration import CACHE_NAME
    from mc_nerf_torch.data.synthetic import make_dataset
    from mc_nerf_torch.parallel.dryrun import spawn_ranks
    from mc_nerf_torch.train.engine import STAGE_NAMES, Engine

    work = pathlib.Path(__file__).resolve().parent / "build" / f"dp_smoke_{os.getpid()}"
    shutil.rmtree(work, ignore_errors=True)
    res, (n_train, n_val, n_test), name = ENGINE_RES, CLI_VIEWS, "Ball_Dp"
    scene_dir = work / "data" / name
    make_dataset(str(scene_dir), n_train=n_train, n_val=n_val, n_test=n_test, img_h=res,
                 img_w=res, seed=SEED, calibration_mode="rendered")
    os.remove(scene_dir / CACHE_NAME)
    stages, warmup = DP_CUTS["stages"], DP_CUTS["occ_warmup_steps"]
    for run, st in (("dp", stages), ("launch", DP_CUTS["launch stages"])):
        (work / f"config_{run}").mkdir(parents=True)
        (work / f"config_{run}" / "config.yaml").write_text(
            cli_yaml(res, "importance", st, warmup, work / run))
    flags = lambda run, mode: [mode, "--config", str(work / f"config_{run}"), "--root_data",
                               str(work / "data"), "--data_name", name]
    print(f"dp: {DP_WORLD} ranks on one card; the scene ({n_train} + {n_val} + {n_test} views "
          f"at {res}x{res}, its cache deleted); Config() widths, stages {stages} of (20, 16, "
          f"16), occ_warmup_steps {warmup} of 3000", flush=True)

    # the ranks share the card with this process: hand its cache back
    gc.collect()
    torch.cuda.empty_cache()
    print(f"dp: this process holds {torch.cuda.memory_reserved() / 2**30:.2f} GiB of the card "
          "while the ranks run", flush=True)
    # every rank on the one card (on a machine with more, the backend rule
    # would give each its own card and NCCL: nccl_phase's case)
    one_card = {"CUDA_VISIBLE_DEVICES": os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]}
    spawn_ranks(DP_WORLD, [str(pathlib.Path(__file__).resolve()), "--dp-rank",
                           json.dumps({"work": str(work), "name": name, "cli": True,
                                       "split": "dp"})],
                str(work), env=one_card, timeout=900)
    ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(DP_WORLD)]
    calls = torch.load(work / "calls.pt", weights_only=False)
    r0 = ranks[0]
    spe = r0["steps_per_epoch"]

    # the topology, the schedule, the launches a step
    for r, x in enumerate(ranks):
        if (x["rank"], x["world"], x["backend"], x["device"], x["current_device"]) != (
                r, DP_WORLD, "gloo", "cuda:0", 0):
            fail(f"dp rank {r}: {x['rank']} of {x['world']}, {x['backend']} on {x['device']} "
                 f"(current {x['current_device']}): rank {r} of {DP_WORLD}, gloo on cuda:0 "
                 "wanted")
        if x["steps_per_epoch"] != n_train * 50 // DP_WORLD or x["step"] != spe * sum(stages):
            fail(f"dp rank {r}: {x['steps_per_epoch']} steps an epoch, {x['step']} in all")
        trained = [(stage, n, c) for path, stage, n, _, c in x["epochs"] if path == "dp_train"]
        if [s for s, *_ in trained] != [0, 1, 2]:
            fail(f"dp rank {r} trained stages {[s for s, *_ in trained]}")
        for stage, n, c in trained:
            want = {k: (2 * host_steps(c) if stage and k in (
                "fused_render", "render_bwd_points", "render_bwd_weights", "sample_pdf_cuda")
                        else 0) for k in n}
            if n != want or (c["captured"], c["looped"], c["replayed"]) != (0, spe, 0):
                fail(f"dp rank {r} {STAGE_NAMES[stage]}: launches {n}, wanted {want}; steps by "
                     f"route {c}: {spe} on the loop wanted")
        if not all(v == GLOO_ROUTE for v in x["routes"].values()):
            fail(f"dp rank {r}: routes {x['routes']}, {GLOO_ROUTE!r} wanted")
        if (x["grad_reduces"] != spe * sum(stages)
                or x["grad_reduce_bytes"] != x["p_flat_bytes"]):
            fail(f"dp rank {r}: {x['grad_reduces']} gradient all-reduces of "
                 f"{x['grad_reduce_bytes']} bytes")
    digests = [[e[3] for e in x["epochs"]] for x in ranks]
    same_bits = digests[0] == digests[1] and r0["final_occ"] == ranks[1]["final_occ"]
    print(f"dp: p_flat after each epoch and each epoch's map the same bits on both ranks: "
          f"{same_bits}", flush=True)
    if not same_bits:
        fail(f"dp: the ranks' parameters or maps differ: {digests}")
    if (r0["cache_builds"], ranks[1]["cache_builds"]) != (1, 0):
        fail(f"dp: cache builds by rank {[x['cache_builds'] for x in ranks]}: rank 0's alone")
    if r0["kept"] != [0, 1, 2]:
        fail(f"dp: checkpoints {r0['kept']}")
    # the frames, split over the ranks: every rank renders every validation
    # and demo view, its blocks a replay of one graph, the gather after it
    n_val = sum(1 for h in r0["history"] if h["stage"])
    frame_routes = [{path: x["frames"].get(path, {}).get("routes") for path in ("dp_train",
                                                                             "dp_demo")}
                    for x in ranks]
    want = [{"dp_train": [{"captured": 1, "replayed": n_val, "looped": 0}],
             "dp_demo": [{"captured": 1, "replayed": n_test, "looped": 0}]}] * DP_WORLD
    print(f"dp: frames by route and rank {frame_routes}", flush=True)
    if frame_routes != want:
        fail(f"dp: frames by route {frame_routes}, {want} wanted")
    split = check_split_frames(ranks, DP_SPLIT_CELLS, smi, "dp")

    # the 1-rank run with twice the images a step, and its demo
    cfg1 = from_args(build_argparser().parse_args(flags("dp", "--train")))
    cfg1 = cfg1.replace(train=dataclasses.replace(cfg1.train, images_per_batch=DP_WORLD),
                        paths=dataclasses.replace(cfg1.paths,
                                                  root_weights=str(work / "one" / "weights"),
                                                  root_out=str(work / "one" / "results")))
    eng1 = Engine(cfg1, dev)
    one_flat, epoch_fn = [], eng1._epoch_fn

    def kept_epoch_fn(stage):
        fn = epoch_fn(stage)

        def run(*args):
            out = fn(*args)
            one_flat.append(eng1.state.p_flat.clone())
            return out
        return run

    eng1._epoch_fn = kept_epoch_fn
    eng1.train()
    if eng1.steps_per_epoch != spe:
        fail(f"dp: the 1-rank run takes {eng1.steps_per_epoch} steps an epoch, not {spe}")
    ckpt_dir = work / "dp" / "weights" / "train" / name
    dp_flat = [torch.load(ckpt_dir / str(e) / "state.pt", weights_only=True)["p_flat"]
               for e in range(sum(stages))]
    metric_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                     for a, b in zip(r0["history"], eng1.history)
                     for k in ("loss", "loss_intr", "loss_extr", "loss_rgb_c", "loss_rgb_f"))
    param_errs = [float((a.to(dev) - b).abs().max() / b.abs().max())
                  for a, b in zip(dp_flat, one_flat)]
    param_err = max(param_errs)
    cfg_d = from_args(build_argparser().parse_args(flags("dp", "--demo")))
    cfg_d = cfg_d.replace(paths=dataclasses.replace(cfg_d.paths,
                                                    root_out=str(work / "one" / "demo")))
    demo1 = Engine(cfg_d, dev).demo()
    demo_err = max(abs(r0["demo"][k] - demo1[k]) / abs(demo1[k]) for k in ("psnr", "ssim"))
    print(f"dp against 1 rank with images_per_batch={DP_WORLD}: epoch metrics within "
          f"{metric_err:.3e} (bound {DP_TOL['metrics rel']}), parameters after each epoch "
          f"within {', '.join(f'{e:.3e}' for e in param_errs)} of their largest entry (bound "
          f"{DP_TOL['params']}); demo scores within "
          f"{demo_err:.3e} (bound {DP_TOL['demo rel']}): 2 ranks {r0['demo']}, 1 rank {demo1}",
          flush=True)
    if not (metric_err <= DP_TOL["metrics rel"] and param_err <= DP_TOL["params"]
            and demo_err <= DP_TOL["demo rel"]):
        fail("dp: the 2-rank run strays from the 1-rank run with twice the images")

    # the demo: one dict, each view written once, one stamped directory
    out_dir = r0["demo"]["out_dir"]
    written = sorted(ranks[0]["written"] + ranks[1]["written"])
    stamped = [d for d in os.listdir(os.path.dirname(out_dir)) if d.startswith("img_rendered_")]
    pngs = {k: sorted(os.listdir(os.path.join(out_dir, k))) for k in ("pred", "depth", "gt")}
    print(f"dp_demo: both ranks {r0['demo']}; views written by rank "
          f"{[x['written'] for x in ranks]}; {stamped}: {pngs}", flush=True)
    if (ranks[1]["demo"] != r0["demo"] or written != list(range(n_test)) or len(stamped) != 1
            or any(len(v) != n_test for v in pngs.values())
            or not all(math.isfinite(r0["demo"][k]) for k in ("psnr", "ssim"))):
        fail("dp_demo: the ranks' demos disagree, or a view was written twice or never")

    # torchrun itself
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", str(DP_WORLD), "-m", "mc_nerf_torch",
                           *flags("launch", "--train")], capture_output=True, text=True,
                          env={**os.environ, **one_card}, timeout=900)
    routes = launched_routes(proc.stdout + proc.stderr)
    launch_dir = work / "launch" / "weights" / "train" / name
    launch_kept = sorted(int(n) for n in os.listdir(launch_dir)) if launch_dir.is_dir() else []
    print(f"dp torchrun --nproc_per_node {DP_WORLD} -m mc_nerf_torch --train: rc "
          f"{proc.returncode}; checkpoints {launch_kept}; routes {routes}",
          flush=True)
    if (proc.returncode != 0 or launch_kept != list(range(sum(DP_CUTS["launch stages"])))
            or routes != [GLOO_ROUTE]):
        fail("torchrun's run failed:\n" + proc.stdout[-3000:] + proc.stderr[-6000:])

    shutil.rmtree(work, ignore_errors=True)
    summary = {"steps_per_epoch": spe, "split": split, "metric_err": metric_err,
               "param_err": param_err, "param_errs": param_errs, "demo_err": demo_err,
               "grad_reduce_bytes": r0["grad_reduce_bytes"], "card": smi}
    # each path's launches by rank: the wrappers' (warm-ups, captures) and
    # those in the frame graphs' replays (profiled)
    summary["launches"] = {path: [x["launches"][path] for x in ranks]
                           for path in ("dp_train", "dp_demo")}
    summary["frame_launches"] = {path: [x["frames"][path]["launches"] for x in ranks]
                                 for path in ("dp_train", "dp_demo")}
    return {"summary": summary, "calls": calls, "nerf": eng1.cfg.nerf}


def nccl_phase(smi: str) -> Optional[dict]:
    """NCCL on every card of the machine, where it has two or more:
    ``torchrun --standalone --nproc_per_node <cards>`` (``python -m
    torch.distributed.run``) of ``dp_rank`` without the CLI, one rank a
    card (the backend rule picks NCCL), each running the step kinds
    (``nccl_kinds``): the graph route is one CUDA graph a step, its
    collectives captured in it; then frames split over the ranks
    (``split_frames`` of ``NCCL_SPLIT_CELLS``).  Checks
    (``check_nccl_kinds``): the graph's state equal to the loop's bit for
    bit on every rank and the same on all ranks, one graph a step, the
    launches a step, the loop's all-reduces on the host;
    (``check_split_frames``) each split frame the same on every rank and
    bit for bit one process's frame in chunks of a block; each eval kernel
    held on rank 0's blocks (``split_kernels``).  Then ``nccl_cli``.  With
    one card it prints that it is skipped and returns None."""
    import os
    import pathlib
    import shutil

    n = torch.cuda.device_count()
    if n < 2:
        print(f"nccl phase: skipped: {n} card (one graph a step over NCCL needs two or more)",
              flush=True)
        return None
    work = pathlib.Path(__file__).resolve().parent / "build" / f"nccl_smoke_{os.getpid()}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    rc, out = torchrun(n, [str(pathlib.Path(__file__).resolve()), "--dp-rank",
                           json.dumps({"work": str(work), "kinds": True, "split": "nccl"})],
                       900)
    if rc != 0:
        fail(f"nccl phase: torchrun over {n} cards exited {rc}:\n" + out[-8000:])
    ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(n)]
    for r, x in enumerate(ranks):
        if (x["rank"], x["world"], x["backend"], x["device"]) != (r, n, "nccl", f"cuda:{r}"):
            fail(f"nccl rank {r}: {x['rank']} of {x['world']}, {x['backend']} on {x['device']}: "
                 f"rank {r} of {n}, nccl on cuda:{r} wanted")
    kinds = check_nccl_kinds(ranks, smi)
    split = check_split_frames(ranks, NCCL_SPLIT_CELLS, smi, "nccl")
    kernels = split_kernels(torch.load(work / "calls.pt", weights_only=False), "nccl_split")
    frames = nccl_cli(work, n, smi)
    shutil.rmtree(work, ignore_errors=True)
    return {"cards": n, "kinds": kinds, "split": split, "kernels": kernels,
            "launch_frames": frames, "card": smi}


def split_kernels(calls: dict, path: str) -> list:
    """The kernels line's entries of a split path: K1, K2, K4 and
    ``sample_pdf_cuda`` held against their plain versions, with the
    planted faults, on the block inputs rank 0 gave them there (``calls``,
    recorded by ``split_rank``; ``path_kernel_holds`` at ``Config()``'s
    widths, which ``frame_cell`` keeps).  Fails unless each of them was
    held on the path."""
    from mc_nerf_torch.config import Config

    failures = []
    checked = path_kernel_holds(calls, Config().nerf, plants=True, failures=failures)
    if failures:
        fail(f"the {path} kernel checks failed: " + "; ".join(failures))
    if set(checked) != {(path, name) for name in FRAME_SIGNATURE}:
        fail(f"kernels checked on the {path} path {sorted(checked)}")
    return kernel_entries(checked)


def nccl_cli(work, n: int, smi: str, timeout: float = 300.0) -> list:
    """``torchrun --standalone --nproc_per_node n -m mc_nerf_torch --train``
    on a seeded scene under ``work`` (``CLI_VIEWS`` at ``ENGINE_RES``,
    the analytic calibration), stages ``DP_CUTS["launch stages"]``: the
    engine over NCCL, one rank a card.  Fails unless it exits 0 within
    ``timeout`` seconds (printing what the ranks wrote if not), keeps
    every checkpoint, logs one graph of the step over the ``n`` ranks and
    renders the validation frames split over the ranks, each rank's blocks
    through one graph, captured while the group and the step graphs live,
    and gathered after its replay.  Returns the frames' routes logged."""
    import os

    from mc_nerf_torch.data.synthetic import make_dataset

    name, (n_train, n_val, n_test) = "Ball_Nccl", CLI_VIEWS
    make_dataset(str(work / "data" / name), n_train=n_train, n_val=n_val, n_test=n_test,
                 img_h=ENGINE_RES, img_w=ENGINE_RES, seed=SEED)
    (work / "config").mkdir()
    (work / "config" / "config.yaml").write_text(cli_yaml(
        ENGINE_RES, "importance", DP_CUTS["launch stages"], DP_CUTS["occ_warmup_steps"],
        work / "launch"))
    rc, out = torchrun(n, ["-m", "mc_nerf_torch", "--train", "--config", str(work / "config"),
                           "--root_data", str(work / "data"), "--data_name", name], timeout)
    routes = launched_routes(out)
    frames = launched_routes(out, "frames: ")
    launch_dir = work / "launch" / "weights" / "train" / name
    kept = sorted(int(e) for e in os.listdir(launch_dir)) if launch_dir.is_dir() else []
    print(f"nccl torchrun --nproc_per_node {n} -m mc_nerf_torch --train: rc {rc}; checkpoints "
          f"{kept}; routes {routes}; frames {frames} ({smi})", flush=True)
    if (rc != 0 or kept != list(range(sum(DP_CUTS["launch stages"])))
            or not routes or not all(f"one CUDA graph of the step over {n} ranks" in r
                                     for r in routes)
            or not frames or not all(r.startswith("one CUDA graph of the frame")
                                     and f"split over {n} ranks, one all-gather a frame" in r
                                     for r in frames)):
        fail("nccl: torchrun's run failed:\n" + out[-8000:])
    return frames


def torchrun(n: int, args: list, timeout: float) -> tuple:
    """``python -m torch.distributed.run --standalone --nproc_per_node n
    <args>`` in a session of its own, its output and errors merged:
    (exit code, output).  Fails, printing the output, if it runs past
    ``timeout`` seconds; the ranks are stopped with it."""
    import os

    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             "--nproc_per_node", str(n), *args], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        fail(f"torchrun {' '.join(args[:3])} ran past {timeout:.0f} s:\n" + out[-8000:])
    return proc.returncode, out


def launched_routes(output: str, what: str = "train steps: ") -> list:
    """The distinct routes an engine under ``torchrun`` logged in
    ``output`` (``train steps: ...`` and ``frames: ...``: rank 0 logs at
    INFO, the other ranks from WARNING up)."""
    return sorted({line.split(what, 1)[1] for line in output.splitlines() if what in line})


def check_recorded(calls: dict, counted: dict) -> None:
    """Every launch counted on a path is a call ``engine_recorder``
    recorded there."""
    for path, got in counted.items():
        names = ("fused_render", "fused_shaded_mlp", "fused_shaded_mlp_bwd", *RAYS_FORMS,
                 "sample_pdf_cuda")
        seen = {n: sum(c["n"] for c in calls.get((path, n), {}).values())
                for n in (*names, "fused_render_bwd")}
        want = {**{n: got[n] for n in names}, "fused_render_bwd": got["render_bwd_points"]}
        if seen != want:
            fail(f"{path}: recorded calls {seen} are not the launches counted {got}")


@contextlib.contextmanager
def cli_recording(work, name: str, counters: dict):
    """Instruments ``mc_nerf_torch.main.main`` for a CLI phase and yields
    ``(cli, calls, builds, epochs, frames)``.  ``cli(path, run, mode)`` runs
    ``main([mode, "--config", work/config_<run>, ...])`` on the scene
    ``work/data/<name>`` with every count in ``counters`` set to 0 just
    before, and returns (its result, the launches counted, the engine).
    While it runs, the kernels' entry points are recorded by path and
    shape into ``calls`` (``engine_recorder``, each shape's last call
    kept: the trained field's, from a train path the tensors of the step
    graph's capture as its last replay left them (the profiled one of
    ``replayed_launches``, after the run); a first NeRF step's untrained
    field composites to the white background whatever its MLP computes,
    and no planted fault there moves K2's rays; K5 where its launch
    starts, its entry point being called inside fused_mlp.py's VJP), the
    engine's
    detection-cache builds are appended to ``builds``, and each training
    epoch's launches are appended to ``epochs`` as (path, stage,
    {kernel: launches}, {"p_flat": the sha256 of ``p_flat`` after the
    epoch, "occ": of the occupancy map it trained on}, the epoch's steps
    by how they ran: ``StageEpoch.counts``' growth over it).  After each
    ``Engine.train`` and ``Engine.demo`` on a path, its frame graphs are
    profiled (``replayed_frames``) into ``frames[path]``: {"launches":
    {wrapper: launches in the replays}, "graphs": each graph's, "routes":
    each renderer's ``FrameRender.counts``}.  Everything is restored on
    exit."""
    import mc_nerf_torch.models.nerf as nerf_module
    import mc_nerf_torch.ops.cuda.fused_mlp as mlp_module
    import mc_nerf_torch.ops.cuda.fused_render as render_module
    import mc_nerf_torch.ops.volume as volume_module
    import mc_nerf_torch.train.engine as engine_module
    from mc_nerf_torch.main import main as cli_main

    where, calls, epochs, frames = [None], {}, [], {}
    wrapped = {(nerf_module, "fused_render"): lambda a: f"{a[2].shape[0]} rays x {a[8]}",
               (nerf_module, "fused_shaded_mlp"): lambda a: f"{a[2].shape[0]} rays x {a[5]}",
               **{(nerf_module, n): shape for n, shape in RAYS_SHAPES.items()},
               (render_module, "fused_render_bwd"): lambda a: f"{a[3].shape[0]} rays x {a[9]}",
               (volume_module, "sample_pdf_cuda"): pdf_shape}
    originals = {k: getattr(*k) for k in wrapped}
    for (module, fn_name), shape_of in wrapped.items():
        setattr(module, fn_name, engine_recorder(originals[module, fn_name], fn_name, shape_of,
                                                 where, calls, last=True))
    shaded_bwd_launch = mlp_module._shaded_bwd_launch
    record_k5 = engine_recorder(lambda *a: None, "fused_shaded_mlp_bwd",
                                lambda a: f"{a[3].shape[0]} rays x {a[7]}", where, calls,
                                last=True)

    def k5_launch(*a):
        record_k5(*a[:9])           # not the workspace
        return shaded_bwd_launch(*a)

    mlp_module._shaded_bwd_launch = k5_launch
    engines, builds = [], []
    engine_train, engine_demo = engine_module.Engine.train, engine_module.Engine.demo
    build_cache = engine_module.build_calibration_cache

    def train(self, *a, **kw):
        engines.append(self)
        epoch_fn = self._epoch_fn

        def counted_epoch_fn(stage):
            fn = epoch_fn(stage)

            def run(*args):
                before = {n: c.launches for n, c in counters.items()}
                steps_before = dict(fn.counts)
                occ = digest(self._occ_map)
                out = fn(*args)
                epochs.append((where[0], stage, {n: c.launches - before[n]
                                                 for n, c in counters.items()},
                               {"p_flat": digest(self.state.p_flat), "occ": occ},
                               {k: v - steps_before[k] for k, v in fn.counts.items()}))
                return out
            return run

        self._epoch_fn = counted_epoch_fn
        out = engine_train(self, *a, **kw)
        profile_frames(self)
        return out

    def demo(self, *a, **kw):
        engines.append(self)
        out = engine_demo(self, *a, **kw)
        profile_frames(self)
        return out

    def profile_frames(eng):
        """The path's frame graphs, profiled while they live (``main()``
        closes the engine on its way out under a process group)."""
        if where[0] is not None:
            renders = list(eng._render_fns.values())
            total, graphs = replayed_frames(renders, where[0])
            frames[where[0]] = {"launches": total, "graphs": graphs,
                                "routes": [dict(r.counts) for r in renders]}

    def recorded_build(*a, **kw):
        builds.append(a)
        return build_cache(*a, **kw)

    engine_module.Engine.train, engine_module.Engine.demo = train, demo
    engine_module.build_calibration_cache = recorded_build

    def cli(path, run, mode):
        for c in counters.values():
            c.launches = 0
        where[0] = path
        out = cli_main([mode, "--config", str(work / f"config_{run}"), "--root_data",
                        str(work / "data"), "--data_name", name])
        torch.cuda.synchronize()
        where[0] = None
        return out, {n: c.launches for n, c in counters.items()}, engines[-1]

    try:
        yield cli, calls, builds, epochs, frames
    finally:
        for (module, fn_name), fn in originals.items():
            setattr(module, fn_name, fn)
        mlp_module._shaded_bwd_launch = shaded_bwd_launch
        engine_module.Engine.train, engine_module.Engine.demo = engine_train, engine_demo
        engine_module.build_calibration_cache = build_cache


def digest(t) -> str:
    """The sha256 of a tensor's bytes (None: "none")."""
    if t is None:
        return "none"
    return hashlib.sha256(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


def untimed(history: list) -> list:
    """``Engine.history`` without its times: each epoch's losses and
    scores."""
    timed = ("seconds", "rays_per_s", "capture_seconds", "ckpt_seconds")
    return [{k: v for k, v in h.items() if k not in timed} for h in history]


def host_steps(counts: dict) -> int:
    """The steps of a ``StageEpoch`` (its ``counts``) whose launches the
    kernels' wrappers counted: the warm-up's, the capture's and the
    loop's.  A replay runs the captured launches again without a wrapper."""
    return counts["warmup"] + counts["captured"] + counts["looped"]


def csrc_kernel_names() -> list:
    """The names of the ``__global__`` kernels in ``mc_nerf_torch/csrc/``."""
    import pathlib
    import re

    csrc = pathlib.Path(__file__).resolve().parent / "mc_nerf_torch" / "csrc"
    sources = [f.read_text() for f in csrc.glob("*.cu*")]
    return sorted({m for text in sources for m in re.findall(
        r"__global__[^;{]*?\b(\w+_kernel)\s*\(", text)})


# the kernel of csrc/ that a wrapper launches once a call and that no
# other wrapper of its train path launches (the two fine modes never share
# a path): what the profiler counts for the wrapper in a step graph's replay
SIGNATURE = {"fused_render": "composite_fwd_kernel", "render_bwd_points": "mlp_points_kernel",
             "render_bwd_weights": "weight_grad_kernel", "fused_shaded_mlp": "shaded_fwd_kernel",
             "fused_shaded_mlp_bwd": "mlp_points_kernel", "sample_pdf_cuda": "inverse_cdf_kernel"}


def replayed_launches(eng, path: str, wrappers, per_step: dict, names) -> tuple:
    """The launches that ``eng``'s step graphs made on the card in its
    training run: each stage's graph replayed after the run under the
    profiler (``profile_fullest``; CUPTI reports a graph's kernel nodes one by one),
    its kernels of ``csrc/`` counted, times the replays the run made
    (``StageEpoch.counts``).  The train state a replay moves is put back
    after each (the generator moves on: the engine reseeds it every
    epoch).  The stages go in the order of their captures, so the
    tensors a recorder keeps of the last one hold what that graph's own
    replay gave its kernels.  Fails unless each of ``wrappers`` launches
    its ``SIGNATURE`` kernel ``per_step[stage]`` times a replay.  Returns
    ({wrapper: launches in the run's replays}, {stage: {kernel of csrc/:
    launches a replay}})."""
    from mc_nerf_torch.tools.profile_step import count_named, profile_fullest

    if len({SIGNATURE[w] for w in wrappers}) != len(wrappers):
        fail(f"{path}: {wrappers} share a signature kernel")
    st = eng.state
    live = [st.p_flat, st.step, *(t for o in st.opt_states for t in (o.mu, o.nu, o.count))]
    total, by_stage = dict.fromkeys(wrappers, 0), {}
    for stage, ep in sorted(eng._epoch_fns.items()):
        if ep._cuda_graph is None:
            fail(f"{path}: the stage-{stage} step was not captured")
        saved = [t.clone() for t in live]

        def put_back():
            with torch.no_grad():
                for t, v in zip(live, saved):
                    t.copy_(v)

        rows = profile_fullest(ep._cuda_graph.replay, after=put_back)
        found = by_stage[stage] = count_named(rows, names)
        got = {w: found.get(SIGNATURE[w], 0) for w in wrappers}
        if got != dict.fromkeys(wrappers, per_step[stage]):
            fail(f"{path}: a replay of the stage-{stage} step graph launches {got} "
                 f"({found}), not {per_step[stage]} each")
        for w in wrappers:
            total[w] += got[w] * ep.counts["replayed"]
    print(f"{path}: the step graphs' kernels of csrc/ a replay, by stage (profiled): "
          f"{by_stage}; in the run's replays: {total}", flush=True)
    return total, by_stage


def engine_recorder(fn, name: str, shape_of, where: list, calls: dict, last: bool = False):
    """``fn`` (a kernel's entry point, called with positional arguments)
    that, while ``where[0]`` names a path, counts its calls there by
    ``shape_of(args)`` and keeps detached copies of the first call's
    arguments at each shape in ``calls[(path, name)][shape]``; with
    ``last``, the last call's (detached, not copied: each call's
    arguments are tensors of their own, which the next call replaces).
    A call while a CUDA graph is being captured is counted (its wrapper
    counts the launch once); with ``last`` it keeps its arguments as they
    are, tensors of the graph's pool that every replay rewrites and that
    this reference keeps from being reused, so they hold what the kernel
    was given in the graph's last replay (a replay calls no
    entry point: a train path's step graph is only seen at its capture);
    without ``last`` it keeps none (they hold no values until a replay),
    and the first call kept is the first eager step's, a warm-up's."""
    def copy_arg(a, copy=True):
        if isinstance(a, torch.Tensor):
            return a.detach().clone() if copy else a.detach()
        if hasattr(a, "_fields"):
            return type(a)(*(copy_arg(x, copy) for x in a))
        return type(a)(copy_arg(x, copy) for x in a) if isinstance(a, (list, tuple)) else a

    def call(*args):
        if where[0] is not None:
            seen = calls.setdefault((where[0], name), {})
            rec = seen.setdefault(shape_of(args), {"n": 0})
            if last or ("args" not in rec and not torch.cuda.is_current_stream_capturing()):
                rec["args"] = copy_arg(args, not last)
            rec["n"] += 1
        return fn(*args)
    return call


@contextlib.contextmanager
def recording_frames(where: list, calls: dict):
    """The eval kernels' entry points in ``models/nerf.py`` (K1, K2, K4:
    ``RAYS_FORMS``, their rays and depths recorded) and ``sample_pdf_cuda``
    in ``ops/volume.py`` recorded into ``calls`` while ``where[0]`` names
    a path (``engine_recorder``, each shape's last call); restored on
    exit."""
    import mc_nerf_torch.models.nerf as nerf_module
    import mc_nerf_torch.ops.volume as volume_module

    wrapped = {**{(nerf_module, n): shape for n, shape in RAYS_SHAPES.items()},
               (volume_module, "sample_pdf_cuda"): pdf_shape}
    originals = {k: getattr(*k) for k in wrapped}
    for (module, name), shape_of in wrapped.items():
        setattr(module, name, engine_recorder(originals[module, name], name, shape_of, where,
                                              calls, last=True))
    try:
        yield
    finally:
        for (module, name), fn in originals.items():
            setattr(module, name, fn)


def pdf_shape(a) -> str:
    """A ``sample_pdf_cuda`` call's shape, as ``engine_recorder`` keys it."""
    return f"{a[1].shape[0]} rays x {a[1].shape[1]} to {a[2]}"


def path_kernel_holds(calls: dict, nc, plants: bool = False, failures: list = None) -> dict:
    """Each kernel on each recorded path (``calls``, as ``engine_recorder``
    keeps them), held on the inputs the path gave it: at every shape it
    was called at, the kernel against its plain version (``MLP_TOL``,
    ``RENDER_TOL``, ``SHADED_TOL``, ``BWD_TOL``, ``SHADED_BWD_TOL``,
    ``SAMPLE_PDF_TOL``; with ``plants``, the planted faults too, each at 2x
    a tolerance or more).  An eval chunk of ``fused_render`` (no noise) is
    held again with its depths spread (``EVAL_SPREAD``).  A rays entry
    point's call (``RAYS_FORMS``) is that kernel on the recorded rays and
    depths, held first to its feat entry point on the oracle's features of
    the same points (``feat_form``), bit for bit, then as the feat entry
    point is.  Returns {(path, kernel): {shape: {"launches": the calls
    recorded, "max_abs_err"}}}."""
    from mc_nerf_torch.ops.cuda.fused_mlp import (
        fused_mlp_apply, fused_shaded_mlp, fused_shaded_mlp_bwd, fused_shaded_mlp_bwd_plain,
        fused_shaded_mlp_plain, mlp_plain)
    from mc_nerf_torch.ops.cuda.fused_render import (
        fused_render, fused_render_bwd, fused_render_bwd_plain)
    from mc_nerf_torch.tools.bwd_check import (
        bwd_errs, mixed_in_tiles, pair_swapped, planted_errs, planted_errs_shaded)

    out = {}
    gc.collect()
    rays_fns = {f.__name__: f for f in rays_wrappers()}
    feat_fns = {"fused_mlp_apply": fused_mlp_apply, "fused_shaded_mlp": fused_shaded_mlp,
                "fused_render": lambda *a: fused_render(*a)[0]}
    for (path, name), shapes in calls.items():
        for shape, rec in shapes.items():
            a, n, label = rec["args"], rec["n"], f"{name} on the {path} inputs ({shape})"
            planted = {}
            call = None          # the rays route's kernel on the points of ``a``
            base = RAYS_FORMS.get(name, name)
            if name in RAYS_FORMS:
                call, a = functools.partial(rays_fns[name], *a), feat_form(name, a)
                with torch.no_grad():
                    same = torch.equal(call(), feat_fns[base](*a))
                print(f"{label}: the rays route equals {base} on the encode's features, bit "
                      f"for bit: {same}", flush=True)
                if not same:
                    (failures.append if failures is not None else fail)(
                        f"{label}: the rays route strays from {base} on the same points")
            if base == "fused_mlp_apply":
                pk, feat, depth, skips = a
                ker = call() if call else fused_mlp_apply(*a)
                torch.cuda.synchronize()
                ref = mlp_plain(*a)
                if plants:
                    planted = {
                        "points mixed in a tile": mlp_errs(mixed_in_tiles(ker), ref),
                        "a pair's tiles swapped": mlp_errs(pair_swapped(ker), ref),
                        "skip input dropped": mlp_errs(
                            mlp_plain(drop_skip(pk, skips), feat, depth, skips), ref),
                        "first layer lost": mlp_errs(mlp_plain(drop_first(pk), feat, depth, skips),
                                                     ref)}
                hold(label, mlp_errs(ker, ref), MLP_TOL, planted, 2.0, failures)
                errs = {name: float((ker - ref).abs().max())}
            elif base == "fused_render":
                with torch.no_grad():
                    e = hold_render(label, a, RENDER_TOL, plants, failures,
                                    ("scan one sample late",) if a[4] is None else (),
                                    (call(), None) if call else None)
                    if plants and a[4] is None:
                        # the composite's scan on the recorded points: the
                        # feat route (on the rays route the points would
                        # move with the depths), the same composite kernel
                        z, k = a[3], EVAL_SPREAD
                        hold_render(f"{label}, depths spread {k}x",
                                    (*a[:3], z[:, :1] + (z - z[:, :1]) * k, *a[4:]),
                                    {**RENDER_TOL, "depth": DEPTH_ATOL * k}, plants, failures)
                errs = {name: max(e.values())}
            elif base == "fused_shaded_mlp":
                pk, feat, basis16, depth, skips, s, nb = a
                with torch.no_grad():
                    k_out = call() if call else fused_shaded_mlp(*a)
                    torch.cuda.synchronize()
                    p_out = fused_shaded_mlp_plain(*a)
                    if plants:
                        planted = {
                            "points mixed in a tile": shaded_errs(mixed_in_tiles(k_out), p_out),
                            "a pair's tiles swapped": shaded_errs(pair_swapped(k_out), p_out),
                            "skip input dropped": shaded_errs(fused_shaded_mlp_plain(
                                drop_skip(pk, skips), *a[1:]), p_out),
                            "another ray's basis": shaded_errs(fused_shaded_mlp_plain(
                                pk, feat, basis16.roll(basis16.shape[0] // 2, 0), *a[3:]),
                                p_out)}
                hold(label, shaded_errs(k_out, p_out), SHADED_TOL, planted, 2.0, failures)
                errs = {name: float((k_out - p_out).abs().max())}
            elif name == "fused_shaded_mlp_bwd":
                depth = a[5]
                k = fused_shaded_mlp_bwd(*a)
                torch.cuda.synchronize()
                ref = fused_shaded_mlp_bwd_plain(*a)
                if plants:
                    planted = {**planted_errs_shaded(a, ref),
                               **masked_below(fused_shaded_mlp_bwd_plain, a, ref)}
                hold(label + " (relative L2)", bwd_errs(k, ref),
                     SHADED_BWD_TOL["coarse" if depth == nc.coarse_depth else "fine"], planted,
                     2.0, failures)
                errs = {name: max_abs(k, ref)}
                del k, ref
            elif name == "sample_pdf_cuda":
                errs = {name: hold_sample_pdf(label, a, plants, failures)}
            else:
                depth = a[7]
                k = fused_render_bwd(*a)
                torch.cuda.synchronize()
                ref = fused_render_bwd_plain(*a)
                if plants:
                    planted = planted_errs(a, ref)
                hold(label + " (relative L2)", bwd_errs(k, ref),
                     BWD_TOL["coarse" if depth == nc.coarse_depth else "fine"], planted, 2.0,
                     failures, CLI_WEAK_PLANTS)
                errs = {kn: max(float((x - y).abs().max()) for x, y in pairs)
                        for kn, pairs in (("render_bwd_points", zip(k[2:], ref[2:])),
                                          ("render_bwd_weights", zip([*k[0], *k[1]],
                                                                     [*ref[0], *ref[1]])))}
            for kn, e in errs.items():
                out.setdefault((path, kn), {})[shape] = {"launches": n, "max_abs_err": e}
    return out


def kernel_entries(checked: dict) -> list:
    """The kernels line's entries of ``path_kernel_holds``' result: one a
    kernel and path, its calls recorded over the shapes and the largest
    error."""
    return [{"name": name, "path": path,
             "launches_counted": sum(x["launches"] for x in shapes.values()),
             "shapes": sorted(shapes),
             "max_abs_err": max(x["max_abs_err"] for x in shapes.values())}
            for (path, name), shapes in checked.items()]


def shaded_errs(out, ref) -> dict:
    if not (bool(torch.isfinite(out).all()) and float(out[:, 4:].abs().max()) == 0.0):
        fail("fused_shaded_mlp output is not finite or its lanes 4..7 are not 0")
    return {"sigma rel": float((out[:, 0] - ref[:, 0]).abs().max() / ref[:, 0].abs().max()),
            "rgb": float((out[:, 1:4] - ref[:, 1:4]).abs().max())}


def max_abs(a, b) -> float:
    """The largest abs difference over a backward's outputs."""
    flat = lambda r: [*r[0], *r[1], *r[2:]]
    return max(float((x - y).abs().max()) for x, y in zip(flat(a), flat(b)))


def demo_phase(dev, smi: str, fine_mode: str) -> dict:
    """The demo (``train.engine.demo``) at ``Config()``'s widths in
    ``fine_mode`` over two 800x800 views of the seeded scene
    (``tools/scene.scene_params``; importance: culled by a map refreshed
    from it; grid: 128 uniform coarse samples, 26 bins x 5 fine samples a
    ray, no map), through a renderer whose first frame captures the frame
    as a CUDA graph: each eval kernel of the mode (``FRAME_LAUNCHES``)
    counted by its wrapper from 0 just before (a chunk of warm-up and the
    capture) and by the profiler in the graph's replays
    (``replayed_frames``), every one launched; the scores finite; a frame
    of the second view finite.  Importance: that frame again through the
    chunk loop with ``sample_pdf``'s plain body, against the kernel's.
    Both: one chunk of that view through the bf16 plain route against the
    kernel route (``SLICE_ATOL``), the fine MLP's skip input dropped on the
    plain route as the plant."""
    import mc_nerf_torch.models.nerf as nerf_module
    from mc_nerf_torch.cameras.rays import pixel_grid, rays_for_pixels
    from mc_nerf_torch.config import Config
    from mc_nerf_torch.data.blender import SplitData
    from mc_nerf_torch.models.nerf import pack_eval_params, render_rays_eval
    from mc_nerf_torch.ops.cuda.sample_pdf import sample_pdf_cuda
    from mc_nerf_torch.ops.volume import sample_pdf_plain
    from mc_nerf_torch.tools.scene import LEGO_FOV, orbit_views, scene_params
    from mc_nerf_torch.train.engine import demo, refresh_occupancy
    from mc_nerf_torch.train.steps import make_render_fn

    cfg = Config()
    cfg = cfg.replace(eval=dataclasses.replace(cfg.eval, fine_mode=fine_mode))
    nc, h, importance = cfg.nerf, 800, fine_mode == "importance"
    path, mode = ("demo", "importance culled") if importance else ("demo_grid", "grid")
    params = scene_params(nc, SEED, device=dev)
    poses, K = orbit_views((0.3, 2.2), h, h)   # radius 4, looking at the origin
    gt = np.full((2, h, h, 3), 255, np.uint8)   # a white target: the scores need only be finite
    split = SplitData(gt, poses, np.stack([K, K]), np.full(2, LEGO_FOV, np.float32), h, h,
                      ["view0", "view1"])
    occ = refresh_occupancy(params, cfg, dev, 0) if importance else None
    wrappers = {f.__name__: f for f in (*rays_wrappers(), sample_pdf_cuda)
                if f.__name__ in FRAME_LAUNCHES[mode]}
    render = make_render_fn(cfg, h, h, device=dev)
    for c in wrappers.values():
        c.launches = 0
    result = demo(params, split, cfg, device=dev, cull=True, render=render)
    torch.cuda.synchronize()
    counted = {k: c.launches for k, c in wrappers.items()}
    replays, _ = replayed_frames([render], path)
    launches = {k: replays[k] for k in wrappers}
    print(f"{path}: {result} ({smi}); launches in its frame graph's replays {launches}, by the "
          f"wrappers (warm-up and capture) {counted}", flush=True)
    if not all(n > 0 for n in (*launches.values(), *counted.values())):
        fail(f"{path}: a kernel was not launched: {launches}, {counted}")
    if not (result["count"] == 2 and math.isfinite(result["psnr"])
            and math.isfinite(result["ssim"])):
        fail(f"{path}: the result is not finite: {result}")
    rgb, depth, opac = render(params, poses[1], K, occ)
    if tuple(rgb.shape) != (h, h, 3) or not bool(torch.isfinite(rgb).all()
                                                 & torch.isfinite(depth).all()):
        fail(f"{path}: a frame is not finite or has the wrong shape")
    print(f"{path} frame: rgb {float(rgb.min()):.3f}..{float(rgb.max()):.3f} (std "
          f"{float(rgb.std()):.4f}), opacity mean {float(opac.mean()):.4f}, depth std "
          f"{float(depth.std()):.4f}" + (f"; {float(occ.float().mean()):.4f} of the map's cells "
                                          "occupied" if importance else ""), flush=True)
    slice_tol = {"max rgb/opacity": SLICE_ATOL, "max depth/(far-near)": SLICE_ATOL,
                 "mean rgb": SLICE_MEAN_ATOL}

    def gaps(a, b):
        return {"max rgb/opacity": max(float((a[i] - b[i]).abs().max()) for i in (0, 2)),
                "max depth/(far-near)": float((a[1] - b[1]).abs().max()) / (nc.far - nc.near),
                "mean rgb": float((a[0] - b[0]).abs().mean())}

    if importance:
        # the chunk loop both times, the second's draws through
        # sample_pdf_plain: they land apart by their sums' rounding, so the
        # bound is the chunk's below (two routes whose samples land apart)
        loop = make_render_fn(cfg, h, h, device=dev, graph=False)
        kernel = loop(params, poses[1], K, occ)
        drawn = nerf_module.sample_pdf
        nerf_module.sample_pdf = sample_pdf_plain
        try:
            plain = loop(params, poses[1], K, occ)
        finally:
            nerf_module.sample_pdf = drawn
        hold(f"{path}: an 800x800 frame with sample_pdf's kernel vs with its plain body",
             gaps(kernel, plain), slice_tol, {})

    # one chunk of the frame through the plain route on the card
    chunk = cfg.eval.rays_per_chunk
    pix = pixel_grid(h, h, device=dev)[h * h // 2 - chunk // 2: h * h // 2 + chunk // 2]
    rd, ro = rays_for_pixels(pix, torch.as_tensor(poses[1], device=dev),
                             torch.as_tensor(K, device=dev))
    kw = ({"importance_samples": cfg.eval.importance_samples, "occ": occ} if importance
          else {"fine_mode": "grid"})
    ker = render_rays_eval(params, rd, ro, nc, torch.bfloat16, packed=pack_eval_params(params, nc),
                           **kw)
    broken = copy.deepcopy(params)
    with torch.no_grad():
        broken.fine.trunk[nc.fine_skips[0]].weight[:, :nc.embed_dim] = 0
    hold(f"{path}: a chunk, kernel route vs bf16 plain route",
         gaps(ker, render_rays_eval(params, rd, ro, nc, torch.bfloat16, **kw)), slice_tol,
         {"fine skip input dropped": gaps(ker, render_rays_eval(broken, rd, ro, nc,
                                                                torch.bfloat16, **kw))})
    return {"result": result, "launches": launches, "launches_counted": counted}


def fused_mlp_vjp_hold(dev) -> list:
    """K6, the backward of the differentiable ``fused_mlp`` (K1 its
    forward), through autograd at ``Config()``'s widths: the coarse full
    pack over a train batch's rays x 48 points and the fine pack over rays
    x 32 (rays from (0, 0, -4) in seeded directions, sorted depths in [1,
    8]), under an MSE of the packed output (``tools/bwd_check.mlp_cotangent``).
    Each pack launches K1 and K6 once (counted from 0 before) and its
    gradients are finite; the call autograd made to K6 is recorded
    (arguments and outputs) and held against ``fused_mlp_bwd_plain`` on its
    arguments, with the planted faults of ``tools/bwd_check.planted_errs_mlp``
    and the wrong mask.  Returns the kernels line's entries."""
    import mc_nerf_torch.ops.cuda.fused_mlp as fm
    from mc_nerf_torch.config import Config
    from mc_nerf_torch.tools.bwd_check import bwd_errs, mlp_cotangent, planted_errs_mlp
    from mc_nerf_torch.tools.scene import scene_params

    cfg = Config()
    nc, rays = cfg.nerf, cfg.train.rays_per_batch
    params = scene_params(nc, SEED, device=dev)
    rng = np.random.default_rng(SEED)
    calls, real = [], fm._mlp_bwd_launch

    def recorded(*args):
        out = real(*args)
        calls.append((tuple(args[:6]), tuple(out)))
        return out

    entries = []
    for label, mlp, depth, skips, s in (
            ("coarse", params.coarse, nc.coarse_depth, nc.coarse_skips, nc.occ_coarse_samples),
            ("fine", params.fine, nc.fine_depth, nc.fine_skips, 32)):
        d = torch.as_tensor(rng.normal(size=(rays, 3)), dtype=torch.float32, device=dev)
        z = torch.sort(torch.as_tensor(rng.uniform(1.0, 8.0, (rays, s)), dtype=torch.float32,
                                       device=dev), dim=-1).values
        d = d / d.norm(dim=-1, keepdim=True)
        xyz = torch.tensor([0.0, 0.0, -4.0], device=dev) + d[:, None] * z[..., None]
        feat = fm.encode_kernel_order(xyz.reshape(-1, 3), nc.emb_freqs_xyz)
        f = feat.detach().clone().requires_grad_()
        fm.fused_mlp_apply.launches = fm.fused_mlp_bwd.launches = 0
        calls.clear()
        fm._mlp_bwd_launch = recorded
        try:
            out = fm.fused_mlp(fm.pack_mlp_params(mlp, nc.emb_freqs_xyz, skips,
                                                  dtype=torch.float32), f, depth, skips)
            out.backward(mlp_cotangent(out))
        finally:
            fm._mlp_bwd_launch = real
        torch.cuda.synchronize()
        launches = {"fused_mlp_apply": fm.fused_mlp_apply.launches,
                    "fused_mlp_bwd": fm.fused_mlp_bwd.launches}
        grads = [f.grad, *(q.grad for q in mlp.parameters())]
        mlp.zero_grad(set_to_none=True)
        print(f"fused_mlp VJP {label} P={feat.shape[0]}: launches {launches}", flush=True)
        if launches != {"fused_mlp_apply": 1, "fused_mlp_bwd": 1} or len(calls) != 1:
            fail(f"fused_mlp VJP {label}: its forward and backward should launch once each: "
                 f"{launches}, {len(calls)} backward calls recorded")
        if not all(bool(torch.isfinite(g.float()).all()) for g in grads):
            fail(f"fused_mlp VJP {label}: gradients are not finite")
        (args, k), = calls
        ref = fm.fused_mlp_bwd_plain(*args)
        hold(f"fused_mlp backward {label} P={feat.shape[0]}, the call autograd made "
             "(relative L2)", bwd_errs(k, ref), MLP_BWD_TOL[label],
             {**planted_errs_mlp(args, ref), **masked_below(fm.fused_mlp_bwd_plain, args, ref)})
        entries.append({"name": "fused_mlp_bwd", "path": f"fused_mlp_vjp {label}",
                        "launches_counted": launches["fused_mlp_bwd"],
                        "shapes": [f"{feat.shape[0]} points"], "max_abs_err": max_abs(k, ref)})
    return entries


# ---- the hash-grid field (ngp_phase)

# the benchmark's train.ngp cell: its configuration (the published widths)
# and traffic (start step, schedule, image size)
NGP_CONFIG = "portbench/configs/instant-ngp-base.json"
NGP_TRAFFIC = "portbench/traffic/global_optim_ngp.json"
NGP_IMAGES = 8
NGP_STEPS = 10
# The encode's kernels vs models/hashgrid.py::hash_encode_plain, the
# tolerances of tests/test_torch_ngp_gpu.py: the features max |kernel -
# plain| over max |plain| at 2^-8 (the kernel writes bf16, 2^-9 of a
# feature); the table's gradient and d/dx relative L2 at 2e-6 (fp32 sums,
# the atomics, in another order; measured 1.4e-7 and under)
NGP_TOL = {"feat": 2.0 ** -8, "gtable": 2e-6, "gx": 2e-6}
# the encode's kernels, as the profiler names them
NGP_KERNELS = {"fwd": "hash_encode_fwd_kernel", "bwd": "hash_encode_bwd_kernel"}
# a frame whose rgb spreads less is flat: a field that lost its table or
# its density renders one colour (~0); the seeded field's 800x800 frame
# reads 0.045 on an H100
NGP_FLAT_STD = 0.01


def ngp_plain(rec: dict, gout=None, primes=None, x=None, table=None, gate=None) -> tuple:
    """``hash_encode_plain``'s (features, the table's gradient, the points')
    on a recorded call ``rec`` for the cotangent ``gout`` (the features
    alone without one); ``primes``, ``x``, ``table`` or ``gate`` plant
    another spatial hash or input."""
    from mc_nerf_torch.models import hashgrid as hg

    x = rec["x"] if x is None else x
    table = rec["table"] if table is None else table
    gate = rec["gate"] if gate is None else gate
    saved = hg.PRIMES
    hg.PRIMES = saved if primes is None else primes
    try:
        with torch.enable_grad():
            xg = x.clone().requires_grad_(gout is not None)
            tg = table.clone().requires_grad_(gout is not None)
            feat = hg.hash_encode_plain(xg, tg, gate, rec["grid"], rec["lo"], rec["hi"])
            if gout is None:
                return (feat.detach(),)
            gx, gt = torch.autograd.grad(feat, (xg, tg), gout.float())
    finally:
        hg.PRIMES = saved
    return feat.detach(), gt, gx


def ngp_gaps(got: tuple, ref: tuple) -> dict:
    """The errors ``NGP_TOL`` holds, of the outputs ``got`` has (a backward
    without the points' gradient has no ``gx``)."""
    rel = lambda a, b: float(torch.linalg.vector_norm((a - b).double())
                             / torch.linalg.vector_norm(b.double()))
    out = {"feat": float((got[0].float() - ref[0]).abs().max() / ref[0].abs().max())}
    if len(got) > 1:
        out["gtable"] = rel(got[1], ref[1])
        if got[2] is not None:
            out["gx"] = rel(got[2], ref[2])
    return out


def hold_ngp(path: str, rec: dict) -> dict:
    """The encode's kernels against the plain body on a path's recorded call
    ``rec`` (the backward's where the path has one, else the forward's),
    with planted faults at 2x a tolerance or more.  Returns {"fwd" and,
    with a backward, "bwd": the errors of that kernel's outputs}."""
    from mc_nerf_torch.ops.cuda import hashgrid as hk

    x, table, gate, grid, lo, hi = (rec[k] for k in ("x", "table", "gate", "grid", "lo", "hi"))
    gout, need_x = rec.get("gout"), rec.get("need_x", False)
    got = (hk.encode_fwd(x, table, gate, grid, lo, hi),)
    if gout is not None:
        got += tuple(hk.encode_bwd(x, table, gate, grid, lo, hi, gout, need_x))
    torch.cuda.synchronize()
    ref = ngp_plain(rec, gout)
    errs = ngp_gaps(got, ref)
    gate0 = torch.ones(grid.levels, device=x.device) if gate is None else gate.clone()
    gate0[0] = 0.0
    fp8 = lambda t: t.to(torch.float8_e4m3fn).float()
    plants = {"hash primes swapped": ngp_plain(rec, gout, primes=(1, 805459861, 2654435761)),
              "level 0 gated off": ngp_plain(rec, gout, gate=gate0),
              "table in fp8": ngp_plain(rec, gout, table=fp8(table)),
              "a point's neighbour's cell": ngp_plain(rec, gout, x=torch.roll(x, 1, 0))}
    if gout is not None:
        plants["cotangent in fp8"] = ngp_plain(rec, fp8(gout.float() * 2 ** 20) / 2 ** 20)
    if gout is not None and not need_x:     # the kernel gave no d/dx: none compared
        plants = {n: (*r[:2], None) for n, r in plants.items()}
    hold(f"hash encode {path} P={x.shape[0]}", errs, {k: NGP_TOL[k] for k in errs},
         {n: ngp_gaps(r, ref) for n, r in plants.items()}, 2.0)
    return {kind: {k: v for k, v in errs.items() if (k == "feat") == (kind == "fwd")}
            for kind in ("fwd", "bwd")[:1 if gout is None else 2]}


def ngp_phase(dev, smi: str) -> dict:
    """The hash-grid field (``nerf.field: hashgrid``) at the train.ngp cell's
    configuration, on its seeded inputs (``NGP_IMAGES`` of its 800x800
    images), through the port's entry points: the occupancy refresh from
    the field, the GLOBAL_OPTIM and FINE_TUNE step graphs
    (``make_stage_epoch``, an epoch of ``NGP_STEPS`` steps on each route)
    and the 800x800 frame graph (``make_render_fn``, against its chunk
    loop: the same bits, not flat).  The encode's launches by path:
    ``ops/cuda/hashgrid.py::launches`` zeroed before each, the wrapper's
    counts (one forward and one backward a loop step, the warm-ups' and the
    capture's in a graph epoch, one forward a frame chunk) and the
    profiler's in a replay of each graph (``profile_fullest``).  The first eager call of each
    path is recorded (a capture's are not: its tensors are not computed
    yet), and the kernels are held against the plain body on it
    (``hold_ngp``).  Returns the paths' launches and metrics, and the
    ``kernels`` entries."""
    from mc_nerf_torch.models.hashgrid import hash_grid
    from mc_nerf_torch.ops.cuda import hashgrid as hk
    from mc_nerf_torch.tools.profile_step import count_named, profile_fullest
    from mc_nerf_torch.train.engine import refresh_occupancy
    from mc_nerf_torch.train.optim import build_optimizers
    from mc_nerf_torch.train.steps import WARMUP_STEPS, make_render_fn, make_stage_epoch
    from portbench.program import port_config, train_setup
    from portbench.scene import orbit_views
    from portbench.scene_ngp import make_scene

    with open(NGP_CONFIG) as f:
        conf = json.load(f)
    with open(NGP_TRAFFIC) as f:
        tr = json.load(f)
    cfg = port_config(conf)
    sc = dict(tr["scene"], n_images=NGP_IMAGES)
    h, w = sc["img_h"], sc["img_w"]
    scene = make_scene(conf["nerf"], sc, SEED, dev)
    state, data, _ = train_setup(scene.params, scene.images_u8, scene.detections, cfg, tr, dev)
    txs, _ = build_optimizers(cfg, state.params, state.p_flat, tr["lr_steps_per_epoch"])
    field = state.params.nerf
    print(f"ngp: {hash_grid(cfg.nerf).entries} table rows, "
          f"{state.p_flat.numel()} parameters in the flat buffer", flush=True)

    calls, where = {}, [None]
    real = {"fwd": hk.encode_fwd, "bwd": hk.encode_bwd}

    def recorder(kind):
        def call(x, table, gate, grid, lo, hi, *rest):
            rec = calls.setdefault(where[0], {}) if where[0] else None
            capturing = torch.cuda.is_current_stream_capturing()
            if rec is not None and kind not in rec and not capturing:
                keep = lambda t: None if t is None else t.detach().clone()
                rec[kind] = {"x": keep(x), "table": keep(table), "gate": keep(gate),
                             "grid": grid, "lo": lo, "hi": hi}
                if kind == "bwd":
                    rec[kind]["gout"] = keep(rest[0].to(torch.bfloat16))
                    rec[kind]["need_x"] = rest[1] if len(rest) > 1 else True
            return real[kind](x, table, gate, grid, lo, hi, *rest)
        return call

    def counting(fn, path=None):
        """``fn()``'s result and the encode's launches the wrapper counted
        in it; with ``path``, its first eager calls recorded there."""
        where[0] = path
        hk.launches.update(fwd=0, bwd=0)
        out = fn()
        torch.cuda.synchronize()
        where[0] = None
        return out, dict(hk.launches)

    def replayed(replay) -> dict:
        found = count_named(profile_fullest(replay), list(NGP_KERNELS.values()))
        return {k: found.get(n, 0) for k, n in NGP_KERNELS.items()}

    hk.encode_fwd, hk.encode_bwd = recorder("fwd"), recorder("bwd")
    try:
        paths = {}
        occ, got = counting(lambda: refresh_occupancy(field, cfg, dev, 0), "ngp_refresh")
        data = data._replace(occ=occ)
        print(f"ngp_refresh: the encode's launches (counted) {got}", flush=True)
        if not (got["fwd"] > 0 and got["bwd"] == 0):
            fail(f"ngp_refresh: the encode's launches {got}")
        paths["ngp_refresh"] = {"launches": {"loop": got}}
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for stage, path in ((1, "ngp_train"), (2, "ngp_fine_tune")):
            ep = make_stage_epoch(cfg, stage, txs[stage], h, w, tr["total_steps"], NGP_STEPS,
                                  graph=True)
            m, in_graph = counting(lambda: ep(state, data, gen), path)
            loop = make_stage_epoch(cfg, stage, txs[stage], h, w, tr["total_steps"], NGP_STEPS,
                                    graph=False)
            got = {"graph": in_graph, "replay": replayed(ep._cuda_graph.replay),
                   "loop": counting(lambda: loop(state, data, gen))[1]}
            want = {"graph": dict.fromkeys(NGP_KERNELS, WARMUP_STEPS + 1),
                    "replay": dict.fromkeys(NGP_KERNELS, 1),
                    "loop": dict.fromkeys(NGP_KERNELS, NGP_STEPS)}
            metrics = {k: float(v) for k, v in m.items()}
            print(f"{path}: the encode's launches, a graph epoch of {NGP_STEPS} steps (its "
                  f"warm-up and capture, counted) {got['graph']}, a replay (profiled) "
                  f"{got['replay']}, a loop epoch (counted) {got['loop']}; metrics {metrics}",
                  flush=True)
            if got != want:
                fail(f"{path}: the encode's launches {got}, wanted {want}")
            if not all(math.isfinite(v) for v in metrics.values()):
                fail(f"{path}: metrics not finite: {metrics}")
            paths[path] = {"launches": got, "metrics": metrics}
            ep.release()
        poses, K = orbit_views(NGP_IMAGES, h, w)
        pose = torch.as_tensor(poses[3], dtype=torch.float32, device=dev)
        K = torch.as_tensor(K, dtype=torch.float32, device=dev)
        render = make_render_fn(cfg, h, w, device=dev)
        loop = make_render_fn(cfg, h, w, device=dev, graph=False)
        a, in_graph = counting(lambda: render(field, pose, K, data.occ), "ngp_frame")
        b, in_loop = counting(lambda: loop(field, pose, K, data.occ))
        (g, _, _), = render._graphs.values()
        n = render.n_chunks
        got = {"graph": in_graph, "replay": replayed(g.replay), "loop": in_loop}
        want = {"graph": {"fwd": 1 + n, "bwd": 0}, "replay": {"fwd": n, "bwd": 0},
                "loop": {"fwd": n, "bwd": 0}}
        same = all(torch.equal(u, v) for u, v in zip(a, b))
        rgb_std = float(a[0].float().std())
        print(f"ngp_frame {h}x{w}: the encode's launches, the first frame (a chunk's warm-up "
              f"and the capture, counted) {got['graph']}, a replay (profiled) {got['replay']}, "
              f"the loop (counted) {got['loop']}, over {n} chunks; graph and loop the same "
              f"bits: {same}; rgb std {rgb_std:.4f} ({smi})", flush=True)
        if got != want:
            fail(f"ngp_frame: the encode's launches {got}, wanted {want}")
        if not (same and rgb_std > NGP_FLAT_STD):
            fail(f"ngp_frame: the frame graph and its loop differ ({not same}) or the frame is "
                 f"flat (rgb std {rgb_std})")
        paths["ngp_frame"] = {"launches": got, "chunks": n, "rgb_std": rgb_std}
        render.release()
    finally:
        hk.encode_fwd, hk.encode_bwd = real["fwd"], real["bwd"]
    kernels = []
    for path, rec in calls.items():
        for kind, errs in hold_ngp(path, rec.get("bwd", rec["fwd"])).items():
            kernels.append({"name": NGP_KERNELS[kind], "path": path,
                            **{f"launches_{k}": v[kind]
                               for k, v in paths[path]["launches"].items()},
                            "max_err": errs})
    wanted = {("ngp_refresh", "hash_encode_fwd_kernel"), ("ngp_frame", "hash_encode_fwd_kernel"),
              *((p, k) for p in ("ngp_train", "ngp_fine_tune") for k in NGP_KERNELS.values())}
    checked = {(e["path"], e["name"]) for e in kernels}
    if checked != wanted:
        fail(f"hash encode: kernels checked on {sorted(checked)}, wanted {sorted(wanted)}")
    return {"paths": paths, "kernels": kernels, "card": smi}


def start() -> str:
    """What every mode starts with: a CUDA card or a failure, full fp32 for
    the plain versions (TF32 would blur the comparisons), the card's name
    and power limit (printed and returned) and the build of the kernels,
    its time and ptxas's register and spill lines."""
    from mc_nerf_torch.ops.cuda import _build

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    return smi


def finish(lines: dict) -> None:
    """Prints one JSON line for each entry of ``lines``, then the device
    line, last."""
    for key, value in lines.items():
        print(json.dumps({key: value}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


def ngp_main() -> None:
    """``python3 chip_smoke.py --ngp``: the build and ``ngp_phase`` alone."""
    smi = start()
    ngp = ngp_phase(torch.device("cuda"), smi)
    kernels = ngp.pop("kernels")
    finish({"ngp": ngp, "kernels": kernels})


def main() -> None:
    from mc_nerf_torch.ops.cuda.fused_mlp import (
        fused_mlp_apply, fused_shaded_mlp, fused_shaded_mlp_bwd)
    from mc_nerf_torch.ops.cuda.fused_render import (
        fused_render, render_bwd_points, render_bwd_weights)
    from mc_nerf_torch.ops.cuda.sample_pdf import sample_pdf_cuda

    smi = start()
    dev = torch.device("cuda")
    ngp = ngp_phase(dev, smi)
    kernels = ngp.pop("kernels")
    gc.collect()
    torch.cuda.empty_cache()
    kernels += fused_mlp_vjp_hold(dev)
    demos = {mode: demo_phase(dev, smi, mode) for mode in ("importance", "grid")}
    counters = {k.__name__: k for k in (
        fused_render, render_bwd_points, render_bwd_weights, fused_mlp_apply, fused_shaded_mlp,
        fused_shaded_mlp_bwd, *rays_wrappers(), sample_pdf_cuda)}
    engine = engine_phase(dev, smi, counters)
    cli = cli_phase(dev, smi, counters)
    cli_cf = cli_cf_phase(dev, smi, counters)
    dp = dp_phase(dev, smi)
    nccl = nccl_phase(smi)

    # each kernel held on the inputs each path recorded: the engine's
    # within the tolerances, the CLI's, the coarse-free CLI's and the
    # data-parallel ones with the planted faults at 2x a tolerance or more

    def held(phase: dict, label: str, plants: bool) -> set:
        failures = []
        checked = path_kernel_holds(phase["calls"], phase["nerf"], plants, failures)
        if failures:
            fail(f"the {label} kernel checks failed: " + "; ".join(failures))
        kernels.extend(kernel_entries(checked))
        return set(checked)

    held(engine, "engine paths'", False)
    wanted = {("cli_train", n) for n in ("fused_mlp_apply_rays", "fused_render_rays",
                                         "fused_render", "render_bwd_points",
                                         "render_bwd_weights", "sample_pdf_cuda")}
    wanted |= {("cli_demo", "fused_mlp_apply_rays"), ("cli_demo", "fused_render_rays"),
               ("cli_demo", "sample_pdf_cuda"),
               ("cli_train_grid", "fused_mlp_apply_rays"),
               ("cli_train_grid", "fused_shaded_mlp_rays"), ("cli_train_grid", "fused_shaded_mlp"),
               ("cli_train_grid", "fused_shaded_mlp_bwd"),
               ("cli_demo_grid", "fused_mlp_apply_rays"), ("cli_demo_grid", "fused_shaded_mlp_rays")}
    checked = held(cli, "CLI paths'", True)
    if wanted - checked:
        fail(f"kernels not checked on their CLI paths: {sorted(wanted - checked)}")
    # the coarse-free paths: K2 and K3 on the inputs the hybrid schedule's
    # two-pass and coarse-free steps, its validation and both demos gave
    wanted = {("cli_train_cf", n) for n in ("fused_render", "fused_render_rays",
                                            "render_bwd_points", "render_bwd_weights",
                                            "sample_pdf_cuda")}
    wanted |= {(p, n) for p in ("cli_demo_cf", "cli_demo_density")
               for n in ("fused_render_rays", "sample_pdf_cuda")}
    checked = held(cli_cf, "coarse-free CLI paths'", True)
    if checked != wanted:
        fail(f"kernels checked on the coarse-free CLI paths {sorted(checked)}, "
             f"wanted {sorted(wanted)}")
    # the data-parallel paths: K1, K2 and K3 on the inputs rank 0 gave them;
    # K1, K2, K4 and sample_pdf on rank 0's blocks of the split frames (dp_split)
    wanted = {(p, n) for p in ("dp_train", "dp_demo", "dp_split")
              for n in ("fused_mlp_apply_rays", "fused_render_rays", "sample_pdf_cuda")}
    wanted |= {("dp_train", "fused_render"), ("dp_train", "render_bwd_points"),
               ("dp_train", "render_bwd_weights"), ("dp_split", "fused_shaded_mlp_rays")}
    checked = held(dp, "data-parallel paths'", True)
    if checked != wanted:
        fail(f"kernels checked on the data-parallel paths {sorted(checked)}, "
             f"wanted {sorted(wanted)}")
    if nccl is not None:
        kernels += nccl.pop("kernels")
    finish({"ngp": ngp, "demo": demos,
            "engine": {k: v for k, v in engine.items() if k not in ("calls", "nerf")},
            "cli": {**cli["summary"], "launches": cli["launches"]},
            "cli_cf": {**cli_cf["summary"], "launches": cli_cf["launches"]},
            "dp": dp["summary"], "nccl": nccl, "kernels": kernels})


def nccl_main() -> None:
    """``python3 chip_smoke.py --nccl``: on a machine with two cards or
    more, the build and ``nccl_phase`` alone; then its result line and the
    kernels line of its split path (``nccl_split``)."""
    smi = start()
    nccl = nccl_phase(smi)
    if nccl is None:
        fail("--nccl needs two cards or more")
    kernels = nccl.pop("kernels")
    finish({"nccl": nccl, "kernels": kernels})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:     # a rank that dp_phase or nccl_phase starts
        dp_rank(json.loads(sys.argv[2]))
    elif sys.argv[1:2] == ["--nccl"]:
        nccl_main()
    elif sys.argv[1:2] == ["--ngp"]:
        ngp_main()
    else:
        main()
