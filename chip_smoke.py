"""Smoke test of the PyTorch port on one NVIDIA GPU: build, check, render, train,
in both fine modes, the engine's three stages, resume and demo, and the CLI
on a reference-format scene.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the CUDA kernels from
   ``mc_nerf_torch/csrc`` (nvcc, sm_90a, one process per source, in
   parallel) and prints the build time.
1b. The hash-grid field (``ngp_phase``; alone: ``python3 chip_smoke.py
   --ngp``) at the benchmark's instant-ngp-base configuration and
   train.ngp inputs (8 of its 800x800 images): the occupancy refresh from
   the field, the GLOBAL_OPTIM and FINE_TUNE step graphs
   (``make_stage_epoch``, 10 steps on each route) and the 800x800 frame
   graph (``make_render_fn``, the same bits as its chunk loop); the
   encode's launches by path (``ops/cuda/hashgrid.py::launches`` zeroed
   before each: one forward and one backward a loop step, the warm-ups'
   and the capture's in a graph epoch, one forward a frame chunk; the
   profiler's in a replay of each graph); ``hash_encode_fwd_kernel`` and
   ``hash_encode_bwd_kernel`` held against ``hash_encode_plain`` on each
   path's first recorded call (features 2^-8 of their largest, the
   table's gradient and d/dx 2e-6 relative L2, as
   ``tests/test_torch_ngp_gpu.py``), with five planted faults, and timed
   with the plain body's forward and backward and their bound.
2. Holds each eval kernel against its plain PyTorch version on the card, at
   the main path's widths: ``fused_mlp_apply`` (coarse sigma-only 4x128 and
   fine full 8x256, 65,536 points plus a ragged tail) and ``fused_render``
   (flags (F,F), (T,T), (T,F) at s=32 and s=48, 2,000 rays); then times
   both, and compares them again, on one eval chunk of 16384 rays (48
   coarse, 32 fine samples per ray); holds ``sample_pdf``'s kernel against
   its plain body (``draw_gap``: each draw within rounding) at the frame
   chunk's two calls and the train step's two, and times both.
3. Drives the demo (``mc_nerf_torch.train.engine.demo``) at the library's
   default full width over two 800x800 views, with the occupancy refresh,
   through a renderer whose first frame captures the frame as a CUDA
   graph, and checks that K1, K2 and ``sample_pdf``'s kernel ran (the
   wrappers count the warm-up's and the capture's launches, the profiler
   those of a replay of the graph, times its replays: ``replayed_frames``);
   renders a frame again with ``sample_pdf``'s plain body and one chunk
   through the plain route, and compares; times frames.
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
6b. The compiled epoch (``graph_phase``): for four step kinds on the
   workload of 5 (importance and grid GLOBAL_OPTIM, coarse-free FINE_TUNE,
   CAM_PARAM), epochs of 10 steps from one state and seed through the
   step captured as a CUDA graph and through the loop of eager steps, in
   turns: the states after them bit for bit the same, the launches a step
   the same (the wrappers' over the warm-up and capture, the profiler's
   over the replays), a rebound map and a value frozen by the capture
   caught; wall ms, rays/s, device ms and busy share of each route.
6c. The compiled frame (``frame_graph_phase``): for four eval modes
   (importance on a fresh map, importance unculled, coarse-free on a
   bitpacked map, grid) at 800x800 and 200x200, the frame captured as a
   CUDA graph against the chunk loop: the same bits, the eval kernels'
   launches a frame the same (the loop's wrappers, the profiler on a
   replay), new weights, pose and map reaching the replay, a first
   frame's tensors left as they were; ms a frame in turns, the capture's
   seconds and memory, device ms and busy share of both routes; each
   kernel then held on the tensors the graphs' last replays gave it.
7. The engine (``mc_nerf_torch.train.engine.Engine``) at the default model
   and sampler widths on a scene the port's ``make_dataset`` writes under
   ``build/`` (8 train + 1 val + 2 test views at 200x200), cut to stages
   of 1 + 1 + 1 epochs of 16 steps with a 16-step occupancy warm-up: run
   A trains them, each stage's step captured once and replayed
   (``fused_render`` and its two backward launches exactly twice per
   GLOBAL_OPTIM / FINE_TUNE step of the warm-ups and captures, which the
   wrappers count, and twice in a replay of each stage's step graph,
   which the profiler counts after the run; ``fused_mlp_apply`` and
   ``fused_render`` in the validation frames, one graph replayed once a
   frame), run B resumes from run
   A's epoch-0 checkpoint and must end on the same bits, the demo
   restores the latest checkpoint and scores the test views.  The calls
   of the kernels' entry points are recorded by path and shape (the
   engine's training path keeps the first call at each shape, a
   warm-up step's before the capture: a replay calls no entry point; the
   CLI phases keep the last, a step graph's own tensors as its last
   replay, the profiled one after the run, left them); each kernel is
   then held against its plain
   version and timed on the inputs the engine gave it at each shape.
8. The CLI (``mc_nerf_torch.main.main``, what ``python -m mc_nerf_torch``
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
   more, and times it; a frame's eval chunk again with its depths spread
   ``EVAL_SPREAD`` times, where the composite's planted scan fault must
   show.  Then the coarse-free hybrid through the CLI (GLOBAL_OPTIM
   two-pass, FINE_TUNE coarse-free, a bitpacked map): ``fused_render``
   and its two backward launches exactly twice a two-pass step and once
   a coarse-free one, ``fused_mlp_apply`` never, the coarse MLP's
   parameters bit-stable through FINE_TUNE; its ``--demo`` with LPIPS on
   seeded random weights (against the CPU's fp32 value) and with the
   density PMF; each kernel held on those inputs as above.
8b. Data parallelism (``dp_phase``): 2 gloo ranks on the one card, each
   a subprocess, ``main()`` ``--train`` / ``--demo`` on both (the step as
   a loop: gloo's collectives run on the host; the host's wait for the
   card before the gradient all-reduce and the all-reduce timed; every
   validation and demo frame split over the ranks, each rank's blocks one
   graph, the gather after its replay) against one process with twice the
   images; an 800x800 importance-culled and a grid frame split over the 2
   ranks (``split_frames``), each bit for bit against one process in
   chunks of a block, with its ms and the gather's; and ``torchrun``
   itself.  With two cards or more (``nccl_phase``): ``torchrun`` of one
   rank a card over NCCL, the four step kinds of 6b at full width, 7000
   rays a rank, the loop and the step as one graph, its collectives
   captured, in turns (the same bits on both routes and every rank, the
   profiled launches a step, ms a step a rank, busy share, the
   all-reduce, global rays/s against 6b's one process); the four eval
   modes of 6c at 800x800 and 200x200 split over the ranks (the same bits
   on every rank and those of one process in chunks of a block, ms
   against one process's graph frame, the gather, capture seconds and
   pool, the launches a replay); and ``-m mc_nerf_torch --train``, its
   validation split; skipped, and said so, on one card.
9. Prints the ``kernels`` JSON line, one entry per kernel and path (the
   demo; the train step; the grid demo; the grid train step; the
   fused_mlp VJP; the frame graph phase; the engine's training steps,
   validation renders and demo; the CLI's importance and grid ``--train``
   and ``--demo``; the data-parallel ``--train`` and ``--demo`` and the
   frames split over its ranks; the hash encode's refresh, GLOBAL_OPTIM,
   FINE_TUNE and frame paths): that
   path's launches (an eval path's: its frame graphs' replays, profiled;
   ``launches_counted`` the wrappers'), time per launch at its shapes,
   bound, plain and library times; then ``{"ok": true, "device": ...}``
   last.

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

import contextlib
import copy
import dataclasses
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
MLP_TOL = {"rel": MLP_RTOL}
RENDER_TOL = {"rgb/opacity": RENDER_ATOL, "depth": DEPTH_ATOL, "wsel": RENDER_ATOL}
# sample_pdf's kernel vs its plain body (csrc/sample_pdf.cu): the PMF's
# sums in another order, so each draw is held within rounding of the plain
# body's by ops/cuda/sample_pdf.py::draw_gap (1 or less: its depth within
# 2e-5, or its place on the CDF within 4e-6), as tests/test_torch_gpu.py
SAMPLE_PDF_TOL = {"draw": 1.0}
# its calls on the main path: the frame chunk's two (the coarse draw on
# the stride-0 probe ladder, the fine from the coarse weights) and the
# train step's two (uniforms): (label, rays, S, K, uniforms)
SAMPLE_PDF_CALLS = (("frame coarse", 16384, 66, 48, False), ("frame fine", 16384, 48, 32, False),
                    ("train coarse", 7000, 66, 48, True), ("train fine", 7000, 48, 32, True))
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
# the graph phase: steps an epoch of each route, and its step kinds:
# (stage, train and NeRF config changes from Config())
GRAPH_STEPS = 10
GRAPH_KINDS = {"importance GLOBAL_OPTIM": (1, {}, {}),
               "grid GLOBAL_OPTIM": (1, {"fine_mode": "grid"}, {}),
               "coarse-free FINE_TUNE": (2, {}, {"coarse_free": True, "coarse_free_from_stage": 2,
                                                 "cf_uniform_samples": 8,
                                                 "occ_map_dtype": "bitpack"}),
               "CAM_PARAM": (0, {}, {})}
# the frame graph phase: the eval modes (the eval and NeRF config changes
# from Config(); whether a fresh map is refreshed from the weights: the
# demo's), at the demo's size and the engine's and CLI's validation size
# (3 chunks, the last padded), and the frames a route timed
FRAME_MODES = {"importance culled": ({}, {}, True),
               "importance unculled": ({}, {}, False),
               "coarse-free bitpack": ({}, {"coarse_free": True, "occ_map_dtype": "bitpack"},
                                       True),
               "grid": ({"fine_mode": "grid"}, {}, False)}
FRAME_SIDES = (800, 200)
FRAME_ITERS = {800: 2, 200: 10}
# the kernel of csrc/ each eval wrapper launches once a call, as the
# profiler names it: K1 the forward kernel's FWD_RAW instance, K2 its
# composite; K4 the FWD_SHADED instance, which K2 also runs
FRAME_SIGNATURE = {"fused_mlp_apply": r"shaded_fwd_kernel<\D*1>",
                   "fused_render": r"\bcomposite_fwd_kernel\b",
                   "fused_shaded_mlp": r"shaded_fwd_kernel<\D*0>",
                   "sample_pdf_cuda": r"\binverse_cdf_kernel\b"}
# each eval mode's launches of each wrapper a chunk (a block of a split
# frame): K1 the coarse pass, K2 or K4 the fine one; sample_pdf's draws
# of the coarse depths from the map's PMF and of the fine ones
FRAME_LAUNCHES = {"importance culled": {"fused_mlp_apply": 1, "fused_render": 1,
                                        "sample_pdf_cuda": 2},
                  "importance unculled": {"fused_mlp_apply": 1, "fused_render": 1,
                                          "sample_pdf_cuda": 1},
                  "coarse-free bitpack": {"fused_render": 1, "sample_pdf_cuda": 1},
                  "grid": {"fused_mlp_apply": 1, "fused_shaded_mlp": 1}}
# the engine phase's cuts of the protocol (52 epochs of 50 steps a train
# image, 3000 warm-up steps, 800x800 images, 200 test views)
ENGINE_CUTS = {"stages": (1, 1, 1), "steps_per_image_epoch": 2, "occ_warmup_steps": 16}
ENGINE_RES = 200
# improve_cameras on the card vs the CPU: the adoption masks exact, the
# adopted twists and focal multipliers (fp32, SVDs of 10 x 9 systems)
RESTART_ATOL = 1e-4
# calls per timing of a forward kernel on the engine's inputs
ENGINE_ITERS = 20
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
# the step kinds on NCCL ranks (nccl_kinds: GRAPH_KINDS, each rank's image of
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
# in both fine modes; nccl_phase's ranks, one a card: the frame graph
# phase's eight; FRAME_LAUNCHES a chunk's block), and the gathers timed
# alone
DP_SPLIT_CELLS = (("importance culled", 800), ("grid", 800))
NCCL_SPLIT_CELLS = tuple((mode, side) for mode in FRAME_MODES for side in FRAME_SIDES)
GATHER_ITERS = 10
# each wrapper's TPU kernel (the kernels line's "replaces") and its source
REPLACES = {"fused_mlp_apply": "mc_nerf_tpu/ops/pallas/fused_mlp.py:241",
            "fused_render": "mc_nerf_tpu/ops/pallas/fused_render.py:211",
            "render_bwd_points": "mc_nerf_tpu/ops/pallas/fused_render.py:290",
            "render_bwd_weights": "mc_nerf_tpu/ops/pallas/fused_render.py:290",
            "fused_shaded_mlp": "mc_nerf_tpu/ops/pallas/fused_mlp.py:381",
            "fused_shaded_mlp_bwd": "mc_nerf_tpu/ops/pallas/fused_mlp.py:423",
            "fused_mlp_bwd": "mc_nerf_tpu/ops/pallas/fused_mlp.py:739",
            "sample_pdf_cuda": "none: mc_nerf_tpu/ops/volume.py::sample_pdf is plain jnp"}
SOURCES = {"fused_mlp_apply": "mc_nerf_torch/csrc/fused_mlp.cu",
           "fused_render": "mc_nerf_torch/csrc/fused_render.cu",
           "render_bwd_points": "mc_nerf_torch/csrc/fused_render_bwd.cu",
           "render_bwd_weights": "mc_nerf_torch/csrc/fused_render_bwd.cu",
           "fused_shaded_mlp": "mc_nerf_torch/csrc/fused_shaded.cu",
           "fused_shaded_mlp_bwd": "mc_nerf_torch/csrc/fused_mlp_bwd.cu",
           "fused_mlp_bwd": "mc_nerf_torch/csrc/fused_mlp_bwd.cu",
           "sample_pdf_cuda": "mc_nerf_torch/csrc/sample_pdf.cu"}


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
                unplanted: tuple = ()) -> dict:
    """``fused_render`` on the inputs ``a`` held against its plain version
    (``hold``), with the planted faults of the other phases but those in
    ``unplanted`` at 2x (``CLI_WEAK_PLANTS`` at theirs); returns the
    kernel's errors."""
    from mc_nerf_torch.ops.cuda.fused_render import fused_render, fused_render_plain
    from mc_nerf_torch.tools.bwd_check import render_scan_late

    k_out, k_w = fused_render(*a)
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


def hold_sample_pdf(label: str, args: tuple, plants: bool = True,
                    failures: list = None) -> dict:
    """sample_pdf_cuda on ``args`` (z, weights, K, uniforms or None, eps)
    against sample_pdf_plain: every draw within rounding of the plain
    body's (``draw_gap`` within SAMPLE_PDF_TOL); with ``plants``, each
    planted fault (the midpoints one bin late; the draws' jitter dropped,
    or added where there is none) at 2x it or more.  Returns {"draw_gap",
    "max_abs_err": the largest depth gap}."""
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
    return {"draw_gap": e["draw"], "max_abs_err": depth}


def sample_pdf_times(args: tuple) -> dict:
    """sample_pdf_cuda on ``args`` (z, weights, K, uniforms, eps): its ms
    a launch, the plain body's, and the bound (the call's bytes over the
    memory rate: weights, z (one row where its row stride is 0), uniforms
    in, depths out)."""
    from mc_nerf_torch.ops.cuda.sample_pdf import sample_pdf_cuda
    from mc_nerf_torch.ops.volume import sample_pdf_plain

    z, w, k, u, eps = args
    rays, s = w.shape
    nbytes = 4 * (rays * s + (s if z.stride(0) == 0 else rays * s)
                  + (0 if u is None else rays * k) + rays * k)
    b_ms, by = bound(0.0, nbytes)
    with torch.no_grad():
        return {"ms": cuda_ms(lambda: sample_pdf_cuda(*args), ENGINE_ITERS),
                "plain_ms": cuda_ms(lambda: sample_pdf_plain(z, w, k, u, eps=eps), 3),
                "bound_ms": b_ms, "bound_by": by}


def sample_pdf_numbers(dev, rng) -> dict:
    """sample_pdf's kernel against its plain body at the main path's calls
    (SAMPLE_PDF_CALLS, seeded inputs: sorted depths in [1, 8], the probe
    ladder one row; weights of bins 70% empty), held with the planted
    faults (``hold_sample_pdf``) and timed (``sample_pdf_times``).
    Returns {label: numbers}."""
    out = {}
    for label, rays, s, k, jitter in SAMPLE_PDF_CALLS:
        ladder = label == "frame coarse"
        z = torch.as_tensor(np.sort(rng.uniform(1.0, 8.0, (1 if ladder else rays, s)), axis=-1),
                            dtype=torch.float32, device=dev).expand(rays, s)
        w = rng.uniform(0.0, 1.0, (rays, s)) * (rng.uniform(size=(rays, s)) < 0.3)
        w = torch.as_tensor(w, dtype=torch.float32, device=dev)
        u = torch.as_tensor(rng.uniform(size=(rays, k)), dtype=torch.float32, device=dev)
        args = (z, w, k, u if jitter else None, 1e-5)
        out[label] = {**hold_sample_pdf(f"sample_pdf {label} R={rays} S={s} K={k}", args),
                      **sample_pdf_times(args)}
        x = out[label]
        print(f"sample_pdf {label}: {x['ms']:.4f} ms a launch (plain {x['plain_ms']:.3f}, bound "
              f"{x['bound_ms']:.4f} by {x['bound_by']})", flush=True)
    return out


def per_launch(passes: dict) -> dict:
    """One kernel's numbers over a training step's launches (one per pass):
    each time and bound is the mean per launch; ``per_pass`` keeps each."""
    mean = {k: sum(p[k] for p in passes.values()) / len(passes)
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")
            if all(k in p for p in passes.values())}
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
    from mc_nerf_torch.train.optim import build_optimizers, counter, flatten_params
    from mc_nerf_torch.train.steps import TrainState, draw_step, make_loss_fn, make_stage_step

    mode = cfg.train.fine_mode
    params, data = train_workload(cfg, SEED, dev, img_h=h, img_w=w)
    p_flat = flatten_params(params)
    txs, states = build_optimizers(cfg, params, p_flat, STEPS_PER_EPOCH)
    state = TrainState(params, p_flat, states, counter(TOTAL_STEPS // 2, dev))
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


def kind_workload(dev, stage: int, train_kw: dict, nerf_kw: dict) -> tuple:
    """A step kind of ``GRAPH_KINDS`` on the workload bench.py times
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


def graph_phase(dev, smi: str, counters: dict) -> dict:
    """The compiled epoch (``train/steps.py:StageEpoch``) against the loop
    of eager steps, on the workload bench.py times at full width, for each
    of ``GRAPH_KINDS``: from one state (step 143,000 of 286,000: the BARF
    gate moves every step) and one seed, epochs of ``GRAPH_STEPS`` steps,
    the first of each route untimed (the graph's warm-up and capture),
    then four timed in turns (loop, graph, graph, loop), then one of each
    under the profiler (``tools/profile_step.py``'s ``routes_in_turns``
    and ``profile_routes``).  Checks: after every epoch the graph route's
    p_flat, moments, count and step equal the loop's (the bound is the
    loop's spread against itself, measured: 0, bit for bit, where the
    kernels are deterministic); the wrappers' launches a step over the
    warm-up and the capture equal the loop's, and the profiler finds every
    kernel of ``csrc/`` as many times a step in a graph epoch (its
    replays) as in a loop epoch.  Plants that must be caught: a map
    rebound after the capture (``data._replace(occ=...)``:
    ``StaleGraphBuffer``, before any replay) and a value made from the
    host's count of the steps it issued (the progress clock of a
    GLOBAL_OPTIM step, the count of a CAM_PARAM step's LR schedule), which
    a capture freezes: the loop with it ends on the loop's bits, the graph
    with it must not.  Prints each kind's wall ms a step in turns, rays/s,
    and the profiled device ms and busy share."""
    import mc_nerf_torch.train.steps as steps_module
    from mc_nerf_torch.tools.profile_step import profile_routes, routes_in_turns
    from mc_nerf_torch.tools.scene import TOTAL_STEPS
    from mc_nerf_torch.train.optim import FlatRAdam
    from mc_nerf_torch.train.steps import StaleGraphBuffer, make_stage_epoch

    t_phase = time.perf_counter()
    names = csrc_kernel_names()
    n, pool = GRAPH_STEPS, torch.cuda.graph_pool_handle()

    def one_kind(kind, stage, train_kw, nerf_kw) -> dict:
        cfg, state, data, txs, live = kind_workload(dev, stage, train_kw, nerf_kw)
        start = [t.clone() for t in live]
        gen = torch.Generator(device=dev)

        def epoch(route, tx=None):
            return make_stage_epoch(cfg, stage, tx or txs[stage], 800, 800, TOTAL_STEPS, n,
                                    graph=route == "graph", pool=pool)

        def reset():
            """Back to the start state and seed."""
            with torch.no_grad():
                for t, v in zip(live, start):
                    t.copy_(v)
            gen.manual_seed(SEED + 1)

        def keep():
            return [t.clone() for t in live]

        launched = {}

        def run(ep, data_=None):
            """One epoch; the wrappers' launches in it are added to
            ``launched[ep]``."""
            before = {k: c.launches for k, c in counters.items()}
            m = ep(state, data if data_ is None else data_, gen)
            got = launched.setdefault(ep, dict.fromkeys(counters, 0))
            for k, c in counters.items():
                got[k] += c.launches - before[k]
            if not all(math.isfinite(float(v)) for v in m.values()):
                fail(f"graph phase {kind}: epoch metrics not finite: {m}")

        def gap(a, b):
            return max(float((x.double() - y.double()).abs().max()) for x, y in zip(a, b))

        eps = {"loop": epoch("loop"), "graph": epoch("graph")}
        first, timed = routes_in_turns(eps, run, n, reset, keep)
        ends = {route: [first[route]] + [kept for _, kept in timed[route]] for route in eps}
        turns = {route: [ms for ms, _ in v] for route, v in timed.items()}
        # the wrappers count the loop's launches and the graph's warm-up's
        # and capture's; a replay runs the captured launches without them
        launches = {route: {k: v / host_steps(ep.counts) for k, v in launched[ep].items()}
                    for route, ep in eps.items()}
        spread = gap(ends["loop"][0], ends["loop"][2])
        worst = max(gap(e, ends["loop"][0]) for e in ends["graph"])
        same = all(torch.equal(x, y) for e in ends["graph"] for x, y in zip(e, ends["loop"][0]))
        counts = {r: dict(ep.counts) for r, ep in eps.items()}
        print(f"graph phase, {kind}: the loop against itself {spread:.3e}, the graph against "
              f"the loop {worst:.3e} (max abs over p_flat, mu, nu, count, step; bit-identical: "
              f"{same}); launches a step: loop {launches['loop']}, graph (warm-up and capture) "
              f"{launches['graph']}; steps by route {counts}", flush=True)
        if worst > spread or launches["loop"] != launches["graph"]:
            fail(f"graph phase {kind}: the graph route strays from the loop ({worst:.3e} "
                 f"against its spread {spread:.3e}) or launches otherwise")
        if counts["graph"] != {"warmup": steps_module.WARMUP_STEPS, "captured": 1,
                               "replayed": 3 * n, "looped": 0}:
            fail(f"graph phase {kind}: steps by route {counts['graph']}")

        prof = profile_routes(eps, run, n, names)
        for p in prof.values():
            p.pop("rows")
        if (prof["graph"]["named_a_step"] != prof["loop"]["named_a_step"]
                or (stage and not prof["graph"]["named_a_step"])):
            fail(f"graph phase {kind}: the profiler finds the kernels of csrc/ "
                 f"{prof['graph']['named_a_step']} a step in the graph's replays, "
                 f"{prof['loop']['named_a_step']} in the loop's")
        rays = cfg.train.rays_per_batch if stage else 0
        ms = {r: sum(v) / len(v) for r, v in turns.items()}
        print(f"graph phase, {kind}: ms a step in turns (loop, graph, graph, loop) "
              f"{turns['loop'][0]:.3f}, {turns['graph'][0]:.3f}, {turns['graph'][1]:.3f}, "
              f"{turns['loop'][1]:.3f}: loop {ms['loop']:.3f}, graph {ms['graph']:.3f} "
              f"({ms['loop'] / ms['graph']:.2f}x"
              + (f"; {rays / ms['loop'] * 1e3:.0f} against {rays / ms['graph'] * 1e3:.0f} "
                 "rays/s" if rays else "") + "); profiled: " + "; ".join(
                  f"{r} {p['step_ms']:.3f} ms wall, {p['kernel_ms']:.3f} ms of kernels, busy "
                  f"share {p['busy_share']:.3f}, {p['kernels_a_step']} kernels a step"
                  for r, p in prof.items())
              + f"; the kernels of csrc/ a step {prof['graph']['named_a_step']} ({smi})",
              flush=True)

        # the plants
        plants = {}
        if data.occ is not None and stage == 1:
            replayed = eps["graph"].counts["replayed"]
            try:
                reset()
                run(eps["graph"], data._replace(occ=data.occ.clone()))
                plants["rebound map"] = "not caught"
            except StaleGraphBuffer as e:
                plants["rebound map"] = f"caught: {e}"
            if eps["graph"].counts["replayed"] != replayed:
                plants["rebound map"] = "not caught: replayed on the rebound map"
        frozen = {1: "progress from the host's count", 0: "LR from the host's count"}.get(stage)
        if frozen and not nerf_kw:
            host = {"n": 0}
            real, tx = steps_module.make_loss_fn, txs[stage]

            def issued(dtype):
                # the host's count of the steps it issued, as a device
                # scalar: right in the loop, frozen by a capture
                host["n"] += 1
                return torch.full((), host["n"] - 1, dtype=dtype, device=dev)

            if stage == 1:
                def make_loss_fn(*a, **kw):
                    fn = real(*a, **kw)
                    return lambda prm, dat, draws, step: fn(
                        prm, dat, draws, issued(torch.int32) + TOTAL_STEPS // 2)
                steps_module.make_loss_fn = make_loss_fn
            else:
                lr1 = tx.lr
                tx = FlatRAdam(tx.mask, lambda t: lr1(issued(torch.float32)), tx.weight_decay,
                               tx.clip)
            try:
                planted = {}
                for route in ("loop", "graph"):
                    ep = epoch(route, tx)
                    for _ in range(2):        # the graph's capture; the loop's first epoch
                        host["n"] = 0
                        reset()
                        run(ep)
                    planted[route] = keep()
            finally:
                steps_module.make_loss_fn = real
            loop_ok = all(torch.equal(x, y) for x, y in zip(planted["loop"], ends["loop"][0]))
            graph_off = gap(planted["graph"], ends["loop"][0])
            plants[frozen] = (f"the loop with it {'on' if loop_ok else 'OFF'} the loop's bits; "
                              f"the graph with it {graph_off:.3e} away")
            if not loop_ok or graph_off <= spread:
                plants[frozen] = "not caught: " + plants[frozen]
        print(f"graph phase, {kind}: plants {plants}", flush=True)
        if any(v.startswith("not caught") for v in plants.values()):
            fail(f"graph phase {kind}: a plant was not caught: {plants}")
        return {"stage": stage, "turns_ms": turns, "loop_ms": ms["loop"],
                "graph_ms": ms["graph"], "speedup": ms["loop"] / ms["graph"],
                "rays_per_s": {r: rays / v * 1e3 for r, v in ms.items()} if rays else None,
                "profiles": prof, "loop_spread": spread, "graph_gap": worst,
                "bit_identical": same, "launches_a_step": launches["loop"],
                "graph_launches_a_step": launches["graph"], "steps_by_route": counts,
                "plants": plants}

    out = {}
    for kind, spec in GRAPH_KINDS.items():
        out[kind] = one_kind(kind, *spec)
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"graph phase: {seconds:.1f} s", flush=True)
    return {"kinds": out, "seconds": seconds, "card": smi}


def frame_launches_in(rows) -> dict:
    """The eval kernels' launches in profiler ``rows`` (``profile_steps``'),
    by wrapper: each wrapper's ``FRAME_SIGNATURE`` kernel; K2 runs the
    same ``shaded_fwd_kernel<FWD_SHADED>`` as K4 before its composite, so
    K4's are those beyond K2's."""
    found = {w: sum(c for _, c, name in rows if re.search(p, name))
             for w, p in FRAME_SIGNATURE.items()}
    found["fused_shaded_mlp"] -= found["fused_render"]
    return found


def replayed_frames(renders, path: str) -> tuple:
    """The launches that the frame graphs of ``renders``
    (``train/steps.py::FrameRender``) made on the card in a path's run:
    each graph replayed once more under the profiler, its eval kernels
    counted (``frame_launches_in``), times the replays the run made
    (``FrameRender.captures``).  A replay writes only the graph's own
    outputs, from the inputs the run wrote last.  Returns ({wrapper:
    launches in the run's replays}, {graph: {"per_replay": {wrapper:
    launches}, "replays": n}})."""
    from mc_nerf_torch.tools.profile_step import profile_steps

    total, graphs = dict.fromkeys(FRAME_SIGNATURE, 0), {}
    for render in renders:
        for key, (g, _, _) in render._graphs.items():
            _, rows, _ = profile_steps(g.replay, 1)
            found, n = frame_launches_in(rows), render.captures[key]["replays"]
            graphs[f"{render.img_h}x{render.img_w} {key}"] = {"per_replay": found, "replays": n}
            for w, v in found.items():
                total[w] += v * n
    print(f"{path}: the frame graphs' eval kernels a replay (profiled) {graphs}; in the run's "
          f"replays {total}", flush=True)
    return total, graphs


def frame_cell(mode: str, side: int, dev, angles=(0.3,)) -> tuple:
    """A cell of the frame phases: ``mode``'s change of ``Config()``
    (``FRAME_MODES``), the seeded scene's weights (``tools/scene.scene_params``)
    and, where the mode has one, a fresh map refreshed from them, and the
    orbit's poses at ``angles`` with their K at ``side`` x ``side``.
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
    poses, K = orbit_views(angles, side, side)
    return cfg, params, occ, poses, K


def in_turns(fns: dict, order, iters: int, before=None) -> dict:
    """Each route of ``fns`` (route -> callable) timed in the turns of
    ``order`` (``cuda_ms`` of ``iters`` calls a turn, ``before()`` ahead of
    each turn where given): {route: [ms a call, a turn each]}."""
    turns = {route: [] for route in fns}
    for route in order:
        if before is not None:
            before()
        turns[route].append(cuda_ms(fns[route], iters))
    return turns


def frame_graph_phase(dev, smi: str, counters: dict) -> dict:
    """The compiled frame (``train/steps.py::FrameRender``) against the
    chunk loop, in each eval mode of ``FRAME_MODES`` at each of
    ``FRAME_SIDES``, at ``Config()`` widths on the seeded scene's weights
    (``tools/scene.scene_params``) and, where the mode has one, a fresh
    map refreshed from them.  Checks, each route from its own renderer:
    the graph's first frame (one chunk of warm-up, the capture, a replay)
    equal to the loop's frame bit for bit; each eval kernel's launches a
    frame the same on both routes (the loop's by its wrapper, the graph's
    by the profiler on one replay; the loop's by the profiler too):
    ``FRAME_LAUNCHES[mode]`` a chunk; new weights (every weight x 1.01), a new
    pose and a new map of the same kind (half of the box emptied) reach
    the replay, which equals the loop
    on them bit for bit without a second capture, and leave the first
    frame's tensors as they were.  Times the loop and the graph in turns
    (loop, graph, graph, loop; ms a frame, CUDA events), and prints each
    graph's warm-up and capture seconds and the memory its capture
    reserved, and both routes' profiled device ms and busy share.  The
    kernels' entry points are recorded at the captures (``engine_recorder``,
    each shape's last call: a graph's own tensors, which its last replay
    wrote) for ``path_kernel_numbers``.  ``counters``: name -> wrapper."""
    from mc_nerf_torch.tools.profile_step import profile_steps
    from mc_nerf_torch.train.steps import make_render_fn

    t_phase = time.perf_counter()
    where, calls = [None], {}
    out, replayed = {}, dict.fromkeys(FRAME_SIGNATURE, 0)

    def launches():
        return {k: counters[k].launches for k in FRAME_SIGNATURE}

    def one(mode, side) -> dict:
        cfg, params, occ, (pose, pose2), K = frame_cell(mode, side, dev, (0.3, 2.2))
        chunks = -(-side * side // cfg.eval.rays_per_chunk)
        loop = make_render_fn(cfg, side, side, device=dev, graph=False)
        graph = make_render_fn(cfg, side, side, device=dev, graph=True)
        for c in counters.values():
            c.launches = 0
        # the loop's own peak over what it started from: one chunk's working
        # set, what the graph's pool holds for good
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        a = loop(params, pose, K, occ)
        torch.cuda.synchronize()
        loop_peak_mib = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
        loop_launches = launches()
        where[0] = "frame_graph"
        b = graph(params, pose, K, occ)
        torch.cuda.synchronize()
        where[0] = None
        captured = {k: v - loop_launches[k] for k, v in launches().items()}
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        key = graph.graph_key(occ)
        prof = {}
        for route, fn in (("loop", loop), ("graph", graph)):
            wall, rows, _ = profile_steps(lambda: fn(params, pose, K, occ), 1)
            kernel_ms = sum(r[0] for r in rows)
            prof[route] = {"wall_ms": wall, "kernel_ms": kernel_ms, "busy_share": kernel_ms / wall,
                           "kernels": sum(r[1] for r in rows),
                           "launches": frame_launches_in(rows)}
        want = {k: FRAME_LAUNCHES[mode].get(k, 0) * chunks for k in FRAME_SIGNATURE}
        launches_ok = (loop_launches == prof["graph"]["launches"] == prof["loop"]["launches"]
                       == want
                       and captured == {k: v + v // chunks for k, v in loop_launches.items()})
        # new weights, pose and map, written by the caller (the map: this
        # one with the half of the box at x < 0 emptied; the seeded scene's
        # fresh map is all occupied, so a refresh would not change it)
        kept = [t.clone() for t in b]
        params2 = copy.deepcopy(params)
        with torch.no_grad():
            for p in params2.parameters():
                p.mul_(1.01)
        occ2 = None
        if occ is not None:
            occ2 = occ.clone()
            occ2[: occ.shape[0] // 2] = 0
        a2, b2 = loop(params2, pose2, K, occ2), graph(params2, pose2, K, occ2)
        torch.cuda.synchronize()
        new_ok = (all(torch.equal(x, y) for x, y in zip(a2, b2))
                  and not torch.equal(a2[0], a[0])
                  and (occ is None or not torch.equal(occ2, occ)))
        first_ok = all(torch.equal(x, y) for x, y in zip(b, kept))
        iters = FRAME_ITERS[side]
        turns = in_turns({"loop": lambda: loop(params, pose, K, occ),
                          "graph": lambda: graph(params, pose, K, occ)},
                         ("loop", "graph", "graph", "loop"), iters)
        ms = {r: sum(v) / len(v) for r, v in turns.items()}
        cap = graph.captures[key]
        counts = {"loop": dict(loop.counts), "graph": dict(graph.counts)}
        finite = bool(torch.isfinite(a[0]).all() & torch.isfinite(a[1]).all())
        print(f"frame graph, {mode} {side}x{side} ({chunks} chunks): bit-identical {same}, new "
              f"weights / pose / map {new_ok}, first frame kept {first_ok}; launches a frame: "
              f"loop {loop_launches}, graph replay (profiled) {prof['graph']['launches']}, "
              f"capture {captured}; ms a frame in turns (loop, graph, graph, loop) "
              f"{turns['loop'][0]:.3f}, {turns['graph'][0]:.3f}, {turns['graph'][1]:.3f}, "
              f"{turns['loop'][1]:.3f}: loop {ms['loop']:.3f}, graph {ms['graph']:.3f} "
              f"({ms['loop'] / ms['graph']:.3f}x); warm-up {cap['warmup_s']:.3f} s, capture "
              f"{cap['capture_s']:.3f} s, {cap['pool_mib']:.1f} MiB reserved (the loop's peak "
              f"{loop_peak_mib:.1f} MiB allocated); profiled: "
              + "; ".join(f"{r} {p['wall_ms']:.3f} ms wall, {p['kernel_ms']:.3f} ms of kernels, "
                          f"busy share {p['busy_share']:.3f}, {p['kernels']} kernels"
                          for r, p in prof.items()) + f" ({smi})", flush=True)
        if not (same and new_ok and first_ok and launches_ok and finite):
            fail(f"frame graph {mode} {side}x{side}: the graph frame strays from the loop or "
                 f"launches otherwise (bit-identical {same}, new values {new_ok}, first frame "
                 f"kept {first_ok}, launches {launches_ok}, finite {finite})")
        if counts["graph"] != {"captured": 1, "replayed": 3 + 2 * (iters + 1), "looped": 0}:
            fail(f"frame graph {mode} {side}x{side}: frames by route {counts}")
        for k, v in prof["graph"]["launches"].items():
            replayed[k] += v * cap["replays"]
        graph.release()
        return {"bit_identical": same, "new_values": new_ok, "first_kept": first_ok,
                "chunks": chunks, "launches_a_frame": loop_launches,
                "capture_launches": captured, "profiles": prof, "turns_ms": turns,
                "loop_ms": ms["loop"], "graph_ms": ms["graph"],
                "speedup": ms["loop"] / ms["graph"], "capture": cap,
                "loop_peak_mib": loop_peak_mib, "frames_by_route": counts}

    with recording_frames(where, calls):
        for mode in FRAME_MODES:
            for side in FRAME_SIDES:
                out[f"{mode} {side}"] = one(mode, side)
                torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"frame graph phase: {seconds:.1f} s; launches in the replays {replayed}", flush=True)
    return {"modes": out, "seconds": seconds, "card": smi, "calls": calls,
            "replayed_launches": replayed}


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
    ``path_kernel_numbers`` then checks and times the kernel."""
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
    if train_launches["fused_mlp_apply"] != 0 or not all(
            val_launches[n] > 0 for n in ("fused_mlp_apply", "fused_render", "sample_pdf_cuda")):
        fail(f"engine validation launches {val_launches}, training {train_launches}")
    # the validation frames: one graph of the frame, captured once and
    # replayed once a frame (the wrappers count the warm-up and capture)
    frame_routes = {"engine_validation": [dict(r.counts) for r in eng_a._render_fns.values()]}
    val_frames, _ = replayed_frames(eng_a._render_fns.values(), "engine_validation")
    if not (frame_routes["engine_validation"] == [{"captured": 1, "replayed": stages[1] + stages[2],
                                                   "looped": 0}]
            and val_frames["fused_mlp_apply"] > 0 and val_frames["fused_render"] > 0
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
    same = {"p_flat": torch.equal(a.p_flat, b.p_flat), "step": bool(a.step == b.step),
            **{f"stage {i} {f}": bool(torch.equal(getattr(x, f), getattr(y, f)))
               for i, (x, y) in enumerate(zip(a.opt_states, b.opt_states)) for f in ("mu", "nu")},
            **{f"stage {i} count": bool(x.count == y.count)
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
    frame_routes["engine_demo"] = [dict(r.counts) for r in eng_d._render_fns.values()]
    demo_frames, _ = replayed_frames(eng_d._render_fns.values(), "engine_demo")
    print(f"engine demo: {demo} in {demo_s:.2f} s ({smi}); launches by the wrappers (warm-up "
          f"and capture) {demo_launches}, in the frame graphs' replays {demo_frames}; frames by "
          f"route {frame_routes}", flush=True)
    if not (demo["count"] == 2 and math.isfinite(demo["psnr"]) and math.isfinite(demo["ssim"])):
        fail(f"engine demo result is not finite: {demo}")
    if not (demo_launches["fused_mlp_apply"] > 0 and demo_launches["fused_render"] > 0
            and demo_launches["sample_pdf_cuda"] > 0 and demo_launches["render_bwd_points"] == 0
            and demo_frames["fused_mlp_apply"] > 0 and demo_frames["fused_render"] > 0
            and demo_frames["sample_pdf_cuda"] > 0
            and frame_routes["engine_demo"] == [{"captured": 1, "replayed": 2, "looped": 0}]):
        fail(f"engine demo launches {demo_launches}, in its frame graphs {demo_frames}; frames "
             f"by route {frame_routes['engine_demo']}")
    shutil.rmtree(work, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    print(f"engine phase: {seconds:.1f} s", flush=True)

    # every counted launch is a recorded call, on the path it was counted on
    counted = {"engine_train": train_launches, "engine_validation": val_launches,
               "engine_demo": demo_launches}
    for path, got in counted.items():
        seen = {name: sum(c["n"] for c in calls.get((path, name), {}).values())
                for name in ("fused_render", "fused_mlp_apply", "fused_render_bwd",
                             "sample_pdf_cuda")}
        want = {"fused_render": got["fused_render"], "fused_mlp_apply": got["fused_mlp_apply"],
                "fused_render_bwd": got["render_bwd_points"],
                "sample_pdf_cuda": got["sample_pdf_cuda"]}
        if seen != want or got["render_bwd_points"] != got["render_bwd_weights"]:
            fail(f"{path}: recorded calls {seen} are not the launches counted {got}")
    return {"seconds": seconds, "train_s": train_s, "resume_s": resume_s,
            "restore_ms": restore_ms, "demo_s": demo_s, "demo": demo, "steps_per_epoch": spe,
            "epochs": eng_a.history, "train_launches": train_launches,
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
    ``path_kernel_numbers``."""
    import os
    import pathlib
    import shutil

    from mc_nerf_torch.config import Config
    from mc_nerf_torch.data.blender import load_scene
    from mc_nerf_torch.data.calibration import CACHE_NAME
    from mc_nerf_torch.data.cube import tag_world_points
    from mc_nerf_torch.data.synthetic import make_dataset
    from mc_nerf_torch.train.engine import STAGE_NAMES

    t_phase = time.perf_counter()
    try:
        gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True, check=True)
    except (OSError, subprocess.CalledProcessError) as e:
        fail(f"g++ is not usable here ({e}): the tag36h11 detector builds with it")
    print(f"g++: {gxx.stdout.splitlines()[0]}", flush=True)

    work = pathlib.Path(__file__).resolve().parent / "build" / f"cli_smoke_{os.getpid()}"
    shutil.rmtree(work, ignore_errors=True)
    res, (n_train, n_val, n_test), name = ENGINE_RES, CLI_VIEWS, "Ball_Cli"
    scene_dir = work / "data" / name
    t0 = time.perf_counter()
    make_dataset(str(scene_dir), n_train=n_train, n_val=n_val, n_test=n_test, img_h=res,
                 img_w=res, seed=SEED, calibration_mode="rendered")
    dataset_s = time.perf_counter() - t0
    written = dict(np.load(scene_dir / CACHE_NAME))
    os.remove(scene_dir / CACHE_NAME)
    runs = {"importance": (CLI_CUTS["importance stages"], "importance"),
            "grid": (CLI_CUTS["grid stages"], "grid")}
    for run, (stages, mode) in runs.items():
        (work / f"config_{run}").mkdir(parents=True)
        (work / f"config_{run}" / "config.yaml").write_text(
            cli_yaml(res, mode, stages, CLI_CUTS["occ_warmup_steps"], work / run))
    print(f"cli: the reference-format scene ({n_train} train + {n_val} val + {n_test} test "
          f"views at {res}x{res}, calib and coord cube images) written in {dataset_s:.2f} s; "
          f"Config() model and sampler widths; cuts: stages {CLI_CUTS['importance stages']} "
          f"(importance) and {CLI_CUTS['grid stages']} (grid) of the protocol's (20, 16, 16), "
          f"occ_warmup_steps {CLI_CUTS['occ_warmup_steps']} of 3000, ckpt_max_keep "
          f"{CLI_CUTS['ckpt_max_keep']} of 5, {res}x{res} images of 800x800, {n_train} train "
          f"views ({n_train * 50} steps an epoch)", flush=True)

    with cli_recording(work, name, counters) as (cli, calls, cache_s, _, frames):
        state_i, train_s, l_train, eng_i = cli("cli_train", "importance", "--train")
        demo_i, demo_s, l_demo, _ = cli("cli_demo", "importance", "--demo")
        state_g, train_g_s, l_train_g, eng_g = cli("cli_train_grid", "grid", "--train")
        demo_g, demo_g_s, l_demo_g, _ = cli("cli_demo_grid", "grid", "--demo")
        state_r, resume_s, l_resume, eng_r = cli(None, "importance", "--train")

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
    print(f"cli: detection cache built by the engine in {cache_s[0]:.3f} s; equals "
          f"make_dataset's; {int(built['calib_valid'].sum())} calib and "
          f"{int(built['coord_valid'].sum())} coord tags detected; coord keypoints within "
          f"{kp_err:.3f} px of the ground-truth projection ({smi})", flush=True)
    if not kp_err <= 1.0:
        fail(f"a detected coord keypoint lies {kp_err:.3f} px from its projection (bound 1)")

    summary = {"dataset_s": dataset_s, "cache_build_s": cache_s[0], "keypoint_err_px": kp_err}
    for run, eng, state, t_s, launches in (("importance", eng_i, state_i, train_s, l_train),
                                           ("grid", eng_g, state_g, train_g_s, l_train_g)):
        stages = runs[run][0]
        total, spe = sum(stages), eng.steps_per_epoch
        nerf_steps = spe * (stages[1] + stages[2])
        for h in eng.history:
            print(f"cli {run} {STAGE_NAMES[h['stage']]} {h['epoch']}: loss {h['loss']:.6f} "
                  f"rgb_f {h['loss_rgb_f']:.5f}; {h['seconds']:.3f} s "
                  f"({h['seconds'] / spe * 1e3:.2f} ms a step)"
                  + (f"; val PSNR {h['val_psnr']:.3f} SSIM {h['val_ssim']:.4f}"
                     if "val_psnr" in h else "") + f" ({smi})", flush=True)
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
        print(f"cli {run} --train: {t_s:.2f} s ({total} epochs, {spe} steps an epoch); "
              f"checkpoints kept {eng.ckpt.epochs()}, pose plots {plots}; launches {launches}",
              flush=True)
        if eng.ckpt.epochs() != want:
            fail(f"cli {run}: checkpoints kept {eng.ckpt.epochs()}, the retention keeps {want}")
        if plots != sorted(f"epoch_{e}.png" for e in range(total)):
            fail(f"cli {run}: pose plots {plots}, one per camera table wanted")
        summary[run] = {"train_s": t_s, "steps_per_epoch": spe, "nerf_steps": nerf_steps,
                        "epochs": eng.history, "steps_by_route": routes,
                        "host_nerf_steps": sum(host_steps(eng._epoch_fns[st].counts)
                                               for st in (1, 2) if st in eng._epoch_fns)}
    # the wrappers count the warm-ups' and the captures' launches; the
    # replays run the captured ones again without them, which the profiler
    # counts in one replay of each step graph
    host_i, host_g = summary["importance"]["host_nerf_steps"], summary["grid"]["host_nerf_steps"]
    if not (l_train["render_bwd_points"] == l_train["render_bwd_weights"] == 2 * host_i
            and l_train["fused_render"] > 2 * host_i and l_train["fused_mlp_apply"] > 0
            and l_train["sample_pdf_cuda"] > 2 * host_i
            and l_train["fused_shaded_mlp"] == l_train["fused_shaded_mlp_bwd"] == 0):
        fail(f"cli_train launches {l_train} ({host_i} NeRF steps of warm-up and capture)")
    if not (l_train_g["fused_shaded_mlp_bwd"] == 2 * host_g
            and l_train_g["fused_shaded_mlp"] > 2 * host_g and l_train_g["fused_mlp_apply"] > 0
            and l_train_g["fused_render"] == l_train_g["render_bwd_points"]
            == l_train_g["sample_pdf_cuda"] == 0):
        fail(f"cli_train_grid launches {l_train_g} ({host_g} NeRF steps of warm-up and "
             "capture)")
    graph_launches, summary["per_replay"] = {}, {}
    for path, eng, wrappers in (
            ("cli_train", eng_i, ("fused_render", "render_bwd_points", "render_bwd_weights",
                                  "sample_pdf_cuda")),
            ("cli_train_grid", eng_g, ("fused_shaded_mlp", "fused_shaded_mlp_bwd"))):
        graph_launches[path], summary["per_replay"][path] = replayed_launches(
            eng, path, wrappers, {0: 0, 1: 2, 2: 2}, csrc_kernel_names())
    for path, result, dt, launches, kernels in (
            ("cli_demo", demo_i, demo_s, l_demo, ("fused_mlp_apply", "fused_render",
                                                  "sample_pdf_cuda")),
            ("cli_demo_grid", demo_g, demo_g_s, l_demo_g, ("fused_mlp_apply", "fused_shaded_mlp"))):
        print(f"{path}: {result} in {dt:.2f} s ({smi}); launches {launches}", flush=True)
        if not (result["count"] == n_test and math.isfinite(result["psnr"])
                and math.isfinite(result["ssim"])):
            fail(f"{path} result is not finite: {result}")
        if sorted(n for n, v in launches.items() if v) != sorted(kernels):
            fail(f"{path} launches {launches}, only {kernels} wanted")
        summary[path] = {"seconds": dt, "psnr": result["psnr"], "ssim": result["ssim"]}
    # every frame on the graph route: one capture a renderer, a replay a frame
    for path, kernels, n_frames in (
            ("cli_train", ("fused_mlp_apply", "fused_render", "sample_pdf_cuda"),
             sum(runs["importance"][0][1:])),
            ("cli_demo", ("fused_mlp_apply", "fused_render", "sample_pdf_cuda"), n_test),
            ("cli_train_grid", ("fused_mlp_apply", "fused_shaded_mlp"), sum(runs["grid"][0][1:])),
            ("cli_demo_grid", ("fused_mlp_apply", "fused_shaded_mlp"), n_test)):
        fr = frames[path]
        print(f"{path}: frames by route {fr['routes']}, launches in the frame graphs' replays "
              f"{fr['launches']}", flush=True)
        if (fr["routes"] != [{"captured": 1, "replayed": n_frames, "looped": 0}]
                or sorted(k for k, v in fr["launches"].items() if v) != sorted(kernels)):
            fail(f"{path}: frames by route {fr['routes']} ({n_frames} replays of one capture "
                 f"wanted), launches in their replays {fr['launches']} ({kernels} wanted)")
    summary["frames"] = frames
    print(f"cli resumed --train: {resume_s:.2f} s, epochs trained {len(eng_r.history)}, step "
          f"{int(state_r.step)}; launches {l_resume}", flush=True)
    if eng_r.history or state_r.step != state_i.step or any(l_resume.values()):
        fail("the resumed CLI run trained again")
    summary["resume_s"] = resume_s

    # every counted launch is a recorded call, on the path it was counted on
    counted = {"cli_train": l_train, "cli_demo": l_demo, "cli_train_grid": l_train_g,
               "cli_demo_grid": l_demo_g}
    check_recorded(calls, counted)
    shutil.rmtree(work, ignore_errors=True)
    summary["seconds"] = time.perf_counter() - t_phase
    print(f"cli phase: {summary['seconds']:.1f} s", flush=True)
    return {"summary": summary, "calls": calls, "nerf": eng_i.cfg.nerf, "launches": counted,
            "graph_launches": graph_launches,
            "frame_launches": {path: fr["launches"] for path, fr in frames.items()}}


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

    t_phase = time.perf_counter()
    work = pathlib.Path(__file__).resolve().parent / "build" / f"cli_cf_smoke_{os.getpid()}"
    shutil.rmtree(work, ignore_errors=True)
    res, (n_train, n_val, n_test), name = ENGINE_RES, CLI_VIEWS, "Ball_Cf"
    t0 = time.perf_counter()
    make_dataset(str(work / "data" / name), n_train=n_train, n_val=n_val, n_test=n_test,
                 img_h=res, img_w=res, seed=SEED, calibration_mode="rendered")
    dataset_s = time.perf_counter() - t0
    os.remove(work / "data" / name / CACHE_NAME)
    stages, warmup = CLI_CF["stages"], CLI_CUTS["occ_warmup_steps"]
    for run, extra in (("cf", CLI_CF["train"]), ("density", CLI_CF["density demo"])):
        (work / f"config_{run}").mkdir(parents=True)
        (work / f"config_{run}" / "config.yaml").write_text(
            cli_yaml(res, "importance", stages, warmup, work / "cf", extra))
    print(f"cli_cf: the reference-format scene ({n_train} + {n_val} + {n_test} views at "
          f"{res}x{res}) written in {dataset_s:.2f} s; Config() widths, {CLI_CF['train']}, "
          f"stages {stages} of (20, 16, 16), occ_warmup_steps {warmup} of 3000", flush=True)

    lpips_seen = []
    lpips_fn = engine_module.lpips

    def timed_lpips(pred, gt, *a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = lpips_fn(pred, gt, *a)
        lpips_seen.append((pred.detach().cpu(), gt.detach().cpu(), out,
                           time.perf_counter() - t))
        return out

    env = os.environ.get(lpips_net.ENV_VAR)
    with tempfile.TemporaryDirectory() as tmp, \
            cli_recording(work, name, counters) as (cli, calls, cache_s, epochs, frames):
        weights = os.path.join(tmp, "lpips_alex_seeded.npz")
        lpips_weights(weights)
        state, train_s, l_train, eng = cli("cli_train_cf", "cf", "--train")
        os.environ[lpips_net.ENV_VAR] = weights
        engine_module.lpips = timed_lpips
        try:
            demo_cf, demo_s, l_demo, _ = cli("cli_demo_cf", "cf", "--demo")
        finally:
            engine_module.lpips = lpips_fn
            if env is None:
                os.environ.pop(lpips_net.ENV_VAR)
            else:
                os.environ[lpips_net.ENV_VAR] = env
        demo_d, demo_d_s, l_density, eng_d = cli("cli_demo_density", "density", "--demo")
        lpips_cpu = [float(lpips_net.lpips_distance(lpips_net.load(weights), p, g))
                     for p, g, _, _ in lpips_seen]

    nc = eng.cfg.nerf
    if not (nc.coarse_free and nc.coarse_free_from_stage == 2 and nc.occ_map_dtype == "bitpack"
            and nc.cf_uniform_samples == 8 and eng_d.cfg.nerf.occ_pmf == "density"):
        fail(f"the coarse-free CLI configs were not read: {nc}, {eng_d.cfg.nerf}")
    spe = eng.steps_per_epoch
    summary = {"dataset_s": dataset_s, "cache_build_s": cache_s[0], "train_s": train_s,
               "steps_per_epoch": spe, "epochs": eng.history, "step_ms": {}, "rays_per_s": {}}
    for h in eng.history:
        stage = STAGE_NAMES[h["stage"]]
        summary["step_ms"][stage] = h["seconds"] / spe * 1e3
        summary["rays_per_s"][stage] = h["rays_per_s"]
        print(f"cli_cf {stage} {h['epoch']}: loss {h['loss']:.6f} rgb_c {h['loss_rgb_c']:.5f} "
              f"rgb_f {h['loss_rgb_f']:.5f}; {h['seconds']:.3f} s ({h['seconds'] / spe * 1e3:.2f}"
              f" ms a step, {h['rays_per_s']:.0f} rays/s)"
              + (f"; val PSNR {h['val_psnr']:.3f}" if "val_psnr" in h else "") + f" ({smi})",
              flush=True)
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
    graph_launches, summary["per_replay"] = replayed_launches(
        eng, "cli_train_cf", wrappers, per_step, csrc_kernel_names())
    # the validation frames: the wrappers count a chunk of warm-up and the
    # capture's chunks, once (every validation renders coarse-free on the
    # bitpacked map: one graph); the profiler a chunk's launch a replay.
    # A coarse-free chunk: one draw from the map's PMF, K2 on it
    eval_wrappers = ("fused_render", "sample_pdf_cuda")
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
        if not (launches["fused_render"] > 0
                and launches["sample_pdf_cuda"] == launches["fused_render"]
                and all(v == 0 for k, v in launches.items() if k not in eval_wrappers)
                and fr["routes"] == [{"captured": 1, "replayed": n_test, "looped": 0}]
                and all(fr["launches"][k] == chunks * n_test for k in eval_wrappers)
                and all(v == 0 for k, v in fr["launches"].items() if k not in eval_wrappers)):
            fail(f"{path} launches {launches}, in its frame graphs' replays {fr['launches']}, "
                 f"frames by route {fr['routes']}: {eval_wrappers} alike and only (K1 never) "
                 "wanted")
    print(f"cli_train_cf: {train_s:.2f} s; launches {l_train} (by epoch {trained}, validation "
          f"{val}); cache built in {cache_s[0]:.3f} s", flush=True)

    # the coarse MLP: moved by GLOBAL_OPTIM, frozen through FINE_TUNE
    flat = {e: torch.load(os.path.join(eng.ckpt_dir, str(e), "state.pt"),
                          weights_only=True)["p_flat"] for e in range(3)}
    n_cam = sum(p.numel() for p in eng.state.params.cam.parameters())
    coarse = slice(n_cam, n_cam + sum(p.numel() for p in eng.state.params.nerf.coarse.parameters()))
    frozen = torch.equal(flat[1][coarse], flat[2][coarse])
    if not frozen or torch.equal(flat[0][coarse], flat[1][coarse]):
        fail("cli_cf: the coarse MLP moved in FINE_TUNE, or stood still in GLOBAL_OPTIM")

    # the demos, and LPIPS on the card against the CPU's fp32 value
    for path, result, dt in (("cli_demo_cf", demo_cf, demo_s), ("cli_demo_density", demo_d,
                                                                demo_d_s)):
        print(f"{path}: {result} in {dt:.2f} s ({smi})", flush=True)
        if not (result["count"] == n_test and math.isfinite(result["psnr"])
                and math.isfinite(result["ssim"])):
            fail(f"{path} result is not finite: {result}")
    if demo_d["lpips"] is not None:
        fail("cli_demo_density scored LPIPS without a weights file")
    card = [lp for _, _, lp, _ in lpips_seen]
    rel = [abs(a - b) / abs(b) for a, b in zip(card, lpips_cpu)]
    print(f"cli_demo_cf LPIPS (seeded random weights) per view on the card {card}, on the CPU "
          f"{lpips_cpu}: relative error {max(rel):.3e} (bound {LPIPS_RTOL}); "
          f"{sum(t for *_, t in lpips_seen) * 1e3:.1f} ms over {len(card)} views", flush=True)
    if len(card) != n_test or demo_cf["lpips"] is None or not max(rel) <= LPIPS_RTOL:
        fail(f"cli_demo_cf LPIPS {demo_cf['lpips']}: card {card} against CPU {lpips_cpu}")

    counted = {"cli_train_cf": l_train, "cli_demo_cf": l_demo, "cli_demo_density": l_density}
    check_recorded(calls, counted)
    shutil.rmtree(work, ignore_errors=True)
    summary.update({"demo_cf_s": demo_s, "demo_density_s": demo_d_s,
                    "demo_cf": {k: demo_cf[k] for k in ("psnr", "ssim", "lpips")},
                    "demo_density": {k: demo_d[k] for k in ("psnr", "ssim")},
                    "lpips_card": card, "lpips_cpu": lpips_cpu, "lpips_rel_err": max(rel),
                    "lpips_s": sum(t for *_, t in lpips_seen), "coarse_frozen": frozen,
                    "launches_by_epoch": trained, "steps_by_route": routes,
                    "validation_launches": val, "frames": frames,
                    "seconds": time.perf_counter() - t_phase})
    print(f"cli_cf phase: {summary['seconds']:.1f} s", flush=True)
    return {"summary": summary, "calls": calls, "nerf": nc, "launches": counted,
            "nerf_steps": spe * sum(stages[1:]),
            "graph_launches": {"cli_train_cf": graph_launches},
            "frame_launches": {path: fr["launches"] for path, fr in frames.items()}}


def nccl_kinds(dev, world: int, reduces: list) -> dict:
    """This rank's part of the data-parallel step kinds over NCCL: for
    each of ``GRAPH_KINDS``, on the workload of ``graph_phase``
    (``Config()`` widths, 7000 rays a rank: each rank keeps its image of
    the global batch), epochs of ``DP_STEPS`` steps from one state and
    seed through the loop and through the graph route (``graph=True``:
    one graph a step, its collectives captured in it), the first of each
    untimed (the graph's warm-up and capture), then four timed in turns
    (``routes_in_turns``) and one of each under the profiler
    (``profile_routes``: the graph route's is its replays); then the
    graph is released (``StageEpoch.release``).  ``reduces``
    is the list the rank's timed gradient all-reduce appends to (numel,
    bytes an element, the host's wait for the card before it, its own
    seconds, the end): each route's timed epochs' entries are kept.
    Returns {kind: the routes' ms a step in turns, the graph route's
    state against the loop's (the gap, bit for bit), the sha256 of each
    route's last state (p_flat, mu, nu, count, step), the profiled
    launches a step of each kernel of csrc/, busy shares, NCCL kernel ms
    a step, the all-reduces and the route}."""
    from mc_nerf_torch.tools.profile_step import profile_routes, routes_in_turns
    from mc_nerf_torch.tools.scene import TOTAL_STEPS
    from mc_nerf_torch.train.steps import make_stage_epoch

    names, n, out = csrc_kernel_names(), DP_STEPS, {}
    for kind, (stage, train_kw, nerf_kw) in GRAPH_KINDS.items():
        torch.cuda.reset_peak_memory_stats(dev)
        cfg, state, data, txs, live = kind_workload(dev, stage, train_kw, nerf_kw)
        p_flat = state.p_flat
        start = [t.clone() for t in live]
        gen = torch.Generator(device=dev)
        eps = {route: make_stage_epoch(cfg, stage, txs[stage], 800, 800, TOTAL_STEPS, n, world,
                                       graph=route == "graph")
               for route in ("loop", "graph")}
        route_of = {id(ep): route for route, ep in eps.items()}
        runs = []

        def reset():
            with torch.no_grad():
                for t, v in zip(live, start):
                    t.copy_(v)
            gen.manual_seed(SEED + 1)

        def run(ep):
            i = len(reduces)
            m = ep(state, data, gen)
            runs.append((route_of[id(ep)], [r for r in reduces[i:] if r[0] == p_flat.numel()]))
            if not all(math.isfinite(float(v)) for v in m.values()):
                fail(f"kinds {kind}: epoch metrics not finite: {m}")

        first, timed = routes_in_turns(eps, run, n, reset, lambda: [t.clone() for t in live])
        ends = {route: [first[route]] + [kept for _, kept in timed[route]] for route in eps}
        turns = {route: [ms for ms, _ in v] for route, v in timed.items()}
        gap = max(float((x.double() - y.double()).abs().max())
                  for e in ends["graph"] for x, y in zip(e, ends["loop"][0]))
        same = all(torch.equal(x, y) for e in ends["graph"] + ends["loop"]
                   for x, y in zip(e, ends["loop"][0]))
        timed_runs = runs[len(eps):]
        prof = profile_routes(eps, run, n, names)
        for p in prof.values():
            p["nccl_ms"] = sum(ms for ms, _, nm in p.pop("rows") if "nccl" in nm.lower())
        grad = {route: [r for rt, rs in timed_runs if rt == route for r in rs] for route in eps}
        out[kind] = {
            "stage": stage, "turns_ms": turns, "gap": gap, "bit_identical": same,
            "digests": {route: [digest(t) for t in e[-1]] for route, e in ends.items()},
            "named_a_step": {r: p["named_a_step"] for r, p in prof.items()},
            "profiles": prof, "counts": {r: dict(ep.counts) for r, ep in eps.items()},
            "route": eps["graph"].route(dev), "grad_bytes": p_flat.numel() * 4,
            "peak_gib": torch.cuda.max_memory_reserved(dev) / 2**30,
            "grad_reduces": {r: len(v) / (2 * n) for r, v in grad.items()},
            "grad_wait_ms": {r: float(np.median([x[2] for x in v])) * 1e3 if v else None
                             for r, v in grad.items()},
            "grad_reduce_ms": {r: float(np.median([x[3] for x in v])) * 1e3 if v else None
                               for r, v in grad.items()}}
        eps["graph"].release()
        del eps, state, data, live, start
        torch.cuda.empty_cache()
    return out


def dp_rank(spec: dict) -> None:
    """One rank of ``dp_phase`` (``spec["cli"]``) or of ``nccl_phase``
    (``spec["kinds"]``), started with torchrun's environment (``python3
    chip_smoke.py --dp-rank <spec>``).  Joins the group
    (``initialize_distributed``: the rank's card by the device rule, the
    backend by the backend rule) and times the step's gradient all-reduce
    (``steps.all_reduce_mean_``: the host's wait for the card before it,
    then the all-reduce itself, the card synchronized on each side; under
    capture, where NCCL's is captured in the step's graph, untimed).
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
                                        sample_pdf_cuda)}
    reduces, written = [], []
    mean_, write = steps_module.all_reduce_mean_, engine_module._write_pngs

    def timed_mean_(t):
        if torch.cuda.is_current_stream_capturing():
            return mean_(t)
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = mean_(t)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        reduces.append((t.numel(), t.element_size(), t1 - t0, t2 - t1, t2))
        return out

    def recorded_write(dirs, i, *a):
        written.append(i)
        return write(dirs, i, *a)

    steps_module.all_reduce_mean_, engine_module._write_pngs = timed_mean_, recorded_write
    out = {"rank": topo.rank, "world": topo.world, "backend": dist.get_backend(),
           "device": str(topo.device), "current_device": torch.cuda.current_device()}
    try:
        if spec.get("kinds"):
            t0 = time.perf_counter()
            out["kinds"] = nccl_kinds(topo.device, topo.world, reduces)
            out["kinds_s"] = time.perf_counter() - t0
        calls = {}
        if spec.get("cli"):
            with cli_recording(work, spec["name"], counters) as (cli, calls, cache_s, epochs,
                                                                 frames):
                state, train_s, l_train, eng = cli("dp_train", "dp", "--train")
                demo, demo_s, l_demo, _ = cli("dp_demo", "dp", "--demo")
            grads = [(n * size, wait, dt, end) for n, size, wait, dt, end in reduces
                     if n == state.p_flat.numel()]
            out.update({
                "steps_per_epoch": eng.steps_per_epoch, "step": int(state.step),
                "history": eng.history, "epochs": epochs, "final_occ": digest(eng._occ_map),
                "train_s": train_s, "demo_s": demo_s,
                "launches": {"dp_train": l_train, "dp_demo": l_demo}, "frames": frames,
                "routes": {s: ep.route(topo.device) for s, ep in eng._epoch_fns.items()},
                "demo": demo, "written": written, "cache_builds": len(cache_s),
                "kept": eng.ckpt.epochs(), "grad_reduces": len(grads),
                "p_flat_bytes": state.p_flat.numel() * state.p_flat.element_size(),
                "grad_reduce_bytes": grads[0][0] if grads else 0,
                "grad_wait_ms": [wait * 1e3 for _, wait, _, _ in grads],
                "grad_reduce_ms": [dt * 1e3 for _, _, dt, _ in grads],
                "grad_reduce_end_s": [end for *_, end in grads]})
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
    each (mode, side) of ``cells`` (``frame_cell``, as ``frame_graph_phase``
    renders them).  For each: the split frame against this rank's own
    one-process frame in chunks of a block (``world=1``, no collective: the
    same rays in the same groups), bit for bit, and its digest, which the
    ranks must share; the ms a frame of the split frame and of one
    process's graph frame at the full chunk, in turns (split, one, one,
    split; the ranks aligned by a barrier before each); the gather alone
    (median of ``GATHER_ITERS``, the ranks aligned, the card synchronized
    on each side); the split graph's capture seconds and pool; the eval
    kernels' launches a replay of it (profiled, ``replayed_frames``) and in
    the run's replays, and the wrappers' (``counters``, set to 0 just
    before) in its first frame: a block of warm-up and the capture.
    ``record``: (the kernels' recorders' path list, the path to name during
    that first frame).  Returns {"mode side": numbers}."""
    from mc_nerf_torch.parallel.mesh import all_gather_blocks, barrier
    from mc_nerf_torch.train.steps import make_render_fn

    def one(mode, side) -> dict:
        cfg, params, occ, (pose,), K = frame_cell(mode, side, dev)
        split = make_render_fn(cfg, side, side, device=dev, world=world)
        ref = make_render_fn(cfg, side, side, rays_per_chunk=split.block, device=dev)
        whole = make_render_fn(cfg, side, side, device=dev)
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
        same = all(torch.equal(a, b) for a, b in zip(frame, want))
        gap = max(float((a - b).abs().max()) for a, b in zip(frame, want))
        finite = all(bool(torch.isfinite(t).all()) for t in frame)
        turns = in_turns({"split": lambda: split(params, pose, K, occ),
                          "one": lambda: whole(params, pose, K, occ)},
                         ("split", "one", "one", "split"), FRAME_ITERS[side], barrier)
        part = torch.zeros((split.n_chunks * split.block, 5), device=dev)
        gathers = []
        for _ in range(GATHER_ITERS):
            barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            all_gather_blocks(part)
            torch.cuda.synchronize()
            gathers.append(time.perf_counter() - t0)
        total, graphs = replayed_frames([split], f"split {mode} {side}x{side}")
        (replay,) = graphs.values()
        numbers = {
            "bit_identical": same, "gap": gap, "finite": finite,
            "digest": hashlib.sha256("".join(digest(t) for t in frame).encode()).hexdigest(),
            "chunk": split.chunk, "block": split.block, "chunks": split.n_chunks,
            "turns_ms": turns, "split_ms": float(np.mean(turns["split"])),
            "one_ms": float(np.mean(turns["one"])),
            "gather_ms": float(np.median(gathers)) * 1e3,
            "gather_bytes": split.padded * 5 * 4, "capture": split.captures[split.graph_key(occ)],
            "launches_a_replay": replay["per_replay"], "launches": total,
            "launches_counted": counted, "route": split.route(),
            "frames_by_route": dict(split.counts)}
        for r in (split, ref, whole):
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
    gather after its replay (``FrameRender.route``), captured once; each of
    wrapper launched ``FRAME_LAUNCHES[mode]`` times a chunk's block in a
    replay (profiled), and no other.  Prints each cell's ms a frame against one
    process's graph frame, the gather's ms, and each rank's capture seconds,
    pool and launches a replay.  Returns {cell: summary}."""
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
        split_ms, one_ms = max(x["split_ms"] for x in xs), max(x["one_ms"] for x in xs)
        summary = {
            "split_ms": [x["split_ms"] for x in xs], "one_ms": [x["one_ms"] for x in xs],
            "speedup": one_ms / split_ms, "gather_ms": [x["gather_ms"] for x in xs],
            "gather_bytes": xs[0]["gather_bytes"], "gap": [x["gap"] for x in xs],
            "bit_identical": [x["bit_identical"] for x in xs],
            "same_on_every_rank": len({x["digest"] for x in xs}) == 1,
            "capture_s": [x["capture"]["warmup_s"] + x["capture"]["capture_s"] for x in xs],
            "pool_mib": [x["capture"]["pool_mib"] for x in xs],
            "launches_a_replay": [x["launches_a_replay"] for x in xs],
            "launches": [x["launches"] for x in xs],
            "launches_counted": [x["launches_counted"] for x in xs],
            "turns_ms": [x["turns_ms"] for x in xs], "chunk": xs[0]["chunk"],
            "block": xs[0]["block"], "chunks": xs[0]["chunks"], "route": xs[0]["route"]}
        out[cell] = summary
        print(f"{label} split frame, {cell}x{side} over {world} ranks ({summary['chunks']} chunks "
              f"of {summary['chunk']} rays, {summary['block']} a rank): bit-identical to one "
              f"process in chunks of {summary['block']} {summary['bit_identical']}, the same on "
              f"every rank {summary['same_on_every_rank']}; ms a frame by rank "
              f"{', '.join(f'{v:.3f}' for v in summary['split_ms'])} against one process's "
              f"graph frame {', '.join(f'{v:.3f}' for v in summary['one_ms'])} "
              f"({summary['speedup']:.3f}x); the gather of {summary['gather_bytes']} bytes "
              f"{', '.join(f'{v:.3f}' for v in summary['gather_ms'])} ms; capture s "
              f"{', '.join(f'{v:.3f}' for v in summary['capture_s'])}, pool MiB "
              f"{', '.join(f'{v:.1f}' for v in summary['pool_mib'])}; launches a replay "
              f"(profiled) {summary['launches_a_replay']}; route {summary['route']!r} ({smi})",
              flush=True)
        if bad:
            fail(f"{label} split frame {cell}: ranks {bad} stray from the one-process frame, "
                 f"from each other or from the launches ({want} a replay) and route wanted: "
                 f"{[xs[r] for r in bad]}")
    return out


def check_nccl_kinds(ranks: list, one_process: dict, smi: str) -> dict:
    """Checks and prints the step kinds ``nccl_kinds`` ran on each rank of
    ``ranks`` (their ``rank<r>.json``): on every rank the graph route's
    state equal to the loop's bit for bit after every epoch, the same
    bits on every rank, the graph captured once after its warm-up, one
    graph over the ranks, the profiled launches a step of the kernels of
    csrc/ the same on both routes and ``DP_LAUNCHES[kind]`` of each
    wrapper's ``SIGNATURE`` kernel, one gradient all-reduce a step on the
    host in the loop and none outside the graph.  Prints each kind's ms
    a step a rank in turns, busy share, the all-reduce's ms and bytes and
    the global rays/s against ``one_process`` (the graph phase's kinds:
    one process's graph route).  Returns {kind: summary}."""
    from mc_nerf_torch.config import Config
    from mc_nerf_torch.train.steps import WARMUP_STEPS

    out, rays_a_rank = {}, Config().train.rays_per_batch
    for kind, (stage, *_) in GRAPH_KINDS.items():
        xs = [r["kinds"][kind] for r in ranks]
        x = xs[0]
        want = DP_LAUNCHES[kind]
        got = [{k: y["named_a_step"]["graph"].get(k, 0) for k in want} for y in xs]
        bad = [r for r, y in enumerate(xs) if not (
            y["bit_identical"] and y["digests"] == x["digests"]
            and y["counts"]["graph"] == {"warmup": WARMUP_STEPS, "captured": 1,
                                         "replayed": 4 * DP_STEPS, "looped": 0}
            and f"one CUDA graph of the step over {len(xs)} ranks" in y["route"]
            and y["named_a_step"]["graph"] == y["named_a_step"]["loop"] and got[r] == want
            and y["grad_reduces"]["loop"] == 1.0 and y["grad_reduces"]["graph"] == 0.0)]
        ms = {route: [float(np.mean(y["turns_ms"][route])) for y in xs] for route in ("loop",
                                                                                     "graph")}
        rays = rays_a_rank * len(xs) if stage else 0
        one = one_process[kind]["graph_ms"]
        summary = {
            "turns_ms": [y["turns_ms"] for y in xs], "loop_ms": ms["loop"],
            "graph_ms": ms["graph"],
            "busy_share": [{r: p["busy_share"] for r, p in y["profiles"].items()} for y in xs],
            "kernel_ms": [{r: p["kernel_ms"] for r, p in y["profiles"].items()} for y in xs],
            "nccl_ms": [{r: p["nccl_ms"] for r, p in y["profiles"].items()} for y in xs],
            "grad_wait_ms": [y["grad_wait_ms"] for y in xs],
            "grad_reduce_ms": [y["grad_reduce_ms"] for y in xs], "grad_bytes": x["grad_bytes"],
            "gap": [y["gap"] for y in xs], "bit_identical": [y["bit_identical"] for y in xs],
            "launches_a_step": got, "route": x["route"],
            "one_process_graph_ms": one,
            "global_rays_per_s": ({r: rays / max(v) * 1e3 for r, v in ms.items()}
                                  if rays else None),
            "one_process_rays_per_s": rays_a_rank / one * 1e3 if rays else None}
        out[kind] = summary
        turns = "; ".join(f"rank {r} " + ", ".join(f"{v:.3f}" for v in (
            t["loop"][0], t["graph"][0], t["graph"][1], t["loop"][1]))
            for r, t in enumerate(summary["turns_ms"]))
        busy = ", ".join(f"{b['loop']:.3f} / {b['graph']:.3f}" for b in summary["busy_share"])
        reduce = ", ".join(" / ".join(
            "captured" if y["grad_reduce_ms"][r] is None
            else f"{y['grad_wait_ms'][r]:.3f} + {y['grad_reduce_ms'][r]:.3f}"
            for r in ("loop", "graph")) for y in xs)
        # an NCCL kernel waits on the card for every peer: the least over the
        # ranks is the last to arrive's, the all-reduce's own time
        least = {r: min(n[r] for n in summary["nccl_ms"]) for r in ("loop", "graph")}
        summary["nccl_least_ms"] = least
        nccl = (f"; NCCL kernels a step on the card, least over the ranks (loop / graph) "
                f"{least['loop']:.3f} / {least['graph']:.3f} (by rank, waits included: "
                + ", ".join(f"{n['loop']:.3f} / {n['graph']:.3f}" for n in summary["nccl_ms"])
                + ")" if least["loop"] or least["graph"] else "")
        g = summary["global_rays_per_s"]
        print(f"nccl {kind}: ms a step a rank in turns (loop, graph, graph, loop) {turns}: "
              f"loop {max(ms['loop']):.3f}, graph {max(ms['graph']):.3f} "
              f"({max(ms['loop']) / max(ms['graph']):.2f}x); busy share (loop / graph) {busy}; "
              f"gradient all-reduce of {x['grad_bytes']} bytes a step, median ms of the host's "
              f"wait for the card + the all-reduce (loop / graph) {reduce}{nccl}"
              + (f"; global {g['graph']:.0f} rays/s on the graph route ({g['loop']:.0f} on the "
                 f"loop) against one process's graph route "
                 f"{summary['one_process_rays_per_s']:.0f}" if rays else "")
              + f"; graph against loop {summary['gap']} (bit-identical: "
              f"{summary['bit_identical']}); launches a step {got} ({smi})", flush=True)
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
    process in chunks of a block, ms, the gather); then ``torchrun`` itself
    (``python -m torch.distributed.run --standalone``) trains stages
    ``DP_CUTS["launch stages"]`` to the end.  Times: each rank's step ms
    by stage, the host's wait for the card before the gradient all-reduce
    and the all-reduce's ms and bytes, the global rays/s
    against the 1-rank run's, the demo's seconds on 2 ranks and on 1.
    Returns the summary, rank 0's recorded kernel inputs and the
    launches."""
    import os
    import pathlib
    import shutil

    from mc_nerf_torch.config import build_argparser, from_args
    from mc_nerf_torch.data.calibration import CACHE_NAME
    from mc_nerf_torch.data.synthetic import make_dataset
    from mc_nerf_torch.parallel.dryrun import spawn_ranks
    from mc_nerf_torch.train.engine import STAGE_NAMES, Engine

    t_phase = time.perf_counter()
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
    t0 = time.perf_counter()
    spawn_ranks(DP_WORLD, [str(pathlib.Path(__file__).resolve()), "--dp-rank",
                           json.dumps({"work": str(work), "name": name, "cli": True,
                                       "split": "dp"})],
                str(work), env=one_card, timeout=900)
    ranks_s = time.perf_counter() - t0
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
    t0 = time.perf_counter()
    eng1.train()
    torch.cuda.synchronize()
    one_train_s = time.perf_counter() - t0
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
    t0 = time.perf_counter()
    demo1 = Engine(cfg_d, dev).demo()
    torch.cuda.synchronize()
    demo1_s = time.perf_counter() - t0
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
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", str(DP_WORLD), "-m", "mc_nerf_torch",
                           *flags("launch", "--train")], capture_output=True, text=True,
                          env={**os.environ, **one_card}, timeout=900)
    launch_s = time.perf_counter() - t0
    routes = launched_routes(proc.stdout + proc.stderr)
    launch_dir = work / "launch" / "weights" / "train" / name
    launch_kept = sorted(int(n) for n in os.listdir(launch_dir)) if launch_dir.is_dir() else []
    print(f"dp torchrun --nproc_per_node {DP_WORLD} -m mc_nerf_torch --train: rc "
          f"{proc.returncode} in {launch_s:.1f} s; checkpoints {launch_kept}; routes {routes}",
          flush=True)
    if (proc.returncode != 0 or launch_kept != list(range(sum(DP_CUTS["launch stages"])))
            or routes != [GLOO_ROUTE]):
        fail("torchrun's run failed:\n" + proc.stdout[-3000:] + proc.stderr[-6000:])

    # times
    summary = {"ranks_s": ranks_s, "steps_per_epoch": spe, "launch_s": launch_s, "split": split,
               "one_rank_train_s": one_train_s, "demo_s": [x["demo_s"] for x in ranks],
               "one_rank_demo_s": demo1_s, "metric_err": metric_err, "param_err": param_err,
               "param_errs": param_errs, "demo_err": demo_err,
               "grad_reduce_bytes": r0["grad_reduce_bytes"], "step_ms": {}, "rays_per_s": {},
               "grad_reduce_ms": {}, "grad_wait_ms": {}, "median_step_ms": {}, "card": smi}
    for stage in (0, 1, 2):
        sn = STAGE_NAMES[stage]
        epoch = slice(stage * spe, (stage + 1) * spe)     # an epoch's all-reduces
        summary["step_ms"][sn] = {
            "ranks": [x["history"][stage]["seconds"] / spe * 1e3 for x in ranks],
            "one_rank": eng1.history[stage]["seconds"] / spe * 1e3}
        summary["rays_per_s"][sn] = {"ranks": r0["history"][stage]["rays_per_s"],
                                     "one_rank": eng1.history[stage]["rays_per_s"]}
        summary["grad_reduce_ms"][sn] = [float(np.median(x["grad_reduce_ms"][epoch]))
                                         for x in ranks]
        summary["grad_wait_ms"][sn] = [float(np.median(x["grad_wait_ms"][epoch])) for x in ranks]
        # from one gradient all-reduce's end to the next: a step, without
        # the epoch's first (start-up, the other rank's checkpoint)
        summary["median_step_ms"][sn] = [
            float(np.median(np.diff(x["grad_reduce_end_s"][epoch]))) * 1e3 for x in ranks]
        print(f"dp {sn}: step {summary['step_ms'][sn]['ranks'][0]:.2f} / "
              f"{summary['step_ms'][sn]['ranks'][1]:.2f} ms, median "
              f"{summary['median_step_ms'][sn][0]:.2f} / "
              f"{summary['median_step_ms'][sn][1]:.2f} (rank 0 / 1; 1 rank with "
              f"{DP_WORLD} images: {summary['step_ms'][sn]['one_rank']:.2f}), the host's wait "
              f"for the card before the gradient all-reduce median "
              f"{summary['grad_wait_ms'][sn][0]:.3f} / {summary['grad_wait_ms'][sn][1]:.3f} "
              f"ms, the all-reduce {summary['grad_reduce_ms'][sn][0]:.3f} / "
              f"{summary['grad_reduce_ms'][sn][1]:.3f} ms of {r0['grad_reduce_bytes']} bytes, "
              f"global {summary['rays_per_s'][sn]['ranks']:.0f} rays/s (1 rank "
              f"{summary['rays_per_s'][sn]['one_rank']:.0f}) ({smi}; two processes on one "
              f"card: no measure of scaling across cards)", flush=True)
    print(f"dp demo: {summary['demo_s'][0]:.2f} / {summary['demo_s'][1]:.2f} s on 2 ranks, "
          f"{demo1_s:.2f} s on 1 ({smi})", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    summary["seconds"] = time.perf_counter() - t_phase
    print(f"dp phase: {summary['seconds']:.1f} s", flush=True)
    launches = {path: [x["launches"][path] for x in ranks] for path in ("dp_train", "dp_demo")}
    frame_launches = {path: [x["frames"][path]["launches"] for x in ranks]
                      for path in ("dp_train", "dp_demo")}
    # the split frames: each rank's launches in its split graphs' replays
    # (profiled), and the wrappers' in their first frames
    frame_launches["dp_split"] = [{k: sum(c["launches"][k] for c in x["split"].values())
                                   for k in FRAME_SIGNATURE} for x in ranks]
    launches["dp_split"] = [{k: sum(c["launches_counted"][k] for c in x["split"].values())
                             for k in FRAME_SIGNATURE} for x in ranks]
    return {"summary": summary, "calls": calls, "nerf": eng1.cfg.nerf, "launches": launches,
            "frame_launches": frame_launches,
            "by_epoch": [[(stage, n) for path, stage, n, *_ in x["epochs"]
                          if path == "dp_train"] for x in ranks]}


def nccl_phase(smi: str, graph: dict) -> Optional[dict]:
    """NCCL on every card of the machine, where it has two or more:
    ``torchrun --standalone --nproc_per_node <cards>`` (``python -m
    torch.distributed.run``) of ``dp_rank`` without the CLI, one rank a
    card (the backend rule picks NCCL), each running the step kinds
    (``nccl_kinds``): the graph route is one CUDA graph a step, its
    collectives captured in it; then frames split over the ranks
    (``split_frames`` of ``NCCL_SPLIT_CELLS``).  Checks
    (``check_nccl_kinds``): the graph's state equal to the loop's bit for
    bit on every rank and the same on all ranks, one graph a step, the
    launches a step; prints the ms a step of both routes in turns, the
    loop's all-reduce on the host and the NCCL kernels' ms a step on the
    card; (``check_split_frames``) each split frame the same on every rank
    and bit for bit one process's frame in chunks of a block, its ms
    against one process's graph frame, the gather's.  Then ``nccl_cli``.
    With one card it prints that it is skipped and returns None."""
    import os
    import pathlib
    import shutil

    n = torch.cuda.device_count()
    if n < 2:
        print(f"nccl phase: skipped: {n} card (one graph a step over NCCL needs two or more)",
              flush=True)
        return None
    t_phase = time.perf_counter()
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
    kinds = check_nccl_kinds(ranks, graph["kinds"], smi)
    split = check_split_frames(ranks, NCCL_SPLIT_CELLS, smi, "nccl")
    kernels = split_kernels(torch.load(work / "calls.pt", weights_only=False), ranks,
                            "nccl_split")

    launch_s, frames, epochs = nccl_cli(work, n, smi)
    shutil.rmtree(work, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    print(f"nccl phase: {n} cards, {seconds:.1f} s", flush=True)
    return {"cards": n, "kinds": kinds, "split": split, "kernels": kernels,
            "launch_s": launch_s, "launch_frames": frames, "launch_epochs": epochs,
            "seconds": seconds, "card": smi}


def split_kernels(calls: dict, ranks: list, path: str) -> list:
    """The kernels line's entries of a split path: K1, K2, K4 and
    ``sample_pdf_cuda`` held against their plain versions, with the
    planted faults, and timed on the block inputs rank 0 gave them there
    (``calls``, recorded by
    ``split_rank``; ``path_kernel_numbers`` at ``Config()``'s widths, which
    ``frame_cell`` keeps); "launches" those of every rank's split graphs'
    replays (profiled, ``split_frames``), "launches_by_rank" the wrappers'
    in each rank's first frames, "launches_counted" rank 0's.  Fails
    unless each of them was held on the path."""
    from mc_nerf_torch.config import Config

    failures = []
    checked = path_kernel_numbers(calls, Config().nerf, np.random.default_rng(SEED), RENDER_TOL,
                                  MLP_TOL, plants=True, failures=failures)
    if failures:
        fail(f"the {path} kernel checks failed: " + "; ".join(failures))
    if set(checked) != {(path, name) for name in FRAME_SIGNATURE}:
        fail(f"kernels checked on the {path} path {sorted(checked)}")
    kernels = []
    for (_, name), shapes in checked.items():
        numbers = per_launch_over_shapes(shapes)
        replayed = [sum(c["launches"][name] for c in x["split"].values()) for x in ranks]
        kernels.append({"name": name, "path": path, "route": "cuda", "source": SOURCES[name],
                        "replaces": REPLACES[name], **numbers,
                        "launches_by_rank": [sum(c["launches_counted"][name]
                                                 for c in x["split"].values()) for x in ranks],
                        "launches_in_frame_graphs_by_rank": replayed,
                        "launches": sum(replayed), "launches_counted": numbers["launches"]})
    return kernels


def nccl_cli(work, n: int, smi: str, timeout: float = 300.0) -> tuple:
    """``torchrun --standalone --nproc_per_node n -m mc_nerf_torch --train``
    on a seeded scene under ``work`` (``CLI_VIEWS`` at ``ENGINE_RES``,
    the analytic calibration), stages ``DP_CUTS["launch stages"]``: the
    engine over NCCL, one rank a card.  Fails unless it exits 0 within
    ``timeout`` seconds (printing what the ranks wrote if not), keeps
    every checkpoint, logs one graph of the step over the ``n`` ranks and
    renders the validation frames split over the ranks, each rank's blocks
    through one graph, captured while the group and the step graphs live,
    and gathered after its replay.  Returns (its
    seconds, the frames' routes logged, {epoch: its seconds and ms a
    step, from the engine's log})."""
    import os

    from mc_nerf_torch.config import Config
    from mc_nerf_torch.data.synthetic import make_dataset

    name, (n_train, n_val, n_test) = "Ball_Nccl", CLI_VIEWS
    make_dataset(str(work / "data" / name), n_train=n_train, n_val=n_val, n_test=n_test,
                 img_h=ENGINE_RES, img_w=ENGINE_RES, seed=SEED)
    (work / "config").mkdir()
    (work / "config" / "config.yaml").write_text(cli_yaml(
        ENGINE_RES, "importance", DP_CUTS["launch stages"], DP_CUTS["occ_warmup_steps"],
        work / "launch"))
    t0 = time.perf_counter()
    rc, out = torchrun(n, ["-m", "mc_nerf_torch", "--train", "--config", str(work / "config"),
                           "--root_data", str(work / "data"), "--data_name", name], timeout)
    launch_s = time.perf_counter() - t0
    routes = launched_routes(out)
    frames = launched_routes(out, "frames: ")
    launch_dir = work / "launch" / "weights" / "train" / name
    kept = sorted(int(e) for e in os.listdir(launch_dir)) if launch_dir.is_dir() else []
    # the engine's epochs (Engine.history as the log gives it): ms a step
    # from the epoch's seconds, and, in the NeRF stages, from its global
    # rays/s (finer than the seconds' 0.1 s), warm-up and capture included
    spe = CLI_VIEWS[0] * Config().train.steps_per_image_epoch // n
    epochs = {}
    for m in re.finditer(r"(\w+_EPOCH) (\d+) \|.*\| ([\d.]+)s \((\d+) rays/s\)", out):
        stage, epoch, sec, rays = m.group(1), int(m.group(2)), float(m.group(3)), int(m.group(4))
        epochs[epoch] = {"stage": stage, "seconds": sec, "ms_a_step": sec / spe * 1e3,
                         "ms_a_step_by_rays": (n * Config().train.rays_per_batch / rays * 1e3
                                               if rays else None)}
    print(f"nccl torchrun --nproc_per_node {n} -m mc_nerf_torch --train: rc {rc} "
          f"in {launch_s:.1f} s; checkpoints {kept}; routes {routes}; frames {frames}; epochs "
          f"({spe} steps each) {epochs} ({smi})", flush=True)
    if (rc != 0 or kept != list(range(sum(DP_CUTS["launch stages"])))
            or not routes or not all(f"one CUDA graph of the step over {n} ranks" in r
                                     for r in routes)
            or not frames or not all(r.startswith("one CUDA graph of the frame")
                                     and f"split over {n} ranks, one all-gather a frame" in r
                                     for r in frames)):
        fail("nccl: torchrun's run failed:\n" + out[-8000:])
    return launch_s, frames, epochs


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
        seen = {n: sum(c["n"] for c in calls.get((path, n), {}).values())
                for n in ("fused_render", "fused_mlp_apply", "fused_render_bwd",
                          "fused_shaded_mlp", "fused_shaded_mlp_bwd", "sample_pdf_cuda")}
        want = {"fused_render": got["fused_render"], "fused_mlp_apply": got["fused_mlp_apply"],
                "fused_render_bwd": got["render_bwd_points"],
                "fused_shaded_mlp": got["fused_shaded_mlp"],
                "fused_shaded_mlp_bwd": got["fused_shaded_mlp_bwd"],
                "sample_pdf_cuda": got["sample_pdf_cuda"]}
        if seen != want:
            fail(f"{path}: recorded calls {seen} are not the launches counted {got}")


@contextlib.contextmanager
def cli_recording(work, name: str, counters: dict):
    """Instruments ``mc_nerf_torch.main.main`` for a CLI phase and yields
    ``(cli, calls, cache_s, epochs, frames)``.  ``cli(path, run, mode)`` runs
    ``main([mode, "--config", work/config_<run>, ...])`` on the scene
    ``work/data/<name>`` with every count in ``counters`` set to 0 just
    before, and returns (its result, seconds, the launches counted, the
    engine).  While it runs, the kernels' entry points are recorded by
    path and shape into ``calls`` (``engine_recorder``, each shape's last
    call kept: the trained field's, from a train path the tensors of the
    step graph's capture as its last replay left them (the profiled one
    of ``replayed_launches``, after the run); a first NeRF
    step's untrained field composites to the white background whatever
    its MLP computes, and no planted fault there moves K2's rays; K5 where its launch starts, its
    entry point being called inside fused_mlp.py's VJP), the engine's
    detection-cache builds are timed into ``cache_s``, and each training
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
               (nerf_module, "fused_mlp_apply"): lambda a: f"{a[1].shape[0]} points",
               (nerf_module, "fused_shaded_mlp"): lambda a: f"{a[2].shape[0]} rays x {a[5]}",
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
    engines, cache_s = [], []
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

    def timed_build(*a, **kw):
        t = time.perf_counter()
        out = build_cache(*a, **kw)
        cache_s.append(time.perf_counter() - t)
        return out

    engine_module.Engine.train, engine_module.Engine.demo = train, demo
    engine_module.build_calibration_cache = timed_build

    def cli(path, run, mode):
        for c in counters.values():
            c.launches = 0
        where[0] = path
        t = time.perf_counter()
        out = cli_main([mode, "--config", str(work / f"config_{run}"), "--root_data",
                        str(work / "data"), "--data_name", name])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        where[0] = None
        return out, dt, {n: c.launches for n, c in counters.items()}, engines[-1]

    try:
        yield cli, calls, cache_s, epochs, frames
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
    training run: each stage's graph replayed once more after the run
    under the profiler (CUPTI reports a graph's kernel nodes one by one),
    its kernels of ``csrc/`` counted, times the replays the run made
    (``StageEpoch.counts``).  The train state a replay moves is put back
    after each (the generator moves on: the engine reseeds it every
    epoch).  The stages go in the order of their captures, so the
    tensors a recorder keeps of the last one hold what that graph's own
    replay gave its kernels.  Fails unless each of ``wrappers`` launches
    its ``SIGNATURE`` kernel ``per_step[stage]`` times a replay.  Returns
    ({wrapper: launches in the run's replays}, {stage: {kernel of csrc/:
    launches a replay}})."""
    from mc_nerf_torch.tools.profile_step import count_named, profile_steps

    if len({SIGNATURE[w] for w in wrappers}) != len(wrappers):
        fail(f"{path}: {wrappers} share a signature kernel")
    st = eng.state
    live = [st.p_flat, st.step, *(t for o in st.opt_states for t in (o.mu, o.nu, o.count))]
    total, by_stage = dict.fromkeys(wrappers, 0), {}
    for stage, ep in sorted(eng._epoch_fns.items()):
        if ep._cuda_graph is None:
            fail(f"{path}: the stage-{stage} step was not captured")
        saved = [t.clone() for t in live]
        _, rows, _ = profile_steps(ep._cuda_graph.replay, 1)
        with torch.no_grad():
            for t, v in zip(live, saved):
                t.copy_(v)
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
    """The eval kernels' entry points in ``models/nerf.py`` (K1, K2, K4)
    and ``sample_pdf_cuda`` in ``ops/volume.py`` recorded into ``calls``
    while ``where[0]`` names a path (``engine_recorder``, each shape's
    last call); restored on exit."""
    import mc_nerf_torch.models.nerf as nerf_module
    import mc_nerf_torch.ops.volume as volume_module

    wrapped = {(nerf_module, "fused_render"): lambda a: f"{a[2].shape[0]} rays x {a[8]}",
               (nerf_module, "fused_mlp_apply"): lambda a: f"{a[1].shape[0]} points",
               (nerf_module, "fused_shaded_mlp"): lambda a: f"{a[2].shape[0]} rays x {a[5]}",
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


def shaded_numbers(nc, pk, feat, basis16, depth, skips, s, nb, iters: int = 5) -> dict:
    """fused_shaded_mlp (K4) on these inputs: the kernel's ms, the plain
    version's, a bf16 matmul chain's of the same MLP and the bound (the
    MLP's products and the shading's fp32 ones, or feat, basis and the bf16
    pack read, the [P, 8] rows written)."""
    from mc_nerf_torch.ops.cuda.fused_mlp import fused_shaded_mlp, fused_shaded_mlp_plain
    from mc_nerf_torch.tools.bwd_check import needed_macs

    p, enc, rays, pk16 = feat.shape[0], feat.shape[1], basis16.shape[0], bf16_pack(pk)
    t_bound, by = bound(2.0 * needed_macs(nc, depth, pk.trunk_w[0].shape[1], skips, False) * p,
                        p * enc * 2 + rays * 16 * 4 + p * 8 * 4 + pack_bytes(pk16),
                        2.0 * 3 * nb * p)
    a = (pk, feat, basis16, depth, skips, s, nb)
    with torch.no_grad():
        return {"ms": cuda_ms(lambda: fused_shaded_mlp(*a), iters),
                "plain_ms": cuda_ms(lambda: fused_shaded_mlp_plain(*a), 3),
                "library_ms": cuda_ms(lambda: library_mlp(pk16, feat, depth, skips), iters),
                "bound_ms": t_bound, "bound_by": by}


def shaded_bwd_numbers(nc, ws, bs, feat, basis16, dout8, depth, skips, s, nb) -> dict:
    """fused_shaded_mlp_bwd (K5) on these inputs: the kernel's ms, the
    plain backward's, the bf16 torch chain of its products (recompute, dX,
    dW) and the bound (those products and the shading's, or feat, basis,
    dout8 and the pack read, dfeat, dbasis and the fp32 gradients written)."""
    from mc_nerf_torch.ops.cuda.fused_mlp import (
        PackedMLP, fused_shaded_mlp_bwd, fused_shaded_mlp_bwd_plain)
    from mc_nerf_torch.tools.bwd_check import needed_macs

    p, enc, rays = feat.shape[0], feat.shape[1], basis16.shape[0]
    pk = PackedMLP(tuple(ws[:depth]), tuple(bs[:depth]), ws[depth], bs[depth], ws[depth + 1],
                   bs[depth + 1])
    macs = needed_macs(nc, depth, ws[0].shape[1], skips, False)
    t_bound, by = bound(3 * 2.0 * macs * p,
                        p * enc * 2 + rays * 16 * 4 + p * 8 * 4 + pack_bytes(pk)
                        + p * enc * 4 + rays * 16 * 4 + 2 * pack_bytes(pk), 3 * 2.0 * 3 * nb * p)
    dout_b = torch.nn.functional.pad(dout8, (0, 24)).bfloat16()

    def library_bwd():
        library_bwd_dw(*library_bwd_dx(ws, bs, feat, dout_b, depth, skips), dout_b)

    a = (ws, bs, feat, basis16, dout8, depth, skips, s, nb)
    return {"ms": cuda_ms(lambda: fused_shaded_mlp_bwd(*a), 3),
            "plain_ms": cuda_ms(lambda: fused_shaded_mlp_bwd_plain(*a), 2),
            "library_ms": cuda_ms(library_bwd, 3), "bound_ms": t_bound, "bound_by": by}


def path_kernel_numbers(calls: dict, nc, rng, render_tol: dict, mlp_tol: dict,
                        plants: bool = False, failures: list = None) -> dict:
    """Each kernel on each recorded path (``calls``, as ``engine_recorder``
    keeps them), checked and timed on the inputs the path gave it: at every
    shape it was called at, the kernel held against its plain version (the
    tolerances of the other phases; with ``plants``, the planted faults of
    those phases too, each at 2x a tolerance or more), its ms, the plain
    version's, the library call's (none for sample_pdf's) and the bound,
    per launch.  The forward
    kernels are timed over ``ENGINE_ITERS`` calls, after a collection of
    the paths' garbage: on an H100, 5 calls of the engine's fine K2 once
    measured 1.251 ms, 20 calls 0.646 (the train-step phase's K2 0.627
    over 5, on a bf16 pack).  An eval chunk of ``fused_render`` (no
    noise) is held again with its depths spread (``EVAL_SPREAD``).
    Returns {(path, kernel): {shape: numbers with the shape's "launches"
    and "max_abs_err"}}."""
    from mc_nerf_torch.ops.cuda.fused_mlp import (
        PackedMLP, fused_mlp_apply, fused_shaded_mlp, fused_shaded_mlp_bwd,
        fused_shaded_mlp_bwd_plain, fused_shaded_mlp_plain, mlp_plain)
    from mc_nerf_torch.ops.cuda.fused_render import fused_render_bwd, fused_render_bwd_plain
    from mc_nerf_torch.tools.bwd_check import (
        bwd_errs, mixed_in_tiles, pair_swapped, planted_errs, planted_errs_shaded)

    out = {}
    gc.collect()
    for (path, name), shapes in calls.items():
        for shape, rec in shapes.items():
            a, n, label = rec["args"], rec["n"], f"{name} on the {path} inputs ({shape})"
            planted = {}
            if name == "fused_mlp_apply":
                pk, feat, depth, skips = a
                ker = fused_mlp_apply(*a)
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
                hold(label, mlp_errs(ker, ref), mlp_tol, planted, 2.0, failures)
                nums = {name: {**mlp_numbers(nc, *a, iters=ENGINE_ITERS),
                               "max_abs_err": float((ker - ref).abs().max())}}
            elif name == "fused_render":
                with torch.no_grad():
                    e = hold_render(label, a, render_tol, plants, failures,
                                    ("scan one sample late",) if a[4] is None else ())
                    if plants and a[4] is None:
                        z, k = a[3], EVAL_SPREAD
                        hold_render(f"{label}, depths spread {k}x",
                                    (*a[:3], z[:, :1] + (z - z[:, :1]) * k, *a[4:]),
                                    {**render_tol, "depth": DEPTH_ATOL * k}, plants, failures)
                nums = {name: {**render_forward_numbers(nc, a, ENGINE_ITERS),
                               "max_abs_err": max(e.values())}}
            elif name == "fused_shaded_mlp":
                pk, feat, basis16, depth, skips, s, nb = a
                with torch.no_grad():
                    k_out = fused_shaded_mlp(*a)
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
                nums = {name: {**shaded_numbers(nc, *a, iters=ENGINE_ITERS),
                               "max_abs_err": float((k_out - p_out).abs().max())}}
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
                nums = {name: {**shaded_bwd_numbers(nc, *a), "max_abs_err": max_abs(k, ref)}}
                del k, ref
            elif name == "sample_pdf_cuda":
                held = hold_sample_pdf(label, a, plants, failures)
                nums = {name: {**sample_pdf_times(a), **held}}
            else:
                ws, bs, depth = a[0], a[1], a[7]
                k = fused_render_bwd(*a)
                torch.cuda.synchronize()
                ref = fused_render_bwd_plain(*a)
                if plants:
                    planted = planted_errs(a, ref)
                hold(label + " (relative L2)", bwd_errs(k, ref),
                     BWD_TOL["coarse" if depth == nc.coarse_depth else "fine"], planted, 2.0,
                     failures, CLI_WEAK_PLANTS)
                pk = PackedMLP(tuple(ws[:depth]), tuple(bs[:depth]), ws[depth], bs[depth],
                               ws[depth + 1], bs[depth + 1])
                timed = time_backward(nc, {shape: (None, a, pk)}, rng, ws[0].device)
                nums = {kn: {**timed[kn][shape], "max_abs_err": max(
                    float((x - y).abs().max()) for x, y in pairs)}
                        for kn, pairs in (("render_bwd_points", zip(k[2:], ref[2:])),
                                          ("render_bwd_weights", zip([*k[0], *k[1]],
                                                                     [*ref[0], *ref[1]])))}
            for kn, x in nums.items():
                chain = (f", bf16 torch chain {x['library_ms']:.3f}" if "library_ms" in x
                         else "")
                print(f"{kn} on the {path} inputs ({shape}, {n} launches): "
                      f"{x['ms']:.3f} ms (plain {x['plain_ms']:.3f}{chain}, bound "
                      f"{x['bound_ms']:.3f} by {x['bound_by']}), max abs error "
                      f"{x['max_abs_err']:.3e}", flush=True)
                out.setdefault((path, kn), {})[shape] = {**x, "launches": n}
    return out


def per_launch_over_shapes(shapes: dict) -> dict:
    """One kernel's numbers on a path over the shapes it ran at: each time
    and bound the mean per launch (weighted by the launches at each
    shape), the largest error, ``per_shape`` keeping each."""
    n = sum(x["launches"] for x in shapes.values())
    mean = {k: sum(x[k] * x["launches"] for x in shapes.values()) / n
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")
            if all(k in x for x in shapes.values())}
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
    fused_mlp_apply.launches = 0
    fused_shaded_mlp.launches = 0
    t0 = time.perf_counter()
    result = demo(params, split, cfg_g, device=dev, cull=True, render=render)
    torch.cuda.synchronize()
    demo_s = time.perf_counter() - t0
    counted = {"fused_mlp_apply": fused_mlp_apply.launches,
               "fused_shaded_mlp": fused_shaded_mlp.launches}
    replays, _ = replayed_frames([render], "demo_grid")
    launches = {k: replays[k] for k in counted}
    print(f"grid demo: {result} in {demo_s:.2f} s (its capture included); launches in its frame "
          f"graph's replays {launches}, by the wrappers (warm-up and capture) {counted}",
          flush=True)
    if not all(n > 0 for n in (*launches.values(), *counted.values())):
        fail(f"a kernel of the grid demo was not launched: {launches}, {counted}")
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
    return {"launches": launches, "launches_counted": counted, "frame_ms": frame_ms,
            "rays_per_s": h * w / frame_ms * 1e3, "demo_s": demo_s, "result": result,
            "numbers": numbers}


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
    with planted faults; then ms a launch of each kernel and of the plain
    body's forward and backward, and their bound (the logical bytes
    ``portbench/flops_ngp.py`` counts, over the memory rate)."""
    from mc_nerf_torch.models.hashgrid import hash_encode_plain
    from mc_nerf_torch.ops.cuda import hashgrid as hk

    x, table, gate, grid, lo, hi = (rec[k] for k in ("x", "table", "gate", "grid", "lo", "hi"))
    gout, need_x = rec.get("gout"), rec.get("need_x", False)
    fwd = lambda: hk.encode_fwd(x, table, gate, grid, lo, hi)
    bwd = lambda: hk.encode_bwd(x, table, gate, grid, lo, hi, gout, need_x)
    got = (fwd(),) if gout is None else (fwd(), *bwd())
    torch.cuda.synchronize()
    ref = ngp_plain(rec, gout)
    errs = ngp_gaps(got, ref)
    tols = {k: NGP_TOL[k] for k in errs}
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
    p = x.shape[0]
    hold(f"hash encode {path} P={p}", errs, tols,
         {n: ngp_gaps(r, ref) for n, r in plants.items()}, 2.0)
    # the logical bytes of a pass, as portbench/flops_ngp.py counts them
    lf, corners = grid.out_dim, grid.levels * 8 * grid.features * 4
    passes = {"fwd": (fwd, lambda: ngp_plain(rec), p * (12 + corners + 2 * lf))}
    if gout is not None:
        xg = x.clone().requires_grad_(True)
        tg = table.clone().requires_grad_(True)
        with torch.enable_grad():
            feat = hash_encode_plain(xg, tg, gate, grid, lo, hi)
        g = gout.float()
        passes["bwd"] = (bwd, lambda: torch.autograd.grad(feat, (xg, tg) if need_x else (tg,), g,
                                                          retain_graph=True),
                         p * (2 * lf + 2 * corners + 12 + (12 if need_x else 0)))
    numbers = {}
    for kind, (kernel, plain, nbytes) in passes.items():
        b_ms, by = bound(0.0, nbytes)
        numbers[kind] = {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain, 3), "bound_ms": b_ms,
                         "bound_by": by, "points": p,
                         "max_err": {k: v for k, v in errs.items()
                                     if (k == "feat") == (kind == "fwd")}}
        print(f"{NGP_KERNELS[kind]} {path} P={p}: {numbers[kind]['ms']:.4f} ms (bound "
              f"{b_ms:.4f} by {by}; plain {numbers[kind]['plain_ms']:.3f})", flush=True)
    return numbers


def ngp_phase(dev, smi: str) -> dict:
    """The hash-grid field (``nerf.field: hashgrid``) at the train.ngp cell's
    configuration, on its seeded inputs (``NGP_IMAGES`` of its 800x800
    images), through the port's entry points: the occupancy refresh from
    the field, the GLOBAL_OPTIM and FINE_TUNE step graphs
    (``make_stage_epoch``, an epoch of ``NGP_STEPS`` steps on each route)
    and the 800x800 frame graph (``make_render_fn``, against its chunk
    loop: the same bits).  The encode's launches by path:
    ``ops/cuda/hashgrid.py::launches`` zeroed before each, the wrapper's
    counts (one forward and one backward a loop step, the warm-ups' and the
    capture's in a graph epoch, one forward a frame chunk) and the
    profiler's in one replay of each graph.  The first eager call of each
    path is recorded (a capture's are not: its tensors are not computed
    yet), and the kernels are held against the plain body on it
    (``hold_ngp``).  Returns the paths' numbers and the ``kernels``
    entries."""
    from mc_nerf_torch.models.hashgrid import hash_grid
    from mc_nerf_torch.ops.cuda import hashgrid as hk
    from mc_nerf_torch.tools.profile_step import count_named, profile_steps
    from mc_nerf_torch.train.engine import refresh_occupancy
    from mc_nerf_torch.train.optim import build_optimizers
    from mc_nerf_torch.train.steps import WARMUP_STEPS, make_render_fn, make_stage_epoch
    from portbench.program import port_config, train_setup
    from portbench.scene import orbit_views
    from portbench.scene_ngp import make_scene

    t0 = time.perf_counter()
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

    calls, counted, where = {}, {}, [None]
    real = {"fwd": hk.encode_fwd, "bwd": hk.encode_bwd}

    def recorder(kind):
        def call(x, table, gate, grid, lo, hi, *rest):
            rec = calls.setdefault(where[0], {})
            if kind not in rec and not torch.cuda.is_current_stream_capturing():
                keep = lambda t: None if t is None else t.detach().clone()
                rec[kind] = {"x": keep(x), "table": keep(table), "gate": keep(gate),
                             "grid": grid, "lo": lo, "hi": hi}
                if kind == "bwd":
                    rec[kind]["gout"] = keep(rest[0].to(torch.bfloat16))
                    rec[kind]["need_x"] = rest[1] if len(rest) > 1 else True
            return real[kind](x, table, gate, grid, lo, hi, *rest)
        return call

    def counting(path, fn):
        where[0] = path
        hk.launches.update(fwd=0, bwd=0)
        out = fn()
        torch.cuda.synchronize()
        counted[path] = dict(hk.launches)
        return out

    def replayed(replay) -> dict:
        _, rows, _ = profile_steps(replay, 1)
        found = count_named(rows, list(NGP_KERNELS.values()))
        return {k: found.get(n, 0) for k, n in NGP_KERNELS.items()}

    hk.encode_fwd, hk.encode_bwd = recorder("fwd"), recorder("bwd")
    paths = {}
    try:
        occ = counting("ngp_refresh", lambda: refresh_occupancy(field, cfg, dev, 0))
        data = data._replace(occ=occ)
        got = counted["ngp_refresh"]
        print(f"ngp_refresh: the encode's launches (counted) {got}", flush=True)
        if not (got["fwd"] > 0 and got["bwd"] == 0):
            fail(f"ngp_refresh: the encode's launches {got}")
        paths["ngp_refresh"] = {"launches": {"loop": got}}
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for stage, path in ((1, "ngp_train"), (2, "ngp_fine_tune")):
            ep = make_stage_epoch(cfg, stage, txs[stage], h, w, tr["total_steps"], NGP_STEPS,
                                  graph=True)
            m = counting(path, lambda: ep(state, data, gen))
            per_replay = replayed(ep._cuda_graph.replay)
            loop = make_stage_epoch(cfg, stage, txs[stage], h, w, tr["total_steps"], NGP_STEPS,
                                    graph=False)
            counting(path + "_loop", lambda: loop(state, data, gen))
            calls.pop(path + "_loop", None)
            got = {"graph": counted[path], "replay": per_replay, "loop": counted[path + "_loop"]}
            want = {"graph": dict.fromkeys(NGP_KERNELS, WARMUP_STEPS + 1),
                    "replay": dict.fromkeys(NGP_KERNELS, 1),
                    "loop": dict.fromkeys(NGP_KERNELS, NGP_STEPS)}
            metrics = {k: float(v) for k, v in m.items()}
            print(f"{path}: the encode's launches, a graph epoch of {NGP_STEPS} steps (its "
                  f"warm-up and capture, counted) {got['graph']}, a replay (profiled) "
                  f"{per_replay}, a loop epoch (counted) {got['loop']}; metrics {metrics}",
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
        a = counting("ngp_frame", lambda: render(field, pose, K, data.occ))
        b = counting("ngp_frame_loop", lambda: loop(field, pose, K, data.occ))
        calls.pop("ngp_frame_loop", None)
        (g, _, _), = render._graphs.values()
        n = render.n_chunks
        got = {"graph": counted["ngp_frame"], "replay": replayed(g.replay),
               "loop": counted["ngp_frame_loop"]}
        want = {"graph": {"fwd": 1 + n, "bwd": 0}, "replay": {"fwd": n, "bwd": 0},
                "loop": {"fwd": n, "bwd": 0}}
        same = all(torch.equal(u, v) for u, v in zip(a, b))
        rgb_std = float(a[0].float().std())
        print(f"ngp_frame {h}x{w}: the encode's launches, the first frame (a chunk's warm-up "
              f"and the capture, counted) {got['graph']}, a replay (profiled) {got['replay']}, "
              f"the loop (counted) {got['loop']}, over {n} chunks; graph and loop the same "
              f"bits: {same}; rgb std {rgb_std:.4f}", flush=True)
        if got != want:
            fail(f"ngp_frame: the encode's launches {got}, wanted {want}")
        if not (same and rgb_std > NGP_FLAT_STD):
            fail(f"ngp_frame: the frame graph and its loop differ ({not same}) or the frame is "
                 f"flat (rgb std {rgb_std})")
        frame_ms = cuda_ms(lambda: render(field, pose, K, data.occ))
        paths["ngp_frame"] = {"launches": got, "chunks": n, "frame_ms": frame_ms}
        render.release()
    finally:
        hk.encode_fwd, hk.encode_bwd = real["fwd"], real["bwd"]

    kernels = []
    for path, rec in calls.items():
        numbers = hold_ngp(path, rec.get("bwd", rec["fwd"]))
        for kind, x in numbers.items():
            kernels.append({"name": NGP_KERNELS[kind], "path": path, "route": "cuda",
                            "source": "mc_nerf_torch/csrc/hashgrid.cu",
                            "replaces": "none: the JAX package has no hash-grid field",
                            **{f"launches_{k}": v[kind]
                               for k, v in paths[path]["launches"].items()},
                            **x, "library_ms": None})
    wanted = {("ngp_refresh", "hash_encode_fwd_kernel"), ("ngp_frame", "hash_encode_fwd_kernel"),
              *((p, k) for p in ("ngp_train", "ngp_fine_tune") for k in NGP_KERNELS.values())}
    checked = {(e["path"], e["name"]) for e in kernels}
    if checked != wanted:
        fail(f"hash encode: kernels checked on {sorted(checked)}, wanted {sorted(wanted)}")
    seconds = time.perf_counter() - t0
    print(f"ngp phase: {seconds:.1f} s ({smi})", flush=True)
    return {"paths": paths, "kernels": kernels, "seconds": seconds, "card": smi}


def ngp_main() -> None:
    """``python3 chip_smoke.py --ngp``: the build and ``ngp_phase`` alone;
    then its result line, its kernels line and the device line, last."""
    from mc_nerf_torch.ops.cuda import _build

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build_dir = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s into {build_dir}", flush=True)
    ngp = ngp_phase(torch.device("cuda"), smi)
    kernels = ngp.pop("kernels")
    print(json.dumps({"ngp": ngp}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


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
    from mc_nerf_torch.ops.cuda.sample_pdf import sample_pdf_cuda
    from mc_nerf_torch.ops.volume import sample_pdf_plain
    from mc_nerf_torch.tools.bwd_check import mixed_in_tiles, pair_swapped, render_scan_late
    from mc_nerf_torch.tools.scene import LEGO_FOV, orbit_views, scene_params
    from mc_nerf_torch.train.engine import STAGE_NAMES, demo, refresh_occupancy
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
    ngp = ngp_phase(dev, smi)
    gc.collect()
    torch.cuda.empty_cache()

    cfg = Config()
    nc = cfg.nerf
    params = scene_params(nc, SEED, device=dev)
    packed_c, packed_f = pack_eval_params(params, nc)
    print(f"samples per ray at the fine pack, at most: forward {max_samples(packed_f)}, "
          f"backward {max_samples_bwd(packed_f)} (2**31 - 1: no limit)")
    nb = (nc.sh_deg + 1) ** 2
    rng = np.random.default_rng(SEED)
    errs = {"fused_mlp_apply": 0.0, "fused_render": 0.0}   # max abs, for the kernels line
    mlp_tol, render_tol = MLP_TOL, RENDER_TOL

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
    pdf_numbers = sample_pdf_numbers(dev, rng)
    errs["sample_pdf_cuda"] = max(n["max_abs_err"] for n in pdf_numbers.values())

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
    # the demo's frames through the renderer passed in: its first frame
    # warms up one chunk and captures the frame graph, every frame is a
    # replay; the wrappers count the warm-up's and the capture's launches,
    # the profiler those of a replay
    fused_mlp_apply.launches = 0
    fused_render.launches = 0
    sample_pdf_cuda.launches = 0
    t0 = time.perf_counter()
    result = demo(params, split, cfg, device=dev, cull=True, render=render)
    torch.cuda.synchronize()
    demo_s = time.perf_counter() - t0
    demo_counted = {"fused_mlp_apply": fused_mlp_apply.launches,
                    "fused_render": fused_render.launches,
                    "sample_pdf_cuda": sample_pdf_cuda.launches}
    replays, _ = replayed_frames([render], "demo")
    demo_launches = {k: replays[k] for k in demo_counted}
    print(f"demo: {result} in {demo_s:.2f} s (its capture included); launches in its frame "
          f"graph's replays {demo_launches}, by the wrappers (warm-up and capture) "
          f"{demo_counted}", flush=True)
    if not all(n > 0 for n in (*demo_launches.values(), *demo_counted.values())):
        fail(f"a kernel of the main path was not launched: {demo_launches}, {demo_counted}")
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

    # the same frame with sample_pdf's plain body on the card (the chunk
    # loop both times: the renders' draws through sample_pdf_plain): the
    # draws land apart by their sums' rounding, so the bound is the slice
    # chunk's below (two routes whose samples land apart)
    import mc_nerf_torch.models.nerf as nerf_module

    loop = make_render_fn(cfg, h, w, device=dev, graph=False)
    frames = {"kernel": loop(params, poses[1], K, occ)}
    drawn = nerf_module.sample_pdf
    nerf_module.sample_pdf = sample_pdf_plain
    try:
        frames["plain"] = loop(params, poses[1], K, occ)
    finally:
        nerf_module.sample_pdf = drawn
    torch.cuda.synchronize()
    (rgb_k, depth_k, opac_k), (rgb_p, depth_p, opac_p) = frames["kernel"], frames["plain"]
    hold("800x800 frame with sample_pdf's kernel vs with its plain body",
         {"max rgb/opacity": max(float((rgb_k - rgb_p).abs().max()),
                                 float((opac_k - opac_p).abs().max())),
          "max depth/(far-near)": float((depth_k - depth_p).abs().max()) / (nc.far - nc.near),
          "mean rgb": float((rgb_k - rgb_p).abs().mean())},
         {"max rgb/opacity": SLICE_ATOL, "max depth/(far-near)": SLICE_ATOL,
          "mean rgb": SLICE_MEAN_ATOL}, {})

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
    train = train_phase(cfg, dev, h, w, (fused_render, render_bwd_points, render_bwd_weights,
                                         sample_pdf_cuda),
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

    # ---- the compiled epoch: the captured step against the loop, four step kinds
    graph = graph_phase(dev, smi, {k.__name__: k for k in (
        fused_render, render_bwd_points, render_bwd_weights, fused_mlp_apply, fused_shaded_mlp,
        fused_shaded_mlp_bwd)})

    # ---- the compiled frame: the captured frame against the chunk loop, four eval modes
    frame = frame_graph_phase(dev, smi, {k.__name__: k for k in (
        fused_mlp_apply, fused_render, fused_shaded_mlp, sample_pdf_cuda)})

    # ---- the engine: three stages, a resume, the demo from a checkpoint
    engine = engine_phase(dev, smi, {k.__name__: k for k in (
        fused_render, render_bwd_points, render_bwd_weights, fused_mlp_apply, sample_pdf_cuda)})

    # ---- the CLI on a reference-format scene: cache build, both modes, demos
    cli = cli_phase(dev, smi, {k.__name__: k for k in (
        fused_render, render_bwd_points, render_bwd_weights, fused_mlp_apply, fused_shaded_mlp,
        fused_shaded_mlp_bwd, sample_pdf_cuda)})

    # ---- the CLI's coarse-free paths: the hybrid schedule, its demos, LPIPS
    cli_cf = cli_cf_phase(dev, smi, {k.__name__: k for k in (
        fused_render, render_bwd_points, render_bwd_weights, fused_mlp_apply, fused_shaded_mlp,
        fused_shaded_mlp_bwd, sample_pdf_cuda)})

    # ---- data parallelism: 2 ranks on the card through main(), torchrun
    dp = dp_phase(dev, smi)

    # ---- NCCL: one graph a step over the cards, where there are two or more
    nccl = nccl_phase(smi, graph)


    def entry(name, path, launches, numbers):
        return {"name": name, "path": path, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": launches, "max_abs_err": errs[name],
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
                             {**chunk_numbers, "launches_counted": demo_counted[name],
                              "per_pass": {"eval chunk": chunk_numbers}}))
    kernels += [{
        "name": name, "path": "train_step", "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name], "launches": train["launches"][name],
        "launches_per_step": train["launches"][name] / N_TRAIN, "max_abs_err": errs[name],
        **per_launch(train_numbers[name]),
    } for name in ("fused_render", "render_bwd_points", "render_bwd_weights")]
    # the grid paths: the demo (2 frames; times at one eval chunk), the
    # train step (N_TRAIN_GRID steps; per launch, the mean of both passes),
    # the fused_mlp VJP (one launch per pack; the mean of both packs)
    kernels += [entry(name, "demo_grid", grid_demo["launches"][name],
                      {**grid_demo["numbers"][name],
                       "launches_counted": grid_demo["launches_counted"][name],
                       "per_pass": {"grid eval chunk": grid_demo["numbers"][name]}})
                for name in ("fused_mlp_apply", "fused_shaded_mlp")]
    kernels += [{**entry(name, "train_step_grid", grid_train["launches"][name],
                         per_launch(shaded[name])),
                 "launches_per_step": grid_train["launches"][name] / N_TRAIN_GRID}
                for name in ("fused_shaded_mlp", "fused_shaded_mlp_bwd")]
    kernels += [entry(name, "fused_mlp_vjp", vjp["launches"][name], per_launch(vjp[name]))
                for name in ("fused_mlp_apply", "fused_mlp_bwd")]
    # sample_pdf: the demo (its two draws a chunk; times at the frame
    # chunk's two calls) and the train step (its two draws a step; times
    # at the step's two), each the mean of its two calls, kept in per_pass
    frame_pdf = {k: pdf_numbers[k] for k in ("frame coarse", "frame fine")}
    kernels.append(entry("sample_pdf_cuda", "demo", demo_launches["sample_pdf_cuda"],
                         {**per_launch(frame_pdf),
                          "launches_counted": demo_counted["sample_pdf_cuda"]}))
    kernels.append({**entry("sample_pdf_cuda", "train_step", train["launches"]["sample_pdf_cuda"],
                            per_launch({k: pdf_numbers[k]
                                        for k in ("train coarse", "train fine")})),
                    "launches_per_step": train["launches"]["sample_pdf_cuda"] / N_TRAIN})
    # the engine: run A's training steps, its validation renders and the
    # demo, each kernel checked and timed on the inputs the engine gave it.
    # A train path's "launches" are the wrappers' count (the warm-ups, the
    # captures; K1 and K2 in validation), "launches_in_graphs" the launches
    # of the run's replays: what the profiler counted in one replay of each
    # stage's step graph times that graph's replays (replayed_launches); the
    # per-step figures are the latter's
    nerf_steps = engine["steps_per_epoch"] * sum(engine["cuts"]["stages"][1:])
    in_graphs = {**engine["graph_launches"], **cli["graph_launches"], **cli_cf["graph_launches"]}
    # the frames (one graph a frame): an eval path's "launches" are
    # those of its frame graphs' replays, by the profiler (replayed_frames),
    # "launches_counted" the wrappers' (each capture's warm-up chunk and
    # capture); a train path's validation frames add "launches_in_frame_graphs"
    in_frames = {**engine["frame_launches"], **cli["frame_launches"],
                 **cli_cf["frame_launches"], "frame_graph": frame["replayed_launches"]}

    def frame_numbers(path, name, numbers):
        found = in_frames.get(path)
        if found is None:
            return {}
        if "_train" in path:
            return {"launches_in_frame_graphs": found.get(name, 0)}
        return {"launches": found[name], "launches_counted": numbers["launches"]}

    # the frame graph phase's kernels, held on the captured tensors its
    # graphs' last replays wrote, with the planted faults
    failures = []
    frame_checked = path_kernel_numbers(frame["calls"], nc, rng, render_tol, mlp_tol,
                                        plants=True, failures=failures)
    if failures:
        fail("the frame graph phase's kernel checks failed: " + "; ".join(failures))
    if set(frame_checked) != {("frame_graph", n) for n in FRAME_SIGNATURE}:
        fail(f"kernels checked on the frame graph path {sorted(frame_checked)}")
    for (path, name), shapes in frame_checked.items():
        numbers = per_launch_over_shapes(shapes)
        kernels.append({"name": name, "path": path, "route": "cuda", "source": SOURCES[name],
                        "replaces": REPLACES[name], **numbers,
                        **frame_numbers(path, name, numbers)})
    for (path, name), shapes in path_kernel_numbers(engine["calls"], engine["nerf"], rng,
                                                    render_tol, mlp_tol).items():
        numbers = per_launch_over_shapes(shapes)
        graphed = in_graphs.get(path, {}).get(name, 0)
        kernels.append({"name": name, "path": path, "route": "cuda", "source": SOURCES[name],
                        "replaces": REPLACES[name], **numbers,
                        **({"launches_in_graphs": graphed,
                            "launches_per_step": graphed / nerf_steps}
                           if path == "engine_train" else {}),
                        **frame_numbers(path, name, numbers)})
    # the CLI's four paths, each kernel held on the inputs the CLI gave it
    # with the planted faults of the other phases at 2x or more
    failures = []
    cli_numbers = path_kernel_numbers(cli["calls"], cli["nerf"], rng, render_tol, mlp_tol,
                                      plants=True, failures=failures)
    if failures:
        fail("the CLI paths' kernel checks failed: " + "; ".join(failures))
    cli_steps = {"cli_train": cli["summary"]["importance"]["nerf_steps"],
                 "cli_train_grid": cli["summary"]["grid"]["nerf_steps"]}
    for (path, name), shapes in cli_numbers.items():
        numbers = per_launch_over_shapes(shapes)
        graphed = in_graphs.get(path, {}).get(name, 0)
        kernels.append({"name": name, "path": path, "route": "cuda", "source": SOURCES[name],
                        "replaces": REPLACES[name], **numbers,
                        **({"launches_in_graphs": graphed,
                            "launches_per_nerf_step": graphed / cli_steps[path]}
                           if path in cli_steps else {}),
                        **frame_numbers(path, name, numbers)})
    wanted = {("cli_train", n) for n in ("fused_mlp_apply", "fused_render", "render_bwd_points",
                                         "render_bwd_weights", "sample_pdf_cuda")}
    wanted |= {("cli_demo", "fused_mlp_apply"), ("cli_demo", "fused_render"),
               ("cli_demo", "sample_pdf_cuda"),
               ("cli_train_grid", "fused_mlp_apply"), ("cli_train_grid", "fused_shaded_mlp"),
               ("cli_train_grid", "fused_shaded_mlp_bwd"), ("cli_demo_grid", "fused_mlp_apply"),
               ("cli_demo_grid", "fused_shaded_mlp")}
    if wanted - set(cli_numbers):
        fail(f"kernels not checked on their CLI paths: {sorted(wanted - set(cli_numbers))}")
    # the coarse-free paths: K2 and K3 on the inputs the hybrid schedule's
    # two-pass and coarse-free steps, its validation and both demos gave
    failures = []
    cf_numbers = path_kernel_numbers(cli_cf["calls"], cli_cf["nerf"], rng, render_tol, mlp_tol,
                                     plants=True, failures=failures)
    if failures:
        fail("the coarse-free CLI paths' kernel checks failed: " + "; ".join(failures))
    spe = cli_cf["summary"]["steps_per_epoch"]
    for (path, name), shapes in cf_numbers.items():
        numbers = per_launch_over_shapes(shapes)
        # each NeRF stage's launches a step: the profiler's count in one
        # replay of its step graph
        by_stage = ({STAGE_NAMES[stage]: found.get(SIGNATURE[name], 0)
                     for stage, found in cli_cf["summary"]["per_replay"].items() if stage}
                    if path == "cli_train_cf" else None)
        kernels.append({"name": name, "path": path, "route": "cuda", "source": SOURCES[name],
                        "replaces": REPLACES[name], **numbers,
                        **({"launches_in_graphs": in_graphs[path][name],
                            "launches_per_step_by_stage": by_stage} if by_stage else {}),
                        **frame_numbers(path, name, numbers)})
    wanted = {("cli_train_cf", n) for n in ("fused_render", "render_bwd_points",
                                            "render_bwd_weights", "sample_pdf_cuda")}
    wanted |= {(p, n) for p in ("cli_demo_cf", "cli_demo_density")
               for n in ("fused_render", "sample_pdf_cuda")}
    if set(cf_numbers) != wanted:
        fail(f"kernels checked on the coarse-free CLI paths {sorted(cf_numbers)}, "
             f"wanted {sorted(wanted)}")
    # the data-parallel paths: K1, K2 and K3 on the inputs rank 0 gave them;
    # K1, K2, K4 and sample_pdf on rank 0's blocks of the split frames (dp_split)
    failures = []
    dp_numbers = path_kernel_numbers(dp["calls"], dp["nerf"], rng, render_tol, mlp_tol,
                                     plants=True, failures=failures)
    if failures:
        fail("the data-parallel paths' kernel checks failed: " + "; ".join(failures))
    spe = dp["summary"]["steps_per_epoch"]
    for (path, name), shapes in dp_numbers.items():
        numbers = per_launch_over_shapes(shapes)
        by_stage = ({STAGE_NAMES[stage]: n[name] / spe for stage, n in dp["by_epoch"][0]}
                    if path == "dp_train" else None)
        in_frames_by_rank = [f.get(name, 0) for f in dp["frame_launches"][path]]
        kernels.append({"name": name, "path": path, "route": "cuda", "source": SOURCES[name],
                        "replaces": REPLACES[name], **numbers,
                        "launches_by_rank": [n[name] for n in dp["launches"][path]],
                        **({"launches_per_step_by_stage": by_stage} if by_stage else {}),
                        **({"launches_in_frame_graphs_by_rank": in_frames_by_rank}
                           if path == "dp_train" else
                           {"launches": sum(in_frames_by_rank),
                            "launches_counted": numbers["launches"]})})
    wanted = {(p, n) for p in ("dp_train", "dp_demo", "dp_split")
              for n in ("fused_mlp_apply", "fused_render", "sample_pdf_cuda")}
    wanted |= {("dp_train", "render_bwd_points"), ("dp_train", "render_bwd_weights"),
               ("dp_split", "fused_shaded_mlp")}
    if set(dp_numbers) != wanted:
        fail(f"kernels checked on the data-parallel paths {sorted(dp_numbers)}, "
             f"wanted {sorted(wanted)}")
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
    print(json.dumps({"graph": graph}))
    print(json.dumps({"frame_graph": {k: v for k, v in frame.items() if k != "calls"}}))
    print(json.dumps({"cli": cli["summary"], "cli_launches": cli["launches"], "card": smi}))
    print(json.dumps({"cli_cf": cli_cf["summary"], "cli_cf_launches": cli_cf["launches"],
                      "card": smi}))
    print(json.dumps({"dp": dp["summary"], "dp_launches": dp["launches"], "card": smi}))
    if nccl is not None:
        kernels += nccl.pop("kernels")
    print(json.dumps({"nccl": nccl, "card": smi}))
    kernels += ngp.pop("kernels")
    print(json.dumps({"ngp": ngp}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


def nccl_main() -> None:
    """``python3 chip_smoke.py --nccl``: on a machine with two cards or
    more, the build, the graph phase (one process's graph route, what
    the ranks are held to) and ``nccl_phase`` alone; then its result
    line, the kernels line of its split path (``nccl_split``) and the
    device line, last."""
    from mc_nerf_torch.ops.cuda import _build
    from mc_nerf_torch.ops.cuda.fused_mlp import (
        fused_mlp_apply, fused_shaded_mlp, fused_shaded_mlp_bwd)
    from mc_nerf_torch.ops.cuda.fused_render import (
        fused_render, render_bwd_points, render_bwd_weights)

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build_dir = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s into {build_dir}", flush=True)
    graph = graph_phase(torch.device("cuda"), smi, {k.__name__: k for k in (
        fused_render, render_bwd_points, render_bwd_weights, fused_mlp_apply, fused_shaded_mlp,
        fused_shaded_mlp_bwd)})
    nccl = nccl_phase(smi, graph)
    if nccl is None:
        fail("--nccl needs two cards or more")
    kernels = nccl.pop("kernels")
    print(json.dumps({"nccl": nccl, "card": smi}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:     # a rank that dp_phase or nccl_phase starts
        dp_rank(json.loads(sys.argv[2]))
    elif sys.argv[1:2] == ["--nccl"]:
        nccl_main()
    elif sys.argv[1:2] == ["--ngp"]:
        ngp_main()
    else:
        main()
