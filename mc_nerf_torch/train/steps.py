"""Train steps for the three stages and the full-frame render function
(counterpart of ``mc_nerf_tpu/train/steps.py``).

Stage semantics follow ref ``MC_Model.forward`` (``model/mc_nerf.py:58-105``):
  stage 0 (CAM_PARAM):    intr + extr reprojection losses, cameras only;
  stage 1 (GLOBAL_OPTIM): self-normalized intr loss + coarse/fine RGB losses,
                          BARF gate on, everything trains;
  stage 2 (FINE_TUNE):    as stage 1 with BARF off and poses frozen.

Every tensor a step needs is on the device (uint8 images, detections,
parameters); the step's random draws come in as a :class:`StepDraws`,
drawn by :func:`draw_step` from an explicit ``torch.Generator`` on the
device, or built by a test from the JAX package's key tree.  A step
updates the state in place: the parameters, the stage's RAdam moments
and count and the global step are device tensors that keep their
buffers.  The JAX package scans an epoch in one compiled program
(``mc_nerf_tpu/train/steps.py:234-287``); here (:func:`make_stage_epoch`)
each stage's step, its draws included, is captured once as a CUDA graph
and replayed once a step, the metric sums kept on the device to the
epoch's end; over NCCL ranks the graph holds the step's collectives, as
the JAX package's scan holds its ``psum``.  On CPU tensors, and over
gloo ranks (their collectives run on the host), the same step body runs
as a loop.  The frame (:func:`make_render_fn`, the JAX ``jax.jit`` over
``lax.map``) is likewise one CUDA graph on the card, captured once for
each image size and map kind and replayed once a frame; on the CPU, a
loop over its chunks.  Over ranks each chunk's rays are split into rank
blocks and the frame is gathered once after the replay (the JAX
``shard_map`` render).

Data parallelism (``world`` > 1 ranks of the default process group, the
JAX package's ``mesh``): every rank draws the global batch of
``images_per_batch x world`` images from the same generator and keeps its
contiguous block (:func:`rank_block`, the batch JAX shards at
``mc_nerf_tpu/train/steps.py:107-119``), so a run on 2 ranks draws what a
1-rank run with twice the images draws.  The step averages the flat
gradient with one all-reduce; every rank holds the same number of rays,
so the mean of the ranks' RGB means is the global mean, and the
calibration terms are the same on every rank.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mc_nerf_torch import compute_dtype as _dtype
from mc_nerf_torch import resolve_device
from mc_nerf_torch.cameras.projection import reproject_points
from mc_nerf_torch.cameras.rays import pixel_grid, rays_for_pixels
from mc_nerf_torch.config import Config
from mc_nerf_torch.data.calibration import CalibrationData, sample_tags
from mc_nerf_torch.models.camera_params import (
    calib_cube_poses,
    camera_params_from_numpy,
    camera_poses,
    intrinsics,
)
from mc_nerf_torch.models.nerf import (
    RenderDraws,
    draw_render,
    nerf_params_from_numpy,
    pack_eval_params,
    render_rays_eval,
    render_rays_train,
)
from mc_nerf_torch.parallel.mesh import (
    all_gather_blocks,
    all_reduce_max,
    all_reduce_mean_,
    batch_slice,
    collectives_capturable,
    rank,
    world_size,
)
from mc_nerf_torch.train.loss import reprojection_loss, rgb_loss, self_normalized
from mc_nerf_torch.train.optim import (
    FlatOptState,
    FlatRAdam,
    Params,
    counter,
    flat_grads,
    flatten_params,
)


class TrainData(NamedTuple):
    """Device-resident per-scene training tensors.  ``occ`` is the binary
    occupancy map (``ops/occupancy.binary_grid``); None samples the
    coarse pass on the uniform grid."""

    images_u8: torch.Tensor          # [N, H*W, 3] uint8 white-composited train images
    calib: CalibrationData
    occ: Optional[torch.Tensor] = None


@dataclasses.dataclass
class TrainState:
    """Parameters (each a view of ``p_flat``), one optimizer state per
    stage, and the global step (drives BARF progress; a 0-d int32 tensor
    on ``p_flat``'s device, ``optim.counter``).  Steps update it all in
    place."""

    params: Params
    p_flat: torch.Tensor
    opt_states: Tuple[FlatOptState, ...]
    step: torch.Tensor


def _shaped_like(tree, flat: np.ndarray, off: int = 0):
    """The vector ``flat``, from ``off`` on, shaped as ``tree``'s leaves in
    the order ``jax.flatten_util.ravel_pytree`` walks them (NamedTuple
    fields, then sequence items, depth first).  Returns (tree, offset)."""
    if hasattr(tree, "_fields"):
        out = []
        for f in tree._fields:
            leaf, off = _shaped_like(getattr(tree, f), flat, off)
            out.append(leaf)
        return type(tree)(*out), off
    if isinstance(tree, (list, tuple)):
        out = []
        for t in tree:
            leaf, off = _shaped_like(t, flat, off)
            out.append(leaf)
        return type(tree)(out), off
    shape = np.shape(tree)
    n = int(np.prod(shape))
    return flat[off:off + n].reshape(shape), off + n


def train_state_from_numpy(params_np, opt_states_np, step: int, cfg: Config,
                           device=None) -> TrainState:
    """The JAX package's train state as numpy arrays (``Params`` and one
    RAdam ``FlatOptState`` per stage, e.g. ``jax.tree.map(np.asarray, ...)``)
    -> :class:`TrainState`: the parameters through
    ``camera_params_from_numpy`` / ``nerf_params_from_numpy``, each stage's
    ``mu`` / ``nu`` (in ``ravel_pytree`` order there) moved leaf by leaf
    into :func:`flatten_params` order the same way."""
    dev = resolve_device(device)

    def to_port(tree):
        p = Params(camera_params_from_numpy(tree.cam, dev),
                   nerf_params_from_numpy(tree.nerf, cfg.nerf, dev))
        return flatten_params(p), p

    def moved(flat):
        return to_port(_shaped_like(params_np, np.asarray(flat, np.float32))[0])[0]

    p_flat, params = to_port(params_np)
    opts = tuple(FlatOptState(moved(o.mu), moved(o.nu), counter(o.count, dev))
                 for o in opt_states_np)
    return TrainState(params, p_flat, opts, counter(step, dev))


class StepDraws(NamedTuple):
    """The random draws of one step (``train/steps.py`` splits its key
    into k_calib -> (k_int, k_ext), k_rays -> (k_img, k_pix), k_render)."""

    u_int: torch.Tensor                  # [N] U[0,1): the tag of each calib image
    u_ext: torch.Tensor                  # [N] U[0,1): the tag of each coord image
    img_ids: Optional[torch.Tensor]      # [B] int64 images of the batch (stages 1, 2)
    pix_idx: Optional[torch.Tensor]      # [B, R] int64 pixels of each image
    render: Optional[RenderDraws]        # the render's draws, over B * R rays
    # (B = cfg.train.images_per_batch; 1 is the reference's BatchSampler)


def draw_step(cfg: Config, stage: int, n_images: int, img_h: int, img_w: int,
              culled: bool, generator: torch.Generator) -> StepDraws:
    """Draw one step's :class:`StepDraws` from ``generator`` on its device;
    ``culled``: the coarse pass samples an occupancy map; in a coarse-free
    stage the render's draws are the coarse-free render's.  Pixels are drawn with replacement when the image has more than 8x the
    batch's rays (expected collisions ~R^2 / 2HW, as the JAX package
    argues), else without."""
    dev = generator.device
    u_int = torch.rand((n_images,), generator=generator, device=dev)
    u_ext = torch.rand((n_images,), generator=generator, device=dev)
    if stage == 0:
        return StepDraws(u_int, u_ext, None, None, None)
    rays, hw, b = cfg.train.rays_per_batch, img_h * img_w, cfg.train.images_per_batch
    img_ids = torch.randint(0, n_images, (b,), generator=generator, device=dev)
    if hw > 8 * rays:
        pix_idx = torch.randint(0, hw, (b, rays), generator=generator, device=dev)
    else:
        pix_idx = torch.stack([torch.randperm(hw, generator=generator, device=dev)[:rays]
                               for _ in range(b)])
    render = draw_render(b * rays, cfg.nerf, cfg.train.importance_samples, culled, generator,
                         cfg.train.fine_mode, cfg.nerf.coarse_free_at(stage))
    return StepDraws(u_int, u_ext, img_ids, pix_idx, render)


def rank_block(draws: StepDraws, rank: int, world: int) -> StepDraws:
    """Rank ``rank``'s contiguous block of a global batch's draws: its
    images and pixels, and the render draws of their rays.  The
    calibration draws stay whole: the JAX mesh replicates them."""
    if world == 1 or draws.img_ids is None:
        return draws
    rows = batch_slice(draws.img_ids.shape[0], rank, world)
    rays = batch_slice(draws.img_ids.shape[0] * draws.pix_idx.shape[1], rank, world)
    render = RenderDraws(*(None if d is None else d[rays] for d in draws.render))
    return draws._replace(img_ids=draws.img_ids[rows], pix_idx=draws.pix_idx[rows],
                          render=render)


def _calib_losses(params: Params, data: TrainData, draws: StepDraws, img_h: int,
                  img_w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Intrinsic + extrinsic reprojection losses for the step."""
    c = data.calib
    K = intrinsics(params.cam, img_h, img_w)
    w_int, p_int = sample_tags(draws.u_int, c.calib_pts, c.calib_tag_ids, c.calib_counts,
                               c.cube_pts)
    w_ext, p_ext = sample_tags(draws.u_ext, c.coord_pts, c.coord_tag_ids, c.coord_counts,
                               c.cube_pts)
    pred_int = reproject_points(w_int, K, calib_cube_poses(params.cam))
    pred_ext = reproject_points(w_ext, K, camera_poses(params.cam))
    return (reprojection_loss(pred_int, p_int, img_h, img_w),
            reprojection_loss(pred_ext, p_ext, img_h, img_w))


def _sample_ray_batch(params: Params, data: TrainData, draws: StepDraws, img_h: int,
                      img_w: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rays_d, rays_o, gt), each [B*R, 3], for the step's images and
    pixels, on the device; rays only for the sampled pixels."""
    idx = draws.pix_idx                                          # [B, R]
    pix_xy = torch.stack([(idx % img_w).float() + 0.5,
                          torch.div(idx, img_w, rounding_mode="floor").float() + 0.5], -1)
    K = intrinsics(params.cam, img_h, img_w)[draws.img_ids]      # [B, 3, 3]
    pose = camera_poses(params.cam)[draws.img_ids]               # [B, 3, 4]
    rays_d, rays_o = rays_for_pixels(pix_xy, pose, K)            # [B, R, 3]
    gt = data.images_u8[draws.img_ids[:, None], idx].float() / 255.0
    return rays_d.reshape(-1, 3), rays_o.reshape(-1, 3), gt.reshape(-1, 3)


def progress(step: torch.Tensor, total_steps: int) -> torch.Tensor:
    """Training progress, the BARF gate's clock: the step counter over
    ``total_steps`` in float32 on the counter's device (the JAX package's
    ``step.astype(float32) / total_steps``).  A value made on the host
    would be frozen into a captured step."""
    return step.float() / total_steps


def make_loss_fn(cfg: Config, stage: int, img_h: int, img_w: int,
                 total_steps: int, world: int = 1) -> Callable:
    """Per-stage loss: ``(params, data, draws, step) -> (loss, metrics)``.

    ``cfg.train.use_pallas`` picks the render route: None or True renders
    through the hand-written kernels on CUDA (their plain versions on CPU
    tensors): ``fused_render`` in importance mode, ``fused_shaded_mlp`` in
    grid mode (``cfg.train.fine_mode``); False through the plain PyTorch
    route.  The JAX package defaults its train step to XLA because its
    fused backward lost on a TPU; the port's choice rests on the H100
    (PERF.md).  With ``world`` > 1 ranks, the grid mode's selection cutoff
    takes its max over every rank's rays (``all_reduce_max``), as the JAX
    package's max over its mesh does."""
    barf_window = cfg.barf.global_window(cfg.stages)
    use_kernels = cfg.train.use_pallas is not False
    cd = _dtype(cfg.compute_dtype)

    def loss_fn(params: Params, data: TrainData, draws: StepDraws,
                step) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        loss_int, loss_ext = _calib_losses(params, data, draws, img_h, img_w)
        if stage == 0:
            total = loss_int + loss_ext
            zero = torch.zeros_like(total)
            return total, {"loss": total, "loss_intr": loss_int, "loss_extr": loss_ext,
                           "loss_rgb_c": zero, "loss_rgb_f": zero}
        rays_d, rays_o, gt = _sample_ray_batch(params, data, draws, img_h, img_w)
        step_r = progress(torch.as_tensor(step, dtype=torch.int32, device=rays_d.device),
                          total_steps)
        rgb_c, rgb_f = render_rays_train(
            params.nerf, rays_d, rays_o, draws.render, step_r, cfg.nerf, barf_window,
            barf_on=(stage == 1), compute_dtype=cd, fine_mode=cfg.train.fine_mode,
            importance_samples=cfg.train.importance_samples, use_kernels=use_kernels,
            occ=data.occ, remat_shade=cfg.train.remat_shade,
            coarse_free=cfg.nerf.coarse_free_at(stage),
            reduce_max=all_reduce_max if world > 1 else None)
        loss_f = rgb_loss(rgb_f, gt)
        # a coarse-free render has no coarse pass: its loss term drops
        loss_c = torch.zeros_like(loss_f) if rgb_c is None else rgb_loss(rgb_c, gt)
        total = self_normalized(loss_int) + loss_c + loss_f
        return total, {"loss": total, "loss_intr": loss_int, "loss_extr": loss_ext,
                       "loss_rgb_c": loss_c, "loss_rgb_f": loss_f}

    return loss_fn


def make_stage_step(cfg: Config, stage: int, tx: FlatRAdam, img_h: int, img_w: int,
                    total_steps: int, world: int = 1) -> Callable:
    """One step: ``(state, data, draws) -> metrics``: loss, backward,
    the flat gradient (averaged over the ``world`` ranks of the default
    process group), the stage's masked RAdam update of ``state.p_flat``
    and of its optimizer state, and the step's increment, all in place
    on the device.  The metrics are this rank's."""
    if world != world_size():
        raise ValueError(f"a step over {world} ranks in a group of {world_size()}")
    loss_fn = make_loss_fn(cfg, stage, img_h, img_w, total_steps, world)

    def step_fn(state: TrainState, data: TrainData, draws: StepDraws) -> Dict[str, torch.Tensor]:
        for p in state.params.parameters():
            p.grad = None
        total, metrics = loss_fn(state.params, data, draws, state.step)
        total.backward()
        # one all-reduce of the flat gradient (the parameters are views of
        # p_flat: no per-parameter buckets); every rank applies the same update
        g_flat = all_reduce_mean_(flat_grads(state.params))
        tx.update(g_flat, state.opt_states[stage], state.p_flat)
        state.step.add_(1)
        return {k: v.detach() for k, v in metrics.items()}

    return step_fn


# the epoch's metrics, in the order of their sums
METRICS = ("loss", "loss_extr", "loss_intr", "loss_rgb_c", "loss_rgb_f")
# eager steps before a capture: lazy set-up (the kernels' libraries and
# attributes, the cached device constants, the allocator's blocks) must
# not happen under capture; the state is put back after them
WARMUP_STEPS = 3


class StaleGraphBuffer(RuntimeError):
    """A tensor a captured step reads or writes is not the one it was
    captured with: a replay would go on using the old buffer."""


class StageEpoch:
    """One epoch of one stage: ``(state, data, generator) -> mean
    metrics``, each step's draws from ``generator`` (on the device): the
    global batch over ``world`` ranks, of which this rank keeps its block.
    The mean metrics are averaged over the ranks once, at the end: the
    global batch's.

    The metric sums stay on the device (float64) through the epoch: no
    step waits for the host.  ``graph`` picks the route (None: CUDA
    tensors, and one rank or ranks whose collectives a graph captures):

    * the graph route (CUDA; one rank, or NCCL ranks): at the first call, after
      ``WARMUP_STEPS`` eager steps on a side stream whose effects are put
      back (parameters, moments, count, step, the generator's state), one
      step (draws, forward, backward, flat gradient, RAdam update, step
      increment, metric sums) is captured as a ``torch.cuda.CUDAGraph``
      with ``generator`` registered to it, so replay k draws what the k-th
      step of the loop draws; every step is then one replay.  Over NCCL
      ranks the gradient's mean (and the grid mode's cutoff max) is
      captured in the graph; every rank warms up, with real collectives,
      and captures in lockstep.  Before each
      epoch, every buffer the graph reads or writes is checked against
      the one it was captured with (:class:`StaleGraphBuffer`).  A failed
      capture or replay raises: nothing falls back to the loop.
    * the loop (CPU tensors, gloo ranks, or ``graph=False``): the same
      step body, once a step.  Gloo runs a collective on the host, which a
      graph cannot capture, so its ranks take it.

    ``pool`` (``torch.cuda.graph_pool_handle()``) lets the stages' graphs
    share one memory pool: each graph writes every block it uses before
    reading it within a replay, and what outlives a replay (the state,
    the sums) is allocated outside the pool.  :meth:`release` drops the
    graph (over NCCL it holds the group's communicator: release it before
    the group is destroyed).  ``counts`` tallies the steps each way ran:
    "warmup", "captured", "replayed" and "looped"."""

    def __init__(self, cfg: Config, stage: int, tx: FlatRAdam, img_h: int, img_w: int,
                 total_steps: int, steps_per_epoch: int, world: int = 1,
                 graph: Optional[bool] = None, pool=None):
        # NCCL's collectives are captured where the step calls them
        self.in_graph = world == 1 or collectives_capturable()
        if graph and not self.in_graph:
            raise ValueError(f"a step over {world} ranks runs collectives on the host (gloo), "
                             "which a CUDA graph does not capture")
        self.step_fn = make_stage_step(cfg, stage, tx, img_h, img_w, total_steps, world)
        self.draw_cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, images_per_batch=cfg.train.images_per_batch * world))
        self.stage, self.tx, self.img_h, self.img_w = stage, tx, img_h, img_w
        self.world, self.rank = world, rank()
        self.steps_per_epoch = steps_per_epoch
        self.graph, self.pool = graph, pool
        self.counts = dict.fromkeys(("warmup", "captured", "replayed", "looped"), 0)
        self._sums: Optional[torch.Tensor] = None
        self._cuda_graph = None
        self._captured: Dict[str, int] = {}
        self._generator: Optional[torch.Generator] = None

    def uses_graph(self, device: torch.device) -> bool:
        """Whether an epoch on ``device`` takes the graph route."""
        if self.graph is None:
            return device.type == "cuda" and self.in_graph
        if self.graph and device.type != "cuda":
            raise ValueError(f"a CUDA graph needs CUDA tensors, not {device}")
        return self.graph

    def route(self, device: torch.device) -> str:
        """The route an epoch on ``device`` takes, in words."""
        if self.uses_graph(device):
            over = (f" over {self.world} ranks, its collectives captured in it"
                    if self.world > 1 else "")
            return f"one CUDA graph of the step{over}, captured once and replayed once a step"
        why = ("CPU tensors" if device.type != "cuda" else "graph=False" if self.graph is False
               else f"{self.world} gloo ranks: their collectives run on the host")
        return f"the step as a loop ({why})"

    def _sums_on(self, device: torch.device) -> torch.Tensor:
        """The metric sums' buffer, made once, outside any graph's pool."""
        if self._sums is None:
            self._sums = torch.zeros(len(METRICS), dtype=torch.float64, device=device)
        return self._sums

    def _step(self, state: TrainState, data: TrainData, generator: torch.Generator) -> None:
        """The step body both routes run: draws, the step, the sums."""
        draws = draw_step(self.draw_cfg, self.stage, data.images_u8.shape[0], self.img_h,
                          self.img_w, data.occ is not None, generator)
        m = self.step_fn(state, data, rank_block(draws, self.rank, self.world))
        self._sums.add_(torch.stack([m[k] for k in METRICS]).double())

    def buffers(self, state: TrainState, data: TrainData) -> Dict[str, int]:
        """name -> ``data_ptr()`` of every tensor the step reads or writes
        across steps (None for an absent occupancy map)."""
        opt = state.opt_states[self.stage]
        named = {"p_flat": state.p_flat, "step": state.step, "mu": opt.mu, "nu": opt.nu,
                 "count": opt.count, "mask": self.tx.mask, "sums": self._sums,
                 "images_u8": data.images_u8, "occ": data.occ,
                 **{f"calib.{f}": t for f, t in zip(data.calib._fields, data.calib)},
                 **{f"param {n}": p for n, p in state.params.named_parameters()}}
        return {k: None if t is None else t.data_ptr() for k, t in named.items()}

    def check_buffers(self, state: TrainState, data: TrainData,
                      generator: torch.Generator) -> None:
        """Raise :class:`StaleGraphBuffer`, naming the buffer, where a
        tensor of ``state`` or ``data`` (or the generator) is not the one
        the graph was captured with."""
        if generator is not self._generator:
            raise StaleGraphBuffer(f"stage {self.stage}: the generator is not the one its step "
                                   "graph was captured with")
        now = self.buffers(state, data)
        for name, ptr in self._captured.items():
            if now.get(name) != ptr:
                raise StaleGraphBuffer(
                    f"stage {self.stage}: {name} is not the buffer its step graph was captured "
                    f"with (data_ptr {now.get(name)} against {ptr}); write new values into the "
                    "captured buffer in place")

    def capture(self, state: TrainState, data: TrainData, generator: torch.Generator) -> None:
        """Warm up, put the run back, and capture one step (see the class)."""
        dev = state.p_flat.device
        self._sums_on(dev)
        opt = state.opt_states[self.stage]
        live = (state.p_flat, opt.mu, opt.nu, opt.count, state.step)
        saved = [t.clone() for t in live]
        gen_state = generator.get_state()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._step(state, data, generator)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.counts["warmup"] += WARMUP_STEPS
        # the warm-up must not train: every later step would shift
        with torch.no_grad():
            for t, s in zip(live, saved):
                t.copy_(s)
            self._sums.zero_()
        generator.set_state(gen_state)
        for p in state.params.parameters():
            p.grad = None      # the backward writes fresh gradients, never accumulates
        g = torch.cuda.CUDAGraph()
        g.register_generator_state(generator)
        with torch.cuda.graph(g, pool=self.pool, stream=side):
            self._step(state, data, generator)
        self.counts["captured"] += 1
        self._cuda_graph = g
        self.bind(state, data, generator)

    def release(self) -> None:
        """Drop the captured graph and its binding; a later epoch on the
        graph route captures anew."""
        if self._cuda_graph is not None:
            self._cuda_graph.reset()
        self._cuda_graph, self._captured, self._generator = None, {}, None

    def bind(self, state: TrainState, data: TrainData, generator: torch.Generator) -> None:
        """Record the buffers (and the generator) that :meth:`check_buffers`
        holds every later epoch to: those of the capture."""
        self._sums_on(state.p_flat.device)
        self._captured, self._generator = self.buffers(state, data), generator

    def __call__(self, state: TrainState, data: TrainData,
                 generator: torch.Generator) -> Dict[str, torch.Tensor]:
        dev = state.p_flat.device
        graph = self.uses_graph(dev)
        self._sums_on(dev).zero_()
        if graph and self._cuda_graph is None:
            self.capture(state, data, generator)
        n = self.steps_per_epoch
        if graph:
            self.check_buffers(state, data, generator)
            for _ in range(n):
                self._cuda_graph.replay()
            self.counts["replayed"] += n
        else:
            for _ in range(n):
                self._step(state, data, generator)
            self.counts["looped"] += n
        means = (self._sums / n).float()
        return dict(zip(METRICS, all_reduce_mean_(means)))


def make_stage_epoch(cfg: Config, stage: int, tx: FlatRAdam, img_h: int, img_w: int,
                     total_steps: int, steps_per_epoch: int, world: int = 1,
                     graph: Optional[bool] = None, pool=None) -> StageEpoch:
    """One epoch of ``stage``: a :class:`StageEpoch` (``(state, data,
    generator) -> mean metrics``), as a replayed CUDA graph on the card
    (``graph`` None: CUDA, and one rank or NCCL ranks), else as a loop."""
    return StageEpoch(cfg, stage, tx, img_h, img_w, total_steps, steps_per_epoch, world,
                      graph, pool)


class FrameRender:
    """Full-image renderer: ``(nerf_params, pose_w2c [3,4], K [3,3],
    occ=None) -> (rgb [H,W,3], depth [H,W], opacity [H,W])``, fresh tensors
    every call (a caller may keep a frame while it renders the next).

    The frame is the padded pixel grid's rays, the weights packed once,
    fixed-size ray chunks through ``render_rays_eval`` (the last chunk
    padded to full size, so every chunk has the same shapes) and their
    concatenation: the body of the JAX package's ``jax.jit`` over
    ``lax.map`` (``mc_nerf_tpu/train/steps.py:290-362``).

    Split over ``world`` > 1 ranks of the default process group (the JAX
    ``make_render_fn(mesh=...)``'s ``shard_map``, ``:313-343``): the chunk
    is rounded up to a multiple of ``world`` (:func:`split_chunk`), each
    rank renders its contiguous block of every chunk (``batch_slice``, the
    ``P("data")`` block) with the weights, pose and map whole, and one
    gather of every rank's blocks a frame (``all_gather_blocks``) puts the
    frame back together in chunk order on every rank.  A block renders as
    a chunk of its own: the grid mode's cutoff is the block's max, padding
    rays included, as under ``shard_map``, so a frame split over N ranks
    is a one-process frame in chunks of ``chunk / N`` rays.  ``world`` is
    1 or the group's size; 1 under a group renders whole frames with no
    collective.

    ``graph`` picks the route (None: a graph on CUDA, the loop on the
    CPU):

    * the graph route (CUDA): the first frame of each map kind
      (:meth:`graph_key`: no map, or the map's dtype and shape, on which
      the JAX jit recompiles too) runs one chunk (split: this rank's block
      of it) eagerly on a side stream (the kernels' libraries, cached
      device constants and workspaces are made outside any capture), then
      this rank's whole part of the frame is captured as a
      ``torch.cuda.CUDAGraph`` in this renderer's memory pool; every frame
      is then one replay.  A split frame's gather runs after the replay,
      outside the graph, on the current stream, so NCCL and gloo ranks
      alike keep the graph (gloo's collectives run on the host, which no
      graph captures).  The graph owns its inputs: the weights are copied
      into its own copy of the parameters, the pose and K into device
      buffers and the map into the graph's buffer, in place, before each
      replay, so any values a caller passes go in.  A failed capture,
      replay or gather raises: nothing falls back to the loop.
    * the loop (CPU tensors, or ``graph=False``): the same body, eagerly.

    ``cfg.eval.use_pallas`` picks the numeric route: None or True renders
    through the Hopper kernels, False through the plain route in
    ``cfg.compute_dtype``.  ``cfg.eval.fine_mode`` picks the fine mode; in
    grid mode the selection's cutoff is a max over each chunk (split: each
    block), padding rays included, as in the JAX package's ``lax.map``.
    ``occ`` is an optional sampler map (``ops/occupancy.sampler_map``) for
    culled coarse sampling (importance mode only); with
    ``cfg.eval_coarse_free`` the fine depths come from its PMF and no
    coarse pass runs.

    ``counts`` tallies the frames each way ran ("captured", "replayed",
    "looped"); ``captures`` holds, per map kind, the warm-up's and the
    capture's seconds, the memory the capture reserved (MiB) and the
    replays.  :meth:`release` drops the graphs."""

    def __init__(self, cfg: Config, img_h: int, img_w: int,
                 rays_per_chunk: Optional[int] = None, device=None,
                 graph: Optional[bool] = None, world: int = 1):
        if world not in (1, world_size()):
            raise ValueError(f"a frame split over {world} ranks in a group of {world_size()}")
        self.device = resolve_device(device)
        self.cfg, self.img_h, self.img_w = cfg, img_h, img_w
        self.world, self.rank = world, (rank() if world > 1 else 0)
        self.chunk = split_chunk(rays_per_chunk or cfg.eval.rays_per_chunk, world)
        self.block = self.chunk // world
        self.hw = img_h * img_w
        self.n_chunks = -(-self.hw // self.chunk)
        self.padded = self.n_chunks * self.chunk
        self.use_kernels = cfg.eval.use_pallas is not False
        self.cd = _dtype(cfg.compute_dtype)
        self.graph = graph
        self.uses_graph()
        self.counts = dict.fromkeys(("captured", "replayed", "looped"), 0)
        self.captures: Dict[tuple, Dict[str, float]] = {}
        self.pool = None
        # per map kind: (graph, its map buffer, its output: this rank's part)
        self._graphs: Dict[tuple, tuple] = {}
        self._params: Optional[torch.nn.Module] = None
        self._pose = self._K = None

    def uses_graph(self) -> bool:
        """Whether a frame takes the graph route."""
        if self.graph is None:
            return self.device.type == "cuda"
        if self.graph and self.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs CUDA tensors, not {self.device}")
        return self.graph

    def route(self) -> str:
        """The route a frame takes, in words."""
        chunks = f"{self.n_chunks} chunks of {self.chunk} rays"
        split = (f"; split over {self.world} ranks, one all-gather a frame" if self.world > 1
                 else "")
        if self.uses_graph():
            return (f"one CUDA graph of the frame ({chunks}), captured once a map kind and "
                    f"replayed once a frame{split}")
        why = "CPU tensors" if self.device.type != "cuda" else "graph=False"
        return f"the chunk loop ({why}; {chunks}){split}"

    @staticmethod
    def graph_key(occ: Optional[torch.Tensor]) -> tuple:
        """The map kind a graph is captured for: no map, or its dtype and
        shape (the bitpacked ``int32`` map, a ``[G*G, G]`` bf16 map...)."""
        return ("none",) if occ is None else (str(occ.dtype), tuple(occ.shape))

    def _chunks(self, nerf_params, pose_w2c, K, occ, starts) -> list:
        """The frame body up to the chunks starting at ``starts``: the
        (rgb, depth, opacity) of each one's block of this rank (the whole
        chunk with one rank)."""
        pix = F.pad(pixel_grid(self.img_h, self.img_w, device=self.device),
                    (0, 0, 0, self.padded - self.hw))
        rays_d, rays_o = rays_for_pixels(pix, pose_w2c, K)
        packed = pack_eval_params(nerf_params, self.cfg.nerf) if self.use_kernels else None
        ev, own = self.cfg.eval, batch_slice(self.chunk, self.rank, self.world)
        return [render_rays_eval(nerf_params, rays_d[i + own.start:i + own.stop],
                                 rays_o[i + own.start:i + own.stop], self.cfg.nerf, self.cd,
                                 fine_mode=ev.fine_mode, importance_samples=ev.importance_samples,
                                 packed=packed, occ=occ, coarse_free=self.cfg.eval_coarse_free)
                for i in starts]

    def _frame(self, nerf_params, pose_w2c, K, occ) -> torch.Tensor:
        """This rank's part of the frame, as both routes run it: its block
        of every chunk (with one rank, the chunk) as one ``[n_chunks *
        block, 5]`` tensor of (rgb, depth, opacity) rows."""
        outs = self._chunks(nerf_params, pose_w2c, K, occ, range(0, self.padded, self.chunk))
        return torch.cat([torch.cat(out, -1) for out in outs])

    def _whole(self, part: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The whole frame from every rank's part (:meth:`_frame`): one
        gather (none with one rank, also under a group), in rank order
        ``[world, n_chunks, block]``, put back in chunk order and cut to the
        image; each output a fresh copy (a lane of the rows is strided)."""
        rows = all_gather_blocks(part) if self.world > 1 else part
        rows = rows.view(self.world, self.n_chunks, self.block, 5)
        rows = rows.transpose(0, 1).reshape(self.padded, 5)[:self.hw]
        h, w = self.img_h, self.img_w
        return (rows[:, :3].reshape(h, w, 3).contiguous(), rows[:, 3].reshape(h, w).contiguous(),
                rows[:, 4].reshape(h, w).contiguous())

    def _write_inputs(self, nerf_params, pose_w2c, K) -> None:
        """The weights, pose and K, written in place into the graphs'
        own buffers (made at the first frame, outside any pool)."""
        if self._params is None:
            self._params = copy.deepcopy(nerf_params).to(self.device)
            self._pose = torch.empty((3, 4), dtype=torch.float32, device=self.device)
            self._K = torch.empty((3, 3), dtype=torch.float32, device=self.device)
        own, given = list(self._params.parameters()), list(nerf_params.parameters())
        if [p.shape for p in own] != [p.shape for p in given]:
            raise ValueError("these weights are not shaped as the ones the graphs render")
        for p, q in zip(own, given):
            p.copy_(q)
        for buf, x in ((self._pose, pose_w2c), (self._K, K)):
            t = torch.as_tensor(x, dtype=torch.float32)
            if t.device.type == "cpu":
                t = t.pin_memory()     # from pinned memory the copy needs no host sync
            buf.copy_(t, non_blocking=True)

    def capture(self, occ: Optional[torch.Tensor]) -> None:
        """Warm up on one chunk and capture the frame for ``occ``'s map
        kind (see the class), on the inputs written last."""
        dev, key = self.device, self.graph_key(occ)
        occ_buf = None if occ is None else torch.empty_like(occ, device=dev).copy_(occ)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            self._chunks(self._params, self._pose, self._K, occ_buf, (0,))
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        # torch.cuda.graph empties the cache on entry: do it first, so that
        # the growth below is the capture's own
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, pool=self.pool, stream=side):
            part = self._frame(self._params, self._pose, self._K, occ_buf)
        self.captures[key] = {"warmup_s": t1 - t0, "capture_s": time.perf_counter() - t1,
                              "pool_mib": (torch.cuda.memory_reserved(dev) - reserved) / 2**20,
                              "replays": 0}
        self._graphs[key] = (g, occ_buf, part)
        self.counts["captured"] += 1

    def release(self) -> None:
        """Drop every captured graph; a later frame captures anew, in a new
        pool."""
        for g, _, _ in self._graphs.values():
            g.reset()
        self._graphs.clear()
        self.pool = None

    @torch.no_grad()
    def __call__(self, nerf_params, pose_w2c, K, occ=None):
        if not self.uses_graph():
            self.counts["looped"] += 1
            # contiguous, as the graph's buffers are: the rays' sums over a
            # transposed pose (a w2c from a c2w) would run in another order
            pose_w2c, K = (torch.as_tensor(x, dtype=torch.float32, device=self.device)
                           .contiguous() for x in (pose_w2c, K))
            return self._whole(self._frame(nerf_params, pose_w2c, K, occ))
        key = self.graph_key(occ)
        self._write_inputs(nerf_params, pose_w2c, K)
        if key not in self._graphs:
            self.capture(occ)
        g, occ_buf, part = self._graphs[key]
        if occ is not None:
            occ_buf.copy_(occ)
        g.replay()
        self.counts["replayed"] += 1
        self.captures[key]["replays"] += 1
        return self._whole(part)


def split_chunk(rays_per_chunk: int, world: int) -> int:
    """A chunk of ``rays_per_chunk`` rays rounded up to a multiple of
    ``world``, so that it splits into equal rank blocks
    (``mc_nerf_tpu/train/steps.py:314-315``)."""
    return -(-rays_per_chunk // world) * world


def make_render_fn(cfg: Config, img_h: int, img_w: int,
                   rays_per_chunk: Optional[int] = None,
                   device=None, graph: Optional[bool] = None, world: int = 1) -> FrameRender:
    """Full-image renderer: a :class:`FrameRender` (``(nerf_params,
    pose_w2c, K, occ=None) -> (rgb, depth, opacity)``), one replayed CUDA
    graph a frame on the card (``graph`` None: CUDA), else a loop over the
    chunks; with ``world`` > 1 ranks, each chunk split over them and the
    frame gathered once (the JAX ``make_render_fn(mesh=...)``)."""
    return FrameRender(cfg, img_h, img_w, rays_per_chunk, device, graph, world)
