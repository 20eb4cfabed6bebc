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
device, or built by a test from the JAX package's key tree.  The JAX
package scans an epoch in one compiled program; here an epoch is a
Python loop over steps (:func:`make_stage_epoch`).

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

import dataclasses
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
    all_reduce_max,
    all_reduce_mean_,
    batch_slice,
    rank,
    world_size,
)
from mc_nerf_torch.train.loss import reprojection_loss, rgb_loss, self_normalized
from mc_nerf_torch.train.optim import (
    FlatOptState,
    FlatRAdam,
    Params,
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
    stage, and the global step (drives BARF progress).  Steps update it in
    place."""

    params: Params
    p_flat: torch.Tensor
    opt_states: Tuple[FlatOptState, ...]
    step: int = 0


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
    opts = tuple(FlatOptState(moved(o.mu), moved(o.nu), int(o.count)) for o in opt_states_np)
    return TrainState(params, p_flat, opts, int(step))


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
                step: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        loss_int, loss_ext = _calib_losses(params, data, draws, img_h, img_w)
        if stage == 0:
            total = loss_int + loss_ext
            zero = torch.zeros_like(total)
            return total, {"loss": total, "loss_intr": loss_int, "loss_extr": loss_ext,
                           "loss_rgb_c": zero, "loss_rgb_f": zero}
        rays_d, rays_o, gt = _sample_ray_batch(params, data, draws, img_h, img_w)
        # progress as a float32 scalar made on the device (a host tensor
        # copied there each step would wait for the card)
        step_r = torch.full((), float(np.float32(step) / np.float32(total_steps)),
                            dtype=torch.float32, device=rays_d.device)
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
    process group), and the stage's masked RAdam update of
    ``state.p_flat`` in place.  The metrics are this rank's."""
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
        new_opt = tx.update(g_flat, state.opt_states[stage], state.p_flat)
        state.opt_states = tuple(new_opt if i == stage else o
                                 for i, o in enumerate(state.opt_states))
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return step_fn


def make_stage_epoch(cfg: Config, stage: int, tx: FlatRAdam, img_h: int, img_w: int,
                     total_steps: int, steps_per_epoch: int, world: int = 1) -> Callable:
    """One epoch, a Python loop of :func:`make_stage_step`:
    ``(state, data, generator) -> mean metrics``, each step's draws from
    ``generator`` (on the device): the global batch over ``world`` ranks,
    of which this rank keeps its block.  The mean metrics are averaged
    over the ranks once, at the end: the global batch's."""
    step_fn = make_stage_step(cfg, stage, tx, img_h, img_w, total_steps, world)
    draw_cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, images_per_batch=cfg.train.images_per_batch * world))
    this_rank = rank()

    def epoch_fn(state: TrainState, data: TrainData,
                 generator: torch.Generator) -> Dict[str, torch.Tensor]:
        sums: Dict[str, torch.Tensor] = {}
        n_images = data.images_u8.shape[0]
        for _ in range(steps_per_epoch):
            draws = draw_step(draw_cfg, stage, n_images, img_h, img_w, data.occ is not None,
                              generator)
            for k, v in step_fn(state, data, rank_block(draws, this_rank, world)).items():
                sums[k] = sums[k] + v if k in sums else v
        names = sorted(sums)
        means = all_reduce_mean_(torch.stack([sums[k] for k in names]) / steps_per_epoch)
        return dict(zip(names, means))

    return epoch_fn


def make_render_fn(cfg: Config, img_h: int, img_w: int,
                   rays_per_chunk: Optional[int] = None,
                   device=None) -> Callable:
    """Full-image renderer: a loop over fixed-size ray chunks (the JAX
    package's ``lax.map``); the last chunk is padded to full size, so every
    chunk has the same shapes.

    ``(nerf_params, pose_w2c [3,4], K [3,3], occ=None) ->
      (rgb [H,W,3], depth [H,W], opacity [H,W])``

    ``cfg.eval.use_pallas`` picks the route: None or True renders through
    the Hopper kernels (the weights are packed once per render), False
    through the plain route in ``cfg.compute_dtype``.  ``cfg.eval.fine_mode``
    picks the fine mode; in grid mode the selection's cutoff is a max over
    each chunk, padding rays included, as in the JAX package's ``lax.map``.
    ``occ`` is an optional ``[G*G, G]`` sampler map for culled coarse
    sampling (importance mode only); with ``cfg.eval_coarse_free`` the fine
    depths come from its PMF and no coarse pass runs.
    """
    dev = resolve_device(device)
    chunk = rays_per_chunk or cfg.eval.rays_per_chunk
    hw = img_h * img_w
    n_chunks = -(-hw // chunk)
    padded = n_chunks * chunk
    use_kernels = cfg.eval.use_pallas is not False
    cd = _dtype(cfg.compute_dtype)

    @torch.no_grad()
    def render(nerf_params, pose_w2c, K, occ=None):
        pose_w2c = torch.as_tensor(pose_w2c, dtype=torch.float32, device=dev)
        K = torch.as_tensor(K, dtype=torch.float32, device=dev)
        pix = F.pad(pixel_grid(img_h, img_w, device=dev), (0, 0, 0, padded - hw))
        rays_d, rays_o = rays_for_pixels(pix, pose_w2c, K)
        packed = pack_eval_params(nerf_params, cfg.nerf) if use_kernels else None
        outs = [
            render_rays_eval(
                nerf_params, rays_d[i:i + chunk], rays_o[i:i + chunk], cfg.nerf, cd,
                fine_mode=cfg.eval.fine_mode, importance_samples=cfg.eval.importance_samples,
                packed=packed, occ=occ, coarse_free=cfg.eval_coarse_free,
            )
            for i in range(0, padded, chunk)
        ]
        rgb, depth, opacity = (torch.cat(t)[:hw] for t in zip(*outs))
        return (rgb.reshape(img_h, img_w, 3), depth.reshape(img_h, img_w),
                opacity.reshape(img_h, img_w))

    return render
