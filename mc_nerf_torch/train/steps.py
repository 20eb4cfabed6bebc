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
from mc_nerf_torch.models.camera_params import calib_cube_poses, camera_poses, intrinsics
from mc_nerf_torch.models.nerf import (
    RenderDraws,
    draw_render,
    pack_eval_params,
    render_rays_eval,
    render_rays_train,
)
from mc_nerf_torch.train.loss import reprojection_loss, rgb_loss, self_normalized
from mc_nerf_torch.train.optim import FlatOptState, FlatRAdam, Params, flat_grads


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


class StepDraws(NamedTuple):
    """The random draws of one step (``train/steps.py`` splits its key
    into k_calib -> (k_int, k_ext), k_rays -> (k_img, k_pix), k_render)."""

    u_int: torch.Tensor                  # [N] U[0,1): the tag of each calib image
    u_ext: torch.Tensor                  # [N] U[0,1): the tag of each coord image
    img_ids: Optional[torch.Tensor]      # [B] int64 images of the batch (stages 1, 2)
    pix_idx: Optional[torch.Tensor]      # [B, R] int64 pixels of each image
    render: Optional[RenderDraws]        # the render's draws, over B * R rays
    # (B is 1 from draw_step, as in the reference's BatchSampler; the JAX
    # package's per-device images_per_batch waits for data parallelism)


def draw_step(cfg: Config, stage: int, n_images: int, img_h: int, img_w: int,
              culled: bool, generator: torch.Generator) -> StepDraws:
    """Draw one step's :class:`StepDraws` from ``generator`` on its device;
    ``culled``: the coarse pass samples an occupancy map.  Pixels are drawn with replacement when the image has more than 8x the
    batch's rays (expected collisions ~R^2 / 2HW, as the JAX package
    argues), else without."""
    dev = generator.device
    u_int = torch.rand((n_images,), generator=generator, device=dev)
    u_ext = torch.rand((n_images,), generator=generator, device=dev)
    if stage == 0:
        return StepDraws(u_int, u_ext, None, None, None)
    rays, hw = cfg.train.rays_per_batch, img_h * img_w
    img_ids = torch.randint(0, n_images, (1,), generator=generator, device=dev)
    if hw > 8 * rays:
        pix_idx = torch.randint(0, hw, (1, rays), generator=generator, device=dev)
    else:
        pix_idx = torch.randperm(hw, generator=generator, device=dev)[None, :rays]
    render = draw_render(rays, cfg.nerf, cfg.train.importance_samples, culled, generator,
                         cfg.train.fine_mode)
    return StepDraws(u_int, u_ext, img_ids, pix_idx, render)


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
                 total_steps: int) -> Callable:
    """Per-stage loss: ``(params, data, draws, step) -> (loss, metrics)``.

    ``cfg.train.use_pallas`` picks the render route: None or True renders
    through the hand-written kernels on CUDA (their plain versions on CPU
    tensors): ``fused_render`` in importance mode, ``fused_shaded_mlp`` in
    grid mode (``cfg.train.fine_mode``); False through the plain PyTorch
    route.  The JAX package defaults its train step to XLA because its
    fused backward lost on a TPU; the port's choice rests on the H100
    (PERF.md)."""
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
            occ=data.occ, remat_shade=cfg.train.remat_shade)
        loss_c, loss_f = rgb_loss(rgb_c, gt), rgb_loss(rgb_f, gt)
        total = self_normalized(loss_int) + loss_c + loss_f
        return total, {"loss": total, "loss_intr": loss_int, "loss_extr": loss_ext,
                       "loss_rgb_c": loss_c, "loss_rgb_f": loss_f}

    return loss_fn


def make_stage_step(cfg: Config, stage: int, tx: FlatRAdam, img_h: int, img_w: int,
                    total_steps: int) -> Callable:
    """One step: ``(state, data, draws) -> metrics``: loss, backward,
    the flat gradient, and the stage's masked RAdam update of
    ``state.p_flat`` in place."""
    loss_fn = make_loss_fn(cfg, stage, img_h, img_w, total_steps)

    def step_fn(state: TrainState, data: TrainData, draws: StepDraws) -> Dict[str, torch.Tensor]:
        for p in state.params.parameters():
            p.grad = None
        total, metrics = loss_fn(state.params, data, draws, state.step)
        total.backward()
        new_opt = tx.update(flat_grads(state.params), state.opt_states[stage], state.p_flat)
        state.opt_states = tuple(new_opt if i == stage else o
                                 for i, o in enumerate(state.opt_states))
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return step_fn


def make_stage_epoch(cfg: Config, stage: int, tx: FlatRAdam, img_h: int, img_w: int,
                     total_steps: int, steps_per_epoch: int) -> Callable:
    """One epoch, a Python loop of :func:`make_stage_step`:
    ``(state, data, generator) -> mean metrics``, each step's draws from
    ``generator`` (on the device)."""
    step_fn = make_stage_step(cfg, stage, tx, img_h, img_w, total_steps)

    def epoch_fn(state: TrainState, data: TrainData,
                 generator: torch.Generator) -> Dict[str, torch.Tensor]:
        sums: Dict[str, torch.Tensor] = {}
        n_images = data.images_u8.shape[0]
        for _ in range(steps_per_epoch):
            draws = draw_step(cfg, stage, n_images, img_h, img_w, data.occ is not None,
                              generator)
            for k, v in step_fn(state, data, draws).items():
                sums[k] = sums[k] + v if k in sums else v
        return {k: v / steps_per_epoch for k, v in sums.items()}

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
    ``occ`` is an optional ``[G*G, G]`` binary occupancy map for culled
    coarse sampling (importance mode only).
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
                packed=packed, occ=occ,
            )
            for i in range(0, padded, chunk)
        ]
        rgb, depth, opacity = (torch.cat(t)[:hw] for t in zip(*outs))
        return (rgb.reshape(img_h, img_w, 3), depth.reshape(img_h, img_w),
                opacity.reshape(img_h, img_w))

    return render
