"""Full-frame render function (counterpart of ``make_render_fn`` in
``mc_nerf_tpu/train/steps.py``; the training steps come with the training
slice)."""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from mc_nerf_torch import compute_dtype as _dtype
from mc_nerf_torch import resolve_device
from mc_nerf_torch.cameras.rays import pixel_grid, rays_for_pixels
from mc_nerf_torch.config import Config
from mc_nerf_torch.models.nerf import pack_eval_params, render_rays_eval


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
    through the plain route in ``cfg.compute_dtype``.  ``occ`` is an
    optional ``[G*G, G]`` binary occupancy map for culled coarse sampling.
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
                importance_samples=cfg.eval.importance_samples,
                packed=packed, occ=occ,
            )
            for i in range(0, padded, chunk)
        ]
        rgb, depth, opacity = (torch.cat(t)[:hw] for t in zip(*outs))
        return (rgb.reshape(img_h, img_w, 3), depth.reshape(img_h, img_w),
                opacity.reshape(img_h, img_w))

    return render
