"""Ray generation (counterpart of ``mc_nerf_tpu/cameras/rays.py``)."""

from __future__ import annotations

from typing import Tuple

import torch

from mc_nerf_torch import resolve_device
from mc_nerf_torch.cameras.projection import invert_K


def pixel_grid(img_h: int, img_w: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """[H*W, 2] pixel-center coordinates (x, y), row-major, with the
    reference's +0.5 offset (mc_nerf.py:127-130)."""
    dev = resolve_device(device)
    y = torch.arange(img_h, dtype=dtype, device=dev) + 0.5
    x = torch.arange(img_w, dtype=dtype, device=dev) + 0.5
    Y, X = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([X, Y], dim=-1).reshape(-1, 2)


def _dirs_from_pixels(pix_xy: torch.Tensor, K_inv: torch.Tensor) -> torch.Tensor:
    """Pixel centers [..., P, 2] -> camera-frame directions [..., P, 3] (z=1)."""
    x = pix_xy[..., 0]
    y = pix_xy[..., 1]
    dx = x * K_inv[..., 0, 0, None] + K_inv[..., 0, 2, None]
    dy = y * K_inv[..., 1, 1, None] + K_inv[..., 1, 2, None]
    return torch.stack([dx, dy, torch.ones_like(dx)], dim=-1)


def rays_for_pixels(pix_xy: torch.Tensor, pose_w2c: torch.Tensor,
                    K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays through pixel centers [..., P, 2] for a w2c pose [..., 3, 4] and
    intrinsics [..., 3, 3] -> (unit directions, origins), each [..., P, 3].

    The 3x3 products are elementwise multiply-sums, full float32 whatever
    the caller's TF32 setting (``heinsum`` in the JAX package).
    """
    K_inv = invert_K(K)
    dirs_cam = _dirs_from_pixels(pix_xy, K_inv)
    R = pose_w2c[..., :3]
    t = pose_w2c[..., 3]
    # world direction = R^T d_cam ; origin = -R^T t
    dirs_world = (R[..., None, :, :] * dirs_cam[..., :, :, None]).sum(-2)
    origin = -(R * t[..., :, None]).sum(-2)
    rays_d = dirs_world / torch.linalg.norm(dirs_world, dim=-1, keepdim=True)
    rays_o = origin[..., None, :].expand(rays_d.shape)
    return rays_d, rays_o
