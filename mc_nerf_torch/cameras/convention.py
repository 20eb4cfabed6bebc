"""Blender <-> OpenCV conventions and FOV intrinsics (counterpart of
``mc_nerf_tpu/cameras/convention.py``)."""

from __future__ import annotations

import torch

_FLIP = (1.0, -1.0, -1.0)  # diag(1, -1, -1): Blender <-> OpenCV camera axes


def blender_pose_to_w2c(c2w_blender: torch.Tensor) -> torch.Tensor:
    """Blender c2w [..., 4, 4] (or [..., 3, 4]) -> OpenCV w2c [..., 3, 4]
    (ref ``data/data_read.py:246-257``)."""
    R = c2w_blender[..., :3, :3]
    t = c2w_blender[..., :3, 3]
    R_cv = R * torch.tensor(_FLIP, dtype=R.dtype, device=R.device)
    R_w2c = R_cv.transpose(-1, -2)
    t_w2c = -(R_w2c * t[..., None, :]).sum(-1)
    return torch.cat([R_w2c, t_w2c[..., None]], dim=-1)


def fov_to_K(fov_x, img_h: int, img_w: int) -> torch.Tensor:
    """Horizontal FOV (radians) -> [..., 3, 3] intrinsics with the
    reference's formula (fy shares the x-FOV tangent, data_read.py:141-152)."""
    fov_x = torch.as_tensor(fov_x, dtype=torch.float32)
    tan_half = torch.tan(fov_x / 2.0)
    fx = (img_w / 2.0) / tan_half
    fy = (img_h / 2.0) / tan_half
    zeros = torch.zeros_like(fx)
    ones = torch.ones_like(fx)
    row0 = torch.stack([fx, zeros, torch.full_like(fx, img_w / 2.0)], dim=-1)
    row1 = torch.stack([zeros, fy, torch.full_like(fx, img_h / 2.0)], dim=-1)
    row2 = torch.stack([zeros, zeros, ones], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)
