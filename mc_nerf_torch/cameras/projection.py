"""Projection helpers (counterpart of ``mc_nerf_tpu/cameras/projection.py``).

Pose convention as in the reference: world-to-camera ``[R | t]``,
OpenCV axes, ``x_cam = R x_world + t``.  Ported: what the render and the
calibration losses need.
"""

from __future__ import annotations

import torch


def invert_K(K: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of pinhole intrinsics [..., 3, 3]."""
    fx = K[..., 0, 0]
    fy = K[..., 1, 1]
    cx = K[..., 0, 2]
    cy = K[..., 1, 2]
    zeros = torch.zeros_like(fx)
    ones = torch.ones_like(fx)
    inv_fx = 1.0 / fx
    inv_fy = 1.0 / fy
    row0 = torch.stack([inv_fx, zeros, -cx * inv_fx], dim=-1)
    row1 = torch.stack([zeros, inv_fy, -cy * inv_fy], dim=-1)
    row2 = torch.stack([zeros, zeros, ones], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def to_hom(x: torch.Tensor) -> torch.Tensor:
    """Append a homogeneous 1: [..., D] -> [..., D+1] (ref mc_nerf.py:213-225)."""
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def world2cam(world_pts: torch.Tensor, pose_w2c: torch.Tensor) -> torch.Tensor:
    """World points [..., P, 3] -> camera frame: x_cam = R x_world + t
    (ref ``model/mc_nerf.py:260-267``), as fp32 multiply-sums."""
    R, t = pose_w2c[..., :3], pose_w2c[..., 3]
    return (R[..., None, :, :] * world_pts[..., :, None, :]).sum(-1) + t[..., None, :]


def cam2pix(cam_pts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Camera-frame points [..., P, 3] -> pixel coords [..., P, 2]: the
    perspective divide by z (ref ``model/mc_nerf.py:236-241``), guarded so
    points crossing z ~ 0 (poses regressed from scratch) give large but
    finite pixels and gradients."""
    proj = (K[..., None, :, :] * cam_pts[..., :, None, :]).sum(-1)
    z = proj[..., 2:3]
    z_safe = torch.where(torch.abs(z) < 1e-6,
                         torch.where(z < 0, torch.full_like(z, -1e-6), torch.full_like(z, 1e-6)),
                         z)
    return proj[..., :2] / z_safe


def reproject_points(world_pts: torch.Tensor, K: torch.Tensor,
                     pose_w2c: torch.Tensor) -> torch.Tensor:
    """World points [..., P, 3] through a w2c pose [..., 3, 4] and
    intrinsics [..., 3, 3] to pixels [..., P, 2] (ref
    ``model/mc_nerf.py:147-152``): the reprojection of both calibration
    losses."""
    return cam2pix(world2cam(world_pts, pose_w2c), K)
