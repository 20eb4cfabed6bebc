"""Projection helpers (counterpart of ``mc_nerf_tpu/cameras/projection.py``).

Pose convention as in the reference: world-to-camera ``[R | t]``,
OpenCV axes, ``x_cam = R x_world + t``.  Only what the render path needs
is ported.
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
