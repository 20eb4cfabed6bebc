"""Learnable per-image camera parameters (counterpart of
``mc_nerf_tpu/models/camera_params.py``).

The reference registers five parameter groups on the model
(``model/mc_nerf.py:347-371``), all initialized to ones:
  * ``pose_se3``       [N, 6] — per-image camera extrinsics (se3 twist);
  * ``calib_pose_se3`` [N, 6] — per-calib-image cube pose;
  * ``fx, fy, ux, uy`` [N]    — multiplicative intrinsic corrections on the
    init K = [[W, 0, W/2], [0, W, H/2], [0, 0, 1]] (mc_nerf.py:171-186).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from mc_nerf_torch import resolve_device
from mc_nerf_torch.cameras.lie import SE3_to_se3, se3_to_SE3

FIELDS = ("pose_se3", "calib_pose_se3", "fx", "fy", "ux", "uy")


class CameraParams(nn.Module):
    """The six camera parameters, in the JAX package's leaf order."""

    def __init__(self, pose_se3, calib_pose_se3, fx, fy, ux, uy):
        super().__init__()
        for name, t in zip(FIELDS, (pose_se3, calib_pose_se3, fx, fy, ux, uy)):
            setattr(self, name, nn.Parameter(t))


def init_camera_params(num_images: int, device=None) -> CameraParams:
    """All-ones init, matching ref ``register_parameters``."""
    dev = resolve_device(device)
    return CameraParams(*(torch.ones(shape, dtype=torch.float32, device=dev)
                          for shape in ((num_images, 6), (num_images, 6), (num_images,),
                                        (num_images,), (num_images,), (num_images,))))


def init_camera_params_from_gt(poses_w2c: torch.Tensor, K: torch.Tensor, img_h: int,
                               img_w: int) -> CameraParams:
    """Camera parameters at ground truth: the inverse of :func:`intrinsics`
    and :func:`camera_poses`."""
    with torch.no_grad():
        n = K.shape[0]
        return CameraParams(SE3_to_se3(poses_w2c),
                            torch.ones((n, 6), dtype=K.dtype, device=K.device),
                            K[:, 0, 0] / img_w, K[:, 1, 1] / img_w,
                            K[:, 0, 2] / (img_w / 2.0), K[:, 1, 2] / (img_h / 2.0))


def camera_params_from_numpy(tree, device=None) -> CameraParams:
    """The JAX package's ``CameraParams`` as numpy arrays (e.g.
    ``jax.tree.map(np.asarray, cam)``) -> :class:`CameraParams`: the camera
    half of the weight carry-over (``nerf_params_from_numpy`` is the other)."""
    dev = resolve_device(device)
    return CameraParams(*(torch.tensor(np.asarray(getattr(tree, f), np.float32), device=dev)
                          for f in FIELDS))


def intrinsics(cam: CameraParams, img_h: int, img_w: int) -> torch.Tensor:
    """[N, 3, 3] K = abs(multiplier * init), init fx = fy = W, cx = W/2,
    cy = H/2 (ref ``add_weights2intr``, mc_nerf.py:171-186)."""
    fx = torch.abs(cam.fx * img_w)
    fy = torch.abs(cam.fy * img_w)
    cx = torch.abs(cam.ux * (img_w / 2.0))
    cy = torch.abs(cam.uy * (img_h / 2.0))
    zeros, ones = torch.zeros_like(fx), torch.ones_like(fx)
    return torch.stack([torch.stack([fx, zeros, cx], -1),
                        torch.stack([zeros, fy, cy], -1),
                        torch.stack([zeros, zeros, ones], -1)], dim=-2)


def camera_poses(cam: CameraParams) -> torch.Tensor:
    """[N, 3, 4] world-to-camera poses from the learnable twists."""
    return se3_to_SE3(cam.pose_se3)


def calib_cube_poses(cam: CameraParams) -> torch.Tensor:
    """[N, 3, 4] cube-to-camera poses for the calibration images."""
    return se3_to_SE3(cam.calib_pose_se3)
