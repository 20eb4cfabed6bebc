"""The test scene of the measuring scripts: seeded weights whose field
varies with position, and cameras on a sphere looking at the origin."""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from mc_nerf_torch.config import NerfConfig
from mc_nerf_torch.data.blender import _blender_pose_to_w2c_np
from mc_nerf_torch.models.nerf import NerfParams, init_nerf_params

LEGO_FOV = 0.6911112070083618   # camera_angle_x of the NeRF-synthetic scenes


def scene_params(cfg: NerfConfig, seed: int, device=None) -> NerfParams:
    """``init_nerf_params`` from a seeded generator, every weight scaled by
    sqrt(6): U(+-sqrt(6 / fan_in)), He's ReLU gain.  At the init's own
    U(+-1 / sqrt(fan_in)) the activations shrink layer by layer and the
    outputs are nearly all bias: a flat grey field, against which a check
    cannot tell a wrong kernel from a right one.  Here sigma and colour
    vary with the point (rgb 0.17-0.83 over a frame at the defaults)."""
    params = init_nerf_params(cfg, torch.Generator().manual_seed(seed), device=device)
    with torch.no_grad():
        for m in params.modules():
            if isinstance(m, torch.nn.Linear):
                m.weight.mul_(math.sqrt(6.0))
    return params


def orbit_views(azimuths: Sequence[float], h: int = 800, w: int = 800,
                radius: float = 4.0, elevation: float = 0.5,
                fov: float = LEGO_FOV) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV w2c poses [n, 3, 4] of cameras at ``radius`` and ``elevation``
    (radians) at the given azimuths, all looking at the origin, and their
    shared intrinsics K [3, 3] for an h x w image of horizontal FOV ``fov``."""
    poses = []
    for a in azimuths:
        eye = radius * np.array([math.cos(a) * math.cos(elevation),
                                 math.sin(a) * math.cos(elevation), math.sin(elevation)])
        fwd = -eye / radius
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        c2w = np.eye(4)   # Blender axes: the camera looks down -Z, +Y up
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(right, fwd), -fwd, eye
        poses.append(_blender_pose_to_w2c_np(c2w))
    focal = (w / 2.0) / math.tan(fov / 2.0)
    K = np.array([[focal, 0, w / 2.0], [0, focal, h / 2.0], [0, 0, 1]], np.float32)
    return np.stack(poses), K
