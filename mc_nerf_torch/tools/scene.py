"""The test scene of the measuring scripts: seeded weights whose field
varies with position, cameras on a sphere looking at the origin, and the
training workload of the GLOBAL_OPTIM step."""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from mc_nerf_torch import resolve_device
from mc_nerf_torch.config import Config, NerfConfig
from mc_nerf_torch.data.blender import _blender_pose_to_w2c_np
from mc_nerf_torch.data.calibration import calibration_from_numpy
from mc_nerf_torch.models.camera_params import init_camera_params_from_gt
from mc_nerf_torch.models.nerf import NerfParams, init_nerf_params
from mc_nerf_torch.ops.occupancy import uniform_prior_map
from mc_nerf_torch.train.optim import Params
from mc_nerf_torch.train.steps import TrainData

# steps of the whole three-stage schedule at the reference scale: 52
# epochs of 5500 steps (bench.py's total_steps), and the steps per epoch
TOTAL_STEPS = 286000
STEPS_PER_EPOCH = 5500

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


def train_workload(cfg: Config, seed: int, device=None, n_images: int = 110,
                   img_h: int = 800, img_w: int = 800) -> Tuple[Params, TrainData]:
    """The workload ``bench.py:69-105`` times, built on the device: 110
    seeded uint8 images of 800x800, seeded detections (uniform in
    [10, 790] px, every tag visible), the all-occupied ``uniform_prior_map``
    (culling changes where samples land, never how many; None in the grid
    fine mode, which is never culled: ``Engine._occ_train``), and
    :func:`scene_params` weights.  The cameras start at ground truth on an
    orbit of radius 4 around the scene (the benchmark starts them at the
    all-ones init; here the rays cross the scene's box)."""
    dev = resolve_device(device)
    poses, K = orbit_views(np.linspace(0.0, 2 * math.pi, n_images, endpoint=False),
                           img_h, img_w)
    cam = init_camera_params_from_gt(
        torch.as_tensor(poses, dtype=torch.float32, device=dev),
        torch.as_tensor(np.tile(K, (n_images, 1, 1)), device=dev), img_h, img_w)
    params = Params(cam, scene_params(cfg.nerf, seed, device=dev))
    gen = torch.Generator(device=dev).manual_seed(seed)
    images = torch.randint(0, 256, (n_images, img_h * img_w, 3), generator=gen,
                           dtype=torch.uint8, device=dev)
    rng = np.random.default_rng(seed)
    pts = rng.uniform(10, min(img_h, img_w) - 10, size=(n_images, 6, 5, 2)).astype(np.float32)
    valid = np.ones((n_images, 6), bool)
    calib = calibration_from_numpy(pts, valid, pts, valid, device=dev)
    occ = uniform_prior_map(cfg.nerf, dev) if cfg.train.fine_mode == "importance" else None
    return params, TrainData(images, calib, occ)
