"""Camera-pose recovery for the calibration stage (counterpart of
``mc_nerf_tpu/train/restarts.py``).

Pose regression from the all-ones init (ref ``mc_nerf.py:347-371``) is
non-convex: some cameras land in reflection or planar-flip minima that
SGD never leaves.  Between stage-0 epochs the engine runs
:func:`improve_cameras`, a monotone candidate adoption: each camera's
current (pose, K) against a joint sweep of focal hypotheses x the six
analytic planar-PnP solutions (``cameras/pnp.py``), ranked by the full
deterministic reprojection residual over every valid tag; the best is
adopted only when it beats the current residual by a clear factor.  The
optimizer state is left as it is.  Adoption is deterministic (analytic
candidates only), so unlike the JAX function this one takes no key.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Tuple

import numpy as np
import torch

from mc_nerf_torch.cameras.lie import SE3_to_se3, se3_to_SE3
from mc_nerf_torch.cameras.pnp import solve_planar_pnp, tag_pose_to_frame_pose
from mc_nerf_torch.cameras.projection import reproject_points
from mc_nerf_torch.data.calibration import CalibrationData
from mc_nerf_torch.models.camera_params import (
    CameraParams,
    calib_cube_poses,
    camera_poses,
    intrinsics,
)

# a camera adopts a candidate whose residual beats this factor x its own
ADOPT_FACTOR = 0.5
# focal-length hypotheses swept jointly with each tag's PnP pose
N_FX_HYP = 10


def _residual(cube: torch.Tensor, pts_all: torch.Tensor, poses: torch.Tensor, K: torch.Tensor,
              img_h: int, img_w: int) -> torch.Tensor:
    """[..., N, 3, 4] poses and [..., N, 3, 3] K -> the per-camera mean
    squared normalized reprojection error over valid tags, [..., N]."""
    pred = reproject_points(cube, K[..., None, :, :], poses[..., None, :, :])  # [..., N, 6, 5, 2]
    valid = torch.any(pts_all != 0, dim=-1).any(dim=-1)                         # [N, 6]
    dx = (pred[..., 0] - pts_all[..., 0]) / img_w
    dy = (pred[..., 1] - pts_all[..., 1]) / img_h
    per_tag = torch.mean(dx * dx + dy * dy, dim=-1)
    num = torch.sum(torch.where(valid, per_tag, 0.0), dim=-1)
    return num / torch.clamp(valid.sum(-1), min=1)


@torch.no_grad()
def per_camera_losses(cam: CameraParams, calib: CalibrationData, img_h: int,
                      img_w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(intr_loss [N], extr_loss [N]): the deterministic per-camera
    reprojection residuals over all valid tags, in normalized pixel^2
    (the training loss's normalization, ref loss.py:45-58)."""
    K = intrinsics(cam, img_h, img_w)
    return (_residual(calib.cube_pts, calib.calib_pts, calib_cube_poses(cam), K, img_h, img_w),
            _residual(calib.cube_pts, calib.coord_pts, camera_poses(cam), K, img_h, img_w))


def _pnp_candidate_twists(pts_all: torch.Tensor, K: torch.Tensor,
                          cube_pts: torch.Tensor) -> torch.Tensor:
    """Analytic per-tag PnP poses of the containing frame (the cube frame,
    the world frame for the coord set), one per (camera, tag): ``pts_all``
    [N, 6, 5, 2] detections, ``K`` [..., N, 3, 3] -> twists [..., 6, N, 6].
    Invalid tags (zeroed detections) give garbage poses that lose the
    residual ranking."""
    # each tag's plane frame from its keypoints: lt -> rt spans 2h u,
    # lb -> lt spans 2h v, the origin at the centre
    lt, rt, lb = cube_pts[:, 1], cube_pts[:, 2], cube_pts[:, 4]
    two_h = torch.linalg.norm(rt - lt, dim=-1, keepdim=True)       # [6, 1]
    u, v = (rt - lt) / two_h, (lt - lb) / two_h
    n = torch.linalg.cross(u, v)
    h = two_h[:, 0] / 2.0
    corners = torch.tensor([[0.0, 0.0], [-1.0, 1.0], [1.0, 1.0], [1.0, -1.0], [-1.0, -1.0]],
                           dtype=cube_pts.dtype, device=cube_pts.device)
    plane_uv = corners[None] * h[:, None, None]                    # [6, 5, 2]
    pose_p2c = solve_planar_pnp(plane_uv, pts_all, K[..., None, :, :])          # [..., N, 6, 3, 4]
    pose = tag_pose_to_frame_pose(pose_p2c, cube_pts[:, 0], u, v, n)
    return SE3_to_se3(pose).transpose(-3, -2)                      # [..., 6, N, 6]


def _best_candidate(cands: torch.Tensor, pts_all: torch.Tensor, cube: torch.Tensor,
                    K: torch.Tensor, img_h: int, img_w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidates [..., 6, N, 6] scored under K [..., N, 3, 3] -> the best
    twist [..., N, 6] and its residual [..., N] (NaN and inf rank last)."""
    losses = _residual(cube, pts_all, se3_to_SE3(cands), K[..., None, :, :, :], img_h, img_w)
    losses = torch.nan_to_num(losses, nan=1e30, posinf=1e30)       # [..., 6, N]
    best = torch.argmin(losses, dim=-2, keepdim=True)              # [..., 1, N]
    tw = torch.take_along_dim(cands, best[..., None], dim=-3).squeeze(-3)
    return tw, torch.take_along_dim(losses, best, dim=-2).squeeze(-2)


@torch.no_grad()
def improve_cameras(cam: CameraParams, calib: CalibrationData, img_h: int,
                    img_w: int) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """One monotone camera-improvement step (between stage-0 epochs).

    Stuck cameras co-adapt a wrong focal length with a wrong pose, so the
    sweep is joint: focal hypotheses spanning the rigs' 40-80 degree FOVs
    (ref ``Ball.py:17-24``; principal point at the image centre) x each
    tag's PnP pose, scored under that K.  A camera adopts pose + fx/fy
    (+ a centred principal point) together only when the best residual
    beats ``ADOPT_FACTOR`` x its current one, so converged cameras
    (residual ~1e-8) are never churned.  The cube poses of the calibration
    images then get the same treatment under the updated K.

    Returns (the new camera values by field name, adopted-pose mask [N],
    adopted-cube mask [N]); the caller writes the values into its
    parameters.
    """
    _, extr_now = per_camera_losses(cam, calib, img_h, img_w)
    cube = calib.cube_pts
    n, dev = cam.fx.shape[0], cam.fx.device

    # FOV 40..80 deg -> fx/W = 1/(2 tan(fov/2)) in ~[0.59, 1.37]; padded
    fx_grid = torch.as_tensor(np.geomspace(0.5, 1.6, N_FX_HYP), dtype=torch.float32, device=dev)
    K_grid = torch.zeros((N_FX_HYP, 3, 3), dtype=torch.float32, device=dev)
    K_grid[:, 0, 0], K_grid[:, 1, 1] = fx_grid * img_w, fx_grid * img_h
    K_grid[:, 0, 2], K_grid[:, 1, 2], K_grid[:, 2, 2] = img_w / 2.0, img_h / 2.0, 1.0
    K_rep = K_grid[:, None].expand(N_FX_HYP, n, 3, 3)

    # the joint (fx, tag) sweep over the coord detections
    tws, lss = _best_candidate(_pnp_candidate_twists(calib.coord_pts, K_rep, cube),
                               calib.coord_pts, cube, K_rep, img_h, img_w)   # [F, N, 6], [F, N]
    best_f = torch.argmin(lss, dim=0)                                        # [N]
    best_pose = torch.take_along_dim(tws, best_f[None, :, None], dim=0)[0]
    best_pose_loss = torch.take_along_dim(lss, best_f[None], dim=0)[0]
    best_fx = fx_grid[best_f]
    adopt_pose = best_pose_loss < ADOPT_FACTOR * extr_now

    # the fy parameter stores fy / img_w (camera_params.intrinsics), and
    # the hypothesis sets fy = fx_mult * img_h
    new = {
        "pose_se3": torch.where(adopt_pose[:, None], best_pose, cam.pose_se3),
        "fx": torch.where(adopt_pose, best_fx, cam.fx),
        "fy": torch.where(adopt_pose, best_fx * (img_h / img_w), cam.fy),
        "ux": torch.where(adopt_pose, 1.0, cam.ux),
        "uy": torch.where(adopt_pose, 1.0, cam.uy),
    }
    # the cube poses under the (possibly updated) intrinsics
    K_new = intrinsics(SimpleNamespace(**new), img_h, img_w)
    best_cube, best_cube_loss = _best_candidate(
        _pnp_candidate_twists(calib.calib_pts, K_new, cube), calib.calib_pts, cube, K_new,
        img_h, img_w)
    # if K changed, the old intr residual is stale: recompute it under K_new
    intr_under_new = _residual(cube, calib.calib_pts, calib_cube_poses(cam), K_new, img_h, img_w)
    adopt_cube = best_cube_loss < ADOPT_FACTOR * intr_under_new
    new["calib_pose_se3"] = torch.where(adopt_cube[:, None], best_cube, cam.calib_pose_se3)
    return new, adopt_pose, adopt_cube
