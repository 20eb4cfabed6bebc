"""Per-epoch observability (counterpart of
``mc_nerf_tpu/utils/visualization.py``; ref ``model/mc_nerf.py:388-534``,
``model/net_utils.py:205-231``): the camera-error table, the
inverse-depth colormap and the GT-vs-estimated camera pose plot.  The
plot is drawn with PIL (matplotlib draws it there, and is not a
dependency of the port): the same wireframes, colours, limits and image
size, projected orthographically at matplotlib's default 3D view.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from mc_nerf_torch.utils.logging import format_table

CAMERA_TABLE_HEADERS = (
    "EPOCH", "LOSS_FX", "LOSS_FY", "LOSS_UX", "LOSS_UY", "LOSS_K", "LOSS_R", "LOSS_T"
)

# inferno at 17 evenly spaced points, linearly interpolated (within 0.026
# of the 256-entry table) for the inverse-depth PNGs
_INFERNO = np.array([
    (0.0015, 0.0005, 0.0139), (0.0423, 0.0281, 0.1411), (0.1293, 0.0473, 0.2908),
    (0.2383, 0.0366, 0.3964), (0.3415, 0.0623, 0.4294), (0.4412, 0.0993, 0.4316),
    (0.5409, 0.1347, 0.4151), (0.6401, 0.1714, 0.3811), (0.7357, 0.2159, 0.3302),
    (0.8224, 0.2752, 0.2661), (0.8943, 0.3534, 0.1936), (0.9470, 0.4492, 0.1153),
    (0.9784, 0.5579, 0.0349), (0.9879, 0.6753, 0.0653), (0.9746, 0.7977, 0.2063),
    (0.9476, 0.9174, 0.4107), (0.9884, 0.9984, 0.6449),
])


def camera_error_row(epoch: int, K_gt: np.ndarray, K_est: np.ndarray, pose_gt: np.ndarray,
                     pose_est: np.ndarray) -> list:
    """One row of the camera-error table (ref mc_nerf.py:388-407): mean
    absolute errors of fx, fy, cx, cy, all of K, R and t."""
    dK = np.abs(K_gt - K_est)
    dP = np.abs(pose_gt - pose_est)
    return [int(epoch)] + [round(float(v), 4) for v in (
        dK[:, 0, 0].mean(), dK[:, 1, 1].mean(), dK[:, 0, 2].mean(), dK[:, 1, 2].mean(),
        dK.mean(), dP[:, :3, :3].mean(), dP[:, :3, 3:].mean())]


def camera_error_table(rows: Sequence[list]) -> str:
    return format_table(CAMERA_TABLE_HEADERS, rows)


def apply_depth_colormap(depth01: np.ndarray) -> np.ndarray:
    """[H, W] values in [0, 1] -> [H, W, 3] inferno colours, with the
    reference's clip of the index to [63, 255] (net_utils.py:219-231)."""
    idx = np.clip((np.clip(depth01, 0.0, 1.0) * 255).astype(np.int64), 63, 255)
    xs = np.linspace(0.0, 1.0, len(_INFERNO))
    t = np.arange(256) / 255.0
    table = np.stack([np.interp(t, xs, _INFERNO[:, c]) for c in range(3)], -1)
    return table[idx]


def _frustum_points(pose_c2w: np.ndarray, K: np.ndarray, img_w: int, cam_size: float):
    """Five 3D points (4 image-plane corners + center) of a camera wireframe
    (ref draw_camera_shape, mc_nerf.py:499-534)."""
    focal = K[0, 0] * cam_size / img_w
    h = cam_size / 2.0
    corners = np.array(
        [[-h, -h, -focal], [-h, h, -focal], [h, h, -focal], [h, -h, -focal]]
    )
    R, t = pose_c2w[:, :3], pose_c2w[:, 3]
    world = corners @ R.T + t
    return world, t


POSE_GT_COLOR = (0.7, 0.2, 0.7)      # purple
POSE_EST_COLOR = (0.0, 0.6, 0.7)     # teal


def view_projection(elev_deg: float = 30.0, azim_deg: float = -60.0) -> np.ndarray:
    """[2, 3] orthographic projection onto the screen (right, up) of a view
    from elevation ``elev_deg`` and azimuth ``azim_deg`` (matplotlib's
    default 3D view), +z up."""
    el, az = np.deg2rad(elev_deg), np.deg2rad(azim_deg)
    eye = np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)])
    right = np.cross([0.0, 0.0, 1.0], eye)
    right /= np.linalg.norm(right)
    return np.stack([right, np.cross(eye, right)])


def save_pose_plot(path: str, gt_c2w: np.ndarray, est_c2w: np.ndarray, K_gt: np.ndarray,
                   K_est: np.ndarray, img_w: int, lim: float = 3.5, size: int = 600) -> None:
    """GT (purple) and estimated (teal) camera wireframes in the cube
    [-lim, lim]^3, one ``size`` x ``size`` PNG (4 in at 150 dpi)."""
    from PIL import Image, ImageDraw

    proj = view_projection()
    # the limits' cube fills the image: its projection spans sqrt(3) lim at most
    scale = 0.95 * (size / 2.0) / (np.sqrt(3.0) * lim)

    def px(p):
        x, y = proj @ np.asarray(p, np.float64)
        return (size / 2.0 + scale * x, size / 2.0 - scale * y)

    img = Image.new("RGB", (size, size), (255, 255, 255))
    draw = ImageDraw.Draw(img)
    for poses, Ks, color in ((gt_c2w, K_gt, POSE_GT_COLOR), (est_c2w, K_est, POSE_EST_COLOR)):
        rgb = tuple(int(round(255 * c)) for c in color)
        for i in range(poses.shape[0]):
            pts, c = _frustum_points(poses[i], Ks[i], img_w, 0.3)
            draw.line([px(p) for p in (*pts, pts[0])], fill=rgb, width=1)
            for p in pts:
                draw.line([px(c), px(p)], fill=rgb, width=1)
            cx, cy = px(c)
            draw.ellipse([cx - 2, cy - 2, cx + 2, cy + 2], fill=rgb)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    img.save(path)
