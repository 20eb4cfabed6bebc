"""Per-epoch observability (own copy of the table and colormap parts of
``mc_nerf_tpu/utils/visualization.py``; ref ``model/mc_nerf.py:388-534``,
``model/net_utils.py:205-231``): the camera-error table and the
inverse-depth colormap.  The GT-vs-estimated pose plot (matplotlib there)
is not ported: matplotlib is not a dependency of the port.
"""

from __future__ import annotations

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
