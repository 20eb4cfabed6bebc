"""Calibration-cube image renderer (numpy; own copy of
``mc_nerf_tpu/data/cube_render.py``).

Renders the calib/coord image sets: the tag cube ray-traced through each
camera on a transparent background (white after compositing), the
counterpart of the reference generator's Blender calibration renders
(``synthetic_dataset_code/Ball.py:257-314``), supersampled so the
detector finds subpixel-stable edges.  The face and tag geometry is
:mod:`mc_nerf_torch.data.cube`'s: the black tag square spans 0.8 x the
face edge, canonical tag row 0 along the 'lt' -> 'rt' edge (+v up, +u
right in the face frame).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from mc_nerf_torch.data.cube import face_frames
from mc_nerf_torch.data.tag36h11 import GRID, tag_bitmap


def _face_tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    frames = face_frames()
    normals = np.stack([f[0] for f in frames])
    us = np.stack([f[1] for f in frames])
    vs = np.stack([f[2] for f in frames])
    return normals, us, vs


def render_cube_image(
    pose_w2c: np.ndarray,
    K: np.ndarray,
    img_h: int,
    img_w: int,
    tag_size: float = 1.0,
    cube_rot: Optional[np.ndarray] = None,
    supersample: int = 2,
) -> np.ndarray:
    """Ray-trace the tag cube: returns [H, W, 4] float RGBA in [0, 1].

    Args:
      pose_w2c: [3, 4] camera pose.
      K: [3, 3] intrinsics.
      cube_rot: [3, 3] cube-to-world rotation (None = canonical / coord set).
      supersample: antialiasing factor (rays per pixel axis).
    """
    ss = supersample
    h, w = img_h * ss, img_w * ss
    K_ss = K.copy().astype(np.float64)
    K_ss[:2] *= ss

    ys, xs = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
    d_cam = np.stack(
        [(xs - K_ss[0, 2]) / K_ss[0, 0], (ys - K_ss[1, 2]) / K_ss[1, 1], np.ones_like(xs)],
        axis=-1,
    ).reshape(-1, 3)
    R, t = pose_w2c[:, :3].astype(np.float64), pose_w2c[:, 3].astype(np.float64)
    d = d_cam @ R
    o = -R.T @ t

    if cube_rot is not None:
        # rotate rays into the cube frame instead of rotating the cube
        d = d @ cube_rot
        o = cube_rot.T @ o

    half = tag_size / 2.0
    normals, us, vs = _face_tables()
    bitmaps = np.stack([tag_bitmap(i) for i in range(6)])   # [6, 8, 8]

    best_t = np.full(d.shape[0], np.inf)
    shade = np.zeros(d.shape[0], dtype=np.float32)
    hit = np.zeros(d.shape[0], dtype=bool)

    tag_half = tag_size * 0.8 / 2.0
    cell = (2 * tag_half) / GRID

    for f in range(6):
        n, u, v = normals[f], us[f], vs[f]
        dn = d @ n
        # ray hits the face plane from outside: d . n < 0
        denom = np.where(np.abs(dn) < 1e-12, 1e-12, dn)
        t_hit = (half - o @ n) / denom
        p = o + d * t_hit[:, None]
        pu = p @ u
        pv = p @ v
        on_face = (
            (dn < 0)
            & (t_hit > 1e-6)
            & (np.abs(pu) <= half)
            & (np.abs(pv) <= half)
            & (t_hit < best_t)
        )
        if not on_face.any():
            continue
        # tag lookup: row from +v (top) downward, col from -u (left) rightward
        col_f = (pu + tag_half) / cell
        row_f = (tag_half - pv) / cell
        inside = (col_f >= 0) & (col_f < GRID) & (row_f >= 0) & (row_f < GRID)
        col_i = np.clip(col_f.astype(np.int64), 0, GRID - 1)
        row_i = np.clip(row_f.astype(np.int64), 0, GRID - 1)
        val = np.where(inside, bitmaps[f][row_i, col_i], 1.0)  # white outside tag
        best_t = np.where(on_face, t_hit, best_t)
        shade = np.where(on_face, val.astype(np.float32), shade)
        hit = hit | on_face

    rgba = np.zeros((h, w, 4), dtype=np.float32)
    g = shade.reshape(h, w)
    m = hit.reshape(h, w)
    rgba[..., 0] = g
    rgba[..., 1] = g
    rgba[..., 2] = g
    rgba[..., 3] = m.astype(np.float32)

    if ss > 1:
        rgba = rgba.reshape(img_h, ss, img_w, ss, 4).mean(axis=(1, 3))
    return rgba
