"""Calibration-cube geometry: AprilTag keypoints in the cube frame (own
copy of ``mc_nerf_tpu/data/cube.py``).

One tag36h11 marker per face (ids 0-5); keypoints per tag are [center,
lt, rt, rb, lb] (ref ``data/data_read.py:300-336``).  The tag spans 0.8 x
the cube edge, and the cube edge equals ``tag_size``.
"""

from __future__ import annotations

import numpy as np

# per face: (outward normal, in-plane u, in-plane v); corner order
# [lt, rt, rb, lb] = [(-u,+v), (+u,+v), (+u,-v), (-u,-v)]
_FACES = (
    ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)),    # tag 0: y = -c
    ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)),     # tag 1: x = +c
    ((0.0, 1.0, 0.0), (-1.0, 0.0, 0.0), (0.0, 0.0, 1.0)),    # tag 2: y = +c
    ((-1.0, 0.0, 0.0), (0.0, -1.0, 0.0), (0.0, 0.0, 1.0)),   # tag 3: x = -c
    ((0.0, 0.0, 1.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0)),     # tag 4: z = +c
    ((0.0, 0.0, -1.0), (1.0, 0.0, 0.0), (0.0, -1.0, 0.0)),   # tag 5: z = -c
)


def tag_world_points(tag_size: float = 1.0) -> np.ndarray:
    """[6, 5, 3] float32 keypoints of all six tags in the cube frame."""
    cube_half = tag_size / 2.0
    tag_half = tag_size * 0.8 / 2.0
    pts = np.zeros((6, 5, 3), dtype=np.float32)
    for tag_id, face in enumerate(_FACES):
        n, u, v = (np.array(a) for a in face)
        center = n * cube_half
        pts[tag_id] = [center, center + (-u + v) * tag_half, center + (u + v) * tag_half,
                       center + (u - v) * tag_half, center + (-u - v) * tag_half]
    return pts
