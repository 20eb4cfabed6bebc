"""Calibration detections: the cache, the function that writes it, and per-step tag
sampling (own copy of ``mc_nerf_tpu/data/calibration.py``).

Detections live in a fixed-shape cache (``calibration_cache.npz``: pts
[N, 6, 5, 2], valid [N, 6]), read with numpy.  :func:`build_calibration_cache`
writes it by running the tag36h11 detector (``native/apriltag_binding.py``)
over a scene's calib/coord images, as the reference runs libapriltag at
start-up; synthetic scenes may ship an analytic one instead.  The per-step
"one random visible tag per camera" choice runs on the device from
uniforms passed in, so the same draws can be handed to the JAX package.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from mc_nerf_torch import resolve_device
from mc_nerf_torch.data.cube import tag_world_points

CACHE_NAME = "calibration_cache.npz"


class CalibrationData(NamedTuple):
    """Device-resident calibration tensors for one scene."""

    calib_pts: torch.Tensor      # [N, 6, 5, 2] detected keypoints (calib set)
    coord_pts: torch.Tensor      # [N, 6, 5, 2] detected keypoints (coord set)
    # valid tag ids per image, padded by repeating the first valid id
    calib_tag_ids: torch.Tensor  # [N, 6] int64
    coord_tag_ids: torch.Tensor  # [N, 6] int64
    calib_counts: torch.Tensor   # [N] int64 number of valid tags
    coord_counts: torch.Tensor   # [N] int64
    cube_pts: torch.Tensor       # [6, 5, 3] tag keypoints in the cube frame


def pad_valid_ids(valid: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[N, 6] bool -> ([N, 6] padded valid tag ids, [N] counts)."""
    n = valid.shape[0]
    ids = np.zeros((n, 6), dtype=np.int64)
    counts = np.zeros((n,), dtype=np.int64)
    for i in range(n):
        v = np.flatnonzero(valid[i])
        if len(v) == 0:
            raise ValueError(f"image {i} has no detected tags — invalid calibration data "
                             "(the reference aborts here too, data_read.py:208-212)")
        counts[i] = len(v)
        ids[i] = np.concatenate([v, np.full(6 - len(v), v[0])])
    return ids, counts


def calibration_from_numpy(calib_pts, calib_valid, coord_pts, coord_valid,
                           tag_size: float = 1.0, device=None) -> CalibrationData:
    """Stage detections ([N, 6, 5, 2] points, [N, 6] valid masks) on the device."""
    dev = resolve_device(device)
    calib_ids, calib_counts = pad_valid_ids(np.asarray(calib_valid, bool))
    coord_ids, coord_counts = pad_valid_ids(np.asarray(coord_valid, bool))
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    return CalibrationData(t(calib_pts), t(coord_pts), t(calib_ids, torch.int64),
                           t(coord_ids, torch.int64), t(calib_counts, torch.int64),
                           t(coord_counts, torch.int64), t(tag_world_points(tag_size)))


def load_calibration(scene_dir: str, tag_size: float = 1.0, device=None) -> CalibrationData:
    """Read the detection cache with numpy and stage it on the device."""
    cache = np.load(os.path.join(scene_dir, CACHE_NAME))
    ts = float(cache["tag_size"]) if "tag_size" in cache else tag_size
    return calibration_from_numpy(cache["calib_pts"], cache["calib_valid"],
                                  cache["coord_pts"], cache["coord_valid"], ts, device)


def build_calibration_cache(scene_dir: str, overwrite: bool = False) -> str:
    """Run the tag36h11 detector over the calib and coord images and write
    the detection cache, unless it exists (or with ``overwrite``).  Like the
    reference (``data/data_read.py:208-212``), an image with no detection
    aborts.  Returns the cache's path."""
    out_path = os.path.join(scene_dir, CACHE_NAME)
    if os.path.exists(out_path) and not overwrite:
        return out_path

    from mc_nerf_torch.data.blender import load_split
    from mc_nerf_torch.native.apriltag_binding import detect_tags, rgb_to_gray

    arrays = {}
    for split in ("calib", "coord"):
        data = load_split(scene_dir, split, load_images=True, with_poses=False)
        pts = np.zeros((data.count, 6, 5, 2), dtype=np.float32)
        valid = np.zeros((data.count, 6), dtype=bool)
        for i in range(data.count):
            dets = detect_tags(rgb_to_gray(data.images_u8[i]))
            if not dets:
                raise ValueError(f"no tags detected in {split} image {i} — invalid "
                                 "calibration data (the reference aborts here too)")
            for d in dets:
                if 0 <= d.tag_id < 6:
                    pts[i, d.tag_id] = d.keypoints
                    valid[i, d.tag_id] = True
        arrays[f"{split}_pts"] = pts
        arrays[f"{split}_valid"] = valid
    np.savez(out_path, tag_size=np.float32(1.0), **arrays)
    return out_path


def sample_tags(u: torch.Tensor, pts: torch.Tensor, tag_ids: torch.Tensor,
                counts: torch.Tensor,
                cube_pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pick one visible tag per camera from uniforms ``u`` [N] in [0, 1)
    (ref ``data/data_read.py:226``).

    Returns (world_pts [N, 5, 3], pixel_pts [N, 5, 2]) for the chosen tags.
    """
    slot = torch.minimum((u * counts).to(torch.int64), counts - 1)
    chosen = torch.gather(tag_ids, 1, slot[:, None])[:, 0]                 # [N]
    pix = pts[torch.arange(pts.shape[0], device=pts.device), chosen]
    return cube_pts[chosen], pix
