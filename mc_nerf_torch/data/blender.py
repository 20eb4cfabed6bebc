"""Blender-format scene IO (counterpart of ``mc_nerf_tpu/data/blender.py``).

Per-split ``transforms_{split}.json`` with ``frames: [{file_path,
camera_angle_x, transform_matrix}]`` plus PNG images.  Semantics from the
reference loader (``data/data_read.py:80-152``): RGBA composited onto
white, per-frame horizontal FOV -> K, Blender c2w -> OpenCV w2c.  Host-side
numpy and PIL only.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class SplitData:
    """One split (train/val/test/calib/coord) of a scene."""

    images_u8: Optional[np.ndarray]   # [N, H, W, 3] uint8, white-composited
    poses_w2c: Optional[np.ndarray]   # [N, 3, 4] float32
    K: np.ndarray                     # [N, 3, 3] float32
    fov_x: np.ndarray                 # [N] float32 radians
    img_h: int
    img_w: int
    paths: List[str]

    @property
    def count(self) -> int:
        return len(self.paths)


def _composite_white(img) -> np.ndarray:
    """RGBA PIL image -> RGB uint8 over white (ref data_read.py:129-139)."""
    arr = np.asarray(img).astype(np.float32) / 255.0
    if arr.ndim == 2:  # grayscale
        arr = np.stack([arr] * 3, axis=-1)
    if arr.shape[-1] == 4:
        rgb, a = arr[..., :3], arr[..., 3:]
        arr = rgb * a + (1.0 - a)
    else:
        arr = arr[..., :3]
    return np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _blender_pose_to_w2c_np(c2w: np.ndarray) -> np.ndarray:
    """Blender c2w -> OpenCV w2c [3, 4] (ref data_read.py:246-257)."""
    R = c2w[:3, :3].astype(np.float64)
    t = c2w[:3, 3].astype(np.float64)
    R_cv = R * np.array([1.0, -1.0, -1.0])
    R_w2c = R_cv.T
    t_w2c = -R_w2c @ t
    return np.concatenate([R_w2c, t_w2c[:, None]], axis=-1).astype(np.float32)


def load_split(scene_dir: str, split: str, load_images: bool = True,
               with_poses: bool = True) -> SplitData:
    """Load one ``transforms_{split}.json`` + its images."""
    from PIL import Image

    with open(os.path.join(scene_dir, f"transforms_{split}.json"), "r") as f:
        meta = json.load(f)

    paths, fovs, poses = [], [], []
    for frame in meta["frames"]:
        p = frame["file_path"]
        if not p.endswith(".png"):
            p = p + ".png"
        paths.append(os.path.join(scene_dir, p))
        fovs.append(frame["camera_angle_x"])
        if with_poses:
            poses.append(_blender_pose_to_w2c_np(np.asarray(frame["transform_matrix"])))

    images = None
    img_h = img_w = 0
    if load_images:
        imgs = []
        for p in paths:
            with Image.open(p) as im:
                arr = _composite_white(im)
            img_h, img_w = arr.shape[0], arr.shape[1]
            imgs.append(arr)
        images = np.stack(imgs, axis=0)
    elif paths and os.path.exists(paths[0]):
        with Image.open(paths[0]) as im:
            img_w, img_h = im.size

    fov_x = np.asarray(fovs, dtype=np.float32)
    # FOV -> K (ref data_read.py:141-152): fy shares the x-FOV tangent
    tan_half = np.tan(fov_x / 2.0)
    n = len(paths)
    K = np.zeros((n, 3, 3), dtype=np.float32)
    K[:, 0, 0] = (img_w / 2.0) / tan_half
    K[:, 1, 1] = (img_h / 2.0) / tan_half
    K[:, 0, 2] = img_w / 2.0
    K[:, 1, 2] = img_h / 2.0
    K[:, 2, 2] = 1.0

    return SplitData(
        images_u8=images,
        poses_w2c=np.stack(poses, axis=0) if with_poses and poses else None,
        K=K,
        fov_x=fov_x,
        img_h=img_h,
        img_w=img_w,
        paths=paths,
    )


@dataclasses.dataclass
class Scene:
    """A full multi-camera scene: the train/val/test render splits."""

    train: SplitData
    val: SplitData
    test: SplitData
    scene_dir: str

    @property
    def img_h(self) -> int:
        return self.train.img_h

    @property
    def img_w(self) -> int:
        return self.train.img_w


def load_scene(scene_dir: str, load_test_images: bool = True) -> Scene:
    """Load the train/val/test render splits of a scene directory."""
    return Scene(
        train=load_split(scene_dir, "train"),
        val=load_split(scene_dir, "val"),
        test=load_split(scene_dir, "test", load_images=load_test_images),
        scene_dir=scene_dir,
    )
