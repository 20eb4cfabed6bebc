"""Procedural synthetic scene writer (own copy of
``mc_nerf_tpu/data/synthetic.py``).

Writes a blender-format scene: per-split ``transforms_*.json`` and RGBA
PNGs of a few lambertian spheres, ray-traced from cameras on one of the
reference's four rigs with per-camera random FOVs in [40, 80] degrees,
plus ``calibration_cache.npz``: either of tag keypoints projected through
the ground-truth cameras (``calibration_mode="analytic"``), or detected
by the tag36h11 detector in rendered calib/coord cube images
(``"rendered"``, the path of a real scene).  Given the same arguments it
writes the same files as the JAX package's ``make_dataset``.  Host-side
numpy and PIL only.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np

from mc_nerf_torch.data.calibration import CACHE_NAME, build_calibration_cache
from mc_nerf_torch.data.cube import face_frames, tag_world_points


@dataclasses.dataclass
class SphereScene:
    """A few coloured spheres inside the [-1.2, 1.2]^3 region."""

    centers: np.ndarray    # [S, 3]
    radii: np.ndarray      # [S]
    colors: np.ndarray     # [S, 3]
    light_dir: np.ndarray  # [3] unit


def default_scene() -> SphereScene:
    centers = np.array([[0.0, 0.0, 0.0], [0.55, 0.35, 0.3], [-0.45, -0.25, -0.35],
                        [0.1, -0.55, 0.45]])
    radii = np.array([0.5, 0.28, 0.32, 0.22])
    colors = np.array([[0.85, 0.25, 0.2], [0.2, 0.6, 0.85], [0.3, 0.8, 0.3],
                       [0.9, 0.8, 0.2]])
    light = np.array([0.4, 0.25, 0.88])
    return SphereScene(centers, radii, colors, light / np.linalg.norm(light))


def render_spheres(scene: SphereScene, pose_w2c: np.ndarray, K: np.ndarray, img_h: int,
                   img_w: int) -> np.ndarray:
    """Ray-trace one RGBA view: [H, W, 4] float in [0, 1]."""
    ys, xs = np.meshgrid(np.arange(img_h) + 0.5, np.arange(img_w) + 0.5, indexing="ij")
    d_cam = np.stack([(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1], np.ones_like(xs)],
                     axis=-1).reshape(-1, 3)
    R, t = pose_w2c[:, :3], pose_w2c[:, 3]
    d = d_cam @ R  # R^T d per row
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = -R.T @ t

    best_t = np.full(d.shape[0], np.inf)
    best_s = np.full(d.shape[0], -1, dtype=np.int32)
    for s, (c, r) in enumerate(zip(scene.centers, scene.radii)):
        oc = o - c
        b = np.einsum("pd,d->p", d, oc)
        disc = b * b - (np.dot(oc, oc) - r * r)
        hit = disc > 0
        t_hit = -b - np.sqrt(np.where(hit, disc, 0.0))
        valid = hit & (t_hit > 1e-3) & (t_hit < best_t)
        best_t = np.where(valid, t_hit, best_t)
        best_s = np.where(valid, s, best_s)

    rgba = np.zeros((d.shape[0], 4), dtype=np.float32)
    hit_mask = best_s >= 0
    if hit_mask.any():
        pts = o + d[hit_mask] * best_t[hit_mask, None]
        sid = best_s[hit_mask]
        normals = (pts - scene.centers[sid]) / scene.radii[sid, None]
        lambert = np.clip(normals @ scene.light_dir, 0.0, 1.0)
        rgba[hit_mask, :3] = scene.colors[sid] * (0.35 + 0.65 * lambert)[:, None]
        rgba[hit_mask, 3] = 1.0
    return rgba.reshape(img_h, img_w, 4)


# ---------------------------------------------------------------- camera rigs

def _look_at_c2w(pos: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Blender-convention c2w (camera -Z forward, +Y up): [4, 4]."""
    f = target - pos
    f = f / np.linalg.norm(f)
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(f, up)) > 0.999:
        up = np.array([0.0, 1.0, 0.0])
    r = np.cross(f, up)
    r /= np.linalg.norm(r)
    u = np.cross(r, f)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = r, u, -f, pos
    return c2w


def _on_sphere(radius: float, phi: float, theta: float) -> np.ndarray:
    """The point at elevation ``phi`` and azimuth ``theta`` (radians)."""
    return radius * np.array([np.cos(phi) * np.cos(theta), np.cos(phi) * np.sin(theta),
                              np.sin(phi)])


def ball_rig(n_cams: int, radius: float = 3.0, rng: Optional[np.random.Generator] = None,
             fov_range: Tuple[float, float] = (40.0, 80.0)) -> Tuple[np.ndarray, np.ndarray]:
    """Cameras on a sphere looking at the origin (the reference's Ball rig,
    ``synthetic_dataset_code/Ball.py:163-224``): lat/lon bands + random
    FOVs.  Returns (c2w [N, 4, 4], fov_x [N] radians)."""
    rng = rng or np.random.default_rng(0)
    poses = []
    n_az = max(4, int(np.ceil(np.sqrt(n_cams * 1.5))))
    for el in np.linspace(-55, 75, max(2, int(np.ceil(n_cams / n_az)))):
        for az in np.linspace(0, 360, n_az, endpoint=False):
            if len(poses) >= n_cams:
                break
            el_j = el + rng.uniform(-4, 4)
            az_j = az + rng.uniform(-4, 4)
            poses.append(_look_at_c2w(_on_sphere(radius, np.deg2rad(el_j), np.deg2rad(az_j)),
                                      np.zeros(3)))
    fov = np.deg2rad(rng.uniform(fov_range[0], fov_range[1], size=n_cams))
    return np.stack(poses[:n_cams], axis=0), fov


def orbit_rig(n_cams: int, radius: float = 3.0, elevation_deg: float = 25.0,
              fov_deg: float = 60.0) -> Tuple[np.ndarray, np.ndarray]:
    """Circular test trajectory (the reference's 200 test views)."""
    phi = np.deg2rad(elevation_deg)
    poses = [_look_at_c2w(_on_sphere(radius, phi, theta), np.zeros(3))
             for theta in np.linspace(0, 2 * np.pi, n_cams, endpoint=False)]
    return np.stack(poses, axis=0), np.full(n_cams, np.deg2rad(fov_deg))


def _random_fovs(n, rng, fov_range=(40.0, 80.0)):
    rng = rng or np.random.default_rng(0)
    return np.deg2rad(rng.uniform(fov_range[0], fov_range[1], size=n)), rng


def array_rig(n_cams: int, z: float = -4.0, extent: float = 2.4,
              rng: Optional[np.random.Generator] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Planar camera grid at fixed z looking at the origin (the reference's
    Array rig, ``synthetic_dataset_code/Array.py:21-28, 169-224``)."""
    fov, rng = _random_fovs(n_cams, rng)
    xs = np.linspace(-extent, extent, int(np.ceil(np.sqrt(n_cams))))
    poses = []
    for yy in xs:
        for xx in xs:
            if len(poses) >= n_cams:
                break
            poses.append(_look_at_c2w(np.array([xx, yy, z]), np.zeros(3)))
    return np.stack(poses[:n_cams], axis=0), fov


def halfball_rig(n_cams: int, radius: float = 3.0,
                 rng: Optional[np.random.Generator] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Cameras on the upper hemisphere (the reference's HalfBall rig,
    ``synthetic_dataset_code/HalfBall.py:18-23, 162-215``)."""
    fov, rng = _random_fovs(n_cams, rng)
    n_az = max(4, int(np.ceil(np.sqrt(n_cams * 1.5))))
    poses = []
    for el in np.linspace(5, 80, max(2, int(np.ceil(n_cams / n_az)))):
        for az in np.linspace(0, 360, n_az, endpoint=False):
            if len(poses) >= n_cams:
                break
            phi = np.deg2rad(el + rng.uniform(-3, 3))
            theta = np.deg2rad(az + rng.uniform(-3, 3))
            poses.append(_look_at_c2w(_on_sphere(radius, phi, theta), np.zeros(3)))
    return np.stack(poses[:n_cams], axis=0), fov


def room_rig(n_cams: int, size: Tuple[float, float, float] = (6.0, 4.0, 3.0),
             rng: Optional[np.random.Generator] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Cameras on the walls and ceiling of a box looking inward (the
    reference's Room rig, ``synthetic_dataset_code/Room.py:18-29, 171-363``)."""
    fov, rng = _random_fovs(n_cams, rng)
    hx, hy, hz = size[0] / 2, size[1] / 2, size[2] / 2
    poses = []
    for _ in range(n_cams):
        w = rng.integers(0, 5)
        u, v = rng.uniform(-0.8, 0.8, size=2)
        pos = (np.array([hx, u * hy, v * hz]), np.array([-hx, u * hy, v * hz]),
               np.array([u * hx, hy, v * hz]), np.array([u * hx, -hy, v * hz]),
               np.array([u * hx, v * hy, hz]))[w]
        poses.append(_look_at_c2w(pos, np.zeros(3)))
    return np.stack(poses, axis=0), fov


RIGS = {"ball": ball_rig, "array": array_rig, "halfball": halfball_rig, "room": room_rig}


# ------------------------------------------------- calibration (analytic)

def _project(pts_w: np.ndarray, K: np.ndarray, pose_w2c: np.ndarray) -> np.ndarray:
    pix = (pts_w @ pose_w2c[:, :3].T + pose_w2c[:, 3]) @ K.T
    return pix[:, :2] / pix[:, 2:3]


def _random_rotation(rng: np.random.Generator) -> np.ndarray:
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def generate_detections(poses_w2c: np.ndarray, K: np.ndarray, img_h: int, img_w: int,
                        tag_size: float, rng: np.random.Generator,
                        randomize_cube: bool) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Analytic tag keypoint detections for every camera.

    Coord images see the cube at its canonical orientation (the shared
    world frame); calib images at a per-image random one, drawn again
    until >= 2 tags are visible (as the reference generator re-rolls,
    ``Ball.py:257-314``).  Returns pts [N, 6, 5, 2], valid [N, 6] bool,
    cube_rots [N, 3, 3]."""
    n = poses_w2c.shape[0]
    cube_pts = tag_world_points(tag_size)
    pts = np.zeros((n, 6, 5, 2), dtype=np.float32)
    valid = np.zeros((n, 6), dtype=bool)
    rots = np.zeros((n, 3, 3), dtype=np.float32)
    normals = np.stack([f[0] for f in face_frames()], axis=0)

    for i in range(n):
        cam_center = -poses_w2c[i, :, :3].T @ poses_w2c[i, :, 3]
        for _ in range(100):
            R_cube = _random_rotation(rng) if randomize_cube else np.eye(3)
            ok = np.zeros(6, dtype=bool)
            proj = np.zeros((6, 5, 2), dtype=np.float32)
            for tag in range(6):
                world = cube_pts[tag] @ R_cube.T
                view = cam_center - world[0]
                # the face must look toward the camera at a usable grazing angle
                if (R_cube @ normals[tag]) @ view / np.linalg.norm(view) < 0.25:
                    continue
                p = _project(world, K[i], poses_w2c[i])
                if ((p[:, 0] > 2).all() and (p[:, 0] < img_w - 2).all()
                        and (p[:, 1] > 2).all() and (p[:, 1] < img_h - 2).all()):
                    proj[tag] = p
                    ok[tag] = True
            if ok.sum() >= (2 if randomize_cube else 1) or not randomize_cube:
                pts[i], valid[i], rots[i] = proj, ok, R_cube
                break
        else:
            raise RuntimeError(f"no valid cube orientation found for camera {i}")
    return pts, valid, rots


# ------------------------------------------------------------------ writer

def _blender_to_w2c_np(c2w: np.ndarray) -> np.ndarray:
    R_w2c = (c2w[:3, :3] * np.array([1.0, -1.0, -1.0])).T
    return np.concatenate([R_w2c, (-R_w2c @ c2w[:3, 3])[:, None]], axis=-1)


def _intrinsics(fov: float, img_h: int, img_w: int) -> np.ndarray:
    """[3, 3] intrinsics of a horizontal FOV (radians), the reference's formula."""
    tan_half = np.tan(fov / 2.0)
    return np.array([[(img_w / 2.0) / tan_half, 0, img_w / 2.0],
                     [0, (img_h / 2.0) / tan_half, img_h / 2.0], [0, 0, 1.0]])


def _write_split(scene_dir: str, split: str, c2w: np.ndarray, fov: np.ndarray,
                 scene: Optional[SphereScene], img_h: int, img_w: int) -> None:
    from PIL import Image

    os.makedirs(os.path.join(scene_dir, split), exist_ok=True)
    frames = []
    for i in range(c2w.shape[0]):
        rel = f"./{split}/r_{i}"
        frames.append({"file_path": rel, "camera_angle_x": float(fov[i]),
                       "transform_matrix": c2w[i].tolist()})
        if scene is not None:
            rgba = render_spheres(scene, _blender_to_w2c_np(c2w[i]),
                                  _intrinsics(fov[i], img_h, img_w), img_h, img_w)
            Image.fromarray((rgba * 255 + 0.5).astype(np.uint8), "RGBA").save(
                os.path.join(scene_dir, rel + ".png"))
    with open(os.path.join(scene_dir, f"transforms_{split}.json"), "w") as f:
        json.dump({"frames": frames}, f)


def _write_cube_split(scene_dir: str, split: str, c2w: np.ndarray, fov: np.ndarray,
                      img_h: int, img_w: int, tag_size: float, rng: np.random.Generator,
                      randomize_cube: bool) -> np.ndarray:
    """Render the calibration cube through each camera of a split.  With
    ``randomize_cube`` (the calib shots) the cube's orientation is drawn
    again until the detector finds >= 2 tags (ref ``Ball.py:246-313``).
    Returns the cube rotations, [N, 3, 3]."""
    from PIL import Image

    from mc_nerf_torch.data.cube_render import render_cube_image
    from mc_nerf_torch.native.apriltag_binding import detect_tags, rgb_to_gray

    os.makedirs(os.path.join(scene_dir, split), exist_ok=True)
    n = c2w.shape[0]
    rots = np.zeros((n, 3, 3), dtype=np.float32)
    frames = []
    for i in range(n):
        rel = f"./{split}/r_{i}"
        frames.append({"file_path": rel, "camera_angle_x": float(fov[i]),
                       "transform_matrix": c2w[i].tolist()})
        K = _intrinsics(fov[i], img_h, img_w)
        w2c = _blender_to_w2c_np(c2w[i])
        for _ in range(100):
            R_cube = _random_rotation(rng) if randomize_cube else None
            rgba = render_cube_image(w2c, K, img_h, img_w, tag_size, cube_rot=R_cube,
                                     supersample=3)
            rgb = rgba[..., :3] * rgba[..., 3:] + (1.0 - rgba[..., 3:])
            if not randomize_cube or len(detect_tags(rgb_to_gray(rgb))) >= 2:
                Image.fromarray((rgba * 255 + 0.5).astype(np.uint8), "RGBA").save(
                    os.path.join(scene_dir, rel + ".png"))
                rots[i] = R_cube if R_cube is not None else np.eye(3)
                break
        else:
            raise RuntimeError(f"no detectable cube orientation for camera {i}")
    with open(os.path.join(scene_dir, f"transforms_{split}.json"), "w") as f:
        json.dump({"frames": frames}, f)
    return rots


def make_dataset(scene_dir: str, n_train: int = 16, n_val: int = 2, n_test: int = 4,
                 img_h: int = 64, img_w: int = 64, tag_size: float = 1.0, seed: int = 0,
                 calibration_mode: str = "analytic", rig: str = "ball") -> None:
    """Write a blender-format scene and its calibration cache.

    The calib and coord splits reuse the train cameras (the same rig
    photographs the cube), as the reference datasets do.
    ``calibration_mode``: 'analytic', the cube's keypoints projected
    through the ground-truth cameras (no cube images); or 'rendered', cube
    images rendered and the cache built from them by the tag36h11 detector.
    ``rig``: 'ball' | 'array' | 'halfball' | 'room', the reference's four
    dataset styles.
    """
    if calibration_mode not in ("analytic", "rendered"):
        raise ValueError(f"unknown calibration_mode {calibration_mode!r} (analytic | rendered)")
    rng = np.random.default_rng(seed)
    scene = default_scene()
    os.makedirs(scene_dir, exist_ok=True)

    c2w_train, fov_train = RIGS[rig](n_train, rng=rng)
    c2w_val, fov_val = orbit_rig(n_val, elevation_deg=35.0)
    c2w_test, fov_test = orbit_rig(n_test, elevation_deg=20.0)
    _write_split(scene_dir, "train", c2w_train, fov_train, scene, img_h, img_w)
    _write_split(scene_dir, "val", c2w_val, fov_val, scene, img_h, img_w)
    _write_split(scene_dir, "test", c2w_test, fov_test, scene, img_h, img_w)

    if calibration_mode == "rendered":
        _write_cube_split(scene_dir, "coord", c2w_train, fov_train, img_h, img_w, tag_size, rng,
                          randomize_cube=False)
        _write_cube_split(scene_dir, "calib", c2w_train, fov_train, img_h, img_w, tag_size, rng,
                          randomize_cube=True)
        build_calibration_cache(scene_dir, overwrite=True)
        return

    # pose-only calib/coord JSONs and analytic detections
    _write_split(scene_dir, "coord", c2w_train, fov_train, None, img_h, img_w)
    _write_split(scene_dir, "calib", c2w_train, fov_train, None, img_h, img_w)
    w2c = np.stack([_blender_to_w2c_np(c) for c in c2w_train], axis=0)
    tan_half = np.tan(fov_train / 2.0)
    K = np.zeros((n_train, 3, 3), dtype=np.float64)
    K[:, 0, 0] = (img_w / 2.0) / tan_half
    K[:, 1, 1] = (img_h / 2.0) / tan_half
    K[:, 0, 2] = img_w / 2.0
    K[:, 1, 2] = img_h / 2.0
    K[:, 2, 2] = 1.0
    coord_pts, coord_valid, _ = generate_detections(w2c, K, img_h, img_w, tag_size, rng,
                                                    randomize_cube=False)
    calib_pts, calib_valid, calib_rots = generate_detections(w2c, K, img_h, img_w, tag_size,
                                                             rng, randomize_cube=True)
    np.savez(os.path.join(scene_dir, CACHE_NAME), calib_pts=calib_pts,
             calib_valid=calib_valid, coord_pts=coord_pts, coord_valid=coord_valid,
             calib_cube_rots=calib_rots, tag_size=np.float32(tag_size))
