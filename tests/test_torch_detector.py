"""The port's tag36h11 detector (``mc_nerf_torch/native``), its tag tables
and the cube renderer, on the port alone and against the JAX package's.

The round-trip golden tests of ``tests/test_apriltag.py`` run on the
port's copies at that file's bounds.  The tables and the renderer equal
the JAX ones exactly; the port's ``detect_tags`` gives the JAX binding's
detections exactly (the same source built with the same flags).  The JAX
binding is reached only inside test bodies, through a fixture that waits
out its first build, whose shared temporary file other test processes may
be writing at the same time.
"""

import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

from mc_nerf_tpu.data import cube_render as j_cube_render
from mc_nerf_tpu.data import tag36h11 as j_tag

from mc_nerf_torch.data import tag36h11 as t_tag
from mc_nerf_torch.data.cube import tag_world_points
from mc_nerf_torch.data.cube_render import render_cube_image
from mc_nerf_torch.data.synthetic import _blender_to_w2c_np, _look_at_c2w, _random_rotation
from mc_nerf_torch.data.tag36h11 import TAG36H11_CODES, decode_bits, tag_bitmap
from mc_nerf_torch.native import apriltag_binding as t_bind
from mc_nerf_torch.native.apriltag_binding import detect_tags, rgb_to_gray

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def j_detect():
    """The JAX binding's ``detect_tags``, once its library loads: retried
    for up to 30 s while a concurrent first build settles."""
    from mc_nerf_tpu.native import apriltag_binding as j_bind

    deadline = time.monotonic() + 30.0
    while True:
        try:
            j_bind.detect_tags(np.full((16, 16), 255, np.uint8))
            return j_bind.detect_tags
        except (OSError, subprocess.CalledProcessError):
            if time.monotonic() > deadline:
                raise
            time.sleep(0.5)


def _project(pts_w, K, w2c):
    pix = (pts_w @ w2c[:, :3].T + w2c[:, 3]) @ K.T
    return pix[:, :2] / pix[:, 2:3]


def _composite(rgba):
    return rgba[..., :3] * rgba[..., 3:] + (1 - rgba[..., 3:])


# ------------------------------------------------- the golden tests, port alone

def test_bitmap_layout():
    bm = tag_bitmap(0)
    assert bm.shape == (8, 8)
    assert bm[0].sum() == 0 and bm[-1].sum() == 0
    assert bm[:, 0].sum() == 0 and bm[:, -1].sum() == 0
    code = 0
    for r in range(6):
        for c in range(6):
            code = (code << 1) | int(bm[r + 1, c + 1])
    assert code == TAG36H11_CODES[0]


def test_decode_bits_all_rotations():
    for tag_id in range(6):
        bits = tag_bitmap(tag_id)[1:-1, 1:-1].astype(int)
        for k in range(4):
            assert decode_bits(np.rot90(bits, -k)) == (tag_id, k)


def test_detect_front_view():
    w2c = _blender_to_w2c_np(_look_at_c2w(np.array([0.2, -3.0, 0.3]), np.zeros(3)))
    K = np.array([[400.0, 0, 200], [0, 400.0, 200], [0, 0, 1]])
    dets = detect_tags(rgb_to_gray(_composite(render_cube_image(w2c, K, 400, 400,
                                                                supersample=2))))
    assert 0 in {d.tag_id for d in dets}
    pts = tag_world_points(1.0)
    for d in dets:
        err = np.abs(_project(pts[d.tag_id], K, w2c) - d.keypoints).max()
        assert err < 0.5, f"tag {d.tag_id}: keypoint err {err:.3f} px"


def test_detect_rotated_cube_subpixel():
    rng = np.random.default_rng(1)
    pts = tag_world_points(1.0)
    K = np.array([[500.0, 0, 160], [0, 500.0, 160], [0, 0, 1]])
    errs = []
    for _ in range(4):
        v = rng.normal(size=3)
        v /= np.linalg.norm(v)
        w2c = _blender_to_w2c_np(_look_at_c2w(v * 3.2, np.zeros(3)))
        R_cube = _random_rotation(rng)
        img = _composite(render_cube_image(w2c, K, 320, 320, cube_rot=R_cube, supersample=3))
        for d in detect_tags(rgb_to_gray(img)):
            errs.append(np.abs(_project(pts[d.tag_id] @ R_cube.T, K, w2c) - d.keypoints).max())
    assert len(errs) >= 4
    assert np.mean(errs) < 0.3, f"mean keypoint err {np.mean(errs):.3f} px"
    assert np.max(errs) < 1.0


def test_degenerate_tile_grids_no_crash():
    rng = np.random.default_rng(0)
    for shape in [(12, 300), (300, 12), (9, 120), (15, 200), (12, 12)]:
        g = np.full(shape, 255, np.uint8)
        h, w = shape
        for x0 in range(1, w - 9, 20):
            g[1:min(h - 1, 9), x0:x0 + 8] = 0
        assert isinstance(detect_tags(g), list)
        assert isinstance(detect_tags(rng.integers(0, 256, shape, dtype=np.uint8)), list)


@pytest.mark.parametrize("scale", [48, 64])
def test_detect_very_large_tag(scale):
    tag = np.kron(tag_bitmap(3).astype(np.uint8) * 255, np.ones((scale, scale), np.uint8))
    m = 60
    img = np.full((tag.shape[0] + 2 * m, tag.shape[1] + 2 * m), 255, np.uint8)
    img[m:m + tag.shape[0], m:m + tag.shape[1]] = tag
    dets = detect_tags(img)
    assert [d.tag_id for d in dets] == [3]
    s = 8 * scale
    want = np.array([[m, m], [m + s, m], [m + s, m + s], [m, m + s]], np.float64)
    assert np.abs(dets[0].corners - want).max() < 1.5


def test_no_false_positives_on_blank():
    assert detect_tags(np.full((200, 200), 255, np.uint8)) == []
    noise = np.random.default_rng(0).uniform(100, 255, (200, 200)).astype(np.uint8)
    assert detect_tags(noise) == []


def test_detect_tags_refuses_a_colour_image():
    with pytest.raises(ValueError, match="grayscale"):
        detect_tags(np.zeros((8, 8, 3), np.uint8))


# ------------------------------------------------------ against the JAX package

def test_tag_tables_equal_the_jax_ones():
    assert t_tag.TAG36H11_CODES == j_tag.TAG36H11_CODES
    assert (t_tag.GRID, t_tag.DATA, t_tag.N_BITS) == (j_tag.GRID, j_tag.DATA, j_tag.N_BITS)
    for tag_id in range(len(TAG36H11_CODES)):
        np.testing.assert_array_equal(t_tag.tag_bitmap(tag_id), j_tag.tag_bitmap(tag_id))
        bits = t_tag.tag_bitmap(tag_id)[1:-1, 1:-1].astype(int)
        for k in range(4):
            np.testing.assert_array_equal(t_tag.rotate_bits(bits, k), j_tag.rotate_bits(bits, k))
            assert t_tag.decode_bits(np.rot90(bits, k)) == j_tag.decode_bits(np.rot90(bits, k))


def test_detector_source_is_the_jax_packages():
    j_src = ROOT / "mc_nerf_tpu" / "native" / "apriltag" / "detector.cpp"
    assert t_bind.SRC.read_bytes() == j_src.read_bytes()


def _views(n, seed):
    """(w2c, K, h, w, cube rotation or None) of ``n`` random views of the cube."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        v = rng.normal(size=3)
        v /= np.linalg.norm(v)
        h, w = (96, 128) if i % 2 else (160, 160)
        f = rng.uniform(120.0, 260.0)
        K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
        rot = _random_rotation(rng) if i % 3 else None
        out.append((_blender_to_w2c_np(_look_at_c2w(v * rng.uniform(2.6, 3.6), np.zeros(3))),
                    K, h, w, rot))
    return out


@pytest.mark.parametrize("supersample", [1, 3])
def test_render_cube_image_equals_jax(supersample):
    for w2c, K, h, w, rot in _views(4, 11):
        np.testing.assert_array_equal(
            render_cube_image(w2c, K, h, w, 1.0, rot, supersample),
            j_cube_render.render_cube_image(w2c, K, h, w, 1.0, rot, supersample))


def test_detect_tags_equals_the_jax_binding(j_detect):
    from mc_nerf_tpu.native.apriltag_binding import rgb_to_gray as j_gray

    n_dets = 0
    for w2c, K, h, w, rot in _views(8, 12):
        rgb = _composite(render_cube_image(w2c, K, h, w, cube_rot=rot, supersample=3))
        gray = rgb_to_gray(rgb)
        np.testing.assert_array_equal(gray, j_gray(rgb))
        got, want = detect_tags(gray), j_detect(gray)
        assert [d.tag_id for d in got] == [d.tag_id for d in want]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.keypoints, b.keypoints)
        n_dets += len(got)
    assert n_dets >= 8


_BUILD_ONE = """
import pathlib, sys, time
from mc_nerf_torch.native import apriltag_binding as b
b.BUILD_ROOT = pathlib.Path(sys.argv[1])
go = pathlib.Path(sys.argv[2])
while not go.exists():
    time.sleep(0.01)
print(b.detector_available(), b.lib_path())
"""


def test_four_processes_building_at_once_all_load(tmp_path):
    go = tmp_path / "go"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONE, str(tmp_path / "build"), str(go)],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    time.sleep(1.0)      # let every process reach its wait
    go.touch()
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err for _, err in outs]
    lines = {out.strip() for out, _ in outs}
    assert len(lines) == 1 and next(iter(lines)).startswith("True "), lines
    lib = pathlib.Path(next(iter(lines)).split(" ", 1)[1])
    assert lib.exists() and lib.is_relative_to(tmp_path)
    assert [p.name for p in lib.parent.iterdir()] == [lib.name]   # no temporary left


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "detector.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(t_bind, "SRC", bad)
    monkeypatch.setattr(t_bind, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="detector.cpp"):
        t_bind.build()
    assert not any(p.is_file() for p in (tmp_path / "build").rglob("*"))
