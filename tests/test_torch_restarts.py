"""The engine's helpers in the port against the JAX package, on the CPU:
the synthetic scene writer, planar PnP, the camera restarts, checkpoint
retention, the demo's checkpoint selector, the schedule's stage map and
the train-state carry-over.

Tolerances (each measured on these inputs, set ~10x above it):
  * ``make_dataset``: every file the same bytes, the calibration cache's
    arrays equal (exact);
  * ``homography_dlt`` / ``solve_planar_pnp``: the JAX tests' own bounds
    (``tests/test_pnp.py``: H to 1e-4 of the truth, poses to 5e-3), and
    the same against the JAX function (measured 1.9e-5 on H, 2.7e-6 on
    the poses);
  * ``tag_pose_to_frame_pose``: 1e-6 (fp32 multiply-sums both sides);
  * ``improve_cameras``: the adoption masks exact, the new camera values
    within 5e-5 (measured 5.2e-6 on the twists, 6e-8 on fx / fy);
  * ``per_camera_losses``: rtol 1e-4, atol 1e-12 (measured 5.4e-6
    relative on the residuals of stuck cameras, 5.6e-14 absolute on the
    ~7e-12 of converged ones);
  * retention, the demo's selector, the stage map: exact.
"""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_nerf_tpu import config as j_config
from mc_nerf_tpu.cameras import lie as j_lie
from mc_nerf_tpu.cameras import pnp as j_pnp
from mc_nerf_tpu.data import calibration as j_calib
from mc_nerf_tpu.data.blender import load_scene as j_load_scene
from mc_nerf_tpu.data.synthetic import make_dataset as j_make_dataset
from mc_nerf_tpu.models import camera_params as j_cam
from mc_nerf_tpu.models.nerf import init_nerf_params as j_init_nerf
from mc_nerf_tpu.train import engine as j_engine
from mc_nerf_tpu.train import optim as j_optim
from mc_nerf_tpu.train import restarts as j_restarts
from mc_nerf_tpu.train.checkpoint import Checkpointer as JCheckpointer
from mc_nerf_tpu.train.steps import TrainState as JTrainState

from mc_nerf_torch import config as t_config
from mc_nerf_torch.cameras import pnp as t_pnp
from mc_nerf_torch.data import calibration as t_calib
from mc_nerf_torch.data.synthetic import make_dataset as t_make_dataset
from mc_nerf_torch.models import camera_params as t_cam
from mc_nerf_torch.train import engine as t_engine
from mc_nerf_torch.train import optim as t_optim
from mc_nerf_torch.train import restarts as t_restarts
from mc_nerf_torch.train.checkpoint import STATE_FILE, Checkpointer
from mc_nerf_torch.train.optim import FlatOptState, counter
from mc_nerf_torch.train.steps import TrainState, train_state_from_numpy

CPU = "cpu"


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


# ---------------------------------------------------------------- the scene

@pytest.mark.parametrize("rig", ["ball", "array", "halfball", "room"])
def test_make_dataset_writes_the_same_files(tmp_path, rig):
    """Same arguments, same files: transforms_*.json and PNGs byte for
    byte, the calibration cache's arrays equal."""
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(n_train=6, n_val=1, n_test=2, img_h=20, img_w=24, seed=5, rig=rig)
    j_make_dataset(a, **kw)
    t_make_dataset(b, **kw)
    names = sorted(os.path.relpath(os.path.join(r, f), a) for r, _, fs in os.walk(a) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(r, f), b)
                           for r, _, fs in os.walk(b) for f in fs)
    assert any(n.endswith(".png") for n in names)
    for n in names:
        if n.endswith(".npz"):
            ja, ta = np.load(os.path.join(a, n)), np.load(os.path.join(b, n))
            assert set(ja) == set(ta)
            for k in ja:
                np.testing.assert_array_equal(ta[k], ja[k])
        else:
            assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n), shallow=False), n


def test_make_dataset_refuses_rendered_calibration(tmp_path):
    """``calibration_mode="rendered"`` writes the cube images and the cache
    the detector builds from them (>= 2 tags in each calib view, as its
    re-rolls ask); a mode other than the two is refused.  Parity of the
    files with the JAX package is ``tests/test_torch_cli.py``'s."""
    d = str(tmp_path / "s")
    t_make_dataset(d, n_train=2, n_val=1, n_test=1, img_h=64, img_w=64, seed=4,
                   calibration_mode="rendered")
    for split in ("calib", "coord"):
        assert sorted(os.listdir(os.path.join(d, split))) == ["r_0.png", "r_1.png"]
    cache = np.load(os.path.join(d, t_calib.CACHE_NAME))
    assert cache["calib_valid"].sum(1).min() >= 2 and cache["coord_valid"].sum(1).min() >= 1
    assert cache["calib_pts"].shape == (2, 6, 5, 2)
    with pytest.raises(ValueError, match="calibration_mode"):
        t_make_dataset(str(tmp_path / "x"), n_train=2, calibration_mode="detected")


# ---------------------------------------------------------------- planar PnP

def _K(fov_deg, h, w):
    f = (w / 2.0) / np.tan(np.deg2rad(fov_deg) / 2.0)
    return np.array([[f, 0, w / 2.0], [0, (h / 2.0) / np.tan(np.deg2rad(fov_deg) / 2.0), h / 2.0],
                     [0, 0, 1.0]], np.float32)


def _plane_views(rng, K, n, push):
    h = 0.4
    plane = np.array([[0, 0], [-h, h], [h, h], [h, -h], [-h, -h]], np.float32)
    poses, pixes = [], []
    while len(poses) < n:
        wu = rng.normal(size=(6,)).astype(np.float32) * 0.5
        wu[5] = push
        pose = np.asarray(j_lie.se3_to_SE3(jnp.asarray(wu)))
        cam = np.concatenate([plane, np.zeros((5, 1), np.float32)], -1) @ pose[:, :3].T + pose[:, 3]
        if (cam[:, 2] <= 0.5).any():
            continue
        pix = cam @ K.T
        poses.append(pose)
        pixes.append((pix[:, :2] / pix[:, 2:3]).astype(np.float32))
    return plane, np.stack(poses), np.stack(pixes)


def test_homography_dlt_matches_jax(rng):
    """The exact homography to 1e-4 (the JAX test's bound), as JAX finds it."""
    H_true = np.array([[1.2, 0.1, 5.0], [-0.2, 0.9, 3.0], [1e-3, -2e-3, 1.0]])
    src = rng.uniform(-1, 1, size=(8, 2)).astype(np.float32)
    dst_h = np.concatenate([src, np.ones((8, 1))], -1) @ H_true.T
    dst = (dst_h[:, :2] / dst_h[:, 2:3]).astype(np.float32)
    H = t_pnp.homography_dlt(_t(src), _t(dst)).numpy()
    Hj = np.asarray(j_pnp.homography_dlt(jnp.asarray(src), jnp.asarray(dst)))
    np.testing.assert_allclose(H / H[2, 2], H_true, atol=1e-4)
    np.testing.assert_allclose(H / H[2, 2], Hj / Hj[2, 2], atol=1e-4)


def test_solve_planar_pnp_matches_jax(rng):
    """Batched poses of seeded planes: the truth and the JAX function's
    answer to 5e-3 (the JAX test's bound)."""
    K = _K(60.0, 320, 320)
    plane, poses, pixes = _plane_views(rng, K, 6, 3.5)
    Ks = np.broadcast_to(K, (6, 3, 3))
    got = t_pnp.solve_planar_pnp(_t(np.stack([plane] * 6)), _t(pixes), _t(Ks)).numpy()
    want = np.asarray(j_pnp.solve_planar_pnp(jnp.asarray(np.stack([plane] * 6)),
                                             jnp.asarray(pixes), jnp.asarray(Ks)))
    np.testing.assert_allclose(got, poses, atol=5e-3)
    np.testing.assert_allclose(got, want, atol=5e-3)


def test_tag_pose_to_frame_pose_matches_jax(rng):
    pose = np.asarray(j_lie.se3_to_SE3(jnp.asarray(rng.normal(size=(4, 6)).astype(np.float32))))
    frame = rng.normal(size=(4, 3, 3)).astype(np.float32)
    origin = rng.normal(size=(4, 3)).astype(np.float32)
    args = (pose, origin, frame[:, 0], frame[:, 1], frame[:, 2])
    np.testing.assert_allclose(t_pnp.tag_pose_to_frame_pose(*map(_t, args)).numpy(),
                               np.asarray(j_pnp.tag_pose_to_frame_pose(*map(jnp.asarray, args))),
                               atol=1e-6)


# ---------------------------------------------------------- camera restarts

@pytest.fixture(scope="module")
def cal_scene(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cal") / "Cal_Spheres")
    j_make_dataset(d, n_train=8, n_val=1, n_test=1, img_h=48, img_w=48, seed=11)
    return d


def _perturbed_cameras(scene_dir, seed):
    """Ground-truth cameras, each perturbed by its own scale: some near
    converged (1e-5), some far off (a few tenths to 2): stuck ones."""
    sc = j_load_scene(scene_dir)
    gt = j_cam.init_camera_params_from_gt(jnp.asarray(sc.train.poses_w2c),
                                          jnp.asarray(sc.train.K), 48, 48)
    rng = np.random.default_rng(seed)
    scale = rng.permutation(np.array([1e-5, 1e-4, 0.5, 0.5, 1e-3, 2.0, 0.3, 1e-5], np.float32))
    return gt._replace(
        pose_se3=gt.pose_se3 + jnp.asarray(rng.normal(size=(8, 6)).astype(np.float32)
                                           * scale[:, None]),
        fx=gt.fx * jnp.asarray(1 + rng.normal(size=8).astype(np.float32) * scale),
        calib_pose_se3=jnp.asarray(rng.normal(size=(8, 6)).astype(np.float32)))


@pytest.mark.parametrize("seed", [0, 1])
def test_improve_cameras_matches_jax(cal_scene, seed):
    """The same adoption masks (exact) and new camera values (5e-5)."""
    cam = _perturbed_cameras(cal_scene, seed)
    nerf = j_init_nerf(jax.random.PRNGKey(0), j_config.NerfConfig(
        coarse_depth=1, coarse_width=8, coarse_skips=(), fine_depth=1, fine_width=8,
        fine_skips=()))
    jnew, jap, jac = jax.jit(j_restarts.improve_cameras, static_argnums=(3, 4))(
        jax.random.PRNGKey(0), j_optim.Params(cam, nerf), j_calib.load_calibration(cal_scene),
        48, 48)
    tcam = t_cam.camera_params_from_numpy(jax.tree.map(np.asarray, cam), CPU)
    new, ap, ac = t_restarts.improve_cameras(tcam, t_calib.load_calibration(cal_scene, device=CPU),
                                             48, 48)
    np.testing.assert_array_equal(ap.numpy(), np.asarray(jap))
    np.testing.assert_array_equal(ac.numpy(), np.asarray(jac))
    assert 0 < int(ap.sum()) < 8          # some adopted, some kept
    for f in t_cam.FIELDS:
        np.testing.assert_allclose(new[f].numpy(), np.asarray(getattr(jnew.cam, f)), atol=5e-5)


def test_per_camera_losses_match_jax(cal_scene):
    cam = _perturbed_cameras(cal_scene, 0)
    nerf = j_init_nerf(jax.random.PRNGKey(0), j_config.NerfConfig(
        coarse_depth=1, coarse_width=8, coarse_skips=(), fine_depth=1, fine_width=8,
        fine_skips=()))
    want = j_restarts.per_camera_losses(j_optim.Params(cam, nerf),
                                        j_calib.load_calibration(cal_scene), 48, 48)
    got = t_restarts.per_camera_losses(t_cam.camera_params_from_numpy(
        jax.tree.map(np.asarray, cam), CPU), t_calib.load_calibration(cal_scene, device=CPU),
        48, 48)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-12)


# ---------------------------------------------------------------- checkpoints

def _port_state(e):
    z = torch.zeros(2)
    return TrainState(None, torch.full((4,), float(e)),
                      (FlatOptState(z, z + e, counter(e, "cpu")),), counter(e, "cpu"))


def _jax_state(e):
    return JTrainState(params=jnp.full((4,), float(e)), opt_states=(jnp.zeros((2,)),),
                       step=jnp.asarray(e, jnp.int32))


@pytest.mark.parametrize("max_keep,keep,n", [(2, (1, 3), 7), (1, (0, 1, 4), 5), (0, (0,), 4),
                                             (3, (), 6)])
def test_retention_keeps_what_the_jax_checkpointer_keeps(tmp_path, max_keep, keep, n):
    """The same saves keep the same epochs as the JAX package's orbax
    Checkpointer with the same max_keep and stage boundaries."""
    jck = JCheckpointer(str(tmp_path / "jax"), max_keep=max_keep, keep_epochs=keep)
    ck = Checkpointer(str(tmp_path / "port"), max_keep=max_keep, keep_epochs=keep)
    for e in range(n):
        jck.save(e, _jax_state(e))
        ck.save(e, _port_state(e))
    jck.close()
    want = sorted(int(d) for d in os.listdir(tmp_path / "jax") if d.isdigit())
    assert ck.epochs() == want
    assert ck.latest_epoch() == n - 1


def test_checkpoint_round_trip_and_atomic_name(tmp_path):
    """A restore copies into the state's own buffer (the parameters stay
    its views), replaces the optimizer states and the step; no temporary
    file is left; a checkpoint of another model is refused."""
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(3, _port_state(3))
    assert os.listdir(tmp_path / "ck" / "3") == [STATE_FILE]
    state = _port_state(0)
    buf = state.p_flat
    _, epoch = ck.restore(state)
    assert epoch == 3 and state.step == 3 and state.p_flat is buf
    assert torch.equal(buf, torch.full((4,), 3.0))
    assert state.opt_states[0].count == 3 and torch.equal(state.opt_states[0].nu, torch.full((2,), 3.0))
    with pytest.raises(ValueError, match="parameters"):
        ck.restore(TrainState(None, torch.zeros(5), (FlatOptState(torch.zeros(5), torch.zeros(5),
                                                                  counter(0, "cpu")),),
                              counter(0, "cpu")))
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "none")).restore(_port_state(0))


@pytest.mark.parametrize("name", ["", "7", "Ball_Computer-EPOCH-51-x.ckpt", "junk"])
def test_parse_demo_ckpt_matches_jax(name):
    assert t_engine._parse_demo_ckpt(name) == j_engine._parse_demo_ckpt(name)


def test_stage_of_epoch_matches_jax():
    t_st, j_st = t_config.StageConfig(2, 3, 1), j_config.StageConfig(2, 3, 1)
    assert t_st.boundaries == j_st.boundaries
    assert [t_st.stage_of_epoch(e) for e in range(6)] == [j_st.stage_of_epoch(e) for e in range(6)]
    with pytest.raises(ValueError):
        t_st.stage_of_epoch(6)


def test_train_state_from_numpy_round_trip():
    """JAX Params + RAdam states -> the port -> the same flat vectors:
    the parameters and each stage's moments land leaf by leaf, in the
    port's order (Linear weights transposed)."""
    nc = dict(emb_freqs_xyz=2, coarse_depth=2, coarse_width=8, coarse_skips=(1,),
              fine_depth=3, fine_width=16, fine_skips=(1,))
    jcfg = j_config.Config(nerf=j_config.NerfConfig(**nc))
    tcfg = t_config.Config(nerf=t_config.NerfConfig(**nc))
    rng = np.random.default_rng(4)
    cam = j_cam.CameraParams(*(jnp.asarray(rng.normal(size=s).astype(np.float32))
                               for s in ((3, 6), (3, 6), (3,), (3,), (3,), (3,))))
    jp = j_optim.Params(cam, j_init_nerf(jax.random.PRNGKey(1), jcfg.nerf))
    flat, unravel = jax.flatten_util.ravel_pytree(jp)
    _, jstates = j_optim.build_optimizers(jcfg, jp, 5)
    jstates = tuple(j_optim.FlatOptState(jnp.asarray(rng.normal(size=flat.shape), jnp.float32),
                                         jnp.asarray(rng.uniform(size=flat.shape), jnp.float32),
                                         jnp.asarray(i + 2, jnp.int32))
                    for i, _ in enumerate(jstates))
    st = train_state_from_numpy(jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, jstates),
                                17, tcfg, CPU)
    assert st.step == 17 and [o.count for o in st.opt_states] == [2, 3, 4]
    # every vector, read back through the port's params, is the JAX tree
    for vec, jvec in [(st.p_flat, flat)] + [(o.mu, s.mu) for o, s in zip(st.opt_states, jstates)] \
            + [(o.nu, s.nu) for o, s in zip(st.opt_states, jstates)]:
        ref = train_state_from_numpy(jax.tree.map(np.asarray, unravel(jvec)), (), 0, tcfg, CPU)
        assert torch.equal(vec, ref.p_flat)
    assert torch.equal(st.p_flat, t_optim.flatten_params(st.params))
    np.testing.assert_array_equal(st.params.nerf.fine.trunk[1].weight.detach().numpy(),
                                  np.asarray(jp.nerf.fine.trunk_w[1]).T)
    np.testing.assert_array_equal(
        st.opt_states[1].mu[:st.params.cam.pose_se3.numel()].numpy(),
        np.asarray(jstates[1].mu[:cam.pose_se3.size]))


def test_refresh_jitter_differs_by_epoch():
    """The repaired refresh: each epoch's lattice jitter comes from
    (seed ^ 0x0CC, epoch), so two epochs jitter differently and one epoch
    the same way twice."""
    cfg = t_config.Config(nerf=t_config.NerfConfig(occ_grid_size=6))
    a, b = t_engine.refresh_jitter(cfg, 1, CPU), t_engine.refresh_jitter(cfg, 2, CPU)
    assert a.shape == (216, 3) and float(a.min()) >= 0 and float(a.max()) < 1
    assert not torch.equal(a, b)
    assert torch.equal(a, t_engine.refresh_jitter(cfg, 1, CPU))
