"""The port's training slice against the JAX package, on the CPU.

Cameras, projection, calibration sampling, losses and the flat RAdam
against their JAX counterparts; then the slice: loss and every parameter
gradient of ``make_loss_fn`` for stages 0, 1 and 2, by the plain route
(against the JAX package's ``make_loss_fn`` with ``use_pallas=False``, both
in float32) and by the kernel route (the kernels' plain versions, against
the JAX ``render_rays_train(use_pallas=True, interpret=True)`` composed
with the same losses), and one ``make_stage_step`` update against JAX's.
Every random draw is built from the JAX package's key tree and handed to
both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from mc_nerf_tpu import config as j_config
from mc_nerf_tpu.cameras import lie as j_lie
from mc_nerf_tpu.cameras import projection as j_proj
from mc_nerf_tpu.data import calibration as j_calib
from mc_nerf_tpu.data.cube import tag_world_points as j_tag_points
from mc_nerf_tpu.models import camera_params as j_cam
from mc_nerf_tpu.models.nerf import init_nerf_params as j_init_nerf
from mc_nerf_tpu.models.nerf import render_rays_train as j_render_train
from mc_nerf_tpu.ops import occupancy as j_occ
from mc_nerf_tpu.train import loss as j_loss
from mc_nerf_tpu.train import optim as j_optim
from mc_nerf_tpu.train import steps as j_steps

from mc_nerf_torch import config as t_config
from mc_nerf_torch.cameras import lie as t_lie
from mc_nerf_torch.cameras import projection as t_proj
from mc_nerf_torch.data import calibration as t_calib
from mc_nerf_torch.data.cube import tag_world_points as t_tag_points
from mc_nerf_torch.models import camera_params as t_cam
from mc_nerf_torch.models.nerf import RenderDraws, nerf_params_from_numpy
from mc_nerf_torch.train import loss as t_loss
from mc_nerf_torch.train import optim as t_optim
from mc_nerf_torch.train import steps as t_steps

CPU = "cpu"


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x)).to(dtype)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------ cameras

def test_skew_so3_se3_match_jax(rng):
    """atol 1e-6 on the maps (fp32, closed form; both sides multiply-sum
    at full precision), angles from 0 to ~3 rad, the Taylor branch included."""
    w = rng.normal(size=(64, 6)).astype(np.float32)
    w[:8, :3] *= 1e-6                 # the small-angle branch
    w[8:16, :3] = 0.0                 # exactly zero
    w[16:24, :3] *= 1.7
    np.testing.assert_array_equal(_np(t_lie.skew(_t(w[:, :3]))), np.asarray(j_lie.skew(w[:, :3])))
    np.testing.assert_allclose(_np(t_lie.so3_to_SO3(_t(w[:, :3]))),
                               np.asarray(j_lie.so3_to_SO3(jnp.asarray(w[:, :3]))), atol=1e-6)
    np.testing.assert_allclose(_np(t_lie.se3_to_SE3(_t(w))),
                               np.asarray(j_lie.se3_to_SE3(jnp.asarray(w))), atol=1e-6)


def test_se3_gradients_finite_at_zero_and_match_jax(rng):
    """The double-where guard: d(se3_to_SE3) at theta = 0 is finite, and
    equal to JAX's within 1e-5 elsewhere."""
    w = rng.normal(size=(16, 6)).astype(np.float32)
    w[:4, :3] = 0.0
    cot = rng.normal(size=(16, 3, 4)).astype(np.float32)
    jg = jax.grad(lambda x: jnp.sum(j_lie.se3_to_SE3(x) * cot))(jnp.asarray(w))
    x = _t(w).requires_grad_()
    (t_lie.se3_to_SE3(x) * _t(cot)).sum().backward()
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(_np(x.grad), np.asarray(jg), atol=1e-5)


def test_SE3_to_se3_round_trip_matches_jax(rng):
    """The log map agrees with JAX's to 1e-5 and inverts se3_to_SE3."""
    w = (rng.normal(size=(32, 6)) * np.array([1.0, 1.0, 1.0, 2.0, 2.0, 2.0])).astype(np.float32)
    Rt = np.asarray(j_lie.se3_to_SE3(jnp.asarray(w)))
    out = _np(t_lie.SE3_to_se3(_t(Rt)))
    np.testing.assert_allclose(out, np.asarray(j_lie.SE3_to_se3(jnp.asarray(Rt))), atol=1e-5)
    np.testing.assert_allclose(out, w, atol=1e-4)


def test_projection_matches_jax(rng):
    """world2cam / cam2pix / reproject_points / to_hom: rtol 1e-6 (fp32
    multiply-sums on both sides), a point at z ~ 0 included (the guard)."""
    pts = rng.normal(size=(5, 7, 3)).astype(np.float32) * 2
    pose = np.asarray(j_lie.se3_to_SE3(jnp.asarray(rng.normal(size=(5, 6)).astype(np.float32))))
    K = np.tile(np.array([[30.0, 0, 16], [0, 28.0, 12], [0, 0, 1]], np.float32), (5, 1, 1))
    cam = pts.copy()
    cam[0, 0, 2] = 1e-8
    np.testing.assert_array_equal(_np(t_proj.to_hom(_t(pts))), np.asarray(j_proj.to_hom(pts)))
    np.testing.assert_allclose(_np(t_proj.world2cam(_t(pts), _t(pose))),
                               np.asarray(j_proj.world2cam(pts, pose)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(t_proj.cam2pix(_t(cam), _t(K))),
                               np.asarray(j_proj.cam2pix(cam, K)), rtol=1e-6)
    np.testing.assert_allclose(_np(t_proj.reproject_points(_t(pts), _t(K), _t(pose))),
                               np.asarray(j_proj.reproject_points(pts, K, pose)),
                               rtol=1e-5, atol=1e-4)


def test_camera_params_match_jax(rng):
    """intrinsics / camera_poses / calib_cube_poses of the same leaves
    (atol 1e-6), the all-ones init, and the ground-truth init."""
    jc = j_cam.CameraParams(*(jnp.asarray(rng.normal(size=s).astype(np.float32))
                              for s in ((4, 6), (4, 6), (4,), (4,), (4,), (4,))))
    tc = t_cam.camera_params_from_numpy(jax.tree.map(np.asarray, jc), device=CPU)
    np.testing.assert_allclose(_np(t_cam.intrinsics(tc, 12, 16)),
                               np.asarray(j_cam.intrinsics(jc, 12, 16)), atol=1e-6)
    np.testing.assert_allclose(_np(t_cam.camera_poses(tc)),
                               np.asarray(j_cam.camera_poses(jc)), atol=1e-6)
    np.testing.assert_allclose(_np(t_cam.calib_cube_poses(tc)),
                               np.asarray(j_cam.calib_cube_poses(jc)), atol=1e-6)
    ones = t_cam.init_camera_params(3, device=CPU)
    assert all(bool((p == 1).all()) for p in ones.parameters())
    assert [n for n, _ in ones.named_parameters()] == list(t_cam.FIELDS)
    poses, K = np.asarray(j_cam.camera_poses(jc)), np.asarray(j_cam.intrinsics(jc, 12, 16))
    jg = j_cam.init_camera_params_from_gt(jnp.asarray(poses), jnp.asarray(K), 12, 16)
    tg = t_cam.init_camera_params_from_gt(_t(poses), _t(K), 12, 16)
    for f in t_cam.FIELDS:
        np.testing.assert_allclose(_np(getattr(tg, f)), np.asarray(getattr(jg, f)), atol=2e-5)


# ------------------------------------------------------ calibration, losses

def test_tag_points_and_sample_tags_match_jax(rng):
    """The cube's tag keypoints bit for bit; sample_tags with the uniforms
    of the JAX key picks the same tags (exact)."""
    np.testing.assert_array_equal(t_tag_points(0.7), j_tag_points(0.7))
    n = 9
    valid = rng.random((n, 6)) < 0.5
    valid[np.arange(n), rng.integers(0, 6, n)] = True
    pts = rng.uniform(0, 100, size=(n, 6, 5, 2)).astype(np.float32)
    ids, counts = j_calib._pad_valid_ids(valid)
    t_ids, t_counts = t_calib.pad_valid_ids(valid)
    np.testing.assert_array_equal(t_ids, ids)
    np.testing.assert_array_equal(t_counts, counts)
    key = jax.random.PRNGKey(4)
    jw, jp = j_calib.sample_tags(key, jnp.asarray(pts), jnp.asarray(ids), jnp.asarray(counts),
                                 jnp.asarray(j_tag_points(1.0)))
    u = np.asarray(jax.random.uniform(key, (n,)))
    data = t_calib.calibration_from_numpy(pts, valid, pts, valid, device=CPU)
    tw, tp = t_calib.sample_tags(_t(u), data.calib_pts, data.calib_tag_ids, data.calib_counts,
                                 data.cube_pts)
    np.testing.assert_array_equal(_np(tw), np.asarray(jw))
    np.testing.assert_array_equal(_np(tp), np.asarray(jp))


def test_load_calibration_reads_the_cache(tmp_path, rng):
    valid = np.ones((2, 6), bool)
    pts = rng.uniform(0, 10, size=(2, 6, 5, 2)).astype(np.float32)
    np.savez(tmp_path / t_calib.CACHE_NAME, tag_size=np.float32(0.5), calib_pts=pts,
             calib_valid=valid, coord_pts=pts, coord_valid=valid)
    data = t_calib.load_calibration(str(tmp_path), device=CPU)
    np.testing.assert_array_equal(_np(data.cube_pts), j_tag_points(0.5))
    assert tuple(data.calib_tag_ids.shape) == (2, 6)


def test_losses_match_jax(rng):
    """reprojection / rgb / self-normalized losses and the self-normalized
    gradient (eps 1e-6, detached denominator): rtol 1e-6."""
    a, b = rng.normal(size=(2, 9, 5, 2)).astype(np.float32) * 40
    np.testing.assert_allclose(float(t_loss.reprojection_loss(_t(a), _t(b), 12, 16)),
                               float(j_loss.reprojection_loss(a, b, 12, 16)), rtol=1e-6)
    np.testing.assert_allclose(float(t_loss.rgb_loss(_t(a), _t(b))),
                               float(j_loss.rgb_loss(a, b)), rtol=1e-6)
    x = np.float32(3e-6)
    jg = jax.grad(lambda v: j_loss.self_normalized(v * v))(jnp.float32(x))
    tx = torch.tensor(x, requires_grad=True)
    y = t_loss.self_normalized(tx * tx)
    y.backward()
    np.testing.assert_allclose(float(y.detach()), float(j_loss.self_normalized(x * x)), rtol=1e-6)
    np.testing.assert_allclose(float(tx.grad), float(jg), rtol=1e-6)


# ---------------------------------------------------------------- optimizer

def test_flat_radam_matches_jax(rng):
    """Eight masked, clipped updates with the stage-1 decay schedule
    (through the SGD fallback and into the rectified branch): params and
    moments agree with JAX's FlatRAdam to 1e-6."""
    n = 257
    p0 = rng.normal(size=n).astype(np.float32)
    mask = (rng.random(n) < 0.7).astype(np.float32)
    gamma = np.float32(0.995)
    jtx = j_optim.FlatRAdam(jnp.asarray(mask), lambda c: 0.1 * 0.995 ** c, 4e-4, clip=10.0)
    ttx = t_optim.FlatRAdam(_t(mask), lambda c: np.float32(0.1) * gamma ** np.float32(c), 4e-4,
                            clip=10.0)
    jp, js = jnp.asarray(p0), jtx.init(jnp.asarray(p0))
    tp = _t(p0)
    ts = ttx.init(tp)
    for i in range(8):
        g = (rng.normal(size=n) * (30 if i == 0 else 1)).astype(np.float32)
        jp, js = jtx.update(jnp.asarray(g), js, jp)
        ts = ttx.update(_t(g), ts, tp)
        np.testing.assert_allclose(_np(tp), np.asarray(jp), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(ts.mu), np.asarray(js.mu), atol=1e-6)
    np.testing.assert_allclose(_np(ts.nu), np.asarray(js.nu), atol=1e-6)
    assert ts.count == int(js.count) == 8


# -------------------------------------------------------------- the slice

H = W = 12
N_IMG = 3
RAYS = 40
CFG_KW = dict(samples_coarse=16, emb_freqs_xyz=4, coarse_depth=2, coarse_width=32,
              coarse_skips=(1,), fine_depth=2, fine_width=32, fine_skips=(1,),
              occ_grid_size=16, occ_probes=16, occ_coarse_samples=16)
IMP = 16
TOTAL_STEPS, STEP = 100, 50        # BARF gate [1, 0.5, 0, 0] at stage 1


def _configs(use_pallas):
    jc = j_config.Config(
        nerf=j_config.NerfConfig(**CFG_KW),
        train=dataclasses.replace(j_config.TrainConfig(), rays_per_batch=RAYS,
                                  importance_samples=IMP, use_pallas=use_pallas),
        compute_dtype="float32")
    tc = t_config.Config(
        nerf=t_config.NerfConfig(**CFG_KW),
        train=dataclasses.replace(t_config.TrainConfig(), rays_per_batch=RAYS,
                                  importance_samples=IMP, use_pallas=use_pallas),
        compute_dtype="float32")
    return jc, tc


def _scene(culled):
    """JAX and port params with the same values (cameras perturbed from
    ones so that rays differ per image), data, occupancy map."""
    jc, tc = _configs(False)
    rng = np.random.default_rng(7)
    cam = j_cam.CameraParams(
        pose_se3=jnp.asarray(np.concatenate([rng.normal(size=(N_IMG, 3)) * 0.3,
                                             rng.normal(size=(N_IMG, 3)) * 0.3 + [0, 0, 4]],
                                            1).astype(np.float32)),
        calib_pose_se3=jnp.asarray((rng.normal(size=(N_IMG, 6)) * 0.3 + [0, 0, 0, 0, 0, 4])
                                   .astype(np.float32)),
        fx=jnp.asarray(rng.uniform(0.8, 1.2, N_IMG).astype(np.float32)),
        fy=jnp.asarray(rng.uniform(0.8, 1.2, N_IMG).astype(np.float32)),
        ux=jnp.asarray(rng.uniform(0.9, 1.1, N_IMG).astype(np.float32)),
        uy=jnp.asarray(rng.uniform(0.9, 1.1, N_IMG).astype(np.float32)))
    jp = j_optim.Params(cam=cam, nerf=j_init_nerf(jax.random.PRNGKey(3), jc.nerf))
    tp = t_optim.Params(t_cam.camera_params_from_numpy(jax.tree.map(np.asarray, cam), CPU),
                        nerf_params_from_numpy(jax.tree.map(np.asarray, jp.nerf), tc.nerf, CPU))
    images = rng.integers(0, 256, size=(N_IMG, H * W, 3), dtype=np.uint8)
    pts = rng.uniform(0, W, size=(N_IMG, 6, 5, 2)).astype(np.float32)
    valid = rng.random((N_IMG, 6)) < 0.6
    valid[:, 0] = True
    ids, counts = j_calib._pad_valid_ids(valid)
    jcal = j_calib.CalibrationData(jnp.asarray(pts), jnp.asarray(pts * 0.9), jnp.asarray(ids),
                                   jnp.asarray(ids), jnp.asarray(counts), jnp.asarray(counts),
                                   jnp.asarray(j_tag_points(1.0)))
    tcal = t_calib.calibration_from_numpy(pts, valid, pts * 0.9, valid, device=CPU)
    occ_j = occ_t = None
    if culled:
        dens = np.where(rng.random((16, 16, 16)) < 0.3, 5.0, 0.0).astype(np.float32)
        occ = np.asarray(j_occ.binary_grid(j_occ.OccupancyGrid(jnp.asarray(dens)), jc.nerf),
                         np.float32)
        occ_j, occ_t = jnp.asarray(occ, jnp.bfloat16), torch.as_tensor(occ).bfloat16()
    jdata = j_steps.TrainData(jnp.asarray(images), jcal, occ_j)
    tdata = t_steps.TrainData(torch.as_tensor(images), tcal, occ_t)
    return jp, tp, jdata, tdata


def _draws_from_key(key, cfg, stage, culled):
    """The draws ``make_loss_fn`` consumes, from its own key splits
    (train/steps.py:162, :68, :105-118; models/nerf.py:188)."""
    k_calib, k_rays, k_render = jax.random.split(key, 3)
    k_int, k_ext = jax.random.split(k_calib)
    u_int = jax.random.uniform(k_int, (N_IMG,))
    u_ext = jax.random.uniform(k_ext, (N_IMG,))
    if stage == 0:
        return t_steps.StepDraws(_t(u_int), _t(u_ext), None, None, None)
    k_img, k_pix = jax.random.split(k_rays)
    img_ids = jax.random.randint(k_img, (1,), 0, N_IMG)
    pix_keys = jax.random.split(k_pix, 1)
    pix = jax.vmap(lambda k: jax.random.permutation(k, H * W)[:RAYS])(pix_keys)   # hw <= 8R
    kj, kn_c, kn_sel, kn_pdf, kn_f = jax.random.split(k_render, 5)
    nc = cfg.nerf
    sc = nc.occ_coarse_samples if culled else nc.samples_coarse
    z_u = (jax.random.uniform(kj, (RAYS, sc)) if culled else
           jax.random.uniform(kj, (RAYS, 1), jnp.float32, 0.0, (nc.far - nc.near) / sc))
    render = RenderDraws(_t(z_u), _t(jax.random.normal(kn_c, (RAYS, sc))),
                         _t(jax.random.normal(kn_sel, (RAYS, sc))),
                         _t(jax.random.uniform(kn_pdf, (RAYS, IMP))),
                         _t(jax.random.normal(kn_f, (RAYS, IMP))))
    return t_steps.StepDraws(_t(u_int), _t(u_ext), _t(img_ids, torch.int64),
                             _t(pix, torch.int64), render)


def _j_kernel_loss(cfg, stage):
    """JAX's loss with the Pallas render in interpret mode: make_loss_fn's
    body with render_rays_train(use_pallas=True, interpret=True)."""
    window = cfg.barf.global_window(cfg.stages)

    def loss_fn(params, data, key, step):
        k_calib, k_rays, k_render = jax.random.split(key, 3)
        loss_int, _ = j_steps._calib_losses(params, data, k_calib, H, W)
        rays_d, rays_o, gt = j_steps._sample_ray_batch(params, data, k_rays, cfg, H, W, 1, None)
        rgb_c, rgb_f = j_render_train(
            params.nerf, rays_d, rays_o, k_render, step.astype(jnp.float32) / TOTAL_STEPS,
            cfg.nerf, window, barf_on=(stage == 1), fine_mode="importance",
            importance_samples=IMP, use_pallas=True, interpret=True, occ=data.occ)
        return (j_loss.self_normalized(loss_int) + j_loss.rgb_loss(rgb_c, gt)
                + j_loss.rgb_loss(rgb_f, gt))

    return loss_fn


def _leaf_pairs(tp, jtree):
    """(port tensor, JAX array, is a Linear weight) per leaf; the port's
    Linear weights are [out, in], JAX's [in, out]."""
    pairs = [(getattr(tp.cam, f), getattr(jtree.cam, f), False) for f in t_cam.FIELDS]
    for tm, jm in ((tp.nerf.coarse, jtree.nerf.coarse), (tp.nerf.fine, jtree.nerf.fine)):
        pairs += [(l.weight, w, True) for l, w in zip(tm.trunk, jm.trunk_w)]
        pairs += [(l.bias, b, False) for l, b in zip(tm.trunk, jm.trunk_b)]
        for mod, head, i in (("sigma0", "sigma", 0), ("sigma1", "sigma", 1),
                             ("sh0", "sh", 0), ("sh1", "sh", 1)):
            pairs += [(getattr(tm, mod).weight, getattr(jm, f"{head}_w{i}"), True),
                      (getattr(tm, mod).bias, getattr(jm, f"{head}_b{i}"), False)]
    return pairs


def _as_jax_layout(t, is_weight):
    a = _np(t)
    return a.T if is_weight else a


def _grads_close(tp, jgrads):
    """Per leaf, atol 5e-3 * max|ref| (tests/test_fused_render.py:131)."""
    for k, (p, jg, is_w) in enumerate(_leaf_pairs(tp, jgrads)):
        ref = np.asarray(jg, np.float32)
        got = np.zeros_like(ref) if p.grad is None else _as_jax_layout(p.grad, is_w)
        scale = max(1e-3, float(np.abs(ref).max()))
        np.testing.assert_allclose(got, ref, rtol=0, atol=5e-3 * scale, err_msg=f"leaf {k}")


@pytest.mark.parametrize("route,stage,culled", [
    ("plain", 0, False), ("plain", 1, True), ("plain", 1, False), ("plain", 2, True),
    ("kernel", 1, True), ("kernel", 1, False), ("kernel", 2, True)])
def test_loss_and_grads_match_jax(route, stage, culled):
    """Loss within relative 2e-3 and every parameter gradient within
    5e-3 * max|ref| per leaf, stages 0-2, culled and uniform coarse
    sampling (stage 0 renders nothing, so it has one route)."""
    use_pallas = route == "kernel"
    jc, tc = _configs(use_pallas)
    jp, tp, jdata, tdata = _scene(culled)
    key = jax.random.PRNGKey(11)
    step = jnp.asarray(STEP, jnp.int32)
    if route == "plain":
        jfn = lambda p: j_steps.make_loss_fn(jc, stage, H, W, TOTAL_STEPS)(p, jdata, key, step)[0]
    else:
        jfn = lambda p: _j_kernel_loss(jc, stage)(p, jdata, key, step)
    j_val, j_grads = jax.value_and_grad(jfn)(jp)
    draws = _draws_from_key(key, tc, stage, culled)
    total, metrics = t_steps.make_loss_fn(tc, stage, H, W, TOTAL_STEPS)(tp, tdata, draws, STEP)
    total.backward()
    assert set(metrics) == {"loss", "loss_intr", "loss_extr", "loss_rgb_c", "loss_rgb_f"}
    assert abs(float(total.detach()) - float(j_val)) <= 2e-3 * abs(float(j_val))
    _grads_close(tp, j_grads)


def test_stage_mask_matches_jax():
    """The 0/1 masks of the three stages, leaf by leaf."""
    jp, tp, _, _ = _scene(False)
    _, unravel = ravel_pytree(jp)
    for stage in range(3):
        jm = unravel(j_optim.stage_mask(jp, stage))
        tm = t_optim.stage_mask(tp, stage)
        off = 0
        for p, ref, is_w in _leaf_pairs(tp, jm):
            got = tm[off:off + p.numel()].view_as(p)
            off += p.numel()
            np.testing.assert_array_equal(_as_jax_layout(got, is_w), np.asarray(ref))


def test_stage_step_update_matches_jax():
    """One stage-1 step (plain route, float32) from the same params and
    draws: every leaf's update within 5e-3 of the reference update's
    largest entry (the gradient tolerance: the first RAdam step is a
    clipped SGD step), and the step counter advances."""
    jc, tc = _configs(False)
    jp, tp, jdata, tdata = _scene(True)
    key = jax.random.PRNGKey(12)
    jtxs, jstates = j_optim.build_optimizers(jc, jp, steps_per_epoch=10)
    jold_params = jax.tree.map(np.array, jp)   # the JAX step donates its state
    jstate = j_steps.TrainState(jp, jstates, jnp.asarray(STEP, jnp.int32))
    jstep = j_steps.make_stage_step(jc, 1, jtxs[1], H, W, TOTAL_STEPS)
    jnew, _ = jstep(jstate, jdata, key)
    p_flat = t_optim.flatten_params(tp)
    before = [p.detach().clone() for p, _, _ in _leaf_pairs(tp, jp)]
    ttxs, tstates = t_optim.build_optimizers(tc, tp, p_flat, steps_per_epoch=10)
    tstate = t_steps.TrainState(tp, p_flat, tstates, t_optim.counter(STEP, "cpu"))
    step = t_steps.make_stage_step(tc, 1, ttxs[1], H, W, TOTAL_STEPS)
    metrics = step(tstate, tdata, _draws_from_key(key, tc, 1, True))
    assert tstate.step == STEP + 1 and tstate.opt_states[1].count == 1
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    for (p, jnew_leaf, is_w), old, (_, jold, _) in zip(_leaf_pairs(tp, jnew.params), before,
                                                       _leaf_pairs(tp, jold_params)):
        ref = np.asarray(jnew_leaf) - np.asarray(jold)
        got = _as_jax_layout(p.detach() - old, is_w)
        np.testing.assert_allclose(got, ref, rtol=0, atol=5e-3 * max(1e-12, np.abs(ref).max()))


def test_stage_epoch_runs_with_its_own_generator():
    """make_stage_epoch draws from a torch.Generator; stage 0 moves only
    the cameras, the metrics are finite."""
    _, tc = _configs(None)
    _, tp, _, tdata = _scene(True)
    p_flat = t_optim.flatten_params(tp)
    txs, states = t_optim.build_optimizers(tc, tp, p_flat, steps_per_epoch=2)
    state = t_steps.TrainState(tp, p_flat, states, t_optim.counter(0, "cpu"))
    nerf_before = torch.cat([p.detach().reshape(-1).clone() for p in tp.nerf.parameters()])
    gen = torch.Generator().manual_seed(0)
    m0 = t_steps.make_stage_epoch(tc, 0, txs[0], H, W, 10, 2)(state, tdata, gen)
    assert torch.equal(torch.cat([p.detach().reshape(-1) for p in tp.nerf.parameters()]),
                       nerf_before)
    m1 = t_steps.make_stage_epoch(tc, 1, txs[1], H, W, 10, 2)(state, tdata, gen)
    assert state.step == 4
    assert all(bool(torch.isfinite(v)) for v in [*m0.values(), *m1.values()])
    assert not torch.equal(torch.cat([p.detach().reshape(-1) for p in tp.nerf.parameters()]),
                           nerf_before)
