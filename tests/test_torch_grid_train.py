"""The grid fine mode's training slice of the port against the JAX
package, on the CPU.

``render_rays_train(fine_mode="grid")`` by both routes (the plain route
against JAX's XLA route in fp32; the kernel route, the plain versions of
``fused_shaded_mlp``'s kernels on CPU tensors, against its Pallas route in
interpret mode), ``remat_shade``, the refusal of an occupancy map, the
grid draws, ``tools/scene.train_workload`` in grid mode, ``make_loss_fn``
on both routes and one ``make_stage_step``.  Every random draw comes from
the JAX package's key tree, the weights through
``nerf_params_from_numpy``.  Sizes as ``tests/test_torch_grid.py``: 2x32
MLPs with a skip at 1, 4 octaves, 16 coarse samples, 5 bins x 3 fine
samples per ray, 24-40 rays.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_nerf_tpu import config as j_config
from mc_nerf_tpu.data import calibration as j_calib
from mc_nerf_tpu.data.cube import tag_world_points as j_tag_points
from mc_nerf_tpu.models import camera_params as j_cam
from mc_nerf_tpu.models.nerf import init_nerf_params as j_init_params
from mc_nerf_tpu.models.nerf import render_rays_train as j_render_train
from mc_nerf_tpu.train import optim as j_optim
from mc_nerf_tpu.train import steps as j_steps

from mc_nerf_torch import config as t_config
from mc_nerf_torch.data import calibration as t_calib
from mc_nerf_torch.models import camera_params as t_cam
from mc_nerf_torch.models.nerf import (
    RenderDraws,
    draw_render,
    nerf_params_from_numpy,
    render_rays_eval,
    render_rays_train,
)
from mc_nerf_torch.ops.cuda import fused_mlp as t_fm
from mc_nerf_torch.train import optim as t_optim
from mc_nerf_torch.train import steps as t_steps

CPU = "cpu"
CFG_KW = dict(samples_coarse=16, sample_scale=3, fine_bins_topk=5, emb_freqs_xyz=4,
              coarse_depth=2, coarse_width=32, coarse_skips=(1,),
              fine_depth=2, fine_width=32, fine_skips=(1,), sh_deg=2,
              occ_grid_size=16, occ_probes=16, occ_coarse_samples=16)
KF = CFG_KW["fine_bins_topk"] * CFG_KW["sample_scale"]


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x)).to(dtype)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _render_setup(n_rays):
    jc, tc = j_config.NerfConfig(**CFG_KW), t_config.NerfConfig(**CFG_KW)
    jp = j_init_params(jax.random.PRNGKey(0), jc)
    tp = nerf_params_from_numpy(jax.tree.map(np.asarray, jp), tc, device=CPU)
    rng = np.random.default_rng(1)
    rd = rng.normal(size=(n_rays, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ro = np.tile(np.array([[0.0, 0.0, -4.0]], np.float32), (n_rays, 1))
    return jc, tc, jp, tp, rd, ro


def _train_draws(key, tc, n_rays):
    """The grid-mode draws of JAX's render_rays_train from its key splits
    (models/nerf.py:188, :259-261; composite's and sigma_to_weights' noise
    draws at the sigma shapes)."""
    kj, kn_c, kn_sel, _kn_pdf, kn_f = jax.random.split(key, 5)
    sc = tc.samples_coarse
    return RenderDraws(
        _t(jax.random.uniform(kj, (n_rays, 1), jnp.float32, 0.0, (tc.far - tc.near) / sc)),
        _t(jax.random.normal(kn_c, (n_rays, sc))), _t(jax.random.normal(kn_sel, (n_rays, sc))),
        None, _t(jax.random.normal(kn_f, (n_rays, tc.samples_fine))))


def _module_pairs(tp, jtree):
    """(port tensor, JAX array, is a Linear weight) for every MLP leaf."""
    pairs = []
    for tm, jm in ((tp.coarse, jtree.coarse), (tp.fine, jtree.fine)):
        pairs += [(l.weight, w, True) for l, w in zip(tm.trunk, jm.trunk_w)]
        pairs += [(l.bias, b, False) for l, b in zip(tm.trunk, jm.trunk_b)]
        for mod, head, i in (("sigma0", "sigma", 0), ("sigma1", "sigma", 1),
                             ("sh0", "sh", 0), ("sh1", "sh", 1)):
            pairs += [(getattr(tm, mod).weight, getattr(jm, f"{head}_w{i}"), True),
                      (getattr(tm, mod).bias, getattr(jm, f"{head}_b{i}"), False)]
    return pairs


def _t_train_loss(tp, tc, rd, ro, draws, use_kernels, remat=False):
    rgb_c, rgb_f = render_rays_train(
        tp, rd, ro, draws, torch.tensor(0.5), tc, (0.1, 0.5), barf_on=True,
        compute_dtype=torch.float32, fine_mode="grid", use_kernels=use_kernels,
        remat_shade=remat)
    return (rgb_c ** 2).mean() + 2 * (rgb_f ** 2).mean(), rgb_c, rgb_f


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_render_rays_train_grid_matches_jax(route):
    """With the JAX key tree's draws handed in: rgb within 0.04 of JAX's
    (tests/test_fused_render.py:250) and every MLP gradient within
    0.1 * max|ref| per leaf (tests/test_render_eval.py:159); the plain
    route against JAX's XLA route in fp32, the kernel route against its
    Pallas route in interpret mode."""
    jc, tc, jp, tp, rd, ro = _render_setup(32)
    key = jax.random.PRNGKey(2)
    kernel = route == "kernel"

    def j_loss(p):
        rgb_c, rgb_f = j_render_train(
            p, jnp.asarray(rd), jnp.asarray(ro), key, jnp.asarray(0.5), jc, (0.1, 0.5),
            barf_on=True, compute_dtype=jnp.float32, fine_mode="grid", use_pallas=kernel,
            interpret=kernel)
        return jnp.mean(rgb_c ** 2) + 2 * jnp.mean(rgb_f ** 2), (rgb_c, rgb_f)

    (j_val, (jc_rgb, jf_rgb)), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(jp)
    before = t_fm.fused_shaded_mlp.launches
    loss, rgb_c, rgb_f = _t_train_loss(tp, tc, torch.as_tensor(rd), torch.as_tensor(ro),
                                       _train_draws(key, tc, 32), kernel)
    loss.backward()
    assert t_fm.fused_shaded_mlp.launches == before      # CPU tensors: plain versions
    assert float(np.abs(_np(rgb_c) - np.asarray(jc_rgb)).max()) < 0.04
    assert float(np.abs(_np(rgb_f) - np.asarray(jf_rgb)).max()) < 0.04
    assert abs(float(loss.detach()) - float(j_val)) < 0.04
    for k, (p, jg, is_w) in enumerate(_module_pairs(tp, j_grads)):
        ref = np.asarray(jg, np.float32)
        got = _np(p.grad).T if is_w else _np(p.grad)
        scale = max(float(np.abs(ref).max()), 1e-4)
        assert float(np.abs(got - ref).max()) < 0.1 * scale + 1e-6, f"leaf {k}"


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_remat_shade_same_loss_and_grads(route):
    """remat_shade (torch.utils.checkpoint around both shading passes)
    gives the same loss and the same gradients, bit for bit."""
    _, tc, _, tp, rd, ro = _render_setup(24)
    draws = _train_draws(jax.random.PRNGKey(5), tc, 24)
    rd_t, ro_t = torch.as_tensor(rd), torch.as_tensor(ro)
    results = []
    for remat in (False, True):
        tp.zero_grad(set_to_none=True)
        loss, _, _ = _t_train_loss(tp, tc, rd_t, ro_t, draws, route == "kernel", remat)
        loss.backward()
        results.append((float(loss.detach()), [p.grad.clone() for p in tp.parameters()]))
    assert results[0][0] == results[1][0]
    for a, b in zip(results[0][1], results[1][1]):
        assert torch.equal(a, b)


def test_occupancy_map_refused_in_grid_mode():
    """As the JAX package (models/nerf.py:246-248, :496-498): an occupancy
    map outside the importance mode raises, in eval and in training."""
    _, tc, _, tp, rd, ro = _render_setup(4)
    occ = torch.ones((16 * 16, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        render_rays_eval(tp, torch.as_tensor(rd), torch.as_tensor(ro), tc, fine_mode="grid",
                         occ=occ)
    with pytest.raises(ValueError):
        render_rays_train(tp, torch.as_tensor(rd), torch.as_tensor(ro),
                          _train_draws(jax.random.PRNGKey(0), tc, 4), torch.tensor(0.5), tc,
                          (0.1, 0.5), True, fine_mode="grid", occ=occ)


def test_draw_render_grid_shapes():
    """Grid mode draws the [R, 1] jitter, coarse noises and the fine noise
    over fine_bins_topk * sample_scale samples; no inverse-CDF uniforms."""
    tc = t_config.NerfConfig(**CFG_KW)
    d = draw_render(7, tc, 32, False, torch.Generator().manual_seed(0), "grid")
    assert tuple(d.z_u.shape) == (7, 1) and d.pdf_u is None
    assert tuple(d.noise_c.shape) == tuple(d.noise_sel.shape) == (7, 16)
    assert tuple(d.noise_f.shape) == (7, KF) == (7, tc.samples_fine)
    assert tc.samples_fine_grid == 48 and float(d.z_u.max()) < 7.0 / 16


def test_train_workload_has_no_occupancy_in_grid_mode():
    """tools/scene.train_workload gives occ=None in the grid fine mode (as
    Engine._occ_train), the all-occupied prior in the importance mode."""
    from mc_nerf_torch.tools.scene import train_workload

    tc = t_config.NerfConfig(**CFG_KW)
    grid = t_config.Config(nerf=tc, train=t_config.TrainConfig(fine_mode="grid"))
    _, data = train_workload(grid, 0, CPU, n_images=2, img_h=24, img_w=24)
    assert data.occ is None
    _, data = train_workload(t_config.Config(nerf=tc), 0, CPU, n_images=2, img_h=24, img_w=24)
    assert data.occ is not None


# ----------------------------------------------------------- the train step

H = W = 12
N_IMG = 3
RAYS = 40
TOTAL_STEPS, STEP = 100, 50


def _step_configs(use_pallas):
    train = dict(rays_per_batch=RAYS, fine_mode="grid", use_pallas=use_pallas)
    jc = j_config.Config(nerf=j_config.NerfConfig(**CFG_KW),
                         train=dataclasses.replace(j_config.TrainConfig(), **train),
                         compute_dtype="float32")
    tc = t_config.Config(nerf=t_config.NerfConfig(**CFG_KW),
                         train=dataclasses.replace(t_config.TrainConfig(), **train),
                         compute_dtype="float32")
    return jc, tc


def _step_scene():
    """JAX and port params with the same values, cameras near (0, 0, 4),
    seeded images and detections; no occupancy map (grid mode)."""
    jc, tc = _step_configs(False)
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
    jp = j_optim.Params(cam=cam, nerf=j_init_params(jax.random.PRNGKey(3), jc.nerf))
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
    return (jp, tp, j_steps.TrainData(jnp.asarray(images), jcal, None),
            t_steps.TrainData(torch.as_tensor(images), tcal, None))


def _step_draws(key, tc):
    """make_loss_fn's draws from its key splits (train/steps.py:162, :68,
    :105-118), the render's in grid mode."""
    k_calib, k_rays, k_render = jax.random.split(key, 3)
    k_int, k_ext = jax.random.split(k_calib)
    k_img, k_pix = jax.random.split(k_rays)
    img_ids = jax.random.randint(k_img, (1,), 0, N_IMG)
    pix = jax.vmap(lambda k: jax.random.permutation(k, H * W)[:RAYS])(jax.random.split(k_pix, 1))
    return t_steps.StepDraws(_t(jax.random.uniform(k_int, (N_IMG,))),
                             _t(jax.random.uniform(k_ext, (N_IMG,))), _t(img_ids, torch.int64),
                             _t(pix, torch.int64), _train_draws(k_render, tc.nerf, RAYS))


def test_grid_stage_step_matches_jax():
    """One stage-1 step in grid mode (plain route, float32) from the same
    params and draws: the loss within relative 2e-3 and every leaf's update
    within 5e-3 of the reference update's largest entry (the importance
    step's tolerances, tests/test_torch_train.py)."""
    jc, tc = _step_configs(False)
    jp, tp, jdata, tdata = _step_scene()
    key = jax.random.PRNGKey(12)
    jtxs, jstates = j_optim.build_optimizers(jc, jp, steps_per_epoch=10)
    jold = jax.tree.map(np.array, jp)      # the JAX step donates its state
    jstate, j_metrics = j_steps.make_stage_step(jc, 1, jtxs[1], H, W, TOTAL_STEPS)(
        j_steps.TrainState(jp, jstates, jnp.asarray(STEP, jnp.int32)), jdata, key)
    jnew, j_loss = jstate.params, j_metrics["loss"]
    p_flat = t_optim.flatten_params(tp)
    before = [p.detach().clone() for p in tp.parameters()]
    ttxs, tstates = t_optim.build_optimizers(tc, tp, p_flat, steps_per_epoch=10)
    state = t_steps.TrainState(tp, p_flat, tstates, STEP)
    metrics = t_steps.make_stage_step(tc, 1, ttxs[1], H, W, TOTAL_STEPS)(
        state, tdata, _step_draws(key, tc))
    assert abs(float(metrics["loss"]) - float(j_loss)) <= 2e-3 * abs(float(j_loss))
    j_pairs = [(getattr(jnew.cam, f), getattr(jold.cam, f), False) for f in t_cam.FIELDS]
    j_pairs += [(n, o, w) for (_, n, w), (_, o, _) in zip(_module_pairs(tp.nerf, jnew.nerf),
                                                          _module_pairs(tp.nerf, jold.nerf))]
    t_leaves = [getattr(tp.cam, f) for f in t_cam.FIELDS] + [p for p, _, _ in
                                                              _module_pairs(tp.nerf, jnew.nerf)]
    old = {id(p): b for p, b in zip(tp.parameters(), before)}
    for p, (jn, jo, is_w) in zip(t_leaves, j_pairs):
        ref = np.asarray(jn) - np.asarray(jo)
        got = _np(p - old[id(p)])
        got = got.T if is_w else got
        np.testing.assert_allclose(got, ref, rtol=0, atol=5e-3 * max(1e-12, np.abs(ref).max()))


@pytest.mark.parametrize("use_pallas", [False, None])
def test_grid_loss_fn_routes_close_to_jax(use_pallas):
    """make_loss_fn in grid mode on both routes (None: the kernels' plain
    versions) against JAX's make_loss_fn on its XLA route in fp32: the loss
    within 0.04 relative, the fine MLP's gradients within 0.1 * max|ref|
    per leaf."""
    jc, _ = _step_configs(False)
    _, tc = _step_configs(use_pallas)
    jp, tp, jdata, tdata = _step_scene()
    key = jax.random.PRNGKey(13)
    jfn = lambda p: j_steps.make_loss_fn(jc, 1, H, W, TOTAL_STEPS)(
        p, jdata, key, jnp.asarray(STEP, jnp.int32))[0]
    j_val, j_grads = jax.jit(jax.value_and_grad(jfn))(jp)
    total, _ = t_steps.make_loss_fn(tc, 1, H, W, TOTAL_STEPS)(tp, tdata, _step_draws(key, tc),
                                                              STEP)
    total.backward()
    assert abs(float(total.detach()) - float(j_val)) <= 0.04 * abs(float(j_val))
    for k, (p, jg, is_w) in enumerate(_module_pairs(tp.nerf, j_grads.nerf)):
        ref = np.asarray(jg, np.float32)
        got = _np(p.grad).T if is_w else _np(p.grad)
        scale = max(float(np.abs(ref).max()), 1e-4)
        assert float(np.abs(got - ref).max()) < 0.1 * scale + 1e-6, f"leaf {k}"
