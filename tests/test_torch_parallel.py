"""The port's data-parallel step and render against the JAX package's
2-device mesh on the CPU (the counterpart of ``tests/test_parallel.py``),
and the port's ``dryrun_multichip``.

One step: JAX's ``make_stage_step`` on a 2-device mesh with a global
batch of 2 images (``tests/test_parallel.py:55``), against the port's
``make_stage_step`` on 2 gloo ranks (subprocesses, a file store under the
test's tmp directory) with one image each.  The draws come from the JAX
key tree (as ``tests/test_torch_train.py::_draws_from_key`` builds them,
over the global batch's rays), and each rank keeps its block through the
port's own ``rank_block``.  Cases: stage 0; stage 1 in the importance
mode (occupancy-culled); stage 1 in the grid mode; and a grid step built
so that one rank's local max of the selection weights lies below
``weight_thresh`` and the global max does not (one camera looks into a
dense half-space, the other into an empty one): a rank-local cutoff
selects other bins on that rank and fails it; and stage 2 (FINE_TUNE) of
the coarse-free hybrid schedule, the fine pass alone drawn from the
occupancy PMF.  The mean of the ranks'
losses is held to JAX's global loss at rtol 1e-5 (measured: 4.1e-7 at
most over the first four cases), every parameter leaf's update to 5e-3 of the
reference update's largest entry (``test_stage_step_update_matches_jax``'s
tolerance; measured 4.9e-4 at most), and the ranks' ``p_flat`` to the
same bits.  The render: the port's ``make_render_fn`` against JAX's on a
2-device mesh in the importance mode.
"""

import dataclasses
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_nerf_tpu import config as j_config
from mc_nerf_tpu.data import calibration as j_calib
from mc_nerf_tpu.data.cube import tag_world_points as j_tag_points
from mc_nerf_tpu.models import camera_params as j_cam
from mc_nerf_tpu.models.nerf import init_nerf_params as j_init_nerf
from mc_nerf_tpu.ops import occupancy as j_occ
from mc_nerf_tpu.parallel.mesh import make_mesh
from mc_nerf_tpu.train import optim as j_optim
from mc_nerf_tpu.train import steps as j_steps

from mc_nerf_torch import config as t_config
from mc_nerf_torch.data import calibration as t_calib
from mc_nerf_torch.models.nerf import RenderDraws, nerf_params_from_numpy
from mc_nerf_torch.parallel.dryrun import dryrun_multichip, spawn_ranks
from mc_nerf_torch.train import steps as t_steps

CPU = "cpu"
H = W = 12
N_IMG, RAYS, IMP, WORLD = 3, 40, 16, 2
TOTAL_STEPS, STEP = 100, 50        # BARF gate [1, 0.5, 0, 0] at stage 1
NERF_KW = dict(samples_coarse=16, sample_scale=4, fine_bins_topk=4, emb_freqs_xyz=4,
               coarse_depth=2, coarse_width=32, coarse_skips=(1,), fine_depth=2, fine_width=32,
               fine_skips=(1,), occ_grid_size=16, occ_probes=16, occ_coarse_samples=16)
CASES = {"stage 0": ("importance", 0, False), "stage 1 importance": ("importance", 1, False),
         "stage 1 grid": ("grid", 1, False), "grid, one rank's max below the cutoff": (
             "grid", 1, True), "coarse-free stage 2": ("importance", 2, False, True)}
CF_UNIFORM = 4
LOSS_RTOL = 1e-5
UPDATE_TOL = 5e-3


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x)).to(dtype)


def _configs(mode, coarse_free=False):
    cf = (dict(coarse_free=True, coarse_free_from_stage=2, cf_uniform_samples=CF_UNIFORM)
          if coarse_free else {})

    def make(m):
        return m.Config(nerf=m.NerfConfig(**NERF_KW, **cf),
                        train=dataclasses.replace(m.TrainConfig(), rays_per_batch=RAYS,
                                                  importance_samples=IMP, use_pallas=False,
                                                  fine_mode=mode),
                        compute_dtype="float32")

    return make(j_config), make(t_config)


def _global_draws(key, cfg, stage, culled):
    """The draws JAX's loss takes from its step key with images_per_batch
    2 (train/steps.py:162, :68, :105-118; models/nerf.py:188), over the
    global batch's 2 x RAYS rays."""
    k_calib, k_rays, k_render = jax.random.split(key, 3)
    k_int, k_ext = jax.random.split(k_calib)
    u_int, u_ext = (_t(jax.random.uniform(k, (N_IMG,))) for k in (k_int, k_ext))
    if stage == 0:
        return t_steps.StepDraws(u_int, u_ext, None, None, None)
    k_img, k_pix = jax.random.split(k_rays)
    img_ids = jax.random.randint(k_img, (WORLD,), 0, N_IMG)
    pix = jax.vmap(lambda k: jax.random.permutation(k, H * W)[:RAYS])(      # hw <= 8R
        jax.random.split(k_pix, WORLD))
    kj, kn_c, kn_sel, kn_pdf, kn_f = jax.random.split(k_render, 5)
    nc, n = cfg.nerf, WORLD * RAYS
    if nc.coarse_free_at(stage):
        # no coarse pass: the PMF draw's jitter, its uniform share, the noise
        # (``tests/test_torch_coarse_free.py::_cf_draws``)
        render = RenderDraws(None, None, None,
                             _t(jax.random.uniform(kn_pdf, (n, IMP - nc.cf_uniform_samples))),
                             _t(jax.random.normal(kn_f, (n, IMP))),
                             _t(jax.random.uniform(kn_sel, (n, nc.cf_uniform_samples))))
    elif cfg.train.fine_mode == "grid":
        sc = nc.samples_coarse
        render = RenderDraws(
            _t(jax.random.uniform(kj, (n, 1), jnp.float32, 0.0, (nc.far - nc.near) / sc)),
            _t(jax.random.normal(kn_c, (n, sc))), _t(jax.random.normal(kn_sel, (n, sc))),
            None, _t(jax.random.normal(kn_f, (n, nc.samples_fine))))
    else:
        assert culled
        sc = nc.occ_coarse_samples
        render = RenderDraws(_t(jax.random.uniform(kj, (n, sc))),
                             _t(jax.random.normal(kn_c, (n, sc))),
                             _t(jax.random.normal(kn_sel, (n, sc))),
                             _t(jax.random.uniform(kn_pdf, (n, IMP))),
                             _t(jax.random.normal(kn_f, (n, IMP))))
    return t_steps.StepDraws(u_int, u_ext, _t(img_ids, torch.int64), _t(pix, torch.int64),
                             render)


def _first_img_ids(key):
    return np.asarray(jax.random.randint(jax.random.split(jax.random.split(key, 3)[1])[0],
                                         (WORLD,), 0, N_IMG))


def _dense_half_space(mlp, in_dim):
    """The coarse MLP rebuilt so that its raw density is 100 relu(x) - 60:
    a dense half-space x > 0 (weights ~1 at the first sample there) and
    an empty one (softplus(-60 + noise): weights below 1e-10 even with the
    last sample's 1e10 delta)."""
    w0 = np.zeros_like(mlp.trunk_w[0])
    w0[0, 0] = 1.0                              # relu(x), x the first encoded lane
    w1 = np.zeros_like(mlp.trunk_w[1])
    w1[in_dim, 0] = 1.0                         # the skip input is [enc | h]
    s0 = np.zeros_like(mlp.sigma_w0)
    s0[0, 0] = 1.0
    s1 = np.zeros_like(mlp.sigma_w1)
    s1[0, 0] = 100.0
    return mlp._replace(trunk_w=(w0, w1), trunk_b=tuple(np.zeros_like(b) for b in mlp.trunk_b),
                        sigma_w0=s0, sigma_b0=np.zeros_like(mlp.sigma_b0), sigma_w1=s1,
                        sigma_b1=np.full_like(mlp.sigma_b1, -60.0))


def _case(mode, stage, split_max, coarse_free=False):
    """(jc, tc, JAX params, JAX data, key, the port's case for the ranks)."""
    jc, tc = _configs(mode, coarse_free)
    assert jc.nerf.coarse_free_at(stage) == tc.nerf.coarse_free_at(stage) == coarse_free
    rng = np.random.default_rng(7)
    se3 = np.concatenate([rng.normal(size=(N_IMG, 3)) * 0.3,
                          rng.normal(size=(N_IMG, 3)) * 0.3 + [0, 0, 4]], 1).astype(np.float32)
    key = jax.random.PRNGKey(12)
    nerf = jax.tree.map(np.asarray, j_init_nerf(jax.random.PRNGKey(3), jc.nerf))
    if split_max:
        # rank 0's image looks into x > 0 from x = 30, every other into x < 0
        while len(set(_first_img_ids(key).tolist())) < WORLD:
            key = jax.random.fold_in(key, 1)
        se3[:] = [0, 0, 0, 30, 0, 4]
        se3[_first_img_ids(key)[0]] = [0, 0, 0, -30, 0, 4]
        nerf = nerf._replace(coarse=_dense_half_space(nerf.coarse, jc.nerf.embed_dim))
    cam = j_cam.CameraParams(
        pose_se3=jnp.asarray(se3),
        calib_pose_se3=jnp.asarray((rng.normal(size=(N_IMG, 6)) * 0.3 + [0, 0, 0, 0, 0, 4])
                                   .astype(np.float32)),
        fx=jnp.asarray(rng.uniform(0.8, 1.2, N_IMG).astype(np.float32)),
        fy=jnp.asarray(rng.uniform(0.8, 1.2, N_IMG).astype(np.float32)),
        ux=jnp.asarray(rng.uniform(0.9, 1.1, N_IMG).astype(np.float32)),
        uy=jnp.asarray(rng.uniform(0.9, 1.1, N_IMG).astype(np.float32)))
    jp = j_optim.Params(cam=cam, nerf=jax.tree.map(jnp.asarray, nerf))
    images = rng.integers(0, 256, size=(N_IMG, H * W, 3), dtype=np.uint8)
    pts = rng.uniform(0, W, size=(N_IMG, 6, 5, 2)).astype(np.float32)
    valid = rng.random((N_IMG, 6)) < 0.6
    valid[:, 0] = True
    ids, counts = j_calib._pad_valid_ids(valid)
    jcal = j_calib.CalibrationData(jnp.asarray(pts), jnp.asarray(pts * 0.9), jnp.asarray(ids),
                                   jnp.asarray(ids), jnp.asarray(counts), jnp.asarray(counts),
                                   jnp.asarray(j_tag_points(1.0)))
    occ_j = occ_t = None
    if mode == "importance":
        dens = np.where(rng.random((16, 16, 16)) < 0.3, 5.0, 0.0).astype(np.float32)
        occ = np.asarray(j_occ.binary_grid(j_occ.OccupancyGrid(jnp.asarray(dens)), jc.nerf),
                         np.float32)
        occ_j, occ_t = jnp.asarray(occ, jnp.bfloat16), torch.as_tensor(occ).bfloat16()
    jdata = j_steps.TrainData(jnp.asarray(images), jcal, occ_j)
    start = t_steps.train_state_from_numpy(jax.tree.map(np.asarray, jp), (), 0, tc, CPU)
    port = {"cfg": tc, "stage": stage, "p_flat": start.p_flat,
            "leaves": [p.numel() for p in start.params.parameters()],
            "data": t_steps.TrainData(torch.as_tensor(images), t_calib.calibration_from_numpy(
                pts, valid, pts * 0.9, valid, device=CPU), occ_t),
            "draws": _global_draws(key, tc, stage, occ_t is not None)}
    return jc, tc, jp, jdata, key, port


_RANK = textwrap.dedent("""
    import json, sys
    import torch
    from mc_nerf_torch.models import nerf as nerf_module
    from mc_nerf_torch.models.camera_params import init_camera_params
    from mc_nerf_torch.models.nerf import init_nerf_params
    from mc_nerf_torch.parallel.distributed import initialize_distributed
    from mc_nerf_torch.train import steps
    from mc_nerf_torch.train.optim import Params, build_optimizers, counter, flatten_params

    work, h, w, total, step_at = sys.argv[1], *map(int, sys.argv[2:])
    topo = initialize_distributed(device="cpu", init_method=f"file://{work}/store")
    cuts, select = [], nerf_module.select_fine_bins

    def spy(weights, k, thresh, batch_max=None):
        cuts.append([float(weights.max()), None if batch_max is None else float(batch_max)])
        return select(weights, k, thresh, batch_max)

    nerf_module.select_fine_bins = spy
    out = {}
    for name, c in torch.load(f"{work}/cases.pt", weights_only=False).items():
        cfg, stage = c["cfg"], c["stage"]
        params = Params(init_camera_params(c["data"].images_u8.shape[0], "cpu"),
                        init_nerf_params(cfg.nerf, None, "cpu"))
        p_flat = flatten_params(params)
        with torch.no_grad():
            p_flat.copy_(c["p_flat"])
        txs, states = build_optimizers(cfg, params, p_flat, steps_per_epoch=10)
        state = steps.TrainState(params, p_flat, states, counter(step_at, "cpu"))
        fn = steps.make_stage_step(cfg, stage, txs[stage], h, w, total, topo.world)
        cuts.clear()
        m = fn(state, c["data"], steps.rank_block(c["draws"], topo.rank, topo.world))
        out[name] = {"metrics": {k: float(v) for k, v in m.items()}, "p_flat": p_flat.clone(),
                     "cuts": list(cuts), "step": state.step}
    torch.save(out, f"{work}/rank{topo.rank}.pt")
    torch.distributed.destroy_process_group()
    print(json.dumps({"rank": topo.rank, "backend": topo.backend}))
""")


@pytest.fixture(scope="module")
def port_steps(tmp_path_factory):
    """Every case's port step on 2 gloo ranks, in one launch."""
    work = tmp_path_factory.mktemp("ranks")
    cases = {name: _case(*spec) for name, spec in CASES.items()}
    torch.save({name: c[-1] for name, c in cases.items()}, work / "cases.pt")
    spawn_ranks(WORLD, ["-c", _RANK, str(work), str(H), str(W), str(TOTAL_STEPS), str(STEP)],
                str(work), env={"OMP_NUM_THREADS": "1"}, timeout=300)
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return cases, ranks


@pytest.mark.parametrize("name", list(CASES))
def test_step_on_two_ranks_matches_the_jax_mesh(port_steps, name):
    cases, ranks = port_steps
    jc, tc, jp, jdata, key, port = cases[name]
    stage = port["stage"]
    jtxs, jstates = j_optim.build_optimizers(jc, jp, steps_per_epoch=10)
    jstep = j_steps.make_stage_step(jc, stage, jtxs[stage], H, W, TOTAL_STEPS,
                                    images_per_batch=WORLD, mesh=make_mesh(WORLD))
    jnew, jm = jstep(j_steps.TrainState(jp, jstates, jnp.asarray(STEP, jnp.int32)), jdata, key)
    j_flat = t_steps.train_state_from_numpy(jax.tree.map(np.asarray, jnew.params), (), 0, tc,
                                            CPU).p_flat
    r0, r1 = (r[name] for r in ranks)
    assert r0["step"] == r1["step"] == STEP + 1
    # one all-reduced gradient: the same update on every rank
    assert torch.equal(r0["p_flat"], r1["p_flat"])
    for k, v in jm.items():
        got = (r0["metrics"][k] + r1["metrics"][k]) / WORLD
        assert abs(got - float(v)) <= LOSS_RTOL * max(abs(float(v)), 1e-6), (k, got, float(v))
    # each leaf's update against JAX's (the port's flat layout, leaf by leaf)
    p0 = port["p_flat"]
    off = 0
    for n in port["leaves"]:
        part = slice(off, off + n)
        off += n
        ref, got = j_flat[part] - p0[part], r0["p_flat"][part] - p0[part]
        err = float((got - ref).abs().max())
        assert err <= UPDATE_TOL * max(1e-12, float(ref.abs().max())), (part, err)
    if tc.train.fine_mode == "grid":
        # every rank selected against the global batch's max
        (l0, b0), = r0["cuts"]
        (l1, b1), = r1["cuts"]
        assert b0 == b1 == max(l0, l1)
        if "below" in name:
            assert l1 < tc.nerf.weight_thresh <= l0


def test_render_matches_the_jax_mesh_render():
    """The port's make_render_fn against JAX's shard_map render on a
    2-device mesh, both plain in fp32, importance mode, no map: rgb and
    opacity 1e-4, depth 1e-3 (``tests/test_torch_slice.py``'s bounds;
    measured 2.4e-7, 7.2e-7, 2.4e-7)."""
    kw = dict(samples_coarse=16, sample_scale=4, fine_bins_topk=4, emb_freqs_xyz=4,
              coarse_depth=2, coarse_width=16, coarse_skips=(1,), fine_depth=2,
              fine_width=16, fine_skips=(1,))
    jc, tc = (m.Config(nerf=m.NerfConfig(**kw),
                       eval=m.EvalConfig(res_h=16, res_w=16, rays_per_chunk=64,
                                         importance_samples=8, use_pallas=False),
                       compute_dtype="float32") for m in (j_config, t_config))
    params = j_init_nerf(jax.random.PRNGKey(3), jc.nerf)
    pose = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 4.0]], np.float32)
    K = np.array([[16, 0, 8], [0, 16, 8], [0, 0, 1]], np.float32)
    want = j_steps.make_render_fn(jc, 16, 16, mesh=make_mesh(WORLD))(
        params, jnp.asarray(pose), jnp.asarray(K))
    got = t_steps.make_render_fn(tc, 16, 16, device=CPU)(
        nerf_params_from_numpy(jax.tree.map(np.asarray, params), tc.nerf, CPU), pose, K)
    for g, w, name, atol in zip(got, want, ("rgb", "depth", "opacity"), (1e-4, 1e-3, 1e-4)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol, err_msg=name)


def test_dryrun_multichip_on_two_ranks(monkeypatch):
    """Config() widths, the rays cut to 512 a rank: finite, the same bits."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    out = dryrun_multichip(WORLD, rays_per_rank=512, timeout=300)
    assert np.isfinite(out["loss"]) and out["backend"] == "gloo"
