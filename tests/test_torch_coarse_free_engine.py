"""The port's ``Engine`` under the hybrid coarse-free schedule against the
JAX package's, on the CPU, on the engine tests' tiny scene
(``tests/test_torch_engine.py``: 5 train views at 24x24, 2-layer width-16
MLPs, 128 rays a step, float32, plain routes).

One JAX run and one port run of a 1 + 1 + 2 epoch protocol (10 steps an
epoch) with ``coarse_free_from_stage=2`` (GLOBAL_OPTIM two-pass, FINE_TUNE
coarse-free), ``cf_uniform_samples=4``, a bitpacked G=32 map refreshed
after every NeRF epoch, for the refresh sources "auto" (the coarse MLP
throughout) and "fine" (the fine MLP in FINE_TUNE), give:
  * the schedule: the stage of each epoch, the refreshes as (epoch,
    source, fresh): exact;
  * the trajectory, the port drawing from the JAX key tree (its
    coarse-free draws included, ``tests/test_torch_engine.py``'s
    ``_draws_from_key``): each epoch's mean metrics to rtol 1e-3
    (measured: 3.1e-7 at most; the coarse-free epochs' rgb_c term exactly
    zero on both), the camera and the NeRF parameters after each epoch
    each to 2.5e-5 of their largest entry (measured after the last epoch:
    7.5e-8 on the cameras, 6.0e-6 ("auto") and 1.2e-7 ("fine") on the
    MLPs); the last map bit for bit; in each coarse-free refresh the other
    source would have given another map, so the agreement holds the
    source;
  * the coarse MLP bit-identical across the coarse-free epochs on both.
Then the demo of the epoch-0 checkpoint (before the occupancy warm-up)
renders coarse-free from the uniform prior on both, with no refresh: the
same scores.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from mc_nerf_tpu.data.synthetic import make_dataset as j_make_dataset
from mc_nerf_tpu.train import engine as j_engine

from mc_nerf_torch.ops import occupancy as t_occ
from mc_nerf_torch.train import engine as t_engine
from mc_nerf_torch.train import steps as t_steps
from tests.test_torch_engine import CPU, HW, N_TRAIN, _configs, _draws_from_key, _spy, _t

STAGES = (1, 1, 2)
# the threshold near the median of the tiny field's refreshed density
# (softplus ~0.56-0.72 here, times the coarse step 7 / 48), no dilation and
# a fast EMA, so that the map is partly occupied and follows its source
HYBRID = dict(coarse_free=True, coarse_free_from_stage=2, cf_uniform_samples=4,
              occ_grid_size=32, occ_map_dtype="bitpack", occ_update_every=1,
              occ_warmup_steps=10, occ_thresh=0.089, occ_dilate=False, occ_decay=0.5)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("scene") / "Tiny_Hybrid")
    j_make_dataset(d, n_train=N_TRAIN, n_val=2, n_test=2, img_h=HW, img_w=HW, seed=7)
    return d


@pytest.fixture(scope="module", params=["auto", "fine"])
def hybrid_runs(scene_dir, tmp_path_factory, request):
    """The JAX engine and the port's through the hybrid protocol from the
    same state, the port drawing from the JAX key tree."""
    jcfg, tcfg = _configs(scene_dir, str(tmp_path_factory.mktemp("hyb")), STAGES,
                          occ_refresh_source=request.param, **HYBRID)
    jeng = j_engine.Engine(jcfg)
    init = jax.tree.map(np.asarray, (jeng.state.params, jeng.state.opt_states, jeng.state.step))
    train_key, spe = jeng.train_key, jeng.steps_per_epoch
    j_metrics, j_params = [], {}
    run_epoch = jeng._run_epoch
    jeng._run_epoch = lambda *a: j_metrics.append(run_epoch(*a)) or j_metrics[-1]
    j_refresh = _spy(jeng, "_refresh_occupancy", lambda e: [e, jeng.occ_grid is None])
    j_sources = _spy(jeng, "_grid_refresh_fns", lambda source: source)
    _spy(jeng.ckpt, "save",
         lambda e, s: j_params.__setitem__(e, jax.tree.map(np.array, s.params)))
    jeng.train()
    jeng.ckpt.wait()
    j_refresh = [(e, src, fresh) for (e, fresh), src in zip(j_refresh, j_sources)]

    calls = itertools.count()

    def draws(cfg, stage, n_images, img_h, img_w, culled, generator):
        epoch, i = divmod(next(calls), spe)
        key = jax.random.split(jax.random.fold_in(jax.random.fold_in(train_key, epoch), 0), spe)[i]
        return _draws_from_key(key, cfg, stage, culled)

    def jitter(cfg, epoch, device):
        key = jax.random.fold_in(jax.random.PRNGKey(cfg.train.seed ^ 0x0CC), epoch)
        return _t(jax.random.uniform(key, (cfg.nerf.occ_grid_size ** 3, 3)))

    t_refresh, t_params = [], {}
    refresh_grid = t_engine.refresh_grid

    other_differs = []

    def spy_refresh(nerf, cfg, device, epoch, grid=None, source="coarse"):
        t_refresh.append((epoch, source, grid is None))
        out = refresh_grid(nerf, cfg, device, epoch, grid, source)
        if cfg.stages.stage_of_epoch(epoch) == 2:
            other = refresh_grid(nerf, cfg, device, epoch, grid,
                                 {"coarse": "fine", "fine": "coarse"}[source])
            other_differs.append(not torch.equal(t_occ.sampler_map(out, cfg.nerf),
                                                 t_occ.sampler_map(other, cfg.nerf)))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_steps, "draw_step", draws)
        mp.setattr(t_engine, "refresh_jitter", jitter)
        mp.setattr(t_engine, "refresh_grid", spy_refresh)
        teng = t_engine.Engine(tcfg, device=CPU)
        teng.state = t_steps.train_state_from_numpy(*init[:2], int(init[2]), tcfg, CPU)
        _spy(teng.ckpt, "save", lambda e, s: t_params.__setitem__(e, s.p_flat.clone()))
        teng.train()
    j_flat = {e: t_steps.train_state_from_numpy(p, (), 0, tcfg, CPU).p_flat
              for e, p in j_params.items()}
    return dict(jeng=jeng, teng=teng, j_metrics=j_metrics, j_refresh=j_refresh,
                t_refresh=t_refresh, other_differs=other_differs, j_flat=j_flat, t_flat=t_params, jcfg=jcfg,
                source=request.param)


def test_hybrid_schedule_matches_jax(hybrid_runs):
    r = hybrid_runs
    jeng, teng = r["jeng"], r["teng"]
    assert teng.steps_per_epoch == jeng.steps_per_epoch == 10
    assert teng.state.step == int(jeng.state.step) == 40
    assert [h["stage"] for h in teng.history] == [r["jcfg"].stages.stage_of_epoch(e)
                                                  for e in range(4)] == [0, 1, 2, 2]
    ft = "coarse" if r["source"] == "auto" else "fine"
    assert r["t_refresh"] == r["j_refresh"] == [(1, "coarse", True), (2, ft, False),
                                                (3, ft, False)]
    # the last map, bit for bit
    assert teng._occ_map.dtype == t_occ.BITPACK_DTYPE
    np.testing.assert_array_equal(teng._occ_map.numpy(), np.asarray(jeng._occ2d).view(np.int32))

    # in each coarse-free epoch's refresh the other source's map differs:
    # the trajectories below hold the source the port chose
    assert r["other_differs"] == [True, True]


def test_hybrid_trajectory_matches_jax(hybrid_runs):
    r = hybrid_runs
    teng = r["teng"]
    assert len(r["j_metrics"]) == len(teng.history) == 4
    for jm, th in zip(r["j_metrics"], teng.history):
        for k, v in jm.items():
            assert abs(th[k] - v) <= 1e-3 * abs(v), (th["epoch"], k, th[k], v)
        if th["stage"] == 2:
            assert th["loss_rgb_c"] == jm["loss_rgb_c"] == 0.0
    n_cam = sum(p.numel() for p in teng.state.params.cam.parameters())
    n_coarse = sum(p.numel() for p in teng.state.params.nerf.coarse.parameters())
    for e in range(4):
        for part in (slice(0, n_cam), slice(n_cam, None)):
            want, got = r["j_flat"][e][part], r["t_flat"][e][part]
            err = float((got - want).abs().max())
            assert err <= 2.5e-5 * float(want.abs().max()), (e, part, err)
    # the coarse MLP is frozen in the coarse-free epochs, on both
    coarse = slice(n_cam, n_cam + n_coarse)
    for flats in (r["t_flat"], r["j_flat"]):
        assert torch.equal(flats[1][coarse], flats[2][coarse])
        assert torch.equal(flats[2][coarse], flats[3][coarse])
        assert not torch.equal(flats[0][coarse], flats[1][coarse])


def test_demo_before_the_warm_up_renders_coarse_free_from_the_uniform_prior(hybrid_runs,
                                                                           monkeypatch):
    """The epoch-0 checkpoint has no NeRF step: no refresh, the views
    render coarse-free from the uniform prior (the map is the only
    proposal there), with the JAX engine's scores."""
    r = hybrid_runs
    teng = r["teng"]
    maps = []
    render_fn = teng._render_fn

    def spy_render_fn(h, w):     # the engine's own renderer of the views' size
        fn = render_fn(h, w)
        return lambda params, pose, K, occ=None: maps.append(occ) or fn(params, pose, K, occ)

    for obj, name in ((t_engine, "refresh_occupancy"), (teng, "_refresh_occupancy")):
        monkeypatch.setattr(obj, name, lambda *a: pytest.fail("refreshed before the warm-up"))
    monkeypatch.setattr(teng, "_render_fn", spy_render_fn)
    got = teng.demo(ckpt_epoch=0)
    want = r["jeng"].demo(ckpt_epoch=0)
    prior = t_occ.uniform_prior_map(teng.cfg.nerf, CPU)
    assert len(maps) == 2 and all(torch.equal(m, prior) for m in maps)
    assert got["count"] == want["count"] == 2
    for k in ("psnr", "ssim"):
        assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), (k, got[k], want[k])
