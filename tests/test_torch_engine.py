"""The port's ``Engine`` against the JAX package's, on the CPU, on the JAX
engine test's tiny scene (``tests/test_engine.py:22-50``: 5 train views at
24x24, 2-layer width-16 MLPs, 128 rays a step, float32, plain routes).

One JAX run and one port run of a 2 + 2 + 2 epoch protocol (10 steps an
epoch), in each fine mode: importance (the occupancy map refreshed every
2 NeRF epochs once 20 NeRF steps have run) and grid (train and eval; no
occupancy map), give:
  * the schedule: steps per epoch, the stage of each epoch, the epochs
    that restart cameras, the epochs that refresh the map and whether
    each refresh is fresh or EMA, the checkpoint epochs kept: exact;
  * the trajectory: the port starts from the JAX engine's initial state
    (``train_state_from_numpy``), its step draws are built from the JAX
    key tree (``fold_in(train_key, epoch)`` -> ``split``) and its refresh
    jitter from the JAX key's uniforms.  Each epoch's mean metrics agree
    to rtol 1e-3 (measured: 8.1e-5 at most over the six epochs in
    importance mode, 7.8e-5 in grid mode), the camera and the NeRF
    parameters after each epoch each to 2.5e-5 of their largest entry
    (measured after the sixth epoch: 9.9e-7 on the cameras in both modes,
    2.4e-6 on the MLPs in importance mode, 9.9e-6 in grid mode).
Then the port alone: a resume from the epoch-0 checkpoint ends on the
same bits as the uninterrupted run; a resume past a refresh rebuilds the
map fresh, as the JAX engine does (``engine.py:452-464``); ``demo`` of a
stage-0 checkpoint renders unculled (``engine.py:651-676``); two
refreshes jitter differently; a scene without a detection cache gets one
from the detector (and one whose cube images hold no tag is refused); an
unknown fine mode is refused.
"""

import dataclasses
import itertools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mc_nerf_tpu import config as j_config
from mc_nerf_tpu.data.synthetic import make_dataset as j_make_dataset
from mc_nerf_tpu.train import engine as j_engine

from mc_nerf_torch import config as t_config
from mc_nerf_torch.data.synthetic import make_dataset
from mc_nerf_torch.models.nerf import RenderDraws
from mc_nerf_torch.train import engine as t_engine
from mc_nerf_torch.train import steps as t_steps

CPU = "cpu"
NERF_KW = dict(samples_coarse=24, sample_scale=4, fine_bins_topk=6, emb_freqs_xyz=4,
               coarse_depth=2, coarse_width=16, coarse_skips=(1,),
               fine_depth=2, fine_width=16, fine_skips=(1,), occ_grid_size=16)
N_TRAIN, HW = 5, 24


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("scene") / "Tiny_Spheres")
    j_make_dataset(d, n_train=N_TRAIN, n_val=2, n_test=2, img_h=HW, img_w=HW, seed=7)
    return d


def _configs(scene_dir, out, stages, **nerf):
    """The JAX test's small_cfg on both sides, plain routes."""
    root, name = os.path.split(scene_dir)
    kw = dict(data_root=root, data_name=name, compute_dtype="float32")

    def make(m, **extra):
        return m.Config(
            stages=m.StageConfig(*stages),
            train=m.TrainConfig(rays_per_batch=128, steps_per_image_epoch=2, use_pallas=False,
                                ckpt_max_keep=2),
            nerf=m.NerfConfig(**{**NERF_KW, **nerf}),
            eval=m.EvalConfig(res_h=HW, res_w=HW, rays_per_chunk=128, use_pallas=False),
            paths=m.PathsConfig(root_weights=os.path.join(out, "weights"),
                                root_out=os.path.join(out, "results"),
                                log_path=os.path.join(out, "log"), tb_path=os.path.join(out, "tb")),
            **kw, **extra)

    return make(j_config, parallel=j_config.ParallelConfig(data_parallel=1)), make(t_config)


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x)).to(dtype)


def _draws_from_key(key, cfg, stage, culled):
    """The draws the JAX loss takes from its step key (train/steps.py:162,
    :68, :105-118; models/nerf.py:188); in a coarse-free stage the PMF
    draw's uniforms from kn_pdf, the mixture's from kn_sel, the noise
    from kn_f."""
    rays, imp = cfg.train.rays_per_batch, cfg.train.importance_samples
    k_calib, k_rays, k_render = jax.random.split(key, 3)
    k_int, k_ext = jax.random.split(k_calib)
    u_int, u_ext = (_t(jax.random.uniform(k, (N_TRAIN,))) for k in (k_int, k_ext))
    if stage == 0:
        return t_steps.StepDraws(u_int, u_ext, None, None, None)
    k_img, k_pix = jax.random.split(k_rays)
    img_ids = jax.random.randint(k_img, (1,), 0, N_TRAIN)
    pix = jax.random.permutation(jax.random.split(k_pix, 1)[0], HW * HW)[None, :rays]  # hw <= 8R
    kj, kn_c, kn_sel, kn_pdf, kn_f = jax.random.split(k_render, 5)
    nc = cfg.nerf
    if cfg.train.fine_mode == "grid":     # models/nerf.py:259-262, :292-305
        assert not culled
        sc = nc.samples_coarse
        render = RenderDraws(
            _t(jax.random.uniform(kj, (rays, 1), jnp.float32, 0.0, (nc.far - nc.near) / sc)),
            _t(jax.random.normal(kn_c, (rays, sc))), _t(jax.random.normal(kn_sel, (rays, sc))),
            None, _t(jax.random.normal(kn_f, (rays, nc.samples_fine))))
        return t_steps.StepDraws(u_int, u_ext, _t(img_ids, torch.int64), _t(pix, torch.int64),
                                 render)
    assert culled
    if nc.coarse_free_at(stage):          # models/nerf.py:193-235, ops/volume.py:231-234
        ku = min(max(nc.cf_uniform_samples, 0), imp - 1)
        render = RenderDraws(None, None, None, _t(jax.random.uniform(kn_pdf, (rays, imp - ku))),
                             _t(jax.random.normal(kn_f, (rays, imp))),
                             _t(jax.random.uniform(kn_sel, (rays, ku))) if ku else None)
        return t_steps.StepDraws(u_int, u_ext, _t(img_ids, torch.int64), _t(pix, torch.int64),
                                 render)
    sc = nc.occ_coarse_samples
    render = RenderDraws(_t(jax.random.uniform(kj, (rays, sc))),
                         _t(jax.random.normal(kn_c, (rays, sc))),
                         _t(jax.random.normal(kn_sel, (rays, sc))),
                         _t(jax.random.uniform(kn_pdf, (rays, imp))),
                         _t(jax.random.normal(kn_f, (rays, imp))))
    return t_steps.StepDraws(u_int, u_ext, _t(img_ids, torch.int64), _t(pix, torch.int64), render)


def _spy(obj, name, record):
    """Wrap ``obj.name`` so that each call first appends ``record(*args)``
    to the returned list."""
    calls = []
    orig = getattr(obj, name)

    def wrapped(*args, **kw):
        calls.append(record(*args))
        return orig(*args, **kw)

    setattr(obj, name, wrapped)
    return calls


def _fine_mode(cfg, mode):
    return cfg.replace(train=dataclasses.replace(cfg.train, fine_mode=mode),
                       eval=dataclasses.replace(cfg.eval, fine_mode=mode))


@pytest.fixture(scope="module", params=["importance", "grid"])
def both_runs(scene_dir, tmp_path_factory, request):
    """The JAX engine and the port's engine through the same 2 + 2 + 2
    protocol from the same state, in one fine mode, the port drawing from
    the JAX key tree."""
    jcfg, tcfg = (_fine_mode(c, request.param) for c in _configs(
        scene_dir, str(tmp_path_factory.mktemp("both")), (2, 2, 2), occ_update_every=2,
        occ_warmup_steps=20))
    jeng = j_engine.Engine(jcfg)
    init = jax.tree.map(np.asarray, (jeng.state.params, jeng.state.opt_states, jeng.state.step))
    train_key, spe = jeng.train_key, jeng.steps_per_epoch
    j_metrics = []
    j_params = {}
    run_epoch = jeng._run_epoch
    jeng._run_epoch = lambda *a: j_metrics.append(run_epoch(*a)) or j_metrics[-1]
    j_refresh = _spy(jeng, "_refresh_occupancy", lambda e: (e, jeng.occ_grid is None))
    j_restart = _spy(jeng, "_maybe_restart_cameras", lambda d, e: e)
    _spy(jeng.ckpt, "save",
         lambda e, s: j_params.__setitem__(e, jax.tree.map(np.array, s.params)))
    jeng.train()
    jeng.ckpt.wait()
    j_kept = sorted(int(n) for n in os.listdir(jeng.ckpt_dir) if n.isdigit())

    calls = itertools.count()

    def draws(cfg, stage, n_images, img_h, img_w, culled, generator):
        epoch, i = divmod(next(calls), spe)
        key = jax.random.split(jax.random.fold_in(jax.random.fold_in(train_key, epoch), 0), spe)[i]
        return _draws_from_key(key, cfg, stage, culled)

    def jitter(cfg, epoch, device):
        key = jax.random.fold_in(jax.random.PRNGKey(cfg.train.seed ^ 0x0CC), epoch)
        return _t(jax.random.uniform(key, (cfg.nerf.occ_grid_size ** 3, 3)))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_steps, "draw_step", draws)
        mp.setattr(t_engine, "refresh_jitter", jitter)
        teng = t_engine.Engine(tcfg, device=CPU)
        teng.state = t_steps.train_state_from_numpy(*init[:2], int(init[2]), tcfg, CPU)
        t_params = {}
        t_refresh = _spy(teng, "_refresh_occupancy", lambda e: (e, teng.occ_grid is None))
        t_restart = _spy(teng, "_maybe_restart_cameras", lambda d, e: e)
        _spy(teng.ckpt, "save", lambda e, s: t_params.__setitem__(e, s.p_flat.clone()))
        teng.train()
    # the JAX parameters after each epoch, in the port's layout
    j_flat = {e: t_steps.train_state_from_numpy(p, (), 0, tcfg, CPU).p_flat
              for e, p in j_params.items()}
    return dict(jeng=jeng, teng=teng, j_metrics=j_metrics, j_refresh=j_refresh,
                t_refresh=t_refresh, j_restart=j_restart, t_restart=t_restart, j_kept=j_kept,
                j_flat=j_flat, t_flat=t_params, jcfg=jcfg, mode=request.param)


def test_schedule_matches_jax(both_runs):
    r = both_runs
    jeng, teng = r["jeng"], r["teng"]
    assert teng.steps_per_epoch == jeng.steps_per_epoch == 10
    assert teng.state.step == int(jeng.state.step) == 60
    assert [h["stage"] for h in teng.history] == [r["jcfg"].stages.stage_of_epoch(e)
                                                  for e in range(6)] == [0, 0, 1, 1, 2, 2]
    assert r["t_restart"] == r["j_restart"] == [0]
    # importance: refreshes after 2 NeRF epochs (fresh), after 4 (EMA);
    # grid: no occupancy map
    want = [(3, True), (5, False)] if r["mode"] == "importance" else []
    assert r["t_refresh"] == r["j_refresh"] == want
    assert (teng.occ_grid is None) == (r["mode"] == "grid")
    assert teng.ckpt.epochs() == r["j_kept"] == [1, 3, 4, 5]


def test_trajectory_matches_jax(both_runs):
    r = both_runs
    assert len(r["j_metrics"]) == len(r["teng"].history) == 6
    for jm, th in zip(r["j_metrics"], r["teng"].history):
        for k, v in jm.items():
            assert abs(th[k] - v) <= 1e-3 * abs(v), (th["epoch"], k, th[k], v)
    n_cam = sum(p.numel() for p in r["teng"].state.params.cam.parameters())
    for e in range(6):
        for part in (slice(0, n_cam), slice(n_cam, None)):
            want, got = r["j_flat"][e][part], r["t_flat"][e][part]
            err = float((got - want).abs().max())
            assert err <= 2.5e-5 * float(want.abs().max()), (e, part, err)


# ----------------------------------------------------------- the port alone

@pytest.fixture(scope="module")
def run_a(scene_dir, tmp_path_factory):
    """The port's 1 + 1 + 1 protocol with refreshes after epochs 1 (fresh)
    and 2 (EMA), as chip_smoke.py runs it, each refresh's jitter kept."""
    out = str(tmp_path_factory.mktemp("a"))
    _, cfg = _configs(scene_dir, out, (1, 1, 1), occ_warmup_steps=10)
    eng = t_engine.Engine(cfg, device=CPU)
    jitters = []
    orig = t_engine.refresh_jitter

    def spy(cfg_, epoch, device):
        jitters.append((epoch, orig(cfg_, epoch, device)))
        return jitters[-1][1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_engine, "refresh_jitter", spy)
        refresh = _spy(eng, "_refresh_occupancy", lambda e: (e, eng.occ_grid is None))
        eng.train()
    return dict(eng=eng, cfg=cfg, out=out, jitters=jitters, refresh=refresh)


def _resumed(run, epoch, tmp_path):
    """An engine on a fresh weights directory holding only ``epoch``'s
    checkpoint of ``run``."""
    cfg = run["cfg"]
    cfg_b = cfg.replace(paths=dataclasses.replace(cfg.paths,
                                                  root_weights=str(tmp_path / "weights")))
    eng_b = t_engine.Engine(cfg_b, device=CPU)
    shutil.copytree(os.path.join(run["eng"].ckpt_dir, str(epoch)),
                    os.path.join(eng_b.ckpt_dir, str(epoch)))
    return eng_b


def test_resume_from_epoch_0_gives_the_same_bits(run_a, tmp_path):
    a = run_a["eng"]
    assert run_a["refresh"] == [(1, True), (2, False)]
    b = _resumed(run_a, 0, tmp_path)
    b.train(resume=True)
    assert [h["epoch"] for h in b.history] == [1, 2]
    assert b.state.step == a.state.step == 30
    assert torch.equal(b.state.p_flat, a.state.p_flat)
    for sa, sb in zip(a.state.opt_states, b.state.opt_states):
        assert sa.count == sb.count and torch.equal(sa.mu, sb.mu) and torch.equal(sa.nu, sb.nu)


def test_resume_after_a_refresh_rebuilds_the_map_fresh(run_a, tmp_path):
    """Resumed after epoch 1 (refreshed), the map is rebuilt fresh from the
    restored coarse MLP with epoch 1's jitter before epoch 2 trains, and
    epoch 2's refresh is then an EMA: the JAX engine's order."""
    b = _resumed(run_a, 1, tmp_path)
    refresh = _spy(b, "_refresh_occupancy", lambda e: (e, b.occ_grid is None))
    fresh = {}
    orig = b._epoch_fn

    def epoch_fn(stage):
        fresh.setdefault("map", b._occ_map.clone())
        return orig(stage)

    b._epoch_fn = epoch_fn
    b.train(resume=True)
    assert refresh == [(1, True), (2, False)]
    restored = _resumed(run_a, 1, tmp_path / "c")
    restored.ckpt.restore(restored.state, 1)
    want = t_engine.refresh_occupancy(restored.state.params.nerf, run_a["cfg"], CPU, 1)
    assert torch.equal(fresh["map"], want)


def test_two_refreshes_jitter_differently(run_a):
    (e1, j1), (e2, j2) = run_a["jitters"]
    assert (e1, e2) == (1, 2) and j1.shape == j2.shape == (16 ** 3, 3)
    assert not torch.equal(j1, j2)


def test_demo_of_a_stage0_checkpoint_renders_unculled(run_a):
    """The demo of the epoch-0 checkpoint refreshes no map; the latest's
    refreshes the engine's own, fresh, with its epoch's jitter."""
    cfg = run_a["cfg"].replace(mode=1)
    eng = t_engine.Engine(cfg, device=CPU)
    calls = _spy(eng, "_refresh_occupancy", lambda e: (e, eng.occ_grid is None))
    early = eng.demo(ckpt_epoch=0)
    assert calls == []
    late = eng.demo()      # the latest checkpoint: 2 NeRF epochs trained
    assert calls == [(2, True)]
    for res in (early, late):
        assert res["count"] == 2 and np.isfinite(res["psnr"]) and np.isfinite(res["ssim"])
        assert sorted(os.listdir(os.path.join(res["out_dir"], "pred"))) == ["0000.png", "0001.png"]
    out_dir = os.path.join(cfg.paths.render_dir, cfg.data_name)
    assert {"epoch_1.png", "epoch_1_gt.png", "epoch_2_depth.png"} <= set(os.listdir(out_dir))


def test_train_refuses_a_scene_without_a_detection_cache(tmp_path):
    """A scene that ships calib / coord cube images and no detection cache
    gets the cache make_dataset wrote, from the detector, before training;
    one whose calib image holds no tag is refused (ref data_read.py:208-212)."""
    d = str(tmp_path / "Rendered")
    make_dataset(d, n_train=3, n_val=1, n_test=1, img_h=64, img_w=64, seed=2,
                 calibration_mode="rendered")
    cache = os.path.join(d, "calibration_cache.npz")
    want = dict(np.load(cache))
    os.remove(cache)
    _, cfg = _configs(d, str(tmp_path / "out"), (1, 0, 0))
    eng = t_engine.Engine(cfg, device=CPU)
    eng.train()
    got = np.load(cache)
    assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)
    assert eng.state.step == eng.steps_per_epoch == 6

    os.remove(cache)
    Image.new("RGBA", (64, 64), (255, 255, 255, 255)).save(os.path.join(d, "calib", "r_1.png"))
    with pytest.raises(ValueError, match="no tags detected in calib image 1"):
        t_engine.Engine(cfg, device=CPU).train()
    assert not os.path.exists(cache)


def test_a_failing_pose_plot_does_not_stop_training(scene_dir, tmp_path, monkeypatch, capfd):
    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(t_engine, "save_pose_plot", broken)
    _, cfg = _configs(scene_dir, str(tmp_path), (2, 0, 0))
    eng = t_engine.Engine(cfg, device=CPU)
    eng.train()
    assert eng.state.step == 2 * eng.steps_per_epoch and eng.ckpt.epochs() == [0, 1]
    assert capfd.readouterr().err.count("E] pose plot ") == 2    # logged once a camera table


def test_engine_refuses_an_unknown_fine_mode(scene_dir, tmp_path):
    _, cfg = _configs(scene_dir, str(tmp_path), (1, 1, 1))
    with pytest.raises(ValueError, match="fine_mode"):
        t_engine.Engine(cfg.replace(train=dataclasses.replace(cfg.train, fine_mode="coarse")),
                        device=CPU)


def test_two_images_a_step(scene_dir, tmp_path):
    """``images_per_batch=2``: an epoch has N * 2 // 2 steps, as the JAX
    engine counts them, and each step draws two images' rays."""
    jcfg, cfg = _configs(scene_dir, str(tmp_path), (0, 1, 0))
    jcfg = jcfg.replace(train=dataclasses.replace(jcfg.train, images_per_batch=2))
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, images_per_batch=2))
    eng = t_engine.Engine(cfg, device=CPU)
    assert eng.steps_per_epoch == j_engine.Engine(jcfg).steps_per_epoch == 5
    d = t_steps.draw_step(cfg, 1, N_TRAIN, HW, HW, True, torch.Generator().manual_seed(0))
    assert tuple(d.img_ids.shape) == (2,) and tuple(d.pix_idx.shape) == (2, 128)
    assert d.render.z_u.shape[0] == d.render.noise_f.shape[0] == 256
    eng.train()
    assert eng.state.step == 5 and np.isfinite(eng.history[0]["loss_rgb_f"])
