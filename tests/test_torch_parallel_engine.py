"""The port's ``Engine`` on 2 gloo ranks on the CPU (the counterpart of the
slow ``tests/test_multiprocess_train.py``, small enough for the tier-1
run), on the JAX engine test's tiny scene: 5 train views at 24x24, 2-layer
width-16 MLPs, 128 rays a rank, float32, plain routes, importance mode
with the occupancy map refreshed every 2 NeRF epochs once 10 NeRF steps
have run.

The ranks are subprocesses with torchrun's environment, rendezvousing
through a file store under the test's tmp directory.  One 2 + 2 + 2
protocol on 2 ranks (5 steps an epoch: 5 views x 2 / 2 images) gives:
  * the schedule of the JAX ``Engine(data_parallel=2)`` exactly (its train
    loop, gates and checkpoint retention as they are, its epochs stubbed):
    steps per epoch, the stage of each epoch, the restarts, the refreshes
    (fresh or EMA), the checkpoints kept; rank 0 alone builds the
    detection cache and writes the checkpoints;
  * the trajectory of the port's 1-rank ``Engine`` with
    ``images_per_batch=2`` from the same seed: each epoch's mean metrics
    to rtol 1.5e-6 and the parameters after each epoch to 2e-8 of their
    largest entry (measured: 1.3e-7 and 2.1e-9 at most over the six
    epochs: only the order of the gradient's sums differs);
  * ``p_flat`` after every epoch, and the occupancy map after every
    refresh, the same bits on both ranks;
  * a resume from the epoch-1 checkpoint (epoch 0's is pruned) ending on
    the uninterrupted run's bits on both ranks;
  * the demo: every view rendered on both ranks (each frame split over
    them), the views' scoring sharded over the ranks, each PNG written
    once, one stamped directory, the same dict on both ranks, and the
    scores of the 1-rank demo of the same checkpoint.
"""

import dataclasses
import os
import textwrap

import pytest
import torch

from mc_nerf_tpu import config as j_config
from mc_nerf_tpu.train import engine as j_engine

from mc_nerf_torch import config as t_config
from mc_nerf_torch.data.synthetic import make_dataset
from mc_nerf_torch.parallel.dryrun import spawn_ranks
from mc_nerf_torch.train import engine as t_engine

CPU = "cpu"
NERF_KW = dict(samples_coarse=24, sample_scale=4, fine_bins_topk=6, emb_freqs_xyz=4,
               coarse_depth=2, coarse_width=16, coarse_skips=(1,), fine_depth=2,
               fine_width=16, fine_skips=(1,), occ_grid_size=16, occ_update_every=2,
               occ_warmup_steps=10)
N_TRAIN, N_TEST, HW, WORLD = 5, 2, 24, 2
METRIC_RTOL, PARAM_TOL = 1.5e-6, 2e-8


def _configs(scene_dir, out):
    root, name = os.path.split(scene_dir)

    def make(m, **extra):
        return m.Config(
            stages=m.StageConfig(2, 2, 2),
            train=m.TrainConfig(rays_per_batch=128, steps_per_image_epoch=2, use_pallas=False,
                                ckpt_max_keep=2),
            nerf=m.NerfConfig(**NERF_KW),
            eval=m.EvalConfig(res_h=HW, res_w=HW, rays_per_chunk=128, use_pallas=False),
            paths=m.PathsConfig(root_weights=os.path.join(out, "weights"),
                                root_out=os.path.join(out, "results"),
                                log_path=os.path.join(out, "log"), tb_path=os.path.join(out, "tb")),
            data_root=root, data_name=name, compute_dtype="float32", **extra)

    return make(j_config, parallel=j_config.ParallelConfig(data_parallel=WORLD)), make(t_config)


def _spy(obj, name, record):
    calls = []
    orig = getattr(obj, name)

    def wrapped(*args, **kw):
        calls.append(record(*args))
        return orig(*args, **kw)

    setattr(obj, name, wrapped)
    return calls


def _epoch_params(eng):
    """Record ``p_flat`` after each epoch the engine trains."""
    kept, epoch_fn = [], eng._epoch_fn

    def wrapped(stage):
        fn = epoch_fn(stage)

        def run(*args):
            out = fn(*args)
            kept.append(eng.state.p_flat.clone())
            return out
        return run

    eng._epoch_fn = wrapped
    return kept


_RANK = textwrap.dedent("""
    import dataclasses, hashlib, os, shutil, sys
    import torch
    from mc_nerf_torch.parallel.distributed import initialize_distributed
    from mc_nerf_torch.parallel.mesh import barrier
    from mc_nerf_torch.train import engine as E

    work = sys.argv[1]
    topo = initialize_distributed(device="cpu", init_method=f"file://{work}/store")
    cfg = torch.load(os.path.join(work, "cfg.pt"), weights_only=False)
    digest = lambda t: hashlib.sha256(t.detach().float().contiguous().numpy().tobytes()).hexdigest()
    rec = {k: [] for k in ("p_flat", "digests", "refresh", "restart", "saved", "cache", "written")}

    def spy(obj, name, record):
        orig = getattr(obj, name)
        setattr(obj, name, lambda *a: (record(*a), orig(*a))[1])

    def instrument(eng):
        epoch_fn, refresh = eng._epoch_fn, eng._refresh_occupancy

        def counted(stage):
            fn = epoch_fn(stage)

            def run(*a):
                out = fn(*a)
                rec["p_flat"].append(eng.state.p_flat.clone())
                rec["digests"].append(digest(eng.state.p_flat))
                return out
            return run

        def refreshed(epoch):
            fresh = eng.occ_grid is None
            refresh(epoch)
            rec["refresh"].append((epoch, fresh, digest(eng._occ_map)))

        eng._epoch_fn, eng._refresh_occupancy = counted, refreshed
        spy(eng, "_maybe_restart_cameras", lambda d, e: rec["restart"].append(e))
        spy(eng.ckpt, "save", lambda e, s: rec["saved"].append(e))

    spy(E, "build_calibration_cache", lambda d: rec["cache"].append(d))
    spy(E, "_write_pngs", lambda dirs, i, *a: rec["written"].append(i))
    eng = E.Engine(cfg, "cpu")
    instrument(eng)
    eng.train()
    out = {"rank": topo.rank, "spe": eng.steps_per_epoch, "step": eng.state.step,
           "history": eng.history, "kept": eng.ckpt.epochs(), **rec}

    # a resume from the epoch-1 checkpoint (the CAM_PARAM stage's last) on a
    # fresh weights directory
    cfg_b = cfg.replace(paths=dataclasses.replace(cfg.paths,
                                                  root_weights=os.path.join(work, "weights_b")))
    if topo.rank == 0:
        shutil.copytree(os.path.join(eng.ckpt_dir, "1"),
                        os.path.join(cfg_b.paths.root_weights, "train", cfg.data_name, "1"))
    barrier()
    eng_b = E.Engine(cfg_b, "cpu")
    eng_b.train(resume=True)
    out["resumed"] = [h["epoch"] for h in eng_b.history]
    out["resumed_digest"] = digest(eng_b.state.p_flat)
    out["demo"] = E.Engine(cfg.replace(mode=1), "cpu").demo()
    torch.save(out, os.path.join(work, f"rank{topo.rank}.pt"))
    torch.distributed.destroy_process_group()
    print("{}")
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX Engine(data_parallel=2), the port's Engine on 2 ranks, and the
    port's 1-rank Engine with images_per_batch=2, each through 2 + 2 + 2."""
    scene_dir = str(tmp_path_factory.mktemp("scene") / "Tiny_Spheres")
    make_dataset(scene_dir, n_train=N_TRAIN, n_val=1, n_test=N_TEST, img_h=HW, img_w=HW, seed=7)
    jcfg, tcfg = _configs(scene_dir, str(tmp_path_factory.mktemp("jax")))
    # the JAX engine's schedule alone: its train loop, gates and checkpoint
    # retention as they are, the epochs, refreshes, restarts and renders
    # stubbed (no program is compiled)
    jeng = j_engine.Engine(jcfg)
    j_refresh, j_restart, j_epochs = [], [], []

    def refresh(epoch):
        j_refresh.append((epoch, jeng.occ_grid is None))
        jeng.occ_grid = epoch          # a grid now exists: the next refresh is an EMA

    jeng._run_epoch = lambda stage, data, key: j_epochs.append(stage) or dict.fromkeys(
        ("loss", "loss_intr", "loss_extr", "loss_rgb_c", "loss_rgb_f"), 0.0)
    jeng._refresh_occupancy = refresh
    jeng._maybe_restart_cameras = lambda data, epoch: j_restart.append(epoch)
    jeng._report_cameras = jeng._validate = lambda epoch: None
    jeng.train()
    jeng.ckpt.wait()
    jax_run = {"spe": jeng.steps_per_epoch, "refresh": j_refresh, "restart": j_restart,
               "stages": j_epochs,
               "kept": sorted(int(n) for n in os.listdir(jeng.ckpt_dir) if n.isdigit())}

    work = tmp_path_factory.mktemp("ranks")
    _, tcfg = _configs(scene_dir, str(work / "out"))
    torch.save(tcfg, work / "cfg.pt")
    spawn_ranks(WORLD, ["-c", _RANK, str(work)], str(work), env={"OMP_NUM_THREADS": "1"},
                timeout=300)
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]

    one = str(tmp_path_factory.mktemp("one"))
    _, cfg1 = _configs(scene_dir, one)
    eng1 = t_engine.Engine(cfg1.replace(train=dataclasses.replace(cfg1.train,
                                                                  images_per_batch=WORLD)), CPU)
    one_params = _epoch_params(eng1)
    eng1.train()
    # the 1-rank demo of the 2-rank run's latest checkpoint
    demo1 = t_engine.Engine(tcfg.replace(mode=1, paths=dataclasses.replace(
        tcfg.paths, root_out=os.path.join(one, "demo"))), CPU).demo()
    return {"jax": jax_run, "ranks": ranks, "one": eng1, "one_params": one_params,
            "demo1": demo1, "tcfg": tcfg}


def test_schedule_matches_the_jax_data_parallel_engine(runs):
    j = runs["jax"]
    assert j["spe"] == N_TRAIN * 2 // WORLD == 5
    for r in runs["ranks"]:
        assert (r["spe"], r["step"]) == (j["spe"], 6 * j["spe"])
        assert [h["stage"] for h in r["history"]] == j["stages"] == [0, 0, 1, 1, 2, 2]
        assert r["restart"] == j["restart"] == [0]
        # refreshes after 2 NeRF epochs (fresh) and 4 (EMA)
        assert [tuple(x[:2]) for x in r["refresh"]] == j["refresh"] == [(3, True), (5, False)]
        assert r["kept"] == j["kept"] == [1, 3, 4, 5]
    # rays/s counts the global batch
    h = runs["ranks"][0]["history"][2]
    assert h["rays_per_s"] == pytest.approx(5 * WORLD * 128 / h["seconds"])


def test_rank_0_alone_builds_the_cache_and_writes_checkpoints(runs):
    r0, r1 = runs["ranks"]
    assert r0["saved"] == list(range(6)) and r1["saved"] == []
    assert len(r0["cache"]) == 2 and r1["cache"] == []      # the train run and the resume


def test_trajectory_matches_one_rank_with_twice_the_images(runs):
    r0, eng1 = runs["ranks"][0], runs["one"]
    assert eng1.steps_per_epoch == r0["spe"] and len(eng1.history) == 6
    for h2, h1 in zip(r0["history"], eng1.history):
        for k in ("loss", "loss_intr", "loss_extr", "loss_rgb_c", "loss_rgb_f"):
            assert abs(h2[k] - h1[k]) <= METRIC_RTOL * abs(h1[k]), (h1["epoch"], k, h2[k], h1[k])
    for e, (got, want) in enumerate(zip(r0["p_flat"], runs["one_params"])):
        err = float((got - want).abs().max())
        assert err <= PARAM_TOL * float(want.abs().max()), (e, err)


def test_p_flat_and_the_map_are_the_same_bits_on_both_ranks(runs):
    r0, r1 = runs["ranks"]
    assert len(r0["digests"]) == 6 and r0["digests"] == r1["digests"]
    assert r0["refresh"] == r1["refresh"]


def test_a_resume_ends_on_the_same_bits(runs):
    for r in runs["ranks"]:
        assert r["resumed"] == [2, 3, 4, 5]
        assert r["resumed_digest"] == r["digests"][-1]


def test_the_demo_shards_its_views_and_scores_the_one_rank_demo(runs):
    r0, r1 = runs["ranks"]
    assert r0["demo"] == r1["demo"]
    assert sorted(r0["written"] + r1["written"]) == list(range(N_TEST))
    assert r0["written"] == [0] and r1["written"] == [1]
    out = r0["demo"]["out_dir"]
    assert sorted(os.listdir(os.path.join(out, "pred"))) == ["0000.png", "0001.png"]
    assert len([d for d in os.listdir(os.path.dirname(out))
                if d.startswith(os.path.basename(runs["tcfg"].paths.render_dir) + "_")]) == 1
    one = runs["demo1"]
    assert r0["demo"]["count"] == one["count"] == N_TEST
    for k in ("psnr", "ssim"):
        assert r0["demo"][k] == pytest.approx(one[k], rel=1e-9, abs=0), k
    assert r0["demo"]["lpips"] is one["lpips"] is None
