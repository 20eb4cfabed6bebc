"""The hash-grid field (``nerf.field: hashgrid``: ``models/hashgrid.py``,
``models/ngp.py``) on the CPU, against the plain reference
``portbench/reference/ngp.py`` (float32, written from the paper's
equations and importing nothing of the port), at tiny sizes: 4 levels at
resolutions 4, 8, 16, 32 over a table of at most 2^10 rows a level (two
dense levels, two hashed), 64-wide MLPs, seeded weights.

* the level geometry (the published one too: 6,098,925 rows), the
  spatial hash in 32-bit arithmetic, the encode's features, the table's
  gradient and d/dx at dense and hashed levels, the clamp at the box's
  faces, the level gate;
* the field through ``render_rays_train`` / ``render_rays_eval``, the
  refresh's map, and one GLOBAL_OPTIM step's loss, gradients and update
  (through the benchmark's runner at a tiny size: the port's epoch object
  against the reference's step), with two faults read as faults;
* the engine: coarse-free stage-1 training refused for the MLP pair and
  not for the field; training, checkpoint, resume to the same bits and
  the demo; the CLI's ``--train`` / ``--demo`` on a hashgrid YAML;
* a step over 2 gloo ranks against one rank's step of both images;
* the tracer's counters and span.

Tolerances: the port's plain route in float32 follows the reference to
round-off, 1e-5 relative unless a case says otherwise (the sums run in
other orders: the corners, the scatter-add, the MLP products).
"""

import dataclasses
import os
import shutil
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from mc_nerf_torch.config import (
    Config,
    EvalConfig,
    NerfConfig,
    PathsConfig,
    StageConfig,
    TrainConfig,
    load_yaml,
)
from mc_nerf_torch.data.synthetic import make_dataset
from mc_nerf_torch.models import hashgrid as hg
from mc_nerf_torch.models.hashgrid import (
    hash_encode,
    hash_encode_plain,
    hash_grid,
    level_gate,
    level_resolutions,
)
from mc_nerf_torch.models.nerf import draw_render, init_nerf_params, render_rays_eval, \
    render_rays_train
from mc_nerf_torch.models.ngp import NgpField
from mc_nerf_torch.ops.occupancy import uniform_prior_map
from mc_nerf_torch.ops.volume import composite, trunc_exp
from mc_nerf_torch.train import engine as t_engine
from mc_nerf_torch.utils import trace
from portbench.reference import nerf as RN
from portbench.reference import ngp as R

CPU = torch.device("cpu")
TINY = dict(field="hashgrid", hash_levels=4, hash_log2_size=10, hash_base_res=4,
            hash_max_res=32, coarse_free=True, coarse_free_from_stage=1, occ_grid_size=16)
NC = NerfConfig(**TINY)
GRIDS = {"tiny": TINY,
         "dense_only": dict(TINY, hash_log2_size=16),
         "one_level": dict(TINY, hash_levels=1, hash_base_res=8, hash_max_res=8)}
LO, HI = NC.bound_min, NC.bound_max
RTOL = 1e-5


def _nc_dict(nc: NerfConfig) -> dict:
    return dataclasses.asdict(nc)


def _rel(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _field(nc=NC, seed=0) -> NgpField:
    """A field at a scale where every level moves the output: the table
    U(+-1), the MLPs He-scaled."""
    f = init_nerf_params(nc, torch.Generator().manual_seed(seed), CPU)
    with torch.no_grad():
        f.table.mul_(1e4)
        for name, p in f.named_parameters():
            if name != "table":
                p.mul_(6 ** 0.5)
    return f


def _ref_params(field: NgpField) -> dict:
    return {"nerf." + k: v.detach().clone() for k, v in field.named_parameters()}


def _points(n=512, seed=0, spread=1.2):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((n, 3), generator=g) * 2 - 1) * HI * spread


def _rays(n=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=-1)
    return d, -3.0 * d + 0.3 * torch.randn((n, 3), generator=g)


# --- the geometry --------------------------------------------------------------------

def test_the_published_geometry():
    grid = hash_grid(NerfConfig())
    assert grid.res == (16, 22, 30, 42, 58, 80, 111, 153, 212, 294, 406, 561, 776, 1072, 1482,
                        2048)
    assert grid.hashed == (False,) * 5 + (True,) * 11
    assert grid.entries == 6_098_925 and grid.entries * grid.features == 12_197_850
    assert grid.sizes[:5] == (17 ** 3, 23 ** 3, 31 ** 3, 43 ** 3, 59 ** 3)
    assert level_resolutions(16, 16, 2048)[-1] == 2048


@pytest.mark.parametrize("name", sorted(GRIDS) + ["published"])
def test_geometry_matches_the_reference(name):
    nc = NerfConfig(**GRIDS[name]) if name in GRIDS else NerfConfig()
    grid = hash_grid(nc)
    ref = R.levels(_nc_dict(nc))
    assert list(grid.res) == [lv["res"] for lv in ref]
    assert list(grid.offsets) == [lv["offset"] for lv in ref]
    assert list(grid.hashed) == [lv["hashed"] for lv in ref]
    assert grid.entries == R.table_rows(_nc_dict(nc))


def test_the_hash_is_32_bit_arithmetic():
    rng = np.random.default_rng(0)
    c = rng.integers(0, 2049, size=(1000, 3))
    want = ((c[:, 0].astype(np.uint32) * np.uint32(1))
            ^ (c[:, 1].astype(np.uint32) * np.uint32(2654435761))
            ^ (c[:, 2].astype(np.uint32) * np.uint32(805459861))) & np.uint32(1023)
    grid = hash_grid(NC)
    got = hg.corner_index(grid, 3, torch.as_tensor(c)) - grid.offsets[3]
    assert np.array_equal(got.numpy(), want.astype(np.int64))


# --- the encode ----------------------------------------------------------------------

@pytest.mark.parametrize("gated", [False, True], ids=["all_levels", "gated"])
@pytest.mark.parametrize("name", ["tiny", "dense_only"])
def test_features_match_the_reference(name, gated):
    nc = NerfConfig(**GRIDS[name])
    grid, x = hash_grid(nc), _points()
    table = torch.rand((grid.entries, 2), generator=torch.Generator().manual_seed(1)) * 2 - 1
    gate = torch.tensor([1.0, 0.7, 0.2, 0.0])[:grid.levels] if gated else None
    got = hash_encode_plain(x, table, gate, grid, LO, HI)
    want = R.encode(x, table, _nc_dict(nc), gate)
    assert got.shape == (512, 2 * grid.levels)
    assert _rel(got, want) < RTOL


@pytest.mark.parametrize("wrt", ["table", "points"])
@pytest.mark.parametrize("name", ["tiny", "dense_only"])
def test_gradients_match_the_reference(name, wrt):
    nc = NerfConfig(**GRIDS[name])
    grid, x = hash_grid(nc), _points(seed=2)
    table = torch.rand((grid.entries, 2), generator=torch.Generator().manual_seed(3)) * 2 - 1
    gate = torch.tensor([1.0, 0.9, 0.5, 0.3])
    cot = torch.randn((512, 2 * grid.levels), generator=torch.Generator().manual_seed(4))
    grads = []
    for enc in (lambda x, t: hash_encode_plain(x, t, gate, grid, LO, HI),
                lambda x, t: R.encode(x, t, _nc_dict(nc), gate)):
        xg, tg = x.clone().requires_grad_(True), table.clone().requires_grad_(True)
        (enc(xg, tg) * cot).sum().backward()
        grads.append(tg.grad if wrt == "table" else xg.grad)
    assert float(grads[1].abs().max()) > 0
    assert _rel(*grads) < RTOL


@pytest.mark.parametrize("face", ["lower", "upper"])
def test_the_clamp_at_the_box_faces(face):
    """A point beyond a face reads the face's features (the upper face: the
    last cell's far corner) and passes no gradient along that axis; on the
    face it does."""
    grid = hash_grid(NC)
    table = torch.rand((grid.entries, 2), generator=torch.Generator().manual_seed(5)) * 2 - 1
    x = _points(64, seed=6, spread=0.5)
    edge = LO if face == "lower" else HI
    on, beyond = x.clone(), x.clone()
    on[:, 0], beyond[:, 0] = edge, edge + (-0.7 if face == "lower" else 0.7)
    f_on = hash_encode_plain(on, table, None, grid, LO, HI)
    assert torch.equal(f_on, hash_encode_plain(beyond, table, None, grid, LO, HI))
    assert torch.allclose(f_on, R.encode(on, table, _nc_dict(NC)), rtol=1e-5, atol=1e-6)
    xg = beyond.clone().requires_grad_(True)
    hash_encode_plain(xg, table, None, grid, LO, HI).sum().backward()
    assert float(xg.grad[:, 0].abs().max()) == 0.0 and float(xg.grad[:, 1:].abs().max()) > 0


def test_the_level_gate():
    """Level l ramps as BARF's octave l does (n = L), 0 before its turn."""
    nc = NerfConfig(field="hashgrid")
    gate = level_gate(nc, torch.tensor(0.5), (0.3846, 0.6923))
    assert gate.shape == (16,) and torch.all(gate[:-1] >= gate[1:])
    assert float(gate[0]) == 1.0 and float(gate[-1]) == 0.0
    assert torch.allclose(gate, RN.barf_weights(16, torch.tensor(0.5), 0.3846, 0.6923))
    late = level_gate(nc, torch.tensor(197000 / 286000), (20 / 52, 36 / 52))
    assert float(late.min()) > 0.9


def test_a_gated_level_reads_and_trains_nothing():
    grid, x = hash_grid(NC), _points(seed=7)
    table = (torch.rand((grid.entries, 2)) * 2 - 1).requires_grad_(True)
    gate = torch.tensor([1.0, 1.0, 0.0, 1.0])
    f = hash_encode_plain(x, table, gate, grid, LO, HI)
    assert float(f.detach()[:, 4:6].abs().max()) == 0.0
    f.sum().backward()
    rows = slice(grid.offsets[2], grid.offsets[2] + grid.sizes[2])
    assert float(table.grad[rows].abs().max()) == 0.0
    assert float(table.grad[:grid.offsets[2]].abs().max()) > 0


def test_trunc_exp():
    h = torch.tensor([-2.0, 0.0, 14.0, 20.0], requires_grad=True)
    y = trunc_exp(h)
    assert torch.equal(y, torch.exp(h.detach()))
    y.sum().backward()
    assert torch.allclose(h.grad, torch.exp(torch.clamp(h.detach(), max=15.0)))


def test_the_exp_composite_matches_the_reference():
    g = torch.Generator().manual_seed(8)
    z = torch.sort(torch.rand((32, 16), generator=g) * 7 + 1, -1).values
    h0, rgb = torch.randn((32, 16), generator=g), torch.rand((32, 16, 3), generator=g)
    got = composite(z, h0, rgb, density="exp")
    want = R.composite(z, h0, rgb)
    assert _rel(got.rgb, want[0]) < RTOL and _rel(got.depth[:, 0], want[1]) < RTOL
    with pytest.raises(ValueError):
        composite(z, h0, rgb, noise=torch.zeros_like(z), density="exp")


# --- the renders ---------------------------------------------------------------------

@pytest.mark.parametrize("barf_on", [True, False], ids=["gated", "all_levels"])
def test_the_train_render_matches_the_reference(barf_on):
    field, (d, o) = _field(), _rays()
    occ = uniform_prior_map(NC, CPU)
    draws = draw_render(64, NC, 16, True, torch.Generator().manual_seed(9), coarse_free=True)
    window = (0.3, 0.7)
    step_r = torch.tensor(0.6)
    rgb_c, rgb = render_rays_train(field, d, o, draws, step_r, NC, window, barf_on,
                                   torch.float32, "importance", 16, True, occ, coarse_free=True)
    assert rgb_c is None
    p = _ref_params(field)
    nc = _nc_dict(NC)
    z = R.samples(occ.float(), o, d, nc, 16, draws.pdf_u, draws.mix_u)
    gate = R.level_gate(nc, step_r, window) if barf_on else None
    want = R.composite(z, *R.field(p, o[:, None] + d[:, None] * z[..., None], d, nc, gate,
                                   "fp32"))[0]
    assert _rel(rgb, want) < RTOL
    assert float(want.std()) > 0.02          # the seeded field varies from ray to ray


def test_the_eval_render_matches_the_reference():
    field, (d, o) = _field(seed=1), _rays(seed=1)
    occ = uniform_prior_map(NC, CPU)
    rgb, depth, opacity = render_rays_eval(field, d, o, NC, torch.float32, "importance", 16,
                                           None, occ, True)
    nc = _nc_dict(NC)
    z = R.samples(occ.float(), o, d, nc, 16)
    want = R.composite(z, *R.field(_ref_params(field), o[:, None] + d[:, None] * z[..., None],
                                   d, nc, None, "fp32"))
    assert _rel(rgb, want[0]) < RTOL and _rel(depth[:, 0], want[1]) < RTOL
    assert _rel(opacity[:, 0], want[2]) < RTOL
    with pytest.raises(ValueError):
        render_rays_eval(field, d, o, NC, torch.float32, "importance", 16, None, occ, False)


def test_the_refreshed_map_matches_the_reference():
    field = _field(seed=2)
    cfg = Config(nerf=dataclasses.replace(NC, occ_dilate=False), compute_dtype="float32")
    density = t_engine.refresh_grid(field, cfg, CPU, 3).density
    # the threshold at the lattice's median density, so that it splits it
    step = (cfg.nerf.far - cfg.nerf.near) / cfg.nerf.occ_coarse_samples
    cfg = cfg.replace(nerf=dataclasses.replace(
        cfg.nerf, occ_thresh=float(density.median()) * step * 1.0001))
    got = t_engine.refresh_occupancy(field, cfg, CPU, 3)
    jitter = t_engine.refresh_jitter(cfg, 3, CPU)
    want = R.occupancy_map(_ref_params(field), _nc_dict(cfg.nerf), jitter)
    assert 0.1 < float(want.mean()) < 0.9       # the threshold splits the lattice
    assert torch.equal(got.float(), want)


# --- one GLOBAL_OPTIM step through the benchmark's runner ----------------------------

TINY_RUN = {"traffic": {"scene": {"n_images": 4, "img_h": 32, "img_w": 32},
                        "steps_per_epoch": 2},
            "train": {"rays_per_batch": 64},
            "nerf": {"hash_levels": 4, "hash_log2_size": 10, "hash_base_res": 4,
                     "hash_max_res": 32, "occ_grid_size": 16},
            "config": {"compute_dtype": "float32"}}


def _drive():
    from portbench.run import Run, manifest, run_cell
    b = Run("train.ngp", 2 ** 31 + 11, 0.1, False, CPU, time.time(), overrides=TINY_RUN)
    return run_cell(b, manifest())


def test_one_step_matches_the_reference(cpu_threads):
    """The port's epoch object (loop route, fp32 plain) against the
    reference's steps: the loss terms, the first gradient and the change
    over 3 steps, every leaf, to round-off (and so ``correct``)."""
    r = _drive()
    got = r["notes"]["readings"]
    assert r["correct"], r["checks"]
    assert got["loss_gap"] < 1e-5 and got["grad_gap"] < 1e-3 and got["change_gap"] < 1e-3


def test_a_step_that_returns_its_state_unchanged_is_caught(monkeypatch, cpu_threads):
    from mc_nerf_torch.train.optim import FlatRAdam
    monkeypatch.setattr(FlatRAdam, "update", lambda self, g, state, p: state)
    r = _drive()
    assert not r["correct"] and r["checks"]["change_gap"]["value"] > 0.5


def test_half_the_batch_left_out_is_caught(monkeypatch, cpu_threads):
    import mc_nerf_torch.train.steps as steps
    monkeypatch.setattr(steps, "rgb_loss",
                        lambda pred, gt: torch.mean((pred[: len(pred) // 2]
                                                     - gt[: len(gt) // 2]) ** 2))
    assert not _drive()["correct"]


@pytest.fixture
def cpu_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --- the engine and the CLI ------------------------------------------------------------

N_TRAIN, HW = 4, 24


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("scene") / "Tiny_Grid")
    make_dataset(d, n_train=N_TRAIN, n_val=1, n_test=1, img_h=HW, img_w=HW, seed=5)
    return d


def _cfg(scene_dir, out, stages=(1, 1, 1), **nerf) -> Config:
    root, name = os.path.split(scene_dir)
    return Config(data_root=root, data_name=name, compute_dtype="float32",
                  stages=StageConfig(*stages),
                  train=TrainConfig(rays_per_batch=64, steps_per_image_epoch=2,
                                    importance_samples=8, ckpt_max_keep=0),
                  nerf=dataclasses.replace(NC, occ_warmup_steps=4, **nerf),
                  eval=EvalConfig(res_h=HW, res_w=HW, rays_per_chunk=256, importance_samples=8),
                  paths=PathsConfig(root_weights=os.path.join(out, "w"),
                                    root_out=os.path.join(out, "r"),
                                    log_path=os.path.join(out, "log"),
                                    tb_path=os.path.join(out, "tb")))


@pytest.mark.parametrize("field,coarse_free,levels,refused", [
    ("mlp", True, 16, True), ("hashgrid", True, 16, False), ("hashgrid", False, 16, True),
    ("hashgrid", True, 12, True), ("hashgrid", True, 1, False)],
    ids=["pair_coarse_free_refused", "field_allowed", "field_two_pass_refused",
         "levels_not_dividing_32_refused", "one_level_allowed"])
def test_the_engine_check_of_stage_1_coarse_free(field, coarse_free, levels, refused):
    nc = dataclasses.replace(NerfConfig(), field=field, coarse_free=coarse_free,
                             coarse_free_from_stage=1, hash_levels=levels)
    cfg = Config(nerf=nc)
    if refused:
        with pytest.raises(ValueError):
            t_engine.check_sampling_modes(cfg)
    else:
        t_engine.check_sampling_modes(cfg)


def test_engine_trains_checkpoints_resumes_and_demos(scene_dir, tmp_path):
    """1 + 1 + 1 epochs (8 steps each) on the tiny scene: the map refreshed
    from the field, every epoch checkpointed; a resume from epoch 0 ends on
    the same bits; the demo scores the test view."""
    cfg = _cfg(scene_dir, str(tmp_path))
    eng = t_engine.Engine(cfg, device=CPU)
    state = eng.train()
    final = state.p_flat.clone()
    assert eng.occ_grid is not None and eng.ckpt.epochs() == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in eng.history)
    eng2 = t_engine.Engine(cfg, device=CPU)
    for e in eng2.ckpt.epochs()[1:]:
        shutil.rmtree(os.path.join(eng2.ckpt.dir, str(e)))
    assert torch.equal(eng2.train(resume=True).p_flat, final)
    demo = t_engine.Engine(cfg.replace(mode=1), device=CPU).demo()
    assert demo["count"] == 1 and np.isfinite(demo["psnr"])


def test_the_cli_trains_and_demos_a_hashgrid_yaml(scene_dir, tmp_path):
    from mc_nerf_torch.main import main
    out = str(tmp_path / "out")
    os.makedirs(tmp_path / "config")
    (tmp_path / "config" / "config.yaml").write_text(f"""
system:
  epoch: {{cam_param_stage: 1, global_opt_stage: 1, fine_tune_stage: 1}}
  train_params: {{batch: 64, importance_samples: 8}}
  test_params: {{resolution_h: {HW}, resolution_w: {HW}, importance_samples: 8}}
  weights_params: {{root_weights: {out}/weights}}
  out_params: {{root_out: {out}/results}}
  log_params: {{logpath: {out}/log}}
  tensorboard_params: {{tb_pth: {out}/tb}}
model:
  nerf:
    field: hashgrid
    hash_levels: 4
    hash_log2_size: 10
    hash_base_res: 4
    hash_max_res: 32
    ngp_width: 16
    coarse_free: true
    coarse_free_from_stage: 1
    occ_grid_size: 16
    occ_warmup_steps: 4
""")
    root, name = os.path.split(scene_dir)
    args = ["--config", str(tmp_path / "config"), "--root_data", root, "--data_name", name]
    cfg = load_yaml(str(tmp_path / "config" / "config.yaml"))
    assert cfg.nerf.field == "hashgrid" and cfg.nerf.ngp_width == 16
    main(["--train", *args], device="cpu")
    result = main(["--demo", *args], device="cpu")
    assert result["count"] == 1 and np.isfinite(result["psnr"])


# --- two gloo ranks ----------------------------------------------------------------------

def _step_state(world: int, rank: int):
    """Tiny cameras and field, and the epoch object of 2 GLOBAL_OPTIM steps
    over ``world`` ranks (one image a rank; 2 images with one rank)."""
    from mc_nerf_torch.data.calibration import calibration_from_numpy
    from mc_nerf_torch.models.camera_params import init_camera_params
    from mc_nerf_torch.train.optim import Params, build_optimizers, counter, flatten_params
    from mc_nerf_torch.train.steps import TrainData, TrainState, make_stage_epoch
    cfg = Config(stages=StageConfig(1, 1, 1), nerf=NC, compute_dtype="float32",
                 train=TrainConfig(rays_per_batch=32, importance_samples=8,
                                   images_per_batch=1 if world > 1 else 2))
    n, hw = 4, 16
    params = Params(init_camera_params(n, CPU), _field(seed=4))
    p_flat = flatten_params(params)
    txs, opts = build_optimizers(cfg, params, p_flat, 4)
    rng = np.random.default_rng(0)
    pts = rng.uniform(2, 14, size=(n, 6, 5, 2)).astype(np.float32)
    valid = np.ones((n, 6), bool)
    data = TrainData(torch.as_tensor(rng.integers(0, 256, (n, hw * hw, 3), dtype=np.uint8)),
                     calibration_from_numpy(pts, valid, pts, valid, device=CPU),
                     uniform_prior_map(NC, CPU))
    state = TrainState(params, p_flat, opts, counter(10, CPU))
    epoch = make_stage_epoch(cfg, 1, txs[1], hw, hw, 40, 2, world=world)
    epoch(state, data, torch.Generator().manual_seed(3))
    return state.p_flat


def _rank(r, port, out):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=r, world_size=2)
    try:
        out.put((r, _step_state(2, r).numpy()))
    finally:
        dist.destroy_process_group()


def test_two_gloo_ranks_take_one_ranks_step():
    """2 gloo ranks, one image each, the flat gradient all-reduced: both end
    on the same bits, and on a 1-rank run of both images to round-off."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, port, out)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = dict(out.get(timeout=240) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert np.array_equal(got[0], got[1])
    one = _step_state(1, 0).numpy()
    assert np.abs(got[0] - one).max() <= 1e-5 * np.abs(one).max()


# --- the tracer ------------------------------------------------------------------------

def test_the_counters_and_the_span():
    trace.reset()
    field, (d, o) = _field(), _rays(16)
    x = _points(100)
    hash_encode(x, field.table, None, hash_grid(NC), LO, HI)
    render_rays_eval(field, d, o, NC, torch.float32, "importance", 8, None,
                     uniform_prior_map(NC, CPU), True)
    snap = trace.snapshot()
    assert snap["counters"]["hashgrid.plain"] == 2
    assert snap["counters"]["hashgrid.points"] == 100 + 16 * 8
    assert "hashgrid.kernel" not in snap["counters"]
    assert snap["spans"]["ngp.field"]["count"] == 1
    assert snap["spans"]["ngp.field"]["units"] == 16 * 8
