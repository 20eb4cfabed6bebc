"""The hash-grid field on a CUDA card: the encode's kernels
(``csrc/hashgrid.cu``) against their plain body
(``models/hashgrid.py::hash_encode_plain``) at the train cell's sizes,
planted faults read as faults; and the field through the port's normal
path: the GLOBAL_OPTIM and FINE_TUNE step graphs against their loops, the
frame graph against its loop, ``Engine`` training, checkpoint, resume and
demo, and the CLI's ``--train`` / ``--demo`` on a hashgrid YAML.

Every test is marked ``gpu`` and skips without a card.  The file imports
nothing of JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_ngp_gpu.py -q -s

``-s`` prints each case's measured errors ("measured ..." lines), from
which the tolerances were set.
"""

import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from mc_nerf_torch.config import Config, NerfConfig, StageConfig, TrainConfig
from mc_nerf_torch.data.calibration import calibration_from_numpy
from mc_nerf_torch.models import hashgrid as hg
from mc_nerf_torch.models.camera_params import FIELDS, CameraParams
from mc_nerf_torch.models.hashgrid import hash_encode, hash_encode_plain, hash_grid
from mc_nerf_torch.models.nerf import init_nerf_params
from mc_nerf_torch.ops.cuda import hashgrid as hk
from mc_nerf_torch.train.engine import refresh_occupancy
from mc_nerf_torch.train.optim import Params, build_optimizers, counter, flatten_params
from mc_nerf_torch.train.steps import TrainData, TrainState
from mc_nerf_torch.utils import trace
from portbench.scene import camera_params, cube_detections
from portbench.scene_ngp import ngp_weights

# the published grid (16 levels x 2 features, 2^19 entries a level,
# N_min 16, N_max 2048) and the box of the MC-NeRF configurations
NGP = NerfConfig(field="hashgrid", coarse_free=True, coarse_free_from_stage=1)
LO, HI = NGP.bound_min, NGP.bound_max
# the train cell's points a step: 8192 rays x 32 samples
P = 8192 * 32

# Tolerances, each with its reason (measured on an H100 with -s):
# * features: the kernel writes bf16 (the MLPs' operand type), the plain
#   body fp32: the gap is bf16's rounding of each feature, at most 2^-9 of
#   it; held as max |kernel - plain| over max |plain|, at 2^-8 (measured
#   1.96e-3, i.e. 2^-9);
# * the table's gradient: fp32 atomics in another order than the plain
#   body's scatter-add, from the same bf16 cotangent: relative L2 2e-6
#   (measured 8.0e-8 / 1.2e-7, all levels / gated);
# * d/dx: fp32 sums over the same corners in another order: relative L2
#   2e-6 (measured 1.4e-7 / 1.3e-7).
# A table in fp8 (e4m3, the control) moves the features by up to 2^-4 of
# them, and a cotangent in fp8 both gradients by ~2^-5: each fails its
# bound (measured 0.031 in the features, 0.027 in the gradients).
FEAT_TOL = 2.0 ** -8
GTABLE_TOL = 2e-6
GX_TOL = 2e-6
# a resumed run against the uninterrupted one after 400 steps: the
# atomics' order moves a table gradient entry whose contributions cancel
# by its rounding, and RAdam's normalised step turns that sign into a full
# step of the learning rate (measured 1.3e-3 relative over the flat
# state); a resume that lost the moments or the step moves it by ~1
RESUME_TOL = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, seed=0, n=P, spread=1.2):
    """Seeded points (some outside the box, some on its faces), a table at
    the scale of the benchmark's seeded field, a gate with levels off,
    ramping and on, and a loss-shaped bf16 cotangent."""
    g = torch.Generator(device=dev).manual_seed(seed)
    grid = hash_grid(NGP)
    x = (torch.rand((n, 3), generator=g, device=dev) * 2 - 1) * HI * spread
    x[:64, 0] = LO
    x[64:128, 1] = HI
    table = (torch.rand((grid.entries, 2), generator=g, device=dev) * 2 - 1)
    gate = torch.clamp(torch.linspace(1.6, -0.4, grid.levels, device=dev), 0, 1)
    gout = (torch.randn((n, grid.out_dim), generator=g, device=dev) / n).to(torch.bfloat16)
    return grid, x, table, gate, gout


def _plain(x, table, gate, grid, gout, primes=None):
    """The plain body's (features, d table, d x) for the cotangent ``gout``;
    ``primes`` plants another spatial hash."""
    saved = hg.PRIMES
    if primes is not None:
        hg.PRIMES = primes
    try:
        xg, tg = x.clone().requires_grad_(True), table.clone().requires_grad_(True)
        feat = hash_encode_plain(xg, tg, gate, grid, LO, HI)
        feat.backward(gout.float())
    finally:
        hg.PRIMES = saved
    return feat.detach(), tg.grad, xg.grad


def _gaps(feat, gtab, gx, ref):
    rel = lambda a, b: float(torch.linalg.vector_norm((a - b).double())
                             / torch.linalg.vector_norm(b.double()))
    return {"feat": float((feat.float() - ref[0]).abs().max() / ref[0].abs().max()),
            "gtable": rel(gtab, ref[1]), "gx": rel(gx, ref[2])}


def _kernel(x, table, gate, grid, gout):
    feat = hk.encode_fwd(x, table, gate, grid, LO, HI)
    gtab, gx = hk.encode_bwd(x, table, gate, grid, LO, HI, gout)
    return feat, gtab, gx


@pytest.mark.gpu
@pytest.mark.parametrize("gated", [False, True], ids=["all_levels", "gated"])
def test_kernels_match_the_plain_body(cuda, gated):
    grid, x, table, gate, gout = _inputs(cuda)
    gate = gate if gated else None
    got = _gaps(*_kernel(x, table, gate, grid, gout), _plain(x, table, gate, grid, gout))
    print(f"measured hashgrid {'gated' if gated else 'all levels'}: {got}")
    assert got["feat"] <= FEAT_TOL and got["gtable"] <= GTABLE_TOL and got["gx"] <= GX_TOL


@pytest.mark.gpu
def test_planted_faults_and_the_fp8_control_read_as_faults(cuda):
    """Each plant against the sound plain body fails one bound or more."""
    grid, x, table, gate, gout = _inputs(cuda, seed=1)
    ref = _plain(x, table, gate, grid, gout)
    fp8 = lambda t: t.to(torch.float8_e4m3fn).float()
    plants = {
        "hash primes swapped": _plain(x, table, gate, grid, gout, (1, 805459861, 2654435761)),
        "gate dropped": _plain(x, table, None, grid, gout),
        "table in fp8": _plain(x, fp8(table), gate, grid, gout),
        "cotangent in fp8": _plain(x, table, gate, grid, fp8(gout * 2 ** 20) / 2 ** 20),
        "a point's neighbour's cell": _plain(torch.roll(x, 1, 0), table, gate, grid, gout),
    }
    for name, got in plants.items():
        gaps = _gaps(*got, ref)
        over = max(gaps["feat"] / FEAT_TOL, gaps["gtable"] / GTABLE_TOL, gaps["gx"] / GX_TOL)
        print(f"measured plant {name}: {gaps}, {over:.1f}x the bounds")
        assert over > 1, name


@pytest.mark.gpu
def test_points_gradient_only_where_asked(cuda):
    """Without a points gradient the backward writes the table's alone, the
    same values; the dispatch counts the kernel route and the points."""
    grid, x, table, gate, gout = _inputs(cuda, seed=2, n=4096)
    g1, gx = hk.encode_bwd(x, table, gate, grid, LO, HI, gout, need_x=True)
    g2, none = hk.encode_bwd(x, table, gate, grid, LO, HI, gout, need_x=False)
    assert none is None and gx is not None
    assert float((g1 - g2).abs().max()) <= 1e-6 * float(g1.abs().max())
    trace.reset()
    tg = table.clone().requires_grad_(True)
    hash_encode(x, tg, gate, grid, LO, HI).float().sum().backward()
    snap = trace.snapshot()["counters"]
    assert snap["hashgrid.kernel"] == 1 and snap["hashgrid.points"] == 4096
    assert "hashgrid.plain" not in snap and tg.grad is not None


@pytest.mark.gpu
def test_refused_inputs_raise(cuda):
    grid, x, table, gate, _ = _inputs(cuda, n=256)
    with pytest.raises(ValueError):
        hk.check_args(x, table[1:], gate, grid)
    with pytest.raises(ValueError):
        hk.check_args(x, table.view(-1)[1:-1].view(-1, 2), gate, grid)   # 4-byte aligned
    with pytest.raises(ValueError):
        hk.check_args(x.double(), table, gate, grid)
    with pytest.raises(ValueError):
        hk.check_args(x, table, gate[:3], grid)


def _timed(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


@pytest.mark.gpu
def test_kernel_times_at_the_cell(cuda):
    """ms a launch of the forward and the backward at the train cell's
    2^18 points (all levels on), and of the plain body's; printed for
    PERF.md, nothing asserted but that they ran."""
    grid, x, table, _, gout = _inputs(cuda, spread=0.6)
    fwd = _timed(lambda: hk.encode_fwd(x, table, None, grid, LO, HI))
    bwd = _timed(lambda: hk.encode_bwd(x, table, None, grid, LO, HI, gout))
    plain = _timed(lambda: hash_encode_plain(x, table, None, grid, LO, HI), reps=3)
    print(f"measured hashgrid ms: fwd {fwd:.4f} bwd {bwd:.4f} plain fwd {plain:.3f} "
          f"({torch.cuda.get_device_name()})")
    assert fwd > 0 and bwd > 0


# --- the normal path on the card ----------------------------------------------------------

def _train_state(dev, n=8, side=200):
    """Cameras on an orbit and the published field, seeded as the
    benchmark's cell seeds it, flattened with one RAdam state a stage; the
    data: seeded images, every tag detected, the map refreshed from the
    field."""
    cfg = Config(stages=StageConfig(20, 16, 16), nerf=NGP,
                 train=TrainConfig(rays_per_batch=8192, importance_samples=32))
    nc = dataclasses.asdict(NGP)
    raw = camera_params(n, side, side, 4.0, 0.5, dev)
    raw.update(ngp_weights(nc, 7, dev))
    field = init_nerf_params(NGP, torch.Generator(device=dev).manual_seed(0), dev)
    with torch.no_grad():
        for name, p in field.named_parameters():
            p.copy_(raw["nerf." + name])
    params = Params(CameraParams(*(raw[f"cam.{f}"].clone() for f in FIELDS)), field)
    p_flat = flatten_params(params)
    txs, opts = build_optimizers(cfg, params, p_flat, 5500)
    det = cube_detections(3, n, side)
    valid = np.ones(det.shape[:2], bool)
    images = torch.randint(0, 256, (n, side * side, 3), dtype=torch.uint8, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    data = TrainData(images, calibration_from_numpy(det, valid, det, valid, device=dev),
                     refresh_occupancy(field, cfg, dev, 0))
    return cfg, TrainState(params, p_flat, opts, counter(197000, dev)), data, txs


@pytest.mark.gpu
@pytest.mark.parametrize("stage", [1, 2], ids=["global_optim", "fine_tune"])
def test_step_graph_against_the_loop(cuda, stage):
    """3 steps through the captured step graph and 3 through the loop from
    the same state and draws: the loss terms and the parameters' change
    agree to the atomics' reordering (relative 1e-3; measured with -s);
    the encode ran as kernels, twice a step in the loop (forward,
    backward)."""
    from mc_nerf_torch.train.steps import make_stage_epoch
    out = {}
    for graph in (True, False):
        cfg, state, data, txs = _train_state(cuda)
        p0 = state.p_flat.clone()
        epoch = make_stage_epoch(cfg, stage, txs[stage], 200, 200, 286000, 3, graph=graph)
        launched = dict(hk.launches)
        m = epoch(state, data, torch.Generator(device=cuda).manual_seed(5))
        out[graph] = ({k: float(v) for k, v in m.items()}, state.p_flat - p0)
        if not graph:
            assert hk.launches["fwd"] - launched["fwd"] == 3
            assert hk.launches["bwd"] - launched["bwd"] == 3
        assert epoch.counts["replayed" if graph else "looped"] == 3
        epoch.release()
    (mg, dg), (ml, dl) = out[True], out[False]
    loss_gap = max(abs(mg[k] - ml[k]) / max(abs(ml[k]), 1e-12) for k in ("loss", "loss_rgb_f"))
    change_gap = float(torch.linalg.vector_norm(dg - dl) / torch.linalg.vector_norm(dl))
    print(f"measured step graph vs loop, stage {stage}: loss {loss_gap:.3e}, "
          f"change {change_gap:.3e}; loss {ml['loss']:.5f}")
    assert loss_gap <= 1e-3 and change_gap <= 1e-3 and math.isfinite(ml["loss"])


@pytest.mark.gpu
def test_frame_graph_against_the_loop(cuda):
    """A 200x200 frame of the seeded field through the captured frame graph
    and through the chunk loop: the same bits (the forward has no
    atomics); a second replay with the table changed renders the change."""
    from mc_nerf_torch.train.steps import make_render_fn
    from portbench.scene import orbit_views
    cfg, state, data, _ = _train_state(cuda)
    poses, K = orbit_views(8, 200, 200)
    pose = torch.as_tensor(poses[3], dtype=torch.float32, device=cuda)
    K = torch.as_tensor(K, dtype=torch.float32, device=cuda)
    field = state.params.nerf
    graph = make_render_fn(cfg, 200, 200, device=cuda)
    loop = make_render_fn(cfg, 200, 200, device=cuda, graph=False)
    a, b = graph(field, pose, K, data.occ), loop(field, pose, K, data.occ)
    assert graph.counts["replayed"] == 1 and torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert 0.05 < float(a[0].std())
    with torch.no_grad():
        field.table.mul_(0.5)
    c = graph(field, pose, K, data.occ)[0]
    assert torch.equal(c, loop(field, pose, K, data.occ)[0]) and not torch.equal(c, a[0])
    graph.release()


_YAML = """
system:
  epoch: {{cam_param_stage: 1, global_opt_stage: 1, fine_tune_stage: 1}}
  train_params: {{batch: 4096, importance_samples: 32}}
  test_params: {{resolution_h: 64, resolution_w: 64, importance_samples: 32}}
  weights_params: {{root_weights: {out}/weights}}
  out_params: {{root_out: {out}/results}}
  log_params: {{logpath: {out}/log}}
  tensorboard_params: {{tb_pth: {out}/tb}}
model:
  nerf:
    field: hashgrid
    coarse_free: true
    coarse_free_from_stage: 1
    occ_warmup_steps: 100
"""


@pytest.mark.gpu
def test_engine_and_cli_on_the_card(cuda, tmp_path):
    """The CLI's --train (1 + 1 + 1 epochs of 200 steps, step graphs, the
    map refreshed from the field) and --demo (the frame graph) on a
    hashgrid YAML at the published widths; then the Engine resumes from
    the epoch-0 checkpoint and ends within ``RESUME_TOL`` of the
    uninterrupted run."""
    from mc_nerf_torch.data.synthetic import make_dataset
    from mc_nerf_torch.main import main
    from mc_nerf_torch.train.checkpoint import STATE_FILE
    from mc_nerf_torch.train.engine import Engine
    from mc_nerf_torch.config import load_yaml
    scene = str(tmp_path / "data" / "Tiny_Grid")
    make_dataset(scene, n_train=4, n_val=1, n_test=2, img_h=64, img_w=64, seed=3)
    out = str(tmp_path / "out")
    os.makedirs(tmp_path / "config")
    (tmp_path / "config" / "config.yaml").write_text(_YAML.format(out=out))
    args = ["--config", str(tmp_path / "config"), "--root_data", str(tmp_path / "data"),
            "--data_name", "Tiny_Grid"]
    main(["--train", *args])
    demo = main(["--demo", *args])
    print(f"measured cli demo on the card: {demo}")
    assert demo["count"] == 2 and math.isfinite(demo["psnr"])
    cfg = load_yaml(str(tmp_path / "config" / "config.yaml")).replace(
        data_root=str(tmp_path / "data"), data_name="Tiny_Grid")
    ckpt = os.path.join(out, "weights", "train", "Tiny_Grid")
    final = torch.load(os.path.join(ckpt, "2", STATE_FILE), weights_only=True)["p_flat"]
    for e in ("1", "2"):
        os.remove(os.path.join(ckpt, e, STATE_FILE))
    eng = Engine(cfg)
    resumed = eng.train(resume=True).p_flat.cpu()
    eng.close()
    gap = float(torch.linalg.vector_norm(resumed - final) / torch.linalg.vector_norm(final))
    print(f"measured resume against the uninterrupted run: {gap:.3e}")
    assert gap <= RESUME_TOL
