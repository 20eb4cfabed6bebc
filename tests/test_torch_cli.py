"""The port's CLI (``python -m mc_nerf_torch``, ``mc_nerf_torch.main.main``)
and the pieces it brings, against the JAX package, on the CPU.

* ``make_dataset(calibration_mode="rendered")``: for one seed, every PNG
  decodes to the JAX package's pixels, the JSONs and the detection caches
  are equal (exact);
* the CLI builds the detection cache of a scene that ships none;
* ``--train`` then ``--demo`` on the verify recipe's tiny scene and yaml
  writes the same tree of checkpoint epochs, render files and pose plots
  as the JAX ``main.py`` run;
* ``--demo`` of a JAX-trained checkpoint, converted to the port's
  ``state.pt``, scores the JAX ``--demo``'s PSNR and SSIM to rtol 1e-3
  (the engine test's bound; both sides render in bf16 on their plain
  routes; measured 1.1e-4 on the PSNR, 9.0e-5 on the SSIM);
* no fallback: without a device and without CUDA ``main`` raises, and a
  launcher's ``WORLD_SIZE`` > 1 is refused;
* the pose plot's wireframes equal the JAX package's to 1e-6, and its PNG
  holds both colours.
"""

import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from mc_nerf_tpu import config as j_config
from mc_nerf_tpu.data.synthetic import make_dataset as j_make_dataset
from mc_nerf_tpu.train import engine as j_engine
from mc_nerf_tpu.utils import visualization as j_vis

from mc_nerf_torch import main as t_main
from mc_nerf_torch import config as t_config
from mc_nerf_torch.data.calibration import CACHE_NAME
from mc_nerf_torch.data.synthetic import make_dataset
from mc_nerf_torch.train.checkpoint import Checkpointer
from mc_nerf_torch.train.steps import train_state_from_numpy
from mc_nerf_torch.utils import visualization as t_vis

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"
SCENE = "Tiny_Spheres"


@pytest.fixture(scope="module")
def j_detect():
    """The JAX binding, once its library loads: retried for up to 30 s
    while a concurrent first build settles."""
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


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


def test_rendered_make_dataset_writes_the_jax_files(tmp_path, j_detect):
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(n_train=3, n_val=1, n_test=1, img_h=96, img_w=96, seed=2,
              calibration_mode="rendered")
    j_make_dataset(a, **kw)
    make_dataset(b, **kw)
    names = _files(a)
    assert names == _files(b)
    assert {"calib/r_2.png", "coord/r_0.png", CACHE_NAME} <= set(names)
    for n in names:
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        if n.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(pb)), np.asarray(Image.open(pa)))
        elif n.endswith(".json"):
            assert json.load(open(pb)) == json.load(open(pa))
        else:
            ja, ta = np.load(pa), np.load(pb)
            assert set(ja) == set(ta)
            for k in ja:
                np.testing.assert_array_equal(ta[k], ja[k])
    cache = np.load(os.path.join(b, CACHE_NAME))
    assert cache["calib_valid"].sum(1).min() >= 2 and cache["coord_valid"].sum(1).min() >= 1


def _yaml(out):
    """The verify recipe's tiny yaml with its outputs under ``out``."""
    text = (ROOT / ".claude" / "skills" / "verify" / "SKILL.md").read_text()
    return text.split("```yaml")[1].split("```")[0].replace("/tmp/vrun/out", str(out))


def _args(root, mode):
    return [mode, "--config", str(root / "config"), "--root_data", str(root / "data"),
            "--data_name", SCENE]


def _setup(root, scene_src, out):
    shutil.copytree(scene_src, root / "data" / SCENE)
    (root / "config").mkdir(parents=True)
    (root / "config" / "config.yaml").write_text(_yaml(out))


def test_the_cli_builds_a_missing_detection_cache(tmp_path, j_detect):
    src = tmp_path / "src"
    make_dataset(str(src), n_train=3, n_val=1, n_test=1, img_h=96, img_w=96, seed=2,
                 calibration_mode="rendered")
    want = dict(np.load(src / CACHE_NAME))
    os.remove(src / CACHE_NAME)
    root = tmp_path / "run"
    _setup(root, src, root / "out")
    text = (root / "config" / "config.yaml").read_text().replace(
        "global_opt_stage: 1, fine_tune_stage: 1", "global_opt_stage: 0, fine_tune_stage: 0")
    (root / "config" / "config.yaml").write_text(text)
    state = t_main.main(_args(root, "--train"), device=CPU)
    got = np.load(root / "data" / SCENE / CACHE_NAME)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert state.step == 3 * 50


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The verify recipe's drive, ``--train`` then ``--demo``, through the
    JAX ``main.py`` and through the port's ``main``, each in its own tree;
    then the port's ``--demo`` of the JAX run's last checkpoint."""
    base = tmp_path_factory.mktemp("cli")
    src = base / "scene"
    make_dataset(str(src), n_train=4, n_val=1, n_test=1, img_h=24, img_w=24, seed=3)
    roots = {side: base / side for side in ("jax", "port", "served")}
    for side, root in roots.items():
        _setup(root, src, root / "out")

    spec = importlib.util.spec_from_file_location("jax_main", ROOT / "main.py")
    j_main = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(j_main)
    j_demos = []
    demo = j_engine.Engine.demo
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_engine.Engine, "demo", lambda self, *a: j_demos.append(demo(self, *a))
                   or j_demos[-1])
        for mode in ("--train", "--demo"):
            mp.setattr(sys, "argv", ["main.py", *_args(roots["jax"], mode)])
            j_main.main()

    t_state = t_main.main(_args(roots["port"], "--train"), device=CPU)
    t_demo = t_main.main(_args(roots["port"], "--demo"), device=CPU)

    # the JAX run's last checkpoint, restored with its Checkpointer and
    # written as the port's state.pt, then served by the port's --demo
    j_cfg = j_config.from_args(j_config.build_argparser().parse_args(
        _args(roots["jax"], "--demo")))
    jeng = j_engine.Engine(j_cfg)
    j_state, epoch = jeng.ckpt.restore(jeng.state, None)
    t_cfg = t_config.from_args(t_config.build_argparser().parse_args(
        _args(roots["served"], "--demo")))
    state = train_state_from_numpy(
        *jax.tree.map(np.asarray, (j_state.params, j_state.opt_states)), int(j_state.step),
        t_cfg, CPU)
    Checkpointer(os.path.join(t_cfg.paths.root_weights, "train", SCENE)).save(epoch, state)
    served = t_main.main(_args(roots["served"], "--demo"), device=CPU)
    return dict(roots=roots, j_demo=j_demos[0], t_demo=t_demo, t_state=t_state,
                served=served, epoch=epoch)


def _tree(out):
    """The run's checkpoint epochs, the files of its render directory and
    of its demo directory (time stamp dropped)."""
    weights = out / "weights" / "train" / SCENE
    results = out / "results"
    demo_dirs = [d for d in os.listdir(results) if d.startswith("img_rendered_")]
    assert len(demo_dirs) == 1
    return (sorted(os.listdir(weights)), _files(results / "img_rendered"),
            _files(results / demo_dirs[0]))


def test_cli_writes_the_jax_tree(cli_runs):
    roots = cli_runs["roots"]
    j_tree, t_tree = _tree(roots["jax"] / "out"), _tree(roots["port"] / "out")
    assert t_tree == j_tree
    epochs, renders, demo = t_tree
    assert epochs == ["0", "1", "2"]
    assert {f"{SCENE}/cam_pose/epoch_{e}.png" for e in range(3)} <= set(renders)
    assert {f"{SCENE}/epoch_2.png", f"{SCENE}/epoch_2_gt.png"} <= set(renders)
    assert demo == ["depth/0000depth.png", "gt/0000gt.png", "pred/0000.png"]
    assert cli_runs["t_state"].step == 3 * 200
    t_demo = cli_runs["t_demo"]
    assert t_demo["count"] == 1 and np.isfinite(t_demo["psnr"]) and np.isfinite(t_demo["ssim"])


def test_demo_of_a_jax_checkpoint_scores_the_jax_demo(cli_runs):
    j, t = cli_runs["j_demo"], cli_runs["served"]
    assert cli_runs["epoch"] == 2 and t["count"] == j["count"] == 1
    for k in ("psnr", "ssim"):
        assert abs(t[k] - j[k]) <= 1e-3 * abs(j[k]), (k, t[k], j[k])


def test_main_without_a_device_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_main.main(["--train", "--config", str(tmp_path), "--root_data", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_main.main(["--demo", "--start_device", "1", "--config", str(tmp_path)])


def test_a_launcher_world_size_without_a_rendezvous_raises(tmp_path, monkeypatch):
    """WORLD_SIZE=2 with no reachable rendezvous (torchrun's MASTER_ADDR
    unset) raises from initialize_distributed: the run never goes on as a
    single process."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(RuntimeError, match="refusing to go on as 2 independent") as err:
        t_main.main(["--train", "--config", str(tmp_path)], device=CPU)
    assert err.traceback[-1].name == "initialize_distributed"
    assert not torch.distributed.is_initialized()


def test_the_module_entry_prints_the_flags():
    proc = subprocess.run([sys.executable, "-m", "mc_nerf_torch", "--help"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for flag in ("--train", "--demo", "--config", "--root_data", "--data_name", "--log",
                 "--start_device", "--tensorboard"):
        assert flag in proc.stdout


def _poses(rng, n):
    out = []
    for _ in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        out.append(np.concatenate([q, rng.uniform(-3, 3, (3, 1))], 1))
    return np.stack(out)


def test_frustum_points_equal_the_jax_ones(rng):
    for pose in _poses(rng, 6):
        K = np.diag([rng.uniform(20, 80), rng.uniform(20, 80), 1.0])
        got, want = t_vis._frustum_points(pose, K, 64, 0.3), j_vis._frustum_points(pose, K, 64, 0.3)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_pose_plot_holds_both_colours(tmp_path, rng):
    K = np.tile(np.diag([40.0, 40.0, 1.0]), (5, 1, 1))
    path = str(tmp_path / "cam_pose" / "epoch_0.png")
    t_vis.save_pose_plot(path, _poses(rng, 5), _poses(rng, 5), K, K, 64)
    img = np.asarray(Image.open(path).convert("RGB"))
    assert img.shape == (600, 600, 3)
    colours = {tuple(c) for c in img.reshape(-1, 3)}
    for c in (t_vis.POSE_GT_COLOR, t_vis.POSE_EST_COLOR):
        assert tuple(int(round(255 * v)) for v in c) in colours
