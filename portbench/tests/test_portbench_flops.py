"""The benchmark's operation counts against the worked numbers."""

import json
import os

import pytest

from portbench import flops

CFG = os.path.join(os.path.dirname(__file__), "..", "configs")


def config(name):
    with open(os.path.join(CFG, f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("which, sigma_only, macs", [
    ("coarse", True, 81_792), ("coarse", False, 101_632), ("fine", False, 629_248)])
def test_macs_a_point_from_the_published_widths(which, sigma_only, macs):
    assert flops.mlp_macs(config("mcnerf-importance")["nerf"], which, sigma_only) == macs


@pytest.mark.parametrize("name, culled, worked", [
    ("mcnerf-importance", True, 1.0506e12),     # 7000 x (48 x 101,632 + 32 x 629,248) x 6
    ("mcnerf-grid", False, 3.9821e12)])         # 7000 x (128 x 101,632 + 130 x 629,248) x 6
def test_train_step_flops(name, culled, worked):
    got = flops.train_step_flops(config(name), 7000, culled)
    assert got == pytest.approx(worked, rel=1e-4)


def test_frame_flops_count_no_padding():
    # 640,000 x (48 x 81,792 + 32 x 629,248) x 2; the 655,360 padded rays do not count
    got = flops.frame_flops(config("mcnerf-importance"), 800 * 800, True)
    assert got == pytest.approx(3.0799e13, rel=1e-4)


@pytest.mark.parametrize("name", ["mcnerf-importance", "mcnerf-grid"])
def test_kernel_passes_bound_the_step_by_compute(name):
    cfg = config(name)
    passes = flops.train_kernel_passes(cfg, 7000, name.endswith("importance"))
    assert len(passes) == 4
    # forward + backward of both passes: the model's FLOPs, plus the shading's
    mlp = sum(p["mlp_flops"] for p in passes)
    assert mlp == pytest.approx(flops.train_step_flops(cfg, 7000, name.endswith("importance")))
    t = flops.least_time(passes)
    assert mlp / flops.PEAK_BF16 < t < 1.01 * mlp / flops.PEAK_BF16 + 1e-5


def test_frame_passes_least_time():
    cfg = config("mcnerf-importance")
    passes = flops.frame_kernel_passes(cfg, 640_000, True)
    assert [p["name"] for p in passes] == ["K1 coarse", "K2 fine"]
    assert flops.least_time(passes) == pytest.approx(3.0799e13 / 989e12, rel=2e-3)


def test_a_memory_bound_pass_is_timed_by_its_bytes():
    p = {"name": "copy", "mlp_flops": 0.0, "sh_flops": 0.0, "bytes": 3.35e9}
    assert flops.least_time([p]) == pytest.approx(1e-3)
