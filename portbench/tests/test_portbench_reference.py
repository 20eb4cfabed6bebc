"""The plain reference against the port's CPU route at a tiny size: its
pieces against the port's, the train step's readings and a frame, with
the port in float32 on its plain route (the reference's precision)."""

import time

import numpy as np
import pytest
import torch

from mc_nerf_torch.models.encoding import sincos_encode
from mc_nerf_torch.models.sh import sh_basis
from mc_nerf_torch.ops import volume
from portbench.reference import nerf as R
from portbench.run import Run, manifest, run_cell
from portbench.scene import orbit_views, se3_log
from portbench.tests.conftest import tiny


def test_pieces_against_the_port():
    g = torch.Generator().manual_seed(0)
    x = torch.rand(50, 3, generator=g) * 4 - 2
    assert torch.allclose(R.encode(x, 10), sincos_encode(x, 10), atol=1e-6)
    gate = torch.rand(10, generator=g)
    assert torch.allclose(R.encode(x, 10, gate), sincos_encode(x, 10, gate), atol=1e-6)
    d = torch.nn.functional.normalize(torch.randn(50, 3, generator=g), dim=-1)
    assert torch.allclose(R.sh_basis(2, d), sh_basis(2, d), atol=1e-6)
    z = torch.sort(torch.rand(40, 48, generator=g) * 7 + 1, -1).values
    w = torch.rand(40, 48, generator=g) ** 4
    u = torch.rand(40, 32, generator=g)
    for uu in (u, None):
        assert torch.allclose(R.sample_pdf(z, w, 32, uu), volume.sample_pdf(z, w, 32, uu),
                              atol=1e-5)
    sel = torch.rand(40, 128, generator=g) ** 8
    bins, valid = R.select_bins(sel, 26, 1e-3)
    pb, pv = volume.select_fine_bins(sel, 26, 1e-3)
    assert torch.equal(valid, pv) and torch.equal(bins, pb)


def test_log_map_round_trip():
    poses, _ = orbit_views(7, 32, 32)
    back = R.se3_exp(torch.as_tensor(se3_log(poses)))
    assert np.allclose(back.numpy(), poses, atol=1e-9)


@pytest.mark.parametrize("workload", ["train.importance", "train.grid"])
def test_train_steps_follow_the_port_in_fp32(workload, cpu_threads):
    b = Run(workload, 2 ** 31 + 99, 0.1, False, torch.device("cpu"), time.time(),
            overrides=tiny(workload, fp32=True))
    r = run_cell(b, manifest())
    got = {k: v["value"] for k, v in r["checks"].items()}
    assert r["correct"], got
    assert got["loss_gap"] < 1e-4 and got["change_gap"] < 1e-3, got


def test_frame_follows_the_port_in_fp32(cpu_threads):
    b = Run("frame.importance", 2 ** 31 + 98, 0.1, False, torch.device("cpu"), time.time(),
            overrides=tiny("frame.importance", fp32=True))
    r = run_cell(b, manifest())
    assert r["correct"]
    assert r["notes"]["readings"]["rgb_max_gap"] < 1e-3
