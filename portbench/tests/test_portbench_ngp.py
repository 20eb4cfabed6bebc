"""The hash-grid cell's pieces on the CPU: its configuration at the
published widths, its operations and bytes (``flops_ngp.py``), its
readers (``metrics/hashgrid_ms.train.py``, ``roofline_share.hashgrid``)
on a trace with and without the encode's kernels, and a run of the cell
at a small size, sound and with a fault planted."""

import json
import time

import torch

from portbench import flops_ngp
from portbench.reference import ngp as ref_ngp
from portbench.run import HERE, Run, manifest, read_metric, run_cell

CFG = json.loads((HERE / "configs" / "instant-ngp-base.json").read_text())
SMALL = {"traffic": {"scene": {"n_images": 4, "img_h": 32, "img_w": 32}, "steps_per_epoch": 2},
         "train": {"rays_per_batch": 64},
         "nerf": {"hash_levels": 4, "hash_log2_size": 10, "hash_base_res": 4,
                  "hash_max_res": 32, "occ_grid_size": 16},
         "config": {"compute_dtype": "float32"}}


def test_the_published_widths():
    nc = CFG["nerf"]
    assert ref_ngp.table_rows(nc) * ref_ngp.FEATURES == 12_197_850
    assert [lv["hashed"] for lv in ref_ngp.levels(nc)] == [False] * 5 + [True] * 11
    assert flops_ngp.mlp_macs(nc) == 9_408
    assert CFG["reduced"] == [] and CFG["train"]["rays_per_batch"] * 32 == 2 ** 18


def test_the_encode_bytes_and_model_flops():
    passes = flops_ngp.encode_passes(CFG, 8192)
    p = 2 ** 18
    assert [x["bytes"] for x in passes] == [p * (12 + 1024 + 64), p * (64 + 2048 + 24)]
    assert flops_ngp.train_step_flops(CFG, 8192) == 6 * p * 9_408
    assert abs(flops_ngp.least_time(passes) - p * 3236 / 3.35e12) < 1e-12


def _ctx(hash_s):
    return {"trace": [{"kind": "train", "units": 250, "busy_s": 1.0, "window_s": 1.1,
                       "layer_s": {"glue": 0.5, "hashgrid": hash_s},
                       "flops_per_unit": 1.0, "bound_s_per_unit": 0.0,
                       "hashgrid_bound_s_per_unit": 2.5e-4}], "world": 1}


def test_the_readers():
    assert read_metric("hashgrid_ms.train", _ctx(0.25)) == 1.0
    assert abs(read_metric("roofline_share.hashgrid", _ctx(0.25)) - 25.0) < 1e-9
    for name in ("hashgrid_ms.train", "roofline_share.hashgrid"):
        assert read_metric(name, _ctx(0.0)) is None
        assert read_metric(name, {"trace": None}) is None


def _drive(**over):
    b = Run("train.ngp", 2 ** 31 + 13, 0.1, False, torch.device("cpu"), time.time(),
            overrides=SMALL)
    return run_cell(b, manifest())


def test_a_sound_run_is_correct(cpu_threads):
    r = _drive()
    assert r["correct"] and r["attempted"] >= 2 and r["failed"] == 0


def test_an_answer_altered_where_it_is_produced(monkeypatch, cpu_threads):
    """The field's colour off by 0.1 on a quarter of its points (the port's
    module as ``program.py`` loaded it: no test here imports the port)."""
    import sys

    import portbench.program  # noqa: F401
    nerf = sys.modules["mc_nerf_torch.models.nerf"]
    shade = nerf.ngp_shade

    def altered(*a, **k):
        sigma, rgb = shade(*a, **k)
        return sigma, rgb + 0.1 * (torch.arange(rgb.shape[0])[:, None, None] % 4 == 0)
    monkeypatch.setattr(nerf, "ngp_shade", altered)
    assert not _drive()["correct"]
