"""The benchmark's CPU tests: the repository root on the path, small
sizes of the cells for the runs the tests drive on the CPU."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the cells at a size a CPU test holds: widths cut, a few small images
TINY_TRAIN = {"traffic": {"scene": {"n_images": 4, "img_h": 32, "img_w": 32},
                          "steps_per_epoch": 2},
              "train": {"rays_per_batch": 64},
              "nerf": {"coarse_width": 32, "fine_width": 32, "occ_grid_size": 16}}
TINY_FRAME = {"traffic": {"img_h": 24, "img_w": 24, "views": 8, "profile_frames": 2},
              "eval": {"rays_per_chunk": 256},
              "nerf": {"coarse_width": 32, "fine_width": 32, "occ_grid_size": 16}}


def tiny(workload: str, fp32: bool = False) -> dict:
    """The overrides of a cell at a CPU test's size; ``fp32``: the port's
    plain route in float32, which the fp32 reference follows to round-off."""
    import copy
    out = copy.deepcopy(TINY_FRAME if workload.startswith("frame") else TINY_TRAIN)
    if fp32:
        out["config"] = {"compute_dtype": "float32"}
        out.setdefault("train", {})["use_pallas"] = False
        out.setdefault("eval", {})["use_pallas"] = False
    return out


@pytest.fixture
def cpu_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
