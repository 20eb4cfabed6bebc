"""On the card: the readings the limits of ``correct`` were set from, on
three seeds at each one-card cell's own size.  The program's timed path
reads within every limit; the reference in fp8 (the control) and, in a
train cell, the reference with half the batch left out of its mean each
fail one limit or more.  Needs a CUDA card:
``python3 -m pytest -m gpu portbench/tests/test_portbench_control.py``."""

import json

import pytest

from portbench.run import HERE

SEEDS = (2147490001, 2147490002, 2147490003)


def limits(workload):
    return json.loads((HERE / "workloads" / f"{workload}.json").read_text())["limits"]


def fails(reading, lim):
    return any(reading[k] > v for k, v in lim.items() if k in reading)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", ["train.importance", "train.grid", "frame.importance"])
def test_limits_hold_the_program_and_fail_the_control(workload, seed):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs the hand-written kernels")
    from portbench.control import readings
    got = readings(workload, seed, torch.device("cuda", 0))
    lim = limits(workload)
    assert not fails(got["lower"], lim), got["lower"]
    assert fails(got["control"], lim), got["control"]
    if "half_batch" in got:
        assert fails(got["half_batch"], lim), got["half_batch"]
