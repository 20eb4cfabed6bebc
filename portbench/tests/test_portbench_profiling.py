"""The trace arithmetic on synthetic device operations."""

import json

import pytest

from portbench import profiling
from portbench.profiling import Op, Trace


def test_union_counts_overlaps_once():
    assert profiling.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert profiling.union_length([(0, 10), (2, 3), (4, 5)]) == 10
    assert profiling.union_length([]) == 0


@pytest.mark.parametrize("intervals, share", [
    ([(0.0, 1.0), (2.0, 3.0)], 60.0),                # two kernels on one stream
    ([(0.0, 2.0), (1.0, 3.0)], 40.0),                # two streams overlapping
    ([(0.0, 5.0), (1.0, 2.0), (3.0, 4.0)], 0.0),     # nested, the card never idle
])
def test_idle_share(intervals, share):
    from portbench.metrics._common import idle_share
    trace = Trace([Op("k", s, e) for s, e in intervals], [], 0.0, 5.0)
    s = dict(profiling.summary(trace, []), kind="train")
    assert idle_share({"trace": [s]}, "train") == pytest.approx(share)
    assert idle_share({"trace": [s]}, "frame") is None


def test_idle_gaps_inside_the_window():
    gaps = profiling.idle_gaps([(1.0, 2.0), (1.5, 3.0), (4.0, 4.5)], 0.0, 5.0)
    assert gaps == [(0.0, 1.0), (3.0, 1.0), (4.5, 0.5)]


def test_summary_layers_breakdown_and_named_gaps(tmp_path):
    (tmp_path / "a.json").write_text(json.dumps({"layer": "kernels", "kernels": ["fused_k"]}))
    maps = profiling.load_layer_maps(tmp_path)
    trace = Trace(device=[Op("void fused_k<1>()", 0.0, 0.5), Op("elementwise", 0.5, 0.6),
                          Op("elementwise", 1.6, 1.7)],
                  host=[Op("portbench.epoch_end_read", 0.55, 1.65), Op("cudaMemcpy", 1.0, 1.2)],
                  start=0.0, end=2.0)
    s = profiling.summary(trace, maps)
    assert s["busy_s"] == pytest.approx(0.7)
    assert s["window_s"] == 2.0
    assert s["layer_s"] == pytest.approx({"kernels": 0.5, "glue": 0.2})
    assert s["breakdown"]["device_ops"][0] == ["void fused_k<1>()", 0.5]
    gaps = s["breakdown"]["idle_gaps"]
    assert gaps[0] == ["cudaMemcpy", pytest.approx(1.0)]       # the innermost host op
    assert [g[0] for g in gaps[1:]] == ["host"]
