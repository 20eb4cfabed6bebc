"""The window statistics: the tail and the rates, and what a stall does
to them, in the statistics and through the frame runner's window."""

import time

import pytest
import torch

from portbench import stats
from portbench.run import Run, manifest, run_cell
from portbench.tests.conftest import tiny


def test_nearest_rank_percentile():
    assert stats.percentile(range(1, 101), 90) == 90
    assert stats.percentile([5.0], 90) == 5.0
    assert stats.percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 90) == 9
    with pytest.raises(ValueError):
        stats.percentile([], 90)


def test_a_planted_stall_lowers_the_rate_and_raises_the_tail():
    frames = [240.0] * 4
    stalled = frames[:2] + [1240.0] + frames[2:]       # one frame waits a second
    n = 640_000
    assert stats.rate(len(stalled) * n, sum(stalled) / 1e3) < stats.rate(len(frames) * n,
                                                                          sum(frames) / 1e3)
    assert stats.percentile(stalled, 90) > stats.percentile(frames, 90)


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    assert stats.spread([9.0, 10.0, 10.0, 11.0]) == pytest.approx(
        (10.75 - 9.25) / 10.0)


def test_the_frame_window_sees_a_stall(monkeypatch, cpu_threads):
    """Every frame of one window slowed by a planted sleep: fewer rays a
    second and a longer tail than the window without it."""
    from mc_nerf_torch.train.steps import FrameRender

    def window(stall_s):
        call = FrameRender.__call__

        def slowed(self, *a, **k):
            time.sleep(stall_s)
            return call(self, *a, **k)
        monkeypatch.setattr(FrameRender, "__call__", slowed)
        b = Run("frame.importance", 11, 0.6, False, torch.device("cpu"), time.time(),
                overrides=tiny("frame.importance"))
        return run_cell(b, manifest())["metrics"]

    calm, stalled = window(0.0), window(0.05)
    assert stalled["render_rays_per_s"]["value"] < calm["render_rays_per_s"]["value"]
    assert stalled["frame_ms_p90"]["value"] > calm["frame_ms_p90"]["value"] + 40
