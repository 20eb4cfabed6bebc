"""What the per-layer readers share: the traced ranks' summaries
(``profiling.summary`` plus the runner's counts) and the peaks.  A trace
in which no operation ran on the device gives no reading."""

from __future__ import annotations

from typing import List, Optional

from portbench.flops import PEAK_BF16


def ranks(ctx: dict, kind: str) -> Optional[List[dict]]:
    """The traced ranks' summaries of a run of ``kind`` ("train" / "frame"),
    or None where the run traced nothing of that kind."""
    tr = ctx.get("trace")
    if not tr or tr[0].get("kind") != kind or not all(r["busy_s"] > 0 for r in tr):
        return None
    return tr


def mfu(ctx: dict, kind: str) -> Optional[float]:
    """Model FLOPs of the traced units over the traced time and the peak,
    %, averaged over the ranks (each rank's own work on its own chip)."""
    rs = ranks(ctx, kind)
    if rs is None:
        return None
    return 100.0 * sum(r["flops_per_unit"] * r["units"] / (r["window_s"] * PEAK_BF16)
                       for r in rs) / len(rs)


def roofline(ctx: dict, kind: str) -> Optional[float]:
    """The hand kernels' least time over their device time, %, over the
    ranks' sums; None where no hand kernel ran."""
    rs = ranks(ctx, kind)
    if rs is None:
        return None
    spent = sum(r["layer_s"].get("kernels", 0.0) for r in rs)
    if spent <= 0:
        return None
    return 100.0 * sum(r["bound_s_per_unit"] * r["units"] for r in rs) / spent


def glue_ms(ctx: dict, kind: str) -> Optional[float]:
    """Device ms a unit in every operation no kernel file names, averaged
    over the ranks."""
    rs = ranks(ctx, kind)
    if rs is None:
        return None
    return 1e3 * sum(r["layer_s"].get("glue", 0.0) / r["units"] for r in rs) / len(rs)


def idle_share(ctx: dict, kind: str) -> Optional[float]:
    """1 - busy / window, %, averaged over the ranks."""
    rs = ranks(ctx, kind)
    if rs is None:
        return None
    return 100.0 * sum(1.0 - r["busy_s"] / r["window_s"] for r in rs) / len(rs)
