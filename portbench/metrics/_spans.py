"""What the readers of the port's own spans share: the snapshot of the
tracer (``mc_nerf_torch/utils/trace.py``) in the run's own process, taken
on rank 0 after the runner returns.  The tracer is the one the port
loaded; nothing here imports the port (``program.py`` and the runners
do).  A program without the tracer, or a span that never occurred (the
CPU, the loop route), gives no reading."""

from __future__ import annotations

import sys
from typing import Iterable, Optional

TRACER = "mc_nerf_torch.utils.trace"


def snapshot() -> Optional[dict]:
    """The port's tracer's snapshot (its pending device intervals waited
    for), or None where the program loaded no tracer."""
    trace = sys.modules.get(TRACER)
    return None if trace is None else trace.snapshot(sync=True)


def unprofiled_median_ms(snap: Optional[dict], name: str) -> Optional[float]:
    """The median of span ``name``'s durations taken before any profiler
    recorded in the process, ms: a CUDA graph's launch stays slower after
    a profiler session has ended, so the traced part of the window and all
    that follows it are left out."""
    s = (snap or {}).get("spans", {}).get(name)
    return None if s is None or s["median_unprofiled_s"] is None else 1e3 * s[
        "median_unprofiled_s"]


def interval_median_ms(snap: Optional[dict], name: str) -> Optional[float]:
    """The median of device interval ``name``'s newest resolved lengths, ms."""
    s = (snap or {}).get("intervals", {}).get(name)
    return None if s is None else 1e3 * s["median_s"]


def total_s(snap: Optional[dict], name: str) -> Optional[float]:
    """Span ``name``'s total seconds."""
    s = (snap or {}).get("spans", {}).get(name)
    return None if s is None else s["total_s"]


def self_total_s(snap: Optional[dict], names: Iterable[str]) -> Optional[float]:
    """The spans' self seconds summed (their child spans' excluded), None
    where none of them occurred."""
    spans = (snap or {}).get("spans", {})
    found = [spans[n]["self_s"] for n in names if n in spans]
    return sum(found) if found else None
