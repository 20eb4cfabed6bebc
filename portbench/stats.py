"""Window statistics: tails, rates, and the spread the bounds are set from."""

from __future__ import annotations

import math
import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    value with at least q% of the values at or below it."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def rate(units: float, seconds: float) -> float:
    """Units completed a second over all the window's time."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return units / seconds


def spread(values: Sequence[float]) -> float:
    """The distance between the first and the third quartile
    (``statistics.quantiles(n=4)``), as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
