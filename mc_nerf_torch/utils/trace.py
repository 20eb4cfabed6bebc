"""The port's tracer: spans, counters and device intervals, kept in memory.

* :func:`span` times a block on the host (``time.perf_counter``) and
  records its name, its enclosing span (the parent), its duration and its
  self time (the duration less what its child spans cover).  While a
  ``torch.profiler`` records, the span also opens
  ``record_function("mcn." + name)``, which puts it on the device trace's
  clock; with no profiler it opens no range.
* :func:`count` keeps counters.
* :func:`interval_start` / :func:`interval_end` bracket a device
  interval: a pair of timing CUDA events on the current stream, taken
  from a small pool and resolved once ``query()`` says both have
  completed.  Nothing here synchronizes, except a :func:`snapshot` asked
  to.

Memory holds, for each name, the count, the total and self-total
seconds, the summed units (steps, frames) and bounded windows of the
newest durations for medians, so it never grows with the run: one of
every duration, one of those taken before any profiler recorded in the
process (a CUDA graph's launch stays slower after a ``torch.profiler``
session has ended, by about half a microsecond a node on an H100).
There is no switch: tracing off means no profiler attached, and the
spans still time on the host, a few a frame or an epoch.

One tracer a process (:data:`TRACER`): the kernels' loader, the step and
frame graphs and the engine record into the same place, which the
engine's table and the benchmark's readers read.  Spans nest on the
thread that opens them; the port traces one thread.
"""

from __future__ import annotations

import statistics
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

WINDOW = 4096      # the newest durations a name keeps, for its median
POOL = 16          # free timing events kept for reuse
PENDING = 256      # device intervals awaiting their events; older ones are dropped


class _Stat:
    """What memory holds of one name."""

    __slots__ = ("count", "total", "self_total", "units", "recent", "unprofiled", "parents",
                 "last")

    def __init__(self):
        self.count = 0
        self.total = self.self_total = 0.0
        self.units = 0
        self.recent: Deque[float] = deque(maxlen=WINDOW)
        self.unprofiled: Deque[float] = deque(maxlen=WINDOW)   # before any profiler
        self.parents: set = set()
        self.last: dict = {}         # the newest occurrence's tags

    def add(self, seconds: float, self_seconds: float, units: int, unprofiled: bool) -> None:
        self.count += 1
        self.total += seconds
        self.self_total += self_seconds
        self.units += units
        self.recent.append(seconds)
        if unprofiled:
            self.unprofiled.append(seconds)

    def summary(self) -> dict:
        return {"count": self.count, "total_s": self.total, "self_s": self.self_total,
                "units": self.units, "median_s": _median(self.recent),
                "median_unprofiled_s": _median(self.unprofiled),
                "parents": sorted(p or "" for p in self.parents), "last": dict(self.last)}


def _median(values) -> Optional[float]:
    return statistics.median(values) if values else None


class Span:
    """One span, a context manager (:meth:`Tracer.span`).  Once closed:
    ``seconds``, ``self_seconds``, and ``within``, its descendants'
    seconds by name."""

    __slots__ = ("name", "tags", "units", "parent", "start", "end", "child", "within",
                 "_tracer", "_range")

    def __init__(self, tracer: "Tracer", name: str, units: int, tags: dict):
        self.name, self.units, self.tags, self._tracer = name, units, tags, tracer
        self.parent: Optional[Span] = None
        self.start = self.end = self.child = 0.0
        self.within: Dict[str, float] = {}
        self._range = None

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def self_seconds(self) -> float:
        return self.seconds - self.child

    def __enter__(self) -> "Span":
        stack = self._tracer._stack
        self.parent = stack[-1] if stack else None
        if _autograd_profiler._is_profiler_enabled:
            self._tracer.profiled = True
            args = ",".join(f"{k}={v}" for k, v in self.tags.items()) or None
            self._range = _autograd_profiler.record_function("mcn." + self.name, args)
            self._range.__enter__()
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.perf_counter()
        self._tracer._stack.pop()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self._tracer._close(self)


class Tracer:
    """Spans, counters and device intervals of one process (see the
    module)."""

    def __init__(self):
        self._stack: List[Span] = []
        self._free: List[torch.cuda.Event] = []
        # whether a span has opened under a profiler: the process's graph
        # launches are slower from then on, a reset notwithstanding
        self.profiled = False
        self.reset()

    def reset(self) -> None:
        """Forget every span, counter and interval recorded (spans still
        open record on closing)."""
        self._spans: Dict[str, _Stat] = {}
        self._counts: Dict[str, int] = {}
        self._intervals: Dict[str, _Stat] = {}
        self._open: Dict[str, torch.cuda.Event] = {}
        self._pending: Deque[Tuple[str, torch.cuda.Event, torch.cuda.Event]] = deque()

    # ------------------------------------------------------------ spans

    def span(self, name: str, units: int = 0, **tags) -> Span:
        """A span of ``name`` (``with tracer.span(...) as s``); ``units``
        (steps, frames) add to the name's sum; ``tags`` (the frame
        number, the stage) identify the occurrence."""
        return Span(self, name, units, tags)

    def _close(self, sp: Span) -> None:
        d = sp.end - sp.start
        st = self._spans.get(sp.name)
        if st is None:
            st = self._spans[sp.name] = _Stat()
        st.add(d, d - sp.child, sp.units, not self.profiled)
        st.parents.add(sp.parent.name if sp.parent is not None else None)
        if sp.tags:
            st.last = sp.tags
        if sp.parent is not None:
            sp.parent.child += d
        for anc in self._stack:
            anc.within[sp.name] = anc.within.get(sp.name, 0.0) + d

    def count(self, name: str, n: int = 1) -> None:
        self._counts[name] = self._counts.get(name, 0) + n

    # ---------------------------------------------------- device intervals

    def _event(self) -> torch.cuda.Event:
        return self._free.pop() if self._free else torch.cuda.Event(enable_timing=True)

    def interval_start(self, name: str, device) -> None:
        """Open device interval ``name`` after the work enqueued so far on
        ``device``'s current stream."""
        ev = self._event()
        ev.record(torch.cuda.current_stream(device))
        self._open[name] = ev

    def interval_end(self, name: str, device) -> None:
        """Close the open interval ``name`` before the work enqueued next
        on ``device``'s current stream (nothing when none is open), and
        resolve the intervals whose events have completed."""
        start = self._open.pop(name, None)
        if start is None:
            return
        end = self._event()
        end.record(torch.cuda.current_stream(device))
        self._pending.append((name, start, end))
        while len(self._pending) > PENDING:
            self._pending.popleft()
        self._resolve()

    def _resolve(self) -> None:
        while self._pending and self._pending[0][2].query():
            name, start, end = self._pending.popleft()
            self._add_interval(name, start.elapsed_time(end) / 1e3)
            for ev in (start, end):
                if len(self._free) < POOL:
                    self._free.append(ev)

    def _add_interval(self, name: str, seconds: float) -> None:
        st = self._intervals.get(name)
        if st is None:
            st = self._intervals[name] = _Stat()
        st.add(seconds, seconds, 0, not self.profiled)

    # ------------------------------------------------------------ reading

    def snapshot(self, sync: bool = False) -> dict:
        """Every name's summary: ``spans`` (count, total and self seconds,
        units, the median of the newest durations and of those taken
        before any profiler, parents, the newest tags), ``counters`` and
        the resolved device ``intervals``.  With
        ``sync`` it first waits for the pending intervals' events."""
        if sync:
            for _, _, end in self._pending:
                end.synchronize()
        self._resolve()
        return {"spans": {k: v.summary() for k, v in self._spans.items()},
                "counters": dict(self._counts),
                "intervals": {k: v.summary() for k, v in self._intervals.items()}}

    def table(self) -> str:
        """The snapshot as text: spans by total time, counters, intervals."""
        snap = self.snapshot()
        rows = [f"{'span':<22} {'count':>7} {'total s':>10} {'self s':>10} {'median ms':>10} "
                f"{'units':>8}  parent; newest"]
        for name, s in sorted(snap["spans"].items(), key=lambda kv: -kv[1]["total_s"]):
            tags = " ".join(f"{k}={v}" for k, v in s["last"].items())
            rows.append(f"{name:<22} {s['count']:>7} {s['total_s']:>10.3f} {s['self_s']:>10.3f} "
                        f"{s['median_s'] * 1e3:>10.3f} {s['units']:>8}  "
                        f"{','.join(p or '-' for p in s['parents'])}; {tags}")
        for name, n in sorted(snap["counters"].items()):
            rows.append(f"{name:<22} {n:>7}")
        for name, s in sorted(snap["intervals"].items()):
            rows.append(f"{name:<22} {s['count']:>7} {s['total_s']:>10.3f} {'device':>10} "
                        f"{s['median_s'] * 1e3:>10.3f}")
        return "\n".join(rows)


TRACER = Tracer()
span = TRACER.span
count = TRACER.count
interval_start = TRACER.interval_start
interval_end = TRACER.interval_end
snapshot = TRACER.snapshot
reset = TRACER.reset
table = TRACER.table
