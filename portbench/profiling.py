"""Device trace arithmetic: which layer each device operation belongs to,
its time by layer, the busy time (the union of the operations'
intervals) and the idle gaps, from ``torch.profiler`` over a steady part
of the window.

The kernel sums follow ``mc_nerf_torch/tools/profile_step.py``'s
``profile_steps`` and ``count_named`` (a name matched as a word), with
intervals in place of sums so that overlapping operations (several
streams, the all-reduce) are counted once in the busy time.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Sequence, Tuple

KERNEL_DIR = Path(__file__).resolve().parent / "kernels"
GLUE = "glue"


class Op(NamedTuple):
    name: str
    start: float     # seconds
    end: float


def load_layer_maps(directory: Path = KERNEL_DIR) -> List[Tuple[str, List[re.Pattern]]]:
    """[(layer, patterns)] of every ``*.json`` file under ``directory``,
    each ``{"layer": name, "kernels": [pattern, ...]}``: a device
    operation whose name holds a pattern (a regular expression, matched as
    a word where it starts and ends with one) belongs to that layer."""
    maps = []
    for path in sorted(Path(directory).glob("*.json")):
        spec = json.loads(path.read_text())
        maps.append((spec["layer"], [re.compile(_worded(k)) for k in spec["kernels"]]))
    return maps


def _worded(pattern: str) -> str:
    head = r"\b" if re.match(r"\w", pattern) else ""
    tail = r"\b" if re.search(r"\w$", pattern) else ""
    return head + pattern + tail


def classify(name: str, maps) -> str:
    """The layer of a device operation: the first map (by file name) with a
    pattern in ``name``; an operation no file names is glue."""
    for layer, patterns in maps:
        if any(p.search(name) for p in patterns):
            return layer
    return GLUE


def union_length(intervals: Sequence[Tuple[float, float]]) -> float:
    """Total length covered by the intervals, overlaps counted once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals: Sequence[Tuple[float, float]], start: float,
              end: float) -> List[Tuple[float, float]]:
    """[(gap start, gap length)] of the stretches of [start, end] that no
    interval covers."""
    gaps, cur = [], start
    for s, e in sorted(intervals):
        if s > cur:
            gaps.append((cur, s - cur))
        cur = max(cur, e)
    if end > cur:
        gaps.append((cur, end - cur))
    return gaps


class Trace(NamedTuple):
    device: List[Op]       # device operations (kernels, copies, sets)
    host: List[Op]         # host operations and the benchmark's own ranges
    start: float           # the profiled window on the trace's clock, seconds
    end: float

    @property
    def window_s(self) -> float:
        return self.end - self.start


def record(body: Callable[[], None], sync: Callable[[], None]) -> Trace:
    """Run ``body()`` under ``torch.profiler`` (CPU and CUDA activities),
    synchronized on both sides; the window is the host's span of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("portbench.window"):
            body()
            sync()
    device, host, win = [], [], None
    for e in prof.events():
        op = Op(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
        if e.device_type == DeviceType.CUDA:
            # a host range's shadow on the device's timeline is no operation
            if op.end > op.start and not _annotation(e):
                device.append(op)
        elif e.name == "portbench.window":
            win = op
        else:
            host.append(op)
    if win is None:
        raise RuntimeError("the profiler recorded no window")
    return Trace(device, host, win.start, win.end)


def _annotation(event) -> bool:
    """Whether a device-side event is a user annotation (a
    ``record_function`` range mirrored on the device's timeline)."""
    return bool(getattr(event, "is_user_annotation", False)) or event.name.startswith("portbench.")


def layer_seconds(ops: Sequence[Op], maps) -> Dict[str, float]:
    """{layer: device seconds}, each operation by its own duration."""
    out: Dict[str, float] = {}
    for op in ops:
        layer = classify(op.name, maps)
        out[layer] = out.get(layer, 0.0) + (op.end - op.start)
    return out


def top_ops(ops: Sequence[Op], n: int = 10) -> List[list]:
    """[[name, seconds]] of the ``n`` device operations that took most time
    in all, by name."""
    sums: Dict[str, float] = {}
    for op in ops:
        sums[op.name] = sums.get(op.name, 0.0) + (op.end - op.start)
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:n]]


def top_gaps(trace: Trace, n: int = 10) -> List[list]:
    """[[what the host was doing, seconds]] of the ``n`` longest idle gaps
    of the device: each named by the shortest host operation that spans
    its middle ("host" where none does)."""
    gaps = idle_gaps([(o.start, o.end) for o in trace.device], trace.start, trace.end)
    gaps.sort(key=lambda g: -g[1])
    out = []
    for s, length in gaps[:n]:
        mid = s + length / 2
        spans = [o for o in trace.host if o.start <= mid <= o.end]
        name = min(spans, key=lambda o: o.end - o.start).name if spans else "host"
        out.append([name, length])
    return out


def summary(trace: Trace, maps) -> dict:
    """What the per-layer readers read: busy and window seconds, device
    seconds by layer, the breakdown."""
    intervals = [(o.start, o.end) for o in trace.device]
    return {"busy_s": union_length(intervals), "window_s": trace.window_s,
            "layer_s": layer_seconds(trace.device, maps),
            "breakdown": {"device_ops": top_ops(trace.device), "idle_gaps": top_gaps(trace)}}
