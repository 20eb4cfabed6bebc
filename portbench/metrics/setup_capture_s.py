"""`setup_capture_s`: the seconds of the graphs' eager warm-ups and
captures (the spans ``epoch.capture``, ``epoch.warmup``, ``frame.warmup``
and ``frame.capture``), each span's self time, so the kernels' loads
inside them are left out."""

from portbench.metrics import _spans

SPANS = ("epoch.capture", "epoch.warmup", "frame.warmup", "frame.capture")


def read(ctx):
    return _spans.self_total_s(_spans.snapshot(), SPANS)
