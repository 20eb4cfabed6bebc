"""`caller_ms.frame`: the median device interval ``frame.caller``, from a
frame's outputs to the next frame's first work on the stream (the
caller's copy to the host and its loop: the card waits), ms."""

from portbench.metrics import _spans


def read(ctx):
    return _spans.interval_median_ms(_spans.snapshot(), "frame.caller")
