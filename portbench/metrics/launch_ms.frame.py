"""`launch_ms.frame`: the median host time of a frame graph's launch
(the port's span ``frame.launch``: the ``replay()`` call, onto a queue the
caller's copy to the host emptied), over the frames before the traced
ones (a profiler slows every later launch in the process), ms."""

from portbench.metrics import _spans


def read(ctx):
    return _spans.unprofiled_median_ms(_spans.snapshot(), "frame.launch")
