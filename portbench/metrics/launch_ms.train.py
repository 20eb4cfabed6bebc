"""`launch_ms.train`: the median host time of an epoch's first step
graph launch (the port's span ``epoch.launch``, onto a queue the epoch-end
read emptied), over the epochs before the traced one (a profiler slows
every later launch in the process): what launching one step costs, ms."""

from portbench.metrics import _spans


def read(ctx):
    return _spans.unprofiled_median_ms(_spans.snapshot(), "epoch.launch")
