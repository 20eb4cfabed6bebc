"""`device_idle_share.frame`: 1 - busy / window of the traced frames, %."""

from portbench.metrics._common import idle_share


def read(ctx):
    return idle_share(ctx, "frame")
