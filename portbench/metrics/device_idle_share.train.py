"""`device_idle_share.train`: 1 - busy / window of the traced steps, %."""

from portbench.metrics._common import idle_share


def read(ctx):
    return idle_share(ctx, "train")
