"""`train_mfu`: model FLOPs of the traced steps over the traced time and 989 TFLOP/s, %."""

from portbench.metrics._common import mfu


def read(ctx):
    return mfu(ctx, "train")
