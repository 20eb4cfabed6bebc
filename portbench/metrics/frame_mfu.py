"""`frame_mfu`: model FLOPs of the traced frames over the traced time and 989 TFLOP/s, %."""

from portbench.metrics._common import mfu


def read(ctx):
    return mfu(ctx, "frame")
