"""`roofline_share.frame_kernels`: the least time of the hand kernels'
passes over their device time, %."""

from portbench.metrics._common import roofline


def read(ctx):
    return roofline(ctx, "frame")
