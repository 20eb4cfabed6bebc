"""`glue_ms.frame`: device ms a frame in every operation no kernel file names."""

from portbench.metrics._common import glue_ms


def read(ctx):
    return glue_ms(ctx, "frame")
