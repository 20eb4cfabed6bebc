"""`setup_kernels_s`: the seconds the port spent loading its kernels'
libraries (the span ``kernels.load``: the sources hashed, ``nvcc`` where
the checkout has no build yet, the ``ctypes`` load), in all."""

from portbench.metrics import _spans


def read(ctx):
    return _spans.total_s(_spans.snapshot(), "kernels.load")
