"""Device-busy ms a frame: the union of the kernel intervals of the
profiled sub-window over its frames."""

from perfbench import tracefile


def read(ctx):
    return tracefile.busy_us(ctx.kernels) / 1e3 / ctx.frames if ctx.kernels else None
