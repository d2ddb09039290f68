"""Kernel launches a frame: the kernel events of the profiled sub-window's
device trace over its frames (the plain PyTorch ops' kernels included)."""


def read(ctx):
    return len(ctx.kernels) / ctx.frames if ctx.kernels else None
