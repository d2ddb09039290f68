"""Host ms a frame in the ``frame.geometry`` span (the geometry kernel's
launch, or the plain G-buffer, gradient and backprojection), self time
less its waits. Layer: host (pipeline/frame.py)."""

from perfbench import stages


def read(ctx):
    return stages.stage_host_ms(ctx, ("frame.geometry",))
