"""Host ms a frame in the ``frame.move``, ``frame.matrices`` and
``frame.moments`` spans and in the ``frame`` span outside its stages, self
time less their waits: the frame's plain PyTorch ops and its own code.
With ``geometry_host_ms``, ``trace_host_ms``, ``filter_host_ms`` and the
waits' time it makes up the ``frame`` spans' time. Layer: host
(pipeline/frame.py)."""

from perfbench import stages


def read(ctx):
    return stages.stage_host_ms(ctx, ("frame", "frame.move", "frame.matrices", "frame.moments"))
