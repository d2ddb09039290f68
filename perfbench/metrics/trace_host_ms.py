"""Host ms a frame in the ``frame.trace`` and ``frame.pathgrad`` spans with
everything nested in them (the tracers' launches or host loops, the firefly
clamp, demodulation, the path gradient's re-trace), less their waits.
Layer: host (pipeline/frame.py)."""

from perfbench import stages


def read(ctx):
    return stages.stage_host_ms(ctx, ("frame.trace", "frame.pathgrad"), nested=True)
