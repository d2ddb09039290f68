"""Device idle ms a frame in the gaps that open inside a ``frame`` span
while the host is in no wait: the card ran dry because the host enqueued
more slowly than it ran. The profiler's host cost slows the enqueue, so
this is an upper bound, as ``device_idle_share`` is. Layer: host
(pipeline/frame.py)."""

from perfbench import stages


def read(ctx):
    return stages.idle_ms(ctx, "enqueue")
