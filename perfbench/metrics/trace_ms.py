"""Device ms a frame of the path tracers (ops/cuda/pathtrace.py,
ops/cuda/wavefront.py): the dense trace kernel, the segment tracer and the
bounce-0 shadow segment."""

FAMILY = ("trace_kernel", "trace_segment_kernel", "shadow_segment_kernel")


def read(ctx):
    return ctx.family_ms(lambda name: name in FAMILY)
