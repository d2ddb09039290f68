"""Device ms a frame of every kernel outside the trace, filter and geometry
families: the plain PyTorch ops on the card (the G-buffer seed, the
moments, the multi-res and path-gradient planes, the small tensors each
frame makes)."""

OWN = ("trace_kernel", "trace_segment_kernel", "shadow_segment_kernel",
       "geometry_kernel", "geometry_bvh_kernel")
PREFIXES = ("atrous_iter", "temporal_blend")


def read(ctx):
    return ctx.family_ms(lambda name: name not in OWN and not name.startswith(PREFIXES))
