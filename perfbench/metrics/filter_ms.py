"""Device ms a frame of the filter stage (ops/cuda/atrous.py): the nine
a-trous iterations and the temporal blend."""

PREFIXES = ("atrous_iter", "temporal_blend")


def read(ctx):
    return ctx.family_ms(lambda name: name.startswith(PREFIXES))
