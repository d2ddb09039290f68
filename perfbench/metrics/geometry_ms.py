"""Device ms a frame of the geometry kernels (ops/cuda/geometry.py): the
dense and the LBVH G-buffer kernels."""

FAMILY = ("geometry_kernel", "geometry_bvh_kernel")


def read(ctx):
    return ctx.family_ms(lambda name: name in FAMILY)
