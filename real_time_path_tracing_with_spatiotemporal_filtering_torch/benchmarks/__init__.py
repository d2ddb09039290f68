"""Measurement entry points of the port: the JAX package's benchmark suite
(``suite``) and its Mosaic micro-benchmarks (``mosaic_micro``)."""
