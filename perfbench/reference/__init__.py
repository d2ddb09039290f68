"""The plain reference of the benchmark: a frozen copy of the path tracer's
plain PyTorch frame (the operations the JAX package defines, as the
measured package's plain route runs them), imported by nothing of the
program and importing nothing of it. ``frame.render_frame`` is the whole
frame; the benchmark builds its tables, camera matrices and history itself.
"""
