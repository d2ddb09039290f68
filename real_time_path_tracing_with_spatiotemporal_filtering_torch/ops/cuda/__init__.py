"""Wrappers of the hand-written CUDA kernels (sources in csrc/).

Each wrapper launches its kernel for tensors on a CUDA device and runs its
plain PyTorch version for tensors on the CPU. ``LAUNCHES`` counts the
kernel launches by kernel name.
"""

from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda._build import (  # noqa: F401
    LAUNCHES,
)
