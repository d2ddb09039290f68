"""Plain PyTorch versions of the frame's passes; CUDA kernels in ops/cuda."""
