"""Runtime calls a frame that wait on the device inside the program's
``frame`` spans (``stages.waits``): ``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize``, and ``cudaMemcpy`` or
``cudaMemcpyAsync`` whose device copy is from pageable memory or to the
host. Each keeps the next frame from being enqueued while the card works.
Layer: host (pipeline/frame.py)."""

from perfbench import stages


def read(ctx):
    found = stages.waits(ctx)
    return None if found is None else len(found) / ctx.frames
