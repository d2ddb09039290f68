"""Host ms a frame that ``Renderer.step()`` spends enqueuing its work: over
the profiled sub-window, the harness's ``step`` spans less the CUDA runtime
calls inside them that wait on the device, over its frames. The calls that
wait are the synchronisations and the copies (a copy from pageable host
memory first waits for the stream). The profiler's own host cost lengthens
the spans, so this is an upper bound of an unprofiled frame's enqueue time.
Layer: host (pipeline/renderer.py, pipeline/frame.py)."""

from perfbench import tracefile

WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy", "cudaMemcpyAsync")


def read(ctx):
    steps = [s for s in ctx.host_spans if s["name"] == "step"]
    if not steps:
        return None
    waits = [e for e in ctx.runtime_events if e["name"] in WAITS]
    busy = sum(s["dur"] for s in steps) - tracefile.overlap_us(steps, waits)
    return busy / 1e3 / ctx.frames
