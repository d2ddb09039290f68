"""The readers of the program's stage spans (``stages.py`` and the seven
metrics on it) on a synthetic trace of one frame, its runtime calls matched
to its device copies by correlation id."""

import math

from perfbench import harness, registry, stages, tracefile

FRAMES = 2  # the divisor of every per-frame number


def span(name, ts, dur):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def call(name, ts, dur, corr=None):
    e = {"cat": "cuda_runtime", "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def op(name, ts, dur, corr=None, cat="kernel"):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def copy(kind, ts, dur, corr):
    return op(f"Memcpy {kind}", ts, dur, corr, cat="gpu_memcpy")


SPANS = [
    span("frame", 0, 100),
    span("frame.matrices", 0, 30),
    span("frame.geometry", 30, 10),
    span("frame.trace", 40, 20),
    span("trace.segment[0]", 45, 10),
    span("frame.filter", 60, 30),
    span("frame.blend", 90, 8),
    span("wait_inflight", 100, 20),
]
CALLS = [
    call("cudaMemcpyAsync", 5, 2, corr=1),         # pageable HtoD: waits
    call("cudaStreamSynchronize", 8, 10),          # waits
    call("cudaMemcpyAsync", 19, 4, corr=2),        # DtoH: waits
    call("cudaMemcpyAsync", 24, 1, corr=3),        # DtoD: does not wait
    call("cudaLaunchKernel", 32, 2, corr=4),       # a launch does not wait
    call("cudaStreamSynchronize", 50, 2),          # waits, inside trace.segment[0]
    call("cudaStreamSynchronize", 105, 5),         # outside every frame
]
OPS = [
    op("matrix_kernel", 0, 9),
    copy("HtoD (Pageable -> Device)", 19, 1, 1),   # gap [9, 19] opened in the sync
    copy("DtoH (Device -> Pageable)", 20, 4, 2),
    copy("DtoD (Device -> Device)", 24, 2, 3),
    op("geometry_kernel", 26, 39, 4),
    op("atrous_iter_var_kernel", 70, 40),          # gap [65, 70] opened in frame.filter
    op("temporal_blend_ramp_kernel", 125, 5),      # gap [110, 125] opened in wait_inflight
]
WINDOW_US = 200.0


def ctx(spans=SPANS):
    events = spans + CALLS + OPS
    return harness.TraceContext(
        kernels=tracefile.kernel_events(events), device_events=tracefile.device_events(events),
        host_spans=tracefile.host_spans(events), runtime_events=tracefile.runtime_events(events),
        frames=FRAMES, window_us=WINDOW_US, cfg={"width": 1920, "height": 1080},
        device_kind="NVIDIA H100 80GB HBM3")


def read(name, c=None):
    return registry.metric_reader(name)(c or ctx())


def ms(us):
    return us / 1e3 / FRAMES


def test_copies_that_wait_are_waits():
    found = stages.waits(ctx())
    assert [(w["ts"], w["name"]) for w in found] == [
        (5, "cudaMemcpyAsync"), (8, "cudaStreamSynchronize"), (19, "cudaMemcpyAsync"),
        (50, "cudaStreamSynchronize")]
    assert read("host_syncs_per_frame") == 4 / FRAMES


def test_gaps_go_to_where_they_opened():
    assert math.isclose(read("sync_idle_ms"), ms(10))     # opened inside the sync
    assert math.isclose(read("enqueue_idle_ms"), ms(5))   # opened inside frame.filter
    # the gap opened in wait_inflight counts for neither
    by_span = stages.idle_by_span(ctx())
    assert set(by_span) == {"frame.matrices wait", "frame.filter", "wait_inflight", "edges"}
    assert math.isclose(by_span["frame.matrices wait"], ms(10))
    assert math.isclose(by_span["frame.filter"], ms(5))
    assert math.isclose(by_span["wait_inflight"], ms(15))
    # with the sub-window's edges the table adds up to its idle time
    idle_share = read("device_idle_share")
    assert math.isclose(sum(by_span.values()), ms(idle_share * WINDOW_US))


def test_self_times_exclude_nested_spans_and_waits():
    assert math.isclose(read("geometry_host_ms"), ms(10))
    # frame.trace with what is nested in it, less the sync inside the segment
    assert math.isclose(read("trace_host_ms"), ms(20 - 2))
    # its self time alone leaves the nested segment out
    assert math.isclose(stages.stage_host_ms(ctx(), ("frame.trace",)), ms(20 - 10))
    assert math.isclose(read("filter_host_ms"), ms(30 + 8))
    # frame.matrices less its three waits, and the frame outside its stages
    assert math.isclose(read("plain_host_ms"), ms(30 - 2 - 10 - 4 + 2))
    host = sum(read(n) for n in ("geometry_host_ms", "trace_host_ms", "filter_host_ms",
                                 "plain_host_ms"))
    waited = sum(w["dur"] for w in stages.waits(ctx()))
    assert math.isclose(host + ms(waited), ms(100))  # the frame span's time


def test_silent_without_frame_spans():
    older = ctx([s for s in SPANS if not s["name"].startswith(("frame", "trace."))])
    for name in ("host_syncs_per_frame", "sync_idle_ms", "enqueue_idle_ms", "geometry_host_ms",
                 "trace_host_ms", "filter_host_ms", "plain_host_ms"):
        assert read(name, older) is None, name
    assert stages.idle_by_span(older) is None
