"""The trace arithmetic and the metric readers on a synthetic Chrome trace."""

import math

from perfbench import harness, registry, tracefile


def k(name, ts, dur, cat="kernel"):
    return {"cat": cat, "name": f"void (anonymous namespace)::{name}<4>(float*)", "ts": ts,
            "dur": dur}


EVENTS = [
    k("geometry_bvh_kernel", 0, 10),
    k("trace_segment_kernel", 10, 40),
    k("trace_segment_kernel", 45, 20),          # overlaps the one before
    k("vectorized_elementwise_kernel", 100, 5),
    {"cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "ts": 105, "dur": 5},
    k("atrous_iter_var_kernel", 130, 30),
    k("temporal_blend_ramp_kernel", 160, 10),
    {"cat": "user_annotation", "name": "step", "ts": 60, "dur": 30},
    {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 62, "dur": 3},
    {"cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 70, "dur": 12},   # waits
    {"cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 88, "dur": 6},  # half in
    {"cat": "user_annotation", "name": "wait_inflight", "ts": 112, "dur": 18},
    {"cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 500},
]
FRAMES = 2
CFG = {"width": 1920, "height": 1080, "variance_guided": True, "accumulation_ramp": True}


def ctx(**kw):
    fields = dict(kernels=tracefile.kernel_events(EVENTS),
                  device_events=tracefile.device_events(EVENTS),
                  host_spans=tracefile.host_spans(EVENTS),
                  runtime_events=tracefile.runtime_events(EVENTS), frames=FRAMES,
                  window_us=400.0, cfg=CFG, device_kind="NVIDIA H100 80GB HBM3")
    fields.update(kw)
    return harness.TraceContext(**fields)


def read(name, c=None):
    return registry.metric_reader(name)(c or ctx())


def test_busy_union_and_gaps():
    assert tracefile.busy_us(tracefile.kernel_events(EVENTS)) == 65 + 5 + 40
    assert tracefile.busy_us(tracefile.device_events(EVENTS)) == 65 + 10 + 40
    gaps = tracefile.idle_gaps(tracefile.device_events(EVENTS), tracefile.host_spans(EVENTS))
    assert [g[0] for g in gaps] == ["step", "wait_inflight"]
    assert [round(g[1] * 1e6, 9) for g in gaps] == [35.0, 20.0]
    assert tracefile.kernel_name(EVENTS[1]) == "trace_segment_kernel"


def test_family_metrics():
    assert read("trace_ms") == (40 + 20) / 1e3 / FRAMES
    assert read("geometry_ms") == 10 / 1e3 / FRAMES
    assert read("filter_ms") == (30 + 10) / 1e3 / FRAMES
    assert read("plain_ops_ms") == 5 / 1e3 / FRAMES
    assert read("launches_per_frame") == 6 / FRAMES
    assert read("device_busy_ms") == 110 / 1e3 / FRAMES
    assert read("device_idle_share") == 1 - 115 / 400
    # the step span less the time its calls wait on the device
    assert math.isclose(read("host_ms_per_frame"), (30 - 12 - 2) / 1e3 / FRAMES)


def test_filter_roofline_counts_stage_bytes():
    roofline = registry.metric_reader("filter_roofline")
    import importlib.util, os
    spec = importlib.util.spec_from_file_location(
        "fr", os.path.join(registry.HERE, "metrics", "filter_roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    px = 1920 * 1080
    assert mod.stage_bytes({"width": 1920, "height": 1080}) == 64 * px
    assert mod.stage_bytes(CFG) == 84 * px
    least_ms = 84 * px / 3.35e12 * 1e3
    assert math.isclose(roofline(ctx()), 100 * least_ms / read("filter_ms"))
    assert roofline(ctx(device_kind="some other card")) is None


def test_silent_without_its_kernels():
    empty = ctx(kernels=[], device_events=[], host_spans=[], runtime_events=[])
    for name in ("host_ms_per_frame", "trace_ms", "filter_ms", "filter_roofline", "geometry_ms", "plain_ops_ms",
                 "launches_per_frame", "device_busy_ms", "device_idle_share"):
        assert read(name, empty) is None, name


def test_p95_over_intervals():
    values = list(range(1, 101))
    assert math.isclose(harness.p95([float(v) for v in values]), 95.05)
    assert harness.p95([3.0]) == 3.0
