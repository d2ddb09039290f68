"""The frame's stage spans (utils/profiling.span): under torch.profiler a
frame records ``frame`` and one span a stage it runs, each once, nested in
``frame`` and in the order the route runs them, and the segment tracer's
and the path gradient's inner spans nested in their stage; with no
profiler running a frame enters no ``record_function`` and gives the same
frame bit for bit."""

import pytest
import torch

from real_time_path_tracing_with_spatiotemporal_filtering_torch import (
    RenderConfig,
    Renderer,
    Scene,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline import (
    frame as tframe,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils import profiling

torch.set_num_threads(1)

SIZE = dict(width=16, height=16, max_bounces=3)
# the benchmark cells' render mode (perfbench/traffic/interactive_orbit_dense.json)
CELL = dict(SIZE, rr_start_bounce=4, variance_guided=True, accumulation_ramp=True,
            adaptive_alpha=True)
# the segment tracer's G-buffer seed with its NEE shadow segment, and the
# path gradient's re-trace and box filter
SEGMENTS = dict(CELL, gbuffer_primary=True, nee=True, path_gradient=True)
CONFIGS = {"cell": CELL, "segments": SEGMENTS}

STAGES = {
    "plain": ["frame.matrices", "frame.geometry", "frame.pathgrad", "frame.trace",
              "frame.moments", "frame.filter", "frame.blend"],
    "kernels": ["frame.matrices", "frame.geometry", "frame.trace", "frame.pathgrad",
                "frame.moments", "frame.filter", "frame.blend"],
}
# a 4x4 model matrix: a small turn about y and a shift
MODEL = [[0.995, 0.0, 0.0998, 0.05], [0.0, 1.0, 0.0, 0.0], [-0.0998, 0.0, 0.995, 0.0],
         [0.0, 0.0, 0.0, 1.0]]


def _renderer(cfg: dict) -> Renderer:
    """A CPU renderer one frame in, so the frame measured has a history."""
    r = Renderer(Scene.cornell_box(), RenderConfig(**cfg), device="cpu")
    r.step()
    return r


def _frame(r: Renderer, route: str):
    """One frame of ``r`` on ``route``: Renderer.step() on the plain route,
    the kernel route's body on CPU tensors (each wrapper's plain version)."""
    if route == "plain":
        return r.step()
    rgb, r.history = tframe._render_frame_kernels(r.tri_data, r.camera, r.light, r.history,
                                                  r.cfg)
    return rgb


def _profiled_spans(fn, tmp_path) -> tuple:
    """``fn()``'s result and the spans it recorded under torch.profiler
    (the exported trace's ``user_annotation`` events), in start order."""
    with profiling.trace(str(tmp_path)):
        out = fn()
    events = profiling.read_events(str(tmp_path / "trace.json"))
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"),
                   key=lambda e: e["ts"])
    return out, spans


def _inside(inner, outer) -> bool:
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


@pytest.mark.parametrize("route", ["plain", "kernels"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_stage_spans_nested_in_frame_order(name, route, tmp_path):
    cfg = CONFIGS[name]
    r = _renderer(cfg)
    _, spans = _profiled_spans(lambda: _frame(r, route), tmp_path)
    frames = [s for s in spans if s["name"] == "frame"]
    assert len(frames) == 1
    stages = [s for s in spans if s["name"].startswith("frame.")]
    want = [s for s in STAGES[route] if s != "frame.pathgrad" or cfg.get("path_gradient")]
    assert [s["name"] for s in stages] == want
    assert all(_inside(s, frames[0]) for s in stages)
    for a, b in zip(stages, stages[1:]):
        assert a["ts"] + a["dur"] <= b["ts"], (a["name"], b["name"])
    stage = {s["name"]: s for s in stages}
    inner = [s for s in spans if not s["name"].startswith("frame")]
    box3 = [s for s in inner if s["name"] == "pathgrad.box3"]
    if not cfg.get("path_gradient"):
        assert inner == []
        return
    assert len(box3) == r.cfg.gradient_filter_iters
    assert all(_inside(s, stage["frame.pathgrad"]) for s in box3)
    tracer = [s for s in inner if s["name"].startswith("trace.")]
    if route == "plain":  # the plain tracers have no segments
        assert tracer == []
        return
    in_trace = [s["name"] for s in tracer if _inside(s, stage["frame.trace"])]
    assert in_trace == ["trace.seed", "trace.shadow",
                        *(f"trace.segment[{k}]" for k in range(1, r.cfg.max_bounces)),
                        "trace.radiance"]
    seed, shadow = tracer[:2]
    assert _inside(shadow, seed)
    in_pathgrad = [s["name"] for s in tracer if _inside(s, stage["frame.pathgrad"])]
    assert in_pathgrad == [*(f"trace.segment[{k}]" for k in range(r.cfg.max_bounces)),
                           "trace.radiance"]
    assert len(in_trace) + len(in_pathgrad) == len(tracer)


def test_model_move_is_the_first_stage(tmp_path):
    r = _renderer(CELL)
    r.set_model(MODEL)
    _, spans = _profiled_spans(r.step, tmp_path)
    names = [s["name"] for s in spans]
    assert names == ["frame", "frame.move", *STAGES["plain"][:2], *STAGES["plain"][3:]]
    assert _inside(spans[1], spans[0])


class _Counting:
    """A stand-in for torch.profiler.record_function that counts entries."""

    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).entered += 1

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("route", ["plain", "kernels"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_no_span_without_a_profiler(name, route, monkeypatch):
    cfg = CONFIGS[name]
    unprofiled, profiled = _renderer(cfg), _renderer(cfg)
    monkeypatch.setattr(_Counting, "entered", 0)
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    rgb = _frame(unprofiled, route)
    assert _Counting.entered == 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        want = _frame(profiled, route)
    assert _Counting.entered > 0  # the stand-in is what a recorded span enters
    assert torch.equal(rgb, want)
    for field in ("image", "moments", "age"):
        assert torch.equal(getattr(unprofiled.history, field), getattr(profiled.history, field))


def test_span_formats_its_name_only_while_recording(tmp_path):
    assert profiling.span("trace.segment", 3) is profiling.span("frame")

    class Index:
        formatted = 0

        def __format__(self, spec):
            Index.formatted += 1
            return "7"

    with profiling.span("trace.segment", Index()):
        pass
    assert Index.formatted == 0

    def recorded():
        with profiling.span("trace.segment", Index()):
            pass

    _, spans = _profiled_spans(recorded, tmp_path)
    assert [s["name"] for s in spans] == ["trace.segment[7]"]
    assert Index.formatted == 1
