"""One run of one cell: set-up, the measured window, the traced sub-window
and the check of what the window produced.

The window drives ``Renderer.step()`` of the measured package with at most
two frames in flight, as a swap chain allows: before frame i is enqueued
the harness waits on the event recorded after frame i - 2, and it keeps
each returned image alive until then. The cell's motion (camera and light)
is set before every step from tables made in set-up.

The check: once the window has closed and the program is freed, the plain
reference (``reference/``) renders the first ``START_FRAMES`` frames from
scratch, and re-renders ``SAMPLES`` window frames drawn from the seed from
the program's own history of the frame before (it cannot follow the
program through thousands of frames); each frame and the history it
leaves are compared with the program's (``check.py``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import statistics
import sys
import tempfile
import time

import torch

from perfbench import check, motion as motion_mod, registry, tracefile
from perfbench.reference import procedural

PORT = "real_time_path_tracing_with_spatiotemporal_filtering_torch"
WARMUP_FRAMES = 8       # past the variance estimate's first four frames
START_FRAMES = 2        # compared from scratch: a frame without and one with history
SAMPLES = 2             # window frames the reference re-renders
PROFILED_FRAMES = 30    # frames of the traced sub-window
PROFILE_ATTEMPTS = 3    # a sub-window whose trace holds no kernel is taken again
MAX_FPS = 2000          # rows of the motion tables per second of window
CHECK_STREAM = 0xC4EC   # the seed's stream that draws the compared frames


def render_settings(config: dict, traffic: dict) -> dict:
    """The RenderConfig fields of a cell: the configuration's display size
    and the traffic's render mode."""
    return {"width": config["display"]["width"], "height": config["display"]["height"],
            **traffic["render"]}


def scene_arrays(config: dict):
    """The configuration's (vertices, indices), made by the benchmark and
    handed to both the program and the reference."""
    spec = config["scene"]
    if spec["kind"] == "cornell_box":
        return procedural.cornell_box()
    raise ValueError(f"unknown scene kind {spec['kind']!r}")


class PortProgram:
    """The system under test: the measured package's Renderer."""

    def __init__(self, vertices, indices, settings: dict, device: torch.device):
        import importlib

        ptt = importlib.import_module(PORT)
        if device.type == "cuda":
            importlib.import_module(PORT + ".ops.cuda._build").library()
        self.Camera, self.Light = ptt.Camera, ptt.Light
        self.renderer = ptt.Renderer(ptt.Scene.from_arrays(vertices, indices),
                                     ptt.RenderConfig(**settings), device=device)

    def set_inputs(self, m: motion_mod.Motion, i: int) -> None:
        r = self.renderer
        r.camera = self.Camera(position=m.cam_pos[i], rotation=m.cam_rot[i])
        r.light = self.Light(position=m.light_pos[i], color=m.light_color)

    def step(self) -> torch.Tensor:
        return self.renderer.step()

    @property
    def history(self):
        return self.renderer.history


class Marker:
    """A point on the device's timeline after the work enqueued so far (a
    CUDA event; the host clock for a CPU run, which the tests make)."""

    def __init__(self, device: torch.device):
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()
        self.t = time.perf_counter()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def ms_since(self, other: "Marker") -> float:
        if self.event is not None:
            return other.event.elapsed_time(self.event)
        return (self.t - other.t) * 1e3


class Sampler:
    """A uniform sample of ``k`` window frames, drawn from the seed as the
    frames come (reservoir sampling): each keeps the program's history
    before the frame, the frame's image and the history after it."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.kept = k, 0, []
        self.gen = motion_mod.rng(seed, CHECK_STREAM)

    def offer(self, item) -> None:
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            slot = int(self.gen.integers(0, self.seen + 1))
            if slot < self.k:
                self.kept[slot] = item
        self.seen += 1


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def p95(values) -> float:
    """The 95th percentile of ``values`` (inclusive quantiles)."""
    if len(values) < 2:
        return max(values)
    return statistics.quantiles(values, n=20, method="inclusive")[18]


@dataclasses.dataclass
class TraceContext:
    """What a per-layer metric's reader reads (``metrics/<name>.py``)."""

    kernels: list
    device_events: list
    host_spans: list
    runtime_events: list
    frames: int
    window_us: float
    cfg: dict
    device_kind: str

    def family_ms(self, match) -> float | None:
        """Device ms a frame of the kernels whose name ``match`` accepts;
        None where the sub-window launched none."""
        picked = [e for e in self.kernels if match(tracefile.kernel_name(e))]
        if not picked:
            return None
        return sum(e["dur"] for e in picked) / 1e3 / self.frames


class Window:
    """The measured loop over one program."""

    def __init__(self, prog, motion: motion_mod.Motion, device: torch.device, sampler=None):
        self.prog, self.motion, self.device, self.sampler = prog, motion, device, sampler
        self.inflight: collections.deque = collections.deque()
        self.frame = 0
        self.markers: list[Marker] = []
        self.spans = False

    def _span(self, name):
        return torch.profiler.record_function(name) if self.spans else contextlib.nullcontext()

    def step(self):
        """Enqueue one frame, after the frame two before it has completed."""
        if len(self.inflight) == 2:
            with self._span("wait_inflight"):
                self.inflight.popleft()[0].wait()
        if self.frame >= len(self.motion):
            raise RuntimeError("the window outran its motion tables")
        prev = self.prog.history
        with self._span("motion"):
            self.prog.set_inputs(self.motion, self.frame)
        with self._span("step"):
            rgb = self.prog.step()
        marker = Marker(self.device)
        self.inflight.append((marker, rgb))
        self.markers.append(marker)
        if self.sampler is not None:
            self.sampler.offer((self.frame, prev, rgb, self.prog.history))
        self.frame += 1
        return rgb

    def drain(self) -> None:
        _sync(self.device)
        self.inflight.clear()


def profile_frames(win: Window, frames: int) -> dict:
    """Run ``frames`` frames under ``torch.profiler`` and read the trace,
    which goes through ``TMPDIR`` and is deleted once read."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if win.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    for attempt in range(PROFILE_ATTEMPTS):
        win.drain()
        with tempfile.TemporaryDirectory(prefix="perfbench_trace_") as tmp:
            with torch.profiler.profile(activities=acts) as prof:
                win.spans = True
                t0 = time.perf_counter()
                for _ in range(frames):
                    win.step()
                win.drain()
                wall_us = (time.perf_counter() - t0) * 1e6
                win.spans = False
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            events = tracefile.read_events(path)
        kernels = tracefile.kernel_events(events)
        if kernels or win.device.type != "cuda":
            return dict(kernels=kernels, device_events=tracefile.device_events(events),
                        spans=tracefile.host_spans(events),
                        runtime=tracefile.runtime_events(events), frames=frames,
                        wall_us=wall_us)
        print(f"perfbench: profiled sub-window {attempt + 1} held no kernel", file=sys.stderr)
    raise RuntimeError(f"{PROFILE_ATTEMPTS} profiled sub-windows held no kernel")


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device: torch.device, t_process: float, program=PortProgram,
             warmup: int = WARMUP_FRAMES, base: str = registry.HERE,
             config_override: dict | None = None) -> dict:
    """One run of ``cell``; returns the result line's object. ``program``
    makes the system under test (the tests and the control put others in
    its place); ``config_override`` changes the configuration's entries
    (the tests' small frames)."""
    config = {**registry.config(cell["config"], base), **(config_override or {})}
    traffic = registry.traffic(cell["traffic"], base)
    limits = registry.limits(cell["name"], base)
    settings = render_settings(config, traffic)
    vertices, indices = scene_arrays(config)

    # -- set-up: library, tables and tree, motion, warm-up of this shape --
    t_enter = time.perf_counter()
    motion = motion_mod.make_motion(traffic, seed, warmup + int(MAX_FPS * seconds) + 64, device)
    t_motion = time.perf_counter()
    prog = program(vertices, indices, settings, device)
    t_program = time.perf_counter()
    win = Window(prog, motion, device)
    start_frames = []
    for i in range(warmup):
        rgb = win.step()
        if i < START_FRAMES:
            start_frames.append(rgb)
        if i == START_FRAMES - 1:
            start_history = prog.history
    win.drain()
    setup_s = time.perf_counter() - t_process
    print(f"perfbench: set-up {setup_s:.3f} s: start {t_enter - t_process:.3f}, motion "
          f"{t_motion - t_enter:.3f}, program {t_program - t_motion:.3f}, warm-up "
          f"{setup_s - (t_program - t_process):.3f}", file=sys.stderr)

    # -- the window --
    win.sampler = Sampler(SAMPLES, seed)
    first = win.frame
    profiled = None
    opened = Marker(device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds or (trace and profiled is None):
        if trace and profiled is None and time.perf_counter() - t0 >= seconds / 2:
            profiled = profile_frames(win, PROFILED_FRAMES)
            continue
        win.step()
    win.drain()
    window_s = time.perf_counter() - t0
    frames = win.frame - first
    marks = [opened] + win.markers[first:]
    intervals = [b.ms_since(a) for a, b in zip(marks, marks[1:])]
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    samples = win.sampler.kept
    del prog, win, marks
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # -- the check --
    numbers, failed = check.run(vertices, indices, settings, motion, start_frames,
                                start_history, samples, device)
    # an infinite gap (a missing plane, a shape or counter that differs) as
    # the largest float, which JSON can carry
    checks = {name: {"value": min(numbers[name], sys.float_info.max), "limit": spec["limit"]}
              for name, spec in limits["numbers"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    result = {"correct": correct, "attempted": frames, "failed": failed}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
           "count": cell["chips"], "memory_peak_bytes": memory_peak}
    if not trace:
        values = {"frame_ms": window_s * 1e3 / frames, "frame_p95_ms": p95(intervals),
                  "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in registry.cell_metrics(bench, cell["name"], "end_to_end")}
    else:
        ctx = TraceContext(kernels=profiled["kernels"], device_events=profiled["device_events"],
                           host_spans=profiled["spans"], runtime_events=profiled["runtime"],
                           frames=profiled["frames"], window_us=profiled["wall_us"],
                           cfg=settings, device_kind=kind)
        result["metrics"] = {}
        for m in registry.cell_metrics(bench, cell["name"], "per_layer"):
            value = registry.metric_reader(m["name"], base)(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=tracefile.busy_us(profiled["device_events"]) * 1e-6,
                   window_s=profiled["wall_us"] * 1e-6)
        result["breakdown"] = {
            "device_ops": tracefile.device_ops(profiled["device_events"], profiled["frames"]),
            "idle_gaps": tracefile.idle_gaps(profiled["device_events"], profiled["spans"]),
        }
    result["device"] = dev
    result["checks"] = checks
    return result
