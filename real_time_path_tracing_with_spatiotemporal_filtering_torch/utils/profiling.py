"""Profiling and timing harness.

The port's counterpart of the JAX package's ``utils/profiling.py``:
``sync``, ``time_fn``, ``trace`` and ``FrameTimer``, with CUDA events and
``torch.profiler`` in place of the TPU runtime's workarounds. It marks the
program's stages for a profiler (``span``) and reads a profiler trace: each
kernel's device interval (``kernel_events``), the device's busy time as the
union of those intervals and the launches per frame (``device_time``), and
the device time of each launch of named kernels (``kernel_launch_ms``),
which does not depend on the host's cost of making the launch.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import tempfile
import time
from typing import Callable

import torch


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def _device_of(tree) -> torch.device | None:
    """The device of the first tensor in ``tree``, or None if it holds none."""
    return next((t.device for t in _tensors(tree)), None)


def sync(tree=None) -> None:
    """Wait for the work that produces the tensors in ``tree`` (a tensor,
    or tuples, lists and dicts of them): a ``torch.cuda.synchronize`` of
    their card; nothing for CPU tensors. A ``tree`` without tensors
    synchronises the current card, if there is one."""
    dev = _device_of(tree)
    if dev is None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    elif dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2,
            pipelined: bool = True) -> float:
    """Milliseconds per call of ``fn(*args)``. On the card, CUDA events:
    ``pipelined`` records one pair around all the calls (throughput;
    launches overlap device work), otherwise one pair around each call,
    synchronised after it (latency). On the CPU, the host clock. The device
    is that of the first tensor in the warm-up's output, else in ``args``;
    where neither holds one (``fn`` returns None), the card if there is one."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    sync(out)
    dev = _device_of((out, args))
    on_card = dev.type == "cuda" if dev is not None else torch.cuda.is_available()
    if not on_card:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters * 1000.0
    if pipelined:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    total = 0.0
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (host and, where there is a card,
    device activity); the Chrome trace goes to ``log_dir/trace.json``
    (view it in Perfetto or chrome://tracing). Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


_NO_SPAN = contextlib.nullcontext()


def span(name: str, index=None):
    """A profiler range named ``name`` (``name[index]`` with an ``index``)
    around a stage of the program, while a profiler is recording; otherwise
    a shared no-op context, so that an unprofiled frame pays one flag read
    a span (``record_function`` costs ~10 us a span even with no profiler).
    The ranges stay in the profiler's memory; whoever holds the profiler
    exports them."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name if index is None else f"{name}[{index}]")


def read_events(trace_path: str) -> list[dict]:
    """The events of an exported Chrome trace."""
    with open(trace_path) as f:
        return json.load(f)["traceEvents"]


def kernel_events(events) -> list[dict]:
    """The device's kernels among ``events``: each has ``ts`` and ``dur``
    in microseconds and the kernel's ``name``."""
    return [e for e in events if str(e.get("cat", "")).lower() == "kernel"]


def kernel_name(e) -> str:
    """A kernel event's function name, without namespace, template
    arguments or parameters (``trace_segment_kernel``)."""
    key = e["name"].replace("(anonymous namespace)::", "").replace("void ", "")
    return key.split("(")[0].split("<")[0].split("::")[-1]


def range_kernels(events, label: str) -> list[dict]:
    """The kernels launched from the host inside the profiler ranges named
    ``label`` (the program's :func:`span`): the launch call (matched to its
    kernel by correlation id) starts inside the range."""
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == label]
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})
                and any(a <= e["ts"] <= b for a, b in spans)}
    return [e for e in kernel_events(events) if e.get("args", {}).get("correlation") in launched]


def range_host_us(events, label: str) -> float:
    """The host's microseconds inside the profiler ranges named ``label``."""
    return sum(e["dur"] for e in events
               if e.get("cat") == "user_annotation" and e.get("name") == label)


def busy_us(kernels) -> float:
    """Length of the union of the kernel intervals, in microseconds."""
    busy, end = 0.0, float("-inf")
    for e in sorted(kernels, key=lambda e: e["ts"]):
        start, stop = e["ts"], e["ts"] + e["dur"]
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def device_time(kernels, frames: int) -> dict:
    """Device-busy ms (the union of the kernel intervals) and kernel
    launches, each per frame, over ``frames`` frames' kernels."""
    return dict(device_ms=busy_us(kernels) / 1e3 / frames, launches=len(kernels) / frames)


# Windows of profiled_kernels that held no kernel and were taken again, since
# import. Callers that time with it report the count beside their numbers
# (the suite's ``profiler_windows``), so that a recurring dropout shows.
empty_windows = 0


def profiled_kernels(fn: Callable, calls: int, attempts: int = 3) -> list[dict]:
    """The kernel events of ``calls`` calls of ``fn()`` on the card, under
    ``torch.profiler`` (the trace goes through a temporary file). A window
    in which the profiler recorded no kernel at all is taken again, up to
    ``attempts`` windows in all, and counted in :data:`empty_windows` with a
    line on stderr: on the H100 one window in a run of chip_smoke.py came
    back empty while its frames launched kernels."""
    global empty_windows
    kernels: list[dict] = []
    for attempt in range(attempts):
        with tempfile.TemporaryDirectory() as tmp:
            with trace(tmp):
                for _ in range(calls):
                    fn()
            kernels = kernel_events(read_events(os.path.join(tmp, "trace.json")))
        if kernels or not torch.cuda.is_available():
            break
        empty_windows += 1
        print(f"profiled_kernels: window {attempt + 1} of {calls} calls of "
              f"{getattr(fn, '__qualname__', fn)} held no kernel", file=sys.stderr, flush=True)
    return kernels


def kernel_launch_ms(fn: Callable, calls: int = 20, warmup: int = 2) -> dict[str, list[float]]:
    """Device ms of each launch, by kernel name, over ``calls`` calls of
    ``fn()`` after ``warmup`` more: what each kernel took on the card,
    whatever the host spent around it."""
    for _ in range(warmup):
        fn()
    sync()
    per_name = collections.defaultdict(list)
    for e in sorted(profiled_kernels(fn, calls), key=lambda e: e["ts"]):
        per_name[kernel_name(e)].append(e["dur"] / 1e3)
    return dict(per_name)


class FrameTimer:
    """Rolling per-frame FPS/ms counter for interactive loops (the
    reference prints a line per frame, main.cpp:1112 -- this is the
    metrics-minded version)."""

    def __init__(self, window: int = 30):
        self.window = window
        self._times: list[float] = []
        self._last: float | None = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    @property
    def ms_per_frame(self) -> float:
        if not self._times:
            return float("nan")
        return sum(self._times) / len(self._times) * 1000.0

    @property
    def fps(self) -> float:
        ms = self.ms_per_frame
        return 1000.0 / ms if ms == ms and ms > 0 else float("nan")
