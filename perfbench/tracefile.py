"""Arithmetic on a ``torch.profiler`` Chrome trace, apart from the program.

Copied from the measured package's ``utils/profiling`` (``kernel_events``,
``kernel_name``, ``busy_us``), with the idle gaps and the breakdown the
benchmark prints. Times are the trace's microseconds.
"""

from __future__ import annotations

import collections
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def read_events(path: str) -> list[dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def kernel_events(events) -> list[dict]:
    """The device's kernels among ``events`` (``ts``, ``dur``, ``name``)."""
    return [e for e in events if str(e.get("cat", "")).lower() == "kernel"]


def device_events(events) -> list[dict]:
    """Every operation that ran on the device: kernels, copies, fills."""
    return [e for e in events if str(e.get("cat", "")).lower() in DEVICE_CATS]


def runtime_events(events) -> list[dict]:
    """The host's CUDA runtime calls (launches, copies, synchronisations),
    each on the host's timeline."""
    return [e for e in events if str(e.get("cat", "")).lower() == "cuda_runtime"]


def host_spans(events) -> list[dict]:
    """The harness's own spans (``torch.profiler.record_function``)."""
    return [e for e in events if e.get("cat") == "user_annotation"]


def kernel_name(e) -> str:
    """A kernel's function name without namespace, template arguments or
    parameters (``trace_segment_kernel``); a copy or fill keeps its name."""
    key = e["name"].replace("(anonymous namespace)::", "").replace("void ", "")
    return key.split("(")[0].split("<")[0].split("::")[-1]


def intervals(events) -> list[tuple[float, float]]:
    """The union of the events' intervals, as sorted disjoint (start, end)."""
    merged: list[list[float]] = []
    for e in sorted(events, key=lambda e: e["ts"]):
        start, stop = e["ts"], e["ts"] + e["dur"]
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], stop)
        else:
            merged.append([start, stop])
    return [(a, b) for a, b in merged]


def overlap_us(spans, events) -> float:
    """Microseconds of ``events`` that fall inside ``spans``."""
    total = 0.0
    for e in events:
        for s in spans:
            total += max(0.0, min(e["ts"] + e["dur"], s["ts"] + s["dur"]) - max(e["ts"], s["ts"]))
    return total


def busy_us(events) -> float:
    """Length of the union of the events' intervals."""
    return sum(b - a for a, b in intervals(events))


def idle_gaps(events, spans, top: int = 10) -> list[list]:
    """The ``top`` longest gaps between the device's busy intervals, each
    as [the span the host was in for most of the gap, seconds]."""
    busy = intervals(events)
    gaps = [(b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:]) if a1 > b0]
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    out = []
    for g0, g1 in gaps[:top]:
        best, label = 0.0, "other"
        for s in spans:
            overlap = min(g1, s["ts"] + s["dur"]) - max(g0, s["ts"])
            if overlap > best:
                best, label = overlap, s["name"]
        out.append([label, (g1 - g0) * 1e-6])
    return out


def device_ops(events, frames: int, top: int = 10) -> list[list]:
    """The ``top`` device operations by seconds a frame: [name, seconds]."""
    per = collections.Counter()
    for e in events:
        per[kernel_name(e)] += e["dur"]
    return [[name, us * 1e-6 / frames] for name, us in per.most_common(top)]
