"""The measured program's stage spans in a profiled sub-window.

The program records a ``frame`` span a frame with one span a stage nested
in it (``frame.matrices``, ``frame.geometry``, ``frame.trace``, ...; the
measured package's ``utils/profiling.span``). From them and the trace's
runtime calls and device operations this module finds the calls inside the
frames that wait on the device, each stage's host time less those waits,
and where the host was when each of the device's idle gaps opened. Read by
``metrics/host_syncs_per_frame.py``, ``sync_idle_ms.py``,
``enqueue_idle_ms.py`` and the four ``<stage>_host_ms.py``. Each function
returns None where the trace holds no ``frame`` span (a program without
the spans). Times are the trace's microseconds, on the one clock that the
profiler gives host and device events.
"""

from __future__ import annotations

import collections

from perfbench import tracefile

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
COPIES = ("cudaMemcpy", "cudaMemcpyAsync")
# a copy call waits on the device where its copy is from pageable host memory
# (staged after the stream drains) or to the host
WAITING_COPY = ("Pageable", "DtoH")


def _end(e) -> float:
    return e["ts"] + e["dur"]


def _at(e, t: float) -> bool:
    return e["ts"] <= t <= _end(e)


def _inside(inner, outer) -> bool:
    return outer["ts"] <= inner["ts"] and _end(inner) <= _end(outer)


def frames(ctx) -> list[dict]:
    return [s for s in ctx.host_spans if s["name"] == "frame"]


def waits(ctx) -> list[dict] | None:
    """The runtime calls that start inside a ``frame`` span and wait on the
    device: the synchronisations, and the copies whose device copy (matched
    by ``args.correlation``) is from pageable memory or to the host."""
    spans = frames(ctx)
    if not spans:
        return None
    copies = {e["args"]["correlation"]: e["name"] for e in ctx.device_events
              if e.get("cat") == "gpu_memcpy" and "correlation" in e.get("args", {})}
    out = []
    for e in ctx.runtime_events:
        if not any(_at(f, e["ts"]) for f in spans):
            continue
        copy = copies.get(e.get("args", {}).get("correlation"), "")
        if e["name"] in SYNCS or (e["name"] in COPIES and any(k in copy for k in WAITING_COPY)):
            out.append(e)
    return out


def _less(span, cover) -> list[tuple[float, float]]:
    """``span``'s interval less the union of the intervals of ``cover``."""
    out, t = [], span["ts"]
    for a, b in tracefile.intervals(cover):
        a, b = max(a, t), min(b, _end(span))
        if b > a:
            if a > t:
                out.append((t, a))
            t = b
    if _end(span) > t:
        out.append((t, _end(span)))
    return out


def stage_host_ms(ctx, names, nested: bool = False) -> float | None:
    """Host ms a frame in the spans named ``names``: each span's self time
    (its time less the part the spans nested in it cover), or with
    ``nested`` its whole time, less the waits in it."""
    found = waits(ctx)
    if found is None:
        return None
    total = 0.0
    for s in ctx.host_spans:
        if s["name"] not in names:
            continue
        cover = [] if nested else [c for c in ctx.host_spans if c is not s and _inside(c, s)]
        for a, b in _less(s, cover):
            total += b - a - tracefile.overlap_us([{"ts": a, "dur": b - a}], found)
    return total / 1e3 / ctx.frames


def idle_gaps(ctx) -> list[tuple[float, float]]:
    """The device's idle gaps between its busy intervals, (start, end)."""
    busy = tracefile.intervals(ctx.device_events)
    return [(b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:]) if a1 > b0]


def idle_ms(ctx, kind: str) -> float | None:
    """Device idle ms a frame in the gaps that opened while the host was
    inside a wait (``kind`` "sync"), or inside a ``frame`` span and not in
    a wait ("enqueue"). Gaps that open elsewhere count for neither. None
    also where the device ran nothing (a CPU run)."""
    found = waits(ctx)
    if found is None or not ctx.device_events:
        return None
    spans = frames(ctx)
    total = 0.0
    for g0, g1 in idle_gaps(ctx):
        in_wait = any(_at(w, g0) for w in found)
        if (kind == "sync") == in_wait and (in_wait or any(_at(f, g0) for f in spans)):
            total += g1 - g0
    return total / 1e3 / ctx.frames


def idle_by_span(ctx) -> dict[str, float] | None:
    """Device idle ms a frame by the innermost span the host was in when
    each gap opened (``<span> wait`` inside a wait; ``none`` outside every
    span), and ``edges``: the sub-window's idle time before its first and
    after its last device operation, so that the values add up to the
    sub-window's idle time (``device_idle_share`` times its length)."""
    found = waits(ctx)
    if found is None or not ctx.device_events:
        return None
    out = collections.Counter()
    for g0, g1 in idle_gaps(ctx):
        around = [s for s in ctx.host_spans if _at(s, g0)]
        name = max(around, key=lambda s: (s["ts"], -s["dur"]))["name"] if around else "none"
        if any(_at(w, g0) for w in found):
            name += " wait"
        out[name] += (g1 - g0) / 1e3 / ctx.frames
    gaps_ms = sum(out.values())
    busy_ms = tracefile.busy_us(ctx.device_events) / 1e3 / ctx.frames
    out["edges"] = ctx.window_us / 1e3 / ctx.frames - busy_ms - gaps_ms
    return dict(out.most_common())
