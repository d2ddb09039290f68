#!/usr/bin/env python3
"""Where the time of a frame goes, on one CUDA card.

    python3 frame_profile.py [--configs default,default_1080p,quality,interactive,
                                        stress32,stress88]
                             [--out frame_profiles]

For each configuration, renders 5 warm-up frames through
``Renderer.step()`` on the kernel route, times 20 frames with the host
clock (the last one synchronised), then profiles 20 more with
``torch.profiler`` and reads the device's kernels from the exported trace.
Prints one line per configuration with ms/frame (host clock, unprofiled and
profiled), the device's busy time per frame (the union of its kernel
intervals), its idle share, and each kernel's device ms and launches per
frame. The static camera and light leave every frame's work the same.
Exits non-zero if a configuration fails to run.

Configurations: ``default`` is ``RenderConfig()`` (1000x800), and
``default_1080p`` the same at 1920x1080; ``quality`` and ``interactive`` are
the ``cornell_box_quality`` and ``cornell_box_interactive`` presets
(1920x1080). ``stress32`` and ``stress88`` are the large scenes of
``presets.cornell_stress`` at 1920x1080 seen by the orbit camera at azimuth
0: 32,768 triangles with 8 bounces, Russian roulette from bounce 2 and
adaptive alpha, and 247,808 triangles in the default parity config.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

FRAMES = 20
WARMUP = 5
# large scenes: (splits, config overrides)
STRESS = {
    "stress32": (32, dict(max_bounces=8, rr_start_bounce=2, adaptive_alpha=True)),
    "stress88": (88, {}),
}


def _renderer(pt, name: str):
    if name in ("default", "default_1080p"):
        size = {} if name == "default" else dict(width=1920, height=1080)
        return pt.Renderer(pt.Scene.cornell_box(), pt.RenderConfig(**size))
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.models import presets

    if name in STRESS:
        splits, overrides = STRESS[name]
        r = presets.cornell_stress(splits=splits, **overrides)
        r.camera = pt.Camera.orbit([0.0, 1.0, 0.0], 6.0, 0.0, 1.0, device=r.device)
        return r
    return getattr(presets, f"cornell_box_{name}")()


def _kernels(trace_path: str):
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if str(e.get("cat", "")).lower() == "kernel"]


def _busy_us(kernels) -> float:
    """Length of the union of the kernel intervals."""
    busy, end = 0.0, float("-inf")
    for e in sorted(kernels, key=lambda e: e["ts"]):
        start, stop = e["ts"], e["ts"] + e["dur"]
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def profile(pt, name: str, out: str) -> dict:
    import torch

    r = _renderer(pt, name)
    for _ in range(WARMUP):
        r.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FRAMES):
        r.step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / FRAMES

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(FRAMES):
            r.step()
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0) / FRAMES
    path = os.path.join(out, f"frame_profile_{name}.json")
    prof.export_chrome_trace(path)
    kernels = _kernels(path)
    per_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        key = e["name"].replace("(anonymous namespace)::", "").replace("void ", "")
        key = key.split("(")[0].split("<")[0].split("::")[-1]
        per_name[key][0] += e["dur"] / 1e3 / FRAMES
        per_name[key][1] += 1
    busy_ms = _busy_us(kernels) / 1e3 / FRAMES
    return dict(
        config=name, width=r.cfg.width, height=r.cfg.height, frames=FRAMES,
        ms_per_frame=wall_ms, ms_per_frame_profiled=prof_ms, device_busy_ms=busy_ms,
        idle_share=1.0 - busy_ms / prof_ms,
        kernels={k: dict(ms=v[0], launches_per_frame=v[1] / FRAMES)
                 for k, v in sorted(per_name.items(), key=lambda kv: -kv[1][0])},
    )


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--configs",
                        default="default,default_1080p,quality,interactive,stress32,stress88")
    parser.add_argument("--out", default="frame_profiles")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("frame_profile: no CUDA device", file=sys.stderr)
        return 1
    import real_time_path_tracing_with_spatiotemporal_filtering_torch as pt

    os.makedirs(args.out, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    for name in args.configs.split(","):
        print(json.dumps(dict(profile(pt, name, args.out), card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
