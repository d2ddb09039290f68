#!/usr/bin/env python3
"""Where the time of a frame goes, on one CUDA card.

    python3 frame_profile.py [--configs default,default_1080p,quality,interactive,
                                        stress32,stress88,stress32c,recommended32,
                                        pathgrad512,moved_1080p,stress32m]
                             [--out frame_profiles]

For each configuration, renders 5 warm-up frames through
``Renderer.step()`` on the kernel route, times 20 frames with the host
clock (the last one synchronised), then profiles 20 more with
``torch.profiler`` and reads the device's kernels from the exported trace.
Prints one line per configuration with ms/frame (host clock, unprofiled and
profiled), the device's busy time per frame (the union of its kernel
intervals) and kernel launches per frame (``utils/profiling.device_time``),
its idle share, each kernel's device ms and launches per
frame, and, for a kernel launched several times a frame, its mean device us
at each position in the frame. The static camera and light leave every frame's work the same.
The plain PyTorch parts of the path gradient and the multi-res split
(``ops/pathgrad.path_gradient_pass`` with its ``box3_filter`` passes, and
``ops/multires.combine_planes``) run inside ``torch.profiler`` ranges during
the profiled frames, and the kernels they launch are reported per range.
Exits non-zero if a configuration fails to run.

Configurations: ``default`` is ``RenderConfig()`` (1000x800), and
``default_1080p`` the same at 1920x1080; ``quality`` and ``interactive`` are
the ``cornell_box_quality`` and ``cornell_box_interactive`` presets
(1920x1080). ``stress32`` and ``stress88`` are the large scenes of
``presets.cornell_stress`` at 1920x1080 seen by the orbit camera at azimuth
0: 32,768 triangles with 8 bounces, Russian roulette from bounce 2 and
adaptive alpha, and 247,808 triangles in the default parity config;
``stress32c`` is ``stress32`` with the G-buffer seed and NEE (path C).
``recommended32`` is the JAX suite's row 4c'' (``stress32`` with multi-res
indirect at split 1 and stride 4, the G-buffer seed, grid jitter,
variance-guided SVGF and the ramp in "normal" mode) and ``pathgrad512`` its
row 2e (the Cornell box at 512x512 with variance-guided SVGF, the ramp and
the path gradient). ``moved_1080p`` and ``stress32m`` are ``default_1080p``
and ``stress32`` with the scene moved every frame by ``Renderer.set_model``
through the four poses of chip_smoke.py's paths M and MA in turn (0.08 to
0.32 rad about the vertical axis through (0, 1, 0); the matrices placed on
the card before the frames), so that each frame's work stays close to its
unmoved twin's.
"""

from __future__ import annotations

import argparse
import collections
import itertools
import json
import os
import sys
import time

from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils.device import card_line
from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils.profiling import (
    annotated,
    device_time,
    kernel_events,
    kernel_name,
    range_kernels,
    read_events,
)

FRAMES = 20
WARMUP = 5
# large scenes: (splits, config overrides)
INTERACTIVE = dict(max_bounces=8, rr_start_bounce=2, adaptive_alpha=True)
STRESS = {
    "stress32": (32, INTERACTIVE),
    "stress88": (88, {}),
    "stress32c": (32, dict(INTERACTIVE, gbuffer_primary=True, nee=True)),
    "recommended32": (32, dict(INTERACTIVE, indirect_split=1, indirect_stride=4,
                               gbuffer_primary=True, indirect_jitter=True, variance_guided=True,
                               accumulation_ramp=True, ramp_reset_mode="normal")),
}
PATHGRAD512 = dict(width=512, height=512, variance_guided=True, accumulation_ramp=True,
                   path_gradient=True)
# moved scenes: the configuration each one moves
MOVED = {"moved_1080p": "default_1080p", "stress32m": "stress32"}
# plain PyTorch functions whose kernels are reported apart: (module, name)
RANGES = (("pathgrad", "path_gradient_pass"), ("pathgrad", "box3_filter"),
          ("multires", "combine_planes"))


def _renderer(pt, name: str):
    if name in ("default", "default_1080p"):
        size = {} if name == "default" else dict(width=1920, height=1080)
        return pt.Renderer(pt.Scene.cornell_box(), pt.RenderConfig(**size))
    if name == "pathgrad512":
        return pt.Renderer(pt.Scene.cornell_box(), pt.RenderConfig(**PATHGRAD512))
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.models import presets

    if name in STRESS:
        splits, overrides = STRESS[name]
        r = presets.cornell_stress(splits=splits, **overrides)
        r.camera = pt.Camera.orbit([0.0, 1.0, 0.0], 6.0, 0.0, 1.0, device=r.device)
        return r
    return getattr(presets, f"cornell_box_{name}")()


def _annotated_ranges():
    """The RANGES functions inside profiler ranges of their names."""
    from real_time_path_tracing_with_spatiotemporal_filtering_torch import ops

    return annotated([(getattr(ops, mod), name, name) for mod, name in RANGES])


def _stepper(r, name: str):
    """A frame of ``r``: step(), under a moved configuration after setting
    the next of the four poses' model matrices (made on the card up front)."""
    import torch

    if name not in MOVED:
        return r.step
    from chip_smoke import MODEL_STEP, model_rotation

    poses = itertools.cycle([torch.tensor(model_rotation(MODEL_STEP * (i + 1)), device=r.device)
                             for i in range(4)])

    def step():
        r.set_model(next(poses))
        return r.step()

    return step


def profile(pt, name: str, out: str) -> dict:
    import torch

    r = _renderer(pt, MOVED.get(name, name))
    step = _stepper(r, name)
    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FRAMES):
        step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / FRAMES

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with _annotated_ranges(), torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(FRAMES):
            step()
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0) / FRAMES
    path = os.path.join(out, f"frame_profile_{name}.json")
    prof.export_chrome_trace(path)
    events = read_events(path)
    kernels = kernel_events(events)
    busy = device_time(kernels, FRAMES)
    busy_ms = busy["device_ms"]
    ranges = {}
    for _, label in RANGES:
        inside = range_kernels(events, label)
        if inside:
            ranges[label] = dict(_per_kernel(inside),
                                 ms=sum(e["dur"] for e in inside) / 1e3 / FRAMES,
                                 launches_per_frame=len(inside) / FRAMES)
    return dict(
        config=name, width=r.cfg.width, height=r.cfg.height, frames=FRAMES,
        ms_per_frame=wall_ms, ms_per_frame_profiled=prof_ms, device_busy_ms=busy_ms,
        launches_per_frame=busy["launches"], idle_share=1.0 - busy_ms / prof_ms,
        kernels=_per_kernel(kernels)["kernels"],
        us_by_launch=_by_launch(kernels), plain_ranges=ranges,
    )


def _by_launch(kernels) -> dict:
    """For each kernel launched several times a frame, its mean device us
    at each position in the frame (the segment tracer's segments in order)."""
    per_name = collections.defaultdict(list)
    for e in sorted(kernels, key=lambda e: e["ts"]):
        per_name[kernel_name(e)].append(e["dur"])
    out = {}
    for name, durs in per_name.items():
        per = len(durs) // FRAMES
        if per > 1 and per * FRAMES == len(durs):
            out[name] = [sum(durs[f * per + k] for f in range(FRAMES)) / FRAMES
                         for k in range(per)]
    return out


def _per_kernel(kernels) -> dict:
    """Device ms and launches per frame of each kernel name, largest first."""
    per_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        per_name[kernel_name(e)][0] += e["dur"] / 1e3 / FRAMES
        per_name[kernel_name(e)][1] += 1
    return dict(kernels={k: dict(ms=v[0], launches_per_frame=v[1] / FRAMES)
                         for k, v in sorted(per_name.items(), key=lambda kv: -kv[1][0])})


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--configs",
                        default="default,default_1080p,quality,interactive,stress32,stress88,"
                                "stress32c,recommended32,pathgrad512,moved_1080p,stress32m")
    parser.add_argument("--out", default="frame_profiles")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("frame_profile: no CUDA device", file=sys.stderr)
        return 1
    import real_time_path_tracing_with_spatiotemporal_filtering_torch as pt

    os.makedirs(args.out, exist_ok=True)
    card = card_line()
    print(card)
    for name in args.configs.split(","):
        print(json.dumps(dict(profile(pt, name, args.out), card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
