"""Where the segment tracer's time goes, from the program's spans.

The JAX package's ``benchmarks/wavefront_breakdown.py`` on the port. The
TPU script doubled each phase of its streamed traversal and read the
difference; here every phase is its own launch or host call, and the
segment tracer records each as a ``torch.profiler`` range of its own
(utils/profiling.span), which gives each phase's time directly: the
G-buffer seed of bounce 0 (``trace.seed``, ops/cuda/wavefront._seed_from_gbuffer,
under ``--primary``), the shadow segment it launches under NEE
(``trace.shadow``, a range inside the seed's), each ``trace_segment``
launch by segment (``trace.segment[k]``), and the epilogue
(``trace.radiance``, path_radiance), printed under the keys
``gbuffer_seed``, ``shadow_segment``, ``trace_segment[k]`` and
``path_radiance``. For each range: the device ms and launches of the
kernels launched inside it and the host ms spent in it, per frame
(utils/profiling.range_kernels);
and the frame's host ms unprofiled and profiled and the device's busy ms.
As the JAX script does, it checks that the profiled frame is bit-identical
to the unprofiled one. Prints one JSON line. Usage:

    python -m real_time_path_tracing_with_spatiotemporal_filtering_torch.benchmarks.wavefront_breakdown
        [--tris 32768] [--width 1920] [--height 1080] [--frames 3]
        [--segments 32] [--rr-start-bounce 0] [--primary] [--soup]
        [--device cuda|cpu]

On the CPU the plain versions run and the profiler sees no device: the
ranges' host ms are printed and their device fields are null.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

import real_time_path_tracing_with_spatiotemporal_filtering_torch as ptt
from real_time_path_tracing_with_spatiotemporal_filtering_torch.benchmarks.traversal_stats import (
    scene_of,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import intersect
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import (
    geometry as cuda_geometry,
    wavefront as wf,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline import frame as frame_mod
from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils import device as dev_mod
from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils import profiling


def ranges(cfg) -> dict[str, str]:
    """The segment tracer's span names by the key printed for each, in
    frame order."""
    out = {}
    if cfg.gbuffer_primary:
        out.update(gbuffer_seed="trace.seed", shadow_segment="trace.shadow")
    start = 1 if cfg.gbuffer_primary else 0
    out.update({f"trace_segment[{s}]": f"trace.segment[{s}]"
                for s in range(start, cfg.max_bounces)})
    out["path_radiance"] = "trace.radiance"
    return out


def breakdown(td, cfg, frames: int, dev) -> dict:
    """One line: the frame's times and each range's, per frame."""
    cam, light = ptt.Camera.default(dev), ptt.Light.default(dev)
    primary = None
    if cfg.gbuffer_primary:
        view, proj = frame_mod.camera_matrices(cam, cfg)
        geometry_pass = (cuda_geometry.geometry_pass_bvh if intersect.uses_bvh(td)
                         else cuda_geometry.geometry_pass)
        geo = geometry_pass(td, td.lut, cam.position, cam.rotation, light.position,
                            light.position, light.color, light.color, view, proj, view, proj,
                            cfg, emit_albedo=True)
        primary = (geo.visibility, geo.world_pos, geo.normal, geo.albedo)

    def trace():
        return wf.path_trace_wavefront(td, cam.position, light, 1, cfg, cam.rotation,
                                       primary=primary)

    base = trace()
    profiling.sync(base)
    t0 = time.perf_counter()
    for _ in range(frames):
        trace()
    profiling.sync()
    wall_ms = (time.perf_counter() - t0) / frames * 1000.0
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            t0 = time.perf_counter()
            for _ in range(frames):
                out = trace()
            profiling.sync(out)
            profiled_ms = (time.perf_counter() - t0) / frames * 1000.0
        events = profiling.read_events(os.path.join(tmp, "trace.json"))
    identical = bool(torch.equal(out, base))
    on_card = dev.type == "cuda"
    kernels = profiling.kernel_events(events)
    phases = {}
    for key, label in ranges(cfg).items():
        inside = profiling.range_kernels(events, label)
        phases[key] = {
            "host_ms": profiling.range_host_us(events, label) / 1e3 / frames,
            "device_ms": sum(e["dur"] for e in inside) / 1e3 / frames if on_card else None,
            "launches": len(inside) / frames if on_card else None,
        }
    line = {"tris": td.num_triangles, "size": [cfg.width, cfg.height],
            "segments": cfg.max_bounces, "primary": cfg.gbuffer_primary, "nee": cfg.nee,
            "frames": frames, "ms": wall_ms, "ms_profiled": profiled_ms,
            "device_ms": profiling.device_time(kernels, frames)["device_ms"] if on_card else None,
            "profiled_frame_bit_identical": identical, "phases": phases}
    if on_card:  # the shadow segment's range lies inside the seed's
        line["device_ms_in_ranges"] = sum(p["device_ms"] for k, p in phases.items()
                                          if k != "shadow_segment")
    return line


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tris", type=int, default=32768)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--frames", type=int, default=3)
    p.add_argument("--segments", type=int, default=32)
    p.add_argument("--rr-start-bounce", type=int, default=0)
    p.add_argument("--primary", action="store_true",
                   help="bounce 0 off the G-buffer, with NEE (path C's seed)")
    p.add_argument("--soup", action="store_true")
    p.add_argument("--device", default=None, help="cuda (default) or cpu (plain versions)")
    args = p.parse_args(argv)
    dev = dev_mod.resolve(args.device)
    scene = scene_of(args.tris, args.soup)
    td = ptt.precompute_triangle_data(scene, dev)
    cfg = ptt.RenderConfig(width=args.width, height=args.height, max_bounces=args.segments,
                           rr_start_bounce=args.rr_start_bounce, gbuffer_primary=args.primary,
                           nee=args.primary)
    print(f"# device: {dev_mod.device_name(dev)}", flush=True)
    line = breakdown(td, cfg, args.frames, dev)
    print(json.dumps(line), flush=True)
    if not line["profiled_frame_bit_identical"]:
        raise SystemExit("the profiled frame differs from the unprofiled one")


if __name__ == "__main__":
    main()
