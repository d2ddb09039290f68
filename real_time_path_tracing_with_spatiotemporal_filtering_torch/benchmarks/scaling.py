"""Scene-size scaling probe: per-pass ms at 1080p across triangle counts.

The JAX package's ``benchmarks/scaling.py`` on the port. For each size, the
subdivided Cornell box nearest it; the geometry pass and the path-trace
pass apart, and the whole frame, each through the route pipeline/frame.py
picks (the dense kernels below ops/intersect.BVH_MIN_TRIANGLES, the LBVH
kernels and the segment tracer from there). Prints one JSON line per size:
host ms of each (the mean of ``--frames`` calls after one warm-up, synced
at the end) and, on the card, the device's busy ms and launches of each
from a ``torch.profiler`` window of as many calls
(utils/profiling.device_time). Usage:

    python -m real_time_path_tracing_with_spatiotemporal_filtering_torch.benchmarks.scaling
        [--sizes 2048,8192,32768] [--frames 3] [--width 1920] [--height 1080]
        [--rr-start-bounce 0] [--device cuda|cpu]

The TPU package's knobs of its streamed traversal (--hdr-lanes, --tile-w,
--sort-mode, --wavefront) have no counterpart: the port's LBVH walks have
no tiles, headers or sort.
"""

from __future__ import annotations

import argparse
import json
import time

import real_time_path_tracing_with_spatiotemporal_filtering_torch as ptt
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import intersect
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import (
    geometry as cuda_geometry,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline import frame as frame_mod
from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import procedural
from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils import device as dev_mod
from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils import profiling


def time_pass(fn, frames: int, on_card: bool) -> dict:
    """Host ms of a call of ``fn`` (mean over ``frames`` after one warm-up),
    and on the card the device's busy ms and launches a call."""
    profiling.sync(fn())
    t0 = time.perf_counter()
    out = None
    for _ in range(frames):
        out = fn()
    profiling.sync(out)
    result = {"ms": (time.perf_counter() - t0) / frames * 1000.0}
    if on_card:
        result.update(profiling.device_time(profiling.profiled_kernels(fn, frames), frames))
    return result


def measure(target: int, cfg, frames: int, dev) -> dict:
    """One size's line: the nearest subdivided Cornell box (32 s^2
    triangles), its route and the three timings."""
    splits = max(1, int(round((target / 32) ** 0.5)))
    scene = ptt.Scene.from_arrays(*procedural.subdivided_cornell(splits))
    t0 = time.perf_counter()
    td = ptt.precompute_triangle_data(scene, dev)
    profiling.sync(td.lut)
    prep_ms = (time.perf_counter() - t0) * 1000.0
    cam, light = ptt.Camera.default(dev), ptt.Light.default(dev)
    view, proj = frame_mod.camera_matrices(cam, cfg)
    large = intersect.uses_bvh(td)
    geometry_pass = cuda_geometry.geometry_pass_bvh if large else cuda_geometry.geometry_pass
    kernels = frame_mod.use_kernels(cfg, dev)
    on_card = dev.type == "cuda"

    def geometry():
        return geometry_pass(td, td.lut, cam.position, cam.rotation, light.position,
                             light.position, light.color, light.color, view, proj, view, proj,
                             cfg).visibility

    def trace():
        return frame_mod.trace_noisy(td, cam, light, 1, cfg, kernels)

    r = ptt.Renderer(scene, cfg, device=dev, tri_data=td)
    return {
        "tris": scene.num_triangles, "route": "lbvh" if large else "dense",
        "size": [cfg.width, cfg.height], "prep_ms": prep_ms,
        "geometry": time_pass(geometry, frames, on_card),
        "trace": time_pass(trace, frames, on_card),
        "frame": time_pass(r.step, frames, on_card),
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sizes", default="2048,8192,32768")
    p.add_argument("--frames", type=int, default=3)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--rr-start-bounce", type=int, default=0,
                   help="Russian roulette from this bounce (non-parity)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu (plain versions)")
    args = p.parse_args(argv)
    dev = dev_mod.resolve(args.device)
    cfg = ptt.RenderConfig(width=args.width, height=args.height,
                           rr_start_bounce=args.rr_start_bounce)
    print(f"# device: {dev_mod.device_name(dev)}", flush=True)
    for size in args.sizes.split(","):
        print(json.dumps(measure(int(size), cfg, args.frames, dev)), flush=True)


if __name__ == "__main__":
    main()
