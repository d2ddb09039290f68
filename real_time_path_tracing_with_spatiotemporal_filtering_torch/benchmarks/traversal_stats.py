"""Traversal counters of the segment tracer, per segment and in total.

The JAX package's ``benchmarks/traversal_stats.py`` on the port, with the
port's own counters in place of the TPU kernel's (its clusters, row phases
and sub-blocks do not exist here): one 1-spp trace of the frame by
segments, each launched by ops/cuda/wavefront.SegmentLaunches with its
counting instantiation (ops/cuda/geometry.WalkCounts and the ``lanes``
sums, as kernel_time.py and chip_smoke.py read them), on the live lists
the host loop uses. For each segment: the live rays it ran, the box tests
and triangle tests a live ray, and the lane efficiency of the kernel's
loop over rays and of its walks (lanes doing work over 32 x warp steps);
then the totals. Prints one JSON line per segment and one for the total.
On the CPU (``--device cpu``) the plain version runs and counts nothing:
the live rays are printed, the kernel counters as null. Usage:

    python -m real_time_path_tracing_with_spatiotemporal_filtering_torch.benchmarks.traversal_stats
        [--tris 32768] [--width 1920] [--height 1080] [--segments 32]
        [--rr-start-bounce 0] [--soup] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

import torch

import real_time_path_tracing_with_spatiotemporal_filtering_torch as ptt
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import (
    geometry as cuda_geometry,
    wavefront as wf,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import procedural
from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils import device as dev_mod


def lane_efficiency(lanes) -> dict:
    """The segment kernel's two lane shares from its four lane sums: the
    loop over rays (lanes with a ray over 32 x warp steps) and the walks
    (lanes stepping over 32 x walk steps)."""
    a, b, c, d = (int(v) for v in lanes.tolist())
    return {"ray_loop": a / max(32 * b, 1), "walks": c / max(32 * d, 1)}


def segment_line(seg, live: int, counts, lanes) -> dict:
    """A segment's (or the total's) line from its counters (None: not
    counted)."""
    line = {"segment": seg, "live_rays": live}
    if counts is None:
        return dict(line, box_tests_per_ray=None, tri_tests_per_ray=None, lane_eff=None)
    tri, box = (int(t.sum(dtype=torch.int64).item()) for t in counts.tests)
    return dict(line, box_tests_per_ray=box / max(live, 1), tri_tests_per_ray=tri / max(live, 1),
                lane_eff=lane_efficiency(lanes))


def scene_of(tris: int, soup: bool):
    """The subdivided Cornell box nearest ``tris`` (32 s^2 triangles), or a
    random volumetric soup of ``tris`` (the worst case: geometry fills the
    volume)."""
    if soup:
        return ptt.Scene.from_arrays(*procedural.random_soup(tris, seed=3, extent=2.0))
    splits = max(1, int(round((tris / 32) ** 0.5)))
    return ptt.Scene.from_arrays(*procedural.subdivided_cornell(splits))


def run(td, cfg, dev) -> list[dict]:
    """The per-segment lines and the total's of one 1-spp frame, frame
    index 1, under the default camera and light."""
    cam, light = ptt.Camera.default(dev), ptt.Light.default(dev)
    n = cfg.width * cfg.height
    rays = wf.RayState.empty(n, dev)
    on_card = dev.type == "cuda"
    lists = wf.LiveLists(n, dev) if on_card else None
    total_counts = cuda_geometry.WalkCounts.zeros(n, td) if on_card else None
    total_lanes = torch.zeros(4, dtype=torch.int64, device=dev)
    lines, total_live = [], 0
    for seg in range(cfg.max_bounces):
        live = n if seg == 0 else int(rays.alive.sum(dtype=torch.int64).item())
        if live == 0:
            break
        counts = lanes = None
        if on_card:
            counts = cuda_geometry.WalkCounts.zeros(n, td)
            lanes = torch.zeros(4, dtype=torch.int64, device=dev)
        wf.trace_segment(rays, seg, 0, 0, td, cam.position, cam.rotation, light, 1, cfg,
                         counts=counts, first=seg == 0, lists=lists, lanes=lanes)
        if on_card:
            for acc, part in zip(total_counts, counts):
                acc += part
            total_lanes += lanes
        total_live += live
        lines.append(segment_line(seg, live, counts, lanes))
    lines.append(segment_line("total", total_live, total_counts, total_lanes))
    return lines


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tris", type=int, default=32768)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--segments", type=int, default=32)
    p.add_argument("--rr-start-bounce", type=int, default=0)
    p.add_argument("--soup", action="store_true")
    p.add_argument("--device", default=None, help="cuda (default) or cpu (plain versions)")
    args = p.parse_args(argv)
    dev = dev_mod.resolve(args.device)
    scene = scene_of(args.tris, args.soup)
    td = ptt.precompute_triangle_data(scene, dev)
    cfg = ptt.RenderConfig(width=args.width, height=args.height, max_bounces=args.segments,
                           rr_start_bounce=args.rr_start_bounce)
    print(f"# device: {dev_mod.device_name(dev)}  tris={scene.num_triangles} "
          f"{cfg.width}x{cfg.height} segments={cfg.max_bounces}", flush=True)
    for line in run(td, cfg, dev):
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
