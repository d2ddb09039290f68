#!/usr/bin/env python3
"""Host time of the segment tracer's launches on path E's re-trace (one CUDA card).

    python3 segment_host_time.py [--tree DIR] [--paths 32] [--reps 3]

Path E (``chip_smoke.py``; the JAX suite's row 2e) re-traces the 171x171
stratum pixels of a 512x512 frame of the Cornell box with the segment
tracer every frame: 29,241 rays and 32 segments (the parity config). For
the package found in ``DIR`` (default: this script's directory, so that an
unpacked copy of another tree can be measured by the same script), this
times on the host clock:

- the segment launches: ``--paths`` paths of 32 launches each, made as
  the host loop makes them (through ``SegmentLaunches``, one per path,
  where the tree has it; else one ``trace_segment`` call a launch): the
  time to issue them (before the synchronisation) and the time until the
  card has run them, in us per launch;
- ``trace_pixels_wavefront``: the whole re-trace (its 32 launches and the
  plain PyTorch work around them), issued and in all, in us per call.

While the card keeps up with the host, the time to issue is the host's cost
of a launch. Prints the card's name and power limit and one JSON line per
repetition.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)))
    parser.add_argument("--paths", type=int, default=32)
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch

    if not torch.cuda.is_available():
        print("segment_host_time: no CUDA device", file=sys.stderr)
        return 1
    import real_time_path_tracing_with_spatiotemporal_filtering_torch as pt
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import pathgrad
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import (
        wavefront as wf,
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")
    cfg = pt.RenderConfig(width=512, height=512, variance_guided=True, accumulation_ramp=True,
                          path_gradient=True)
    td = pt.precompute_triangle_data(pt.Scene.cornell_box(), dev)
    cam, light = pt.Camera.default(dev), pt.Light.default(dev)
    frame_idx = 5
    gy, gx = pathgrad.stratum_pixels(cfg.height, cfg.width, frame_idx, cfg.gradient_stratum, dev)
    pixels = tuple(t.reshape(-1).to(torch.int32).contiguous() for t in (gx, gy))
    n = pixels[0].numel()
    rays = wf.RayState.empty(n, dev)
    prepared = hasattr(wf, "SegmentLaunches")
    segs = cfg.max_bounces

    def paths(count: int) -> None:
        for _ in range(count):
            if prepared:
                launch = wf.SegmentLaunches(rays, td, cam.position, cam.rotation, light,
                                            frame_idx, cfg, None, pixels)
                for seg in range(segs):
                    launch(seg, 0, 0, seg == 0)
            else:
                for seg in range(segs):
                    wf.trace_segment(rays, seg, 0, 0, td, cam.position, cam.rotation, light,
                                     frame_idx, cfg, None, pixels)

    def retraces(count: int) -> None:
        for _ in range(count):
            wf.trace_pixels_wavefront(td, cam.position, light, frame_idx, gx, gy, cfg,
                                      cam.rotation)

    def timed(fn, count: int) -> tuple:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(count)
        issued = time.perf_counter() - t0
        torch.cuda.synchronize()
        return issued, time.perf_counter() - t0

    paths(1)
    retraces(1)
    retrace_count = max(args.paths // 4, 1)
    for rep in range(args.reps):
        seg_issue, seg_all = timed(paths, args.paths)
        pix_issue, pix_all = timed(retraces, retrace_count)
        calls = args.paths * segs
        print(json.dumps(dict(
            tree=os.path.abspath(args.tree), rep=rep,
            launches_by="SegmentLaunches" if prepared else "trace_segment",
            rays=n, segments=segs, segment_launches=calls,
            segment_issue_us=1e6 * seg_issue / calls,
            segment_us=1e6 * seg_all / calls,
            trace_pixels_wavefront_calls=retrace_count,
            trace_pixels_wavefront_issue_us=1e6 * pix_issue / retrace_count,
            trace_pixels_wavefront_us=1e6 * pix_all / retrace_count,
            card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
