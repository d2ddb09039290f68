"""A/B of multi-resolution indirect light (cfg.indirect_split).

The JAX package's ``benchmarks/multires_ab.py`` on the port: the tracked
interactive rows (the 32,768- and 247,808-triangle subdivided Cornell
boxes, 1920x1080 at 1 spp, 8 bounces, Russian roulette from bounce 2,
adaptive alpha, the orbit camera) with the split off against several
(split, stride) points, each through Renderer.step() and
benchmarks/suite.bench_renderer (two warm-up frames, then ``--frames``
timed frames). Prints one JSON line per scene and variant; with
``--device-time``, the device's busy ms, launches and idle share a frame
beside the host ms. Usage:

    python -m real_time_path_tracing_with_spatiotemporal_filtering_torch.benchmarks.multires_ab
        [--splits 32,88] [--frames 3] [--variants base,s2x2,s2x4,s1x4]
        [--ramp] [--device-time] [--device cuda|cpu]

A variant is ``base`` (no split) or ``s<split>x<stride>``, with ``g``
appended for the G-buffer seed of bounce 0 (gbuffer_primary) and/or ``j``
for the per-frame grid phase (indirect_jitter), e.g. s1x4g or s1x4gj.
``--ramp`` uses the recommended temporal config (variance-guided SVGF, the
accumulation ramp in "normal" mode, adaptive alpha).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import real_time_path_tracing_with_spatiotemporal_filtering_torch as ptt
from real_time_path_tracing_with_spatiotemporal_filtering_torch.benchmarks.suite import (
    bench_renderer,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import procedural
from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils import device as dev_mod


def variant_cfg(base, variant: str):
    """The config of ``variant`` over ``base``."""
    name = variant
    flags = {}
    if name.endswith("j"):
        name, flags["indirect_jitter"] = name[:-1], True
    if name.endswith("g"):
        name, flags["gbuffer_primary"] = name[:-1], True
    if name != "base":
        split, stride = name.lstrip("s").split("x")
        flags.update(indirect_split=int(split), indirect_stride=int(stride))
    return dataclasses.replace(base, **flags)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--splits", default="32,88",
                   help="subdivided-Cornell splits (32 -> 32,768 tris; 88 -> 247,808)")
    p.add_argument("--frames", type=int, default=3)
    p.add_argument("--variants", default="base,s2x2,s2x4,s1x4")
    p.add_argument("--ramp", action="store_true")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--device-time", action="store_true")
    p.add_argument("--device", default=None, help="cuda (default) or cpu (plain versions)")
    args = p.parse_args(argv)
    dev = dev_mod.resolve(args.device)
    base = ptt.RenderConfig(
        width=args.width, height=args.height, max_bounces=8, rr_start_bounce=2,
        adaptive_alpha=True, variance_guided=args.ramp, accumulation_ramp=args.ramp,
        ramp_reset_mode="normal" if args.ramp else "id",
    )

    def orbit(r, i):
        r.camera = ptt.Camera.orbit([0.0, 1.0, 0.0], 6.0, 0.01 * i, 1.0, device=dev)

    for splits in (int(s) for s in args.splits.split(",")):
        scene = ptt.Scene.from_arrays(*procedural.subdivided_cornell(splits))
        td = ptt.precompute_triangle_data(scene, dev)
        print(f"# device: {dev_mod.device_name(dev)}  tris={scene.num_triangles} "
              f"frames={args.frames}", file=sys.stderr, flush=True)
        for variant in args.variants.split(","):
            cfg = variant_cfg(base, variant)
            result = bench_renderer(lambda: ptt.Renderer(scene, cfg, device=dev, tri_data=td),
                                    args.frames, orbit, args.device_time)
            print(json.dumps({
                "metric": f"ms/frame, interactive {scene.num_triangles}tris {variant}",
                "value": result["ms"], "unit": "ms/frame", "size": [cfg.width, cfg.height],
                **{k: v for k, v in result.items() if k != "ms"},
            }), flush=True)
            print(f"{variant:8s} {result['ms']:9.1f} ms/frame", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
