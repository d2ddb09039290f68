"""Render any OBJ scene on the card through the PyTorch port (the reference
hardcodes its scene path, main.cpp:417; here it is an argument).

Scenes of 128 triangles and more walk an LBVH through the segment tracer
(csrc/wavefront.cu); add --rr to bound path lengths (unbiased Russian
roulette, non-parity). Runs on the CUDA card; ``--device cpu`` runs the
plain PyTorch versions instead.

Run:  python examples/render_obj_torch.py scene.obj [out.png] [--rr] [--device cpu]
"""

import argparse

import real_time_path_tracing_with_spatiotemporal_filtering_torch as ptt
from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils.image import (
    write_png,
)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("scene", nargs="?", default=None, help="OBJ path (default: Cornell Box)")
    parser.add_argument("out", nargs="?", default="render.png")
    parser.add_argument("--rr", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    cfg = ptt.RenderConfig(width=1280, height=720, rr_start_bounce=4 if args.rr else 0)
    scene = ptt.Scene.from_arrays(*ptt.load_obj(args.scene))  # None = default scene
    renderer = ptt.Renderer(scene, cfg, device=args.device)
    rgb = renderer.render(num_frames=20)
    write_png(args.out, rgb)
    print(f"wrote {args.out}: {scene.num_triangles} triangles")


if __name__ == "__main__":
    main()
