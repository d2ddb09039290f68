"""Minimal end-to-end render on the card: the reference's default scene and
settings, through the PyTorch port.

Equivalent of building and launching the reference app (main.cpp:179-308)
headlessly: Cornell Box, 1000x800, 1 spp, full A-SVGF denoising, 30 frames
of temporal accumulation, PNG out. Runs on the CUDA card; ``--device cpu``
runs the plain PyTorch versions instead.

Run:  python examples/render_cornell_torch.py [out.png] [--device cpu]
"""

import argparse

import real_time_path_tracing_with_spatiotemporal_filtering_torch as ptt
from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils.image import (
    write_png,
)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("out", nargs="?", default="cornell.png")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    renderer = ptt.Renderer(ptt.Scene.cornell_box(), ptt.RenderConfig(), device=args.device)
    rgb = renderer.render(num_frames=30)
    write_png(args.out, rgb)
    print(f"wrote {args.out} after {renderer.frame_count} frames")


if __name__ == "__main__":
    main()
