"""Command-line renderer of the PyTorch port: the headless counterpart of
the reference app, on the card.

The reference's only interface is a GLFW window with WASD/IJKL keys
(main.cpp:1119-1168); on a headless host the equivalent surface is a
frame-sequence renderer with scripted camera/light motion and PNG output.
The flags, defaults and checks of ``cli.py`` (the JAX package's CLI), with
``--device`` in place of ``--cpu``: it runs on the card unless given
``--device cpu`` (the plain PyTorch versions).

Examples:
    python cli_torch.py --frames 30 --out /tmp/seq                 # static camera
    python cli_torch.py --frames 60 --orbit-light 0.1 --out /tmp/l # moving light
    python cli_torch.py --width 1920 --height 1080 --frames 10     # 1080p timing
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def parser() -> argparse.ArgumentParser:
    """The CLI's flags."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", default=None, help="OBJ path (default: Cornell Box)")
    p.add_argument("--width", type=int, default=1000)   # main.cpp:52
    p.add_argument("--height", type=int, default=800)   # main.cpp:53
    p.add_argument("--frames", type=int, default=10)
    p.add_argument("--spp", type=int, default=1)
    p.add_argument("--max-bounces", type=int, default=32)
    p.add_argument("--wavelet-iterations", type=int, default=9)
    p.add_argument("--variance-guided", action="store_true",
                   help="full SVGF: variance-normalized a-trous "
                        "weights (extension; off = reference parity)")
    p.add_argument("--adaptive-alpha", action="store_true",
                   help="enable gradient-driven adaptive EMA alpha")
    p.add_argument("--demodulate-albedo", action="store_true",
                   help="SVGF albedo demodulation: filter irradiance "
                        "(color / primary-hit albedo), re-modulate "
                        "for display (extension; off = parity)")
    p.add_argument("--accumulation-ramp", action="store_true",
                   help="SVGF accumulation ramp: per-pixel history "
                   "length drives alpha = max(ramp_alpha_min, 1/N), "
                   "gradient-reset (extension; off = parity)")
    p.add_argument("--nee", action="store_true",
                   help="next-event estimation: explicit light "
                   "sampling with shadow rays (non-parity; much "
                   "lower 1-spp noise, light respects occluders)")
    p.add_argument("--path-gradient", action="store_true",
                   help="A-SVGF path-space temporal gradient: "
                   "re-trace sparse previous-frame samples under the "
                   "current light, max()'d with the Phong proxy "
                   "(extension; needs --adaptive-alpha or "
                   "--accumulation-ramp)")
    p.add_argument("--rr-start-bounce", type=int, default=0,
                   help="Russian roulette from this bounce on "
                   "(0 = off/reference parity; unbiased early "
                   "termination, big win on enclosed scenes)")
    p.add_argument("--no-light-quirk", action="store_true",
                   help="make the sphere light respect occluders")
    p.add_argument("--indirect-split", type=int, default=0,
                   help="multi-resolution indirect: trace bounces "
                   ">= this index on a subsampled grid and upsample "
                   "with G-buffer guidance (non-parity; 0 = off)")
    p.add_argument("--indirect-stride", type=int, default=2,
                   help="coarse-grid stride of --indirect-split "
                   "(2 -> 1/4 of the indirect rays)")
    p.add_argument("--indirect-jitter", action="store_true",
                   help="rotate the coarse grid's phase per frame "
                   "(interleaved sampling: the temporal EMA "
                   "integrates over phases, shrinking the split's "
                   "low-pass bias; needs width/height divisible by "
                   "the stride)")
    p.add_argument("--gbuffer-primary", action="store_true",
                   help="seed bounce 0 from the G-buffer instead of "
                   "re-tracing it (non-parity: disables primary AA "
                   "jitter; deletes the full-res bounce-0 traversal)")
    p.add_argument("--ramp-reset-mode", choices=("id", "normal"),
                   default="id",
                   help="ramp history-rejection test: exact primitive "
                   "ids or quantized surface normals ('normal' keeps "
                   "accumulation on tessellated geometry in motion)")
    p.add_argument("--firefly-clamp", type=float, default=0.0,
                   help="clamp noisy HDR radiance before filtering "
                   "(0 = off/parity; 1-4 kills light-crossing "
                   "fireflies, recommended with --indirect-split)")
    p.add_argument("--out", default=None, help="output dir for PNG frames")
    p.add_argument("--save-every", type=int, default=1)
    p.add_argument("--move-camera", type=float, nargs=3, default=None,
                   metavar=("DX", "DY", "DZ"), help="per-frame camera delta")
    p.add_argument("--orbit-camera", type=float, default=0.0,
                   help="per-frame orbit azimuth delta in radians "
                        "(extension: the reference camera never rotates)")
    p.add_argument("--orbit-light", type=float, default=0.0,
                   help="per-frame light x delta (wraps like the reference)")
    p.add_argument("--checkpoint", default=None, help="state .npz to save at end")
    p.add_argument("--resume", default=None, help="state .npz to load at start")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch versions)")
    return p


def build_config(args):
    """The RenderConfig of parsed flags."""
    import real_time_path_tracing_with_spatiotemporal_filtering_torch as ptt

    return ptt.RenderConfig(
        width=args.width,
        height=args.height,
        spp=args.spp,
        max_bounces=args.max_bounces,
        wavelet_iterations=args.wavelet_iterations,
        adaptive_alpha=args.adaptive_alpha,
        variance_guided=args.variance_guided,
        demodulate_albedo=args.demodulate_albedo,
        accumulation_ramp=args.accumulation_ramp,
        light_through_walls=not args.no_light_quirk,
        rr_start_bounce=args.rr_start_bounce,
        nee=args.nee,
        path_gradient=args.path_gradient,
        indirect_split=args.indirect_split,
        indirect_stride=args.indirect_stride,
        indirect_jitter=args.indirect_jitter,
        gbuffer_primary=args.gbuffer_primary,
        ramp_reset_mode=args.ramp_reset_mode,
        firefly_clamp=args.firefly_clamp,
    )


def main(argv=None):
    """Parse ``argv`` (default: the command line), render, and return the
    last frame ((H, W, 3) tensor on the render device; None for 0 frames)."""
    p = parser()
    args = p.parse_args(argv)

    if args.path_gradient and not (args.adaptive_alpha or args.accumulation_ramp):
        # Fail before the torch imports with the config's own rationale
        # rather than inside RenderConfig.__post_init__ mid-startup.
        p.error(
            "--path-gradient requires --adaptive-alpha or "
            "--accumulation-ramp (nothing else consumes the gradient)"
        )
    if args.indirect_split and not (
        1 <= args.indirect_split < args.max_bounces
    ):
        p.error(
            "--indirect-split must be in [1, max_bounces) -- the coarse "
            "tail needs at least one segment"
        )

    import real_time_path_tracing_with_spatiotemporal_filtering_torch as ptt
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils.image import (
        write_png,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils.profiling import (
        sync,
    )

    cfg = build_config(args)
    if args.scene:
        scene = ptt.Scene.from_arrays(*ptt.load_obj(args.scene))
    else:
        scene = ptt.Scene.cornell_box()

    renderer = ptt.Renderer(scene, cfg, device=args.device)
    if args.resume:
        renderer.load_state(args.resume)
        print(f"resumed at frame {renderer.frame_count}", file=sys.stderr)

    if args.out:
        os.makedirs(args.out, exist_ok=True)

    rgb = None
    t_first = None
    t0 = time.perf_counter()
    for i in range(args.frames):
        if args.move_camera:
            renderer.move_camera(*args.move_camera)
        if args.orbit_camera:
            renderer.camera = ptt.Camera.orbit(
                [0.0, 1.0, 0.0], 6.0, args.orbit_camera * i, 1.0, device=renderer.device
            )
        if args.orbit_light:
            renderer.move_light(dx=args.orbit_light)
        rgb = renderer.step()
        sync(rgb)
        if t_first is None:
            t_first = time.perf_counter() - t0
            t0 = time.perf_counter()
        if args.out and i % args.save_every == 0:
            write_png(
                os.path.join(args.out, f"frame_{renderer.frame_count - 1:05d}.png"), rgb
            )

    steady = args.frames - 1
    if steady > 0:
        ms = (time.perf_counter() - t0) / steady * 1000.0
        print(
            f"{args.frames} frames at {args.width}x{args.height} on {renderer.device}: "
            f"first (kernel build + first frame) {t_first:.2f}s, steady {ms:.2f} ms/frame",
            file=sys.stderr,
        )
    if args.checkpoint:
        renderer.save_state(args.checkpoint)
        print(f"state saved to {args.checkpoint}", file=sys.stderr)
    return rgb


if __name__ == "__main__":
    main()
