"""Interactive terminal viewer: the reference's GLFW main loop on the card.

The reference opens a 1000x800 window and polls WASD/IJKL keys at 60 Hz
(main.cpp:265-308, 1119-1168). On a headless host the same loop becomes:
read raw keys from the controlling tty without blocking, advance the camera/
light through the shared input controller, render a frame, and present it as
an ANSI truecolor half-block preview in the terminal (plus optional PNG
recording). The JAX package's viewer, with one more flag: ``--device``
(the card unless ``--device cpu``).

Run: python -m real_time_path_tracing_with_spatiotemporal_filtering_torch.viewer
Keys: WASD/QE camera, IJKL/OU light, p = save PNG, x = quit.
"""

from __future__ import annotations

import argparse
import os
import select
import shutil
import sys

import numpy as np


def _read_keys_nonblocking(fd) -> set[str]:
    keys: set[str] = set()
    while select.select([fd], [], [], 0)[0]:
        ch = os.read(fd, 1).decode(errors="ignore")
        if ch:
            keys.add(ch.lower())
    return keys


def ansi_preview(img: np.ndarray, max_cols: int, max_rows: int) -> str:
    """Downsample to the terminal and render 2 pixels/cell with half blocks."""
    h, w, _ = img.shape
    cols = min(max_cols, w)
    rows = min(max_rows * 2, h)
    ys = np.linspace(0, h - 1, rows).astype(int)
    xs = np.linspace(0, w - 1, cols).astype(int)
    small = (np.clip(img[ys][:, xs], 0, 1) * 255).astype(np.uint8)
    lines = []
    for r in range(0, rows - 1, 2):
        top, bot = small[r], small[r + 1]
        cells = [
            f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
            for t, b in zip(top, bot)
        ]
        lines.append("".join(cells) + "\x1b[0m")
    return "\n".join(lines)


def build_config(args):
    """Viewer flag set -> validated RenderConfig.

    ``--path-gradient`` feeds adaptive alpha / the accumulation ramp
    (RenderConfig rejects it with no consumer); it therefore implies
    ``--ramp`` so the flag is usable alone, matching its help text.
    """
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.config import (
        RenderConfig,
    )

    ramp = args.ramp or args.path_gradient
    if args.path_gradient and not args.ramp:
        print("--path-gradient implies --ramp (gradient consumer)",
              file=sys.stderr)
    return RenderConfig(
        width=args.width, height=args.height,
        nee=args.nee, rr_start_bounce=args.rr_start_bounce,
        variance_guided=ramp, accumulation_ramp=ramp,
        adaptive_alpha=ramp,
        path_gradient=args.path_gradient,
        # getattr: programmatic callers (tests) may pass a bare Namespace
        # without the newer non-parity flags
        indirect_split=getattr(args, "indirect_split", 0),
        indirect_stride=getattr(args, "indirect_stride", 2),
        indirect_jitter=getattr(args, "indirect_jitter", False),
        gbuffer_primary=getattr(args, "gbuffer_primary", False),
        # the viewer's quality preset uses the tessellation-robust
        # history-rejection test and a mild firefly clamp (config.py)
        ramp_reset_mode="normal" if ramp else "id",
        firefly_clamp=getattr(args, "firefly_clamp", 0.0),
    )


def run_viewer(args):
    """Render ``args.frames`` frames (-1: until "x"), previewing, recording
    and reading keys as the flags say; returns the last frame's host copy
    ((H, W, 3) numpy; None for 0 frames)."""
    import real_time_path_tracing_with_spatiotemporal_filtering_torch as ptt
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline.input import (
        apply_keys,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils.image import (
        write_png,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils.profiling import (
        FrameTimer,
    )

    cfg = build_config(args)
    scene = (
        ptt.Scene.from_arrays(*ptt.load_obj(args.scene))
        if args.scene
        else ptt.Scene.cornell_box()
    )
    renderer = ptt.Renderer(scene, cfg, device=getattr(args, "device", None))

    interactive = sys.stdin.isatty() and not args.headless
    old_attrs = None
    fd = None
    if interactive:
        import termios
        import tty

        fd = sys.stdin.fileno()
        old_attrs = termios.tcgetattr(fd)
        tty.setcbreak(fd)

    timer = FrameTimer()
    if args.record:
        os.makedirs(args.record, exist_ok=True)
    rgb = None
    try:
        frame = 0
        while args.frames < 0 or frame < args.frames:
            keys = _read_keys_nonblocking(fd) if interactive else set()
            if "x" in keys:
                break
            renderer.camera, renderer.light, _ = apply_keys(
                renderer.camera, renderer.light, keys, cfg
            )
            # the frame's one host copy, read by the PNG and the preview
            rgb = renderer.step().cpu().numpy()
            timer.tick()
            if "p" in keys or (args.record and frame % args.record_every == 0):
                path = (
                    os.path.join(args.record or ".", f"frame_{frame:05d}.png")
                )
                write_png(path, rgb)
            if not args.no_preview:
                size = shutil.get_terminal_size((100, 40))
                preview = ansi_preview(rgb, size.columns, size.lines - 2)
                sys.stdout.write("\x1b[H\x1b[2J" + preview + "\n")
                sys.stdout.write(
                    f"frame {frame}  {timer.ms_per_frame:6.1f} ms/frame "
                    f"({timer.fps:5.1f} fps)  WASD/QE camera  IJKL/OU light  "
                    f"p=png x=quit\n"
                )
                sys.stdout.flush()
            frame += 1
    finally:
        if interactive and old_attrs is not None:
            import termios

            termios.tcsetattr(fd, termios.TCSADRAIN, old_attrs)
    return rgb


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", default=None)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--frames", type=int, default=-1, help="-1 = until quit")
    p.add_argument("--record", default=None, help="dir for PNG recording")
    p.add_argument("--record-every", type=int, default=1)
    p.add_argument("--headless", action="store_true")
    p.add_argument("--nee", action="store_true",
                   help="next-event estimation (non-parity)")
    p.add_argument("--rr-start-bounce", type=int, default=0,
                   help="Russian roulette from this bounce (0 = off)")
    p.add_argument("--ramp", action="store_true",
                   help="best interactive quality: variance-guided "
                   "SVGF + accumulation ramp + adaptive alpha")
    p.add_argument("--indirect-split", type=int, default=0,
                   help="multi-res indirect: bounces >= this index "
                   "traced on a subsampled grid (non-parity; 0 = off)")
    p.add_argument("--indirect-stride", type=int, default=2,
                   help="coarse-grid stride of --indirect-split")
    p.add_argument("--indirect-jitter", action="store_true",
                   help="per-frame coarse-grid phase rotation "
                   "(shrinks the split's low-pass bias)")
    p.add_argument("--gbuffer-primary", action="store_true",
                   help="seed bounce 0 from the G-buffer (non-parity: "
                   "no primary AA jitter)")
    p.add_argument("--path-gradient", action="store_true",
                   help="A-SVGF path-space temporal gradient "
                   "(re-traced sparse samples; implies --ramp)")
    p.add_argument("--firefly-clamp", type=float, default=0.0,
                   help="clamp noisy HDR radiance before filtering "
                   "(0 = off; 1-4 kills fireflies)")
    p.add_argument("--no-preview", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch versions)")
    return p


def main(argv=None) -> None:
    run_viewer(parser().parse_args(argv))


if __name__ == "__main__":
    main()
