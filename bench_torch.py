"""Headline benchmark of the PyTorch port: the denoised 1-spp 1080p Cornell
Box, ms/frame, on one CUDA card.

The port's counterpart of ``bench.py``: the default ``RenderConfig`` at
1920x1080 (the reference's parity frame: G-buffer + gradient + path trace +
9x a-trous + EMA) through ``Renderer.step()``; warm-up frames, then frames
timed back to back and synchronised once at the end, as ``bench.py`` times
them. Prints ONE JSON line with ``bench.py``'s keys:

    {"metric": "...", "value": N, "unit": "ms/frame", "vs_baseline": N}

The metric names the card (``torch.cuda.get_device_name``). The baseline is
the 60 Hz frame limit of the port's PERF.md section 2, 16.7 ms/frame:
``vs_baseline = 16.7 / measured``, so > 1 is inside the limit.

Runs on the card; without one it raises, unless given ``--device cpu``
(the plain PyTorch versions, for tests at a small size).

Usage: python bench_torch.py [--width W --height H --frames N --warmup N
                              --device cuda|cpu --verbose]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

BASELINE_MS = 16.7  # PERF.md section 2: the 60 Hz frame limit


def run_bench(width: int = 1920, height: int = 1080, frames: int = 20, warmup: int = 3,
              device: str = "cuda", verbose: bool = False):
    """ms/frame of the default config at ``width`` x ``height`` on
    ``device``, and the device's name."""
    import real_time_path_tracing_with_spatiotemporal_filtering_torch as ptt
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils import device as dev_mod
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils.profiling import sync

    dev = dev_mod.resolve(device)
    name = dev_mod.device_name(dev)
    if verbose:
        print(f"# device: {name}", file=sys.stderr)
    renderer = ptt.Renderer(ptt.Scene.cornell_box(), ptt.RenderConfig(width=width, height=height),
                            device=dev)
    for _ in range(warmup):
        renderer.step()
    # Frames depend on each other through the history, so one sync at the
    # end waits for the whole chain while the launches overlap the device.
    sync(renderer.step())
    t0 = time.perf_counter()
    rgb = None
    for _ in range(frames):
        rgb = renderer.step()
    sync(rgb)
    return (time.perf_counter() - t0) / frames * 1000.0, name


def result_line(width: int, height: int, ms: float, name: str) -> dict:
    return {
        "metric": (f"ms/frame, {width}x{height} 1spp Cornell Box, full A-SVGF (G-buffer + "
                   f"gradient + path trace + 9x a-trous + EMA), single {name}"),
        "value": round(ms, 3),
        "unit": "ms/frame",
        "vs_baseline": round(BASELINE_MS / ms, 4),
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--height", type=int, default=1080)
    parser.add_argument("--frames", type=int, default=20)
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)
    ms, name = run_bench(args.width, args.height, args.frames, args.warmup, args.device,
                         args.verbose)
    print(json.dumps(result_line(args.width, args.height, ms, name)))


if __name__ == "__main__":
    main()
