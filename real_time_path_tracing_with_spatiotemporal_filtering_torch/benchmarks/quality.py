"""Denoising quality benchmark of the PyTorch port: rMSE against a high-spp
converged reference.

The JAX package's ``benchmarks/quality.py``, on the card. A ground-truth
image is accumulated from many independent 1-spp frames (distinct frame
seeds), then the denoiser's steady-state output is compared against it
alongside the raw 1-spp input, reporting the improvement factor. Both the
truth and the raw frame are traced as the frame traces them: on the card
by the trace kernel (csrc/pathtrace.cu), or by the segment tracer
(csrc/wavefront.cu) on scenes that walk the LBVH; on the CPU, or with
``backend="xla"``, by the plain tracer (ops/pathtrace.py).

:data:`BARS` holds the six quality bars of the JAX package's
``tests/test_quality.py``; :func:`run_bar` measures one and says whether it
holds.

Run: python -m real_time_path_tracing_with_spatiotemporal_filtering_torch.benchmarks.quality
         [--spp 1024] [--size 256] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import NamedTuple, Optional

import numpy as np
import torch

_TRUTH_CACHE: dict = {}


def trace_pass(tri_data, camera, light, frame_idx: int, cfg) -> torch.Tensor:
    """One 1-spp frame of noisy radiance (H, W, 3), traced as the frame
    traces it without a G-buffer seed (pipeline/frame.trace_noisy)."""
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline import frame

    kernels = frame.use_kernels(cfg, tri_data.lut.device)
    return frame.trace_noisy(tri_data, camera, light, frame_idx, cfg, kernels)


def ground_truth(tri_data, camera, light, cfg, total_spp: int):
    """Average many independent 1-spp renders (each frame index is an
    independent PCG stream, raytrace.comp.glsl:297), summed on the tables'
    device in float64 in sample order: the float64 adds the JAX package
    makes on the host, in its order. Cached per config within the process:
    the quality bars share one truth across modes that differ only in
    filtering. Returns an (H, W, 3) float32 numpy array."""
    # Normalize away filter-only fields: the trace truth is identical for
    # parity vs variance-guided filtering (RenderConfig is frozen/hashable).
    cfg = dataclasses.replace(
        cfg, variance_guided=False, adaptive_alpha=False,
        demodulate_albedo=False, path_gradient=False,
        # estimator-bias fields forced off: the truth is always the
        # unbiased full-resolution jittered estimator (gbuffer_primary has
        # no effect without a primary argument; normalized so seeded and
        # unseeded modes share one cached truth)
        indirect_split=0, indirect_jitter=False, truncate_radiance=False,
        gbuffer_primary=False,
    )
    key = (cfg, total_spp,
           camera.position.cpu().numpy().tobytes(),
           camera.rotation.cpu().numpy().tobytes(),
           light.position.cpu().numpy().tobytes())
    cached = _TRUTH_CACHE.get(key)
    if cached is not None:
        return cached

    acc = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float64,
                      device=tri_data.lut.device)
    for f in range(total_spp):
        acc += trace_pass(tri_data, camera, light, f + 1_000_000, cfg).double()
    out = (acc / total_spp).float().cpu().numpy()
    _TRUTH_CACHE[key] = out
    return out


def scores(images: dict) -> dict:
    """The rMSE of :func:`render`'s denoised frame and of its raw 1-spp
    frame against its truth, each clamped to [0, 1] (the HDR light pixels
    dominate rMSE otherwise; the reference displays clamped output too)."""
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils.image import rmse

    def c(x):
        return np.clip(x.cpu().numpy() if isinstance(x, torch.Tensor) else x, 0.0, 1.0)

    truth = c(images["truth"])
    return {
        "rmse_denoised": rmse(c(images["frames"][-1]), truth),
        "rmse_noisy_1spp": rmse(c(images["noisy"]), truth),
    }


def run(*args, **kwargs) -> dict:
    """One quality measurement: the :func:`scores` of :func:`render`, which
    takes the arguments."""
    return scores(render(*args, **kwargs))


def render(
    size: int,
    spp: int,
    frames: int,
    variance_guided: bool = False,
    rr_start_bounce: int = 0,
    nee: bool = False,
    demodulate: bool = False,
    ramp: bool = False,
    orbit: float = 0.0,
    light_motion: float = 0.0,
    path_gradient: bool = False,
    width: int | None = None,
    height: int | None = None,
    indirect_split: int = 0,
    indirect_stride: int = 2,
    max_bounces: int = 32,
    gbuffer_primary: bool = False,
    indirect_jitter: bool = False,
    device=None,
    backend: str = "auto",
) -> dict:
    """The images of one quality measurement on ``device`` (the card unless
    ``"cpu"``), on the route ``backend`` picks (RenderConfig.backend): the
    denoised frames in order (``frames``), the raw 1-spp frame (``noisy``)
    and the high-spp truth (``truth``, numpy).
    ``orbit`` (radians/frame): the camera orbits the scene center during
    accumulation and the final frame is compared against a high-spp truth
    AT THE FINAL CAMERA -- this measures reprojection lag and ghosting,
    which the static-camera number cannot see.

    ``light_motion`` (units/frame along x): the light translates during
    accumulation and the truth is rendered AT THE FINAL LIGHT -- this
    measures shading-change lag (stale shadows/indirect light), the signal
    the temporal-gradient lambda exists to bound. ``path_gradient`` swaps
    in the A-SVGF path-space gradient (ops/pathgrad.py) on top of the
    reference's Phong proxy."""
    import real_time_path_tracing_with_spatiotemporal_filtering_torch as ptt
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene.scene import (
        Camera,
        Light,
        precompute_triangle_data,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils.device import resolve

    dev = resolve(device)
    cfg = ptt.RenderConfig(
        width=width or size, height=height or size,
        variance_guided=variance_guided or demodulate,
        rr_start_bounce=rr_start_bounce, nee=nee,
        demodulate_albedo=demodulate,
        accumulation_ramp=ramp,
        # the A-SVGF dynamic configs
        adaptive_alpha=orbit != 0.0 or light_motion != 0.0 or path_gradient,
        path_gradient=path_gradient,
        # multi-res indirect (estimator bias measured against the
        # full-res truth; the truth normalizes these away)
        indirect_split=indirect_split,
        indirect_stride=indirect_stride,
        indirect_jitter=indirect_jitter,
        max_bounces=max_bounces,
        # G-buffer-seeded primaries (no primary AA jitter); the truth
        # keeps the jittered reference estimator, so this row measures
        # the mode's full bias (including the lost anti-aliasing)
        gbuffer_primary=gbuffer_primary,
        backend=backend,
    )
    scene = ptt.Scene.cornell_box()
    td = precompute_triangle_data(scene, dev)

    def light_at(i):
        if light_motion == 0.0:
            return Light.default(dev)
        base = Light.default()
        pos = base.position.numpy() + np.array([light_motion * i, 0.0, 0.0], np.float32)
        return Light(position=torch.tensor(pos, device=dev), color=base.color.to(dev))

    light = light_at(frames - 1)  # truth at the final light

    def cam_at(i):
        if orbit == 0.0:
            return Camera.default(dev)
        return Camera.orbit([0.0, 1.0, 0.0], 6.0, orbit * i, 1.0, device=dev)

    cam = cam_at(frames - 1)  # truth at the final camera

    # Ground truth is always RR-free (RR is unbiased, so the truth is the
    # same; keeping it exact avoids paying RR's variance twice). NEE stays
    # on for the truth when enabled: it changes the transport semantics
    # (no fall-through quirk, occluded light), not just the variance.
    truth = ground_truth(
        td, cam, light,
        dataclasses.replace(cfg, rr_start_bounce=0, path_gradient=False),
        spp,
    )

    r = ptt.Renderer(scene, cfg, camera=cam_at(0), light=light_at(0), device=dev,
                     tri_data=td)
    out = []
    for i in range(frames):
        r.camera = cam_at(i)
        r.light = light_at(i)
        out.append(r.step())

    # raw 1-spp noise level for the improvement factor
    noisy = trace_pass(td, cam, light, frames, cfg)
    return {"frames": out, "noisy": noisy, "truth": truth}


class Bar(NamedTuple):
    """A quality bar of the JAX package's tests/test_quality.py: the
    measurement (``run``'s keywords) and its limits, denoised rMSE at most
    ``max_rmse`` and improvement over the raw 1-spp frame at least
    ``min_improvement``; ``recorded``: the (rMSE, improvement) the test's
    docstring records for the JAX package, at ``recorded_at``."""

    name: str
    kwargs: dict
    max_rmse: float
    min_improvement: float
    recorded: Optional[tuple]
    recorded_at: str


_BAR_128 = dict(size=128, spp=192, frames=20)
BARS = (
    # test_denoiser_beats_raw_input (:55-56: denoised < 0.85 x noisy and
    # < 0.3). The test traces its raw frame at frame index 17; run() at
    # `frames`, 16: another 1-spp sample of the same estimator.
    Bar("denoiser_beats_raw_input",
        dict(size=64, width=64, height=48, spp=192, frames=16, max_bounces=8),
        0.3, 1.0 / 0.85, None, "none recorded"),
    Bar("reference_parity", _BAR_128, 0.23, 1.55, (0.210, 1.69),
        "192-spp truth, 20 frames"),
    Bar("variance_guided", dict(_BAR_128, variance_guided=True), 0.175, 2.0, (0.160, 2.22),
        "192-spp truth, 20 frames"),
    Bar("albedo_demod", dict(_BAR_128, variance_guided=True, demodulate=True), 0.17, 2.05,
        (0.151, 2.31), "1024-spp truth, 32 frames"),
    Bar("nee", dict(_BAR_128, variance_guided=True, nee=True), 0.06, 4.0, (0.043, 5.2),
        "512-spp truth"),
    Bar("multires_interactive_stack",
        dict(_BAR_128, variance_guided=True, rr_start_bounce=2, max_bounces=8,
             indirect_split=1, indirect_stride=4, gbuffer_primary=True),
        0.25, 1.4, (0.2255, 1.61), "512-spp truth, 32 frames"),
)


def run_bar(bar: Bar, device=None, backend: str = "auto") -> dict:
    """Measure ``bar`` on ``device`` and the route ``backend`` picks: its
    denoised rMSE, improvement factor and whether both limits hold, and
    the images measured (:func:`render`'s, under ``images``)."""
    images = render(**bar.kwargs, device=device, backend=backend)
    stats = scores(images)
    improvement = stats["rmse_noisy_1spp"] / max(stats["rmse_denoised"], 1e-12)
    return dict(stats, improvement=improvement, images=images,
                ok=stats["rmse_denoised"] <= bar.max_rmse and improvement >= bar.min_improvement)


def _print_stats(args, label: str, stats: dict) -> None:
    improvement = stats["rmse_noisy_1spp"] / max(stats["rmse_denoised"], 1e-12)
    print(json.dumps({
        "metric": (f"denoised rMSE vs {args.spp}-spp reference, "
                   f"{args.width or args.size}x{args.height or args.size} Cornell "
                   f"(clamped [0,1]), {label}"),
        "value": round(stats["rmse_denoised"], 6),
        "unit": "rmse",
        "noisy_1spp_rmse": round(stats["rmse_noisy_1spp"], 6),
        "improvement_factor": round(improvement, 2),
    }))
    print(f"[{label}] denoised {stats['rmse_denoised']:.4f} vs noisy "
          f"{stats['rmse_noisy_1spp']:.4f} ({improvement:.1f}x better)", file=sys.stderr)


# --multires-sweep: the shipped (split, stride) points, measured against the
# same full-res truth in one process (the JAX package's sweep).
SWEEP = (
    ("variance-guided baseline", {}),
    ("indirect split@2 stride 2", dict(indirect_split=2)),
    ("indirect split@2 stride 4", dict(indirect_split=2, indirect_stride=4)),
    ("indirect split@1 stride 4", dict(indirect_split=1, indirect_stride=4)),
    ("indirect split@1 stride 4 + G-buffer primaries",
     dict(indirect_split=1, indirect_stride=4, gbuffer_primary=True)),
    ("interactive stack mb8 RR@2 split@1 stride 4 + primaries",
     dict(indirect_split=1, indirect_stride=4, gbuffer_primary=True, max_bounces=8,
          rr_start_bounce=2)),
    ("indirect split@1 stride 4 + jitter",
     dict(indirect_split=1, indirect_stride=4, indirect_jitter=True)),
    ("interactive stack + jitter",
     dict(indirect_split=1, indirect_stride=4, gbuffer_primary=True, max_bounces=8,
          rr_start_bounce=2, indirect_jitter=True)),
)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--width", type=int, default=None,
                        help="non-square width (e.g. 1920 for the 1080p headline config)")
    parser.add_argument("--height", type=int, default=None, help="non-square height (e.g. 1080)")
    parser.add_argument("--spp", type=int, default=1024)
    parser.add_argument("--frames", type=int, default=32)
    parser.add_argument("--skip-variance", action="store_true",
                        help="only measure reference-parity filtering")
    parser.add_argument("--rr-start-bounce", type=int, default=0,
                        help="also measure with Russian roulette from this bounce "
                        "(variance-guided mode only; quantifies RR's noise cost)")
    parser.add_argument("--demod", action="store_true",
                        help="also measure with SVGF albedo demodulation (parity and "
                        "variance-guided filtering of irradiance)")
    parser.add_argument("--nee", action="store_true",
                        help="also measure with next-event estimation (variance-guided)")
    parser.add_argument("--ramp", action="store_true",
                        help="also measure with the SVGF accumulation ramp "
                        "(per-pixel history length, alpha floor ramp_alpha_min)")
    parser.add_argument("--orbit", type=float, default=0.0, metavar="RAD",
                        help="orbit the camera by RAD radians/frame; the final frame is "
                        "compared against a truth at the final camera (applies to every "
                        "mode measured)")
    parser.add_argument("--light-motion", type=float, default=0.0, metavar="DX",
                        help="translate the light by DX units/frame along x; the final "
                        "frame is compared against a truth at the final light (applies "
                        "to every mode measured)")
    parser.add_argument("--path-gradient", action="store_true",
                        help="also measure with the A-SVGF path-space temporal gradient "
                        "(re-traced sparse samples; variance-guided mode)")
    parser.add_argument("--indirect", type=int, default=0, metavar="SPLIT",
                        help="also measure multi-res indirect with this split bounce "
                        "(variance-guided mode; bias vs the full-res truth)")
    parser.add_argument("--indirect-stride", type=int, default=2,
                        help="coarse-grid stride of --indirect")
    parser.add_argument("--max-bounces", type=int, default=32,
                        help="bounce cap for every measured mode AND the truth "
                        "(8 = the interactive estimator)")
    parser.add_argument("--gbuffer-primary", action="store_true",
                        help="also measure G-buffer-seeded primaries (no primary AA "
                        "jitter) in variance-guided mode, with and without the "
                        "--indirect split -- total bias vs the jittered truth")
    parser.add_argument("--multires-sweep", action="store_true",
                        help="measure the shipped multi-res indirect points in one process "
                        "(shared truth cache). Honors --size/--spp/--frames/--orbit.")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain PyTorch versions)")
    args = parser.parse_args(argv)
    if args.multires_sweep:
        for label, kw in SWEEP:
            kw = dict(kw)
            stats = run(args.size, args.spp, args.frames, True, kw.pop("rr_start_bounce", 0),
                        width=args.width, height=args.height, orbit=args.orbit,
                        indirect_stride=kw.pop("indirect_stride", 2), device=args.device, **kw)
            if args.orbit:
                label += f" (orbit {args.orbit:g} rad/frame)"
            _print_stats(args, label, stats)
        return
    # (variance_guided, rr, nee, demod, ramp, path_gradient, indirect, gbuffer_primary)
    modes = [(False, 0, False, False, False, False, 0, False)]
    if not args.skip_variance:
        modes.append((True, 0, False, False, False, False, 0, False))
    rr = args.rr_start_bounce
    if rr:
        modes.append((True, rr, False, False, False, False, 0, False))
    if args.nee:
        modes.append((True, 0, True, False, False, False, 0, False))
    if args.demod:
        # demodulation requires the variance-normalized (scale-invariant)
        # luminance weight (config.py validation)
        modes.append((True, 0, False, True, False, False, 0, False))
    if args.ramp:
        modes.append((True, 0, False, False, True, False, 0, False))
    if args.path_gradient:
        modes.append((True, 0, False, False, args.ramp, True, 0, False))
    if args.indirect:
        # like-for-like: the multi-res row keeps the same RR setting so
        # the delta against the variance-guided row isolates the split
        modes.append((True, rr, False, False, False, False, args.indirect, False))
    if args.gbuffer_primary:
        # variance-guided + G-buffer primaries, then the full interactive
        # estimator stack (split + seed) when --indirect is also given
        modes.append((True, rr, False, False, False, False, 0, True))
        if args.indirect:
            modes.append((True, rr, False, False, False, False, args.indirect, True))
    for variance_guided, rr, nee, demod, ramp, pg, ind, gp in modes:
        stats = run(
            args.size, args.spp, args.frames, variance_guided, rr, nee,
            width=args.width, height=args.height,
            demodulate=demod, ramp=ramp, orbit=args.orbit,
            light_motion=args.light_motion, path_gradient=pg,
            indirect_split=ind, indirect_stride=args.indirect_stride,
            max_bounces=args.max_bounces, gbuffer_primary=gp, device=args.device,
        )
        mode = "variance-guided SVGF" if variance_guided else "reference parity"
        if rr:
            mode += f" + RR@{rr}"
        if nee:
            mode += " + NEE"
        if demod:
            mode += " + albedo demod"
        if ramp:
            mode += " + accumulation ramp"
        if pg:
            mode += " + path gradient"
        if ind:
            mode += f" + indirect split@{ind} stride {args.indirect_stride}"
        if gp:
            mode += " + G-buffer primaries"
        if args.max_bounces != 32:
            mode += f" (mb{args.max_bounces})"
        if args.orbit:
            mode += f" (orbit {args.orbit:g} rad/frame)"
        if args.light_motion:
            mode += f" (light {args.light_motion:g} u/frame)"
        _print_stats(args, mode, stats)


if __name__ == "__main__":
    main()
