#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``real_time_path_tracing_with_spatiotemporal_
filtering_torch/csrc`` with nvcc, checks each kernel against its plain
PyTorch version on the card at the default 1000x800 frame, checks the kernel
route against the repository's golden images, drives the default-config
``Renderer`` for 16 frames on both routes (kernels, and ``backend="xla"``,
the plain version) with the launch counts of the kernel route, and times
both routes at 1000x800 and 1920x1080 with CUDA events.

Prints the card's name and power limit, one JSON line of per-kernel results,
and as its last line ``{"ok": true, "device": {...}}``. Exits non-zero, with
no result line, when there is no CUDA device, when the package cannot be
imported, or when any phase fails.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

PKG = "real_time_path_tracing_with_spatiotemporal_filtering_torch"
TPU_PKG = "real_time_path_tracing_with_spatiotemporal_filtering_tpu"
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden")
WIDTH, HEIGHT = 1000, 800  # the default RenderConfig, the reference's frame
BENCH_SIZE = (1920, 1080)  # bench.py's frame
FRAMES = 16
SEED = 20261016


class PhaseError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    print(("PASS " if cond else "FAIL ") + what, flush=True)
    if not cond:
        raise PhaseError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call of ``fn``, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def share_outside(a, b, atol: float, rtol: float = 0.0) -> float:
    """Share of elements where |a - b| > atol + rtol |b| (NaN counts)."""
    import torch

    ok = torch.isclose(a.double(), b.double(), rtol=rtol, atol=atol)
    return 1.0 - ok.double().mean().item()


def max_abs(a, b) -> float:
    return (a.double() - b.double()).abs().max().item()


def kernel_phase(pt, cuda_ops, dev):
    """Each kernel against its plain version at 1000x800; returns the
    per-kernel records (launch counts filled in later)."""
    import torch

    from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline import frame

    geo_mod, pt_mod, at_mod = cuda_ops
    cfg = pt.RenderConfig(width=WIDTH, height=HEIGHT)
    h, w = cfg.height, cfg.width
    td = pt.precompute_triangle_data(pt.Scene.cornell_box(), dev)
    cam, light = pt.Camera.default(dev), pt.Light.default(dev)
    view, proj = frame.camera_matrices(cam, cfg)
    prev_cam = pt.Camera(cam.position + torch.tensor([0.0, 0.0, 0.5], device=dev), cam.rotation)
    view_p, proj_p = frame.camera_matrices(prev_cam, cfg)
    geo_args = (td, td.lut, cam.position, cam.rotation, light.position,
                light.position + torch.tensor([0.5, 0.0, 0.0], device=dev),
                light.color, light.color * 0.5, view, proj, view_p, proj_p, cfg)
    records = []

    # -- geometry --
    k = geo_mod.geometry_pass(*geo_args)
    p = geo_mod.geometry_pass_plain(*geo_args)
    torch.cuda.synchronize()
    vis_bad = (k.visibility != p.visibility).double().mean().item()
    same = (k.visibility == p.visibility)[..., None]
    planes = {
        "depth": (k.depth[..., None], p.depth[..., None], 1e-5),
        "normal": (k.normal, p.normal, 1e-6),
        "world_pos": (k.world_pos, p.world_pos, 1e-5),
        "lam": (k.lam[..., None], p.lam[..., None], 2e-4),
    }
    err = 0.0
    for name, (a, b, tol) in planes.items():
        err = max(err, max_abs(a, b))
        bad = share_outside(torch.where(same, a, b), b, tol)
        print(f"geometry {name}: max_abs {max_abs(a, b):.3e}, share > {tol:g} "
              f"where vis agrees {bad:.3e}")
        check(bad == 0.0 and torch.isfinite(a).all().item(), f"geometry {name} within {tol:g}")
    dy = (k.prev_y - p.prev_y).abs()
    dx = (k.prev_x - p.prev_x).abs()
    print(f"geometry vis mismatch share {vis_bad:.3e}; prev_y/x off-by-one share "
          f"{(dy > 0).double().mean().item():.3e} / {(dx > 0).double().mean().item():.3e}")
    check(vis_bad <= 1e-4, "geometry visibility mismatch share <= 1e-4")
    check(dy.max().item() <= 1 and dx.max().item() <= 1
          and (dy > 0).double().mean().item() < 1e-3
          and (dx > 0).double().mean().item() < 1e-3,
          "geometry prev_y/x within 1 px on < 0.1% of pixels")
    records.append(dict(
        name="geometry", route="cuda", source=f"{PKG}/csrc/geometry.cu",
        replaces=f"{TPU_PKG}/ops/pallas/geometry.py:116", max_abs_err=err,
        ms=time_ms(lambda: geo_mod.geometry_pass(*geo_args), 20),
        plain_ms=time_ms(lambda: geo_mod.geometry_pass_plain(*geo_args), 3),
    ))

    # -- path trace, frame 5, 32 bounces --
    k_noisy = pt_mod.path_trace_pass(td, cam.position, light, 5, cfg, cam.rotation)
    p_noisy = pt_mod.path_trace_pass_plain(td, cam.position, light, 5, cfg, rotation=cam.rotation)
    torch.cuda.synchronize()
    bad = share_outside(k_noisy, p_noisy, 1e-5, 1e-5)
    print(f"trace: max_abs {max_abs(k_noisy, p_noisy):.3e}, share outside 1e-5 {bad:.3e}")
    check(torch.isfinite(k_noisy).all().item(), "trace output finite")
    check(bad <= 1e-3, "trace within 1e-5 (abs+rel) on >= 99.9% of elements")
    records.append(dict(
        name="trace", route="cuda", source=f"{PKG}/csrc/pathtrace.cu",
        replaces=f"{TPU_PKG}/ops/pallas/pathtrace.py:1716",
        max_abs_err=max_abs(k_noisy, p_noisy),
        ms=time_ms(lambda: pt_mod.path_trace_pass(td, cam.position, light, 5, cfg, cam.rotation), 10),
        plain_ms=time_ms(lambda: pt_mod.path_trace_pass_plain(
            td, cam.position, light, 5, cfg, rotation=cam.rotation), 2, warmup=1),
    ))

    # -- a-trous iteration, k = 1..9, seeded HDR color on the real G-buffer --
    rng = np.random.default_rng(SEED)
    color = torch.tensor(rng.exponential(0.5, (h, w, 3)).astype(np.float32), device=dev)
    err = worst = 0.0
    for step in range(1, cfg.wavelet_iterations + 1):
        a = at_mod.atrous_iteration(color, p.normal, p.depth, step, cfg)
        b = at_mod.atrous_iteration_plain(color, p.normal, p.depth, step, cfg)
        torch.cuda.synchronize()
        err = max(err, max_abs(a, b))
        bad = share_outside(a, b, 1e-5, 1e-5)
        worst = max(worst, bad)
        check(bad == 0.0, f"atrous_iter k={step} within 1e-5")
    print(f"atrous_iter k=1..9: max_abs {err:.3e}, share outside 1e-5 {worst:.3e}")
    records.append(dict(
        name="atrous_iter", route="cuda", source=f"{PKG}/csrc/atrous.cu",
        replaces=f"{TPU_PKG}/ops/pallas/atrous.py:35", max_abs_err=err,
        ms=time_ms(lambda: at_mod.atrous_iteration(color, p.normal, p.depth, 5, cfg), 20),
        plain_ms=time_ms(lambda: at_mod.atrous_iteration_plain(color, p.normal, p.depth, 5, cfg), 3),
    ))

    # -- temporal blend: random backprojection, fixed and adaptive alpha --
    prev = torch.tensor(rng.exponential(0.5, (h, w, 3)).astype(np.float32), device=dev)
    lam = torch.tensor(rng.uniform(0, 1, (h, w)).astype(np.float32), device=dev)
    py = torch.tensor(rng.integers(0, h, (h, w)).astype(np.int32), device=dev)
    px = torch.tensor(rng.integers(0, w, (h, w)).astype(np.int32), device=dev)
    err = worst = 0.0
    for adaptive in (False, True):
        c = pt.RenderConfig(width=WIDTH, height=HEIGHT, adaptive_alpha=adaptive)
        for f in (0, 3):
            a = at_mod.temporal_blend(color, prev, py, px, f, lam, c)
            b = at_mod.temporal_blend_plain(color, prev, py, px, f, lam, c)
            torch.cuda.synchronize()
            err = max(err, max_abs(a, b))
            bad = share_outside(a, b, 1e-6, 1e-6)
            worst = max(worst, bad)
            check(bad == 0.0, f"temporal_blend adaptive={adaptive} frame={f} within 1e-6")
    print(f"temporal_blend: max_abs {err:.3e}, share outside 1e-6 {worst:.3e}")
    records.append(dict(
        name="temporal_blend", route="cuda", source=f"{PKG}/csrc/atrous.cu",
        replaces=f"{TPU_PKG}/ops/pallas/atrous.py:278", max_abs_err=err,
        ms=time_ms(lambda: at_mod.temporal_blend(color, prev, py, px, 3, lam, cfg), 20),
        plain_ms=time_ms(lambda: at_mod.temporal_blend_plain(color, prev, py, px, 3, lam, cfg), 5),
    ))
    return records


def golden_phase(pt, dev) -> None:
    """The kernel route against the JAX package's golden snapshots (48x32,
    6 bounces, 3 iterations), at the CPU tests' criterion."""
    import torch

    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import (
        pathtrace as pt_mod,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline import frame

    cfg = pt.RenderConfig(width=48, height=32, max_bounces=6, wavelet_iterations=3,
                          backend="pallas")
    td = pt.precompute_triangle_data(pt.Scene.cornell_box(), dev)
    cam, light = pt.Camera.default(dev), pt.Light.default(dev)
    noisy = pt_mod.path_trace_pass(td, cam.position, light, 7, cfg, cam.rotation)
    hist = frame.init_history(td, cfg)
    for _ in range(3):
        rgb, hist = frame.render_frame_impl(td, cam, light, hist, cfg)
    for name, got in (("pathtrace_48x32_f7", noisy), ("frame3_48x32", rgb)):
        gold = torch.tensor(np.load(os.path.join(GOLDEN, name + ".npy")), device=dev)
        inside = 1.0 - share_outside(got, gold, 1e-6, 1e-5)
        mean = (got - gold).abs().mean().item()
        print(f"golden {name}: share within rtol 1e-5/atol 1e-6 {inside:.6f}, mean abs {mean:.3e}")
        check(inside >= 0.995 and mean <= 1e-4, f"kernel route reproduces {name}")


def sequence_phase(pt, dev) -> dict:
    """16 default-config frames through Renderer.step() on both routes; the
    light and camera move from frame 8 on. Returns the kernel launch counts
    of the kernel route."""
    import torch

    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import LAUNCHES

    scene = pt.Scene.cornell_box()
    cfg = pt.RenderConfig(width=WIDTH, height=HEIGHT)
    r_k = pt.Renderer(scene, cfg, device=dev)
    r_p = pt.Renderer(scene, dataclasses.replace(cfg, backend="xla"), device=dev)
    LAUNCHES.clear()
    for f in range(FRAMES):
        if f >= FRAMES // 2:
            for r in (r_k, r_p):
                r.move_light(dx=0.05)
                r.move_camera(dx=0.01)
        a = r_k.step()
        b = r_p.step()
        torch.cuda.synchronize()
        bad = share_outside(a, b, 1e-3)
        mean = (a - b).abs().mean().item()
        finite = bool(torch.isfinite(a).all().item() and torch.isfinite(b).all().item())
        print(f"frame {f:2d}: kernel vs plain max_abs {max_abs(a, b):.3e}, "
              f"share > 1e-3 {bad:.3e}, mean abs {mean:.3e}, finite {finite}")
        check(finite and tuple(a.shape) == (HEIGHT, WIDTH, 3), f"frame {f} finite, shape (H, W, 3)")
        check(bad <= 0.01 and mean <= 1e-4, f"frame {f} kernel route within 1e-3 on >= 99%")
    counts = dict(LAUNCHES)
    print(f"launch counts over {FRAMES} frames: {counts}")
    expected = {"geometry": FRAMES, "trace": FRAMES, "atrous_iter": 9 * FRAMES,
                "temporal_blend": FRAMES}
    check(counts == expected, f"launch counts {expected}")
    return counts


def timing_phase(pt, dev, card: str) -> None:
    """ms/frame of both routes after warm-up, static camera."""
    scene = pt.Scene.cornell_box()
    for w, h in ((WIDTH, HEIGHT), BENCH_SIZE):
        for backend, reps in (("auto", 20), ("xla", 3)):
            r = pt.Renderer(scene, pt.RenderConfig(width=w, height=h, backend=backend), device=dev)
            ms = time_ms(r.step, reps, warmup=3)
            route = "kernels" if backend == "auto" else "plain"
            print(f"ms/frame {w}x{h} {route}: {ms:.3f} ({card})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    try:
        import real_time_path_tracing_with_spatiotemporal_filtering_torch as pt
        from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import (
            _build,
            atrous as at_mod,
            geometry as geo_mod,
            pathtrace as pt_mod,
        )
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port: {exc}", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    try:
        card = card_line()
        print(card)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"python {sys.version.split()[0]}")
        t0 = time.time()
        _build.library()
        print(f"nvcc build: {time.time() - t0:.1f} s ({_build.NVCC_FLAGS})")
        for line in _build.build_log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print("  ptxas: " + line.strip())
        records = kernel_phase(pt, (geo_mod, pt_mod, at_mod), dev)
        golden_phase(pt, dev)
        counts = sequence_phase(pt, dev)
        timing_phase(pt, dev, card)
    except (PhaseError, RuntimeError, ValueError, subprocess.SubprocessError) as exc:
        print(f"chip_smoke: failed: {exc}", file=sys.stderr)
        return 1
    kernels = [dict(r, launches=counts[r["name"]]) for r in records]
    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms"]
    print(json.dumps({"kernels": [{k: r[k] for k in order} for r in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
