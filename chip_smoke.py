#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``real_time_path_tracing_with_spatiotemporal_
filtering_torch/csrc`` with nvcc, then:

- checks each kernel against its plain PyTorch version on the card: the
  default-config kernels at the reference's 1000x800 frame, and the SVGF and
  estimator modes (variance-guided a-trous, the ramp blend, the tracer with
  NEE / Russian roulette / several samples / truncate_radiance, the
  geometry kernel's albedo planes) at 1920x1080;
- checks the kernel route against the repository's golden images;
- checks the large-scene kernels (the LBVH geometry kernel, the segment
  tracer and the shadow segment) against their plain versions at 1920x1080
  on the 32,768- and 247,808-triangle scenes of paths A and B (the segment
  tracer on B at segments 0, 1 and 31), at 480x270 for the tracer's further
  modes, and against the dense kernels (bit for bit, and timed) at
  1920x1080 on 32, 128 and 288 triangles, where both run;
- drives six main paths through ``Renderer.step()`` on both routes
  (kernels, and ``backend="xla"``, the plain version), each with the launch
  counts read just after it: the default config for 16 frames at 1000x800,
  the ``cornell_box_quality`` and ``cornell_box_interactive`` presets for 8
  frames at 1920x1080, and the large scenes of ``presets.cornell_stress``
  under the orbit camera: path A (32,768 triangles, 8 bounces, Russian
  roulette from 2, adaptive alpha; 4 frames at 1920x1080), path B (247,808
  triangles, the default config; 2 frames at 480x270) and path C (A with the
  G-buffer seed and NEE; 4 frames at 1920x1080);
- times both routes with CUDA events.

Prints the card's name and power limit, one JSON line of per-kernel results
(with each kernel's bound: the least time the card could take for the same
work), and as its last line ``{"ok": true, "device": {...}}``. Exits
non-zero, with no result line, when there is no CUDA device, when the
package cannot be imported, or when any phase fails.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
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
PRESET_FRAMES = 8
PRESETS = ("cornell_box_quality", "cornell_box_interactive")
SEED = 20261016
# The large-scene paths: (splits of presets.cornell_stress, config
# overrides, frames, size). A and B are rows 4c and 4 of the JAX package's
# benchmarks/suite.py; C is A with the G-buffer seed and NEE. B's plain
# route runs at 480x270 (its 32 lockstep walks per frame over 247,808
# triangles are the slow part of the script).
PLAIN_SIZE = (480, 270)
LARGE = {
    "A": (32, dict(max_bounces=8, rr_start_bounce=2, adaptive_alpha=True), 4, BENCH_SIZE),
    "B": (88, {}, 2, PLAIN_SIZE),
    "C": (32, dict(max_bounces=8, rr_start_bounce=2, adaptive_alpha=True, gbuffer_primary=True,
                   nee=True), 4, BENCH_SIZE),
}
LARGE_PER_FRAME = {
    "A": {"geometry_bvh": 1, "trace_segment": 8, "atrous_iter": 9, "temporal_blend": 1},
    "B": {"geometry_bvh": 1, "trace_segment": 32, "atrous_iter": 9, "temporal_blend": 1},
    "C": {"geometry_bvh": 1, "shadow_segment": 1, "trace_segment": 7, "atrous_iter": 9,
          "temporal_blend": 1},
}

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): HBM bytes
# per second and float32 operations per second outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Floating-point operations counted per unit of work (transcendentals count
# as one): a ray/triangle test (six 3-term dot products, t, u, v, u + v;
# csrc/common.cuh tri_test), one a-trous pixel (9 taps), one
# variance-guided a-trous pixel (9 taps and the 9-tap prefilter), one blend
# pixel and one ramp-blend pixel.
TRI_TEST_OPS = 39
# a ray/box slab test (csrc/bvh.cuh slab): 6 subtractions, 6 products, 3
# min and 3 max per axis pair, 4 more for the entry and exit, the clamp at
# 0 and 3 compares and ands
SLAB_TEST_OPS = 26
ATROUS_OPS = 273
ATROUS_VAR_OPS = 328
BLEND_OPS = 12
RAMP_BLEND_OPS = 20


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


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def record(name: str, source: str, replaces: str, **fields) -> dict:
    """One kernel's entry of the JSON line; ``fields`` hold max_abs_err, ms,
    plain_ms and the bound. No single PyTorch call computes any of these
    functions, so library_ms is null."""
    return dict(name=name, route="cuda", source=f"{PKG}/csrc/{source}",
                replaces=f"{TPU_PKG}/{replaces}", library_ms=None, modes=[], **fields)


def trace_tests(pt_mod, td, cam, light, frame_idx, cfg) -> int:
    """Ray/triangle tests one trace launch runs on these inputs (counted by
    the kernel itself), for the data-dependent bound."""
    import torch

    tests = torch.zeros((cfg.height, cfg.width), dtype=torch.int32, device=td.lut.device)
    pt_mod.path_trace_pass(td, cam.position, light, frame_idx, cfg, cam.rotation, tests=tests)
    return int(tests.sum(dtype=torch.int64).item())


def trace_bound(pt_mod, td, cam, light, frame_idx, cfg) -> dict:
    tests = trace_tests(pt_mod, td, cam, light, frame_idx, cfg)
    return bound(12 * cfg.width * cfg.height + 108 * td.num_triangles, TRI_TEST_OPS * tests)


def geometry_bound(cfg, t: int, albedo: bool = False) -> dict:
    per_pixel = 44 + (12 if albedo else 0)
    return bound(per_pixel * cfg.width * cfg.height + 168 * t + (12 * t if albedo else 0),
                 TRI_TEST_OPS * t * cfg.width * cfg.height)


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
    records.append(record(
        "geometry", "geometry.cu", "ops/pallas/geometry.py:116", max_abs_err=err,
        ms=time_ms(lambda: geo_mod.geometry_pass(*geo_args), 20),
        plain_ms=time_ms(lambda: geo_mod.geometry_pass_plain(*geo_args), 3),
        **geometry_bound(cfg, td.num_triangles),
    ))

    # -- path trace, frame 5, 32 bounces --
    k_noisy = pt_mod.path_trace_pass(td, cam.position, light, 5, cfg, cam.rotation)
    p_noisy = pt_mod.path_trace_pass_plain(td, cam.position, light, 5, cfg, rotation=cam.rotation)
    torch.cuda.synchronize()
    bad = share_outside(k_noisy, p_noisy, 1e-5, 1e-5)
    print(f"trace: max_abs {max_abs(k_noisy, p_noisy):.3e}, share outside 1e-5 {bad:.3e}")
    check(torch.isfinite(k_noisy).all().item(), "trace output finite")
    check(bad <= 1e-3, "trace within 1e-5 (abs+rel) on >= 99.9% of elements")
    records.append(record(
        "trace", "pathtrace.cu", "ops/pallas/pathtrace.py:1716",
        max_abs_err=max_abs(k_noisy, p_noisy),
        ms=time_ms(lambda: pt_mod.path_trace_pass(td, cam.position, light, 5, cfg, cam.rotation), 10),
        plain_ms=time_ms(lambda: pt_mod.path_trace_pass_plain(
            td, cam.position, light, 5, cfg, rotation=cam.rotation), 2, warmup=1),
        **trace_bound(pt_mod, td, cam, light, 5, cfg),
    ))
    # the instantiation that counts triangle tests serves the bound only
    tests = torch.zeros((h, w), dtype=torch.int32, device=dev)
    counting_ms = time_ms(
        lambda: pt_mod.path_trace_pass(td, cam.position, light, 5, cfg, cam.rotation, tests=tests), 10)
    print(f"trace {w}x{h}: {records[-1]['ms']:.4f} ms; {counting_ms:.4f} ms with the "
          "triangle-test count compiled in")

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
    records.append(record(
        "atrous_iter", "atrous.cu", "ops/pallas/atrous.py:35", max_abs_err=err,
        ms=time_ms(lambda: at_mod.atrous_iteration(color, p.normal, p.depth, 5, cfg), 20),
        plain_ms=time_ms(lambda: at_mod.atrous_iteration_plain(color, p.normal, p.depth, 5, cfg), 3),
        **bound(40 * h * w, ATROUS_OPS * h * w),
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
    records.append(record(
        "temporal_blend", "atrous.cu", "ops/pallas/atrous.py:278", max_abs_err=err,
        ms=time_ms(lambda: at_mod.temporal_blend(color, prev, py, px, 3, lam, cfg), 20),
        plain_ms=time_ms(lambda: at_mod.temporal_blend_plain(color, prev, py, px, 3, lam, cfg), 5),
        **bound(48 * h * w, BLEND_OPS * h * w),
    ))
    return records


def svgf_kernel_phase(pt, cuda_ops, dev, records) -> None:
    """The SVGF and estimator kernels and modes against their plain versions
    at 1920x1080: adds the records of atrous_iter_var and
    temporal_blend_ramp, and the new modes of geometry and trace."""
    import torch

    from real_time_path_tracing_with_spatiotemporal_filtering_torch.models import presets
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import atrous
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline import frame

    geo_mod, pt_mod, at_mod = cuda_ops
    by_name = {r["name"]: r for r in records}
    w, h = BENCH_SIZE
    cfg = pt.RenderConfig(width=w, height=h, variance_guided=True, accumulation_ramp=True)
    td = pt.precompute_triangle_data(pt.Scene.cornell_box(), dev)
    cam, light = pt.Camera.default(dev), pt.Light.default(dev)
    view, proj = frame.camera_matrices(cam, cfg)
    prev_cam = pt.Camera(cam.position + torch.tensor([0.0, 0.0, 0.5], device=dev), cam.rotation)
    view_p, proj_p = frame.camera_matrices(prev_cam, cfg)
    geo_args = (td, td.lut, cam.position, cam.rotation, light.position,
                light.position + torch.tensor([0.5, 0.0, 0.0], device=dev),
                light.color, light.color * 0.5, view, proj, view_p, proj_p, cfg)

    # -- geometry, 1080p, with and without the albedo planes --
    k = geo_mod.geometry_pass(*geo_args, emit_albedo=True)
    p = geo_mod.geometry_pass_plain(*geo_args, emit_albedo=True)
    torch.cuda.synchronize()
    same = (k.visibility == p.visibility)[..., None]
    err = max_abs(torch.where(same, k.albedo, p.albedo), p.albedo)
    print(f"geometry albedo {w}x{h}: max_abs where vis agrees {err:.3e}")
    check(torch.equal(torch.where(same, k.albedo, p.albedo), p.albedo),
          "geometry albedo planes bit-equal where visibility agrees")
    geo_rec = by_name["geometry"]
    for label, albedo in ((f"{w}x{h} (presets)", False), (f"{w}x{h} emit_albedo", True)):
        geo_rec["modes"].append(dict(
            mode=label, max_abs_err=err if albedo else 0.0,
            ms=time_ms(lambda: geo_mod.geometry_pass(*geo_args, emit_albedo=albedo), 20),
            plain_ms=time_ms(lambda: geo_mod.geometry_pass_plain(*geo_args, emit_albedo=albedo), 2),
            **geometry_bound(cfg, td.num_triangles, albedo)))

    # -- variance-guided a-trous, k = 1..9, seeded color/var on the real G-buffer --
    rng = np.random.default_rng(SEED + 1)
    color = torch.tensor(rng.exponential(0.5, (h, w, 3)).astype(np.float32), device=dev)
    var = torch.tensor((0.1 * rng.random((h, w))).astype(np.float32), device=dev)
    err = 0.0
    for step in range(1, cfg.wavelet_iterations + 1):
        ac, av = at_mod.atrous_iteration_var(color, var, p.normal, p.depth, step, cfg)
        bc, bv = at_mod.atrous_iteration_var_plain(color, var, p.normal, p.depth, step, cfg)
        torch.cuda.synchronize()
        err = max(err, max_abs(ac, bc), max_abs(av, bv))
        check(share_outside(ac, bc, 1e-5, 1e-5) == 0.0 and share_outside(av, bv, 1e-5, 1e-5) == 0.0,
              f"atrous_iter_var k={step} color and var within 1e-5")
    print(f"atrous_iter_var k=1..9 {w}x{h}: max_abs {err:.3e}")
    records.append(record(
        "atrous_iter_var", "atrous.cu", "ops/pallas/atrous.py:104", max_abs_err=err,
        ms=time_ms(lambda: at_mod.atrous_iteration_var(color, var, p.normal, p.depth, 5, cfg), 20),
        plain_ms=time_ms(
            lambda: at_mod.atrous_iteration_var_plain(color, var, p.normal, p.depth, 5, cfg), 3),
        **bound(48 * h * w, ATROUS_VAR_OPS * h * w),
    ))

    # -- ramp blend: random backprojection, both reset modes, adaptive on/off --
    prev = torch.tensor(rng.exponential(0.5, (h, w, 3)).astype(np.float32), device=dev)
    lam = torch.tensor((rng.uniform(0, 1, (h, w)) ** 3).astype(np.float32), device=dev)
    py = torch.tensor(rng.integers(0, h, (h, w)).astype(np.int32), device=dev)
    px = torch.tensor(rng.integers(0, w, (h, w)).astype(np.int32), device=dev)
    prev_age = torch.tensor(rng.integers(0, 40, (h, w)).astype(np.float32), device=dev)
    cons = {
        "id": (torch.tensor(rng.integers(0, 33, (h, w)).astype(np.float32), device=dev),
               p.visibility),
        "normal": (atrous.normal_class(p.normal.flip(1), p.visibility.flip(1)),
                   atrous.normal_class(p.normal, p.visibility)),
    }
    err = 0.0
    for mode, (prev_cons, cur_cons) in cons.items():
        for adaptive in (False, True):
            c = dataclasses.replace(cfg, ramp_reset_mode=mode, adaptive_alpha=adaptive)
            for f in (0, 3):
                args = (color, prev, py, px, f, lam, prev_age, prev_cons, cur_cons, c)
                a_rgb, a_age = at_mod.temporal_blend_ramp(*args)
                b_rgb, b_age = at_mod.temporal_blend_ramp_plain(*args)
                torch.cuda.synchronize()
                err = max(err, max_abs(a_rgb, b_rgb))
                check(torch.equal(a_age, b_age) and share_outside(a_rgb, b_rgb, 1e-6, 1e-6) == 0.0,
                      f"temporal_blend_ramp mode={mode} adaptive={adaptive} frame={f}: "
                      "age bit-equal, rgb within 1e-6")
    print(f"temporal_blend_ramp {w}x{h}: max_abs {err:.3e}")
    ramp_args = (color, prev, py, px, 3, lam, prev_age, *cons["id"], cfg)
    records.append(record(
        "temporal_blend_ramp", "atrous.cu", "ops/pallas/atrous.py:278 (ramp=True)",
        max_abs_err=err,
        ms=time_ms(lambda: at_mod.temporal_blend_ramp(*ramp_args), 20),
        plain_ms=time_ms(lambda: at_mod.temporal_blend_ramp_plain(*ramp_args), 5),
        **bound(64 * h * w, RAMP_BLEND_OPS * h * w),
    ))

    # -- trace modes at 1080p, frame 5 --
    base = pt.RenderConfig(width=w, height=h)
    modes = {
        "nee": dict(nee=True),
        "rr_start_bounce=4": dict(rr_start_bounce=4),
        "spp=4 sample_batches=2": dict(spp=4, sample_batches=2),
        "truncate_radiance": dict(truncate_radiance=True),
    }
    for name in PRESETS:
        preset = getattr(presets, name)(device="cpu", width=16, height=16).cfg
        modes[f"{name} (nee={preset.nee}, spp={preset.spp}, rr={preset.rr_start_bounce})"] = dict(
            nee=preset.nee, spp=preset.spp, rr_start_bounce=preset.rr_start_bounce)
    trace_rec = by_name["trace"]
    for label, over in modes.items():
        c = dataclasses.replace(base, **over)
        kn = pt_mod.path_trace_pass(td, cam.position, light, 5, c, cam.rotation)
        pn = pt_mod.path_trace_pass_plain(td, cam.position, light, 5, c, rotation=cam.rotation)
        torch.cuda.synchronize()
        bad = share_outside(kn, pn, 1e-5, 1e-5)
        err = max_abs(kn, pn)
        print(f"trace {label} {w}x{h}: max_abs {err:.3e}, share outside 1e-5 {bad:.3e}")
        check(torch.isfinite(kn).all().item(), f"trace {label} finite")
        check(bad <= 1e-3, f"trace {label} within 1e-5 (abs+rel) on >= 99.9% of elements")
        trace_rec["max_abs_err"] = max(trace_rec["max_abs_err"], err)
        trace_rec["modes"].append(dict(
            mode=f"{label}, {w}x{h}", max_abs_err=err,
            ms=time_ms(lambda: pt_mod.path_trace_pass(td, cam.position, light, 5, c, cam.rotation),
                       5, warmup=1),
            plain_ms=time_ms(lambda: pt_mod.path_trace_pass_plain(
                td, cam.position, light, 5, c, rotation=cam.rotation), 1, warmup=0),
            **trace_bound(pt_mod, td, cam, light, 5, c)))


def golden_phase(pt, dev) -> None:
    """The kernel route against the JAX package's golden snapshots (48x32,
    6 bounces, 3 iterations): the default trace and frame, the NEE and
    Russian-roulette traces and the variance-guided frame."""
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
    golden = [("pathtrace_48x32_f7", noisy), ("frame3_48x32", rgb)]
    for name, over in (("pathtrace_48x32_f7_nee", dict(nee=True)),
                       ("pathtrace_48x32_f7_rr2", dict(rr_start_bounce=2))):
        c = dataclasses.replace(cfg, **over)
        golden.append((name, pt_mod.path_trace_pass(td, cam.position, light, 7, c, cam.rotation)))
    c = dataclasses.replace(cfg, variance_guided=True)
    hist = frame.init_history(td, c)
    for _ in range(3):
        rgb, hist = frame.render_frame_impl(td, cam, light, hist, c)
    golden.append(("frame3_48x32_var", rgb))
    for name, got in golden:
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


def preset_sequence_phase(pt, dev, name: str) -> dict:
    """8 frames of a preset at 1920x1080 through Renderer.step() on both
    routes; the light and camera move from frame 4 on. Returns the kernel
    launch counts of the kernel route."""
    import torch

    from real_time_path_tracing_with_spatiotemporal_filtering_torch.models import presets
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import LAUNCHES

    factory = getattr(presets, name)
    r_k = factory(device=dev)
    r_p = factory(device=dev, backend="xla")
    w, h = r_k.cfg.width, r_k.cfg.height
    LAUNCHES.clear()
    for f in range(PRESET_FRAMES):
        if f >= PRESET_FRAMES // 2:
            for r in (r_k, r_p):
                r.move_light(dx=0.05)
                r.move_camera(dx=0.01)
        a = r_k.step()
        b = r_p.step()
        torch.cuda.synchronize()
        bad = share_outside(a, b, 1e-3)
        mean = (a - b).abs().mean().item()
        finite = bool(torch.isfinite(a).all().item() and torch.isfinite(b).all().item())
        print(f"{name} frame {f}: kernel vs plain max_abs {max_abs(a, b):.3e}, "
              f"share > 1e-3 {bad:.3e}, mean abs {mean:.3e}, finite {finite}")
        check(finite and tuple(a.shape) == (h, w, 3), f"{name} frame {f} finite, shape (H, W, 3)")
        check(bad <= 0.01 and mean <= 1e-4, f"{name} frame {f} kernel route within 1e-3 on >= 99%")
    counts = dict(LAUNCHES)
    print(f"{name} launch counts over {PRESET_FRAMES} frames: {counts}")
    expected = {"geometry": PRESET_FRAMES, "trace": PRESET_FRAMES,
                "atrous_iter_var": 9 * PRESET_FRAMES, "temporal_blend_ramp": PRESET_FRAMES}
    check(counts == expected, f"{name} launch counts {expected} (atrous_iter 0)")
    return counts


def timing_phase(pt, dev, card: str) -> None:
    """ms/frame of both routes after warm-up, static camera: the default
    config at both sizes, then both presets at 1920x1080."""
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.models import presets

    scene = pt.Scene.cornell_box()
    for w, h in ((WIDTH, HEIGHT), BENCH_SIZE):
        for backend, reps in (("auto", 20), ("xla", 3)):
            r = pt.Renderer(scene, pt.RenderConfig(width=w, height=h, backend=backend), device=dev)
            ms = time_ms(r.step, reps, warmup=3)
            route = "kernels" if backend == "auto" else "plain"
            print(f"ms/frame {w}x{h} {route}: {ms:.3f} ({card})")
    for name in PRESETS:
        for backend, reps, warmup in (("auto", 20, 3), ("xla", 2, 1)):
            r = getattr(presets, name)(device=dev, backend=backend)
            ms = time_ms(r.step, reps, warmup=warmup)
            route = "kernels" if backend == "auto" else "plain"
            print(f"ms/frame {name} {r.cfg.width}x{r.cfg.height} {route}: {ms:.3f} ({card})")


def orbit(pt, i: int, dev):
    """The JAX package's suite camera at frame i (benchmarks/suite.py)."""
    return pt.Camera.orbit([0.0, 1.0, 0.0], 6.0, 0.01 * i, 1.0, device=dev)


def close_share(label: str, a, b, tol: float) -> float:
    """Check that a and b agree within tol (abs and rel) on all but 1e-4 of
    their elements; returns the max abs difference."""
    import torch

    err, bad = max_abs(a, b), share_outside(a, b, tol, tol)
    print(f"{label}: max_abs {err:.3e}, share outside {tol:g} {bad:.3e}, "
          f"bit-equal {torch.equal(a, b)}", flush=True)
    check(bool(torch.isfinite(a.double()).all().item()) and bad <= 1e-4,
          f"{label} within {tol:g} on >= 99.99% of elements")
    return err


def walk_bound(counts, nbytes: float, per_tri: int = 0) -> dict:
    """The bound of a launch, or of a frame's launches, whose walks the
    kernels counted in ``counts`` (ops/cuda/geometry.WalkCounts): their
    triangle and box tests, and ``nbytes`` plus, read once, each node row
    (64 B) and each triangle-test row (48 B, and ``per_tri`` more bytes of
    that triangle) that some walk read."""
    import torch

    tri, box = (int(c.sum(dtype=torch.int64).item()) for c in counts.tests)
    nodes, tris = (int(c.sum(dtype=torch.int64).item()) for c in (counts.nodes, counts.tris))
    return dict(bound(nbytes + 64 * nodes + (48 + per_tri) * tris,
                      TRI_TEST_OPS * tri + SLAB_TEST_OPS * box),
                tri_tests=tri, box_tests=box, node_rows_read=nodes, tri_rows_read=tris)


def geometry_bvh_bound(geo_mod, args, td, cfg) -> dict:
    """The bound of one LBVH geometry launch on ``args``: the output planes
    (44 B a pixel), the 56 parameters, the rows the walks read, and the hit
    position (v0, e1, e2), current and previous vertices and filter normal
    of each distinct committed triangle (120 B)."""
    import torch

    counts = geo_mod.WalkCounts.zeros(cfg.width * cfg.height, td)
    out = geo_mod.geometry_pass_bvh(*args, counts=counts)
    committed = torch.unique(out.visibility[out.visibility > 0]).numel()
    fields = walk_bound(counts, 44 * cfg.width * cfg.height + 224 + 120 * committed)
    return dict(fields, committed_tris=committed)


def stress_geo_args(pt, td, cfg, dev):
    """Geometry-pass inputs on a large scene: the orbit camera at frames 3
    and 2 of the suite's sequence (current and previous), the light moved."""
    import torch

    from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline import frame

    cam, prev = orbit(pt, 3, dev), orbit(pt, 2, dev)
    light = pt.Light.default(dev)
    view, proj = frame.camera_matrices(cam, cfg)
    view_p, proj_p = frame.camera_matrices(prev, cfg)
    return (td, td.lut, cam.position, cam.rotation, light.position,
            light.position + torch.tensor([0.5, 0.0, 0.0], device=dev),
            light.color, light.color * 0.5, view, proj, view_p, proj_p, cfg)


def segments_agree(wf, td, cfg, cam, light, frame_idx, label: str, only=None):
    """The segments of every sample of a frame (those in ``only``, or all),
    kernel against plain on the same input ray state; returns (max abs
    error, plain ms per segment)."""
    import torch

    n = cfg.width * cfg.height
    rays = wf.RayState.empty(n, td.lut.device)
    err, plain_s, launches = 0.0, 0.0, 0
    for batch in range(cfg.sample_batches):
        for sample in range(cfg.spp):
            for seg in range(cfg.max_bounces):
                if only is not None and seg not in only:
                    wf.trace_segment(rays, seg, batch, sample, td, cam.position, cam.rotation,
                                     light, frame_idx, cfg)
                    continue
                plain = wf.RayState(*(t.clone() for t in rays))
                wf.trace_segment(rays, seg, batch, sample, td, cam.position, cam.rotation,
                                 light, frame_idx, cfg)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                wf.trace_segment_plain(plain, seg, batch, sample, td, cam.position,
                                       cam.rotation, light, frame_idx, cfg)
                torch.cuda.synchronize()
                plain_s += time.perf_counter() - t0
                launches += 1
                err = max(err, max_abs(rays.f, plain.f))
                bad = max(share_outside(rays.f, plain.f, 1e-5, 1e-5),
                          (rays.state != plain.state).double().mean().item(),
                          (rays.alive != plain.alive).double().mean().item())
                if bad > 1e-4:
                    check(False, f"trace_segment {label} b{batch} s{sample} seg {seg} "
                                 "within 1e-5 on >= 99.99% of the ray state")
    print(f"trace_segment {label}: {launches} segments against the plain version, "
          f"max_abs {err:.3e}", flush=True)
    check(True, f"trace_segment {label}: each checked segment's ray state within 1e-5")
    return err, 1e3 * plain_s / launches


def frame_segments(wf, td, cfg, cam, light, frame_idx, counts=None, live=None):
    """One 1-sample frame's segments on the card. With ``live`` (a list),
    appends the number of live rays before each launch (a host read)."""
    import torch

    n = cfg.width * cfg.height
    rays = wf.RayState.empty(n, td.lut.device)
    for seg in range(cfg.max_bounces):
        if live is not None:
            live.append(n if seg == 0 else int(rays.alive.sum(dtype=torch.int64).item()))
        wf.trace_segment(rays, seg, 0, 0, td, cam.position, cam.rotation, light, frame_idx,
                         cfg, counts=counts)


def segment_record_fields(wf, td, cfg, cam, light, frame_idx) -> dict:
    """ms per launch of one frame's segments, and the frame's bound over
    its launches: the kernel's counts, the ray-state bytes (a live ray
    reads 52 and writes 56 bytes, a dead one reads its alive flag, segment
    0 writes 56 per ray), the 18 parameters of each launch, and once per
    frame the rows the walks read, with the hit position, normal and
    albedo (60 B) of each triangle tested (a superset of those hit)."""
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda.geometry import (
        WalkCounts,
    )

    n = cfg.width * cfg.height
    counts = WalkCounts.zeros(n, td)
    live = []
    frame_segments(wf, td, cfg, cam, light, frame_idx, counts, live)
    segs = cfg.max_bounces
    state_bytes = 56 * n + sum(108 * k + 4 * n for k in live[1:])
    fields = walk_bound(counts, state_bytes + 72 * segs, per_tri=60)
    fields["bound_ms"] /= segs
    ms = time_ms(lambda: frame_segments(wf, td, cfg, cam, light, frame_idx), 3, warmup=1) / segs
    return dict(ms=ms, live_rays=live, **fields)


def large_kernel_phase(pt, dev, records) -> None:
    """The large-scene kernels against their plain versions and against the
    dense kernels; adds the records of geometry_bvh, trace_segment and
    shadow_segment."""
    import torch

    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import (
        camera as cam_ops,
        pathtrace as plain_pt,
        rng as rng_ops,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import (
        geometry as geo_mod,
        pathtrace as pt_mod,
        wavefront as wf,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import procedural

    t_phase = time.time()
    w, h = BENCH_SIZE
    scenes = {s: pt.precompute_triangle_data(
        pt.Scene.from_arrays(*procedural.subdivided_cornell(s)), dev) for s in (2, 3, 32, 88)}
    # the dense kernels' scenes, from the Cornell box up to 288 triangles
    small_scenes = {32: pt.precompute_triangle_data(pt.Scene.cornell_box(), dev),
                    128: scenes[2], 288: scenes[3]}
    cam, light = orbit(pt, 3, dev), pt.Light.default(dev)
    base = pt.RenderConfig(width=w, height=h)
    path_a = dataclasses.replace(base, **LARGE["A"][1])

    def geometry_agrees(args, label):
        """geometry_bvh against its plain version on every plane; returns
        (max abs error, plain ms)."""
        k = geo_mod.geometry_pass_bvh(*args, emit_albedo=True)
        t0 = time.perf_counter()
        p = geo_mod.geometry_pass_plain(*args, emit_albedo=True)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        err = max(close_share(f"geometry_bvh {name} {label}", getattr(k, name).float(),
                              getattr(p, name).float(), 1e-5) for name in k._fields)
        return err, plain_ms

    # -- LBVH geometry kernel: plain version at path A's and path B's
    # shapes, and the dense kernel from 32 to 288 triangles --
    td = scenes[32]
    args = stress_geo_args(pt, td, path_a, dev)
    err, plain_ms = geometry_agrees(args, f"32768 tris {w}x{h}")
    rec = record("geometry_bvh", "geometry.cu", "ops/pallas/geometry.py:388", max_abs_err=err,
                 ms=time_ms(lambda: geo_mod.geometry_pass_bvh(*args), 20), plain_ms=plain_ms,
                 **geometry_bvh_bound(geo_mod, args, td, path_a))
    records.append(rec)
    td88 = scenes[88]
    args88 = stress_geo_args(pt, td88, base, dev)
    err, plain_ms = geometry_agrees(args88, f"247808 tris {w}x{h}")
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    rec["modes"].append(dict(
        mode=f"247808 triangles (path B), {w}x{h}", max_abs_err=err, plain_ms=plain_ms,
        ms=time_ms(lambda: geo_mod.geometry_pass_bvh(*args88), 20),
        **geometry_bvh_bound(geo_mod, args88, td88, base)))
    for t, tds in small_scenes.items():
        args_s = stress_geo_args(pt, tds, base, dev)
        dense = geo_mod.geometry_pass(*args_s, emit_albedo=True)
        bvh = geo_mod.geometry_pass_bvh(*args_s, emit_albedo=True)
        torch.cuda.synchronize()
        same = all(torch.equal(getattr(dense, f), getattr(bvh, f)) for f in dense._fields)
        mode = dict(mode=f"{t} triangles, {w}x{h}, against the dense kernel", max_abs_err=0.0,
                    ms=time_ms(lambda: geo_mod.geometry_pass_bvh(*args_s), 20),
                    dense_kernel_ms=time_ms(lambda: geo_mod.geometry_pass(*args_s), 20))
        print(f"geometry_bvh vs dense geometry kernel, {t} tris {w}x{h}: bit-equal {same}; "
              f"{mode['ms']:.4f} ms LBVH, {mode['dense_kernel_ms']:.4f} ms dense")
        check(same, f"geometry_bvh equals the dense geometry kernel bit for bit on {t} triangles")
        rec["modes"].append(mode)

    # -- segment tracer: plain version segment by segment at path A's
    # shapes, at path B's (segments 0, 1 and 31) and in further modes at
    # 480x270; the dense kernel from 32 to 288 triangles --
    err, plain_ms = segments_agree(wf, td, path_a, cam, light, 5, f"path A {w}x{h}")
    rec = record("trace_segment", "wavefront.cu", "ops/pallas/wavefront.py:300",
                 max_abs_err=err, plain_ms=plain_ms,
                 **segment_record_fields(wf, td, path_a, cam, light, 5))
    records.append(rec)
    err, plain_ms = segments_agree(wf, td88, base, cam, light, 5, f"path B {w}x{h}",
                                   only=(0, 1, base.max_bounces - 1))
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    rec["modes"].append(dict(mode=f"247808 triangles (path B), 32 bounces, {w}x{h}, per launch",
                             max_abs_err=err, plain_ms=plain_ms,
                             **segment_record_fields(wf, td88, base, cam, light, 5)))
    pw, ph = PLAIN_SIZE
    small = pt.RenderConfig(width=pw, height=ph, max_bounces=8)
    for label, over in (("nee", dict(nee=True)), ("rr_start_bounce=2", dict(rr_start_bounce=2)),
                        ("spp=2 sample_batches=2", dict(spp=2, sample_batches=2)),
                        ("nee rr=2 light_through_walls=False",
                         dict(nee=True, rr_start_bounce=2, light_through_walls=False))):
        c = dataclasses.replace(small, **over)
        err, plain_ms = segments_agree(wf, td, c, cam, light, 5, f"{label} {pw}x{ph}")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["modes"].append(dict(mode=f"{label}, 8 bounces, 32768 tris, {pw}x{ph}",
                                 max_abs_err=err, plain_ms=plain_ms))
    trace_modes = (("parity (32 bounces)", {}), ("path A levers", LARGE["A"][1]),
                   ("nee", dict(nee=True, max_bounces=8)),
                   ("spp=2 sample_batches=2", dict(spp=2, sample_batches=2, max_bounces=8)))
    for t, tds in small_scenes.items():
        for label, over in trace_modes if t == 288 else trace_modes[:2]:
            c = dataclasses.replace(base, **over)
            a = pt_mod.path_trace_pass(tds, cam.position, light, 5, c, cam.rotation)
            b = wf.path_trace_wavefront(tds, cam.position, light, 5, c, cam.rotation)
            torch.cuda.synchronize()
            mode = dict(
                mode=f"{t} triangles, {label}, {w}x{h}, against the dense trace kernel",
                max_abs_err=0.0, launches=c.max_bounces * c.spp * c.sample_batches,
                frame_ms=time_ms(lambda: wf.path_trace_wavefront(tds, cam.position, light, 5, c,
                                                                cam.rotation), 3, warmup=1),
                dense_kernel_ms=time_ms(lambda: pt_mod.path_trace_pass(
                    tds, cam.position, light, 5, c, cam.rotation), 3, warmup=1))
            print(f"segment tracer vs trace kernel, {t} tris {label} {w}x{h}: bit-equal "
                  f"{torch.equal(a, b)}, max_abs {max_abs(a, b):.3e}; {mode['frame_ms']:.3f} ms "
                  f"segments, {mode['dense_kernel_ms']:.3f} ms dense")
            check(torch.equal(a, b), f"segment tracer equals the trace kernel on {t} triangles "
                                     f"({label})")
            rec["modes"].append(mode)

    # -- shadow segment: path C's bounce-0 shadow rays at 1920x1080 --
    path_c = dataclasses.replace(base, **LARGE["C"][1])
    geo = geo_mod.geometry_pass_bvh(*stress_geo_args(pt, td, path_c, dev), emit_albedo=True)
    n = w * h
    idx = torch.arange(n, device=dev)
    px, py = idx % w, torch.div(idx, w, rounding_mode="floor")
    state, gx, gy = rng_ops.sample_jitter(px, py, 5, 0, 0)
    dirs = cam_ops.pixel_rays(px, py, w, h, path_c.fov, jitter_x=0.0 * gx, jitter_y=0.0 * gy,
                              rotation=cam.rotation)
    carry = plain_pt.primary_carry(
        cam.position.expand(n, 3), dirs, state, geo.visibility.reshape(n),
        geo.world_pos.reshape(n, 3), geo.normal.reshape(n, 3), geo.albedo.reshape(n, 3),
        light.position, light.color * path_c.light_intensity, path_c, defer_nee_shadow=True)
    o = carry[0]
    w_l, s_t, _, mask = carry[6]
    cap = torch.where(mask, s_t, torch.zeros_like(s_t))
    k = wf.shadow_segment(o, w_l, cap, mask, td, path_c)
    t0 = time.perf_counter()
    p = wf.shadow_segment_plain(o, w_l, cap, mask, td, path_c)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    bad = (k != p).double().mean().item()
    print(f"shadow_segment path C {w}x{h}: {int(mask.sum().item())} sampling lanes, "
          f"{int(p.sum().item())} occluded, mismatch share {bad:.3e}, bit-equal {torch.equal(k, p)}")
    check(bad <= 1e-4, "shadow_segment matches its plain version on >= 99.99% of lanes")
    counts = geo_mod.WalkCounts.zeros(n, td)
    wf.shadow_segment(o, w_l, cap, mask, td, path_c, counts=counts)
    # per lane: origin, direction and cap (28 B) and the mask read, the flag written
    records.append(record(
        "shadow_segment", "wavefront.cu", "ops/pallas/wavefront.py:487",
        max_abs_err=float((k != p).any().item()),
        ms=time_ms(lambda: wf.shadow_segment(o, w_l, cap, mask, td, path_c), 20),
        plain_ms=plain_ms, **walk_bound(counts, 36 * n)))
    print(f"large-scene kernel phase: {time.time() - t_phase:.1f} s", flush=True)


def large_sequence_phase(pt, dev, path: str) -> dict:
    """Frames of a large-scene path through Renderer.step() on both routes
    under the suite's orbit camera; returns the kernel launch counts."""
    import torch

    from real_time_path_tracing_with_spatiotemporal_filtering_torch.models import presets
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import LAUNCHES

    splits, over, frames, (w, h) = LARGE[path]
    t_phase = time.time()
    r_k = presets.cornell_stress(splits=splits, device=dev, width=w, height=h, **over)
    r_p = presets.cornell_stress(splits=splits, device=dev, width=w, height=h, backend="xla",
                                 **over)
    LAUNCHES.clear()
    for f in range(frames):
        r_k.camera = r_p.camera = orbit(pt, f, dev)
        a = r_k.step()
        b = r_p.step()
        torch.cuda.synchronize()
        bad = share_outside(a, b, 1e-3)
        mean = (a - b).abs().mean().item()
        finite = bool(torch.isfinite(a).all().item() and torch.isfinite(b).all().item())
        print(f"path {path} frame {f}: kernel vs plain max_abs {max_abs(a, b):.3e}, "
              f"share > 1e-3 {bad:.3e}, mean abs {mean:.3e}, finite {finite}")
        check(finite and tuple(a.shape) == (h, w, 3), f"path {path} frame {f} finite, shape (H, W, 3)")
        check(bad <= 0.01 and mean <= 1e-4, f"path {path} frame {f} kernel route within 1e-3 on >= 99%")
    counts = dict(LAUNCHES)
    expected = {k: frames * v for k, v in LARGE_PER_FRAME[path].items()}
    print(f"path {path} ({r_k.tri_data.num_triangles} tris, {w}x{h}) launch counts over "
          f"{frames} frames: {counts}; {time.time() - t_phase:.1f} s")
    check(counts == expected, f"path {path} launch counts {expected}")
    return counts


def large_timing_phase(pt, dev, card: str) -> None:
    """presets.cornell_stress() with its defaults and at BVH_MIN_TRIANGLES
    (splits=2) on the kernel route, then ms/frame of paths A, B and C at
    1920x1080 on the kernel route, and of path A's plain route once."""
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.models import presets

    import torch

    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import LAUNCHES

    t_phase = time.time()
    w, h = BENCH_SIZE
    # the preset's own default (512 triangles, beyond the dense kernels'
    # tables) and 128 triangles, where the LBVH takes over
    for over in ({}, dict(splits=2)):
        r = presets.cornell_stress(device=dev, **over)
        LAUNCHES.clear()
        img = r.step()
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        print(f"cornell_stress({over}) ({r.tri_data.num_triangles} tris, "
              f"{r.cfg.width}x{r.cfg.height}): launch counts {counts}")
        check(bool(torch.isfinite(img).all().item()) and counts.get("geometry_bvh") == 1
              and counts.get("trace_segment") == r.cfg.max_bounces,
              f"cornell_stress({over}) renders on the kernel route through the LBVH kernels")
    for path, backend, reps, warmup in (("A", "auto", 10, 2), ("B", "auto", 5, 2),
                                        ("C", "auto", 10, 2), ("A", "xla", 1, 0)):
        splits, over, _, _ = LARGE[path]
        r = presets.cornell_stress(splits=splits, device=dev, width=w, height=h, backend=backend,
                                   **over)
        r.camera = orbit(pt, 0, dev)
        ms = time_ms(r.step, reps, warmup=warmup)
        route = "kernels" if backend == "auto" else "plain"
        print(f"ms/frame path {path} ({r.tri_data.num_triangles} tris) {w}x{h} {route}: "
              f"{ms:.3f} ({card})")
    print(f"large-scene timing phase: {time.time() - t_phase:.1f} s", flush=True)


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
        entry = ""
        for line in _build.build_log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            elif "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas {entry}: {line.strip()}")
        records = kernel_phase(pt, (geo_mod, pt_mod, at_mod), dev)
        svgf_kernel_phase(pt, (geo_mod, pt_mod, at_mod), dev, records)
        golden_phase(pt, dev)
        large_kernel_phase(pt, dev, records)
        paths = {"default": sequence_phase(pt, dev)}
        for name in PRESETS:
            paths[name] = preset_sequence_phase(pt, dev, name)
        for path in LARGE:
            paths[path] = large_sequence_phase(pt, dev, path)
        timing_phase(pt, dev, card)
        large_timing_phase(pt, dev, card)
    except (PhaseError, RuntimeError, ValueError, subprocess.SubprocessError) as exc:
        print(f"chip_smoke: failed: {exc}", file=sys.stderr)
        return 1
    for r in records:
        r["launches_by_path"] = {path: counts.get(r["name"], 0) for path, counts in paths.items()}
        r["launches"] = sum(r["launches_by_path"].values())
    if not all(r["launches"] > 0 for r in records):
        print("chip_smoke: failed: a kernel was not launched on any main path", file=sys.stderr)
        return 1
    order = ["name", "route", "source", "replaces", "launches", "launches_by_path",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "modes"]
    order += ["tri_tests", "box_tests", "node_rows_read", "tri_rows_read", "committed_tris",
              "live_rays"]
    print(json.dumps({"kernels": [{k: r[k] for k in order if k in r} for r in records]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
