#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``real_time_path_tracing_with_spatiotemporal_
filtering_torch/csrc`` with nvcc, then:

- checks each kernel against its plain PyTorch version on the card, bit
  for bit (``torch.equal``): the default-config kernels at the reference's
  1000x800 frame, and the SVGF and estimator modes (variance-guided a-trous, the ramp blend, the tracer with
  NEE / Russian roulette / several samples / truncate_radiance, the
  geometry kernel's albedo planes) at 1920x1080; both a-trous kernels at
  every stride k = 1..9, and timed apart at k = 1, 5 and 9 (their records'
  ``modes``); both blends on a frame's own backprojection (the orbit
  camera stepping one frame; the records' ``ms``) and on a random one (a
  mode);
- checks the dense geometry kernel, whose warps cull the triangle table per
  8x4 tile, bit for bit in both modes, with and without the albedo planes,
  at three camera poses (default, orbit, near a wall), four sizes and 32,
  128 and 288 triangles, its counted tests and survivors against the
  cull's plain twin (ops/tilecull.py), and bounds it by the work counted;
- checks the kernel route against the repository's golden images;
- checks the large-scene kernels (the LBVH geometry kernel, the segment
  tracer and the shadow segment) against their plain versions at 1920x1080
  on the 32,768- and 247,808-triangle scenes of paths A and B (the segment
  tracer on B at segments 0, 1 and 31), at 480x270 for the tracer's further
  modes, and against the dense kernels (bit for bit, and timed) at
  1920x1080 on 32, 128 and 288 triangles, where both run;
- checks the path-gradient / multi-res slice's kernel modes bit for bit
  against their plain versions at 1920x1080: the segment tracer's
  explicit-pixel mode at the path gradient's 640x360 stratum pixels on
  32,768 triangles and on path D's phased coarse tail with the G-buffer
  seed, and the geometry kernels' visibility-only mode (the drop-in for
  ops/gbuffer.visibility_pass) on the Cornell box and on 32,768 triangles;
- checks the model matrix's two kernels (csrc/model.cu: the moved tables
  and the refit of the LBVH) bit for bit against their plain versions at
  32, 128, 32,768 and 247,808 triangles, the refitted node table against
  the host's pack of the rest tree over the moved triangles, and runs the
  move under ``torch.cuda.set_sync_debug_mode("error")``; prints what the
  refitted tree costs the walks at path MA's last pose (box tests and
  device ms against a fresh tree and the unmoved scene);
- drives ten main paths through ``Renderer.step()`` on both routes
  (kernels, and ``backend="xla"``, the plain version), each with the launch
  counts read just after it: the default config for 16 frames at 1000x800,
  the ``cornell_box_quality`` and ``cornell_box_interactive`` presets for 8
  frames at 1920x1080, and the large scenes of ``presets.cornell_stress``
  under the orbit camera: path A (32,768 triangles, 8 bounces, Russian
  roulette from 2, adaptive alpha; 4 frames at 1920x1080), path B (247,808
  triangles, the default config; 2 frames at 480x270) and path C (A with the
  G-buffer seed and NEE; 4 frames at 1920x1080); path D (A with multi-res
  indirect, the G-buffer seed, grid jitter, variance-guided SVGF and the
  ramp in "normal" mode; 4 frames at 1920x1080) and path E (the Cornell
  box with the path gradient, variance-guided SVGF and the ramp under a
  drifting light; 8 frames at 512x512); paths M (the default config on the
  Cornell box) and MA (path A's scene and config under a fixed camera),
  their scene rotating 0.08 rad a frame by ``Renderer.set_model`` (4 frames
  at 1920x1080);
- drives the app path (app_phase): ``cli_torch.main`` at the CLI's
  defaults (1000x800, 32 bounces, 9 iterations; 16 frames with the light
  orbiting, then 8 checkpointed and 8 resumed, bit-equal to the straight
  run's frame 15), the native and Python OBJ loaders on the 32,768-triangle
  subdivided box (equal arrays), ``cli_torch.main`` on that OBJ at
  1920x1080 with path C's flags (8 frames), the viewer headless at its
  default 320x256 with ``--ramp --nee`` (8 frames), ``apply_keys`` on the
  card under ``torch.cuda.set_sync_debug_mode("error")``, the six quality
  bars of ``benchmarks/quality.BARS`` (the JAX package's
  tests/test_quality.py) with their rMSE and improvement, and the three
  ``examples/*_torch.py`` as subprocesses; the launch counts of the cli,
  cli_obj, viewer and quality paths join the others;
- checks the eight micro-kernels (csrc/micro.cu, the JAX package's Mosaic
  micro-benchmarks) against their plain twins at two iteration counts, bit
  for bit on the output and every carry, then runs the port's
  micro-benchmark (benchmarks/mosaic_micro.py) at the JAX counts, with its
  launches counted as the path ``mosaic_micro``: ns per iteration by slope;
  the last timed launch at each count must give out == x with finite
  carries, and, but for the vec primitives, equal its plain twin bit for
  bit at the lower count;
- runs the measurement entry points: ``bench_torch.run_bench`` at 1920x1080
  and the port's benchmark suite in ``--quick`` mode with device time,
  printing their JSON lines, each with its launch counts;
- times each kernel as the device time of its launches, read from a
  ``torch.profiler`` trace (``ms``; the host's cost of the call does not
  enter it), beside CUDA events around back-to-back wrapper calls
  (``call_ms``), and times the frames of both routes with CUDA events;
- reports the lane efficiency of the two trace kernels and of the LBVH
  geometry and shadow kernels' walks (lanes doing work over 32 x warp
  steps, counted by their counting instantiations) as ``lane_eff`` on the
  ``trace``, ``trace_segment``, ``geometry_bvh`` and ``shadow_segment``
  records and modes, beside it on the ``trace`` record and modes the dense
  shadow loop's plane-first cut (``shadow_cut``: the share of its plane
  pass's warp steps that its barycentric pass saved, and its whole tests
  a pixel), and
  checks that the dense trace's counting launch gives the timed launch's
  image and that the segment kernel's live lists hold exactly the rays
  that go on;
- models, from the same runs' path lengths and walk steps, the lane
  efficiency the earlier designs of the two trace kernels (one thread per
  pixel; one thread per ray slot) would have had on the same work, and
  prints it on a line of its own, apart from what was measured.

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
import statistics
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
# The path-gradient / multi-res paths: (splits of presets.cornell_stress,
# or None for the Cornell box; config overrides, frames, size). D is row
# 4c'' of the JAX package's benchmarks/suite.py (:212-227, on rows 4c and
# 4c' at :177-210) under the orbit camera, E is row 2e (:124-138) with the
# light moved by 0.05 before each frame. D's plain route runs at 1920x1080
# too (its size must stay divisible by the stride).
RECOMMENDED = dict(max_bounces=8, rr_start_bounce=2, adaptive_alpha=True, indirect_split=1,
                   indirect_stride=4, gbuffer_primary=True, indirect_jitter=True,
                   variance_guided=True, accumulation_ramp=True, ramp_reset_mode="normal")
PATHGRAD = dict(variance_guided=True, accumulation_ramp=True, path_gradient=True)
GRADIENT_PATHS = {
    "D": (32, RECOMMENDED, 4, BENCH_SIZE),
    "E": (None, PATHGRAD, 8, (512, 512)),
}
GRADIENT_PER_FRAME = {
    # the truncated full-res trace is bounce 0 off the G-buffer (no launch);
    # the 480x270 coarse tail runs segments 1-7
    "D": {"geometry_bvh": 1, "trace_segment": 7, "atrous_iter_var": 9, "temporal_blend_ramp": 1},
    # the 171x171 stratum re-trace runs 32 segments
    "E": {"geometry": 1, "trace": 1, "trace_segment": 32, "atrous_iter_var": 9,
          "temporal_blend_ramp": 1},
}
LARGE_PER_FRAME = {
    "A": {"geometry_bvh": 1, "trace_segment": 8, "atrous_iter": 9, "temporal_blend": 1},
    "B": {"geometry_bvh": 1, "trace_segment": 32, "atrous_iter": 9, "temporal_blend": 1},
    "C": {"geometry_bvh": 1, "shadow_segment": 1, "trace_segment": 7, "atrous_iter": 9,
          "temporal_blend": 1},
}
# The moved-scene paths, through Renderer.set_model: the scene rotates
# MODEL_STEP rad a frame about the vertical axis through (0, 1, 0), as in
# the JAX package's tests/test_model.py. (splits of presets.cornell_stress,
# or None for the Cornell box; config overrides, frames, size.) M is the
# default config on the Cornell box under the default camera, MA path A's
# scene and config with the camera held at the orbit's frame-0 pose. Each
# frame adds the move's launches to its unmoved twin's (default at
# 1920x1080, A): the refit only where the frame walks the tree
# (pipeline/frame.walks_tree), so M adds transform_tables alone.
MODEL_STEP = 0.08
MODEL_PATHS = {
    "M": (None, {}, 4, BENCH_SIZE),
    "MA": (32, LARGE["A"][1], 4, BENCH_SIZE),
}
MODEL_PER_FRAME = {
    "M": {"geometry": 1, "trace": 1, "atrous_iter": 9, "temporal_blend": 1,
          "transform_tables": 1},
    "MA": {**LARGE_PER_FRAME["A"], "transform_tables": 1, "bvh_refit": 1},
}
# The move's kernels are held to their plain versions at these scene sizes
# (triangles: splits of subdivided_cornell, None for the Cornell box): the
# paths' 32 and 32,768, the LBVH's threshold and path B's 247,808.
MODEL_SCENES = {32: None, 128: 2, 32768: 32, 247808: 88}
PATHS = {**LARGE, **GRADIENT_PATHS, **MODEL_PATHS}
PER_FRAME = {**LARGE_PER_FRAME, **GRADIENT_PER_FRAME, **MODEL_PER_FRAME}

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): HBM bytes
# per second and float32 operations per second outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
L2_BYTES = 50 * 2**20
# Floating-point operations counted per unit of work (transcendentals count
# as one): a ray/triangle test (six 3-term dot products, t, u, v, u + v;
# csrc/common.cuh tri_test), a plane test of the dense trace's shadow loop
# (two 3-term dot products, the numerator and the bound's product;
# csrc/common.cuh may_reach), one a-trous pixel (9 taps), one
# variance-guided a-trous pixel (9 taps and the 9-tap prefilter), one blend
# pixel and one ramp-blend pixel.
TRI_TEST_OPS = 39
PLANE_TEST_OPS = 12
# a ray/box slab test (csrc/bvh.cuh slab): 6 subtractions, 6 products, 3
# min and 3 max per axis pair, 4 more for the entry and exit, the clamp at
# 0 and 3 compares and ands
SLAB_TEST_OPS = 26
ATROUS_OPS = 273
ATROUS_VAR_OPS = 328
# the strides at which the a-trous kernels are timed apart (the frame runs 1..9)
ATROUS_KS = (1, 5, 9)
BLEND_OPS = 12
RAMP_BLEND_OPS = 20
# The move (csrc/model.cu), a triangle: the transform (9 coordinates of 3
# products and 3 adds, 54), the edges 6, three cross products 27, |n|^2 5,
# its reciprocal 1, n1 and n2 6, the square root and the normal 4, d0, d1
# and d2 17, the albedo's compares 2, the largest |coordinate| 17; the
# refit's leaf box (12 min and max, the pad 6, the pad's scale 3) and a
# row's union (6).
TRANSFORM_OPS = 139
REFIT_LEAF_OPS = 21
REFIT_ROW_OPS = 6


class PhaseError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    print(("PASS " if cond else "FAIL ") + what, flush=True)
    if not cond:
        raise PhaseError(what)


def kernel_ms(fn, kernel: str, calls: int = 20, warmup: int = 2, mean: bool = False) -> dict:
    """``ms``: the device time of one launch of ``kernel`` (its CUDA function
    name), the median (``mean``: the mean) over its launches in ``calls``
    calls of ``fn``, read from a torch.profiler trace, so the host's cost of
    making the launches does not enter it; ``call_ms``: CUDA events around
    back-to-back calls of ``fn`` (time_fn), per call, or per launch of the
    kernel where a call makes several, which shows the host's cost."""
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils.profiling import (
        kernel_launch_ms,
        time_fn,
    )

    launches = kernel_launch_ms(fn, calls, warmup).get(kernel, [])
    if not launches:
        raise PhaseError(f"{kernel} was not launched under the profiler")
    ms = sum(launches) / len(launches) if mean else statistics.median(launches)
    return dict(ms=ms, call_ms=time_fn(fn, iters=calls, warmup=warmup) * calls / len(launches))


def from_hbm(fn, inputs: tuple):
    """``fn(*inputs)`` to time with its inputs read from HBM: each call
    takes the next of enough copies of ``inputs`` (together more than twice
    the L2) that the launches between two calls on one copy have moved it
    out of L2, as the frame's other kernels move out a kernel's inputs.
    Without it, inputs under the L2's size stay there from one timed launch
    to the next, and the kernel beats the HBM rate of its bound."""
    import itertools

    nbytes = sum(x.numel() * x.element_size() for x in inputs)
    copies = [inputs] + [tuple(x.clone() for x in inputs)
                         for _ in range(-(-2 * L2_BYTES // nbytes))]
    turn = itertools.cycle(copies)
    return lambda: fn(*next(turn))


def same_bits(label: str, a, b) -> float:
    """Check that a and b are bit-equal (torch.equal); returns their max
    abs difference."""
    import torch

    err = max_abs(a, b)
    print(f"{label}: max_abs {err:.3e}, bit-equal {torch.equal(a, b)}", flush=True)
    check(torch.equal(a, b), f"{label} bit-equal to its plain version")
    return err


def share_outside(a, b, atol: float, rtol: float = 0.0) -> float:
    """Share of elements where |a - b| > atol + rtol |b| (NaN counts)."""
    import torch

    ok = torch.isclose(a.double(), b.double(), rtol=rtol, atol=atol)
    return 1.0 - ok.double().mean().item()


def max_abs(a, b) -> float:
    return (a.double() - b.double()).abs().max().item()


def routes_agree(label: str, a, b, shape) -> float:
    """Hold a kernel-route image ``a`` to its plain-route twin ``b`` by the
    paths' gate: both finite, ``a`` of ``shape``, at least 99% of the
    values within 1e-3 and a mean abs difference of at most 1e-4. Prints
    the comparison and returns the max abs difference."""
    import torch

    torch.cuda.synchronize()
    bad = share_outside(a, b, 1e-3)
    mean = (a - b).abs().mean().item()
    err = max_abs(a, b)
    finite = bool(torch.isfinite(a).all().item() and torch.isfinite(b).all().item())
    print(f"{label}: kernel vs plain max_abs {err:.3e}, share > 1e-3 {bad:.3e}, "
          f"mean abs {mean:.3e}, finite {finite}")
    check(finite and tuple(a.shape) == tuple(shape), f"{label} finite, shape {tuple(shape)}")
    check(bad <= 0.01 and mean <= 1e-4, f"{label} kernel route within 1e-3 on >= 99%")
    return err


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def record(name: str, source: str, replaces: str, **fields) -> dict:
    """One kernel's entry of the JSON line; ``fields`` hold max_abs_err, ms,
    call_ms, plain_ms and the bound. ``replaces`` is a file of the JAX
    package, or of the repository's ``benchmarks/``. No single PyTorch call
    computes any of these functions, so library_ms is null."""
    if not replaces.startswith("benchmarks/"):
        replaces = f"{TPU_PKG}/{replaces}"
    return dict(name=name, route="cuda", source=f"{PKG}/csrc/{source}", replaces=replaces,
                library_ms=None, modes=[], **fields)


def trace_tests(pt_mod, td, cam, light, frame_idx, cfg, row_offset: int = 0,
                rows=None) -> tuple:
    """Whole ray/triangle tests and the NEE shadow loop's plane tests one
    trace launch runs on these inputs (counted by the kernel itself), for
    the data-dependent bound; over the row slab ``row_offset``, ``rows``
    when given."""
    import torch

    rows = cfg.height if rows is None else rows
    tests = torch.zeros((rows, cfg.width), dtype=torch.int32, device=td.lut.device)
    shadow = torch.zeros(4, dtype=torch.int64, device=td.lut.device)
    pt_mod.path_trace_pass(td, cam.position, light, frame_idx, cfg, cam.rotation, tests=tests,
                           shadow=shadow, row_offset=row_offset, rows=rows)
    return int(tests.sum(dtype=torch.int64).item()), int(shadow[0].item())


def trace_bound(pt_mod, td, cam, light, frame_idx, cfg, row_offset: int = 0, rows=None) -> dict:
    tests, planes = trace_tests(pt_mod, td, cam, light, frame_idx, cfg, row_offset, rows)
    rows = cfg.height if rows is None else rows
    return bound(12 * cfg.width * rows + 108 * td.num_triangles,
                 TRI_TEST_OPS * tests + PLANE_TEST_OPS * planes)


def lane_share(lanes) -> tuple:
    """(outer loop, walks) lane efficiency from a kernel's four lane counts:
    lanes that did the work over 32 x warp steps."""
    a, b, c, d = (int(v) for v in lanes.tolist())
    return a / max(32 * b, 1), c / max(32 * d, 1)


# Modelled, not measured: the lane efficiency the earlier designs of the
# trace kernels would have had on each run's work, by record or mode; printed
# on a line of its own.
MODELLED: dict = {}


def one_thread_per_pixel_share(path_len) -> float:
    """A model of the bounce loop's lane efficiency in the earlier dense
    kernel (one thread per pixel on 16x16 blocks, a warp = 2 rows x 16
    columns, the sample loop around the path), from each sample's path
    length: a warp runs, for each sample, the longest path among its lanes.
    An upper bound: it counts no other divergence."""
    import torch

    s, h, w = path_len.shape
    padded = torch.zeros((s, -(-h // 16) * 16, -(-w // 16) * 16), dtype=torch.int64,
                         device=path_len.device)
    padded[:, :h, :w] = path_len
    warps = padded.reshape(s, padded.shape[1] // 2, 2, padded.shape[2] // 16, 16)
    steps = warps.amax(dim=(2, 4)).sum().item()
    return path_len.sum(dtype=torch.int64).item() / max(32 * steps, 1)


def trace_counts(pt_mod, td, cam, light, frame_idx, cfg, label: str) -> dict:
    """The dense trace kernel's counting launch on these inputs, which must
    give the image of the launch that does not count: ``lane_eff``, the
    lane efficiency of the bounce loop and of the triangle loops (whole
    tests), and ``shadow_cut``, the NEE shadow loop's plane-first cut:
    ``skipped_share``, the share of its plane pass's warp steps that its
    barycentric pass did not take, ``bary_per_pixel``, its whole tests a
    pixel, ``bary_lane_eff``, their lanes over 32 x the barycentric warp
    steps, and ``sums``, the kernel's four counts (all 0 without NEE). The
    earlier kernel's lane efficiency, modelled from the same paths, goes to
    MODELLED under ``label``."""
    import torch

    dev = td.lut.device
    lanes = torch.zeros(4, dtype=torch.int64, device=dev)
    shadow = torch.zeros(4, dtype=torch.int64, device=dev)
    path_len = torch.zeros((cfg.sample_batches * cfg.spp, cfg.height, cfg.width),
                           dtype=torch.int32, device=dev)
    args = (td, cam.position, light, frame_idx, cfg, cam.rotation)
    counted = pt_mod.path_trace_pass(*args, path_len=path_len, lanes=lanes, shadow=shadow)
    check(torch.equal(counted, pt_mod.path_trace_pass(*args)),
          f"{label}: the counting launch gives the image of the timed one")
    loop, walk = lane_share(lanes)
    MODELLED[label] = dict(bounce_loop_one_thread_per_pixel=one_thread_per_pixel_share(path_len))
    sums = shadow.tolist()
    _, plane_steps, bary, bary_steps = sums
    skipped = 1.0 - bary_steps / plane_steps if plane_steps else 0.0
    return dict(lane_eff=dict(bounce_loop=loop, triangle_loops=walk),
                shadow_cut=dict(skipped_share=skipped,
                                bary_per_pixel=bary / (cfg.width * cfg.height),
                                bary_lane_eff=bary / max(32 * bary_steps, 1), sums=sums))


# The dense geometry kernel (csrc/geometry.cu geometry_kernel), counted from
# its code: one pixel's ray (pixel_ray) and the epilogue of a hit pixel
# (hit_position 12; depth 15; the gradient's normal 25, barycentric solve and
# recombination 107, two Phong evaluations 154, lambda 25; the
# backprojection's solve, recombination, projection and clamps 145), 27 of it
# in the visibility-only mode. The tile cull is this design's own overhead,
# not work the G-buffer needs, so it stays out of the bound and is reported
# beside it: the cull of one triangle (outside_tile: v0 + e1, v0 + e2 and
# three v - o, 15; the three-term absolute sums of v0, e1, e2 and the scale,
# 19; each vertex's margin, 21; four planes of three dot products, products,
# negations and compares, and their ands and ors, 108) and the frustum of one
# warp tile (tile_frustum: four screen coordinates 20, four edges 28, four
# cross products 36, their orientation 36, four lengths 24; pix and |o|_1, 7).
CULL_OPS = 163
FRUSTUM_OPS = 151
RAY_OPS = 39
EPILOGUE_OPS = 483
VIS_EPILOGUE_OPS = 27


def dense_geometry_bound(cfg, t: int, vis, tests: int, albedo: bool = False,
                         vis_only: bool = False) -> dict:
    """The bound of one dense geometry launch that made ``tests`` triangle
    tests: the output planes (44 B a pixel, 56 with the albedo planes, 20 in
    the visibility-only mode), the 56 parameters and the table (168 B a
    triangle, 12 more with albedo) moved once; the ray of each pixel, the
    tests and the epilogue of each hit pixel (``vis`` > 0). ``cull_ops``:
    the operations of the kernel's tile cull, every triangle of every warp
    tile and the tile's frustum, which explain its time and are no part of
    the bound."""
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import tilecull

    w, h = cfg.width, cfg.height
    n = w * h
    rows, cols = tilecull.tile_grid(cfg)
    hits = int((vis > 0).sum().item())
    per_pixel = 20 if vis_only else 44 + (12 if albedo else 0)
    nbytes = per_pixel * n + 224 + (168 + (12 if albedo else 0)) * t
    ops = (TRI_TEST_OPS * tests + RAY_OPS * n
           + (VIS_EPILOGUE_OPS if vis_only else EPILOGUE_OPS) * hits)
    return dict(bound(nbytes, ops), tri_tests=tests, tests_per_pixel=tests / n,
                cull_ops=(CULL_OPS * t + FRUSTUM_OPS) * rows * cols)


def dense_geometry_fields(geo_mod, args, cfg, vis_only: bool = False,
                          albedo: bool = False, row_offset: int = 0, rows=None) -> dict:
    """The work of one dense geometry launch on ``args`` (geometry_pass's,
    or visibility_pass's when ``vis_only``) from the kernel's counting
    launch, and its bound: the tests and survivors a pixel, checked
    against the cull's plain twin (ops/cuda/geometry.dense_counts_plain)
    bit for bit. ``bound_ms_untiled``: the bound of every triangle tested
    for every pixel (the kernel before the cull). ``row_offset``, ``rows``:
    a launch over that row slab."""
    import torch

    td = args[0]
    t = td.num_triangles
    slab = dict(row_offset=row_offset, rows=rows)
    if vis_only:
        run = lambda **kw: geo_mod.visibility_pass(*args, **slab, **kw)
        cam_pos, rot = args[1], args[5]
    else:
        run = lambda **kw: geo_mod.geometry_pass(*args, emit_albedo=albedo, **slab, **kw)
        cam_pos, rot = args[2], args[3]
    rows = cfg.height if rows is None else rows
    counts = geo_mod.dense_counts(cfg, cam_pos.device, rows)
    out = run(counts=counts)
    want = geo_mod.dense_counts_plain(td, cam_pos, rot, cfg, row_offset, rows)
    torch.cuda.synchronize()
    check(torch.equal(counts, want), f"dense geometry counts {t} tris {cfg.width}x{cfg.height} "
                                     f"rows {row_offset}..{row_offset + rows}: tests and "
                                     "survivors equal the cull's plain twin")
    tests = int(counts[0].sum(dtype=torch.int64).item())
    # the slab's pixels and warp tiles are those of a frame of its rows
    part = dataclasses.replace(cfg, height=rows)
    fields = dense_geometry_bound(part, t, out.visibility, tests, albedo, vis_only)
    fields["survivors_per_pixel"] = counts[1].double().mean().item()
    fields["bound_ms_untiled"] = dense_geometry_bound(
        part, t, out.visibility, t * cfg.width * rows, albedo, vis_only)["bound_ms"]
    return fields


def atrous_modes(kernel_fn, plain_fn, name: str, size: str, steps: int,
                 bound_fields: dict) -> tuple:
    """An a-trous kernel (``name``) against its plain version at every
    stride k = 1..steps, bit for bit, and timed at k = 1, 5 and 9. Returns
    the max abs difference and the modes: device ms of a launch, the plain
    version's ms and the bound (the same at every k: the taps move no more
    bytes and do no more operations as k grows)."""
    import torch

    from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils.profiling import time_fn

    err, modes = 0.0, []
    for k in range(1, steps + 1):
        got, want = kernel_fn(k), plain_fn(k)
        torch.cuda.synchronize()
        if isinstance(got, tuple):
            for part, a, b in zip(("color", "var"), got, want):
                err = max(err, same_bits(f"{name} k={k} {part}", a, b))
        else:
            err = max(err, same_bits(f"{name} k={k}", got, want))
        if k in ATROUS_KS:
            modes.append(dict(mode=f"k={k}, {size}",
                              **kernel_ms(lambda: kernel_fn(k), f"{name}_kernel"),
                              plain_ms=time_fn(lambda: plain_fn(k), iters=3), **bound_fields))
            print(f"{name}_kernel k={k} {size}: {modes[-1]['ms']:.4f} ms", flush=True)
    return err, modes


def atrous_record(name: str, replaces: str, err: float, modes: list) -> dict:
    """An a-trous kernel's record: its times and bound from the k = 5 mode."""
    k5 = modes[ATROUS_KS.index(5)]
    fields = {f: k5[f] for f in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by")}
    rec = record(name, "atrous.cu", replaces, max_abs_err=err, **fields)
    rec["modes"] = modes
    return rec


def kernel_phase(pt, cuda_ops, dev):
    """Each kernel against its plain version at 1000x800; returns the
    per-kernel records (launch counts filled in later)."""
    import torch

    from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline import frame
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils.profiling import time_fn

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

    # -- geometry: every plane bit-equal --
    k = geo_mod.geometry_pass(*geo_args)
    p = geo_mod.geometry_pass_plain(*geo_args)
    torch.cuda.synchronize()
    check(torch.isfinite(k.depth).all().item() and torch.isfinite(k.lam).all().item(),
          "geometry planes finite")
    err = max(same_bits(f"geometry {name}", getattr(k, name).float(), getattr(p, name).float())
              for name in k._fields if getattr(k, name) is not None)
    records.append(record(
        "geometry", "geometry.cu", "ops/pallas/geometry.py:116", max_abs_err=err,
        **kernel_ms(lambda: geo_mod.geometry_pass(*geo_args), "geometry_kernel"),
        plain_ms=time_fn(lambda: geo_mod.geometry_pass_plain(*geo_args), iters=3),
        **dense_geometry_fields(geo_mod, geo_args, cfg),
    ))

    # -- path trace, frame 5, 32 bounces --
    k_noisy = pt_mod.path_trace_pass(td, cam.position, light, 5, cfg, cam.rotation)
    p_noisy = pt_mod.path_trace_pass_plain(td, cam.position, light, 5, cfg, rotation=cam.rotation)
    torch.cuda.synchronize()
    bad = share_outside(k_noisy, p_noisy, 1e-5, 1e-5)
    print(f"trace: max_abs {max_abs(k_noisy, p_noisy):.3e}, share outside 1e-5 {bad:.3e}")
    check(torch.isfinite(k_noisy).all().item(), "trace output finite")
    check(torch.equal(k_noisy, p_noisy), "trace bit-equal to its plain version")
    again = pt_mod.path_trace_pass(td, cam.position, light, 5, cfg, cam.rotation)
    check(torch.equal(again, k_noisy), "trace: a second launch gives the same bits")
    records.append(record(
        "trace", "pathtrace.cu", "ops/pallas/pathtrace.py:1716",
        max_abs_err=max_abs(k_noisy, p_noisy),
        **kernel_ms(lambda: pt_mod.path_trace_pass(td, cam.position, light, 5, cfg, cam.rotation),
                    "trace_kernel", 10),
        plain_ms=time_fn(lambda: pt_mod.path_trace_pass_plain(
            td, cam.position, light, 5, cfg, rotation=cam.rotation), iters=2, warmup=1),
        **trace_counts(pt_mod, td, cam, light, 5, cfg, f"trace parity {w}x{h}"),
        **trace_bound(pt_mod, td, cam, light, 5, cfg),
    ))
    print(f"trace lane efficiency {w}x{h}: {records[-1]['lane_eff']}")
    # the instantiation that counts triangle tests serves the bound only
    tests = torch.zeros((h, w), dtype=torch.int32, device=dev)
    counting_ms = kernel_ms(
        lambda: pt_mod.path_trace_pass(td, cam.position, light, 5, cfg, cam.rotation, tests=tests),
        "trace_kernel", 10)["ms"]
    print(f"trace {w}x{h}: {records[-1]['ms']:.4f} ms; {counting_ms:.4f} ms with the "
          "triangle-test count compiled in")

    # -- a-trous iteration, k = 1..9, seeded HDR color on the real G-buffer --
    rng = np.random.default_rng(SEED)
    color = torch.tensor(rng.exponential(0.5, (h, w, 3)).astype(np.float32), device=dev)
    records.append(atrous_record("atrous_iter", "ops/pallas/atrous.py:35", *atrous_modes(
        lambda k: at_mod.atrous_iteration(color, p.normal, p.depth, k, cfg),
        lambda k: at_mod.atrous_iteration_plain(color, p.normal, p.depth, k, cfg),
        "atrous_iter", f"{w}x{h}", cfg.wavelet_iterations, bound(40 * h * w, ATROUS_OPS * h * w))))

    # -- temporal blend, fixed and adaptive alpha: a frame's own
    # backprojection (the record's ms) and a random one --
    prev = torch.tensor(rng.exponential(0.5, (h, w, 3)).astype(np.float32), device=dev)
    lam = torch.tensor(rng.uniform(0, 1, (h, w)).astype(np.float32), device=dev)
    cur_geo, _ = frame_backprojection(pt, geo_mod, cfg, dev)
    backprojections = {
        "a frame's backprojection (orbit camera, one frame)": (cur_geo.prev_y, cur_geo.prev_x),
        "random backprojection": (
            torch.tensor(rng.integers(0, h, (h, w)).astype(np.int32), device=dev),
            torch.tensor(rng.integers(0, w, (h, w)).astype(np.int32), device=dev)),
    }
    err, modes = 0.0, []
    for label, (py, px) in backprojections.items():
        for adaptive in (False, True):
            c = pt.RenderConfig(width=WIDTH, height=HEIGHT, adaptive_alpha=adaptive)
            for f in (0, 3):
                a = at_mod.temporal_blend(color, prev, py, px, f, lam, c)
                b = at_mod.temporal_blend_plain(color, prev, py, px, f, lam, c)
                torch.cuda.synchronize()
                err = max(err, same_bits(f"temporal_blend {label} adaptive={adaptive} "
                                         f"frame={f}", a, b))
        modes.append(dict(
            mode=f"{label}, {w}x{h}, inputs from HBM",
            **kernel_ms(from_hbm(lambda *x: at_mod.temporal_blend(*x[:4], 3, x[4], cfg),
                                 (color, prev, py, px, lam)), "temporal_blend_kernel"),
            plain_ms=time_fn(lambda: at_mod.temporal_blend_plain(color, prev, py, px, 3, lam, cfg),
                             iters=5),
            **bound(48 * h * w, BLEND_OPS * h * w)))
    rec = record("temporal_blend", "atrous.cu", "ops/pallas/atrous.py:278", max_abs_err=err,
                 ms_is=modes[0]["mode"],
                 **{k: modes[0][k] for k in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by")})
    rec["modes"] = modes[1:]
    records.append(rec)
    return records


def svgf_kernel_phase(pt, cuda_ops, dev, records) -> None:
    """The SVGF and estimator kernels and modes against their plain versions
    at 1920x1080: adds the records of atrous_iter_var and
    temporal_blend_ramp, and the new modes of geometry and trace."""
    import torch

    from real_time_path_tracing_with_spatiotemporal_filtering_torch.models import presets
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import atrous
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline import frame
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils.profiling import time_fn

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
    errs = {name: same_bits(f"geometry {name} {w}x{h} emit_albedo", getattr(k, name).float(),
                            getattr(p, name).float()) for name in k._fields}
    geo_rec = by_name["geometry"]
    for label, albedo in ((f"{w}x{h} (presets)", False), (f"{w}x{h} emit_albedo", True)):
        geo_rec["modes"].append(dict(
            mode=label, max_abs_err=max(v for f, v in errs.items() if albedo or f != "albedo"),
            **kernel_ms(lambda: geo_mod.geometry_pass(*geo_args, emit_albedo=albedo),
                        "geometry_kernel"),
            plain_ms=time_fn(lambda: geo_mod.geometry_pass_plain(*geo_args, emit_albedo=albedo), iters=2),
            **dense_geometry_fields(geo_mod, geo_args, cfg, albedo=albedo)))

    # -- variance-guided a-trous, k = 1..9, seeded color/var on the real G-buffer --
    rng = np.random.default_rng(SEED + 1)
    color = torch.tensor(rng.exponential(0.5, (h, w, 3)).astype(np.float32), device=dev)
    var = torch.tensor((0.1 * rng.random((h, w))).astype(np.float32), device=dev)
    records.append(atrous_record("atrous_iter_var", "ops/pallas/atrous.py:104", *atrous_modes(
        lambda k: at_mod.atrous_iteration_var(color, var, p.normal, p.depth, k, cfg),
        lambda k: at_mod.atrous_iteration_var_plain(color, var, p.normal, p.depth, k, cfg),
        "atrous_iter_var", f"{w}x{h}", cfg.wavelet_iterations,
        bound(48 * h * w, ATROUS_VAR_OPS * h * w))))

    # -- ramp blend, both reset modes, adaptive on/off: a frame's own
    # backprojection and consistency classes (the record's ms), and a
    # random backprojection --
    prev = torch.tensor(rng.exponential(0.5, (h, w, 3)).astype(np.float32), device=dev)
    lam = torch.tensor((rng.uniform(0, 1, (h, w)) ** 3).astype(np.float32), device=dev)
    prev_age = torch.tensor(rng.integers(0, 40, (h, w)).astype(np.float32), device=dev)
    cur_geo, prev_geo = frame_backprojection(pt, geo_mod, cfg, dev)
    frame_cons = {
        "id": (prev_geo.visibility, cur_geo.visibility),
        "normal": (atrous.normal_class(prev_geo.normal, prev_geo.visibility),
                   atrous.normal_class(cur_geo.normal, cur_geo.visibility)),
    }
    random_cons = {
        "id": (torch.tensor(rng.integers(0, 33, (h, w)).astype(np.float32), device=dev),
               p.visibility),
        "normal": (atrous.normal_class(p.normal.flip(1), p.visibility.flip(1)),
                   atrous.normal_class(p.normal, p.visibility)),
    }
    inputs = {
        "a frame's backprojection (orbit camera, one frame)":
            ((cur_geo.prev_y, cur_geo.prev_x), frame_cons),
        "random backprojection": (
            (torch.tensor(rng.integers(0, h, (h, w)).astype(np.int32), device=dev),
             torch.tensor(rng.integers(0, w, (h, w)).astype(np.int32), device=dev)), random_cons),
    }
    err, modes = 0.0, []
    for label, ((py, px), cons) in inputs.items():
        for mode, (prev_cons, cur_cons) in cons.items():
            for adaptive in (False, True):
                c = dataclasses.replace(cfg, ramp_reset_mode=mode, adaptive_alpha=adaptive)
                for f in (0, 3):
                    args = (color, prev, py, px, f, lam, prev_age, prev_cons, cur_cons, c)
                    a_rgb, a_age = at_mod.temporal_blend_ramp(*args)
                    b_rgb, b_age = at_mod.temporal_blend_ramp_plain(*args)
                    torch.cuda.synchronize()
                    what = f"temporal_blend_ramp {label} mode={mode} adaptive={adaptive} frame={f}"
                    err = max(err, same_bits(f"{what} rgb", a_rgb, b_rgb),
                              same_bits(f"{what} age", a_age, b_age))
        ramp_args = (color, prev, py, px, 3, lam, prev_age, *cons["id"], cfg)
        modes.append(dict(
            mode=f"{label}, {w}x{h}",
            **kernel_ms(lambda: at_mod.temporal_blend_ramp(*ramp_args),
                        "temporal_blend_ramp_kernel"),
            plain_ms=time_fn(lambda: at_mod.temporal_blend_ramp_plain(*ramp_args), iters=5),
            **bound(64 * h * w, RAMP_BLEND_OPS * h * w)))
    rec = record("temporal_blend_ramp", "atrous.cu", "ops/pallas/atrous.py:278 (ramp=True)",
                 max_abs_err=err, ms_is=modes[0]["mode"],
                 **{k: modes[0][k] for k in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by")})
    rec["modes"] = modes[1:]
    records.append(rec)

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
        check(torch.equal(kn, pn), f"trace {label} bit-equal to its plain version")
        trace_rec["max_abs_err"] = max(trace_rec["max_abs_err"], err)
        trace_rec["modes"].append(dict(
            mode=f"{label}, {w}x{h}", max_abs_err=err,
            **kernel_ms(lambda: pt_mod.path_trace_pass(td, cam.position, light, 5, c, cam.rotation),
                        "trace_kernel", 5, warmup=1),
            plain_ms=time_fn(lambda: pt_mod.path_trace_pass_plain(
                td, cam.position, light, 5, c, rotation=cam.rotation), iters=1, warmup=0),
            **trace_counts(pt_mod, td, cam, light, 5, c, f"trace {label} {w}x{h}"),
            **trace_bound(pt_mod, td, cam, light, 5, c)))
        print(f"trace {label} lane efficiency: {trace_rec['modes'][-1]['lane_eff']}; "
              f"shadow loop cut: {trace_rec['modes'][-1]['shadow_cut']}")


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
        routes_agree(f"frame {f}", r_k.step(), r_p.step(), (HEIGHT, WIDTH, 3))
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
        routes_agree(f"{name} frame {f}", r_k.step(), r_p.step(), (h, w, 3))
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
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils.profiling import time_fn

    scene = pt.Scene.cornell_box()
    for w, h in ((WIDTH, HEIGHT), BENCH_SIZE):
        for backend, reps in (("auto", 20), ("xla", 3)):
            r = pt.Renderer(scene, pt.RenderConfig(width=w, height=h, backend=backend), device=dev)
            ms = time_fn(r.step, iters=reps, warmup=3)
            route = "kernels" if backend == "auto" else "plain"
            print(f"ms/frame {w}x{h} {route}: {ms:.3f} ({card})")
    for name in PRESETS:
        for backend, reps, warmup in (("auto", 20, 3), ("xla", 2, 1)):
            r = getattr(presets, name)(device=dev, backend=backend)
            ms = time_fn(r.step, iters=reps, warmup=warmup)
            route = "kernels" if backend == "auto" else "plain"
            print(f"ms/frame {name} {r.cfg.width}x{r.cfg.height} {route}: {ms:.3f} ({card})")


def orbit(pt, i: int, dev):
    """The JAX package's suite camera at frame i (benchmarks/suite.py)."""
    return pt.Camera.orbit([0.0, 1.0, 0.0], 6.0, 0.01 * i, 1.0, device=dev)


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


def walk_lane_fields(lanes, counts, rays: int) -> dict:
    """The lane efficiency of an LBVH geometry or shadow launch over
    ``rays`` rays, from the ``lanes`` of its counting instantiation: the
    share of the warps' lanes that had a ray and of the walk's lane steps
    that did work, and the walk's node visits a ray (box tests / 2)."""
    import torch

    rays_share, walk_share = lane_share(lanes)
    box = int(counts.tests[1].sum(dtype=torch.int64).item())
    return dict(lane_eff=dict(rays=rays_share, walk=walk_share),
                steps_per_ray=box / 2 / max(rays, 1))


def geometry_bvh_bound(geo_mod, args, td, cfg, vis_only: bool = False, row_offset: int = 0,
                       rows=None) -> dict:
    """The bound of one LBVH geometry launch on ``args``: the output planes
    (44 B a pixel), the 56 parameters, the rows the walks read, and the hit
    position (v0, e1, e2), current and previous vertices and filter normal
    of each distinct committed triangle (120 B); with the lane counts of
    the walks. ``vis_only``: the visibility-only mode on visibility_pass's
    ``args`` (20 B a pixel, 36 B a committed triangle). ``row_offset``,
    ``rows``: a launch over that row slab."""
    import torch

    rows = cfg.height if rows is None else rows
    n = cfg.width * rows
    counts = geo_mod.WalkCounts.zeros(n, td)
    lanes = torch.zeros(4, dtype=torch.int64, device=td.lut.device)
    run = geo_mod.visibility_pass if vis_only else geo_mod.geometry_pass_bvh
    out = run(*args, counts=counts, lanes=lanes, row_offset=row_offset, rows=rows)
    committed = torch.unique(out.visibility[out.visibility > 0]).numel()
    nbytes = (20 * n + 224 + 36 * committed) if vis_only else (44 * n + 224 + 120 * committed)
    fields = walk_bound(counts, nbytes)
    return dict(fields, committed_tris=committed, **walk_lane_fields(lanes, counts, n))


def path_c_shadow_rays(pt, geo_mod, td, cfg, cam, light, dev, row_offset: int = 0,
                      rows=None) -> tuple:
    """Path C's bounce-0 shadow rays at ``cfg``'s size, as the G-buffer seed
    makes them (ops/cuda/wavefront._seed_from_gbuffer, frame 5, batch 0,
    sample 0): (origins, directions, caps, mask); with ``row_offset`` and
    ``rows``, those of the sharded frame's row slab."""
    import torch

    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import (
        camera as cam_ops,
        pathtrace as plain_pt,
        rng as rng_ops,
    )

    w, h = cfg.width, cfg.height if rows is None else rows
    geo = geo_mod.geometry_pass_bvh(*stress_geo_args(pt, td, cfg, dev), emit_albedo=True,
                                    row_offset=row_offset, rows=h)
    n = w * h
    idx = torch.arange(n, device=dev)
    px, py = idx % w, torch.div(idx, w, rounding_mode="floor") + row_offset
    state, gx, gy = rng_ops.sample_jitter(px, py, 5, 0, 0)
    dirs = cam_ops.pixel_rays(px, py, w, cfg.height, cfg.fov, jitter_x=0.0 * gx,
                              jitter_y=0.0 * gy, rotation=cam.rotation)
    carry = plain_pt.primary_carry(
        cam.position.expand(n, 3), dirs, state, geo.visibility.reshape(n),
        geo.world_pos.reshape(n, 3), geo.normal.reshape(n, 3), geo.albedo.reshape(n, 3),
        light.position, light.color * cfg.light_intensity, cfg, defer_nee_shadow=True)
    w_l, s_t, _, mask = carry[6]
    return carry[0], w_l, torch.where(mask, s_t, torch.zeros_like(s_t)), mask


def shadow_segment_fields(wf, geo_mod, td, cfg, rays) -> dict:
    """ms of shadow_segment on ``rays`` (path_c_shadow_rays, a frame's
    pixels) and its bound: per lane the bool mask read and the int32 flag
    written (5 B), per lane of the mask its origin, direction and cap read
    (28 B), and the rows the walks read; with the lane counts of the
    walks."""
    import torch

    o, w_l, cap, mask = rays
    n = mask.shape[0]
    masked = int(mask.sum().item())
    counts = geo_mod.WalkCounts.zeros(n, td)
    lanes = torch.zeros(4, dtype=torch.int64, device=td.lut.device)
    wf.shadow_segment(o, w_l, cap, mask, td, cfg, counts=counts, lanes=lanes, width=cfg.width)
    return dict(**kernel_ms(lambda: wf.shadow_segment(o, w_l, cap, mask, td, cfg,
                                                      width=cfg.width),
                            "shadow_segment_kernel"),
                **walk_bound(counts, 5 * n + 28 * masked),
                **walk_lane_fields(lanes, counts, masked))


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


def segments_agree(wf, td, cfg, cam, light, frame_idx, label: str, only=None,
                   row_offset: int = 0, rows=None):
    """The segments of every sample of a frame (those in ``only``, or all),
    kernel against plain on the same input ray state, bit for bit, each
    launch after a sample's first on the live list the launch before wrote;
    returns (max abs error, plain ms per segment). ``row_offset``/``rows``:
    the frame's row slab of the sharded frame (default: the whole frame)."""
    import torch

    n = cfg.width * (cfg.height if rows is None else rows)
    rays = wf.RayState.empty(n, td.lut.device)
    lists = wf.LiveLists(n, td.lut.device)
    err, plain_s, launches = 0.0, 0.0, 0
    for batch in range(cfg.sample_batches):
        for sample in range(cfg.spp):
            for seg in range(cfg.max_bounces):
                if only is not None and seg not in only:
                    wf.trace_segment(rays, seg, batch, sample, td, cam.position, cam.rotation,
                                     light, frame_idx, cfg, first=seg == 0, lists=lists,
                                     row_offset=row_offset)
                    continue
                plain = wf.RayState(*(t.clone() for t in rays))
                wf.trace_segment(rays, seg, batch, sample, td, cam.position, cam.rotation,
                                 light, frame_idx, cfg, first=seg == 0, lists=lists,
                                 row_offset=row_offset)
                torch.cuda.synchronize()
                listed = torch.sort(lists.last_list()).values
                if not torch.equal(listed, torch.nonzero(rays.alive).squeeze(1).to(torch.int32)):
                    check(False, f"trace_segment {label} b{batch} s{sample} seg {seg}: the live "
                                 "list holds exactly the rays that go on")
                t0 = time.perf_counter()
                wf.trace_segment_plain(plain, seg, batch, sample, td, cam.position,
                                       cam.rotation, light, frame_idx, cfg, None, row_offset)
                torch.cuda.synchronize()
                plain_s += time.perf_counter() - t0
                launches += 1
                err = max(err, max_abs(rays.f, plain.f))
                if not all(torch.equal(a, b) for a, b in zip(rays, plain)):
                    check(False, f"trace_segment {label} b{batch} s{sample} seg {seg}: ray "
                                 "state bit-equal to the plain version")
    print(f"trace_segment {label}: {launches} segments against the plain version, "
          f"max_abs {err:.3e}", flush=True)
    check(True, f"trace_segment {label}: each checked segment's ray state bit-equal and its "
                "live list the rays that go on")
    return err, 1e3 * plain_s / launches


def frame_segments(wf, td, cfg, cam, light, frame_idx, counts=None, live=None, lanes=None,
                   after=None, row_offset: int = 0, rows=None):
    """One 1-sample frame's segments on the card, launched as the host loop
    launches them (one SegmentLaunches), each launch after the first on the
    live list the launch before wrote. With ``live`` (a list), appends the
    number of live rays before each launch (a host read); ``after`` is
    called after each launch. ``row_offset``, ``rows``: that row slab's."""
    import torch

    n = cfg.width * (cfg.height if rows is None else rows)
    rays = wf.RayState.empty(n, td.lut.device)
    launch = wf.SegmentLaunches(rays, td, cam.position, cam.rotation, light, frame_idx, cfg,
                                counts, lanes=lanes, row_offset=row_offset)
    for seg in range(cfg.max_bounces):
        if live is not None:
            live.append(n if seg == 0 else int(rays.alive.sum(dtype=torch.int64).item()))
        launch(seg, 0, 0, seg == 0)
        if after is not None:
            after()


class SlotWarps:
    """A model of the walks' lane efficiency in the earlier segment kernel
    (one thread per ray slot, a warp = 32 consecutive slots), called after
    each launch: each ray's walk steps are its box tests / 2 in ``counts``
    (zeroed here after each launch), and a warp takes as many walk steps as
    its longest lane. An upper bound: it counts no other divergence."""

    def __init__(self, counts):
        self.counts, self.lanes, self.steps = counts, 0, 0

    def __call__(self) -> None:
        import torch

        steps = self.counts.tests[1].to(torch.int64) // 2
        warps = torch.nn.functional.pad(steps, (0, -steps.numel() % 32)).view(-1, 32)
        self.lanes += int(steps.sum().item())
        self.steps += int(warps.amax(dim=1).sum().item())
        self.counts.tests.zero_()

    def share(self) -> float:
        return self.lanes / max(32 * self.steps, 1)


def segment_lane_eff(td, run, label: str) -> dict:
    """The segment kernel's lane efficiency over ``run(counts, lanes,
    after)``'s launches (``after`` called after each): the loop over rays
    and the walks. The earlier one-thread-per-slot kernel's walks, modelled
    from the same launches, go to MODELLED under ``label``."""
    import torch

    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda.geometry import (
        WalkCounts,
    )

    lanes = torch.zeros(4, dtype=torch.int64, device=td.lut.device)
    model = SlotWarps(WalkCounts.zeros(run.n, td))
    run(model.counts, lanes, model)
    loop, walk = lane_share(lanes)
    MODELLED[label] = dict(walks_one_thread_per_slot=model.share())
    return dict(ray_loop=loop, walks=walk)


def segment_bound(wf, td, cfg, cam, light, frame_idx, row_offset: int = 0, rows=None) -> dict:
    """The bound of a launch of one frame's segments (of the row slab
    ``row_offset``, ``rows`` when given), over the frame's launches: the
    kernel's counts, the ray-state bytes (a live ray reads 52 and writes 56
    bytes, a dead one reads its alive flag, segment 0 writes 56 per ray),
    the 18 parameters of each launch, and once per frame the rows the
    walks read, with the hit position, normal and albedo (60 B) of each
    triangle tested (a superset of those hit); with the live rays before
    each launch."""
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda.geometry import (
        WalkCounts,
    )

    n = cfg.width * (cfg.height if rows is None else rows)
    counts = WalkCounts.zeros(n, td)
    live = []
    frame_segments(wf, td, cfg, cam, light, frame_idx, counts, live, row_offset=row_offset,
                   rows=rows)
    segs = cfg.max_bounces
    state_bytes = 56 * n + sum(108 * k + 4 * n for k in live[1:])
    fields = walk_bound(counts, state_bytes + 72 * segs, per_tri=60)
    fields["bound_ms"] /= segs
    return dict(fields, live_rays=live)


def segment_record_fields(wf, td, cfg, cam, light, frame_idx) -> dict:
    """ms per launch of one frame's segments, and the bound of a launch
    (:func:`segment_bound`), with the live rays and lane efficiency."""
    n = cfg.width * cfg.height
    fields = segment_bound(wf, td, cfg, cam, light, frame_idx)
    live = fields.pop("live_rays")
    timing = kernel_ms(lambda: frame_segments(wf, td, cfg, cam, light, frame_idx),
                       "trace_segment_kernel", 3, warmup=1, mean=True)
    ms = timing["ms"]

    def run(counts, lanes, after):
        frame_segments(wf, td, cfg, cam, light, frame_idx, counts, lanes=lanes, after=after)

    run.n = n
    lane_eff = segment_lane_eff(
        td, run, f"trace_segment {cfg.width}x{cfg.height} {td.num_triangles} tris")
    print(f"trace_segment {cfg.width}x{cfg.height} {td.num_triangles} tris: {ms:.4f} ms per "
          f"launch; live rays {live}; lane efficiency {lane_eff}", flush=True)
    return dict(timing, live_rays=live, lane_eff=lane_eff, **fields)


# The dense geometry kernel's cases: camera poses (current, previous), frame
# sizes (the reference's, bench.py's, one that splits unevenly into 16x16
# blocks of 8x4 warp tiles, one smaller than a block) and scenes (the
# Cornell box and its subdivisions up to the kernel's table).
DENSE_SIZES = ((1000, 800), (1920, 1080), (1003, 797), (37, 13))
DENSE_SPLITS = {32: None, 128: 2, 288: 3}


def dense_poses(pt, dev) -> dict:
    """(current, previous) cameras: the default camera (the previous 0.5
    back), the suite's orbit camera at frames 3 and 2, and a camera 0.07
    from the right wall (x = 1), which it sees at a grazing angle."""
    import torch

    cam = pt.Camera.default(dev)
    near = ((0.93, 1.2, 0.6), (0.985, 0.9, -1.0))
    return {
        "default": (cam, pt.Camera(cam.position + torch.tensor([0.0, 0.0, 0.5], device=dev),
                                   cam.rotation)),
        "orbit": (orbit(pt, 3, dev), orbit(pt, 2, dev)),
        "near_wall": (pt.Camera.looking_at(*near, device=dev),
                      pt.Camera.looking_at((0.92, 1.2, 0.62), near[1], device=dev)),
    }


def dense_geometry_args(pt, td, cfg, cams, dev):
    """geometry_pass's inputs for (current, previous) cameras, the light
    moved between them."""
    import torch

    from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline import frame

    cam, prev = cams
    light = pt.Light.default(dev)
    view, proj = frame.camera_matrices(cam, cfg)
    view_p, proj_p = frame.camera_matrices(prev, cfg)
    return (td, td.lut, cam.position, cam.rotation, light.position,
            light.position + torch.tensor([0.5, 0.0, 0.0], device=dev),
            light.color, light.color * 0.5, view, proj, view_p, proj_p, cfg)


def frame_backprojection(pt, geo_mod, cfg, dev) -> tuple:
    """The dense geometry kernel's planes of two frames of the Cornell box
    under the suite's orbit camera stepping one frame (orbit 0 -> 1, and
    orbit -1 -> 0 before it): (current, previous). The current planes'
    prev_y / prev_x are the backprojection a frame's blend reads."""
    td = pt.precompute_triangle_data(pt.Scene.cornell_box(), dev)
    return tuple(geo_mod.geometry_pass(*dense_geometry_args(
        pt, td, cfg, (orbit(pt, i, dev), orbit(pt, i - 1, dev)), dev)) for i in (1, 0))


def dense_geometry_phase(pt, dev) -> None:
    """The dense geometry kernel against its plain version, bit for bit on
    every plane, at every pose of dense_poses, size of DENSE_SIZES and scene
    of DENSE_SPLITS: the full mode with and without the albedo planes, its
    counting launch (the planes, and its tests and survivors against the
    cull's plain twin), and the visibility-only mode."""
    import torch

    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import (
        geometry as geo_mod,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline import frame
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import procedural

    t_phase = time.time()
    scenes = {t: pt.precompute_triangle_data(
        pt.Scene.cornell_box() if s is None else
        pt.Scene.from_arrays(*procedural.subdivided_cornell(s)), dev)
        for t, s in DENSE_SPLITS.items()}
    cases, tests = 0, []
    for pose, cams in dense_poses(pt, dev).items():
        for w, h in DENSE_SIZES:
            cfg = pt.RenderConfig(width=w, height=h)
            for t, td in scenes.items():
                label = f"{pose} camera, {w}x{h}, {t} tris"
                args = dense_geometry_args(pt, td, cfg, cams, dev)
                counts = geo_mod.dense_counts(cfg, dev)
                runs = {"albedo": geo_mod.geometry_pass(*args, emit_albedo=True),
                        "no albedo": geo_mod.geometry_pass(*args),
                        "counted": geo_mod.geometry_pass(*args, emit_albedo=True, counts=counts)}
                view, proj = frame.camera_matrices(cams[0], cfg)
                vis = geo_mod.visibility_pass_dense(td, cams[0].position, view, proj, cfg,
                                                    rotation=cams[0].rotation)
                plain = geo_mod.geometry_pass_plain(*args, emit_albedo=True)
                want = geo_mod.dense_counts_plain(td, cams[0].position, cams[0].rotation, cfg)
                torch.cuda.synchronize()
                same = all(torch.equal(getattr(k, f), getattr(plain, f))
                           for name, k in runs.items() for f in plain._fields
                           if name != "no albedo" or f != "albedo")
                same &= runs["no albedo"].albedo is None
                same &= all(torch.equal(getattr(vis, f), getattr(plain, n))
                            for f, n in (("visibility", "visibility"), ("world_pos", "world_pos"),
                                         ("depth", "depth")))
                if not (same and torch.equal(counts, want)):
                    check(False, f"dense geometry {label}: every plane of both modes bit-equal "
                                 "to the plain version, counts equal the cull's twin")
                cases += 1
                tests.append((label, counts[0].double().mean().item()))
    print("dense geometry tests a pixel: " + "; ".join(f"{k} {v:.3f}" for k, v in tests))
    check(True, f"dense geometry kernel: {cases} cases (poses x sizes x scenes), every plane of "
                "the full mode with and without albedo, of the counting launch and of the "
                "visibility-only mode bit-equal to the plain version; tests and survivors equal "
                "the cull's plain twin")
    print(f"dense geometry phase: {time.time() - t_phase:.1f} s", flush=True)


def large_kernel_phase(pt, dev, records) -> None:
    """The large-scene kernels against their plain versions and against the
    dense kernels; adds the records of geometry_bvh, trace_segment and
    shadow_segment."""
    import torch

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
        """geometry_bvh against its plain version on every plane, bit for
        bit; returns (max abs error, plain ms)."""
        k = geo_mod.geometry_pass_bvh(*args, emit_albedo=True)
        t0 = time.perf_counter()
        p = geo_mod.geometry_pass_plain(*args, emit_albedo=True)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        check(bool(torch.isfinite(k.depth).all().item()), f"geometry_bvh {label} depth finite")
        err = max(same_bits(f"geometry_bvh {name} {label}", getattr(k, name).float(),
                            getattr(p, name).float()) for name in k._fields)
        return err, plain_ms

    # -- LBVH geometry kernel: plain version at path A's and path B's
    # shapes, and the dense kernel from 32 to 288 triangles --
    td = scenes[32]
    args = stress_geo_args(pt, td, path_a, dev)
    err, plain_ms = geometry_agrees(args, f"32768 tris {w}x{h}")
    rec = record("geometry_bvh", "geometry.cu", "ops/pallas/geometry.py:388", max_abs_err=err,
                 **kernel_ms(lambda: geo_mod.geometry_pass_bvh(*args), "geometry_bvh_kernel"),
                 plain_ms=plain_ms,
                 **geometry_bvh_bound(geo_mod, args, td, path_a))
    records.append(rec)
    td88 = scenes[88]
    args88 = stress_geo_args(pt, td88, base, dev)
    err, plain_ms = geometry_agrees(args88, f"247808 tris {w}x{h}")
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    rec["modes"].append(dict(
        mode=f"247808 triangles (path B), {w}x{h}", max_abs_err=err, plain_ms=plain_ms,
        **kernel_ms(lambda: geo_mod.geometry_pass_bvh(*args88), "geometry_bvh_kernel"),
        **geometry_bvh_bound(geo_mod, args88, td88, base)))
    for t, tds in small_scenes.items():
        args_s = stress_geo_args(pt, tds, base, dev)
        dense = geo_mod.geometry_pass(*args_s, emit_albedo=True)
        bvh = geo_mod.geometry_pass_bvh(*args_s, emit_albedo=True)
        torch.cuda.synchronize()
        same = all(torch.equal(getattr(dense, f), getattr(bvh, f)) for f in dense._fields)
        mode = dict(mode=f"{t} triangles, {w}x{h}, against the dense kernel", max_abs_err=0.0,
                    **kernel_ms(lambda: geo_mod.geometry_pass_bvh(*args_s), "geometry_bvh_kernel"),
                    dense_kernel_ms=kernel_ms(lambda: geo_mod.geometry_pass(*args_s),
                                              "geometry_kernel")["ms"])
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
            launches = c.max_bounces * c.spp * c.sample_batches
            segments = kernel_ms(lambda: wf.path_trace_wavefront(tds, cam.position, light, 5, c,
                                                                cam.rotation),
                                 "trace_segment_kernel", 3, warmup=1, mean=True)
            mode = dict(
                mode=f"{t} triangles, {label}, {w}x{h}, against the dense trace kernel",
                max_abs_err=0.0, launches=launches, segments_ms=segments["ms"] * launches,
                frame_ms=segments["call_ms"] * launches,
                dense_kernel_ms=kernel_ms(lambda: pt_mod.path_trace_pass(
                    tds, cam.position, light, 5, c, cam.rotation), "trace_kernel", 3,
                    warmup=1)["ms"])
            print(f"segment tracer vs trace kernel, {t} tris {label} {w}x{h}: bit-equal "
                  f"{torch.equal(a, b)}, max_abs {max_abs(a, b):.3e}; segments "
                  f"{mode['segments_ms']:.3f} device ms ({mode['frame_ms']:.3f} ms a call), "
                  f"{mode['dense_kernel_ms']:.3f} ms dense")
            check(torch.equal(a, b), f"segment tracer equals the trace kernel on {t} triangles "
                                     f"({label})")
            rec["modes"].append(mode)

    # -- shadow segment: path C's bounce-0 shadow rays at 1920x1080 --
    path_c = dataclasses.replace(base, **LARGE["C"][1])
    rays = path_c_shadow_rays(pt, geo_mod, td, path_c, cam, light, dev)
    k = wf.shadow_segment(*rays, td, path_c, width=path_c.width)
    t0 = time.perf_counter()
    p = wf.shadow_segment_plain(*rays, td, path_c)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    print(f"shadow_segment path C {w}x{h}: {int(rays[3].sum().item())} sampling lanes, "
          f"{int(p.sum().item())} occluded")
    same_bits(f"shadow_segment path C {w}x{h}", k, p)
    records.append(record(
        "shadow_segment", "wavefront.cu", "ops/pallas/wavefront.py:487",
        max_abs_err=float((k != p).any().item()), plain_ms=plain_ms,
        **shadow_segment_fields(wf, geo_mod, td, path_c, rays)))
    print(f"large-scene kernel phase: {time.time() - t_phase:.1f} s", flush=True)


def pixel_segments(wf, td, cfg, cam, light, frame_idx, pixels, rays, start: int, counts=None,
                   live=None, lanes=None, after=None) -> None:
    """The explicit-pixel segments ``start``..max_bounces - 1 of a 1-sample
    trace of ``rays`` at ``pixels`` on the card, launched as the host loop
    launches them (one SegmentLaunches), each launch after the first on the
    live list the launch before wrote. With ``live`` (a list), appends the
    number of live rays before each launch (a host read); ``after`` is
    called after each launch."""
    import torch

    n = rays.alive.shape[0]
    launch = wf.SegmentLaunches(rays, td, cam.position, cam.rotation, light, frame_idx, cfg,
                                counts, pixels, lanes)
    for seg in range(start, cfg.max_bounces):
        if live is not None:
            live.append(n if seg == 0 else int(rays.alive.sum(dtype=torch.int64).item()))
        launch(seg, 0, 0, seg == start)
        if after is not None:
            after()


def explicit_pixel_mode(wf, td, cfg, cam, light, frame_idx, pixels, primary, label: str,
                        path: str) -> dict:
    """The segment tracer's explicit-pixel mode on the rays at ``pixels``
    (int32 px, py), seeded from the G-buffer planes ``primary`` at those
    pixels (segments from 1) or not (segments from 0): each segment against
    the plain version on the same input ray state, bit for bit; then ms per
    launch (CUDA events around the segments only) and the bound per launch
    from the kernel's counts: the pixel lists (8 B a ray) and 56 B of ray
    state written at segment 0, then per launch 4 B a ray and 108 B a live
    ray, 72 B of parameters, and once per trace the rows the walks read with
    60 B of each triangle tested. Returns the mode's record; ``path`` names
    the main path whose launches of the kernel are all of this mode."""
    import torch

    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda.geometry import (
        WalkCounts,
    )

    n = pixels[0].numel()
    dev = pixels[0].device
    start = 0 if primary is None else 1
    seeded = wf.RayState.empty(n, dev)
    if primary is not None:
        wf._seed_from_gbuffer(seeded, primary, 0, 0, td, cam.position, cam.rotation, light,
                              frame_idx, cfg, None, pixels)

    def fresh():
        return wf.RayState(*(t.clone() for t in seeded))

    rays, err, plain_s = fresh(), 0.0, 0.0
    lists = wf.LiveLists(n, dev)
    for seg in range(start, cfg.max_bounces):
        plain = wf.RayState(*(t.clone() for t in rays))
        wf.trace_segment(rays, seg, 0, 0, td, cam.position, cam.rotation, light, frame_idx, cfg,
                         pixels=pixels, first=seg == start, lists=lists)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wf.trace_segment_plain(plain, seg, 0, 0, td, cam.position, cam.rotation, light,
                               frame_idx, cfg, pixels)
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t0
        err = max(err, max_abs(rays.f, plain.f))
        same = all(torch.equal(a, b) for a, b in zip(rays, plain)) and torch.equal(
            torch.sort(lists.last_list()).values,
            torch.nonzero(rays.alive).squeeze(1).to(torch.int32))
        if not same:
            check(False, f"trace_segment explicit pixels {label} segment {seg}: ray state "
                         "bit-equal to the plain version")
    launches = cfg.max_bounces - start
    print(f"trace_segment explicit pixels {label}: {n} rays, {launches} segments bit-equal to "
          f"the plain version, max_abs {err:.3e}", flush=True)
    check(True, f"trace_segment explicit pixels {label}: every segment bit-equal")

    counts, live = WalkCounts.zeros(n, td), []
    pixel_segments(wf, td, cfg, cam, light, frame_idx, pixels, fresh(), start, counts, live)
    later = live[1:] if start == 0 else live
    state_bytes = (64 * n if start == 0 else 0) + sum(108 * k + 4 * n for k in later)
    fields = walk_bound(counts, state_bytes + 72 * launches, per_tri=60)
    fields["bound_ms"] /= launches
    # each run from a fresh copy of the input rays (call_ms includes the copy)
    timing = kernel_ms(lambda: pixel_segments(wf, td, cfg, cam, light, frame_idx, pixels,
                                              fresh(), start),
                       "trace_segment_kernel", 3, warmup=1, mean=True)
    ms = timing["ms"]

    def run(counts, lanes, after):
        pixel_segments(wf, td, cfg, cam, light, frame_idx, pixels, fresh(), start, counts,
                       lanes=lanes, after=after)

    run.n = n
    lane_eff = segment_lane_eff(td, run, f"trace_segment explicit pixels {label}")
    print(f"trace_segment explicit pixels {label}: {ms:.4f} ms per launch; lane efficiency "
          f"{lane_eff}", flush=True)
    return dict(mode=f"{label}, per launch", max_abs_err=err, **timing,
                plain_ms=1e3 * plain_s / launches, rays=n, live_rays=live, lane_eff=lane_eff,
                on_path=path, **fields)


def visibility_mode(pt, geo_mod, td, cfg, cam, dev, label: str) -> dict:
    """The geometry kernels' visibility-only mode (ops/cuda/geometry.
    visibility_pass) against ops/gbuffer.visibility_pass and against the
    full mode's planes, bit for bit, with its launch count; ms and the
    bound: 5 planes written (20 B a pixel), the 56 parameters, and on the
    dense kernel its 168-byte rows and a test per triangle and pixel, on the
    LBVH the rows the walks read and the hit position (36 B) of each
    distinct committed triangle. Returns the mode's record."""
    import torch

    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import gbuffer, intersect
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import LAUNCHES
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline import frame

    view, proj = frame.camera_matrices(cam, cfg)
    light = pt.Light.default(dev)
    bvh = intersect.uses_bvh(td)
    full_pass = geo_mod.geometry_pass_bvh if bvh else geo_mod.geometry_pass
    args = (td, cam.position, view, proj, cfg, cam.rotation)
    LAUNCHES.clear()
    k = geo_mod.visibility_pass(*args)
    launches = dict(LAUNCHES)
    t0 = time.perf_counter()
    p = gbuffer.visibility_pass(*args[:5], rotation=cam.rotation)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    full = full_pass(td, td.lut, cam.position, cam.rotation, light.position, light.position,
                     light.color, light.color, view, proj, view, proj, cfg)
    planes = (("visibility", full.visibility), ("world_pos", full.world_pos),
              ("depth", full.depth))
    err = max(max_abs(getattr(k, name), getattr(p, name)) for name, _ in planes)
    same_plain = all(torch.equal(getattr(k, name), getattr(p, name)) for name, _ in planes)
    same_full = all(torch.equal(getattr(k, name), t) for name, t in planes)
    name = "geometry_bvh[visibility]" if bvh else "geometry[visibility]"
    print(f"visibility-only mode {label} {cfg.width}x{cfg.height}: bit-equal to "
          f"ops/gbuffer.visibility_pass {same_plain}, to the full mode's planes {same_full}, "
          f"max_abs {err:.3e}; launches {launches}", flush=True)
    check(same_plain and same_full and launches == {name: 1},
          f"visibility-only mode {label}: planes bit-equal to the plain version and the full "
          f"mode, one {name} launch")
    if bvh:
        fields = geometry_bvh_bound(geo_mod, args, td, cfg, vis_only=True)
    else:
        fields = dense_geometry_fields(geo_mod, args, cfg, vis_only=True)
    return dict(mode=f"visibility-only ({label}), {cfg.width}x{cfg.height}", max_abs_err=err,
                launches_by_path={"visibility_pass": launches.get(name, 0)},
                **kernel_ms(lambda: geo_mod.visibility_pass(*args),
                            "geometry_bvh_kernel" if bvh else "geometry_kernel"),
                plain_ms=plain_ms,
                **fields)


def gradient_kernel_phase(pt, dev, records) -> None:
    """The kernel modes of the path-gradient / multi-res slice at 1920x1080:
    the explicit-pixel segments at the path gradient's stratum pixels under
    path A's levers and on path D's phased coarse tail with the G-buffer
    seed (32,768 triangles), and the visibility-only mode on the Cornell box
    and on 32,768 triangles. Adds each as a mode of its kernel's record."""
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import (
        multires,
        pathgrad,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import (
        geometry as geo_mod,
        wavefront as wf,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import procedural

    import torch

    t_phase = time.time()
    by_name = {r["name"]: r for r in records}
    w, h = BENCH_SIZE
    td = pt.precompute_triangle_data(pt.Scene.from_arrays(*procedural.subdivided_cornell(32)),
                                     dev)
    cam, light = orbit(pt, 3, dev), pt.Light.default(dev)
    seg_rec = by_name["trace_segment"]

    # the re-trace of frame 5 at frame 6's stratum pixels, path A's levers
    path_a = pt.RenderConfig(width=w, height=h, **LARGE["A"][1])
    gy, gx = pathgrad.stratum_pixels(h, w, 6, path_a.gradient_stratum, dev)
    pixels = tuple(t.reshape(-1).to(torch.int32).contiguous() for t in (gx, gy))
    mode = explicit_pixel_mode(wf, td, path_a, cam, light, 5, pixels, None,
                               f"path gradient stratum pixels {gx.shape[1]}x{gx.shape[0]} of "
                               f"{w}x{h}, 32768 tris, path A levers", "E")
    seg_rec["modes"].append(mode)

    # path D's coarse tail at a phase other than (0, 0), seeded from its G-buffer
    path_d = pt.RenderConfig(width=w, height=h, **RECOMMENDED)
    frame_idx = 5
    phase = multires.grid_phase(frame_idx, path_d.indirect_stride)
    check(phase != (0, 0), f"path D's grid phase at frame {frame_idx} is {phase}, not (0, 0)")
    geo = geo_mod.geometry_pass_bvh(*stress_geo_args(pt, td, path_d, dev), emit_albedo=True)
    primary = (geo.visibility, geo.world_pos, geo.normal, geo.albedo)
    _, tail_cfg = multires.split_cfgs(path_d)
    s = path_d.indirect_stride
    prim_c = tuple(multires._subsample(p, s, phase) for p in primary)
    py_c, px_c = multires.coarse_pixels(path_d, phase, dev)
    pixels = tuple(t.reshape(-1).to(torch.int32).contiguous() for t in (px_c, py_c))
    mode = explicit_pixel_mode(wf, td, tail_cfg, cam, light, frame_idx, pixels, prim_c,
                               f"path D coarse tail {w // s}x{h // s} at phase {phase}, "
                               "G-buffer seed, 32768 tris", "D")
    seg_rec["modes"].append(mode)
    seg_rec["max_abs_err"] = max(seg_rec["max_abs_err"], *(m["max_abs_err"]
                                                          for m in seg_rec["modes"][-2:]))

    cfg = pt.RenderConfig(width=w, height=h)
    cornell = pt.precompute_triangle_data(pt.Scene.cornell_box(), dev)
    by_name["geometry"]["modes"].append(
        visibility_mode(pt, geo_mod, cornell, cfg, pt.Camera.default(dev), dev,
                        "Cornell box, dense kernel"))
    by_name["geometry_bvh"]["modes"].append(
        visibility_mode(pt, geo_mod, td, cfg, cam, dev, "32768 tris, LBVH kernel"))
    print(f"path-gradient / multi-res kernel phase: {time.time() - t_phase:.1f} s", flush=True)


def move_bounds(t: int, rows: int) -> tuple:
    """The bounds of the move's two launches over ``t`` triangles and
    ``rows`` node rows. transform_tables reads a LUT row (36 B) and writes
    204 B a triangle (the LUT row 36, v0, e1, e2 and n 48, n1 and n2 24, d0,
    d1 and d2 12, the normal, the albedo and the filter normal 36, the test
    row 48), and reads the
    model (48 B), writes the background rows (48 B), the pad scale and the
    zeroed counters (4 B a row); bvh_refit reads a moved LUT row and a leaf
    slot a triangle (40 B), a rest row's ids, a row slot and a counter (24
    B) and writes a row (64 B) a row, and reads the pad scale."""
    return (bound(240 * t + 100 + 4 * rows, TRANSFORM_OPS * t),
            bound(40 * t + 88 * rows + 4, REFIT_LEAF_OPS * t + REFIT_ROW_OPS * rows))


def model_kernel_phase(pt, dev, records) -> None:
    """The move's two kernels (ops/cuda/model.py) against their plain
    versions, bit for bit, at MODEL_SCENES' sizes at path MA's last pose;
    the refitted node table against the host's pack of the rest tree over
    the moved triangles (scene/lbvh.refit_lbvh); the whole move under
    ``torch.cuda.set_sync_debug_mode("error")`` (it reads nothing back to
    the host); each kernel timed from the profiler at every size. Adds the
    records of transform_tables and bvh_refit, at path MA's 32,768
    triangles."""
    import torch

    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import model as mv
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import lbvh, procedural
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils.profiling import time_fn

    t_phase = time.time()
    frames = MODEL_PATHS["MA"][2]
    m = torch.tensor(model_rotation(MODEL_STEP * frames), device=dev)
    names = ("transform_tables", "bvh_refit")
    errs, modes = dict.fromkeys(names, 0.0), {name: [] for name in names}
    for t, splits in MODEL_SCENES.items():
        verts, idx = (procedural.cornell_box() if splits is None
                      else procedural.subdivided_cornell(splits))
        td = pt.precompute_triangle_data(pt.Scene.from_arrays(verts, idx), dev)
        tables, workspace = mv.transform_tables(td, m)
        want, coord_max = mv.transform_tables_plain(td, m)
        torch.cuda.synchronize()
        errs["transform_tables"] = max(
            [errs["transform_tables"]]
            + [same_bits(f"transform_tables {k} {t} tris", tables[k], want[k]) for k in mv.TABLES]
            + [same_bits(f"transform_tables pad scale {t} tris",
                         workspace[:1].view(torch.float32)[0], coord_max)])
        nodes = mv.bvh_refit(td.bvh, tables["lut"], workspace)
        nodes_plain = mv.bvh_refit_plain(td.bvh, want["lut"][1:])
        torch.cuda.synchronize()
        errs["bvh_refit"] = max(errs["bvh_refit"], same_bits(
            f"bvh_refit {t} tris (bits)", nodes.view(torch.int32), nodes_plain.view(torch.int32)))
        moved = want["lut"][1:].cpu().numpy()
        host = lbvh.pack_bvh_nodes(lbvh.refit_lbvh(lbvh.build_lbvh(verts[idx]), moved), moved)
        check(np.array_equal(nodes.cpu().numpy().view(np.int32), host.view(np.int32)),
              f"bvh_refit {t} tris equals the host's pack of the rest tree over the moved "
              "triangles")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            moved_td = mv.transform_triangle_data(td, m)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(torch.equal(moved_td.bvh.nodes.view(torch.int32), nodes.view(torch.int32)),
              f"the move of {t} tris runs under sync debug mode 'error' and gives the same tree")

        def move():
            return mv.transform_triangle_data(td, m).lut

        bounds = move_bounds(t, td.bvh.nodes.shape[0])
        plain = (lambda: mv.transform_tables_plain(td, m)[1],
                 lambda: mv.bvh_refit_plain(td.bvh, want["lut"][1:]))
        for name, bnd, plain_fn in zip(names, bounds, plain):
            modes[name].append(dict(mode=f"{t} triangles", **kernel_ms(move, f"{name}_kernel"),
                                    plain_ms=time_fn(plain_fn, iters=3), **bnd))
            print(f"{name}_kernel {t} tris: {modes[name][-1]['ms']:.4f} ms, bound "
                  f"{bnd['bound_ms']:.4f} ({bnd['bound_by']})", flush=True)
    note = ("no TPU kernel: the JAX package applies the model matrix as an XLA map "
            "(transform_triangle_data) and routes moved scenes dense; call_ms is the whole move")
    for name in names:
        main = next(md for md in modes[name] if md["mode"] == "32768 triangles")
        fields = {f: main[f] for f in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by")}
        rec = record(name, "model.cu", "scene/scene.py:170", max_abs_err=errs[name], note=note,
                     **fields)
        rec["modes"] = modes[name]
        records.append(rec)
    print(f"model kernel phase: {time.time() - t_phase:.1f} s", flush=True)


def refit_cost_phase(pt, dev) -> None:
    """What the refitted tree costs the walks at path MA's last pose (a
    finding, not a gate): box tests a ray of the LBVH geometry kernel and
    box tests a pixel over one frame's segments, and their device ms, on
    the refitted tree, on a tree built afresh on the host over the moved
    triangles, and on the unmoved scene."""
    import torch

    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import (
        geometry as geo_mod,
        model as mv,
        wavefront as wf,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline import frame

    r = path_renderer(pt, dev, "MA")
    cfg, rest = r.cfg, r.tri_data
    m = torch.tensor(model_rotation(MODEL_STEP * MODEL_PATHS["MA"][2]), device=dev)
    refit = mv.transform_triangle_data(rest, m)
    t = rest.num_triangles
    fresh = pt.precompute_triangle_data(pt.Scene.from_arrays(
        refit.lut[1:].reshape(-1, 3).cpu().numpy(), np.arange(3 * t).reshape(t, 3)), dev)
    cam, light = orbit(pt, 0, dev), pt.Light.default(dev)
    view, proj = frame.camera_matrices(cam, cfg)
    n = cfg.width * cfg.height
    for label, td in (("refitted", refit), ("fresh", fresh), ("unmoved", rest)):
        args = (td, td.lut, cam.position, cam.rotation, light.position, light.position,
                light.color, light.color, view, proj, view, proj, cfg)
        geo = geometry_bvh_bound(geo_mod, args, td, cfg)
        counts = geo_mod.WalkCounts.zeros(n, td)
        frame_segments(wf, td, cfg, cam, light, 5, counts)
        seg_box = int(counts.tests[1].sum(dtype=torch.int64).item())
        geo_ms = kernel_ms(lambda: geo_mod.geometry_pass_bvh(*args), "geometry_bvh_kernel")["ms"]
        seg_ms = kernel_ms(lambda: frame_segments(wf, td, cfg, cam, light, 5),
                           "trace_segment_kernel", 3, warmup=1, mean=True)["ms"]
        print(json.dumps(dict(refit_cost=label, tris=t, size=f"{cfg.width}x{cfg.height}",
                              geometry_box_tests_per_ray=geo["box_tests"] / n,
                              geometry_bvh_ms=geo_ms,
                              segment_box_tests_per_pixel=seg_box / n,
                              trace_segment_ms_per_frame=seg_ms * cfg.max_bounces)), flush=True)


def path_renderer(pt, dev, path: str, backend: str = "auto", size=None):
    """The Renderer of a large-scene or gradient path (LARGE, GRADIENT_PATHS)
    on one route, at its size or ``size``."""
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.models import presets

    splits, over, _, (w, h) = PATHS[path]
    if size is not None:
        w, h = size
    if splits is None:
        cfg = pt.RenderConfig(width=w, height=h, backend=backend, **over)
        return pt.Renderer(pt.Scene.cornell_box(), cfg, device=dev)
    return presets.cornell_stress(splits=splits, device=dev, width=w, height=h, backend=backend,
                                  **over)


def model_rotation(angle: float) -> np.ndarray:
    """The (4, 4) rotation by ``angle`` about the vertical axis through
    (0, 1, 0) (the JAX package's tests/test_model.py _center_rot_y)."""
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    center = np.float32([0.0, 1.0, 0.0])
    m[:3, 3] = center - m[:3, :3] @ center
    return m


def advance(pt, r, path: str, f: int, dev) -> None:
    """Frame f's motion: the drifting light of path E (the suite's row 2e),
    the rotating scene of paths M and MA (MA's camera held at the orbit's
    frame 0), the suite's orbit camera elsewhere."""
    if path == "E":
        r.move_light(dx=0.05)
    elif path in MODEL_PATHS:
        if path == "MA":
            r.camera = orbit(pt, 0, dev)
        r.set_model(model_rotation(MODEL_STEP * (f + 1)))
    else:
        r.camera = orbit(pt, f, dev)


def large_sequence_phase(pt, dev, path: str) -> dict:
    """Frames of a large-scene, gradient or moved-scene path through
    Renderer.step() on both routes; returns the kernel launch counts."""
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import LAUNCHES

    _, _, frames, (w, h) = PATHS[path]
    t_phase = time.time()
    r_k = path_renderer(pt, dev, path)
    r_p = path_renderer(pt, dev, path, backend="xla")
    LAUNCHES.clear()
    for f in range(frames):
        for r in (r_k, r_p):
            advance(pt, r, path, f, dev)
        routes_agree(f"path {path} frame {f}", r_k.step(), r_p.step(), (h, w, 3))
    counts = dict(LAUNCHES)
    expected = {k: frames * v for k, v in PER_FRAME[path].items()}
    print(f"path {path} ({r_k.tri_data.num_triangles} tris, {w}x{h}) launch counts over "
          f"{frames} frames: {counts}; {time.time() - t_phase:.1f} s")
    check(counts == expected, f"path {path} launch counts {expected}")
    return counts


def large_timing_phase(pt, dev, card: str) -> None:
    """presets.cornell_stress() with its defaults and at BVH_MIN_TRIANGLES
    (splits=2) on the kernel route, then ms/frame of paths A, B, C, D, M and
    MA at 1920x1080 and E at 512x512 on the kernel route, and of the plain
    routes of paths A and D once."""
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.models import presets

    import torch

    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import LAUNCHES
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils.profiling import time_fn

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
                                        ("C", "auto", 10, 2), ("D", "auto", 10, 2),
                                        ("E", "auto", 20, 3), ("M", "auto", 20, 3),
                                        ("MA", "auto", 10, 2), ("A", "xla", 1, 0),
                                        ("D", "xla", 1, 1)):
        size = (512, 512) if path == "E" else (w, h)
        r = path_renderer(pt, dev, path, backend, size)
        if path in MODEL_PATHS:  # the scene held at the paths' first pose
            advance(pt, r, path, 0, dev)
        elif path != "E":
            r.camera = orbit(pt, 0, dev)
        ms = time_fn(r.step, iters=reps, warmup=warmup)
        route = "kernels" if backend == "auto" else "plain"
        print(f"ms/frame path {path} ({r.tri_data.num_triangles} tris) {size[0]}x{size[1]} "
              f"{route}: {ms:.3f} ({card})")
    print(f"large-scene timing phase: {time.time() - t_phase:.1f} s", flush=True)


# The app path: the port's entry points at their own sizes, through the
# kernels (cli_torch.py, the viewer, the OBJ loaders, benchmarks/quality.py
# and the examples). Per-frame launches of each path: the CLI at its
# defaults (the reference's 1000x800, 32 bounces, 9 iterations), the CLI on
# the 32,768-triangle OBJ with path C's flags, the viewer at its default
# 320x256 with --ramp --nee.
APP_FRAMES = {"cli": 2 * FRAMES, "cli_obj": 8, "viewer": 8}
APP_PER_FRAME = {
    "cli": {"geometry": 1, "trace": 1, "atrous_iter": 9, "temporal_blend": 1},
    "cli_obj": LARGE_PER_FRAME["C"],
    "viewer": {"geometry": 1, "trace": 1, "atrous_iter_var": 9, "temporal_blend_ramp": 1},
}
APP_OBJ_SPLITS = 32
CLI_OBJ_FLAGS = ["--width", str(BENCH_SIZE[0]), "--height", str(BENCH_SIZE[1]),
                 "--gbuffer-primary", "--nee", "--max-bounces", "8", "--rr-start-bounce", "2",
                 "--adaptive-alpha"]
# The key sets apply_keys is driven with on the card: every binding, the
# light's two wraps (light x as given) and opposing keys.
KEY_SETS = [({k}, None) for k in "wasdqeijkluo"] + [
    ({"l"}, 1.95), ({"j"}, -19.95), ({"j"}, 2.5), ({"a", "d", "w", "s", "l", "o"}, None)]


def cli_run(label: str, argv: list, card: str):
    """cli_torch.main(argv) in this process; prints its report (stderr)
    under ``label`` beside the card line and returns its last frame and the
    report."""
    import contextlib
    import io

    import cli_torch

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rgb = cli_torch.main(argv)
    for line in err.getvalue().splitlines():
        print(f"  cli_torch {label}: {line} ({card})", flush=True)
    return rgb, err.getvalue()


# The two CLI runs whose difference times a frame (cli_per_frame).
APP_TIMING_FRAMES = (10, 50)


def cli_device_time(argv: list, frames: int) -> tuple:
    """Device busy ms and kernel launches of a whole profiled run of
    cli_torch.main(argv) over ``frames`` frames, set-up included."""
    import contextlib
    import io

    import cli_torch
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils.profiling import (
        busy_us,
        profiled_kernels,
    )

    with contextlib.redirect_stderr(io.StringIO()):  # the run's own report
        kernels = profiled_kernels(lambda: cli_torch.main([*argv, "--frames", str(frames)]), 1)
    return busy_us(kernels) / 1e3, len(kernels)


def cli_per_frame(argv: list) -> dict:
    """A CLI run's device busy ms and launches a frame, the slope between
    profiled runs of APP_TIMING_FRAMES frames (the set-up, which both runs
    share, enters no frame), and the set-up's own, a profiled run of no
    frame (the scene, its tables and the Renderer)."""
    lo, hi = APP_TIMING_FRAMES
    (ms_0, n_0), (ms_lo, n_lo), (ms_hi, n_hi) = (cli_device_time(argv, n) for n in (0, lo, hi))
    return dict(device_ms_per_frame=(ms_hi - ms_lo) / (hi - lo),
                launches_per_frame=(n_hi - n_lo) / (hi - lo),
                setup_device_ms=ms_0, setup_launches=n_0)


def cli_timing(path: str, argv: list, card: str, extra: tuple = ()) -> None:
    """One JSON line for a CLI path: the CLI's own steady host-clock
    ms/frame of an unprofiled run of APP_TIMING_FRAMES[1] frames (no PNGs)
    and its cli_per_frame figures. ``extra``: flags of the path whose own
    share of a frame is measured against a run without them."""
    argv = list(argv)
    _, report = cli_run(f"{path} timing",
                        [*argv, *extra, "--frames", str(APP_TIMING_FRAMES[1])], card)
    steady = re.search(r"first \(kernel build \+ first frame\) ([0-9.]+)s, steady ([0-9.]+) ms",
                       report)
    check(steady is not None, f"{path}: the CLI reports its steady ms/frame")
    line = {"app_timing": path, "argv": " ".join([*argv, *extra]), "first_s": float(steady[1]),
            "ms_per_frame": float(steady[2]), "frames_profiled": list(APP_TIMING_FRAMES),
            **cli_per_frame([*argv, *extra])}
    if extra:
        without = cli_per_frame(argv)
        line["share_of " + " ".join(extra)] = {
            k: line[k] - without[k] for k in ("device_ms_per_frame", "launches_per_frame")}
    line["device"] = card
    print(json.dumps(line), flush=True)


def app_twins(pt, dev, label: str, scene, cfg, frames: int, app_last, move=None) -> None:
    """An app path's frames rendered again by a kernel-route and a
    plain-route Renderer of its scene and config, with its motion
    (``move(renderer, frame)``), each frame held to the paths' gate
    (routes_agree); the app's own last frame ``app_last`` is held to the
    plain route's last. The path's launch counts are read before."""
    import torch

    r_k = pt.Renderer(scene, cfg, device=dev)
    r_p = pt.Renderer(scene, dataclasses.replace(cfg, backend="xla"), device=dev)
    shape = (cfg.height, cfg.width, 3)
    t0 = time.time()
    for f in range(frames):
        for r in (r_k, r_p):
            if move is not None:
                move(r, f)
        a, b = r_k.step(), r_p.step()
        routes_agree(f"{label} frame {f}", a, b, shape)
    app_last = torch.as_tensor(app_last, device=dev)
    routes_agree(f"{label}: the app's own last frame", app_last, b, shape)
    print(f"{label}: the app's own last frame bit-equal to the kernel twin's "
          f"{torch.equal(app_last, a)}; twins {time.time() - t0:.1f} s", flush=True)


def check_app_counts(path: str, counts: dict) -> None:
    frames = APP_FRAMES[path]
    expected = {k: frames * v for k, v in APP_PER_FRAME[path].items()}
    print(f"{path} launch counts over {frames} frames: {counts}")
    check(counts == expected, f"{path} launch counts {expected}")


def input_sync_check(pt, dev) -> int:
    """apply_keys on the card, under torch.cuda.set_sync_debug_mode("error")
    (it must not wait for the card), equal to apply_keys on the CPU for
    every key set of KEY_SETS; returns the number of key sets."""
    import torch

    from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline.input import (
        apply_keys,
    )

    cfg = pt.RenderConfig()

    def inputs(d, light_x):
        light = pt.Light.default(d)
        if light_x is not None:
            light = dataclasses.replace(light,
                                        position=torch.tensor([light_x, 1.0, -0.4], device=d))
        return pt.Camera.default(d), light

    for keys, light_x in KEY_SETS:
        want = apply_keys(*inputs("cpu", light_x), keys, cfg)
        cam, light = inputs(dev, light_x)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = apply_keys(cam, light, keys, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        same = got[2] == want[2] and all(
            g.device == light.position.device and torch.equal(g.cpu(), w)
            for g, w in ((got[0].position, want[0].position), (got[1].position, want[1].position)))
        check(same, f"apply_keys {sorted(keys)} (light x {light_x}) on the card without a sync, "
                    "equal to the CPU")
    return len(KEY_SETS)


def app_phase(pt, dev, card: str) -> dict:
    """The app path on the card: cli_torch.main at its defaults (16 frames
    with the light orbiting, PNGs every 8, then 8 frames checkpointed and 8
    resumed, bit-equal to the straight run's frame 15), the native and
    Python OBJ loaders on the 32,768-triangle subdivided box, cli_torch.main
    on that OBJ with path C's flags, the viewer headless with --ramp --nee,
    apply_keys under sync debug mode "error", the six quality bars of
    benchmarks/quality.BARS, and the three examples/*_torch.py as
    subprocesses. Each frame path is held to the plain route: the cli,
    cli_obj and viewer frames through app_twins, each quality bar measured
    again on the plain route with its frames, raw frame and truth compared.
    Returns the launch counts of the cli, cli_obj, viewer and quality
    paths."""
    import contextlib
    import io
    import tempfile

    import cli_torch
    import torch

    from real_time_path_tracing_with_spatiotemporal_filtering_torch import viewer
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.benchmarks import quality
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.native import loader
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import LAUNCHES
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import obj, procedural

    t_phase = time.time()
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        # cli: the straight run, then the same frames checkpointed and resumed
        seq, ck = os.path.join(tmp, "seq"), os.path.join(tmp, "ck.npz")
        light = ["--orbit-light", "0.1"]
        LAUNCHES.clear()
        straight, _ = cli_run("cli straight", ["--frames", str(FRAMES), *light,
                                               "--save-every", "8", "--out", seq], card)
        cli_run("cli checkpoint", ["--frames", str(FRAMES // 2), *light, "--checkpoint", ck],
                card)
        resumed, _ = cli_run("cli resume", ["--frames", str(FRAMES // 2), *light,
                                            "--resume", ck], card)
        torch.cuda.synchronize()
        paths["cli"] = dict(LAUNCHES)
        check(bool(torch.isfinite(straight).all().item())
              and tuple(straight.shape) == (HEIGHT, WIDTH, 3), "cli: frame finite, (H, W, 3)")
        check(torch.equal(resumed, straight),
              f"cli: the resumed run's last frame is bit-equal to the straight run's frame "
              f"{FRAMES - 1} (max_abs {max_abs(resumed, straight):.3e})")
        check(sorted(os.listdir(seq)) == ["frame_00000.png", "frame_00008.png"],
              "cli: --save-every 8 wrote frames 0 and 8")
        check_app_counts("cli", paths["cli"])
        app_twins(pt, dev, "cli", pt.Scene.cornell_box(),
                  cli_torch.build_config(cli_torch.parser().parse_args(light)), FRAMES, straight,
                  move=lambda r, f: r.move_light(dx=0.1))
        cli_timing("cli", [], card, extra=tuple(light))

        # cli_obj: the 32,768-triangle OBJ through both loaders, then path C
        scene_path = os.path.join(tmp, f"subdivided_cornell_{APP_OBJ_SPLITS}.obj")
        procedural.write_obj(scene_path, *procedural.subdivided_cornell(APP_OBJ_SPLITS))
        t0 = time.perf_counter()
        loader.library()
        t_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        nv, ni = loader.load_obj(scene_path)
        t_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        pv, pi = obj.load_obj_python(scene_path)
        t_python = time.perf_counter() - t0
        print(f"OBJ loaders on {ni.shape[0]} triangles ({os.path.getsize(scene_path)} bytes): "
              f"native {t_native:.4f} s (g++ build {t_build:.2f} s), python {t_python:.4f} s "
              f"({card})", flush=True)
        check(ni.shape == (32 * APP_OBJ_SPLITS ** 2, 3) and np.array_equal(nv, pv)
              and np.array_equal(ni, pi), "native OBJ loader equals load_obj_python")
        obj_argv = ["--scene", scene_path, *CLI_OBJ_FLAGS]
        LAUNCHES.clear()
        last, _ = cli_run("cli_obj", [*obj_argv, "--frames", str(APP_FRAMES["cli_obj"])], card)
        torch.cuda.synchronize()
        paths["cli_obj"] = dict(LAUNCHES)
        check(bool(torch.isfinite(last).all().item())
              and tuple(last.shape) == (BENCH_SIZE[1], BENCH_SIZE[0], 3),
              "cli_obj: frame finite, (H, W, 3)")
        check_app_counts("cli_obj", paths["cli_obj"])
        app_twins(pt, dev, "cli_obj", pt.Scene.from_arrays(nv, ni),
                  cli_torch.build_config(cli_torch.parser().parse_args(obj_argv)),
                  APP_FRAMES["cli_obj"], last)
        cli_timing("cli_obj", obj_argv, card)

        # viewer: headless, preview into a buffer
        args = viewer.parser().parse_args(["--headless", "--ramp", "--nee",
                                           "--frames", str(APP_FRAMES["viewer"])])
        buf = io.StringIO()
        LAUNCHES.clear()
        with contextlib.redirect_stdout(buf):
            shown = viewer.run_viewer(args)
        torch.cuda.synchronize()
        paths["viewer"] = dict(LAUNCHES)
        status = [ln for ln in buf.getvalue().splitlines() if ln.startswith("frame ")]
        print(f"viewer {args.width}x{args.height} --ramp --nee: {status[-1] if status else ''} "
              f"({card})", flush=True)
        check(len(status) == APP_FRAMES["viewer"] and "▀" in buf.getvalue(),
              f"viewer: {APP_FRAMES['viewer']} previews")
        check_app_counts("viewer", paths["viewer"])
        app_twins(pt, dev, "viewer", pt.Scene.cornell_box(), viewer.build_config(args),
                  APP_FRAMES["viewer"], shown)

        n = input_sync_check(pt, dev)
        print(f"apply_keys: {n} key sets on the card without a sync", flush=True)

        # the quality bars, then each again on the plain route
        t0 = time.time()
        LAUNCHES.clear()
        got = {bar.name: quality.run_bar(bar, dev) for bar in quality.BARS}
        torch.cuda.synchronize()
        paths["quality"] = dict(LAUNCHES)
        print(f"quality bars: {time.time() - t0:.1f} s ({card}); launches {paths['quality']}",
              flush=True)
        t0 = time.time()
        for bar in quality.BARS:
            k, p = got[bar.name], quality.run_bar(bar, dev, backend="xla")
            print(json.dumps({"quality_bar": bar.name, "rmse_denoised": k["rmse_denoised"],
                              "rmse_noisy_1spp": k["rmse_noisy_1spp"],
                              "improvement": k["improvement"], "max_rmse": bar.max_rmse,
                              "min_improvement": bar.min_improvement,
                              "plain_route": {"rmse_denoised": p["rmse_denoised"],
                                              "rmse_noisy_1spp": p["rmse_noisy_1spp"]},
                              "jax_recorded": bar.recorded, "jax_recorded_at": bar.recorded_at,
                              "device": card}), flush=True)
            check(k["ok"], f"quality bar {bar.name}: rMSE {k['rmse_denoised']:.4f} <= "
                           f"{bar.max_rmse}, improvement {k['improvement']:.2f} >= "
                           f"{bar.min_improvement:.3f}")
            k_img, p_img = k["images"], p["images"]
            shape = tuple(k_img["noisy"].shape)
            for f, (a, b) in enumerate(zip(k_img["frames"], p_img["frames"], strict=True)):
                routes_agree(f"quality {bar.name} frame {f}", a, b, shape)
            routes_agree(f"quality {bar.name} raw 1-spp frame", k_img["noisy"], p_img["noisy"],
                         shape)
            routes_agree(f"quality {bar.name} truth", torch.as_tensor(k_img["truth"]),
                         torch.as_tensor(p_img["truth"]), shape)
        print(f"quality bars on the plain route, held to the kernel route: "
              f"{time.time() - t0:.1f} s ({card})", flush=True)

        # the examples, as a user runs them, all three at once
        root = os.path.dirname(os.path.abspath(__file__))
        ex = os.path.join(root, "examples")
        pngs = [os.path.join(tmp, "cornell.png"), os.path.join(tmp, "obj.png")]
        runs = {
            "render_cornell_torch.py": [pngs[0]],
            "render_obj_torch.py": [scene_path, pngs[1], "--rr"],
            "checkpoint_resume_torch.py": [],
        }
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        t0 = time.time()
        procs = {name: subprocess.Popen([sys.executable, os.path.join(ex, name), *argv],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True, env=env)
                 for name, argv in runs.items()}
        outs = {}
        try:
            for name, proc in procs.items():
                outs[name] = proc.communicate(timeout=300)[0]
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for name, proc in procs.items():
            print(f"example {name}: exit {proc.returncode}: {outs[name].strip()[-400:]}")
        print(f"examples: {time.time() - t0:.1f} s ({card})", flush=True)
        check(all(proc.returncode == 0 for proc in procs.values())
              and all(os.path.exists(p) for p in pngs)
              and "resume bit-identical" in outs["checkpoint_resume_torch.py"],
              "examples: all three exit 0, both PNGs written, the resume bit-identical")
    print(f"app phase: {time.time() - t_phase:.1f} s ({card})", flush=True)
    return paths


# The micro-kernels: each kernel's pallas_call line in the JAX package's
# benchmarks/mosaic_micro.py, and the operations one iteration of each
# primitive does, counted from those kernels' bodies (integer and float
# operations alike, at the float32 rate): scalar 6 (and, mul, add, and,
# shift, xor); dynrow a 128-wide add and 3; assemble 8 x 128 adds and 18;
# vec 10 an element (two fused multiply-adds count 2 each, 3 products, an
# add, a max and a min); when 5; reduce 4096 adds, 4095 max, a fused
# multiply-add and 2; dynwin 1024 products and 5; cond 5.
MICRO_SITES = {"scalar": 98, "dynrow": 128, "assemble": 159, "vec": 189, "when": 222,
               "reduce": 250, "dynwin": 280, "cond": 305}
MICRO_OPS = {"scalar": 6, "dynrow": 131, "assemble": 1042, "when": 5, "reduce": 8195,
             "dynwin": 1029, "cond": 5}
MICRO_ITERS = 200_000  # the JAX benchmark's --iters
MICRO_CHECK_ITERS = (64, 1000)
MICRO_PLAIN_ITERS = (64, 256)  # the plain twins' slope on the card
# Primitives whose timed launch at the lower JAX count is also held against
# the plain twin (0.4-4 s of the twin on the card). The vec twins take 16-23 s
# there and are held against the kernel at MICRO_CHECK_ITERS only.
MICRO_TWIN_AT_JAX_COUNT = ("scalar", "dynrow", "assemble", "when", "reduce", "dynwin", "cond")


# Row-slab modes (the row-sharded frame, parallel/): the middle third of a
# 1920x1080 frame, the slab of rank 1 of 3, the interior one.
SLAB = (360, 360)  # (row_offset, rows)


def slab_mode(label: str, err: float, kernel: dict, plain_ms: float, **fields) -> dict:
    """A row-slab mode's entry in its kernel's record."""
    return dict(mode=f"{label}, rows {SLAB[0]}..{SLAB[0] + SLAB[1]} of 1920x1080 (sharded slab)",
                max_abs_err=err, plain_ms=plain_ms, **kernel, **fields)


def timed_plain(fn):
    """(result, ms) of one call of the plain version ``fn``."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def slab_kernel_phase(pt, dev, records) -> None:
    """Each kernel's row-slab, halo and window mode (the sharded frame's)
    against its plain version with the same arguments, bit for bit, at
    1920x1080 with row_offset 360 and 360 rows: the geometry kernels in
    both modes (the Cornell box; 32,768 triangles), the trace kernel, the
    segment kernel (path A, every segment) and the shadow kernel (path C's
    slab), the a-trous kernels with k-row halos at k = 1, 5, 9, and both
    blends on a reprojection window and on a gathered plane. Each also
    equals those rows of its whole-frame result where it has one. Adds each
    as a mode of its kernel's record."""
    import torch

    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import atrous, gbuffer
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import (
        atrous as at_mod,
        geometry as geo_mod,
        pathtrace as pt_mod,
        wavefront as wf,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.parallel.sharding import (
        REPROJ_HALO_ROWS,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline import frame
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import procedural

    t_phase = time.time()
    by_name = {r["name"]: r for r in records}
    w, h = BENCH_SIZE
    r0, rows = SLAB
    slab = dict(row_offset=r0, rows=rows)
    cornell = pt.precompute_triangle_data(pt.Scene.cornell_box(), dev)
    td32 = pt.precompute_triangle_data(pt.Scene.from_arrays(*procedural.subdivided_cornell(32)),
                                       dev)
    base = pt.RenderConfig(width=w, height=h)
    path_a = dataclasses.replace(base, **LARGE["A"][1])
    cam, light = orbit(pt, 3, dev), pt.Light.default(dev)

    def planes_agree(label, k, p, whole):
        err = max(same_bits(f"{label} {name}", getattr(k, name).float(), getattr(p, name).float())
                  for name in k._fields if getattr(k, name) is not None)
        check(all(torch.equal(getattr(k, n), getattr(whole, n)[r0:r0 + rows])
                  for n in k._fields if getattr(k, n) is not None),
              f"{label}: the slab equals those rows of the whole frame")
        return err

    # -- geometry kernels, full and visibility-only modes; the bounds from
    # the slab's own counting launches --
    for name, td, geo_fn, kernel in (
            ("geometry", cornell, geo_mod.geometry_pass, "geometry_kernel"),
            ("geometry_bvh", td32, geo_mod.geometry_pass_bvh, "geometry_bvh_kernel")):
        args = stress_geo_args(pt, td, base, dev)
        k = geo_fn(*args, emit_albedo=True, **slab)
        p, plain_ms = timed_plain(lambda: geo_mod.geometry_pass_plain(*args, emit_albedo=True,
                                                                      **slab))
        err = planes_agree(f"{name} slab", k, p, geo_fn(*args, emit_albedo=True))
        if name == "geometry":
            fields = dense_geometry_fields(geo_mod, args, base, albedo=True, **slab)
        else:
            fields = geometry_bvh_bound(geo_mod, args, td, base, **slab)
        by_name[name]["modes"].append(slab_mode(
            f"{td.num_triangles} triangles with albedo", err,
            kernel_ms(lambda: geo_fn(*args, emit_albedo=True, **slab), kernel), plain_ms,
            **fields))
        view, proj = frame.camera_matrices(cam, base)
        vargs = (td, cam.position, view, proj, base, cam.rotation)
        k = geo_mod.visibility_pass(*vargs, **slab)
        p, plain_ms = timed_plain(lambda: gbuffer.visibility_pass(
            *vargs[:5], rotation=cam.rotation, **slab))
        err = planes_agree(f"{name} visibility-only slab", k, p, geo_mod.visibility_pass(*vargs))
        if name == "geometry":
            fields = dense_geometry_fields(geo_mod, vargs, base, vis_only=True, **slab)
        else:
            fields = geometry_bvh_bound(geo_mod, vargs, td, base, vis_only=True, **slab)
        by_name[name]["modes"].append(slab_mode(
            f"visibility-only, {td.num_triangles} triangles", err,
            kernel_ms(lambda: geo_mod.visibility_pass(*vargs, **slab), kernel), plain_ms,
            **fields))

    # -- trace kernel: the default config, frame 5 --
    k = pt_mod.path_trace_pass(cornell, cam.position, light, 5, base, cam.rotation, **slab)
    p, plain_ms = timed_plain(lambda: pt_mod.path_trace_pass_plain(
        cornell, cam.position, light, 5, base, rotation=cam.rotation, **slab))
    err = same_bits("trace slab", k, p)
    whole = pt_mod.path_trace_pass(cornell, cam.position, light, 5, base, cam.rotation)
    check(torch.equal(k, whole[r0:r0 + rows]), "trace slab equals those rows of the whole frame")
    by_name["trace"]["modes"].append(slab_mode(
        "default config, frame 5", err,
        kernel_ms(lambda: pt_mod.path_trace_pass(cornell, cam.position, light, 5, base,
                                                 cam.rotation, **slab), "trace_kernel", 5),
        plain_ms, **trace_bound(pt_mod, cornell, cam, light, 5, base, **slab)))

    # -- segment kernel: every segment of path A's slab; shadow kernel:
    # path C's slab of bounce-0 shadow rays --
    err, plain_ms = segments_agree(wf, td32, path_a, cam, light, 5, "path A slab", **slab)
    by_name["trace_segment"]["modes"].append(slab_mode(
        "path A (32768 triangles), one frame's segments, per launch", err,
        kernel_ms(lambda: frame_segments(wf, td32, path_a, cam, light, 5, **slab),
                  "trace_segment_kernel", 3, warmup=1, mean=True), plain_ms,
        **segment_bound(wf, td32, path_a, cam, light, 5, **slab)))
    path_c = dataclasses.replace(base, **LARGE["C"][1])
    rays = path_c_shadow_rays(pt, geo_mod, td32, path_c, cam, light, dev, **slab)
    k = wf.shadow_segment(*rays, td32, path_c, width=w)
    p, plain_ms = timed_plain(lambda: wf.shadow_segment_plain(*rays, td32, path_c))
    err = same_bits("shadow_segment path C slab", k, p)
    whole = wf.shadow_segment(*path_c_shadow_rays(pt, geo_mod, td32, path_c, cam, light, dev),
                              td32, path_c, width=w)
    check(torch.equal(k, whole[r0 * w:(r0 + rows) * w]),
          "shadow_segment slab equals those rays of the whole frame")
    fields = shadow_segment_fields(wf, geo_mod, td32, path_c, rays)
    by_name["shadow_segment"]["modes"].append(slab_mode(
        "path C's bounce-0 shadow rays", float((k != p).any().item()),
        {k_: fields.pop(k_) for k_ in ("ms", "call_ms") if k_ in fields}, plain_ms, **fields))

    # -- a-trous kernels: the slab's rows with k exchanged rows a side --
    rng = np.random.default_rng(SEED + 7)
    geo = geo_mod.geometry_pass(*stress_geo_args(pt, cornell, base, dev))
    color = torch.tensor(rng.exponential(0.5, (h, w, 3)).astype(np.float32), device=dev)
    var = torch.tensor((0.1 * rng.random((h, w))).astype(np.float32), device=dev)
    cfg_v = dataclasses.replace(base, variance_guided=True)
    for k_ in ATROUS_KS:
        window = slice(r0 - k_, r0 + rows + k_)
        ins = (color[window], geo.normal[window], geo.depth[window])
        got = at_mod.atrous_iteration(*ins, k_, base, halo=k_)
        want, plain_ms = timed_plain(lambda: at_mod.atrous_iteration_plain(*ins, k_, base,
                                                                           halo=k_))
        err = same_bits(f"atrous_iter halo k={k_}", got, want)
        whole = at_mod.atrous_iteration(color, geo.normal, geo.depth, k_, base)
        check(torch.equal(got, whole[r0:r0 + rows]),
              f"atrous_iter halo k={k_} equals those rows of the whole frame's iteration")
        by_name["atrous_iter"]["modes"].append(slab_mode(
            f"halo k={k_}", err, kernel_ms(lambda: at_mod.atrous_iteration(*ins, k_, base,
                                                                           halo=k_),
                                           "atrous_iter_kernel"), plain_ms,
            **bound(40 * rows * w, ATROUS_OPS * rows * w)))
        ins_v = (color[window], var[window], geo.normal[window], geo.depth[window])
        got = at_mod.atrous_iteration_var(*ins_v, k_, cfg_v, halo=k_)
        want, plain_ms = timed_plain(lambda: at_mod.atrous_iteration_var_plain(
            *ins_v, k_, cfg_v, halo=k_))
        err = max(same_bits(f"atrous_iter_var halo k={k_} {part}", a, b)
                  for part, a, b in zip(("color", "var"), got, want))
        whole = at_mod.atrous_iteration_var(color, var, geo.normal, geo.depth, k_, cfg_v)
        check(all(torch.equal(a, b[r0:r0 + rows]) for a, b in zip(got, whole)),
              f"atrous_iter_var halo k={k_} equals those rows of the whole frame's iteration")
        by_name["atrous_iter_var"]["modes"].append(slab_mode(
            f"halo k={k_}", err,
            kernel_ms(lambda: at_mod.atrous_iteration_var(*ins_v, k_, cfg_v, halo=k_),
                      "atrous_iter_var_kernel"), plain_ms,
            **bound(48 * rows * w, ATROUS_VAR_OPS * rows * w)))

    # -- blends: the slab's backprojection (orbit one frame), the history
    # gathered from the reprojection window (row0 = row_offset - halo) or
    # from the all-gathered frame (row0 = 0) --
    cur_geo, _ = frame_backprojection(pt, geo_mod, base, dev)
    py, px = (t[r0:r0 + rows].contiguous() for t in (cur_geo.prev_y, cur_geo.prev_x))
    prev = torch.tensor(rng.exponential(0.5, (h, w, 3)).astype(np.float32), device=dev)
    lam = torch.tensor(rng.uniform(0, 1, (rows, w)).astype(np.float32), device=dev)
    filtered = color[r0:r0 + rows].contiguous()
    prev_age = torch.tensor(rng.integers(0, 40, (h, w)).astype(np.float32), device=dev)
    prev_cons = cur_geo.visibility
    cur_cons = cur_geo.visibility[r0:r0 + rows].contiguous()
    ramp_cfg = dataclasses.replace(base, accumulation_ramp=True, adaptive_alpha=True)
    halo = REPROJ_HALO_ROWS
    sources = {"reprojection window": (slice(r0 - halo, r0 + rows + halo), r0 - halo),
               "all-gathered frame": (slice(0, h), 0)}
    for label, (rs, row0) in sources.items():
        src = tuple(t[rs].contiguous() for t in (prev, prev_age, prev_cons))
        err = err2 = 0.0
        for f in (0, 3):  # frame 0 passes through; frame 3 gathers
            a = at_mod.temporal_blend(filtered, src[0], py, px, f, lam, base, src_row0=row0)
            b, plain_ms = timed_plain(lambda: at_mod.temporal_blend_plain(
                filtered, src[0], py, px, f, lam, base, src_row0=row0))
            err = max(err, same_bits(f"temporal_blend {label} frame {f}", a, b))
            a2 = at_mod.temporal_blend_ramp(filtered, src[0], py, px, f, lam, src[1], src[2],
                                            cur_cons, ramp_cfg, src_row0=row0)
            b2, plain2_ms = timed_plain(lambda: at_mod.temporal_blend_ramp_plain(
                filtered, src[0], py, px, f, lam, src[1], src[2], cur_cons, ramp_cfg,
                src_row0=row0))
            err2 = max([err2] + [same_bits(f"temporal_blend_ramp {label} frame {f} {part}", x, y)
                                 for part, x, y in zip(("rgb", "age"), a2, b2)])
        by_name["temporal_blend"]["modes"].append(slab_mode(
            f"history from the {label}", err,
            kernel_ms(lambda: at_mod.temporal_blend(filtered, src[0], py, px, 3, lam, base,
                                                    src_row0=row0), "temporal_blend_kernel"),
            plain_ms, **bound(48 * rows * w, BLEND_OPS * rows * w)))
        by_name["temporal_blend_ramp"]["modes"].append(slab_mode(
            f"history from the {label}", err2,
            kernel_ms(lambda: at_mod.temporal_blend_ramp(
                filtered, src[0], py, px, 3, lam, src[1], src[2], cur_cons, ramp_cfg,
                src_row0=row0), "temporal_blend_ramp_kernel"),
            plain2_ms, **bound(64 * rows * w, RAMP_BLEND_OPS * rows * w)))
    print(f"row-slab kernel phase: {time.time() - t_phase:.1f} s", flush=True)


# The sharded phase: 3 gloo ranks sharing cuda:0 at 1920x1080 (360 rows a
# rank, rank 1 interior), 4 frames a path: orbit angles 0, 0.02, 0.04, then
# a cut to 1.5. (scene: splits of subdivided_cornell or None for the Cornell
# box; config overrides.)
SHARD_RANKS = 3
SHARD_ANGLES = (0.0, 0.02, 0.04, 1.5)
SHARDED_PATHS = {
    "default_1080p": (None, {}),
    "asvgf_1080p": (None, PATHGRAD),
    "stress32c": (32, LARGE["C"][1]),
    "recommended32": (32, RECOMMENDED),
}
# The JAX package's CommLedger for these configs over 3 devices at
# 1920x1080 (halo, reprojection halo, all-gather fallback bytes), from
# jax.eval_shape of its make_sharded_frame on a CPU mesh, as its
# tests/test_sharding.py reads it.
JAX_LEDGER_3 = {
    "default_1080p": (5022720, 184320, 16588800),
    "asvgf_1080p": (6062080, 491520, 44236800),
    "recommended32": (6017280, 430080, 38707200),
}


def sharded_phase(pt, dev, card: str) -> dict:
    """The row-sharded frame (parallel/frame_sharded.py) as a user runs it:
    sharding.spawn of SHARD_RANKS gloo ranks on the one card, each through
    make_sharded_frame on the kernels' row-slab modes, over the four
    SHARDED_PATHS. Rank 0 gathers every frame and history plane and holds
    it to the single-device kernel route's, bit for bit; each rank's
    launches a frame must equal the single-device route's. Prints per rank
    the launches, ms and device ms a frame and the exchange's ms, and the
    byte ledger against the JAX package's. Returns the launch counts of the
    sharded paths (summed over ranks)."""
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.parallel import (
        frame_sharded,
        sharding,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import procedural

    t_phase = time.time()
    w, h = BENCH_SIZE
    poses = [(pt.Camera.orbit([0.0, 1.0, 0.0], 6.0, a, 1.0), pt.Light.default())
             for a in SHARD_ANGLES]
    jobs, names = [], []
    for name, (splits, over) in SHARDED_PATHS.items():
        scene = pt.Scene.cornell_box() if splits is None else pt.Scene.from_arrays(
            *procedural.subdivided_cornell(splits))
        cfg = pt.RenderConfig(width=w, height=h, **over)
        jobs.append((scene, cfg, poses, 3, True, False))
        names.append(name)
    results = sharding.spawn(frame_sharded.render_jobs, SHARD_RANKS, jobs, backend="gloo",
                             device="cuda", timeout=120.0)
    paths = {}
    for i, name in enumerate(names):
        outs = [r[i] for r in results]
        ref = outs[0]
        for f, (eq, err) in enumerate(zip(ref["equal"], ref["max_abs"])):
            print(f"sharded {name} frame {f}: gathered planes bit-equal to the single-device "
                  f"kernel route {eq}, max_abs {err:.3e}", flush=True)
        check(all(all(eq.values()) for eq in ref["equal"]),
              f"sharded {name}: every gathered frame and history plane over {SHARD_RANKS} ranks "
              "bit-equal to the single-device kernel route")
        for o in outs:
            check(o["launches"] == ref["single_launches"],
                  f"sharded {name} rank {o['rank']}: the single-device route's kernels a frame "
                  f"{ref['single_launches'][-1]}")
            dev_ms = o.get("device", {})
            print(f"sharded {name} rank {o['rank']}/{SHARD_RANKS} {w}x{h}: launches a frame "
                  f"{o['launches'][-1]}; ms a frame {[round(x, 3) for x in o['ms']]} "
                  f"(single device {[round(x, 3) for x in ref['single_ms']]}); device ms a "
                  f"frame {dev_ms.get('device_ms', 'not measured')}, launches "
                  f"{dev_ms.get('launches', 'not measured')}, profiler windows "
                  f"{dev_ms.get('profiler_windows', 'not measured')}; exchange ms "
                  f"{[round(x, 3) for x in o['comm_ms']]} ({card})", flush=True)
        ledger = ref["ledger"]
        comm = [c["gather_bytes"] for c in ref["comm"]]
        print(f"sharded {name} ledger: {ledger}; gather bytes a frame {comm}; fallback over "
              f"window {ledger['gather_fallback_bytes'] / ledger['reproj_halo_bytes']:.1f}",
              flush=True)
        check(all(o["ledger"] == ledger for o in outs), f"sharded {name}: every rank's ledger")
        check(comm[1:3] == [0, 0] and comm[3] == ledger["gather_fallback_bytes"],
              f"sharded {name}: no all-gather on the orbit, the fallback on the cut")
        if name in JAX_LEDGER_3:
            want = dict(zip(("halo_bytes", "reproj_halo_bytes", "gather_fallback_bytes"),
                            JAX_LEDGER_3[name]))
            check(ledger == want, f"sharded {name}: ledger {want}, the JAX package's")
        total = {}
        for o in outs:
            for counts in o["launches"]:
                for k, v in counts.items():
                    total[k] = total.get(k, 0) + v
        paths[f"sharded_{name}"] = total
        print(json.dumps({"sharded_path": name, "ranks": SHARD_RANKS, "size": [w, h],
                          "card": card, "ms": [o["ms"] for o in outs],
                          "comm_ms": [o["comm_ms"] for o in outs],
                          "device": [o.get("device") for o in outs],
                          "single_ms": ref["single_ms"], "ledger": ledger,
                          "gather_bytes": comm}), flush=True)
    print(f"sharded phase: {time.time() - t_phase:.1f} s", flush=True)
    return paths


def micro_agrees(micro, name: str, x, got: dict, iters: int, what: str) -> None:
    """Check a micro-kernel's result ``got`` at ``iters`` iterations: the
    output equals ``x``, and the output and every carry are bit-equal to
    the plain twin's."""
    import torch

    want = micro.run_plain(name, x, iters)
    torch.cuda.synchronize()
    check(sorted(got) == sorted(want) and torch.equal(got["out"], x)
          and all(torch.equal(got[c], want[c]) for c in want),
          f"micro {name} at {iters} iterations{what}: out equals x, out and carries "
          f"{sorted(set(want) - {'out'})} bit-equal to the plain twin")


def micro_phase(dev) -> tuple:
    """The micro-kernels: each primitive against its plain twin at two
    iteration counts (``torch.equal`` on the output and every carry), then
    the micro-benchmark (benchmarks/mosaic_micro.py) at the JAX counts, its
    launches counted, and the last timed launch at each count checked
    (MICRO_TWIN_AT_JAX_COUNT against the twin at the lower count). Returns
    the records (ms per iteration by slope) and the path's launch counts."""
    import torch

    from real_time_path_tracing_with_spatiotemporal_filtering_torch.benchmarks import (
        mosaic_micro,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import (
        LAUNCHES,
        micro,
    )

    t_phase = time.time()
    x = micro.make_input(dev)
    for name in micro.PRIMITIVES:
        for iters in MICRO_CHECK_ITERS:
            micro_agrees(micro, name, x, micro.run(name, x, iters), iters, "")
    LAUNCHES.clear()
    slopes = {name: mosaic_micro.run_pair(name, x, *mosaic_micro.counts(name, MICRO_ITERS))
              for name in micro.PRIMITIVES}
    counts = dict(LAUNCHES)
    for name, r in slopes.items():
        # the last timed launch at each JAX count
        for hi_lo in ("hi", "lo"):
            got, iters = r[f"{hi_lo}_result"], r[f"iters_{hi_lo}"]
            check(torch.equal(got["out"], x)
                  and all(bool(torch.isfinite(v.float()).all()) for v in got.values()),
                  f"micro {name} timed at {iters} iterations: out equals x, carries finite")
        if name in MICRO_TWIN_AT_JAX_COUNT:
            micro_agrees(micro, name, x, r["lo_result"], r["iters_lo"], " (timed)")
    by_kernel: dict = {}
    for name, r in slopes.items():
        prim = micro.PRIMITIVES[name]
        plain = mosaic_micro.run_pair(name, x, *reversed(MICRO_PLAIN_ITERS), reps=3, plain=True)
        elems = prim.shape[0] * prim.shape[1] if prim.shape else 0
        ops = MICRO_OPS.get(prim.kernel, 10 * elems)
        # per launch: x read and out written (16 KB each) and the carries
        # written (the side tables: when 1 KB, dynwin 32 KB, the accumulators)
        side = {"when": 1028, "dynwin": 32772, "dynrow": 516, "assemble": 4100,
                "reduce": 8}.get(prim.kernel, 8 + 4 * elems)
        per_iter = bound(32768 + side, ops * r["iters_hi"])
        mode = dict(mode=name, ns_per_iter=r["ns_per_iter"], plain_ns_per_iter=plain["ns_per_iter"],
                    iters=(r["iters_hi"], r["iters_lo"]), launch_ms=(r["hi_ms"], r["lo_ms"]),
                    ms=r["ns_per_iter"] * 1e-6, plain_ms=plain["ns_per_iter"] * 1e-6,
                    bound_ms=per_iter["bound_ms"] / r["iters_hi"], bound_by=per_iter["bound_by"])
        print(f"micro {name}: {r['ns_per_iter']:.3f} ns/iteration (launches {r['hi_ms']:.4f} ms "
              f"at {r['iters_hi']}, {r['lo_ms']:.4f} ms at {r['iters_lo']}); plain twin "
              f"{plain['ns_per_iter']:.1f} ns/iteration", flush=True)
        by_kernel.setdefault(prim.kernel, []).append(mode)
    records = []
    for kernel, modes in by_kernel.items():
        first = modes[0]
        records.append(record(
            f"micro_{kernel}", "micro.cu", f"benchmarks/mosaic_micro.py:{MICRO_SITES[kernel]}",
            max_abs_err=0.0, ms_is="per loop iteration: the slope between two iteration counts",
            **{k: first[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "ns_per_iter",
                                     "plain_ns_per_iter", "iters", "launch_ms")},
            note="a latency probe (one thread or one block): nowhere near the card's bound"))
        if len(modes) > 1:
            records[-1]["modes"] = modes
    print(f"micro-kernel phase: {time.time() - t_phase:.1f} s; launches {counts}", flush=True)
    return records, counts


def suite_phase(dev, when: str = "") -> dict:
    """The measurement entry points: bench_torch.run_bench at 1920x1080 for
    a few frames, and the port's benchmark suite in --quick mode with
    device time; prints their JSON lines, each row with the profiler
    windows it took. Returns the launch counts of each, by path (``when``
    added to the path names). Run before and after the sharded phase, to
    see whether the sharded ranks' profiling leaves an empty window."""
    import torch

    from real_time_path_tracing_with_spatiotemporal_filtering_torch.benchmarks import suite
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import LAUNCHES
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils import profiling
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils.device import (
        device_name,
    )

    import bench_torch

    t_phase = time.time()
    w, h = BENCH_SIZE
    LAUNCHES.clear()
    ms, name = bench_torch.run_bench(w, h, frames=5, warmup=3, device=dev)
    paths = {f"bench_torch{when}": dict(LAUNCHES)}
    line = bench_torch.result_line(w, h, ms, name)
    print(json.dumps(line), flush=True)
    check(line["value"] > 0 and np.isfinite(line["value"]), "bench_torch: finite ms/frame")
    LAUNCHES.clear()
    empty = profiling.empty_windows
    rows = suite.run_suite(quick=True, device=dev, device_time=True)
    paths[f"suite --quick{when}"] = dict(LAUNCHES)
    card = device_name(dev)
    for row, result in rows:
        print(json.dumps(suite.row_line(row, result, card)), flush=True)
    want = [n for n, _ in suite.suite_entries(True, device=dev)]
    check([n for n, _ in rows] == want and all(
        np.isfinite(r["ms"]) and r["device_ms"] > 0 and r["launches"] > 0 for _, r in rows),
        f"suite --quick --device-time: {len(want)} rows, finite ms, device ms and launches")
    torch.cuda.synchronize()
    print(f"suite phase{when}: {time.time() - t_phase:.1f} s; profiler windows retaken "
          f"{profiling.empty_windows - empty}; launches {paths}", flush=True)
    return paths


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
        from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils.device import (
            card_line,
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
        dense_geometry_phase(pt, dev)
        large_kernel_phase(pt, dev, records)
        gradient_kernel_phase(pt, dev, records)
        slab_kernel_phase(pt, dev, records)
        model_kernel_phase(pt, dev, records)
        refit_cost_phase(pt, dev)
        paths = {"default": sequence_phase(pt, dev)}
        for name in PRESETS:
            paths[name] = preset_sequence_phase(pt, dev, name)
        for path in PATHS:
            paths[path] = large_sequence_phase(pt, dev, path)
        paths.update(suite_phase(dev, " (before the sharded phase)"))
        paths.update(sharded_phase(pt, dev, card))
        paths.update(app_phase(pt, dev, card))
        micro_records, paths["mosaic_micro"] = micro_phase(dev)
        records += micro_records
        paths.update(suite_phase(dev))
        timing_phase(pt, dev, card)
        large_timing_phase(pt, dev, card)
    except (PhaseError, RuntimeError, ValueError, subprocess.SubprocessError) as exc:
        print(f"chip_smoke: failed: {exc}", file=sys.stderr)
        return 1
    for r in records:
        r["launches_by_path"] = {path: counts.get(r["name"], 0) for path, counts in paths.items()
                                 if not r["name"].startswith("micro_") or path == "mosaic_micro"}
        r["launches"] = sum(r["launches_by_path"].values())
        for mode in r["modes"]:
            if "on_path" in mode:  # a mode that is all of the kernel's launches on that path
                path = mode.pop("on_path")
                mode["launches_by_path"] = {path: paths[path].get(r["name"], 0)}
    if not all(r["launches"] > 0 for r in records):
        print("chip_smoke: failed: a kernel was not launched on any main path", file=sys.stderr)
        return 1
    order = ["name", "route", "source", "replaces", "launches", "launches_by_path",
             "max_abs_err", "ms", "ms_is", "call_ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "modes", "ns_per_iter", "plain_ns_per_iter", "iters", "launch_ms",
             "note"]
    order += ["tri_tests", "tests_per_pixel", "survivors_per_pixel", "bound_ms_untiled", "cull_ops",
              "box_tests", "node_rows_read", "tri_rows_read", "committed_tris", "live_rays",
              "lane_eff", "steps_per_ray"]
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils import profiling

    print(f"profiler windows that held no kernel and were taken again: "
          f"{profiling.empty_windows}", flush=True)
    print(json.dumps({"modelled_not_measured_lane_eff_of_earlier_designs": MODELLED}))
    print(json.dumps({"kernels": [{k: r[k] for k in order if k in r} for r in records]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
