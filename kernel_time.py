#!/usr/bin/env python3
"""Device time of kernels of a tree, to compare two trees (one CUDA card).

    python3 kernel_time.py [--tree DIR] [--group atrous|walk|dense|trace] [--count]

Measures the package found in ``DIR`` (default: this script's directory),
with the checks and records of this script's ``chip_smoke.py``, so that an
unpacked copy of another tree (``git archive`` into a listed folder) is
measured by the same code. Two trees are compared in one call, in turns:
parent, this, this, parent.

``--group atrous`` (the default): on the Cornell box's G-buffer with
seeded color and variance, ``atrous_iter`` at 1000x800 (the reference's
frame) and 1920x1080, ``atrous_iter_var`` at 1920x1080 (the presets, path
D) and 512x512 (path E). At each size ``chip_smoke.atrous_modes`` checks the
kernel against its plain version bit for bit at every k = 1..9 and times it
at k = 1, 5 and 9: the median device ms of a launch in a ``torch.profiler``
trace, the plain version's ms and the bound.

``--group walk``: the LBVH walk kernels at 1920x1080 on the orbit camera of
``chip_smoke.py``: ``geometry_bvh`` at path A (32,768 triangles) and path B
(247,808), each plane bit for bit against its plain version;
``geometry_bvh[visibility]`` at 32,768 triangles against
ops/gbuffer.visibility_pass; ``shadow_segment`` on path C's bounce-0 shadow
rays against its plain version; and ``trace_segment`` over one frame's
segments of paths A and B (the mean device ms of a launch, unchecked:
``chip_smoke.py`` checks it). Each line has the median device ms of a
launch, the bound and, for a tree whose LBVH geometry and shadow wrappers
take ``lanes``, the lane efficiency of their walks.

``--group dense``: the dense geometry kernel (``geometry_kernel``) on the
Cornell box at 1000x800 (the default camera; the reference's frame) and at
1920x1080 with the albedo planes (the presets), its visibility-only mode
at 1920x1080, and the kernel at 128 and 288 triangles (subdivided Cornell
boxes, the orbit camera, 1920x1080), where the LBVH kernel takes those
scenes in a frame. Each is checked bit for bit against its plain version,
then timed (the median device ms of a launch); each line has the bound
and, for a tree whose kernel culls per warp tile (its wrappers take
``counts``), the triangle tests and cull survivors a pixel from the
kernel's counting launch, checked against the cull's plain twin.

``--group trace``: the dense trace kernel (``trace_kernel``) on the
Cornell box at 1920x1080 under the orbit camera, in the render modes of
the ``cornell_box_quality`` preset (NEE, 4 spp: the mode whose shadow loop
cuts by plane first), of 1-spp NEE, and of ``cornell_box_interactive`` (no
NEE: the cut bypassed). Each is checked bit for bit against its plain
version, then timed (the median device ms of a launch); each line has the
whole triangle tests a pixel, the lane efficiency, the bound and, for a
tree whose wrapper takes ``shadow``, the shadow loop's cut
(``chip_smoke.trace_counts``). An older tree's wrapper is given a
``shadow`` keyword that it ignores: it has no plane pass to count.

``--count`` prints instead, with no card, the a-trous kernels' edge-weight
evaluations and special-function calls (powf, expf, sqrtf and IEEE
divides) a pixel of the lattice kernels at the tree's tile (``kTX``,
``kTY`` in its ``csrc/atrous.cu``), counted by the kernels' rules, beside
the earlier kernels' 9 evaluations a pixel.

Prints the card's name and power limit, then one JSON line a measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

KS = (1, 5, 9)
SIZES = {"atrous_iter": ((1000, 800), (1920, 1080)),
         "atrous_iter_var": ((1920, 1080), (512, 512))}
SEED = 20261016
PKG = "real_time_path_tracing_with_spatiotemporal_filtering_torch"


def halo_items(k: int, tx: int, ty: int):
    """The halo's weight positions of a tile (``Lattice::halo_item``): the
    lattice row t (-1 .. TY) and the image column's offset from the tile's
    first column, one entry a forward weight the block computes besides
    its own pixels' four."""
    import numpy as np

    m = min(k, tx)
    cols = np.arange(tx)
    left = np.arange(m) - k  # weight columns wc < m lie k to the left
    band = np.where(cols < m, cols - k, cols - m)  # wc in [0, TX)
    rows = [np.full(tx, -1), np.full(tx, -1), np.full(tx, ty)]  # (0,k), (k,k); (k,-k)
    xs = [cols, band, band]
    for lo, hi in ((0, ty), (0, ty - 1), (1, ty)):  # (k,0), (k,k), (k,-k) at -k
        t = np.repeat(np.arange(lo, hi), m)
        rows.append(t)
        xs.append(np.tile(left, hi - lo))
    return np.concatenate(rows), np.concatenate(xs)


def weight_evals(w: int, h: int, k: int, tx: int, ty: int) -> float:
    """Edge-weight evaluations a pixel of the lattice kernels: in each tile
    that starts in the image, four for each of its pixels in the image and
    one for each halo position in the image; then per pixel the centre tap
    and each backward tap whose p - d lies outside the image."""
    import numpy as np

    chunks = -(-(-(-h // k)) // ty)
    halo_t, halo_dx = halo_items(k, tx, ty)
    x0 = np.arange(0, w, tx)
    y0 = np.array([r + c * ty * k for r in range(min(k, h)) for c in range(chunks)])
    y0 = y0[y0 < h]
    hx = x0[:, None] + halo_dx[None, :]  # (strips, halo)
    hy = y0[:, None] + halo_t[None, :] * k  # (row tiles, halo)
    in_x, in_y = ((hx >= 0) & (hx < w)).astype(np.int64), ((hy >= 0) & (hy < h)).astype(np.int64)
    halo = int(np.einsum("sh,rh->", in_x, in_y))  # positions in the image, over all tiles
    ys, xs = np.mgrid[0:h, 0:w]
    left, top, bottom = xs < k, ys < k, ys + k >= h
    direct = int((left | top).sum() + left.sum() + (left | bottom).sum() + top.sum())
    return (4 * w * h + halo + direct) / (w * h) + 1


def count(tree: str) -> None:
    """Print the evaluations and special-function calls a pixel."""
    with open(os.path.join(tree, PKG, "csrc", "atrous.cu")) as f:
        tx, ty = (int(v) for v in re.search(r"kTX = (\d+), kTY = (\d+)", f.read()).groups())
    for name, sizes in SIZES.items():
        for w, h in sizes:
            for k in KS:
                evals = weight_evals(w, h, k, tx, ty)
                # atrous_iter: powf, 2 expf, sqrtf, 2 divides a weight; the
                # variance-guided prefix: powf, expf, a divide, and every
                # tap's w_l an expf and a divide, and one sqrtf a pixel
                calls = 6 * evals if name == "atrous_iter" else 3 * evals + 19
                was = 54 if name == "atrous_iter" else 46
                print(json.dumps(dict(kernel=name, size=f"{w}x{h}", k=k, tile=f"{tx}x{ty}",
                                      weight_evals=evals, special_calls=calls,
                                      was_weight_evals=9, was_special_calls=was)))


def atrous(pt, dev, emit) -> None:
    """The a-trous kernels at k = 1, 5, 9 (``--group atrous``)."""
    import numpy as np
    import torch

    import chip_smoke
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import (
        atrous as at_mod,
        geometry as geo_mod,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline import frame

    # bytes and operations a pixel, as chip_smoke's records count them
    ops = {"atrous_iter": (40, chip_smoke.ATROUS_OPS),
           "atrous_iter_var": (48, chip_smoke.ATROUS_VAR_OPS)}
    for name, sizes in SIZES.items():
        for w, h in sizes:
            cfg = pt.RenderConfig(width=w, height=h)
            td = pt.precompute_triangle_data(pt.Scene.cornell_box(), dev)
            cam, light = pt.Camera.default(dev), pt.Light.default(dev)
            view, proj = frame.camera_matrices(cam, cfg)
            geo = geo_mod.geometry_pass(td, td.lut, cam.position, cam.rotation, light.position,
                                        light.position, light.color, light.color, view, proj,
                                        view, proj, cfg)
            normal, depth = geo.normal, geo.depth
            rng = np.random.default_rng(SEED)
            color = torch.tensor(rng.exponential(0.5, (h, w, 3)).astype(np.float32), device=dev)
            var = torch.tensor((0.1 * rng.random((h, w))).astype(np.float32), device=dev)
            if name == "atrous_iter":
                run = lambda k: at_mod.atrous_iteration(color, normal, depth, k, cfg)
                plain = lambda k: at_mod.atrous_iteration_plain(color, normal, depth, k, cfg)
            else:
                run = lambda k: at_mod.atrous_iteration_var(color, var, normal, depth, k, cfg)
                plain = lambda k: at_mod.atrous_iteration_var_plain(color, var, normal, depth,
                                                                     k, cfg)
            per_px, per_op = ops[name]
            _, modes = chip_smoke.atrous_modes(
                run, plain, name, f"{w}x{h}", cfg.wavelet_iterations,
                chip_smoke.bound(per_px * w * h, per_op * w * h))
            for mode in modes:
                emit(kernel=name, **mode)


def older_wrappers(geo_mod, wf) -> set:
    """Let chip_smoke's helpers drive an older tree: wrap its LBVH geometry
    and shadow wrappers to drop the ``lanes`` and ``width`` keywords they
    lack (a tree before they counted lanes), and, where its dense geometry
    kernel tests every triangle for every pixel (a tree before the tile
    cull, whose ``geometry_pass`` takes no ``counts``), give it the dense
    counts of that kernel: every triangle a pixel, tested and surviving,
    and a tile cull over no tiles. Returns the keywords it supplied or
    dropped."""
    import functools
    import inspect
    import types

    import torch

    older = set()
    for mod, name, keys in ((geo_mod, "geometry_pass_bvh", {"lanes"}),
                            (geo_mod, "visibility_pass", {"lanes"}),
                            (wf, "shadow_segment", {"lanes", "width"})):
        fn = getattr(mod, name)
        drop = keys - set(inspect.signature(fn).parameters)
        if not drop:
            continue

        def shim(*args, _fn=fn, _drop=frozenset(drop), **kwargs):
            return _fn(*args, **{k: v for k, v in kwargs.items() if k not in _drop})

        setattr(mod, name, functools.wraps(fn)(shim))
        older |= drop
    if "counts" in inspect.signature(geo_mod.geometry_pass).parameters:
        return older

    def untiled(tri_data, cfg):
        n = cfg.width * cfg.height
        return torch.full((2, n), tri_data.num_triangles, dtype=torch.int32,
                          device=tri_data.lut.device)

    def counted(fn, cfg_at: int):
        # cfg_at: the position of cfg among the wrapper's arguments
        def shim(*args, counts=None, **kwargs):
            if not isinstance(counts, torch.Tensor):  # the LBVH's WalkCounts, or none
                return fn(*args, **kwargs) if counts is None else fn(*args, counts=counts,
                                                                     **kwargs)
            out = fn(*args, **kwargs)
            counts.copy_(untiled(args[0], args[cfg_at]))
            return out

        return functools.wraps(fn)(shim)

    geo_mod.geometry_pass = counted(geo_mod.geometry_pass, 12)
    geo_mod.visibility_pass = counted(geo_mod.visibility_pass, 4)
    geo_mod.dense_counts = lambda cfg, device: torch.zeros(
        (2, cfg.width * cfg.height), dtype=torch.int32, device=device)
    geo_mod.dense_counts_plain = lambda td, camera_pos, rotation, cfg: untiled(td, cfg)
    ops = sys.modules[geo_mod.__name__.rsplit(".", 2)[0]]
    if not hasattr(ops, "tilecull"):
        ops.tilecull = types.ModuleType(f"{ops.__name__}.tilecull")
        ops.tilecull.tile_grid = lambda cfg: (0, 0)
        sys.modules[ops.tilecull.__name__] = ops.tilecull
    return older | {"counts"}


def walk(pt, dev, emit) -> None:
    """The LBVH walk kernels at 1920x1080 (``--group walk``). For an older
    tree (``older_wrappers``) the lines carry no lane efficiency."""
    import dataclasses

    import torch

    import chip_smoke
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import (
        geometry as geo_mod,
        wavefront as wf,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import procedural

    if "lanes" in older_wrappers(geo_mod, wf):
        emit_all = emit

        def emit(**line):
            line.pop("lane_eff", None)
            emit_all(**line)

    w, h = chip_smoke.BENCH_SIZE
    scenes = {s: pt.precompute_triangle_data(
        pt.Scene.from_arrays(*procedural.subdivided_cornell(s)), dev) for s in (32, 88)}
    base = pt.RenderConfig(width=w, height=h)
    paths = {"A": (scenes[32], dataclasses.replace(base, **chip_smoke.LARGE["A"][1])),
             "B": (scenes[88], base)}
    cam, light = chip_smoke.orbit(pt, 3, dev), pt.Light.default(dev)
    for path, (td, cfg) in paths.items():
        mode = f"path {path}, {td.num_triangles} tris, {w}x{h}"
        args = chip_smoke.stress_geo_args(pt, td, cfg, dev)
        k = geo_mod.geometry_pass_bvh(*args, emit_albedo=True)
        p = geo_mod.geometry_pass_plain(*args, emit_albedo=True)
        err = max(chip_smoke.same_bits(f"geometry_bvh {name} {mode}", getattr(k, name).float(),
                                       getattr(p, name).float()) for name in k._fields)
        emit(kernel="geometry_bvh", mode=mode, max_abs_err=err,
             **chip_smoke.kernel_ms(lambda: geo_mod.geometry_pass_bvh(*args),
                                    "geometry_bvh_kernel"),
             **chip_smoke.geometry_bvh_bound(geo_mod, args, td, cfg))
    vis = chip_smoke.visibility_mode(pt, geo_mod, scenes[32], base, cam, dev,
                                     "32768 tris, LBVH kernel")
    vis.pop("launches_by_path")
    emit(kernel="geometry_bvh[visibility]", **vis)
    td, path_c = scenes[32], dataclasses.replace(base, **chip_smoke.LARGE["C"][1])
    rays = chip_smoke.path_c_shadow_rays(pt, geo_mod, td, path_c, cam, light, dev)
    err = chip_smoke.same_bits(f"shadow_segment path C {w}x{h}",
                               wf.shadow_segment(*rays, td, path_c, width=path_c.width),
                               wf.shadow_segment_plain(*rays, td, path_c))
    emit(kernel="shadow_segment", mode=f"path C's bounce-0 shadow rays, {w}x{h}",
         max_abs_err=err, sampling_lanes=int(rays[3].sum().item()),
         **chip_smoke.shadow_segment_fields(wf, geo_mod, td, path_c, rays))
    for path, (td, cfg) in paths.items():
        launch = chip_smoke.kernel_ms(
            lambda: chip_smoke.frame_segments(wf, td, cfg, cam, light, 5),
            "trace_segment_kernel", 3, warmup=1, mean=True)
        emit(kernel="trace_segment", mode=f"path {path}, {td.num_triangles} tris, {w}x{h}, the "
                                          "mean of a frame's launches", **launch)
        torch.cuda.synchronize()


def dense(pt, dev, emit) -> None:
    """The dense geometry kernel in both modes (``--group dense``). For an
    older tree (``older_wrappers``) the lines carry no survivors."""
    import torch

    import chip_smoke
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import (
        geometry as geo_mod,
        wavefront as wf,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import procedural

    if "counts" in older_wrappers(geo_mod, wf):
        emit_all = emit

        def emit(**line):
            line.pop("survivors_per_pixel", None)
            emit_all(**line)

    poses = chip_smoke.dense_poses(pt, dev)
    cornell = pt.precompute_triangle_data(pt.Scene.cornell_box(), dev)
    w, h = chip_smoke.BENCH_SIZE
    cases = [(f"Cornell box, default camera, {cw}x{ch}{', albedo planes' if albedo else ''}",
              cornell, pt.RenderConfig(width=cw, height=ch), poses["default"], albedo)
             for (cw, ch), albedo in (((1000, 800), False), ((w, h), True))]
    for splits in (2, 3):
        td = pt.precompute_triangle_data(
            pt.Scene.from_arrays(*procedural.subdivided_cornell(splits)), dev)
        cases.append((f"{td.num_triangles} tris, orbit camera, {w}x{h}", td,
                      pt.RenderConfig(width=w, height=h), poses["orbit"], False))
    for label, td, cfg, cams, albedo in cases:
        args = chip_smoke.dense_geometry_args(pt, td, cfg, cams, dev)
        k = geo_mod.geometry_pass(*args, emit_albedo=albedo)
        t0 = time.perf_counter()
        p = geo_mod.geometry_pass_plain(*args, emit_albedo=albedo)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        err = max(chip_smoke.same_bits(f"geometry {name} {label}", getattr(k, name).float(),
                                       getattr(p, name).float())
                  for name in p._fields if getattr(p, name) is not None)
        emit(kernel="geometry", mode=label, max_abs_err=err, plain_ms=plain_ms,
             **chip_smoke.kernel_ms(lambda: geo_mod.geometry_pass(*args, emit_albedo=albedo),
                                    "geometry_kernel"),
             **chip_smoke.dense_geometry_fields(geo_mod, args, cfg, albedo=albedo))
        torch.cuda.synchronize()
    vis = chip_smoke.visibility_mode(pt, geo_mod, cornell, pt.RenderConfig(width=w, height=h),
                                     poses["default"][0], dev, "Cornell box, dense kernel")
    vis.pop("launches_by_path")
    emit(kernel="geometry[visibility]", **vis)


def trace(pt, dev, emit) -> None:
    """The dense trace kernel in three render modes (``--group trace``)."""
    import dataclasses
    import functools
    import inspect

    import chip_smoke
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.models import presets
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import (
        pathtrace as pt_mod,
    )

    if "shadow" not in inspect.signature(pt_mod.path_trace_pass).parameters:
        # a tree before the shadow loop's plane pass: its counts stay 0
        fn = pt_mod.path_trace_pass
        pt_mod.path_trace_pass = functools.wraps(fn)(
            lambda *args, shadow=None, **kwargs: fn(*args, **kwargs))
        emit_all = emit

        def emit(**line):
            line.pop("shadow_cut")
            emit_all(**line)

    w, h = chip_smoke.BENCH_SIZE
    td = pt.precompute_triangle_data(pt.Scene.cornell_box(), dev)
    cam, light = chip_smoke.orbit(pt, 3, dev), pt.Light.default(dev)
    quality, interactive = (
        dataclasses.replace(preset(device="cpu", width=16, height=16).cfg, width=w, height=h)
        for preset in (presets.cornell_box_quality, presets.cornell_box_interactive))
    modes = {"cornell_box_quality": quality, "nee, 1 spp": dataclasses.replace(quality, spp=1),
             "cornell_box_interactive": interactive}
    for name, cfg in modes.items():
        label = f"{name} (nee={cfg.nee}, spp={cfg.spp}, rr={cfg.rr_start_bounce}), {w}x{h}"
        args = (td, cam.position, light, 5, cfg, cam.rotation)
        err = chip_smoke.same_bits(f"trace {label}", pt_mod.path_trace_pass(*args),
                                   pt_mod.path_trace_pass_plain(*args[:5], rotation=cam.rotation))
        tests, _ = chip_smoke.trace_tests(pt_mod, td, cam, light, 5, cfg)
        emit(kernel="trace", mode=label, max_abs_err=err,
             **chip_smoke.kernel_ms(lambda: pt_mod.path_trace_pass(*args), "trace_kernel"),
             tests_per_pixel=tests / (w * h),
             **chip_smoke.trace_counts(pt_mod, td, cam, light, 5, cfg, label),
             **chip_smoke.trace_bound(pt_mod, td, cam, light, 5, cfg))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)))
    parser.add_argument("--group", choices=("atrous", "walk", "dense", "trace"),
                        default="atrous")
    parser.add_argument("--count", action="store_true")
    args = parser.parse_args()
    if args.count:
        count(args.tree)
        return 0
    # this script's chip_smoke, before the tree goes on the path: the
    # package it then imports is the tree's
    import chip_smoke

    sys.path.insert(0, os.path.abspath(args.tree))

    import torch

    if not torch.cuda.is_available():
        print("kernel_time: no CUDA device", file=sys.stderr)
        return 1
    import real_time_path_tracing_with_spatiotemporal_filtering_torch as pt
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import _build
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils.device import card_line

    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    _build.library()
    tree = os.path.abspath(args.tree)

    def emit(**line):
        print(json.dumps(dict(tree=tree, card=card, **line)), flush=True)

    try:
        {"atrous": atrous, "walk": walk, "dense": dense, "trace": trace}[args.group](pt, dev,
                                                                                   emit)
    except chip_smoke.PhaseError as e:
        print(f"kernel_time: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
