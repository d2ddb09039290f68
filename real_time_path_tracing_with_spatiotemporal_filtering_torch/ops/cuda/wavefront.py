"""Segment tracer: the path tracer for large scenes, G-buffer seeds and
explicit pixel lists.

:func:`trace_pixels_wavefront` is the host loop (the JAX package's
``_wavefront_core`` and ``trace_pixels_wavefront``, ops/pallas/wavefront.py
there) over a list of global pixels; :func:`path_trace_wavefront` is its
call over the whole frame. For each batch and each sample in turn it runs
``max_bounces`` segments over one set of flat ray arrays
(:class:`RayState`), then adds each path's radiance with the fall-through /
NEE / truncate_radiance rule, and averages as ops/pathtrace.trace_pixels
does ((sum / spp) per batch, then / batches), so its image equals the
one-launch tracer's bit for bit. Under cfg.gbuffer_primary bounce 0 is
replayed off the G-buffer in PyTorch (ops/pathtrace.primary_carry) and its
NEE shadow rays go through :func:`shadow_segment`; the segments then run
from 1. Seeds are those of the global pixels, so a list of pixels traces
what those pixels of a full frame would. A row slab of the frame (the
row-sharded frame of parallel/: ``row_offset``, ``rows``) is traced in
frame order from its first global row, which the segment kernel is given;
its ray state and live lists hold rows x width rays.

:func:`trace_segment` and :func:`shadow_segment` launch the kernels of
``csrc/wavefront.cu`` for tensors on a CUDA device and run their plain
PyTorch versions for tensors on the CPU. Every segment is launched and
nothing is read back to the host, so a frame's launch count is fixed.
Every launch writes the list of the rays that go on (:class:`LiveLists`).
The first launch of a path runs every ray slot; each later one runs only
the rays still alive, from the list the launch before wrote.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import (
    camera as cam_ops,
    intersect,
    pathtrace,
    rng as rng_ops,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import _build
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda.geometry import (
    check_bvh,
    count_pointers,
    lane_pointer,
    slab,
)


class RayState(NamedTuple):
    """One path per pixel between segments, structure of arrays."""

    f: torch.Tensor      # (12, N) float32: origin, direction, throughput, result (x, y, z)
    state: torch.Tensor  # (N,) int32 holding the uint32 PCG state
    alive: torch.Tensor  # (N,) int32, 1 while the path goes on

    @classmethod
    def empty(cls, n: int, device) -> "RayState":
        return cls(
            f=torch.empty((12, n), dtype=torch.float32, device=device),
            state=torch.empty(n, dtype=torch.int32, device=device),
            alive=torch.empty(n, dtype=torch.int32, device=device),
        )

    def store(self, o, d, accum, result, state, alive) -> None:
        """Write (N, 3) origin/direction/throughput/result, int64 states and
        the bool alive flags into the arrays."""
        self.f.copy_(torch.cat([o.T, d.T, accum.T, result.T]))
        self.state.copy_(rng_ops.to_int32_bits(state))
        self.alive.copy_(alive.to(torch.int32))


class LiveLists:
    """The live-ray lists of the segment kernel, for launches over up to
    ``capacity`` ray slots: three rotating int32 lists, each with two int32
    counters (slots listed, slots fetched). Launch j reads list j % 3,
    appends the rays that go on to list (j + 1) % 3 and zeroes the counters
    of list (j + 2) % 3, so the counters are zeroed once, here, and never by
    a launch of their own. The launches that use one LiveLists must run in
    order on one stream."""

    def __init__(self, capacity: int, device):
        self.capacity = capacity
        self.slots = torch.empty((3, capacity), dtype=torch.int32, device=device)
        self.counters = torch.zeros((3, 2), dtype=torch.int32, device=device)
        self._slot_ptrs = [self.slots[k].data_ptr() for k in range(3)]
        self._ctr_ptrs = [self.counters[k].data_ptr() for k in range(3)]
        self._launch = 0

    def pointers(self, first: bool) -> tuple:
        """The five list pointers of the next launch: the list read (None
        for the ``first`` launch of a path: every slot) and its counters,
        the list written and its counters, the counters zeroed. The launch
        is then taken as made."""
        j = self._launch
        read, write, zero = j, (j + 1) % 3, (j + 2) % 3
        self._launch = write
        return (None if first else self._slot_ptrs[read], self._ctr_ptrs[read],
                self._slot_ptrs[write], self._ctr_ptrs[write], self._ctr_ptrs[zero])

    def last_list(self) -> torch.Tensor:
        """The slots the last launch listed, in listed order (reads the
        count back to the host; for checks)."""
        k = self._launch
        return self.slots[k, : int(self.counters[k, 0].item())]


_LIVE_LISTS: dict = {}


def live_lists(n: int, device) -> LiveLists:
    """The LiveLists of the current stream of ``device``, with room for
    ``n`` slots. One per stream, reused from frame to frame and replaced by
    a larger one when ``n`` outgrows it: its counters are zeroed when it is
    made, and a frame adds no launch to zero them."""
    device = torch.device(device)
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    lists = _LIVE_LISTS.get(key)
    if lists is None or lists.capacity < n:
        lists = _LIVE_LISTS[key] = LiveLists(n, device)
    return lists


def _pixels(n: int, width: int, device, pixels=None, row_offset: int = 0):
    """The rays' global (px, py): ``pixels`` when given, else ray i at
    pixel (i % width, row_offset + i // width) of the frame."""
    if pixels is not None:
        return pixels
    idx = torch.arange(n, device=device)
    return idx % width, torch.div(idx, width, rounding_mode="floor") + row_offset


def trace_segment_plain(rays: RayState, seg, batch, sample, tri_data, camera_pos, rotation,
                        light, frame_idx, cfg, pixels=None, row_offset: int = 0) -> None:
    """The plain version of one segment: ops/pathtrace.bounce_step over the
    flat arrays, with ops/intersect.scene_nearest_hit; segment 0 first
    generates the camera rays as ops/pathtrace.trace_pixels does."""
    n = rays.alive.shape[0]
    if seg == 0:
        px, py = _pixels(n, cfg.width, rays.f.device, pixels, row_offset)
        state, gx, gy = rng_ops.sample_jitter(px, py, frame_idx, batch, sample)
        d = cam_ops.pixel_rays(px, py, cfg.width, cfg.height, cfg.fov,
                               jitter_x=cfg.aa_sigma * gx, jitter_y=cfg.aa_sigma * gy,
                               rotation=rotation)
        o = camera_pos.expand(n, 3)
        accum, result = torch.ones_like(d), torch.zeros_like(d)
        alive = torch.ones(n, dtype=torch.bool, device=d.device)
    else:
        f = rays.f.T
        o, d, accum, result = f[:, 0:3], f[:, 3:6], f[:, 6:9], f[:, 9:12]
        state = rng_ops.from_int32_bits(rays.state)
        alive = rays.alive != 0
    rec = intersect.scene_nearest_hit(tri_data, o, d, t_max=cfg.t_max, eps=cfg.intersect_eps,
                                      mask=alive)
    carry = pathtrace.bounce_step(
        seg, o, d, accum, result, alive, state, rec.hit, rec.t,
        intersect.hit_position(tri_data.planes, rec), tri_data.normals[rec.prim],
        tri_data.albedo[rec.prim], light.position, light.color * cfg.light_intensity, cfg,
        tri_data=tri_data,
    )
    o, d, accum, result, alive, state = carry
    rays.store(o, d, accum, result, state, alive)


class SegmentLaunches:
    """The segment kernel's launches over one :class:`RayState`: what stays
    the same from launch to launch (the scene, camera, light, frame, config,
    pixels, counters and the rays' arrays) is checked and converted once,
    here, so that each launch costs the host only its own arguments. The
    arguments are those of :func:`trace_segment`; the arrays must keep
    their storage while the launches run (the host loop writes the rays in
    place)."""

    def __init__(self, rays: RayState, tri_data, camera_pos, rotation, light, frame_idx, cfg,
                 counts=None, pixels=None, lanes=None, lists=None, row_offset: int = 0):
        n = rays.alive.shape[0]
        _build.check_cuda("rays.f", rays.f, torch.float32, (12, n))
        _build.check_cuda("rays.state", rays.state, torch.int32, (n,))
        _build.check_cuda("rays.alive", rays.alive, torch.int32, (n,))
        count_ptrs = count_pointers(counts, n, tri_data)
        lane_ptr = lane_pointer(lanes, counts)
        if lists is None:
            lists = live_lists(n, rays.f.device)
        elif lists.capacity < n:
            raise ValueError(f"live lists of {lists.capacity} slots for {n} rays")
        self.lists = lists
        if pixels is None:
            if n % cfg.width or row_offset < 0 or row_offset + n // cfg.width > cfg.height:
                raise ValueError(f"{n} rays from row {row_offset} are not rows of a "
                                 f"{cfg.width}x{cfg.height} frame")
            pixel_ptrs = (None, None)
        else:
            for name, t in zip(("px", "py"), pixels):
                _build.check_cuda(name, t, torch.int32, (n,))
            pixel_ptrs = tuple(t.data_ptr() for t in pixels)
        check_bvh(tri_data)
        self._params = torch.cat([
            camera_pos.reshape(3), rotation.reshape(9), light.position.reshape(3),
            (light.color * cfg.light_intensity).reshape(3),
        ]).contiguous()
        _build.check_cuda("params", self._params, torch.float32, (18,))
        planes = tri_data.planes

        def f32(x) -> float:
            return float(np.float32(x))

        self._head = (
            tri_data.bvh.nodes.data_ptr(), tri_data.bvh.tris.data_ptr(),
            planes.v0.data_ptr(), planes.e1.data_ptr(), planes.e2.data_ptr(),
            tri_data.normals.data_ptr(), tri_data.albedo.data_ptr(), self._params.data_ptr(),
            n, cfg.width, cfg.height, int(row_offset), int(frame_idx),
        )
        self._mid = (
            cam_ops.fov_slope(cfg.fov),
            f32(cfg.aa_sigma),
            f32(cfg.ray_offset_eps),
            f32(cfg.t_max),
            f32(cfg.intersect_eps),
            f32(cfg.light_radius),
            # Python squares the radius in double, then the float32 op rounds
            f32(cfg.light_radius * cfg.light_radius),
            f32(1.0 / cfg.first_hit_light_dim),
            int(cfg.light_through_walls),
            int(cfg.nee),
            int(cfg.rr_start_bounce),
            f32(cfg.rr_min_prob),
            f32(cfg.rr_max_prob),
            *pixel_ptrs,
        )
        self._tail = (
            rays.f.data_ptr(), rays.state.data_ptr(), rays.alive.data_ptr(),
            *count_ptrs, lane_ptr,
        )

    def __call__(self, seg: int, batch: int, sample: int, first: bool) -> None:
        """Launch segment ``seg`` of sample ``sample`` of batch ``batch``
        (``first`` as in :func:`trace_segment`)."""
        _build.launch("ptsf_trace_segment", *self._head, batch, sample, seg, *self._mid,
                      *self.lists.pointers(first), *self._tail)


def trace_segment(rays: RayState, seg, batch, sample, tri_data, camera_pos, rotation, light,
                  frame_idx, cfg, counts=None, pixels=None, first=True, lists=None,
                  lanes=None, row_offset: int = 0) -> None:
    """Segment ``seg`` of sample ``sample`` of batch ``batch``, in place on
    ``rays`` (plain version for CPU tensors). ``pixels``: the rays' global
    (px, py), two int32 (N,) tensors; None for whole rows of the frame from
    global row ``row_offset`` on, ray i at pixel (i % W, row_offset +
    i // W). ``first``: the launch starts a path and runs
    every ray slot (at a segment after 0, those whose alive flag is set);
    else it runs the rays the launch before on ``lists`` listed, which must
    have been segment ``seg - 1`` of these rays. Either way it lists the
    rays that go on. ``lists``: a :class:`LiveLists` (None: those of the
    current stream, :func:`live_lists`). ``counts``: optional
    ops/cuda/geometry.WalkCounts of N rays, to which each ray's triangle
    tests and box tests are added and in which the rows read are marked,
    for counting the work of a frame; with it, ``lanes`` ((4,) int64,
    optional) accumulates the lane efficiency: lanes that ran a ray and
    warp steps of the kernel's loop over rays, lanes that ran a walk step
    and warp steps of the walks. A loop over segments makes one
    :class:`SegmentLaunches` instead."""
    if rays.f.device.type == "cpu":
        trace_segment_plain(rays, seg, batch, sample, tri_data, camera_pos, rotation, light,
                            frame_idx, cfg, pixels, row_offset)
        return
    SegmentLaunches(rays, tri_data, camera_pos, rotation, light, frame_idx, cfg, counts, pixels,
                    lanes, lists, row_offset)(seg, batch, sample, first)


def shadow_segment_plain(origins, dirs, cap, mask, tri_data, cfg) -> torch.Tensor:
    """The plain version: ops/intersect.any_hit_within over the lanes in
    ``mask``."""
    return intersect.any_hit_within(tri_data.bvh, origins, dirs, cap, t_max=cfg.t_max,
                               eps=cfg.intersect_eps, mask=mask)


def shadow_segment(origins, dirs, cap, mask, tri_data, cfg, counts=None, lanes=None,
                   width=None) -> torch.Tensor:
    """Whether each shadow ray of ``mask`` meets a triangle at t <= ``cap``
    (origins/dirs (N, 3) float32, cap (N,) float32, mask (N,) bool, all
    contiguous and read in place; False outside the mask). One kernel
    launch; plain version for CPU tensors. ``width``: the rays are a
    frame's pixels in raster order, ``width`` to a row (the kernel then
    walks them 8x4 pixels a warp); None: any order. ``counts`` as in
    :func:`trace_segment`; with it, ``lanes`` (optional) accumulates the
    lane counts (ops/cuda/geometry.lane_pointer): lanes of the mask and
    warps, then the walk's lanes and steps."""
    if origins.device.type == "cpu":
        return shadow_segment_plain(origins, dirs, cap, mask, tri_data, cfg)
    n = mask.shape[0]
    for name, t, dtype, shape in (("origins", origins, torch.float32, (n, 3)),
                                  ("dirs", dirs, torch.float32, (n, 3)),
                                  ("cap", cap, torch.float32, (n,)),
                                  ("mask", mask, torch.bool, (n,))):
        _build.check_cuda(name, t, dtype, shape)
    if width is not None and (width <= 0 or n % width):
        raise ValueError(f"{n} rays are not rows of {width}")
    count_ptrs = count_pointers(counts, n, tri_data)
    check_bvh(tri_data)
    occluded = torch.empty(n, dtype=torch.int32, device=origins.device)
    _build.launch(
        "ptsf_shadow_segment",
        tri_data.bvh.nodes.data_ptr(), tri_data.bvh.tris.data_ptr(),
        origins.data_ptr(), dirs.data_ptr(), cap.data_ptr(), mask.data_ptr(), n, width or 0,
        float(np.float32(cfg.t_max)), float(np.float32(cfg.intersect_eps)),
        occluded.data_ptr(), *count_ptrs, lane_pointer(lanes, counts),
    )
    return occluded != 0


def _seed_from_gbuffer(rays: RayState, primary, batch, sample, tri_data, camera_pos, rotation,
                       light, frame_idx, cfg, counts, pixels=None, row_offset: int = 0) -> None:
    """Bounce 0 off the G-buffer (cfg.gbuffer_primary): the center rays,
    ops/pathtrace.primary_carry with the NEE shadow test deferred to
    :func:`shadow_segment`, written into ``rays``. ``primary`` holds the
    G-buffer planes at the rays' pixels (``pixels`` as in
    :func:`trace_segment`)."""
    n = rays.alive.shape[0]
    px, py = _pixels(n, cfg.width, rays.f.device, pixels, row_offset)
    state, gx, gy = rng_ops.sample_jitter(px, py, frame_idx, batch, sample)
    # no primary jitter; its draws still advance the stream
    dirs = cam_ops.pixel_rays(px, py, cfg.width, cfg.height, cfg.fov,
                              jitter_x=0.0 * gx, jitter_y=0.0 * gy, rotation=rotation)
    vis, world_pos, n_geo, albedo = (p.reshape(n, -1).squeeze(-1) for p in primary)
    carry = pathtrace.primary_carry(
        camera_pos.expand(n, 3), dirs, state, vis, world_pos, n_geo, albedo,
        light.position, light.color * cfg.light_intensity, cfg, defer_nee_shadow=cfg.nee,
    )
    o, d, accum, result, alive, state = carry[:6]
    if cfg.nee:
        w_l, s_t, bank, mask = carry[6]
        cap = torch.where(mask, s_t, torch.zeros_like(s_t))
        lit = mask & ~shadow_segment(o, w_l, cap, mask, tri_data, cfg, counts,
                                     width=cfg.width if pixels is None else None)
        result = result + torch.where(lit[:, None], bank, torch.zeros_like(bank))
    rays.store(o, d, accum, result, state, alive)


def path_radiance(rays: RayState, cfg) -> torch.Tensor:
    """(3, N) radiance of the paths after the last segment: the loop
    fall-through returns a surviving path's bare throughput, unless NEE or
    truncate_radiance drops it (ops/pathtrace.trace_paths)."""
    f = rays.f
    if cfg.nee or cfg.truncate_radiance:
        return f[9:12].clone()
    return torch.where((rays.alive != 0)[None], f[6:9], f[9:12])


def _trace_rays(tri_data, camera_pos, light, frame_idx, cfg, rotation, n, pixels, primary,
                emit_throughput, counts, row_offset: int = 0):
    """The host loop over ``n`` rays at ``pixels`` (None: whole rows of the
    frame from global row ``row_offset`` on); returns (3, N) radiance, and
    the (3, N) throughput with ``emit_throughput``."""
    dev = camera_pos.device
    rays = RayState.empty(n, dev)
    if dev.type == "cuda":
        segment = SegmentLaunches(rays, tri_data, camera_pos, rotation, light, frame_idx, cfg,
                                  counts, pixels, row_offset=row_offset)
    else:
        def segment(seg, batch, sample, first):
            trace_segment_plain(rays, seg, batch, sample, tri_data, camera_pos, rotation, light,
                                frame_idx, cfg, pixels, row_offset)
    start = 0 if primary is None else 1
    total = torch.zeros((3, n), dtype=torch.float32, device=dev)
    thru_total = torch.zeros_like(total)
    for batch in range(cfg.sample_batches):
        summed = torch.zeros_like(total)
        thru_sum = torch.zeros_like(total)
        for sample in range(cfg.spp):
            if primary is not None:
                _seed_from_gbuffer(rays, primary, batch, sample, tri_data, camera_pos, rotation,
                                   light, frame_idx, cfg, counts, pixels, row_offset)
            for seg in range(start, cfg.max_bounces):
                segment(seg, batch, sample, seg == start)
            summed = summed + path_radiance(rays, cfg)
            if emit_throughput:
                thru_sum = thru_sum + path_throughput(rays)
        total = total + cam_ops.true_div(summed, float(cfg.spp))
        thru_total = thru_total + cam_ops.true_div(thru_sum, float(cfg.spp))
    out = cam_ops.true_div(total, float(cfg.sample_batches))
    if emit_throughput:
        return out, cam_ops.true_div(thru_total, float(cfg.sample_batches))
    return out


def path_throughput(rays: RayState) -> torch.Tensor:
    """(3, N) path throughput after the last segment: the throughput where
    the path goes on, 0 where it ended (ops/pathtrace.trace_paths)."""
    f = rays.f
    return torch.where((rays.alive != 0)[None], f[6:9], torch.zeros_like(f[6:9]))


def trace_pixels_wavefront(tri_data, camera_pos, light, frame_idx, px, py, cfg, rotation,
                           primary=None, emit_throughput=False, counts=None):
    """Noisy radiance of the global pixels (``px``, ``py``), integer
    tensors of one shape, by segments: ``px.shape + (3,)``, and the
    truncation-point throughput of the same shape with ``emit_throughput``
    (ops/pathtrace.trace_pixels' signature and values). ``primary``: the
    G-buffer planes (vis, world_pos, normal, albedo) at those pixels, for
    cfg.gbuffer_primary. ``counts``: optional ops/cuda/geometry.WalkCounts
    of N = px.numel() rays that accumulates the work of every launch."""
    if px.shape != py.shape:
        raise ValueError(f"pixel lists of shapes {tuple(px.shape)} and {tuple(py.shape)}")
    shape = tuple(px.shape)
    pixels = tuple(t.reshape(-1).to(torch.int32).contiguous() for t in (px, py))
    n = pixels[0].numel()
    traced = _trace_rays(tri_data, camera_pos, light, frame_idx, cfg, rotation, n, pixels,
                         primary, emit_throughput, counts)
    if emit_throughput:
        return tuple(t.T.reshape(*shape, 3) for t in traced)
    return traced.T.reshape(*shape, 3)


def path_trace_wavefront(tri_data, camera_pos, light, frame_idx, cfg, rotation,
                         primary=None, emit_throughput=False, counts=None,
                         row_offset: int = 0, rows: int | None = None):
    """Noisy radiance (H, W, 3) of one frame by segments (module
    docstring), and the (H, W, 3) truncation-point throughput with
    ``emit_throughput``. ``primary``: the G-buffer planes (vis, world_pos,
    normal, albedo) of cfg.gbuffer_primary. ``counts``: optional
    ops/cuda/geometry.WalkCounts of H*W rays that accumulates the work of
    every segment and shadow launch. ``row_offset``/``rows``: the slab of
    ``rows`` rows from global row ``row_offset`` on, (rows, W, 3), with
    ``primary`` and ``counts`` the slab's."""
    h = slab(cfg, row_offset, rows)
    n = cfg.width * h
    traced = _trace_rays(tri_data, camera_pos, light, frame_idx, cfg, rotation, n, None,
                         primary, emit_throughput, counts, row_offset)
    if emit_throughput:
        return tuple(t.T.contiguous().view(h, cfg.width, 3) for t in traced)
    return traced.T.contiguous().view(h, cfg.width, 3)
