"""Segment tracer: the path tracer for large scenes and G-buffer seeds.

:func:`path_trace_wavefront` is the host loop (the JAX package's
``_wavefront_core``, ops/pallas/wavefront.py there): for each batch and
each sample in turn it runs ``max_bounces`` segments over one set of flat
ray arrays (:class:`RayState`), then adds each path's radiance with the
fall-through / NEE / truncate_radiance rule, and averages as
ops/pathtrace.trace_pixels does ((sum / spp) per batch, then / batches), so
its image equals the one-launch tracer's bit for bit. Under
cfg.gbuffer_primary bounce 0 is replayed off the G-buffer in PyTorch
(ops/pathtrace.primary_carry) and its NEE shadow rays go through
:func:`shadow_segment`; the segments then run from 1.

:func:`trace_segment` and :func:`shadow_segment` launch the kernels of
``csrc/wavefront.cu`` for tensors on a CUDA device and run their plain
PyTorch versions for tensors on the CPU. Every segment is launched, dead
rays return at once, and nothing is read back to the host, so a frame's
launch count is fixed.
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


def _pixels(n: int, width: int, device):
    idx = torch.arange(n, device=device)
    return idx % width, torch.div(idx, width, rounding_mode="floor")


def trace_segment_plain(rays: RayState, seg, batch, sample, tri_data, camera_pos, rotation,
                        light, frame_idx, cfg) -> None:
    """The plain version of one segment: ops/pathtrace.bounce_step over the
    flat arrays, with ops/intersect.scene_nearest_hit; segment 0 first
    generates the camera rays as ops/pathtrace.trace_pixels does."""
    n = rays.alive.shape[0]
    if seg == 0:
        px, py = _pixels(n, cfg.width, rays.f.device)
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


def trace_segment(rays: RayState, seg, batch, sample, tri_data, camera_pos, rotation, light,
                  frame_idx, cfg, counts=None) -> None:
    """Segment ``seg`` of sample ``sample`` of batch ``batch``, in place on
    ``rays`` (plain version for CPU tensors). ``counts``: optional
    ops/cuda/geometry.WalkCounts of N rays, to which each ray's triangle
    tests and box tests are added and in which the rows read are marked,
    for counting the work of a frame."""
    if rays.f.device.type == "cpu":
        trace_segment_plain(rays, seg, batch, sample, tri_data, camera_pos, rotation, light,
                            frame_idx, cfg)
        return
    n = rays.alive.shape[0]
    _build.check_cuda("rays.f", rays.f, torch.float32, (12, n))
    _build.check_cuda("rays.state", rays.state, torch.int32, (n,))
    _build.check_cuda("rays.alive", rays.alive, torch.int32, (n,))
    count_ptrs = count_pointers(counts, n, tri_data)
    if n != cfg.width * cfg.height:
        raise ValueError(f"{n} rays for a {cfg.width}x{cfg.height} frame")
    check_bvh(tri_data)
    params = torch.cat([
        camera_pos.reshape(3), rotation.reshape(9), light.position.reshape(3),
        (light.color * cfg.light_intensity).reshape(3),
    ]).contiguous()
    _build.check_cuda("params", params, torch.float32, (18,))
    planes = tri_data.planes

    def f32(x) -> float:
        return float(np.float32(x))

    _build.launch(
        "ptsf_trace_segment",
        tri_data.bvh.nodes.data_ptr(), tri_data.bvh.tris.data_ptr(),
        planes.v0.data_ptr(), planes.e1.data_ptr(), planes.e2.data_ptr(),
        tri_data.normals.data_ptr(), tri_data.albedo.data_ptr(), params.data_ptr(),
        n, cfg.width, cfg.height, int(frame_idx), batch, sample, seg,
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
        rays.f.data_ptr(), rays.state.data_ptr(), rays.alive.data_ptr(),
        *count_ptrs,
    )


def shadow_segment_plain(origins, dirs, cap, mask, tri_data, cfg) -> torch.Tensor:
    """The plain version: ops/intersect.any_hit_within over the lanes in
    ``mask``."""
    return intersect.any_hit_within(tri_data.bvh, origins, dirs, cap, t_max=cfg.t_max,
                               eps=cfg.intersect_eps, mask=mask)


def shadow_segment(origins, dirs, cap, mask, tri_data, cfg, counts=None) -> torch.Tensor:
    """Whether each shadow ray of ``mask`` meets a triangle at t <= ``cap``
    (origins/dirs (N, 3), cap (N,), mask (N,) bool; False outside the
    mask). One kernel launch; plain version for CPU tensors. ``counts`` as
    in :func:`trace_segment`."""
    if origins.device.type == "cpu":
        return shadow_segment_plain(origins, dirs, cap, mask, tri_data, cfg)
    n = mask.shape[0]
    planes = torch.cat([origins.T, dirs.T, cap[None]]).contiguous()
    mask_i = mask.to(torch.int32).contiguous()
    _build.check_cuda("planes", planes, torch.float32, (7, n))
    _build.check_cuda("mask", mask_i, torch.int32, (n,))
    count_ptrs = count_pointers(counts, n, tri_data)
    check_bvh(tri_data)
    occluded = torch.empty(n, dtype=torch.int32, device=origins.device)
    _build.launch(
        "ptsf_shadow_segment",
        tri_data.bvh.nodes.data_ptr(), tri_data.bvh.tris.data_ptr(),
        planes.data_ptr(), mask_i.data_ptr(), n,
        float(np.float32(cfg.t_max)), float(np.float32(cfg.intersect_eps)),
        occluded.data_ptr(), *count_ptrs,
    )
    return occluded != 0


def _seed_from_gbuffer(rays: RayState, primary, batch, sample, tri_data, camera_pos, rotation,
                       light, frame_idx, cfg, counts) -> None:
    """Bounce 0 off the G-buffer (cfg.gbuffer_primary): the center rays,
    ops/pathtrace.primary_carry with the NEE shadow test deferred to
    :func:`shadow_segment`, written into ``rays``."""
    n = rays.alive.shape[0]
    px, py = _pixels(n, cfg.width, rays.f.device)
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
        lit = mask & ~shadow_segment(o, w_l, cap, mask, tri_data, cfg, counts)
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


def path_trace_wavefront(tri_data, camera_pos, light, frame_idx, cfg, rotation,
                         primary=None, counts=None) -> torch.Tensor:
    """Noisy radiance (H, W, 3) of one frame by segments (module
    docstring). ``primary``: the G-buffer planes (vis, world_pos, normal,
    albedo) of cfg.gbuffer_primary. ``counts``: optional
    ops/cuda/geometry.WalkCounts of H*W rays that accumulates the work of
    every segment and shadow launch."""
    n = cfg.width * cfg.height
    dev = camera_pos.device
    rays = RayState.empty(n, dev)
    start = 0 if primary is None else 1
    total = torch.zeros((3, n), dtype=torch.float32, device=dev)
    for batch in range(cfg.sample_batches):
        summed = torch.zeros_like(total)
        for sample in range(cfg.spp):
            if primary is not None:
                _seed_from_gbuffer(rays, primary, batch, sample, tri_data, camera_pos, rotation,
                                   light, frame_idx, cfg, counts)
            for seg in range(start, cfg.max_bounces):
                trace_segment(rays, seg, batch, sample, tri_data, camera_pos, rotation, light,
                              frame_idx, cfg, counts)
            summed = summed + path_radiance(rays, cfg)
        total = total + cam_ops.true_div(summed, float(cfg.spp))
    out = cam_ops.true_div(total, float(cfg.sample_batches))
    return out.T.contiguous().view(cfg.height, cfg.width, 3)
