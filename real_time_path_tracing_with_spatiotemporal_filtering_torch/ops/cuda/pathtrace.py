"""Bounce-loop path tracer.

:func:`path_trace_pass` launches the CUDA kernel of ``csrc/pathtrace.cu``
for tensors on a CUDA device and runs :func:`path_trace_pass_plain` (the
vectorized tracer of ops/pathtrace.py) for tensors on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import (
    camera as cam_ops,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import pathtrace
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import _build

# The kernel's triangle rows (csrc/bounce.cuh DenseTable): the 12
# ray/triangle test constants first, as three 16-byte groups (n, d0 | n1, d1
# | n2, d2), then v0, e1, e2, the unit normal and the albedo: 27 floats,
# which the kernel stages into shared-memory rows of 32 floats (128 bytes).
ROW_FLOATS = 27
SHARED_ROW_FLOATS = 32
# Rows that fit in shared memory beside the 18 parameter floats, in the 48 KB
# a block gets without opting in to more.
MAX_TRIANGLES = (48 * 1024 - 18 * 4) // (SHARED_ROW_FLOATS * 4)

path_trace_pass_plain = pathtrace.path_trace_pass

_FETCH: dict = {}


def _fetch_counters(device) -> torch.Tensor:
    """The kernel's two int32 pixel-fetch counters for the current stream
    of ``device``: zeroed once, here; every launch leaves them zero."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    if key not in _FETCH:
        _FETCH[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return _FETCH[key]


def pack_table(tri_data) -> torch.Tensor:
    """The kernel's (T, 27) float32 triangle table (ROW_FLOATS)."""
    planes = tri_data.planes
    return torch.cat([
        planes.n, planes.d0[:, None], planes.n1, planes.d1[:, None], planes.n2,
        planes.d2[:, None], planes.v0, planes.e1, planes.e2, tri_data.normals, tri_data.albedo,
    ], dim=1).contiguous()


def path_trace_pass(tri_data, camera_pos, light, frame_idx, cfg, rotation, tests=None,
                    path_len=None, lanes=None):
    """Noisy radiance (H, W, 3) of one frame (plain version for CPU
    tensors). Optional CUDA tensors that select the counting instantiation,
    for measuring the work of a launch: ``tests`` (H, W) int32 receives the
    ray/triangle tests each pixel ran (nearest-hit walks and NEE shadow
    walks); ``path_len`` (sample_batches * spp, H, W) int32 the segments
    each sample's path ran; ``lanes`` (4,) int64 accumulates the lane
    efficiency: lanes that ran a bounce and warp steps of the bounce loop,
    lanes that ran a triangle test and warp steps of the triangle loops."""
    if camera_pos.device.type == "cpu":
        return path_trace_pass_plain(
            tri_data, camera_pos, light, frame_idx, cfg, rotation=rotation
        )
    t = tri_data.num_triangles
    if t > MAX_TRIANGLES:
        raise NotImplementedError(
            f"{t} triangles exceed the trace kernel's shared-memory table "
            f"({MAX_TRIANGLES}); ops/cuda/wavefront.path_trace_wavefront takes any scene"
        )
    table = pack_table(tri_data)
    params = torch.cat(
        [
            camera_pos.reshape(3),
            rotation.reshape(9),
            light.position.reshape(3),
            (light.color * cfg.light_intensity).reshape(3),
        ]
    ).contiguous()
    _build.check_cuda("table", table, torch.float32, (t, ROW_FLOATS))
    _build.check_cuda("params", params, torch.float32, (18,))
    h, w = cfg.height, cfg.width
    if tests is not None:
        _build.check_cuda("tests", tests, torch.int32, (h, w))
    if path_len is not None:
        _build.check_cuda("path_len", path_len, torch.int32, (cfg.sample_batches * cfg.spp, h, w))
    if lanes is not None:
        _build.check_cuda("lanes", lanes, torch.int64, (4,))
    out = torch.empty((h, w, 3), dtype=torch.float32, device=table.device)

    def f32(x) -> float:
        return float(np.float32(x))

    _build.launch(
        "ptsf_trace",
        table.data_ptr(), t, params.data_ptr(), w, h, int(frame_idx),
        cfg.max_bounces, cfg.spp, cfg.sample_batches,
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
        int(cfg.truncate_radiance),
        _fetch_counters(table.device).data_ptr(),
        out.data_ptr(),
        *(None if x is None else x.data_ptr() for x in (tests, path_len, lanes)),
    )
    return out
