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

# Shared-memory rows of the kernel: 27 floats per triangle, beside 18
# parameter floats, in the 48 KB a block gets without opting in to more.
MAX_TRIANGLES = (48 * 1024 - 18 * 4) // (27 * 4)

path_trace_pass_plain = pathtrace.path_trace_pass


def path_trace_pass(tri_data, camera_pos, light, frame_idx, cfg, rotation, tests=None):
    """Noisy radiance (H, W, 3) of one frame (plain version for CPU
    tensors). ``tests``: optional (H, W) int32 CUDA tensor that receives
    the number of ray/triangle tests each pixel ran (nearest-hit walks and
    NEE shadow walks), for counting the work of a launch."""
    if camera_pos.device.type == "cpu":
        return path_trace_pass_plain(
            tri_data, camera_pos, light, frame_idx, cfg, rotation=rotation
        )
    t = tri_data.num_triangles
    if t > MAX_TRIANGLES:
        raise NotImplementedError(
            f"{t} triangles exceed the trace kernel's shared-memory table "
            f"({MAX_TRIANGLES}); large scenes are ROADMAP Queue 1 item 7"
        )
    planes = tri_data.planes
    table = torch.cat(
        [
            planes.v0, planes.e1, planes.e2, planes.n, planes.d0[:, None],
            planes.n1, planes.d1[:, None], planes.n2, planes.d2[:, None],
            tri_data.normals, tri_data.albedo,
        ],
        dim=1,
    ).contiguous()
    params = torch.cat(
        [
            camera_pos.reshape(3),
            rotation.reshape(9),
            light.position.reshape(3),
            (light.color * cfg.light_intensity).reshape(3),
        ]
    ).contiguous()
    _build.check_cuda("table", table, torch.float32, (t, 27))
    _build.check_cuda("params", params, torch.float32, (18,))
    h, w = cfg.height, cfg.width
    if tests is not None:
        _build.check_cuda("tests", tests, torch.int32, (h, w))
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
        out.data_ptr(),
        None if tests is None else tests.data_ptr(),
    )
    return out
