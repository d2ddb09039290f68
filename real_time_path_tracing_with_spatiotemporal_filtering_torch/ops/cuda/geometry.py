"""Fused geometry pass: G-buffer + temporal gradient + backprojection.

:func:`geometry_pass` launches the CUDA kernel of ``csrc/geometry.cu`` for
tensors on a CUDA device and runs :func:`geometry_pass_plain`, its plain
PyTorch version, for tensors on the CPU. Both return
:class:`GeometryBuffers`: everything the rest of the frame needs from the
camera rays and the triangle tables, so the filter and the blend read
planes instead of per-pixel LUT gathers.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import (
    atrous,
    camera as cam_ops,
    gbuffer,
    gradient,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import _build

# Shared-memory rows of the kernel: 42 floats per triangle, beside 56
# parameter floats, in the 48 KB a block gets without opting in to more.
MAX_TRIANGLES = (48 * 1024 - 56 * 4) // (42 * 4)


class GeometryBuffers(NamedTuple):
    visibility: torch.Tensor  # (H, W) float32 primID+1, 0 = background
    depth: torch.Tensor       # (H, W) float32 raster depth (1 for background)
    normal: torch.Tensor      # (H, W, 3) filter normals, (0, 0, 1) background
    lam: torch.Tensor         # (H, W) temporal gradient
    prev_y: torch.Tensor      # (H, W) int32 backprojected row
    prev_x: torch.Tensor      # (H, W) int32 backprojected column
    world_pos: torch.Tensor   # (H, W, 3) hit position (0 for background)
    albedo: torch.Tensor | None = None  # (H, W, 3) hit albedo (1 for background)


def geometry_pass_plain(tri_data, lut_prev, camera_pos, rotation, light_pos,
                        light_pos_prev, light_color, light_color_prev, view,
                        proj, view_prev, proj_prev, cfg,
                        emit_albedo: bool = False) -> GeometryBuffers:
    """The plain PyTorch version: ops.gbuffer, ops.gradient and
    ops.atrous.backproject_pixels, plus the filter normal lut_normals[vis]
    and, with ``emit_albedo``, ops.atrous.albedo_image."""
    gbuf = gbuffer.visibility_pass(
        tri_data, camera_pos, view, proj, cfg, rotation=rotation
    )
    lam = gradient.temporal_gradient_pass(
        gbuf, tri_data.lut, lut_prev, camera_pos, light_pos, light_pos_prev,
        light_color, light_color_prev,
    )
    py, px = atrous.backproject_pixels(gbuf, lut_prev, view_prev, proj_prev, cfg)
    normal = tri_data.lut_normals[gbuf.visibility.to(torch.int64)]
    return GeometryBuffers(
        visibility=gbuf.visibility,
        depth=gbuf.depth,
        normal=normal,
        lam=lam,
        prev_y=py.to(torch.int32),
        prev_x=px.to(torch.int32),
        world_pos=gbuf.world_pos,
        albedo=atrous.albedo_image(tri_data, gbuf.visibility) if emit_albedo else None,
    )


def geometry_pass(tri_data, lut_prev, camera_pos, rotation, light_pos,
                  light_pos_prev, light_color, light_color_prev, view, proj,
                  view_prev, proj_prev, cfg, emit_albedo: bool = False) -> GeometryBuffers:
    """G-buffer, temporal gradient and backprojection in one kernel launch,
    with the albedo planes when ``emit_albedo`` (plain version for CPU
    tensors)."""
    args = (tri_data, lut_prev, camera_pos, rotation, light_pos,
            light_pos_prev, light_color, light_color_prev, view, proj,
            view_prev, proj_prev, cfg)
    if camera_pos.device.type == "cpu":
        return geometry_pass_plain(*args, emit_albedo=emit_albedo)
    planes = tri_data.planes
    t = tri_data.num_triangles
    if t > MAX_TRIANGLES:
        raise NotImplementedError(
            f"{t} triangles exceed the geometry kernel's shared-memory table "
            f"({MAX_TRIANGLES}); large scenes are ROADMAP Queue 1 item 7"
        )
    table = torch.cat(
        [
            planes.v0, planes.e1, planes.e2, planes.n, planes.d0[:, None],
            planes.n1, planes.d1[:, None], planes.n2, planes.d2[:, None],
            tri_data.lut_normals[1:],
            tri_data.lut[1:].reshape(t, 9),
            lut_prev[1:].reshape(t, 9),
        ],
        dim=1,
    ).contiguous()
    params = torch.cat(
        [
            camera_pos.reshape(3),
            rotation.reshape(9),
            cam_ops.matmul_highest(proj, view).reshape(16),
            cam_ops.matmul_highest(proj_prev, view_prev).reshape(16),
            light_pos.reshape(3),
            light_pos_prev.reshape(3),
            light_color.reshape(3),
            light_color_prev.reshape(3),
        ]
    ).contiguous()
    _build.check_cuda("table", table, torch.float32, (t, 42))
    _build.check_cuda("params", params, torch.float32, (56,))
    h, w = cfg.height, cfg.width
    dev = table.device
    f32 = dict(dtype=torch.float32, device=dev)
    out = GeometryBuffers(
        visibility=torch.empty((h, w), **f32),
        depth=torch.empty((h, w), **f32),
        normal=torch.empty((h, w, 3), **f32),
        lam=torch.empty((h, w), **f32),
        prev_y=torch.empty((h, w), dtype=torch.int32, device=dev),
        prev_x=torch.empty((h, w), dtype=torch.int32, device=dev),
        world_pos=torch.empty((h, w, 3), **f32),
        albedo=torch.empty((h, w, 3), **f32) if emit_albedo else None,
    )
    albedo = tri_data.albedo.contiguous()
    _build.check_cuda("albedo", albedo, torch.float32, (t, 3))
    _build.launch(
        "ptsf_geometry",
        table.data_ptr(), t, params.data_ptr(), w, h,
        cam_ops.fov_slope(cfg.fov),
        float(np.float32(cfg.t_max)),
        float(np.float32(cfg.intersect_eps)),
        out.visibility.data_ptr(), out.depth.data_ptr(), out.normal.data_ptr(),
        out.lam.data_ptr(), out.prev_y.data_ptr(), out.prev_x.data_ptr(),
        out.world_pos.data_ptr(),
        albedo.data_ptr(),
        out.albedo.data_ptr() if emit_albedo else None,
    )
    return out
