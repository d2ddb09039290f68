"""Fused geometry pass: G-buffer + temporal gradient + backprojection.

:func:`geometry_pass` launches the CUDA kernel of ``csrc/geometry.cu`` for
tensors on a CUDA device and runs :func:`geometry_pass_plain`, its plain
PyTorch version, for tensors on the CPU. Both return
:class:`GeometryBuffers`: everything the rest of the frame needs from the
camera rays and the triangle tables, so the filter and the blend read
planes instead of per-pixel LUT gathers. :func:`visibility_pass` runs the
same kernels in their visibility-only mode, the drop-in for
ops/gbuffer.visibility_pass. The dense kernel culls its table per warp
tile of 8x4 pixels; ops/tilecull.py is that cull's plain twin. Every pass
takes ``row_offset``/``rows``: it then renders the slab of ``rows`` rows
from global row ``row_offset`` on (the row-sharded frame, parallel/), its
rays, cull and backprojection those of the global pixels.
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
    intersect,
    tilecull,
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
                        emit_albedo: bool = False, row_offset: int = 0,
                        rows: int | None = None) -> GeometryBuffers:
    """The plain PyTorch version: ops.gbuffer, ops.gradient and
    ops.atrous.backproject_pixels, plus the filter normal lut_normals[vis]
    and, with ``emit_albedo``, ops.atrous.albedo_image."""
    gbuf = gbuffer.visibility_pass(
        tri_data, camera_pos, view, proj, cfg, rotation=rotation, row_offset=row_offset, rows=rows
    )
    lam = gradient.temporal_gradient_pass(
        gbuf, tri_data.lut, lut_prev, camera_pos, light_pos, light_pos_prev,
        light_color, light_color_prev,
    )
    py, px = atrous.backproject_pixels(gbuf, lut_prev, view_prev, proj_prev, cfg, row_offset)
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


def _params(camera_pos, rotation, light_pos, light_pos_prev, light_color,
            light_color_prev, view, proj, view_prev, proj_prev) -> torch.Tensor:
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
    _build.check_cuda("params", params, torch.float32, (56,))
    return params


def slab(cfg, row_offset: int, rows: int | None) -> int:
    """The rows of a pass's slab (``rows``, default the frame's); raises
    unless the slab lies in the frame."""
    rows = cfg.height if rows is None else int(rows)
    if row_offset < 0 or rows < 1 or row_offset + rows > cfg.height:
        raise ValueError(f"rows [{row_offset}, {row_offset + rows}) outside a frame of "
                         f"{cfg.height} rows")
    return rows


def _buffers(cfg, dev, emit_albedo: bool, rows: int) -> GeometryBuffers:
    h, w = rows, cfg.width
    f32 = dict(dtype=torch.float32, device=dev)
    return GeometryBuffers(
        visibility=torch.empty((h, w), **f32),
        depth=torch.empty((h, w), **f32),
        normal=torch.empty((h, w, 3), **f32),
        lam=torch.empty((h, w), **f32),
        prev_y=torch.empty((h, w), dtype=torch.int32, device=dev),
        prev_x=torch.empty((h, w), dtype=torch.int32, device=dev),
        world_pos=torch.empty((h, w, 3), **f32),
        albedo=torch.empty((h, w, 3), **f32) if emit_albedo else None,
    )


def _outputs(out: GeometryBuffers) -> tuple:
    return (out.visibility.data_ptr(), out.depth.data_ptr(), out.normal.data_ptr(),
            out.lam.data_ptr(), out.prev_y.data_ptr(), out.prev_x.data_ptr(),
            out.world_pos.data_ptr())


def geometry_pass(tri_data, lut_prev, camera_pos, rotation, light_pos,
                  light_pos_prev, light_color, light_color_prev, view, proj,
                  view_prev, proj_prev, cfg, emit_albedo: bool = False,
                  counts=None, row_offset: int = 0, rows: int | None = None) -> GeometryBuffers:
    """G-buffer, temporal gradient and backprojection in one kernel launch,
    with the albedo planes when ``emit_albedo`` (plain version for CPU
    tensors). ``counts``: optional (2, rows*W) int32 tensor that receives
    each pixel's triangle tests and its warp tile's cull survivors
    (:func:`dense_counts`), for counting the work of a launch."""
    args = (tri_data, lut_prev, camera_pos, rotation, light_pos,
            light_pos_prev, light_color, light_color_prev, view, proj,
            view_prev, proj_prev, cfg)
    n_rows = slab(cfg, row_offset, rows)
    if camera_pos.device.type == "cpu":
        if counts is not None:
            counts.copy_(dense_counts_plain(tri_data, camera_pos, rotation, cfg, row_offset,
                                            n_rows))
        return geometry_pass_plain(*args, emit_albedo=emit_albedo, row_offset=row_offset,
                                   rows=n_rows)
    t = tri_data.num_triangles
    table = _dense_table(tri_data, lut_prev)
    params = _params(*args[2:12])
    out = _buffers(cfg, table.device, emit_albedo, n_rows)
    albedo = tri_data.albedo.contiguous()
    _build.check_cuda("albedo", albedo, torch.float32, (t, 3))
    _build.launch(
        "ptsf_geometry",
        table.data_ptr(), t, params.data_ptr(), cfg.width, cfg.height, int(row_offset), n_rows,
        cam_ops.fov_slope(cfg.fov),
        float(np.float32(cfg.t_max)),
        float(np.float32(cfg.intersect_eps)),
        *_outputs(out),
        albedo.data_ptr(),
        out.albedo.data_ptr() if emit_albedo else None,
        0,
        _dense_count_pointer(counts, cfg, n_rows),
    )
    return out


def dense_counts(cfg, device, rows: int | None = None) -> torch.Tensor:
    """Zeroed counters for a dense geometry launch at ``cfg``'s size, or
    over ``rows`` rows of a slab: row 0 each pixel's triangle tests, row 1
    the survivors of its warp tile's cull (ops/tilecull.py)."""
    rows = cfg.height if rows is None else rows
    return torch.zeros((2, rows * cfg.width), dtype=torch.int32, device=device)


def dense_counts_plain(tri_data, camera_pos, rotation, cfg, row_offset: int = 0,
                       rows: int | None = None) -> torch.Tensor:
    """What a counting launch of the dense kernel writes into ``counts``,
    from the cull's plain twin (ops/tilecull.py); over a slab whose first
    row starts a row of warp tiles, those pixels of the frame's."""
    rows = cfg.height if rows is None else rows
    if row_offset % tilecull.TILE[1]:
        raise ValueError(f"a slab from row {row_offset} does not start a row of warp tiles")
    survivors = tilecull.tile_survivors_plain(tri_data.planes, camera_pos, rotation, cfg)
    counts = tilecull.tile_counts_plain(survivors, cfg)
    return counts[:, row_offset * cfg.width:(row_offset + rows) * cfg.width]


def _dense_count_pointer(counts, cfg, rows: int) -> int | None:
    if counts is None:
        return None
    _build.check_cuda("counts", counts, torch.int32, (2, rows * cfg.width))
    return counts.data_ptr()


def _dense_table(tri_data, lut_prev) -> torch.Tensor:
    """The dense kernel's (T, 42) shared-memory rows."""
    planes = tri_data.planes
    t = tri_data.num_triangles
    if t > MAX_TRIANGLES:
        raise NotImplementedError(
            f"{t} triangles exceed the dense geometry kernel's shared-memory "
            f"table ({MAX_TRIANGLES}); geometry_pass_bvh takes any scene"
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
    _build.check_cuda("table", table, torch.float32, (t, 42))
    return table


class WalkCounts(NamedTuple):
    """The work of LBVH kernel launches, for their bounds: what the kernels'
    counting instantiations record when a wrapper is given ``counts``."""

    tests: torch.Tensor  # (2, N) int32: each ray's triangle tests and box tests
    nodes: torch.Tensor  # (max(T-1, 1),) int32: 1 where a walk read the node row
    tris: torch.Tensor   # (T,) int32: 1 where a walk read the triangle-test row

    @classmethod
    def zeros(cls, n: int, tri_data) -> "WalkCounts":
        """Zeroed counters for launches over ``n`` rays of the scene."""
        dev = tri_data.bvh.nodes.device
        return cls(*(torch.zeros(shape, dtype=torch.int32, device=dev)
                     for shape in _count_shapes(n, tri_data)))


def _count_shapes(n: int, tri_data) -> tuple:
    return (2, n), (tri_data.bvh.nodes.shape[0],), (tri_data.num_triangles,)


def count_pointers(counts: WalkCounts | None, n: int, tri_data) -> tuple:
    """The three counter pointers of a launch over ``n`` rays (null when not
    counting); raises unless the counters fit the launch."""
    if counts is None:
        return None, None, None
    for name, t, shape in zip(WalkCounts._fields, counts, _count_shapes(n, tri_data)):
        _build.check_cuda(f"counts.{name}", t, torch.int32, shape)
    return tuple(t.data_ptr() for t in counts)


def lane_pointer(lanes: torch.Tensor | None, counts) -> int | None:
    """The pointer of an LBVH launch's ``lanes`` (null when not counting):
    a (4,) int64 CUDA tensor to which the counting launch adds its lane
    counts, the lanes that had a ray and the warps that ran them, then the
    walks' lanes and warp steps; raises unless it comes with ``counts``."""
    if lanes is None:
        return None
    if counts is None:
        raise ValueError("lanes are counted only with counts")
    _build.check_cuda("lanes", lanes, torch.int64, (4,))
    return lanes.data_ptr()


def check_bvh(tri_data) -> None:
    """Raise unless the scene's LBVH tables and attribute arrays are what
    the LBVH kernels read: contiguous float32 CUDA tensors of the scene's
    size, the node and test rows 16-byte aligned."""
    t = tri_data.num_triangles
    bvh = tri_data.bvh
    _build.check_cuda("bvh.nodes", bvh.nodes, torch.float32, (max(t - 1, 1), 16))
    _build.check_cuda("bvh.tris", bvh.tris, torch.float32, (t, 12))
    for name in ("v0", "e1", "e2"):
        _build.check_cuda(f"planes.{name}", getattr(tri_data.planes, name), torch.float32, (t, 3))
    _build.check_cuda("normals", tri_data.normals, torch.float32, (t, 3))
    _build.check_cuda("albedo", tri_data.albedo, torch.float32, (t, 3))
    if bvh.nodes.data_ptr() % 16 or bvh.tris.data_ptr() % 16:
        raise ValueError("the LBVH tables must be 16-byte aligned")


def geometry_pass_bvh(tri_data, lut_prev, camera_pos, rotation, light_pos,
                      light_pos_prev, light_color, light_color_prev, view, proj,
                      view_prev, proj_prev, cfg, emit_albedo: bool = False,
                      counts=None, lanes=None, row_offset: int = 0,
                      rows: int | None = None) -> GeometryBuffers:
    """:func:`geometry_pass` through the LBVH (one kernel launch; plain
    version for CPU tensors). ``counts``: optional :class:`WalkCounts` of
    rows*W rays that receives each pixel's triangle tests and box tests and
    marks the rows read, for counting the work of a launch; with it,
    ``lanes`` (optional) accumulates the lane counts (:func:`lane_pointer`)."""
    args = (tri_data, lut_prev, camera_pos, rotation, light_pos,
            light_pos_prev, light_color, light_color_prev, view, proj,
            view_prev, proj_prev, cfg)
    n_rows = slab(cfg, row_offset, rows)
    if camera_pos.device.type == "cpu":
        return geometry_pass_plain(*args, emit_albedo=emit_albedo, row_offset=row_offset,
                                   rows=n_rows)
    t = tri_data.num_triangles
    check_bvh(tri_data)
    _build.check_cuda("lut", tri_data.lut, torch.float32, (t + 1, 3, 3))
    _build.check_cuda("lut_prev", lut_prev, torch.float32, (t + 1, 3, 3))
    _build.check_cuda("lut_normals", tri_data.lut_normals, torch.float32, (t + 1, 3))
    count_ptrs = count_pointers(counts, cfg.width * n_rows, tri_data)
    params = _params(*args[2:12])
    out = _buffers(cfg, params.device, emit_albedo, n_rows)
    planes = tri_data.planes
    _build.launch(
        "ptsf_geometry_bvh",
        tri_data.bvh.nodes.data_ptr(), tri_data.bvh.tris.data_ptr(),
        planes.v0.data_ptr(), planes.e1.data_ptr(), planes.e2.data_ptr(),
        tri_data.lut_normals.data_ptr(), tri_data.lut.data_ptr(), lut_prev.data_ptr(),
        params.data_ptr(), cfg.width, cfg.height, int(row_offset), n_rows,
        cam_ops.fov_slope(cfg.fov),
        float(np.float32(cfg.t_max)),
        float(np.float32(cfg.intersect_eps)),
        *_outputs(out),
        tri_data.albedo.data_ptr(),
        out.albedo.data_ptr() if emit_albedo else None,
        0,
        *count_ptrs,
        lane_pointer(lanes, counts),
    )
    return out


def visibility_pass(tri_data, camera_pos, view, proj, cfg, rotation=None,
                    counts=None, lanes=None, row_offset: int = 0,
                    rows: int | None = None) -> gbuffer.GBuffer:
    """The G-buffer of ops/gbuffer.visibility_pass (visibility, world
    position, depth) in one launch of the geometry kernels' visibility-only
    mode: the dense kernel below ops/intersect.BVH_MIN_TRIANGLES
    (:func:`visibility_pass_dense`), the LBVH kernel from there on (plain
    version for CPU tensors). ``counts`` and ``lanes``: as in
    :func:`geometry_pass_bvh` on LBVH scenes, as in
    :func:`visibility_pass_dense` (no ``lanes``) on the others."""
    if not intersect.uses_bvh(tri_data):
        if lanes is not None:
            raise ValueError("lanes are counted on LBVH scenes only")
        return visibility_pass_dense(tri_data, camera_pos, view, proj, cfg, rotation, counts,
                                     row_offset, rows)
    n_rows = slab(cfg, row_offset, rows)
    if camera_pos.device.type == "cpu":
        return gbuffer.visibility_pass(tri_data, camera_pos, view, proj, cfg, rotation=rotation,
                                       row_offset=row_offset, rows=n_rows)
    if rotation is None:
        rotation = torch.eye(3, dtype=torch.float32, device=camera_pos.device)
    params, out, pointers, scalars = _visibility_launch(camera_pos, view, proj, cfg, rotation,
                                                        row_offset, n_rows)
    t = tri_data.num_triangles
    check_bvh(tri_data)
    _build.check_cuda("lut", tri_data.lut, torch.float32, (t + 1, 3, 3))
    _build.check_cuda("lut_normals", tri_data.lut_normals, torch.float32, (t + 1, 3))
    planes = tri_data.planes
    _build.launch(
        "ptsf_geometry_bvh",
        tri_data.bvh.nodes.data_ptr(), tri_data.bvh.tris.data_ptr(),
        planes.v0.data_ptr(), planes.e1.data_ptr(), planes.e2.data_ptr(),
        tri_data.lut_normals.data_ptr(), tri_data.lut.data_ptr(), tri_data.lut.data_ptr(),
        params.data_ptr(), *scalars, *pointers, None, None, 1,
        *count_pointers(counts, cfg.width * n_rows, tri_data), lane_pointer(lanes, counts),
        label="geometry_bvh[visibility]",
    )
    return out


def _visibility_launch(camera_pos, view, proj, cfg, rotation, row_offset: int, rows: int):
    """The visibility-only mode's parameters (the gradient's and the
    backprojection's are not read), its output planes and their pointers,
    and the kernels' scalar arguments."""
    zeros3 = torch.zeros(3, dtype=torch.float32, device=camera_pos.device)
    params = _params(camera_pos, rotation, zeros3, zeros3, zeros3, zeros3, view, proj, view, proj)
    h, w = rows, cfg.width
    f32 = dict(dtype=torch.float32, device=params.device)
    out = gbuffer.GBuffer(visibility=torch.empty((h, w), **f32),
                          world_pos=torch.empty((h, w, 3), **f32),
                          depth=torch.empty((h, w), **f32))
    pointers = (out.visibility.data_ptr(), out.depth.data_ptr(), None, None, None, None,
                out.world_pos.data_ptr())
    scalars = (w, cfg.height, int(row_offset), rows, cam_ops.fov_slope(cfg.fov),
               float(np.float32(cfg.t_max)),
               float(np.float32(cfg.intersect_eps)))
    return params, out, pointers, scalars


def visibility_pass_dense(tri_data, camera_pos, view, proj, cfg, rotation=None,
                          counts=None, row_offset: int = 0,
                          rows: int | None = None) -> gbuffer.GBuffer:
    """:func:`visibility_pass` through the dense kernel, on any scene its
    table holds (plain version for CPU tensors). ``counts``: as in
    :func:`geometry_pass`."""
    eye = torch.eye(3, dtype=torch.float32, device=camera_pos.device)
    n_rows = slab(cfg, row_offset, rows)
    if camera_pos.device.type == "cpu":
        if counts is not None:
            counts.copy_(dense_counts_plain(
                tri_data, camera_pos, eye if rotation is None else rotation, cfg, row_offset,
                n_rows))
        return gbuffer.visibility_pass(tri_data, camera_pos, view, proj, cfg, rotation=rotation,
                                       row_offset=row_offset, rows=n_rows)
    params, out, pointers, scalars = _visibility_launch(
        camera_pos, view, proj, cfg, eye if rotation is None else rotation, row_offset, n_rows)
    table = _dense_table(tri_data, tri_data.lut)
    _build.launch(
        "ptsf_geometry", table.data_ptr(), tri_data.num_triangles, params.data_ptr(), *scalars,
        *pointers, None, None, 1, _dense_count_pointer(counts, cfg, n_rows),
        label="geometry[visibility]",
    )
    return out
