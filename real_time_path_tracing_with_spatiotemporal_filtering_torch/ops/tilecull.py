"""The dense geometry kernel's tile cull, in plain PyTorch.

The dense geometry kernel (``csrc/geometry.cu`` ``geometry_kernel``) traces
an 8x4 tile of pixels a warp. Before it tests a triangle, the warp culls the
triangle table against the tile's frustum: a triangle is dropped when its
three vertices lie outside one of the frustum's four side planes by more
than a margin, and the pixels test the survivors only. This module is that
cull's plain twin, operation for operation, so it gives the kernel's
survivors bit for bit: :func:`tile_survivors_plain` the (tiles, T) mask of
the warps' ballots, :func:`tile_counts_plain` the per-pixel counts of the
kernel's counting instantiation. The tests and ``chip_smoke.py`` use them;
a frame never does (the kernel culls, and the plain frame tests every
triangle). Why the cull never drops a triangle that a pixel of the tile
hits is argued beside the kernel's ``outside_tile``.
"""

from __future__ import annotations

import numpy as np
import torch

from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import camera as cam_ops
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.intersect import (
    TrianglePlanes,
)

# csrc/geometry.cu: kWarpW x kWarpH pixels a warp, kCullAbs
TILE = (8, 4)
CULL_ABS = 2.0**-12  # the absolute margin per unit of coordinate scale
_TILES_PER_CHUNK = 4096  # bounds the (tiles, 4, 3, T) comparison's memory


def tile_grid(cfg) -> tuple[int, int]:
    """(rows, columns) of warp tiles over the frame; tile (ty, tx) starts at
    pixel (ty * th, tx * tw) and has index ty * columns + tx."""
    tw, th = TILE
    return -(-cfg.height // th), -(-cfg.width // tw)


def _l1(a: torch.Tensor) -> torch.Tensor:
    return (a[..., 0].abs() + a[..., 1].abs()) + a[..., 2].abs()


def _screen_u(x: torch.Tensor, cfg) -> torch.Tensor:
    fx = x.to(torch.float32) + 0.5
    return cam_ops.true_div(2.0 * fx - float(cfg.width), float(cfg.height))


def _screen_v(y: torch.Tensor, cfg) -> torch.Tensor:
    fy = y.to(torch.float32) + 0.5
    h = float(cfg.height)
    return cam_ops.true_div(-(2.0 * fy - h), h)


def _inward(n: torch.Tensor, inside: torch.Tensor) -> torch.Tensor:
    return torch.where((cam_ops.dot3(n, inside) < 0.0)[..., None], -n, n)


def _tile_planes(rotation, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """The inward normals (tiles, 4, 3) of each tile's side planes (left,
    right, top, bottom) and their lengths (tiles, 4): the tile widened by
    one pixel on each side, through the camera (``tile_frustum``)."""
    tw, th = TILE
    rows, cols = tile_grid(cfg)
    dev = rotation.device
    x0 = torch.arange(cols, device=dev) * tw
    y0 = torch.arange(rows, device=dev) * th
    slope = cam_ops.fov_slope(cfg.fov)
    right, up, back = rotation[:, 0], rotation[:, 1], rotation[:, 2]
    left_e = (slope * _screen_u(x0 - 1, cfg))[:, None] * right - back      # (cols, 3)
    right_e = (slope * _screen_u(x0 + tw, cfg))[:, None] * right - back
    top_e = (slope * _screen_v(y0 - 1, cfg))[:, None] * up - back          # (rows, 3)
    bottom_e = (slope * _screen_v(y0 + th, cfg))[:, None] * up - back
    cross = cam_ops.cross3
    sides = [
        _inward(cross(left_e, up), right_e)[None].expand(rows, cols, 3),
        _inward(cross(right_e, up), left_e)[None].expand(rows, cols, 3),
        _inward(cross(right, top_e), bottom_e)[:, None].expand(rows, cols, 3),
        _inward(cross(right, bottom_e), top_e)[:, None].expand(rows, cols, 3),
    ]
    n = torch.stack(sides, dim=2).reshape(rows * cols, 4, 3)
    return n, cam_ops.norm3(n)


def tile_survivors_plain(planes: TrianglePlanes, camera_pos, rotation, cfg) -> torch.Tensor:
    """The (tiles, T) bool mask of the triangles of the scene's ``planes``
    that survive each warp tile's cull (tile index as in
    :func:`tile_grid`)."""
    v0, e1, e2 = planes.v0, planes.e1, planes.e2
    o = camera_pos.reshape(3)
    p = torch.stack([v0 - o, (v0 + e1) - o, (v0 + e2) - o])  # (3, T, 3)
    # 2 slope / height, rounded once, as the kernel computes it
    pix = float(np.float32(2.0 * cam_ops.fov_slope(cfg.fov)) / np.float32(cfg.height))
    floor_m = CULL_ABS * (((_l1(o) + _l1(v0)) + _l1(e1)) + _l1(e2))      # (T,)
    margin = torch.fmax(pix * _l1(p), floor_m)                             # (3, T)
    n, length = _tile_planes(rotation, cfg)
    out = []
    for lo in range(0, n.shape[0], _TILES_PER_CHUNK):
        nk = n[lo:lo + _TILES_PER_CHUNK, :, None, None, :]
        lk = length[lo:lo + _TILES_PER_CHUNK, :, None, None]
        outside = cam_ops.dot3(nk, p) < -(lk * margin)                   # (tiles, 4, 3, T)
        out.append(~outside.all(dim=2).any(dim=1))
    return torch.cat(out)


def tile_counts_plain(survivors: torch.Tensor, cfg) -> torch.Tensor:
    """What the kernel's counting launch writes into ``counts`` (2, H*W)
    int32, from :func:`tile_survivors_plain`'s mask: each pixel's triangle
    tests, then its warp's survivors (the same number: every lane tests
    every survivor)."""
    tw, th = TILE
    rows, cols = tile_grid(cfg)
    per_tile = survivors.sum(dim=1, dtype=torch.int32).reshape(rows, cols)
    per_pixel = per_tile.repeat_interleave(th, 0).repeat_interleave(tw, 1)
    per_pixel = per_pixel[:cfg.height, :cfg.width].reshape(-1)
    return torch.stack([per_pixel, per_pixel])
