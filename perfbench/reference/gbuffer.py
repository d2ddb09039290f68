"""Primary-ray visibility pass (G-buffer).

Replaces the reference's rasterized vert/geom/frag visibility pipeline
(shaders/visibility.{vert,geom,frag}.glsl + main.cpp:1408-1461), which exists
only to produce: per-pixel triangle ID (primID+1, 0 = background), world
position and raster depth. One primary ray per pixel goes through the *same*
camera model as the path tracer (pixel center, no jitter), so the G-buffer
is exactly pixel-aligned with the traced image (SURVEY.md section 7).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import (
    camera as cam_ops,
)
from . import intersect


class GBuffer(NamedTuple):
    """Per-pixel geometry channels, all (H, W[, C])."""

    visibility: torch.Tensor  # (H, W) float32: primID + 1, 0 = background
    world_pos: torch.Tensor   # (H, W, 3) hit position (0 for background)
    depth: torch.Tensor       # (H, W) raster-equivalent NDC depth (1 for bg)


def pixel_grid(height: int, width: int, device=None):
    """(py, px) int64 row and column index planes of shape (H, W)."""
    py = torch.arange(height, device=device)[:, None].expand(height, width)
    px = torch.arange(width, device=device)[None, :].expand(height, width)
    return py, px


def visibility_pass(tri_data, camera_pos, view, proj, cfg, rotation=None, row_offset: int = 0,
                    rows: int | None = None) -> GBuffer:
    """Trace one center ray per pixel and assemble the G-buffer.

    ``view``/``proj`` are only used to reproduce the raster depth channel
    (clip.z/clip.w) that feeds the filter's depth edge-stopping weight
    (temporalFiltering.comp.glsl:66-69, 123).

    ``row_offset``/``rows``: the pass renders ``rows`` rows (default: the
    frame's) from global row ``row_offset`` on, a row slab of the sharded
    frame (parallel/); rays are functions of the global pixel.
    """
    h = cfg.height if rows is None else rows
    w = cfg.width
    py, px = pixel_grid(h, w, camera_pos.device)
    dirs = cam_ops.pixel_rays(px, py + row_offset, w, cfg.height, cfg.fov, rotation=rotation)
    origins = camera_pos.expand(h, w, 3)

    rec = intersect.scene_nearest_hit(
        tri_data, origins, dirs, t_max=cfg.t_max, eps=cfg.intersect_eps
    )
    hit = rec.hit[..., None]
    world_pos = intersect.hit_position(tri_data.planes, rec)
    world_pos = torch.where(hit, world_pos, torch.zeros_like(world_pos))

    visibility = torch.where(
        rec.hit, (rec.prim + 1).to(torch.float32), torch.zeros_like(rec.t)
    )
    depth = torch.where(
        rec.hit,
        cam_ops.ndc_depth(world_pos, view, proj),
        torch.ones_like(rec.t),  # depth attachment clear value
    )
    return GBuffer(visibility=visibility, world_pos=world_pos, depth=depth)
