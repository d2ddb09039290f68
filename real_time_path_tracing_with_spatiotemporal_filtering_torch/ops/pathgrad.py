"""A-SVGF path-space temporal gradient (cfg.path_gradient), plain PyTorch.

The reference estimates shading change by Phong-shading the same world point
under the previous and the current light (temporalGradient.comp.glsl:104-171),
a direct-light proxy blind to shadows and indirect light. A-SVGF (Schied et
al. 2018) instead re-traces a sparse subset of the previous frame's samples
-- same pixel, camera, PCG seed and frame index, so the path reproduces bit
for bit -- under the CURRENT light and compares the new luminance with the
stored one. When nothing changed the difference is exactly zero.

One gradient sample per GRAD_STRATUM x GRAD_STRATUM pixel stratum, chosen by
a per-stratum per-frame PCG draw; the chosen current-frame pixel is
back-projected with the filter's own backprojection map, so the gradient
lands in current-frame screen space. The sparse normalized gradient is
box-filtered at stratum resolution and nearest-upsampled; the frame takes
max(phong, path). The JAX package's ops/pathgrad.py, op for op.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import (
    atrous,
    pathtrace,
    rng as rng_ops,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils.profiling import span

# Decorrelates the stratum-offset PCG stream from the path-tracing streams
# (pixel seeds use batch indices 0..sample_batches-1).
_OFFSET_BATCH = 0x9E3779B9
_NINTH = float(np.float32(1.0 / 9.0))


def stratum_pixels(h: int, w: int, frame_idx: int, stratum: int, device=None,
                   sr_offset: int = 0, sr_rows: int | None = None):
    """The gradient pixel of each stratum this frame: int64 (gh, gw) planes
    (gy, gx), one pixel drawn uniformly inside each stratum x stratum cell
    (clamped at the ragged image edge). ``sr_offset``/``sr_rows``: only
    stratum rows [sr_offset, sr_offset + sr_rows) of the global grid (a
    slab of the sharded frame; the draws are functions of the global
    stratum)."""
    gh = -(-h // stratum) if sr_rows is None else sr_rows
    gw = -(-w // stratum)
    sy = torch.arange(gh, device=device)[:, None].expand(gh, gw) + sr_offset
    sx = torch.arange(gw, device=device)[None, :].expand(gh, gw)
    state = rng_ops.seed_per_pixel(sx, sy, frame_idx, _OFFSET_BATCH)
    state, u1 = rng_ops.pcg_step(state)
    _, u2 = rng_ops.pcg_step(state)
    oy = torch.clamp_max((u1 * stratum).to(torch.int64), stratum - 1)
    ox = torch.clamp_max((u2 * stratum).to(torch.int64), stratum - 1)
    return torch.clamp_max(sy * stratum + oy, h - 1), torch.clamp_max(sx * stratum + ox, w - 1)


def upsample_nearest(img, stratum: int, h: int, w: int):
    """(gh, gw) stratum-resolution plane -> (h, w) by pixel replication."""
    up = img.repeat_interleave(stratum, dim=0).repeat_interleave(stratum, dim=1)
    return up[:h, :w]


def retrace_lambda(tri_data, light, frame_idx: int, cfg, l_old, pyg, pxg, vis_here, vis_then,
                   cam_pos_prev, cam_rot_prev, trace_fn=None):
    """The sparse normalized gradient at the chosen pixels (``pyg``,
    ``pxg``, global coordinates in the previous frame): re-trace that
    frame's sample (seed frame_idx - 1, its camera) under the current light
    and compare with its stored luminance ``l_old``. ``vis_here`` /
    ``vis_then``: the stratum's current primitive and the one the
    back-projected pixel saw; the gradient is 0 where they differ, on the
    background and at frame 0.

    ``trace_fn``: an explicit-pixel tracer with ops/pathtrace.trace_pixels'
    signature (the default); the kernel route passes the segment tracer's
    ops/cuda/wavefront.trace_pixels_wavefront, which gives the same values.
    """
    if trace_fn is None:
        trace_fn = pathtrace.trace_pixels
    if cfg.gbuffer_primary:
        # the stored frame traced bounce 0 off its own G-buffer, which is
        # gone; a full trace at aa_sigma = 0 is the same path bit for bit
        # (the jitter draws still advance the stream)
        cfg = dataclasses.replace(cfg, aa_sigma=0.0, gbuffer_primary=False)
    rgb_new = trace_fn(tri_data, cam_pos_prev, light, frame_idx - 1, pxg, pyg, cfg,
                       rotation=cam_rot_prev)
    l_new = atrous.luminance(rgb_new)
    diff = torch.abs(l_new - l_old)
    denom = torch.clamp_min(torch.maximum(l_new, l_old), 1e-20)
    lam = torch.clamp_max(diff / denom, 1.0)
    valid = (vis_here == vis_then) & (vis_here > 0.0) & (frame_idx > 0)
    return torch.where(valid, lam, torch.zeros_like(lam))


def path_gradient_pass(tri_data, light, frame_idx: int, cfg, noisy_lum_prev, cam_pos_prev,
                       cam_rot_prev, prev_y, prev_x, cur_vis, prev_vis, trace_fn=None,
                       row_offset: int = 0, src_row0: int = 0, row_pad=None):
    """The dense path-space lambda image (H, W) in [0, 1].

    ``noisy_lum_prev``: the previous frame's raw noisy luminance;
    ``cam_pos_prev``/``cam_rot_prev``: the camera it was traced with;
    ``prev_y``/``prev_x``: this frame's backprojection map; ``light``: the
    CURRENT light. ``trace_fn``: see :func:`retrace_lambda`.

    A row slab of the sharded frame (parallel/): ``cur_vis``, ``prev_y``
    and ``prev_x`` are the rows from global row ``row_offset`` on (whole
    stratum rows), ``noisy_lum_prev`` and ``prev_vis`` the previous frame's
    rows from global row ``src_row0`` on (ops/atrous.gather_window), and
    ``row_pad`` gives the stratum grid one neighbour row a side for the box
    filter (default: the edge clamp). The result is the slab's rows.
    """
    rows, w = cur_vis.shape
    stratum = cfg.gradient_stratum
    # a slab holds whole stratum rows, so no draw reaches past its last row
    gy, gx = stratum_pixels(row_offset + rows, w, frame_idx, stratum, cur_vis.device,
                            sr_offset=row_offset // stratum, sr_rows=-(-rows // stratum))
    gy = gy - row_offset
    pyg = prev_y[gy, gx].long()
    pxg = prev_x[gy, gx].long()
    lam = retrace_lambda(
        tri_data, light, frame_idx, cfg, atrous.gather_window(noisy_lum_prev, pyg, pxg, src_row0),
        pyg, pxg, cur_vis[gy, gx], atrous.gather_window(prev_vis, pyg, pxg, src_row0),
        cam_pos_prev, cam_rot_prev, trace_fn=trace_fn,
    )
    for _ in range(cfg.gradient_filter_iters):
        lam = box3_filter(lam, None if row_pad is None else row_pad(lam))
    return upsample_nearest(lam, stratum, rows, w)


def box3_filter(lam, padded=None):
    """One edge-clamped 3x3 box pass over the stratum grid. ``padded``: the
    grid with one neighbour row on each side (the sharded frame's exchanged
    halo); rows then shift within it, columns stay clamped."""
    with span("pathgrad.box3"):
        acc = torch.zeros_like(lam)
        n = lam.shape[0]
        for dy in (-1, 0, 1):
            rows = (atrous.shift_clamped(lam, dy, 0) if padded is None
                    else padded[1 + dy: 1 + dy + n])
            for dx in (-1, 0, 1):
                acc = acc + atrous.shift_clamped(rows, 0, dx)
        return acc * _NINTH
