"""A-trous wavelet filter with edge-stopping weights + temporal EMA, plain
PyTorch version (temporalFiltering.comp.glsl).

Per iteration k (1..9 -- note the reference uses LINEAR stride k, not the
classic 2^k, temporalFiltering.comp.glsl:135):
    3x3 taps at stride k, edge-clamped (temporalFiltering.comp.glsl:132-136)
    weight = dot(np, nq)^sigma_n            (normals, :61-63)
           * exp(-|dp - dq| / sigma_z)      (depth, :66-69)
           * exp(-||cp - cq|| / sigma_l)    (color, :72-74)
    out = sum(h w cq) / sum(h w), h = 1/9 box

After the last iteration the result is EMA-blended (alpha = 0.3 current)
against the previous frame's output, gathered at the backprojected pixel
(temporalFiltering.comp.glsl:213-263). Reference quirk kept: backprojection
barycentrics are computed against the PREVIOUS LUT vertices (:221-229),
unlike the gradient pass which uses current ones.

This is the parity subset; the variance-guided filter, albedo
demodulation and the accumulation ramp are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import (
    camera as cam_ops,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.barycentric import (
    barycentric_coordinates,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.gbuffer import (
    pixel_grid,
)

H_BOX = float(np.float32(1.0 / 9.0))


def shift_clamped(img, dy: int, dx: int):
    """img[clamp(y+dy), clamp(x+dx)] -- the shader's pixel clamp
    (temporalFiltering.comp.glsl:136)."""
    if dy == 0 and dx == 0:
        return img
    h, w = img.shape[0], img.shape[1]
    rows = torch.arange(h, device=img.device).add_(dy).clamp_(0, h - 1)
    cols = torch.arange(w, device=img.device).add_(dx).clamp_(0, w - 1)
    return img[rows][:, cols]


def atrous_iteration(color, normal_img, depth, k: int, cfg):
    """One wavelet iteration at stride k (waveletTransformOddIteration,
    temporalFiltering.comp.glsl:118-155)."""
    cp, np_, dp = color, normal_img, depth
    num = torch.zeros_like(cp)
    den = torch.zeros_like(dp)
    # GLSL loops i (x offset) outer, j (y offset) inner -- same accumulation
    # order keeps fp summation comparable.
    for i in (-1, 0, 1):
        for j in (-1, 0, 1):
            cq = shift_clamped(color, j * k, i * k)
            nq = shift_clamped(normal_img, j * k, i * k)
            dq = shift_clamped(depth, j * k, i * k)
            w_n = torch.pow(
                torch.clamp_min(cam_ops.dot3(np_, nq), 0.0), cfg.sigma_n
            )
            w_z = torch.exp(-torch.abs(dp - dq) / cfg.sigma_z)
            w_l = torch.exp(-cam_ops.norm3(cp - cq) / cfg.sigma_l)
            w = w_n * w_z * w_l
            num = num + (H_BOX * w)[..., None] * cq
            den = den + H_BOX * w
    # den >= h_box always (the center tap has weight 1), so no guard needed.
    return num / den[..., None]


def atrous_filter(color, normal_img, depth, cfg):
    """All cfg.wavelet_iterations iterations (strides 1..n, main.cpp:1259)."""
    out = color
    for k in range(1, cfg.wavelet_iterations + 1):
        out = atrous_iteration(out, normal_img, depth, k, cfg)
    return out


# Rec.709 luma coefficients (the SVGF paper's luminance).
_LUMA = tuple(float(np.float32(c)) for c in (0.2126, 0.7152, 0.0722))


def luminance(rgb):
    """(..., 3) -> (...) Rec.709 luminance."""
    return _LUMA[0] * rgb[..., 0] + _LUMA[1] * rgb[..., 1] + _LUMA[2] * rgb[..., 2]


def backproject_pixels(gbuf, lut_prev, view_prev, proj_prev, cfg):
    """Previous-frame integer pixel of each surface pixel
    (temporalFiltering.comp.glsl:213-239). Background keeps its own pixel.
    Returns int64 (py, px) planes."""
    h, w = gbuf.visibility.shape
    prim = gbuf.visibility.to(torch.int64)
    tri_prev = lut_prev[prim]
    v1p, v2p, v3p = tri_prev[..., 0, :], tri_prev[..., 1, :], tri_prev[..., 2, :]
    # Quirk: barycentrics of the CURRENT position against the PREVIOUS
    # vertices (temporalFiltering.comp.glsl:221-229).
    bary = barycentric_coordinates(gbuf.world_pos, v1p, v2p, v3p)
    world_prev = bary[..., 0:1] * v1p + bary[..., 1:2] * v2p + bary[..., 2:3] * v3p
    screen = cam_ops.world_to_pixel(world_prev, view_prev, proj_prev, w, h)

    own_y, own_x = pixel_grid(h, w, screen.device)
    background = gbuf.visibility < 1.0
    sx = torch.where(background, own_x.to(torch.float32), screen[..., 0])
    sy = torch.where(background, own_y.to(torch.float32), screen[..., 1])
    # ivec2 cast truncates toward zero (GLSL int()). The float clamp to
    # [-1, size] first keeps NaN and out-of-range values out of the cast
    # and changes no in-range result.
    px = sx.nan_to_num(-1.0).clamp(-1.0, float(w)).to(torch.int64)
    py = sy.nan_to_num(-1.0).clamp(-1.0, float(h)).to(torch.int64)
    # The reference relies on robust image access for out-of-view gathers;
    # clamping instead is a documented deviation: border pixels during
    # fast motion read the edge texel rather than black.
    return py.clamp(0, h - 1), px.clamp(0, w - 1)


def temporal_accumulate_at(filtered, prev_image, prev_y, prev_x, frame_idx, lam, cfg):
    """EMA blend with precomputed backprojection coordinates: gather the
    history at (prev_y, prev_x) and blend (temporalFiltering.comp.glsl:
    242-263). ``lam`` drives adaptive alpha when cfg.adaptive_alpha (the
    reference's commented-out :246-248 wired up)."""
    if frame_idx <= 0:
        return filtered
    reprojected = prev_image[prev_y, prev_x]
    alpha = float(np.float32(cfg.ema_alpha))
    if cfg.adaptive_alpha:
        alpha = ((1.0 - lam) * alpha + lam)[..., None]
    return reprojected * (1.0 - alpha) + filtered * alpha


def temporal_accumulate(filtered, prev_image, gbuf, lut_prev, view_prev,
                        proj_prev, frame_idx, lam, cfg):
    """EMA blend against the reprojected history
    (temporalFiltering.comp.glsl:242-263)."""
    py, px = backproject_pixels(gbuf, lut_prev, view_prev, proj_prev, cfg)
    return temporal_accumulate_at(filtered, prev_image, py, px, frame_idx, lam, cfg)
