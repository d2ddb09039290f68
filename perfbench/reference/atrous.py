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

The variance-guided filter (SVGF moments, a variance-normalised luminance
weight and variance propagation), albedo demodulation and the accumulation
ramp follow the JAX package's XLA ops (ops/atrous.py there), operation for
operation: that route made the golden snapshots.
"""

from __future__ import annotations

import numpy as np
import torch

from . import (
    camera as cam_ops,
)
from .barycentric import (
    barycentric_coordinates,
)
from .gbuffer import (
    pixel_grid,
)

H_BOX = float(np.float32(1.0 / 9.0))


def _f32(x) -> float:
    """A Python float holding the float32 value of ``x``."""
    return float(np.float32(x))


def shift_clamped(img, dy: int, dx: int):
    """img[clamp(y+dy), clamp(x+dx)] -- the shader's pixel clamp
    (temporalFiltering.comp.glsl:136)."""
    if dy == 0 and dx == 0:
        return img
    h, w = img.shape[0], img.shape[1]
    rows = torch.arange(h, device=img.device).add_(dy).clamp_(0, h - 1)
    cols = torch.arange(w, device=img.device).add_(dx).clamp_(0, w - 1)
    return img[rows][:, cols]


def _tap(img, j: int, i: int, k: int, halo: int):
    """The neighbour at (j k rows, i k columns). ``halo`` 0: edge-clamped on
    both axes. ``halo`` >= k: the rows carry ``halo`` neighbour rows on each
    side (a row-sharded slab, its halo exchanged by parallel/sharding.py),
    read without a clamp; the columns stay clamped."""
    if halo == 0:
        return shift_clamped(img, j * k, i * k)
    h = img.shape[0] - 2 * halo
    return shift_clamped(img[halo + j * k: halo + j * k + h], 0, i * k)


def _centre(img, halo: int):
    """The rows of ``img`` past its ``halo`` rows on each side."""
    return img[halo: img.shape[0] - halo] if halo else img


def atrous_iteration(color, normal_img, depth, k: int, cfg, halo: int = 0):
    """One wavelet iteration at stride k (waveletTransformOddIteration,
    temporalFiltering.comp.glsl:118-155). ``halo`` > 0: the inputs carry
    ``halo`` >= k neighbour rows on each side and the output drops them
    (the row-sharded frame, parallel/)."""
    cp, np_, dp = _centre(color, halo), _centre(normal_img, halo), _centre(depth, halo)
    num = torch.zeros_like(cp)
    den = torch.zeros_like(dp)
    # GLSL loops i (x offset) outer, j (y offset) inner -- same accumulation
    # order keeps fp summation comparable.
    for i in (-1, 0, 1):
        for j in (-1, 0, 1):
            cq = _tap(color, j, i, k, halo)
            nq = _tap(normal_img, j, i, k, halo)
            dq = _tap(depth, j, i, k, halo)
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
    return luminance_planes(rgb[..., 0], rgb[..., 1], rgb[..., 2])


def luminance_planes(r, g, b):
    """Planar-channel twin of :func:`luminance`."""
    return _LUMA[0] * r + _LUMA[1] * g + _LUMA[2] * b


# --- variance-guided filtering (SVGF extension; cfg.variance_guided) ------
#
# The reference's luminance weight has no variance normalization
# (temporalFiltering.comp.glsl:72-74); these functions implement the SVGF
# estimator (Schied et al. 2017, section 4): temporally accumulated
# luminance moments -> per-pixel variance -> a stddev-normalized w_l, with
# the variance filtered alongside the color.


def _box5(x, halo: int = 0):
    """5x5 edge-clamped box filter (spatial moment estimate for young
    history; a plain box as the cheap stand-in for SVGF's 7x7 bilateral).
    ``halo`` >= 2: rows pre-padded by the caller (the sharded frame)."""
    acc = torch.zeros_like(_centre(x, halo))
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            acc = acc + _tap(x, dy, dx, 1, halo)
    return acc * _f32(1.0 / 25.0)


def spatial_variance(lum, halo: int = 0):
    """5x5 spatial luminance variance estimate (young-history fallback).
    With ``halo`` the input rows are pre-padded and the output drops
    them."""
    s1 = _box5(lum, halo)
    s2 = _box5(lum * lum, halo)
    return torch.clamp_min(s2 - s1 * s1, 0.0)


def albedo_image(tri_data, visibility):
    """Primary-hit albedo per pixel from the visibility plane (primID+1,
    0 = background -> 1.0): the plain twin of the geometry kernel's albedo
    planes, used for albedo demodulation (cfg.demodulate_albedo)."""
    lut = torch.cat([torch.ones_like(tri_data.albedo[:1]), tri_data.albedo])
    return lut[visibility.to(torch.int64)]


def demod_scale(albedo, cfg):
    """Scalar demodulation factor per pixel: max(luminance(albedo), eps).
    The albedo's luminance, not its channels: the parity albedos have
    exact-zero channels, and a channel-wise division would blow up the
    sphere light's glow, which is added with pre-albedo throughput."""
    return torch.clamp_min(luminance(albedo), _f32(cfg.demod_eps))


def demodulate(color, scale):
    """color / demod_scale, broadcast over the channels."""
    return color / scale[..., None]


def modulate(color, scale):
    """Inverse of :func:`demodulate`: restore display radiance."""
    return color * scale[..., None]


def accumulate_moments(lum, prev_moments, prev_y, prev_x, frame_idx: int, cfg,
                       var_spatial=None, reproj=None):
    """Temporal EMA of the (mu1, mu2) luminance moments at the backprojected
    pixel; ``lum`` is the current frame's luminance plane. Returns
    (new_moments (H, W, 2), variance (H, W)).

    Variance = max(0, mu2 - mu1^2) from the accumulated moments; for the
    first cfg.variance_boost_frames frames a 5x5 spatial estimate of the
    current frame's moments substitutes. The frame index is a host int, so
    the spatial estimate is computed only in those frames (the JAX package
    computes it every frame and selects; the values are the same).
    ``var_spatial``: a precomputed :func:`spatial_variance` (the sharded
    frame's, over exchanged rows). ``reproj``: the previous moments already
    gathered at (prev_y, prev_x) (the sharded frame's
    parallel/sharding.reproject_rows_sharded); ``prev_moments`` is then not
    read."""
    m_now = torch.stack([lum, lum * lum], dim=-1)
    if frame_idx > 0:
        if reproj is None:
            reproj = prev_moments[prev_y, prev_x]
        a = np.float32(cfg.moments_alpha)
        m = reproj * float(np.float32(1.0) - a) + m_now * float(a)
    else:
        m = m_now
    if frame_idx >= cfg.variance_boost_frames:
        var = torch.clamp_min(m[..., 1] - m[..., 0] * m[..., 0], 0.0)
    else:
        var = spatial_variance(lum) if var_spatial is None else var_spatial
    return m, var


def normal_class(normal, vis):
    """Surface-consistency key from the quantized geometric normal
    (cfg.ramp_reset_mode == "normal"): each component banded into 31 bins
    and packed, so every sub-triangle of a flat surface shares its key
    while differently oriented surfaces differ. ``vis`` (primID + 1) keys
    the background to class 0. Returns an (H, W) float32 key plane (exact:
    keys < 2^15)."""

    def q(c):
        return ((c + 1.0) * 15.5).to(torch.int32).clamp(0, 30)

    key = (q(normal[..., 0]) * 31 + q(normal[..., 1])) * 31 + q(normal[..., 2])
    return torch.where(vis > 0, (key + 1).to(torch.float32), torch.zeros_like(vis))


def accumulate_age(prev_age, prev_y, prev_x, lam, frame_idx: int, cfg,
                   prev_vis, cur_vis, reproj=None, reproj_vis=None):
    """Per-pixel consecutive-history length N for the SVGF accumulation ramp
    (cfg.accumulation_ramp): N follows the backprojected history pixel,
    increments every frame, clamps at cfg.ramp_age_cap, and resets to 1 on
    frame 0, where the temporal gradient exceeds cfg.ramp_reset_lam, or
    where the consistency plane (visibility ids or :func:`normal_class`
    keys) of the history pixel differs from the current one. ``reproj`` /
    ``reproj_vis``: the previous age / consistency plane already gathered
    at (prev_y, prev_x) (the sharded frame); ``prev_age`` / ``prev_vis``
    are then not read."""
    if frame_idx <= 0:
        return torch.ones_like(lam)
    if reproj is None:
        reproj = prev_age[prev_y, prev_x]
    if reproj_vis is None:
        reproj_vis = prev_vis[prev_y, prev_x]
    n = torch.clamp_max(reproj + 1.0, _f32(cfg.ramp_age_cap))
    reset = (lam > _f32(cfg.ramp_reset_lam)) | (reproj_vis != cur_vis)
    return torch.where(reset, torch.ones_like(n), n)


def ramp_alpha(age, lam, cfg):
    """Blend weight of the CURRENT frame under the accumulation ramp:
    max(ramp_alpha_min, 1/N), composed with adaptive_alpha's gradient blend
    when both are on. Returns (H, W, 1) for broadcasting."""
    alpha = torch.clamp_min(1.0 / age, _f32(cfg.ramp_alpha_min))
    if cfg.adaptive_alpha:
        alpha = (1.0 - lam) * alpha + lam
    return alpha[..., None]


# 3x3 [1/4, 1/2, 1/4]^2 weights of the variance prefilter, as float32 products
_GAUSS3 = tuple(
    (dy, dx, _f32(np.float32(wy) * np.float32(wx)))
    for dy, wy in zip((-1, 0, 1), (0.25, 0.5, 0.25))
    for dx, wx in zip((-1, 0, 1), (0.25, 0.5, 0.25))
)


def _gauss3(x, halo: int = 0):
    """3x3 gaussian prefilter of the variance (SVGF eq. 5), edge-clamped,
    as a direct 9-tap sum in row-major tap order (``halo`` as in
    :func:`_box5`)."""
    g = torch.zeros_like(_centre(x, halo))
    for dy, dx, wgt in _GAUSS3:
        g = g + wgt * _tap(x, dy, dx, 1, halo)
    return g


def atrous_iteration_var(color, var, normal_img, depth, k: int, cfg, halo: int = 0):
    """One variance-guided wavelet iteration at stride k.

    Same taps, normal and depth weights as :func:`atrous_iteration`; the
    luminance weight is |l_p - l_q| over the gaussian-prefiltered stddev
    (SVGF eq. 5), and the variance is propagated as
    var' = sum (h w)^2 var_q / (sum h w)^2. Divides where the TPU kernel
    multiplies by reciprocals: the XLA route made the goldens. ``halo`` as
    in :func:`atrous_iteration`."""
    cp, np_, dp = _centre(color, halo), _centre(normal_img, halo), _centre(depth, halo)
    g = _gauss3(var, halo)
    lp = luminance(cp)
    denom_l = _f32(cfg.sigma_l) * torch.sqrt(g) + _f32(cfg.variance_eps)
    num = torch.zeros_like(cp)
    vnum = torch.zeros_like(g)
    den = torch.zeros_like(dp)
    for i in (-1, 0, 1):
        for j in (-1, 0, 1):
            cq = _tap(color, j, i, k, halo)
            nq = _tap(normal_img, j, i, k, halo)
            dq = _tap(depth, j, i, k, halo)
            vq = _tap(var, j, i, k, halo)
            w_n = torch.pow(
                torch.clamp_min(cam_ops.dot3(np_, nq), 0.0), cfg.sigma_n
            )
            w_z = torch.exp(-torch.abs(dp - dq) / cfg.sigma_z)
            w_l = torch.exp(-torch.abs(lp - luminance(cq)) / denom_l)
            hw = H_BOX * w_n * w_z * w_l
            num = num + hw[..., None] * cq
            vnum = vnum + hw * hw * vq
            den = den + hw
    return num / den[..., None], vnum / (den * den)


def atrous_filter_var(color, var, normal_img, depth, cfg):
    """All iterations of the variance-guided filter; returns (color', var')."""
    out, v = color, var
    for k in range(1, cfg.wavelet_iterations + 1):
        out, v = atrous_iteration_var(out, v, normal_img, depth, k, cfg)
    return out, v


def backproject_pixels(gbuf, lut_prev, view_prev, proj_prev, cfg, row_offset: int = 0):
    """Previous-frame integer pixel of each surface pixel
    (temporalFiltering.comp.glsl:213-239). Background keeps its own pixel.
    Returns int64 (py, px) planes of GLOBAL frame coordinates, clamped to
    the frame; ``row_offset``: the global row of the G-buffer's first row
    (a row slab of the sharded frame)."""
    h, w = cfg.height, cfg.width
    prim = gbuf.visibility.to(torch.int64)
    tri_prev = lut_prev[prim]
    v1p, v2p, v3p = tri_prev[..., 0, :], tri_prev[..., 1, :], tri_prev[..., 2, :]
    # Quirk: barycentrics of the CURRENT position against the PREVIOUS
    # vertices (temporalFiltering.comp.glsl:221-229).
    bary = barycentric_coordinates(gbuf.world_pos, v1p, v2p, v3p)
    world_prev = bary[..., 0:1] * v1p + bary[..., 1:2] * v2p + bary[..., 2:3] * v3p
    screen = cam_ops.world_to_pixel(world_prev, view_prev, proj_prev, w, h)

    own_y, own_x = pixel_grid(gbuf.visibility.shape[0], w, screen.device)
    own_y = own_y + row_offset
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


def gather_window(plane, prev_y, prev_x, row0: int = 0):
    """``plane`` gathered at (prev_y, prev_x), where ``plane`` holds the
    frame's rows from global row ``row0`` on: row prev_y - row0 clamped to
    the plane (a reprojection window of the sharded frame, or a whole
    plane at ``row0`` 0, where the clamp changes nothing)."""
    rows = (prev_y.long() - row0).clamp_(0, plane.shape[0] - 1)
    return plane[rows, prev_x.long()]


def temporal_accumulate_at(filtered, prev_image, prev_y, prev_x, frame_idx, lam, cfg,
                           age=None, reprojected=None):
    """EMA blend with precomputed backprojection coordinates: gather the
    history at (prev_y, prev_x) and blend (temporalFiltering.comp.glsl:
    242-263). ``lam`` drives adaptive alpha when cfg.adaptive_alpha (the
    reference's commented-out :246-248 wired up).

    ``age``: the current frame's history length (:func:`accumulate_age`)
    when cfg.accumulation_ramp; the blend then uses :func:`ramp_alpha`
    instead of the fixed ema_alpha.

    ``reprojected``: the history already gathered at (prev_y, prev_x) (the
    sharded frame); ``prev_image`` is then not read."""
    if frame_idx <= 0:
        return filtered
    if reprojected is None:
        reprojected = prev_image[prev_y, prev_x]
    if cfg.accumulation_ramp and age is not None:
        alpha = ramp_alpha(age, lam, cfg)
    else:
        alpha = _f32(cfg.ema_alpha)
        if cfg.adaptive_alpha:
            alpha = ((1.0 - lam) * alpha + lam)[..., None]
    return reprojected * (1.0 - alpha) + filtered * alpha


def temporal_accumulate(filtered, prev_image, gbuf, lut_prev, view_prev,
                        proj_prev, frame_idx, lam, cfg):
    """EMA blend against the reprojected history
    (temporalFiltering.comp.glsl:242-263)."""
    py, px = backproject_pixels(gbuf, lut_prev, view_prev, proj_prev, cfg)
    return temporal_accumulate_at(filtered, prev_image, py, px, frame_idx, lam, cfg)
