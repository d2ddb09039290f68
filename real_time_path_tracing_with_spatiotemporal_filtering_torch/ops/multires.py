"""Multi-resolution indirect illumination (cfg.indirect_split), plain PyTorch.

Direct light is traced per pixel, indirect light on a coarse grid: the
first ``indirect_split`` segments run at full resolution (truncated, with
the path throughput at the truncation point), the whole path only at every
``indirect_stride``-th pixel. Seeds and draws are pure functions of the
global pixel and the draw order (ops/rng.py), so the coarse trace's first
segments equal the truncated trace at the same pixels bit for bit, and

    resid = full_length(coarse px) - truncated(coarse px)

is exactly the radiance of the segments past the split. Divided by the
truncation throughput it loses the full-res albedo texture; a joint
bilateral 2x2 tent (bilinear weights times a depth and a normal edge stop,
guided by the G-buffer) upsamples it, and the full-res throughput
re-modulates it (:func:`combine_planes`). Under cfg.indirect_jitter the
coarse grid's phase changes every frame (:func:`grid_phase`).

The JAX package's ops/multires.py, op for op, including one property of
its phased expansion (:func:`_expand`): the east-neighbour planes are
padded with their own first column, not the base plane's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import (
    camera as cam_ops,
    pathtrace,
    rng as rng_ops,
)

# Throughput demodulation guard: channels with |thru| below this carry a
# residual of at most thru * L_max ~ 1e-5.
_THRU_EPS = float(np.float32(1e-6))

# Decorrelates the per-frame grid-phase PCG stream from the pixel streams and
# from ops/pathgrad's stratum offsets.
_JITTER_BATCH = 0x85EBCA6B


def grid_phase(frame_idx: int, stride: int) -> tuple[int, int]:
    """The coarse grid's phase (oy, ox) in [0, stride)^2 this frame
    (cfg.indirect_jitter): a PCG hash of the frame index alone, computed on
    the host (the frame index is a host int), so the frame waits for no
    device read."""
    state = rng_ops.seed_per_pixel(0, 0, frame_idx, _JITTER_BATCH)
    state, u1 = rng_ops.pcg_step(state)
    _, u2 = rng_ops.pcg_step(state)
    oy = min(int((u1 * stride).to(torch.int32)), stride - 1)
    ox = min(int((u2 * stride).to(torch.int32)), stride - 1)
    return oy, ox


def _subsample(t, s: int, phase=None):
    """``t[oy::s, ox::s]`` (phase (0, 0) when None); trailing axes pass
    through. With s | H and s | W (the config checks it under jitter) the
    shape is (H / s, W / s)."""
    oy, ox = (0, 0) if phase is None else phase
    return t[oy::s, ox::s]


def coarse_grid(height: int, width: int, stride: int, device=None):
    """Global (py, px) int64 coordinates of the coarse grid: every
    ``stride``-th pixel from (0, 0), (ceil(H/s), ceil(W/s)) each."""
    hc, wc = -(-height // stride), -(-width // stride)
    py = (torch.arange(hc, device=device) * stride)[:, None].expand(hc, wc)
    px = (torch.arange(wc, device=device) * stride)[None, :].expand(hc, wc)
    return py, px


def _shift_next(c, axis: int):
    """c[i+1] along ``axis`` with edge clamp."""
    n = c.shape[axis]
    return torch.cat([c.narrow(axis, 1, n - 1), c.narrow(axis, n - 1, 1)], dim=axis)


def _expand(c, stride: int, out_h: int, out_w: int, phase=None, top_row=None):
    """Nearest (hold) expansion of a coarse plane: out[y, x] =
    c[floor((y - oy) / s), floor((x - ox) / s)], the row index -1 resolved
    to ``top_row`` (default c[0]) and the column index -1 to column 0 of the
    plane after the top row was added: for the east planes (c01, c11) that
    is their own first column, as in the JAX package (ops/multires.py:127
    there), kept for parity."""
    if stride > 1:
        if phase is not None:
            oy, ox = phase
            top = c[:1] if top_row is None else top_row
            c = torch.cat([top, c], dim=0)
            c = torch.cat([c[:, :1], c], dim=1)
            c = c.repeat_interleave(stride, dim=0).repeat_interleave(stride, dim=1)
            y0, x0 = stride - oy, stride - ox
            return c[y0:y0 + out_h, x0:x0 + out_w]
        c = c.repeat_interleave(stride, dim=0).repeat_interleave(stride, dim=1)
    return c[:out_h, :out_w]


def _int_pow(x, p: int):
    """x**p by repeated squaring (static integer exponent)."""
    if p == 0:
        return torch.ones_like(x)
    acc = None
    base = x
    while p:
        if p & 1:
            acc = base if acc is None else acc * base
        p >>= 1
        if p:
            base = base * base
    return acc


def _edge_pad(c):
    """One edge-clamped row on each side of ``c``."""
    return torch.cat([c[:1], c, c[-1:]], dim=0)


def bilateral_upsample(coarse_planes, guide_coarse, guide_full, cfg, phase=None, row_pad=None):
    """Joint-bilateral 2x2 tent upsample of (Hc, Wc) planes to (H, W).
    ``guide_coarse`` / ``guide_full``: (nx, ny, nz, depth) plane tuples at
    coarse and full resolution. Where every edge stop rejects all four
    neighbours the plain bilinear tent is used. Coarse pixels pass through
    unchanged at any ``phase``. ``row_pad``: c -> (Hc + 2, Wc), one
    neighbour row on each side (default: the edge clamp); the sharded frame
    passes its 1-coarse-row halo exchange, edge-clamped at the frame's top
    and bottom, so a slab's upsample equals those rows of the frame's (the
    row index mod the stride is the local one: slabs start on a multiple
    of the stride)."""
    row_pad = _edge_pad if row_pad is None else row_pad
    s = cfg.indirect_stride
    h, w = guide_full[0].shape
    dev = guide_full[0].device
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    if phase is not None:
        ys = (ys - phase[0]) % s
        xs = (xs - phase[1]) % s
    fy = cam_ops.true_div((ys % s).to(torch.float32), float(s))[:, None]
    fx = cam_ops.true_div((xs % s).to(torch.float32), float(s))[None, :]
    bilin = ((1.0 - fy) * (1.0 - fx), (1.0 - fy) * fx, fy * (1.0 - fx), fy * fx)

    def four_neighbors(c):
        padded = row_pad(c)
        top = padded[0:1]
        c10 = padded[2:]
        c01 = _shift_next(c, 1)
        c11 = _shift_next(c10, 1)
        if phase is None:
            return tuple(_expand(v, s, h, w) for v in (c, c01, c10, c11))
        return (
            _expand(c, s, h, w, phase, top_row=top),
            _expand(c01, s, h, w, phase, top_row=_shift_next(top, 1)),
            _expand(c10, s, h, w, phase, top_row=c[:1]),
            _expand(c11, s, h, w, phase, top_row=_shift_next(c[:1], 1)),
        )

    nxf, nyf, nzf, zf = guide_full
    guide_n = [four_neighbors(g) for g in guide_coarse]
    inv_sz = float(np.float32(1.0 / cfg.indirect_sigma_z))
    weights = []
    for k in range(4):
        ndot = nxf * guide_n[0][k] + nyf * guide_n[1][k] + nzf * guide_n[2][k]
        w_n = _int_pow(torch.clamp_min(ndot, 0.0), cfg.indirect_normal_pow)
        w_z = torch.exp(-torch.abs(zf - guide_n[3][k]) * inv_sz)
        weights.append(bilin[k] * w_n * w_z)
    den = weights[0] + weights[1] + weights[2] + weights[3]
    ok = den > float(np.float32(1e-8))
    inv_den = 1.0 / torch.clamp_min(den, float(np.float32(1e-20)))

    out = []
    for c in coarse_planes:
        vals = four_neighbors(c)
        num = (weights[0] * vals[0] + weights[1] * vals[1] + weights[2] * vals[2]
               + weights[3] * vals[3])
        # every edge stop rejected all four neighbours: the plain bilinear tent
        num_b = bilin[0] * vals[0] + bilin[1] * vals[1] + bilin[2] * vals[2] + bilin[3] * vals[3]
        out.append(torch.where(ok, num * inv_den, num_b))
    return tuple(out)


def combine_planes(trunc_pl, thru_pl, full_c_pl, guide_full, cfg, phase=None, row_pad=None):
    """The multi-res estimate from per-channel planes: ``trunc_pl`` /
    ``thru_pl`` the full-res (H, W) triples of the truncated trace,
    ``full_c_pl`` the coarse (Hc, Wc) triple of the full-length trace,
    ``guide_full`` (nx, ny, nz, depth), ``phase`` the coarse grid's,
    ``row_pad`` as in :func:`bilateral_upsample`. Returns the (r, g, b)
    noisy planes."""
    s = cfg.indirect_stride
    thru_c = tuple(_subsample(t, s, phase) for t in thru_pl)
    resid = tuple(
        (fc - _subsample(t, s, phase)) / torch.clamp_min(tc, _THRU_EPS)
        for fc, t, tc in zip(full_c_pl, trunc_pl, thru_c)
    )
    guide_coarse = tuple(_subsample(g, s, phase) for g in guide_full)
    up = bilateral_upsample(resid, guide_coarse, guide_full, cfg, phase=phase, row_pad=row_pad)
    return tuple(t + u * th for t, u, th in zip(trunc_pl, up, thru_pl))


def split_cfgs(cfg):
    """The configs of the truncated full-res trace and of the coarse tail."""
    split_cfg = dataclasses.replace(cfg, max_bounces=cfg.indirect_split, truncate_radiance=True,
                                    indirect_split=0, indirect_jitter=False)
    tail_cfg = dataclasses.replace(cfg, indirect_split=0, indirect_jitter=False)
    return split_cfg, tail_cfg


def coarse_pixels(cfg, phase, device=None, row_offset: int = 0, rows: int | None = None):
    """The coarse tail's global (py, px) pixels, at ``phase``; with
    ``row_offset``/``rows``, those of the slab of ``rows`` rows from global
    row ``row_offset`` on (a multiple of the stride)."""
    py, px = coarse_grid(cfg.height if rows is None else rows, cfg.width, cfg.indirect_stride,
                         device)
    py = py + row_offset
    if phase is not None:
        py, px = py + phase[0], px + phase[1]
    return py, px


def multires_noisy(tri_data, camera_pos, light, frame_idx: int, cfg, normal_img, depth,
                   rotation=None, primary=None, trace_pass=None, trace_fn=None,
                   row_offset: int = 0, rows: int | None = None, row_pad=None):
    """The multi-res noisy estimate (H, W, 3): the full-res truncated trace
    and the coarse full-length trace, combined by :func:`combine_planes`.
    ``normal_img`` (H, W, 3) and ``depth`` (H, W) guide the upsample.
    ``primary``: the full-res G-buffer planes (vis, world_pos, n_geo,
    albedo) of cfg.gbuffer_primary; the coarse trace takes them subsampled
    on its grid.

    ``trace_pass`` / ``trace_fn``: the full-frame and the explicit-pixel
    tracer, with ops/pathtrace.path_trace_pass' and trace_pixels'
    signatures (the defaults: the JAX package's multires_noisy_xla); the
    kernel route passes the segment tracer's (ops/cuda/wavefront), as the
    JAX package's multires_noisy_wavefront does.

    ``row_offset``/``rows``/``row_pad``: the slab of ``rows`` rows from
    global row ``row_offset`` on (the sharded frame; ``row_offset`` a
    multiple of the stride, so the slab's coarse grid is its rows of the
    frame's), with ``row_pad`` as in :func:`bilateral_upsample`."""
    trace_pass = pathtrace.path_trace_pass if trace_pass is None else trace_pass
    trace_fn = pathtrace.trace_pixels if trace_fn is None else trace_fn
    split_cfg, tail_cfg = split_cfgs(cfg)
    s = cfg.indirect_stride
    phase = grid_phase(frame_idx, s) if cfg.indirect_jitter else None
    prim_c = None
    if primary is not None:
        prim_c = tuple(_subsample(p, s, phase) for p in primary)
    slab = {} if rows is None else dict(row_offset=row_offset, rows=rows)
    trunc, thru = trace_pass(tri_data, camera_pos, light, frame_idx, split_cfg, rotation=rotation,
                             emit_throughput=True, primary=primary, **slab)
    py_c, px_c = coarse_pixels(cfg, phase, camera_pos.device, row_offset, rows)
    full_c = trace_fn(tri_data, camera_pos, light, frame_idx, px_c, py_c, tail_cfg,
                      rotation=rotation, primary=prim_c)
    guide_full = (normal_img[..., 0], normal_img[..., 1], normal_img[..., 2], depth)
    noisy = combine_planes(
        tuple(trunc[..., i] for i in range(3)), tuple(thru[..., i] for i in range(3)),
        tuple(full_c[..., i] for i in range(3)), guide_full, cfg, phase=phase, row_pad=row_pad,
    )
    return torch.stack(noisy, dim=-1)
