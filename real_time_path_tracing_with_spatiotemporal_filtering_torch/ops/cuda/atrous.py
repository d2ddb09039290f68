"""A-trous iterations and temporal blends.

:func:`atrous_iteration`, :func:`atrous_iteration_var`,
:func:`temporal_blend` and :func:`temporal_blend_ramp` launch the CUDA
kernels of ``csrc/atrous.cu`` for tensors on a CUDA device and run their
plain PyTorch versions (ops/atrous.py) for tensors on the CPU.

The row-sharded frame (parallel/) runs them on a slab: the a-trous
iterations with ``halo`` exchanged neighbour rows on each side of their
inputs, the blends gathering from a history plane of other rows than the
output's (``src_row0``: the global row of its first row; its own height).
"""

from __future__ import annotations

import numpy as np
import torch

from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import atrous
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import _build

atrous_iteration_plain = atrous.atrous_iteration
atrous_iteration_var_plain = atrous.atrous_iteration_var


def _f32(x) -> float:
    return float(np.float32(x))


def _window_gather(planes, prev_y, prev_x, frame_idx, src_row0: int, rows: int):
    """``planes`` gathered at the backprojection when the history source
    is a window of other rows than the output's (None where not, or at
    frame 0, where nothing is gathered)."""
    if frame_idx <= 0 or (src_row0 == 0 and planes[0].shape[0] == rows):
        return [None] * len(planes)
    return [atrous.gather_window(p, prev_y, prev_x, src_row0) for p in planes]


def temporal_blend_plain(filtered, prev_image, prev_y, prev_x, frame_idx, lam, cfg,
                         src_row0: int = 0):
    """The blend's plain version: ops.atrous.temporal_accumulate_at,
    gathering from the source window (``src_row0``) when given one."""
    (reproj,) = _window_gather((prev_image,), prev_y, prev_x, frame_idx, src_row0,
                               lam.shape[0])
    return atrous.temporal_accumulate_at(filtered, prev_image, prev_y, prev_x, frame_idx, lam,
                                         cfg, reprojected=reproj)


def temporal_blend_ramp_plain(filtered, prev_image, prev_y, prev_x, frame_idx, lam,
                              prev_age, prev_cons, cur_cons, cfg, src_row0: int = 0):
    """The ramp blend's plain version: ops.atrous.accumulate_age, then
    temporal_accumulate_at with that age. Returns (rgb, age)."""
    img, age_g, cons = _window_gather((prev_image, prev_age, prev_cons), prev_y, prev_x,
                                      frame_idx, src_row0, lam.shape[0])
    age = atrous.accumulate_age(prev_age, prev_y, prev_x, lam, frame_idx, cfg,
                                prev_cons, cur_cons, reproj=age_g, reproj_vis=cons)
    rgb = atrous.temporal_accumulate_at(filtered, prev_image, prev_y, prev_x,
                                        frame_idx, lam, cfg, age=age, reprojected=img)
    return rgb, age


def _halo_rows(depth, k: int, halo: int) -> int:
    """The output rows of an iteration whose inputs carry ``halo`` rows on
    each side; raises unless halo is 0 or at least k."""
    if halo < 0 or 0 < halo < k:
        raise ValueError(f"halo {halo} must be 0 or at least the stride {k}")
    h = depth.shape[0] - 2 * halo
    if h < 1:
        raise ValueError(f"{depth.shape[0]} input rows hold no output row past halo {halo}")
    return h


def atrous_iteration(color, normal_img, depth, k: int, cfg, out=None, halo: int = 0):
    """One wavelet iteration at stride k: (H, W, 3) color, (H, W, 3)
    normals, (H, W) depth -> (H, W, 3). ``out``: optional preallocated
    result buffer (CUDA only; it must not alias ``color``). ``halo``: the
    inputs carry that many (>= k) neighbour rows above and below the H
    output rows."""
    if color.device.type == "cpu":
        return atrous_iteration_plain(color, normal_img, depth, k, cfg, halo=halo)
    h = _halo_rows(depth, k, halo)
    hin, w = depth.shape
    _build.check_cuda("color", color, torch.float32, (hin, w, 3))
    _build.check_cuda("normal", normal_img, torch.float32, (hin, w, 3))
    _build.check_cuda("depth", depth, torch.float32, (hin, w))
    if out is None:
        out = torch.empty((h, w, 3), dtype=torch.float32, device=color.device)
    _build.check_cuda("out", out, torch.float32, (h, w, 3))
    if out.data_ptr() == color.data_ptr():
        raise ValueError("atrous_iteration cannot run in place")
    _build.launch(
        "ptsf_atrous_iter",
        color.data_ptr(), normal_img.data_ptr(), depth.data_ptr(), out.data_ptr(),
        w, h, int(halo), int(k),
        _f32(cfg.sigma_n), _f32(cfg.sigma_z), _f32(cfg.sigma_l),
    )
    return out


def _slab_inputs(slab, k: int):
    """(pad, halo) of the iteration at stride k over ``slab``'s rows
    (pipeline/frame.FrameRows: halo(k) neighbour rows a side from pad);
    the whole frame when ``slab`` is None, whose kernels clamp at its edge."""
    halo = 0 if slab is None else slab.halo(k)
    if halo == 0:
        return (lambda x: x), 0
    return (lambda x: slab.pad(x, halo)), halo


def atrous_filter(color, normal_img, depth, cfg, slab=None):
    """All cfg.wavelet_iterations iterations (strides 1..n, main.cpp:1259),
    ping-ponging two result buffers on the card. ``slab``: the rows of a
    row slab (pipeline/frame.FrameRows), which gives each iteration's
    inputs their neighbour rows."""
    bufs = (torch.empty_like(color), torch.empty_like(color))
    out = color
    for k in range(1, cfg.wavelet_iterations + 1):
        pad, halo = _slab_inputs(slab, k)
        out = atrous_iteration(pad(out), pad(normal_img), pad(depth), k, cfg, out=bufs[k % 2],
                               halo=halo)
    return out


def atrous_iteration_var(color, var, normal_img, depth, k: int, cfg, out=None, halo: int = 0):
    """One variance-guided wavelet iteration at stride k: (H, W, 3) color,
    (H, W) variance, (H, W, 3) normals, (H, W) depth -> (color', var').
    ``out``: optional preallocated (color', var') buffers (CUDA only; they
    must not alias the inputs). ``halo`` as in :func:`atrous_iteration`."""
    if color.device.type == "cpu":
        return atrous_iteration_var_plain(color, var, normal_img, depth, k, cfg, halo=halo)
    h = _halo_rows(depth, k, halo)
    hin, w = depth.shape
    _build.check_cuda("color", color, torch.float32, (hin, w, 3))
    _build.check_cuda("var", var, torch.float32, (hin, w))
    _build.check_cuda("normal", normal_img, torch.float32, (hin, w, 3))
    _build.check_cuda("depth", depth, torch.float32, (hin, w))
    if out is None:
        f32 = dict(dtype=torch.float32, device=color.device)
        out = (torch.empty((h, w, 3), **f32), torch.empty((h, w), **f32))
    out_c, out_v = out
    _build.check_cuda("out color", out_c, torch.float32, (h, w, 3))
    _build.check_cuda("out var", out_v, torch.float32, (h, w))
    if {out_c.data_ptr(), out_v.data_ptr()} & {color.data_ptr(), var.data_ptr()}:
        raise ValueError("atrous_iteration_var cannot run in place")
    _build.launch(
        "ptsf_atrous_iter_var",
        color.data_ptr(), var.data_ptr(), normal_img.data_ptr(), depth.data_ptr(),
        out_c.data_ptr(), out_v.data_ptr(), w, h, int(halo), int(k),
        _f32(cfg.sigma_n), _f32(cfg.sigma_z), _f32(cfg.sigma_l), _f32(cfg.variance_eps),
    )
    return out_c, out_v


def atrous_filter_var(color, var, normal_img, depth, cfg, slab=None):
    """All iterations of the variance-guided filter; returns (color',
    var'), ping-ponging two buffer pairs on the card. ``slab`` as in
    :func:`atrous_filter`."""
    bufs = tuple((torch.empty_like(color), torch.empty_like(var)) for _ in range(2))
    out = (color, var)
    for k in range(1, cfg.wavelet_iterations + 1):
        pad, halo = _slab_inputs(slab, k)
        out = atrous_iteration_var(pad(out[0]), pad(out[1]), pad(normal_img), pad(depth), k, cfg,
                                   out=bufs[k % 2], halo=halo)
    return out


def temporal_blend(filtered, prev_image, prev_y, prev_x, frame_idx, lam, cfg, src_row0: int = 0):
    """EMA of ``filtered`` with ``prev_image`` gathered at (prev_y, prev_x);
    frame 0 passes ``filtered`` through. ``prev_image`` holds rows of the
    frame from global row ``src_row0`` on, of any number (default: the
    output's); a pixel gathers its row clamp(prev_y - src_row0)."""
    if filtered.device.type == "cpu":
        return temporal_blend_plain(
            filtered, prev_image, prev_y, prev_x, frame_idx, lam, cfg, src_row0
        )
    h, w = lam.shape
    src_h = prev_image.shape[0]
    _build.check_cuda("filtered", filtered, torch.float32, (h, w, 3))
    _build.check_cuda("prev_image", prev_image, torch.float32, (src_h, w, 3))
    _build.check_cuda("prev_y", prev_y, torch.int32, (h, w))
    _build.check_cuda("prev_x", prev_x, torch.int32, (h, w))
    _build.check_cuda("lam", lam, torch.float32, (h, w))
    out = torch.empty_like(filtered)
    _build.launch(
        "ptsf_temporal_blend",
        filtered.data_ptr(), prev_image.data_ptr(), prev_y.data_ptr(),
        prev_x.data_ptr(), lam.data_ptr(), out.data_ptr(), w, h, src_h, int(src_row0),
        _f32(cfg.ema_alpha),
        int(cfg.adaptive_alpha),
        int(frame_idx),
    )
    return out


def temporal_blend_ramp(filtered, prev_image, prev_y, prev_x, frame_idx, lam,
                        prev_age, prev_cons, cur_cons, cfg, src_row0: int = 0):
    """The blend under the accumulation ramp (cfg.accumulation_ramp):
    gathers image, age and consistency plane at (prev_y, prev_x), updates
    the age (reset where lam > cfg.ramp_reset_lam or the consistency planes
    differ) and blends with alpha = max(ramp_alpha_min, 1/age). Returns
    (rgb (H, W, 3), age (H, W)). ``prev_image``, ``prev_age`` and
    ``prev_cons`` hold rows of the frame from ``src_row0`` on, as in
    :func:`temporal_blend`."""
    if not cfg.accumulation_ramp:
        raise ValueError("temporal_blend_ramp needs cfg.accumulation_ramp")
    if filtered.device.type == "cpu":
        return temporal_blend_ramp_plain(filtered, prev_image, prev_y, prev_x, frame_idx,
                                         lam, prev_age, prev_cons, cur_cons, cfg, src_row0)
    h, w = lam.shape
    src_h = prev_image.shape[0]
    _build.check_cuda("filtered", filtered, torch.float32, (h, w, 3))
    _build.check_cuda("prev_image", prev_image, torch.float32, (src_h, w, 3))
    _build.check_cuda("prev_y", prev_y, torch.int32, (h, w))
    _build.check_cuda("prev_x", prev_x, torch.int32, (h, w))
    _build.check_cuda("lam", lam, torch.float32, (h, w))
    for name, t in (("prev_age", prev_age), ("prev_cons", prev_cons)):
        _build.check_cuda(name, t, torch.float32, (src_h, w))
    _build.check_cuda("cur_cons", cur_cons, torch.float32, (h, w))
    out = torch.empty_like(filtered)
    age = torch.empty_like(lam)
    _build.launch(
        "ptsf_temporal_blend_ramp",
        filtered.data_ptr(), prev_image.data_ptr(), prev_y.data_ptr(), prev_x.data_ptr(),
        lam.data_ptr(), prev_age.data_ptr(), prev_cons.data_ptr(), cur_cons.data_ptr(),
        out.data_ptr(), age.data_ptr(), w, h, src_h, int(src_row0),
        _f32(cfg.ramp_alpha_min), _f32(cfg.ramp_reset_lam), _f32(cfg.ramp_age_cap),
        int(cfg.adaptive_alpha), int(frame_idx),
    )
    return out, age
