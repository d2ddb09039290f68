"""A-trous iterations and temporal blends.

:func:`atrous_iteration`, :func:`atrous_iteration_var`,
:func:`temporal_blend` and :func:`temporal_blend_ramp` launch the CUDA
kernels of ``csrc/atrous.cu`` for tensors on a CUDA device and run their
plain PyTorch versions (ops/atrous.py) for tensors on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import atrous
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import _build

atrous_iteration_plain = atrous.atrous_iteration
atrous_iteration_var_plain = atrous.atrous_iteration_var
temporal_blend_plain = atrous.temporal_accumulate_at


def _f32(x) -> float:
    return float(np.float32(x))


def temporal_blend_ramp_plain(filtered, prev_image, prev_y, prev_x, frame_idx, lam,
                              prev_age, prev_cons, cur_cons, cfg):
    """The ramp blend's plain version: ops.atrous.accumulate_age, then
    temporal_accumulate_at with that age. Returns (rgb, age)."""
    age = atrous.accumulate_age(prev_age, prev_y, prev_x, lam, frame_idx, cfg,
                                prev_cons, cur_cons)
    rgb = atrous.temporal_accumulate_at(filtered, prev_image, prev_y, prev_x,
                                        frame_idx, lam, cfg, age=age)
    return rgb, age


def atrous_iteration(color, normal_img, depth, k: int, cfg, out=None):
    """One wavelet iteration at stride k: (H, W, 3) color, (H, W, 3)
    normals, (H, W) depth -> (H, W, 3). ``out``: optional preallocated
    result buffer (CUDA only; it must not alias ``color``)."""
    if color.device.type == "cpu":
        return atrous_iteration_plain(color, normal_img, depth, k, cfg)
    h, w = depth.shape
    _build.check_cuda("color", color, torch.float32, (h, w, 3))
    _build.check_cuda("normal", normal_img, torch.float32, (h, w, 3))
    _build.check_cuda("depth", depth, torch.float32, (h, w))
    if out is None:
        out = torch.empty_like(color)
    _build.check_cuda("out", out, torch.float32, (h, w, 3))
    if out.data_ptr() == color.data_ptr():
        raise ValueError("atrous_iteration cannot run in place")
    _build.launch(
        "ptsf_atrous_iter",
        color.data_ptr(), normal_img.data_ptr(), depth.data_ptr(), out.data_ptr(),
        w, h, int(k),
        _f32(cfg.sigma_n), _f32(cfg.sigma_z), _f32(cfg.sigma_l),
    )
    return out


def atrous_filter(color, normal_img, depth, cfg):
    """All cfg.wavelet_iterations iterations (strides 1..n, main.cpp:1259),
    ping-ponging two result buffers on the card."""
    if color.device.type == "cpu":
        return atrous.atrous_filter(color, normal_img, depth, cfg)
    bufs = (torch.empty_like(color), torch.empty_like(color))
    out = color
    for k in range(1, cfg.wavelet_iterations + 1):
        out = atrous_iteration(out, normal_img, depth, k, cfg, out=bufs[k % 2])
    return out


def atrous_iteration_var(color, var, normal_img, depth, k: int, cfg, out=None):
    """One variance-guided wavelet iteration at stride k: (H, W, 3) color,
    (H, W) variance, (H, W, 3) normals, (H, W) depth -> (color', var').
    ``out``: optional preallocated (color', var') buffers (CUDA only; they
    must not alias the inputs)."""
    if color.device.type == "cpu":
        return atrous_iteration_var_plain(color, var, normal_img, depth, k, cfg)
    h, w = depth.shape
    _build.check_cuda("color", color, torch.float32, (h, w, 3))
    _build.check_cuda("var", var, torch.float32, (h, w))
    _build.check_cuda("normal", normal_img, torch.float32, (h, w, 3))
    _build.check_cuda("depth", depth, torch.float32, (h, w))
    if out is None:
        out = (torch.empty_like(color), torch.empty_like(var))
    out_c, out_v = out
    _build.check_cuda("out color", out_c, torch.float32, (h, w, 3))
    _build.check_cuda("out var", out_v, torch.float32, (h, w))
    if {out_c.data_ptr(), out_v.data_ptr()} & {color.data_ptr(), var.data_ptr()}:
        raise ValueError("atrous_iteration_var cannot run in place")
    _build.launch(
        "ptsf_atrous_iter_var",
        color.data_ptr(), var.data_ptr(), normal_img.data_ptr(), depth.data_ptr(),
        out_c.data_ptr(), out_v.data_ptr(), w, h, int(k),
        _f32(cfg.sigma_n), _f32(cfg.sigma_z), _f32(cfg.sigma_l), _f32(cfg.variance_eps),
    )
    return out_c, out_v


def atrous_filter_var(color, var, normal_img, depth, cfg):
    """All iterations of the variance-guided filter; returns (color',
    var'), ping-ponging two buffer pairs on the card."""
    if color.device.type == "cpu":
        return atrous.atrous_filter_var(color, var, normal_img, depth, cfg)
    bufs = tuple((torch.empty_like(color), torch.empty_like(var)) for _ in range(2))
    out = (color, var)
    for k in range(1, cfg.wavelet_iterations + 1):
        out = atrous_iteration_var(*out, normal_img, depth, k, cfg, out=bufs[k % 2])
    return out


def temporal_blend(filtered, prev_image, prev_y, prev_x, frame_idx, lam, cfg):
    """EMA of ``filtered`` with ``prev_image`` gathered at (prev_y, prev_x);
    frame 0 passes ``filtered`` through."""
    if filtered.device.type == "cpu":
        return temporal_blend_plain(
            filtered, prev_image, prev_y, prev_x, frame_idx, lam, cfg
        )
    h, w = lam.shape
    _build.check_cuda("filtered", filtered, torch.float32, (h, w, 3))
    _build.check_cuda("prev_image", prev_image, torch.float32, (h, w, 3))
    _build.check_cuda("prev_y", prev_y, torch.int32, (h, w))
    _build.check_cuda("prev_x", prev_x, torch.int32, (h, w))
    _build.check_cuda("lam", lam, torch.float32, (h, w))
    out = torch.empty_like(filtered)
    _build.launch(
        "ptsf_temporal_blend",
        filtered.data_ptr(), prev_image.data_ptr(), prev_y.data_ptr(),
        prev_x.data_ptr(), lam.data_ptr(), out.data_ptr(), w, h,
        _f32(cfg.ema_alpha),
        int(cfg.adaptive_alpha),
        int(frame_idx),
    )
    return out


def temporal_blend_ramp(filtered, prev_image, prev_y, prev_x, frame_idx, lam,
                        prev_age, prev_cons, cur_cons, cfg):
    """The blend under the accumulation ramp (cfg.accumulation_ramp):
    gathers image, age and consistency plane at (prev_y, prev_x), updates
    the age (reset where lam > cfg.ramp_reset_lam or the consistency planes
    differ) and blends with alpha = max(ramp_alpha_min, 1/age). Returns
    (rgb (H, W, 3), age (H, W))."""
    if not cfg.accumulation_ramp:
        raise ValueError("temporal_blend_ramp needs cfg.accumulation_ramp")
    if filtered.device.type == "cpu":
        return temporal_blend_ramp_plain(filtered, prev_image, prev_y, prev_x, frame_idx,
                                         lam, prev_age, prev_cons, cur_cons, cfg)
    h, w = lam.shape
    _build.check_cuda("filtered", filtered, torch.float32, (h, w, 3))
    _build.check_cuda("prev_image", prev_image, torch.float32, (h, w, 3))
    _build.check_cuda("prev_y", prev_y, torch.int32, (h, w))
    _build.check_cuda("prev_x", prev_x, torch.int32, (h, w))
    _build.check_cuda("lam", lam, torch.float32, (h, w))
    for name, t in (("prev_age", prev_age), ("prev_cons", prev_cons), ("cur_cons", cur_cons)):
        _build.check_cuda(name, t, torch.float32, (h, w))
    out = torch.empty_like(filtered)
    age = torch.empty_like(lam)
    _build.launch(
        "ptsf_temporal_blend_ramp",
        filtered.data_ptr(), prev_image.data_ptr(), prev_y.data_ptr(), prev_x.data_ptr(),
        lam.data_ptr(), prev_age.data_ptr(), prev_cons.data_ptr(), cur_cons.data_ptr(),
        out.data_ptr(), age.data_ptr(), w, h,
        _f32(cfg.ramp_alpha_min), _f32(cfg.ramp_reset_lam), _f32(cfg.ramp_age_cap),
        int(cfg.adaptive_alpha), int(frame_idx),
    )
    return out, age
