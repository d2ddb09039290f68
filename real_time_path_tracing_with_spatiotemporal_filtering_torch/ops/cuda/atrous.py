"""A-trous iteration and temporal blend.

:func:`atrous_iteration` and :func:`temporal_blend` launch the CUDA kernels
of ``csrc/atrous.cu`` for tensors on a CUDA device and run their plain
PyTorch versions (ops/atrous.py) for tensors on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import atrous
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import _build

atrous_iteration_plain = atrous.atrous_iteration
temporal_blend_plain = atrous.temporal_accumulate_at


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
        float(np.float32(cfg.sigma_n)),
        float(np.float32(cfg.sigma_z)),
        float(np.float32(cfg.sigma_l)),
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
        float(np.float32(cfg.ema_alpha)),
        int(cfg.adaptive_alpha),
        int(frame_idx),
    )
    return out
