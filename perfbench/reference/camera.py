"""Camera math: pinhole primary rays, view/projection matrices, reprojection.

The reference uses two subtly different camera models: the path tracer's
slope-tan(FOV) pinhole with a fixed -z forward (raytrace.comp.glsl:300,
314-320) and the raster pass's glm::perspective(2*FOV) (main.cpp:483, 1471).
The *image-forming* camera is the tracer's model (the G-buffer must be
pixel-aligned with the traced image, SURVEY.md section 7), while the raster
matrices are reproduced exactly for the depth channel and for worldToPixel
reprojection (temporalFiltering.comp.glsl:178-189).

Matrices are row-major: ``clip = proj @ view @ [p, 1]``. Products of a
matrix with per-pixel points are written out term by term
(``m[0]*x + m[1]*y + m[2]*z + m[3]``), the order the CUDA kernels use, so
the two agree bit for bit on the card. The 4x4 products go through
:func:`matmul_highest`, which pins full float32 (no TF32) on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def matmul_highest(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full float32: TF32 would bend rays on the card the way
    bf16 did on the TPU (a 4x4 projection off by ~0.1% shifts
    reprojections by a pixel)."""
    if a.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    return a @ b


def true_div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` rounded once, as the kernels and the CPU divide. PyTorch on
    CUDA multiplies by the rounded reciprocal when the divisor is a Python
    scalar, which differs from the division in the last bit."""
    return x / torch.tensor(s, dtype=x.dtype, device=x.device)


def fov_slope(fov: float) -> float:
    """float32 tan(fov), the ray slope of the tracer's pinhole."""
    return float(np.float32(math.tan(fov)))


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of a*b over the last axis of size 3, as (a0*b0 + a1*b1) + a2*b2."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def norm3(a: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean length over the last axis of size 3."""
    n = torch.sqrt(dot3(a, a))
    return n.unsqueeze(-1) if keepdim else n


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis of size 3."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def mat_apply(m: torch.Tensor, p: torch.Tensor, w: bool = True) -> torch.Tensor:
    """Rows of ``m`` against (..., 3) points: ``m[i,0]*x + m[i,1]*y +
    m[i,2]*z`` (+ ``m[i,3]`` when ``w``, the homogeneous 1). Returns
    (..., rows)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    rows = []
    for i in range(m.shape[0]):
        r = m[i, 0] * x + m[i, 1] * y + m[i, 2] * z
        if w:
            r = r + m[i, 3]
        rows.append(r)
    return torch.stack(rows, dim=-1)


def pixel_rays(px, py, width, height, fov, jitter_x=None, jitter_y=None,
               rotation=None):
    """Ray directions for pixel coordinates (raytrace.comp.glsl:314-320).

    ``px``/``py`` integer tensors of pixel indices (column, row). The sample
    point is the pixel center plus an optional jitter offset. Returns unit
    (..., 3) directions in world space; ``rotation`` is an optional (3, 3)
    camera->world basis (identity in the reference: forward is -z).
    """
    fx = px.to(torch.float32) + 0.5
    fy = py.to(torch.float32) + 0.5
    if jitter_x is not None:
        fx = fx + jitter_x
    if jitter_y is not None:
        fy = fy + jitter_y
    w = float(width)
    h = float(height)
    # screenUV with y flip (raytrace.comp.glsl:315-316); both axes divide by
    # height so x carries the aspect ratio.
    u = true_div(2.0 * fx - w, h)
    v = true_div(-(2.0 * fy - h), h)
    slope = fov_slope(fov)
    d = torch.stack([slope * u, slope * v, -torch.ones_like(u)], dim=-1)
    if rotation is not None:
        d = mat_apply(rotation, d, w=False)
    return d / norm3(d, keepdim=True)


def look_at(eye, center, up):
    """glm::lookAt, right-handed (used at main.cpp:1471)."""
    f = center - eye
    f = f / norm3(f)
    s = cross3(f, up)
    s = s / norm3(s)
    u = cross3(s, f)
    last = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float32,
                        device=eye.device)
    return torch.stack(
        [
            torch.cat([s, -dot3(s, eye)[None]]),
            torch.cat([u, -dot3(u, eye)[None]]),
            torch.cat([-f, dot3(f, eye)[None]]),
            last,
        ]
    )


def perspective(fovy, aspect, near, far, device=None):
    """glm::perspective, right-handed, GL depth convention (main.cpp:483).

    The reference does not define GLM_FORCE_DEPTH_ZERO_TO_ONE, so glm emits
    the OpenGL-style matrix with NDC z in [-1, 1]; Vulkan then consumes
    clip.z/clip.w directly as the depth value.
    """
    t = np.float32(math.tan(fovy / 2.0))
    a = np.float32(aspect) * t
    m = np.array(
        [
            [np.float32(1.0) / a, 0.0, 0.0, 0.0],
            [0.0, np.float32(1.0) / t, 0.0, 0.0],
            [0.0, 0.0, -(far + near) / (far - near),
             -2.0 * far * near / (far - near)],
            [0.0, 0.0, -1.0, 0.0],
        ],
        np.float32,
    )
    return torch.from_numpy(m).to(device)


def vulkan_perspective(fovy, aspect, near, far, device=None):
    """perspective() with the reference's y flip (main.cpp:1472)."""
    p = perspective(fovy, aspect, near, far, device=device)
    p[1, 1] = -p[1, 1]
    return p


def camera_view(position, rotation):
    """World->camera view matrix from a camera->world basis:
    [[R^T, -R^T p], [0, 1]]. With identity rotation this equals the
    reference's translate-only lookAt (main.cpp:1471)."""
    rt = rotation.T
    top = torch.cat([rt, -mat_apply(rt, position, w=False)[:, None]], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=torch.float32,
                          device=position.device)
    return torch.cat([top, bottom], dim=0)


def reference_view(camera_pos):
    """The per-frame view matrix: translate-only lookAt (main.cpp:1471).

    The reference looks at (x, y, z-6): a pure translation (the camera never
    rotates).
    """
    dev = camera_pos.device
    center = camera_pos + torch.tensor([0.0, 0.0, -6.0], device=dev)
    up = torch.tensor([0.0, 1.0, 0.0], device=dev)
    return look_at(camera_pos, center, up)


def world_to_clip(world_pos, view, proj):
    """clip = proj @ view @ [p, 1] for (..., 3) points."""
    return mat_apply(matmul_highest(proj, view), world_pos)


def world_to_pixel(world_pos, view, proj, width, height):
    """worldToPixel (temporalFiltering.comp.glsl:178-189).

    Returns float (..., 2) screen coordinates (x, y).
    """
    clip = world_to_clip(world_pos, view, proj)
    sx = (clip[..., 0] / clip[..., 3] * 0.5 + 0.5) * float(width)
    sy = (clip[..., 1] / clip[..., 3] * 0.5 + 0.5) * float(height)
    return torch.stack([sx, sy], dim=-1)


def ndc_depth(world_pos, view, proj):
    """Raster-equivalent depth: clip.z / clip.w.

    This is what the fixed-function pipeline writes into the D32 attachment
    that temporalFiltering.comp.glsl:123 reads.
    """
    clip = world_to_clip(world_pos, view, proj)
    return clip[..., 2] / clip[..., 3]
