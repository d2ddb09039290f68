"""Shading functions: sky, normal-keyed albedo, Phong.

Direct behavioral ports of the reference shading math -- the "material
system" of the reference scene (raytrace.comp.glsl:95-163,
temporalGradient.comp.glsl:71-101).
"""

from __future__ import annotations

import torch

from .camera import (
    dot3,
    norm3,
)


def _rgb(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def sky_color(directions):
    """skyColor (raytrace.comp.glsl:95-107): vertical gradient above the
    horizon, dim constant below."""
    y = directions[..., 1:2]
    up = (1.0 - y) * _rgb([1.0, 1.0, 1.0], y) + y * _rgb([0.25, 0.5, 1.0], y)
    return torch.where(y > 0.0, up, torch.full_like(up, 0.03))


def albedo_from_normal(normals):
    """Hardcoded Cornell materials (raytrace.comp.glsl:155-163): walls whose
    geometric normal points +x are red, -x green, everything else 0.7 gray.
    Evaluated on the *unflipped* geometric normal, as in the reference."""
    nx = normals[..., 0:1]
    red = _rgb([1.0, 0.0, 0.0], normals)
    green = _rgb([0.0, 1.0, 0.0], normals)
    gray = _rgb([0.7, 0.7, 0.7], normals)
    return torch.where(nx > 0.99, red, torch.where(nx < -0.99, green, gray))


def faceforward(n, incident):
    """GLSL faceforward(N, I, Nref=N): flip n to oppose the incident
    direction (raytrace.comp.glsl:247)."""
    flip = dot3(incident, n)[..., None] < 0.0
    return torch.where(flip, n, -n)


def reflect(incident, n):
    """GLSL reflect(I, N) = I - 2*dot(N, I)*N."""
    return incident - 2.0 * dot3(n, incident)[..., None] * n


def pow128(x):
    """x**128 as seven squarings, the geometry kernel's form of the Phong
    exponent (within a few float32 ulps of a library pow)."""
    for _ in range(7):
        x = x * x
    return x


def phong(p, n, cam_pos, light_pos, light_color):
    """phongShading (temporalGradient.comp.glsl:71-101).

    Fixed 0.7-gray object color, ambient 0.1, specular 0.5 with exponent
    128, attenuation 1. Used only by the temporal-gradient estimator.
    """
    light_dir = light_pos - p
    light_dir = light_dir / norm3(light_dir, keepdim=True)

    ambient = 0.1 * light_color
    diff = torch.clamp_min(dot3(n, light_dir), 0.0)[..., None]
    diffuse = diff * light_color

    view_dir = cam_pos - p
    view_dir = view_dir / norm3(view_dir, keepdim=True)
    reflect_dir = reflect(-light_dir, n)
    spec = pow128(torch.clamp_min(dot3(view_dir, reflect_dir), 0.0))[..., None]
    specular = 0.5 * spec * light_color

    return (ambient + diffuse + specular) * 0.7
