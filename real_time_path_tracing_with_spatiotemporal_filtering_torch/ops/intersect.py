"""Ray/scene intersection by precomputed triangle planes.

The reference leans on VK_KHR_ray_query hardware traversal
(raytrace.comp.glsl:208-222). Here the nearest-hit query is a dense test of
every ray against every triangle's precomputed plane equations
(Havel-Herout style); for Cornell-class scenes this is exact and cheap.

Plane precomputation (per triangle with edges e1, e2 and normal n = e1 x e2):
    t  = (dot(n, v0) - dot(n, o)) / dot(n, d)
    u  = dot(n1, o) + t * dot(n1, d) + d1      n1 = (e2 x n) / |n|^2
    v  = dot(n2, o) + t * dot(n2, d) + d2      n2 = (n x e1) / |n|^2
hit iff u >= 0, v >= 0, u + v <= 1 and t in (0, t_max] -- the same
barycentric-inside test the hardware ray query commits.

The dot products are written out term by term in the order the CUDA
tracer uses, so the plain version and the kernels agree on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.camera import (
    cross3,
    dot3,
)


class TrianglePlanes(NamedTuple):
    """Precomputed per-triangle intersection constants (all (T, ...))."""

    v0: torch.Tensor       # (T, 3)
    e1: torch.Tensor       # (T, 3) v1 - v0
    e2: torch.Tensor       # (T, 3) v2 - v0
    n: torch.Tensor        # (T, 3) unnormalized geometric normal e1 x e2
    d0: torch.Tensor       # (T,)   dot(n, v0)
    n1: torch.Tensor       # (T, 3) barycentric-u plane normal
    d1: torch.Tensor       # (T,)   barycentric-u plane offset
    n2: torch.Tensor       # (T, 3) barycentric-v plane normal
    d2: torch.Tensor       # (T,)   barycentric-v plane offset


def build_triangle_planes(triangles: torch.Tensor) -> TrianglePlanes:
    """Precompute plane constants from (T, 3, 3) triangle vertices."""
    v0 = triangles[:, 0, :]
    e1 = triangles[:, 1, :] - v0
    e2 = triangles[:, 2, :] - v0
    n = cross3(e1, e2)
    inv_nn = 1.0 / dot3(n, n)[:, None]
    n1 = cross3(e2, n) * inv_nn
    n2 = cross3(n, e1) * inv_nn
    return TrianglePlanes(
        v0=v0, e1=e1, e2=e2, n=n,
        d0=dot3(n, v0),
        n1=n1, d1=-dot3(n1, v0),
        n2=n2, d2=-dot3(n2, v0),
    )


class HitRecord(NamedTuple):
    """Nearest-hit query result for a batch of rays (leading dims shared)."""

    t: torch.Tensor        # (...,)  hit distance (t_max where no hit)
    prim: torch.Tensor     # (...,)  int64 triangle index (0 where no hit)
    hit: torch.Tensor      # (...,)  bool
    bary_u: torch.Tensor   # (...,)  barycentric u of the committed hit
    bary_v: torch.Tensor   # (...,)  barycentric v of the committed hit


def _rows_dot(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(N, 3) x (T, 3) -> (N, T) dot products, term by term."""
    return (
        p[:, None, 0] * q[None, :, 0]
        + p[:, None, 1] * q[None, :, 1]
        + p[:, None, 2] * q[None, :, 2]
    )


def nearest_hit(planes: TrianglePlanes, origins, directions,
                t_max: float = 10000.0, eps: float = 1e-9) -> HitRecord:
    """Closest triangle along each ray (the rayQueryProceed loop's result).

    ``origins``/``directions``: (..., 3). Ties go to the lowest triangle
    index (``argmin`` takes the first minimum; the kernels use a strict
    ``<`` in triangle order).
    """
    batch_shape = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = directions.reshape(-1, 3)

    no = _rows_dot(o, planes.n)
    nd = _rows_dot(d, planes.n)
    n1o = _rows_dot(o, planes.n1)
    n1d = _rows_dot(d, planes.n1)
    n2o = _rows_dot(o, planes.n2)
    n2d = _rows_dot(d, planes.n2)

    parallel = torch.abs(nd) < eps
    safe_nd = torch.where(parallel, torch.full_like(nd, eps), nd)
    t = (planes.d0[None, :] - no) / safe_nd
    u = n1o + t * n1d + planes.d1[None, :]
    v = n2o + t * n2d + planes.d2[None, :]

    valid = (
        ~parallel
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > 0.0)
        & (t <= t_max)
    )
    t_cand = torch.where(valid, t, torch.full_like(t, 2.0 * t_max))
    prim = torch.argmin(t_cand, dim=-1, keepdim=True)
    t_hit = torch.gather(t_cand, -1, prim)[:, 0]
    hit = torch.gather(valid, -1, prim)[:, 0]
    bu = torch.gather(u, -1, prim)[:, 0]
    bv = torch.gather(v, -1, prim)[:, 0]
    prim = prim[:, 0]
    zero = torch.zeros_like(bu)
    return HitRecord(
        t=torch.where(hit, t_hit, torch.full_like(t_hit, t_max)).reshape(batch_shape),
        prim=torch.where(hit, prim, torch.zeros_like(prim)).reshape(batch_shape),
        hit=hit.reshape(batch_shape),
        bary_u=torch.where(hit, bu, zero).reshape(batch_shape),
        bary_v=torch.where(hit, bv, zero).reshape(batch_shape),
    )


def hit_position(planes: TrianglePlanes, rec: HitRecord) -> torch.Tensor:
    """World position of committed hits, via barycentrics like the reference
    (raytrace.comp.glsl:133-139): p = v0 + u*e1 + v*e2."""
    v0 = planes.v0[rec.prim]
    e1 = planes.e1[rec.prim]
    e2 = planes.e2[rec.prim]
    return v0 + rec.bary_u[..., None] * e1 + rec.bary_v[..., None] * e2


def ray_sphere(origins, directions, center, radius: float):
    """checkRayLightIntersection (raytrace.comp.glsl:168-198).

    Returns (hit: bool, t: nearest positive root). Matches the reference:
    a = dot(d, d) (not assumed 1), smallest positive of the two roots, no
    far-plane clamp -- and, per the reference quirk, callers apply it
    regardless of triangle occlusion.
    """
    oc = origins - center
    a = dot3(directions, directions)
    b = 2.0 * dot3(oc, directions)
    c = dot3(oc, oc) - radius * radius
    disc = b * b - 4.0 * a * c
    sqrt_d = torch.sqrt(torch.clamp_min(disc, 0.0))
    t1 = (-b - sqrt_d) / (2.0 * a)
    t2 = (-b + sqrt_d) / (2.0 * a)
    t = torch.where(t1 > 0.0, t1, t2)
    hit = (disc >= 0.0) & (t > 0.0)
    return hit, torch.where(hit, t, torch.zeros_like(t))
