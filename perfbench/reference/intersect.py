"""Ray/scene intersection by precomputed triangle planes.

The reference leans on VK_KHR_ray_query hardware traversal
(raytrace.comp.glsl:208-222). Here the nearest-hit query is either a dense
test of every ray against every triangle's precomputed plane equations
(Havel-Herout style; exact and cheap for Cornell-class scenes) or, for
scenes of :data:`BVH_MIN_TRIANGLES` and more, a walk of the scene's LBVH
(built and packed by scene/lbvh.py). Both run the same triangle test
(:func:`_plane_test`) and commit the least (t, triangle index), so they
return the same record: :func:`scene_nearest_hit` and :func:`scene_occluded`
choose, and every nearest-hit and shadow query of the frame goes through
them.

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

from .camera import (
    cross3,
    dot3,
)


# From here on both routes walk the LBVH for every nearest-hit and shadow
# query. The smallest scene measured where both LBVH kernels beat the dense
# ones (subdivided_cornell(2), 1920x1080 on an H100 by chip_smoke.py: the
# geometry kernel 2.9-6.0x, the segment tracer 1.6-1.9x); on the
# 32-triangle Cornell box the one-launch dense trace is 1.6-2.0x faster.
# Below it the dense test (and the dense kernels, whose tables hold 291 and
# 454 triangles) serve every query.
BVH_MIN_TRIANGLES = 128

# Entries of a walk's stack (per CUDA thread: local memory, csrc/bvh.cuh).
# A walk holds at most one entry per tree level, so scene/lbvh.pack_bvh_nodes
# refuses trees this deep.
MAX_STACK = 64

_NO_HIT = 2**62  # a walk's best-prim sentinel: above every triangle index


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


def _plane_test(o, d, n, d0, n1, d1, n2, d2, t_max, eps):
    """The ray/triangle test on broadcast (ray, triangle) pairs: rays o, d
    (..., 3) against plane constants n, n1, n2 (..., 3) and d0, d1, d2
    (...). Returns (valid, t, u, v). The dense test and the walk both call
    it, so they compute the same bits."""
    no, nd = dot3(o, n), dot3(d, n)
    n1o, n1d = dot3(o, n1), dot3(d, n1)
    n2o, n2d = dot3(o, n2), dot3(d, n2)
    parallel = torch.abs(nd) < eps
    safe_nd = torch.where(parallel, torch.full_like(nd, eps), nd)
    t = (d0 - no) / safe_nd
    u = n1o + t * n1d + d1
    v = n2o + t * n2d + d2
    valid = ~parallel & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0) & (t <= t_max)
    return valid, t, u, v


def nearest_hit(planes: TrianglePlanes, origins, directions,
                t_max: float = 10000.0, eps: float = 1e-9) -> HitRecord:
    """Closest triangle along each ray (the rayQueryProceed loop's result),
    by the dense test of every (ray, triangle) pair.

    ``origins``/``directions``: (..., 3). Ties go to the lowest triangle
    index (``argmin`` takes the first minimum; the kernels use a strict
    ``<`` in triangle order).
    """
    batch_shape = origins.shape[:-1]
    o = origins.reshape(-1, 3)[:, None]
    d = directions.reshape(-1, 3)[:, None]
    valid, t, u, v = _plane_test(
        o, d, planes.n[None], planes.d0[None], planes.n1[None], planes.d1[None],
        planes.n2[None], planes.d2[None], t_max, eps,
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


# --- the LBVH walk -------------------------------------------------------
# The packed tree (scene/lbvh.PackedBVH): ``nodes`` (max(T-1, 1), 16) rows of
# the left child's box (min xyz, max xyz), the right child's box and the two
# child ids as int32 bits (a child id < 0 is the leaf of triangle -1 - id);
# ``tris`` (T, 12) rows n, d0, n1, d1, n2, d2.


def _walk(bvh, o, d, t_max, eps, cap=None, mask=None):
    """Lockstep stack walk of the rays in ``mask`` (all when None). Each
    step pops one node per active ray and handles both children at once:
    the inclusive slab test of both boxes, the triangle test of leaf
    children (the better of the two commits), and the push of internal
    children (the nearer on top); then the rays whose stack is empty
    leave. A step has one host sync (that compaction) and a fixed number
    of operations. Nearest hit when ``cap`` is None: returns (lanes, t,
    prim, u, v) of the walked lanes (prim _NO_HIT for a miss); otherwise
    any hit at t <= cap: returns (lanes, hit)."""
    dev = o.device
    lanes = (torch.arange(o.shape[0], device=dev) if mask is None
             else torch.nonzero(mask.reshape(-1))[:, 0])
    o, d = o[lanes], d[lanes]
    inv = 1.0 / torch.where(torch.abs(d) < 1e-20, torch.full_like(d, 1e-20), d)
    m = lanes.shape[0]
    nodes = bvh.nodes
    box_min = nodes[:, [0, 1, 2, 6, 7, 8]].reshape(-1, 2, 3)
    box_max = nodes[:, [3, 4, 5, 9, 10, 11]].reshape(-1, 2, 3)
    child = nodes.view(torch.int32)[:, 12:14].to(torch.int64)
    # one spare column: a step writes its second push unconditionally
    stack = torch.zeros((m, MAX_STACK + 1), dtype=torch.int64, device=dev)
    sp = torch.ones(m, dtype=torch.int64, device=dev)
    any_hit = cap is not None
    best_t = cap.reshape(-1)[lanes].clone() if any_hit else torch.full((m,), t_max, device=dev)
    best_p = torch.full((m,), _NO_HIT, dtype=torch.int64, device=dev)
    best_u = torch.zeros(m, device=dev)
    best_v = torch.zeros(m, device=dev)
    act = torch.arange(m, device=dev)
    while act.numel():
        sp_a = sp[act] - 1
        node = stack[act, sp_a]
        ch = child[node]
        oa, ba = o[act][:, None], best_t[act]
        ia = inv[act][:, None]
        t0 = (box_min[node] - oa) * ia
        t1 = (box_max[node] - oa) * ia
        tmin = torch.minimum(t0, t1).amax(-1)
        tmax = torch.maximum(t0, t1).amin(-1)
        hit = (tmax >= torch.clamp_min(tmin, 0.0)) & (tmin <= ba[:, None])
        # leaf children: both tested, the better (t, prim) of the valid ones
        leaf = ch < 0
        prim = torch.where(leaf, -1 - ch, torch.zeros_like(ch))
        rows = bvh.tris[prim]
        valid, t, u, v = _plane_test(oa, d[act][:, None], rows[..., 0:3], rows[..., 3],
                                     rows[..., 4:7], rows[..., 7], rows[..., 8:11],
                                     rows[..., 11], t_max, eps)
        valid &= hit & leaf
        # internal children: push the farther, then the nearer
        inner = hit & ~leaf
        near_l = tmin[:, 0] <= tmin[:, 1]
        both = inner[:, 0] & inner[:, 1]
        stack[act, sp_a] = torch.where(
            both, torch.where(near_l, ch[:, 1], ch[:, 0]),
            torch.where(inner[:, 0], ch[:, 0], ch[:, 1]),
        )
        stack[act, sp_a + 1] = torch.where(near_l, ch[:, 0], ch[:, 1])
        sp_new = sp_a + (inner[:, 0] | inner[:, 1]).to(torch.int64) + both.to(torch.int64)
        if any_hit:  # the first hit within the cap ends the ray's walk
            found = (valid & (t <= ba[:, None])).any(-1)
            best_p[act] = torch.where(found, torch.zeros_like(sp_a), best_p[act])
            sp[act] = torch.where(found, torch.zeros_like(sp_new), sp_new)
        else:
            t_c = torch.where(valid, t, torch.full_like(t, float("inf")))
            p_c = torch.where(valid, prim, torch.full_like(prim, _NO_HIT))
            right = (t_c[:, 1] < t_c[:, 0]) | ((t_c[:, 1] == t_c[:, 0]) & (p_c[:, 1] < p_c[:, 0]))
            side = right.to(torch.int64)[:, None]
            t_s, p_s = t_c.gather(1, side)[:, 0], p_c.gather(1, side)[:, 0]
            better = (p_s != _NO_HIT) & ((t_s < ba) | ((t_s == ba) & (p_s < best_p[act])))
            best_t[act] = torch.where(better, t_s, ba)
            best_p[act] = torch.where(better, p_s, best_p[act])
            best_u[act] = torch.where(better, u.gather(1, side)[:, 0], best_u[act])
            best_v[act] = torch.where(better, v.gather(1, side)[:, 0], best_v[act])
            sp[act] = sp_new
        act = act[sp[act] > 0]
    if any_hit:
        return lanes, best_p != _NO_HIT
    return lanes, best_t, best_p, best_u, best_v


def traverse(bvh, origins, directions, t_max: float = 10000.0,
             eps: float = 1e-9, mask=None) -> HitRecord:
    """Nearest hit through the tree, as :func:`nearest_hit` returns it:
    among equal t the lowest triangle index. (The JAX package's traverse
    commits on a strict < in visit order, so it differs from this one only
    on exact-t ties.) Rays outside ``mask`` (same leading shape) are not
    walked and report a miss."""
    shape = origins.shape[:-1]
    o, d = origins.reshape(-1, 3), directions.reshape(-1, 3)
    lanes, t, prim, u, v = _walk(bvh, o, d, t_max, eps, mask=mask)
    n = o.shape[0]
    hit = torch.zeros(n, dtype=torch.bool, device=o.device)
    hit[lanes] = prim != _NO_HIT
    out_t = torch.full((n,), t_max, device=o.device)
    out_prim = torch.zeros(n, dtype=torch.int64, device=o.device)
    out_u = torch.zeros(n, device=o.device)
    out_v = torch.zeros(n, device=o.device)
    found = prim != _NO_HIT
    rows = lanes[found]
    out_t[rows], out_prim[rows] = t[found], prim[found]
    out_u[rows], out_v[rows] = u[found], v[found]
    return HitRecord(t=out_t.reshape(shape), prim=out_prim.reshape(shape),
                     hit=hit.reshape(shape), bary_u=out_u.reshape(shape),
                     bary_v=out_v.reshape(shape))


def any_hit_within(bvh, origins, directions, cap, t_max: float = 10000.0,
                   eps: float = 1e-9, mask=None) -> torch.Tensor:
    """Whether some triangle is hit at t <= ``cap`` (per ray; valid hits
    also have t <= t_max): the same boolean as "the nearest hit is at
    t <= cap". Rays outside ``mask`` report False."""
    shape = origins.shape[:-1]
    o, d = origins.reshape(-1, 3), directions.reshape(-1, 3)
    lanes, hit = _walk(bvh, o, d, t_max, eps, cap=cap, mask=mask)
    out = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    out[lanes] = hit
    return out.reshape(shape)


def uses_bvh(tri_data) -> bool:
    """Whether the scene's queries walk the LBVH (large scenes)."""
    return tri_data.num_triangles >= BVH_MIN_TRIANGLES


def scene_nearest_hit(tri_data, origins, directions, t_max: float = 10000.0,
                      eps: float = 1e-9, mask=None) -> HitRecord:
    """:func:`nearest_hit` of the scene, by the dense test or by the LBVH
    walk (:func:`uses_bvh`); both give the same record. ``mask`` (same
    leading shape) marks the rays whose record is used: the walk skips the
    others (they report a miss), the dense test ignores it."""
    if not uses_bvh(tri_data):
        return nearest_hit(tri_data.planes, origins, directions, t_max=t_max, eps=eps)
    return traverse(tri_data.bvh, origins, directions, t_max=t_max, eps=eps, mask=mask)


def scene_occluded(tri_data, origins, directions, cap, t_max: float = 10000.0,
                   eps: float = 1e-9, mask=None) -> torch.Tensor:
    """Whether the nearest triangle hit lies at t <= ``cap`` (a shadow ray
    blocked before the light), dense or by the LBVH's any-hit walk.
    ``mask`` as in :func:`scene_nearest_hit`."""
    if not uses_bvh(tri_data):
        rec = nearest_hit(tri_data.planes, origins, directions, t_max=t_max, eps=eps)
        return rec.hit & (rec.t <= cap)
    return any_hit_within(tri_data.bvh, origins, directions, cap, t_max=t_max, eps=eps,
                          mask=mask)


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
