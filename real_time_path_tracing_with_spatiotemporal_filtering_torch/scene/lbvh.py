"""LBVH: Karras (2012) radix-tree build on the host, and its packed tables.

The reference delegates acceleration structures to the Vulkan driver
(nvvk::RaytracingBuilderKHR, main.cpp:687-742). The JAX package builds the
same tree in JAX (scene/lbvh.py there) and uses it only as an oracle; here
it is the production BVH of large scenes:

    1. 30-bit Morton codes of the triangle centroids (scene-AABB normalized).
    2. A stable sort by code; equal codes keep index order, which is
       Karras's (code, index) duplicate trick.
    3. Internal-node ranges and splits by binary searches over common-prefix
       lengths, vectorized over all nodes with numpy.
    4. Node AABBs, bottom-up over the tree's levels (min/max are exact, so
       they equal the JAX package's range-minimum queries).

:func:`build_lbvh` equals the JAX build field for field. :func:`pack_bvh_nodes`
and :func:`pack_triangle_tests` turn it into the tables that the plain walk
(ops/intersect.traverse, any_hit_within) and the CUDA walk (csrc/bvh.cuh)
read.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.intersect import MAX_STACK

# Node boxes are padded outward by this share of the scene's largest
# coordinate (and at least this much in absolute terms). The slab test and
# the triangle test round differently, and the walls of the Cornell scenes
# are planar or axis-aligned, so unpadded leaf boxes can have zero
# thickness: a ray whose triangle test is valid must never miss the box.
# The triangle test's own error is a few float32 ulps of the ray origin's
# and the vertices' magnitudes, so the padding holds for ray origins within
# ~100x the scene's coordinate range.
BOX_PAD = 1e-4

# Columns of a packed node row: the left child's box (min xyz, max xyz), the
# right child's box, then the two child ids as int32 bits and two unused
# words (64 bytes: four 16-byte loads). A child id >= 0 is an internal node;
# a leaf is stored as -1 - triangle index.
NODE_WORDS = 16
# Columns of a packed triangle-test row: n, d0, n1, d1, n2, d2 (48 bytes).
TRI_WORDS = 12


class LBVH(NamedTuple):
    """2T-1 node tree: internal nodes [0, T-1), leaves [T-1, 2T-1).

    Node i's children are ``left[i]``/``right[i]`` (node ids). Leaf node
    T-1+k holds sorted-order leaf k, whose original triangle index is
    ``leaf_prim[k]``. ``aabb_min/max`` are (2T-1, 3).
    """

    left: np.ndarray       # (T-1,) int32 child node ids
    right: np.ndarray      # (T-1,) int32
    leaf_prim: np.ndarray  # (T,) int32 original triangle ids, Z-order
    aabb_min: np.ndarray   # (2T-1, 3) float32
    aabb_max: np.ndarray   # (2T-1, 3) float32

    @property
    def num_leaves(self) -> int:
        return self.leaf_prim.shape[0]


class PackedBVH(NamedTuple):
    """The device-side tree: what the plain and the CUDA walks read."""

    nodes: torch.Tensor  # (max(T-1, 1), 16) float32, child ids as int32 bits
    tris: torch.Tensor   # (T, 12) float32 triangle-test rows, original order


def morton_codes_np(centroids) -> np.ndarray:
    """30-bit Morton codes of points normalized to the centroid AABB (the
    JAX package's morton_codes_np, same bits)."""
    c = np.asarray(centroids, np.float32)
    lo = c.min(axis=0)
    hi = c.max(axis=0)
    x = (c - lo) / np.maximum(hi - lo, np.float32(1e-12))
    q = np.clip((x * np.float32(1024.0)).astype(np.uint32), 0, 1023)

    def expand_bits(v):
        v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
        v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
        v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
        v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
        return v

    with np.errstate(over="ignore"):
        return (
            (expand_bits(q[:, 0]) << 2)
            | (expand_bits(q[:, 1]) << 1)
            | expand_bits(q[:, 2])
        )


def _clz32(x: np.ndarray) -> np.ndarray:
    """Leading zeros of 32-bit values held in int64 (32 for 0)."""
    return 32 - np.frexp(x.astype(np.float64))[1]


def build_lbvh(triangles) -> LBVH:
    """Build from (T, 3, 3) float32 triangles, T >= 2. Every loop runs the
    JAX build's per-node iterations over all nodes at once, and stops once
    further iterations can change nothing."""
    tris = np.asarray(triangles, np.float32)
    num = tris.shape[0]
    if num < 2:
        raise ValueError("LBVH needs at least 2 triangles")
    leaf_min = tris.min(axis=1)
    leaf_max = tris.max(axis=1)
    centroids = (leaf_min + leaf_max) * np.float32(0.5)
    codes = morton_codes_np(centroids)
    order = np.argsort(codes, kind="stable")
    codes = codes[order].astype(np.int64)
    smin, smax = leaf_min[order], leaf_max[order]

    i = np.arange(num - 1, dtype=np.int64)

    def delta(j):
        """Common-prefix length of keys (code, index) i and j; -1 outside
        [0, num)."""
        j_safe = np.clip(j, 0, num - 1)
        code_xor = codes[i] ^ codes[j_safe]
        d = np.where(code_xor == 0, 32 + _clz32(i ^ j_safe), _clz32(code_xor))
        return np.where((j >= 0) & (j < num), d, -1)

    d = np.sign(delta(i + 1) - delta(i - 1))
    d[d == 0] = 1
    delta_min = delta(i - d)
    # exponential search for an upper bound of the range length
    lmax = np.full(num - 1, 2, np.int64)
    grow = delta(i + lmax * d) > delta_min
    while grow.any():
        lmax = np.where(grow, lmax * 2, lmax)
        grow &= delta(i + lmax * d) > delta_min
    # binary search for the other end (iterations past t = 0 change nothing)
    length, t = np.zeros(num - 1, np.int64), lmax
    while t.any():
        t = t // 2
        length = np.where(delta(i + (length + t) * d) > delta_min, length + t, length)
    j = i + length * d
    first, last = np.minimum(i, j), np.maximum(i, j)
    # binary search for the split (once t = 1 everywhere, an iteration that
    # moves nothing is followed only by more of the same)
    delta_node = delta(j)
    split, t = np.zeros(num - 1, np.int64), length
    while True:
        t = (t + 1) // 2
        cond = (split + t < length) & (delta(i + (split + t) * d) > delta_node)
        moved = cond.any()
        split = np.where(cond, split + t, split)
        if (t == 1).all() and not moved:
            break
    gamma = i + split * d + np.minimum(d, 0)
    left = np.where(first == gamma, (num - 1) + gamma, gamma)
    right = np.where(last == gamma + 1, (num - 1) + gamma + 1, gamma + 1)

    aabb_min = np.concatenate([np.zeros((num - 1, 3), np.float32), smin])
    aabb_max = np.concatenate([np.zeros((num - 1, 3), np.float32), smax])
    for level in reversed(_internal_levels(left, right, num)):
        lc, rc = left[level], right[level]
        aabb_min[level] = np.minimum(aabb_min[lc], aabb_min[rc])
        aabb_max[level] = np.maximum(aabb_max[lc], aabb_max[rc])
    return LBVH(
        left=left.astype(np.int32),
        right=right.astype(np.int32),
        leaf_prim=order.astype(np.int32),
        aabb_min=aabb_min,
        aabb_max=aabb_max,
    )


def _internal_levels(left, right, num) -> list[np.ndarray]:
    """Internal node ids by depth, root first."""
    levels = [np.zeros(1, np.int64)]
    while True:
        children = np.concatenate([left[levels[-1]], right[levels[-1]]])
        children = children[children < num - 1]
        if children.size == 0:
            return levels
        levels.append(children)


def tree_depth(bvh: LBVH) -> int:
    """Edges from the root to the deepest leaf."""
    return len(_internal_levels(bvh.left, bvh.right, bvh.num_leaves))


def pack_bvh_nodes(bvh: LBVH | None, triangles) -> np.ndarray:
    """The (max(T-1, 1), 16) float32 node table of :data:`NODE_WORDS`
    columns, boxes padded by :data:`BOX_PAD`. ``bvh`` None (a scene of one
    triangle) packs a root whose two children are that triangle. Raises if
    the tree is too deep for a walk's stack."""
    tris = np.asarray(triangles, np.float32)
    scale = max(1.0, float(np.abs(tris).max()))
    pad = np.float32(BOX_PAD * scale)
    if bvh is None:
        lo, hi = tris.min(axis=1) - pad, tris.max(axis=1) + pad
        boxes = np.concatenate([lo, hi, lo, hi], axis=1)
        children = np.full((1, 2), -1, np.int32)
    else:
        depth = tree_depth(bvh)
        if depth >= MAX_STACK:
            raise ValueError(
                f"LBVH depth {depth} reaches the walk's {MAX_STACK}-entry stack"
            )
        lo, hi = bvh.aabb_min - pad, bvh.aabb_max + pad
        num = bvh.num_leaves
        lc, rc = bvh.left.astype(np.int64), bvh.right.astype(np.int64)
        boxes = np.concatenate([lo[lc], hi[lc], lo[rc], hi[rc]], axis=1)

        def encode(c):
            leaf = c >= num - 1
            prim = bvh.leaf_prim[np.where(leaf, c - (num - 1), 0)]
            return np.where(leaf, -1 - prim.astype(np.int64), c).astype(np.int32)

        children = np.stack([encode(lc), encode(rc)], axis=1)
    nodes = np.zeros((boxes.shape[0], NODE_WORDS), np.float32)
    nodes[:, :12] = boxes
    nodes.view(np.int32)[:, 12:14] = children
    return nodes


def pack_triangle_tests(n, d0, n1, d1, n2, d2) -> np.ndarray:
    """The (T, 12) rows of :data:`TRI_WORDS` columns from plane arrays."""
    col = lambda a: np.asarray(a, np.float32).reshape(-1, 1)  # noqa: E731
    return np.concatenate([np.asarray(n, np.float32), col(d0), np.asarray(n1, np.float32),
                           col(d1), np.asarray(n2, np.float32), col(d2)], axis=1)
