// LBVH walks, one ray per thread: the device side of ops/intersect.traverse
// and any_hit_within over the tables of scene/lbvh.py.
//
// The node table (scene/lbvh.pack_bvh_nodes) holds one 64-byte row per
// internal node: the left child's box, the right child's box (min xyz, max
// xyz, padded outward) and the two child ids as int32 bits; a child id < 0
// is the leaf of triangle -1 - id. The triangle-test rows are 48 bytes:
// n, d0, n1, d1, n2, d2. Both are read with 16-byte loads from global
// memory (they stay in L2: 16 MB of nodes and 12 MB of rows at 247,808
// triangles against the H100's 50 MB).
//
// The walk keeps a stack of 64 ints (local memory), visits the nearer
// child first and pushes the farther one; leaf children are tested at
// once. A box is entered when its slab interval meets [0, best] with
// best included, and the nearest hit commits on the pair (t, triangle):
// t < best, or t == best and a lower triangle index. So the committed hit
// is the least (t, index) over all valid hits whatever the visit order,
// which is what the dense loop's strict < in index order (geometry.cu
// tile_nearest_hit) and the plain version's argmin commit.
#pragma once

#include <climits>

#include "common.cuh"

namespace ptsf {

constexpr int kBvhStack = 64;  // ops/intersect.MAX_STACK: the build refuses deeper trees

// What a walk reads. The attribute arrays (T, 3) are read once per
// committed hit, after the walk; a kernel that needs none passes null.
struct BvhScene {
  const float4* nodes;    // (max(T-1, 1), 16) floats
  const float4* tris;     // (T, 12) floats
  const float* v0;        // (T, 3) hit_position: v0 + u e1 + v e2
  const float* e1;
  const float* e2;
  const float* normals;   // (T, 3) unit geometric normals
  const float* albedo;    // (T, 3)
};

// 1 / d per axis, with components below 1e-20 in magnitude replaced by
// 1e-20 (as the JAX package's traversal guards them).
__device__ __forceinline__ V3 inverse_dir(V3 d) {
  return {1.0f / (fabsf(d.x) < 1e-20f ? 1e-20f : d.x), 1.0f / (fabsf(d.y) < 1e-20f ? 1e-20f : d.y),
          1.0f / (fabsf(d.z) < 1e-20f ? 1e-20f : d.z)};
}

// Inclusive slab test (ops/intersect._walk's): whether the box meets [0, best];
// ``tmin`` is the entry distance. About 26 operations.
__device__ __forceinline__ bool slab(V3 o, V3 inv, V3 bmin, V3 bmax, float best, float& tmin) {
  float t0x = (bmin.x - o.x) * inv.x, t1x = (bmax.x - o.x) * inv.x;
  float t0y = (bmin.y - o.y) * inv.y, t1y = (bmax.y - o.y) * inv.y;
  float t0z = (bmin.z - o.z) * inv.z, t1z = (bmax.z - o.z) * inv.z;
  tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return tmax >= fmaxf(tmin, 0.0f) && tmin <= best;
}

__device__ __forceinline__ bool bvh_tri_test(const BvhScene& s, int prim, V3 o, V3 d, float t_max,
                                             float eps, float& t, float& u, float& v) {
  const float4* r = s.tris + 3 * prim;
  float4 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2);
  return tri_test(v3(a.x, a.y, a.z), a.w, v3(b.x, b.y, b.z), b.w, v3(c.x, c.y, c.z), c.w, o, d,
                  t_max, eps, t, u, v);
}

// The walk shared by the nearest-hit and the any-hit query. ``best`` is the
// box cap (updated by ``leaf``); ``leaf(prim)`` tests one triangle and
// returns true to end the walk.
template <bool kCount, class Leaf>
__device__ __forceinline__ void bvh_walk(const BvhScene& s, V3 o, V3 d, const float& best,
                                         Counts& c, Leaf leaf) {
  V3 inv = inverse_dir(d);
  int stack[kBvhStack];
  int sp = 0;
  int node = 0;
  while (true) {
    const float4* row = s.nodes + 4 * node;
    float4 a = __ldg(row), b = __ldg(row + 1), e = __ldg(row + 2), f = __ldg(row + 3);
    float t_l, t_r;
    bool hit_l = slab(o, inv, v3(a.x, a.y, a.z), v3(a.w, b.x, b.y), best, t_l);
    bool hit_r = slab(o, inv, v3(b.z, b.w, e.x), v3(e.y, e.z, e.w), best, t_r);
    int left = __float_as_int(f.x), right = __float_as_int(f.y);
    if (kCount) {
      c.box += 2;
      c.seen_node[node] = 1;
      count_lanes(c.walk_lanes, c.walk_steps);
    }
    if (hit_l && left < 0 && leaf(-1 - left)) return;
    if (hit_r && right < 0 && leaf(-1 - right)) return;
    bool in_l = hit_l && left >= 0, in_r = hit_r && right >= 0;
    if (in_l && in_r) {
      bool near_l = t_l <= t_r;
      node = near_l ? left : right;
      stack[sp++] = near_l ? right : left;
    } else if (in_l) {
      node = left;
    } else if (in_r) {
      node = right;
    } else {
      if (sp == 0) return;
      node = stack[--sp];
    }
  }
}

// Nearest hit (ops/intersect.nearest_hit's record).
template <bool kCount>
__device__ __forceinline__ Hit bvh_nearest_hit(const BvhScene& s, V3 o, V3 d, float t_max,
                                               float eps, Counts& c) {
  float best = t_max, best_u = 0.0f, best_v = 0.0f;
  int best_prim = INT_MAX;
  bvh_walk<kCount>(s, o, d, best, c, [&](int prim) {
    if (kCount) {
      ++c.tri;
      c.seen_tri[prim] = 1;
    }
    float t, u, v;
    if (bvh_tri_test(s, prim, o, d, t_max, eps, t, u, v) &&
        (t < best || (t == best && prim < best_prim))) {
      best = t;
      best_prim = prim;
      best_u = u;
      best_v = v;
    }
    return false;
  });
  if (best_prim == INT_MAX) return {false, 0, t_max, 0.0f, 0.0f};
  return {true, best_prim, best, best_u, best_v};
}

// Whether any triangle is hit at t <= cap (and t <= t_max): the same boolean
// as "the nearest hit is at t <= cap". Stops at the first such triangle.
template <bool kCount>
__device__ __forceinline__ bool bvh_any_hit_within(const BvhScene& s, V3 o, V3 d, float cap,
                                                   float t_max, float eps, Counts& c) {
  bool found = false;
  bvh_walk<kCount>(s, o, d, cap, c, [&](int prim) {
    if (kCount) {
      ++c.tri;
      c.seen_tri[prim] = 1;
    }
    float t, u, v;
    found = bvh_tri_test(s, prim, o, d, t_max, eps, t, u, v) && t <= cap;
    return found;
  });
  return found;
}

}  // namespace ptsf
