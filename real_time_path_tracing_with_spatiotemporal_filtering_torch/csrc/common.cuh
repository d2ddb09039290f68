// Device helpers shared by the geometry and path-trace kernels: float3
// arithmetic in the plain PyTorch version's operation order, the PCG
// generator of ops/rng.py, and the ray/triangle test and dense nearest-hit
// loop of ops/intersect.py.
//
// Every expression here is written in the order the plain version
// evaluates it (dot products as (a0*b0 + a1*b1) + a2*b2, no reassociation).
// The library is built with --fmad=false, so no a*b + c is contracted
// into an FMA and both versions round the same way.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ptsf {

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 scale(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 div(V3 a, float s) { return {a.x / s, a.y / s, a.z / s}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ float norm(V3 a) { return sqrtf(dot(a, a)); }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 load3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ void store3(float* p, V3 a) {
  p[0] = a.x;
  p[1] = a.y;
  p[2] = a.z;
}

// --- PCG (ops/rng.py; raytrace.comp.glsl:71-92, 297) ---------------------
// float(word) * float32(1 / 4294967295): a multiply by the rounded
// reciprocal, as the reference writes it, not a divide.
constexpr float kInvU32Max = (float)(1.0 / 4294967295.0);
constexpr float kTwoPi = (float)(2.0 * 3.14159265);

__device__ __forceinline__ uint32_t seed_per_pixel(uint32_t px, uint32_t py, uint32_t frame,
                                                   uint32_t batch) {
  uint32_t s = px * 3266489917u + py * 668265263u;
  return s ^ (frame * 374761393u) ^ (batch * 2654435761u);
}

__device__ __forceinline__ float pcg_step(uint32_t& state) {
  state = state * 747796405u + 1u;
  uint32_t word = ((state >> ((state >> 28u) + 4u)) ^ state) * 277803737u;
  word = (word >> 22u) ^ word;
  return (float)word * kInvU32Max;
}

// Box-Muller (raytrace.comp.glsl:84-92). The clamp 1e-38 is subnormal in
// float32: it survives only because the build does not flush to zero.
__device__ __forceinline__ void random_gaussian(uint32_t& state, float& gx, float& gy) {
  float u1 = pcg_step(state);
  float u2 = pcg_step(state);
  u1 = fmaxf(u1, 1e-38f);
  float r = sqrtf(-2.0f * logf(u1));
  float theta = kTwoPi * u2;
  gx = r * cosf(theta);
  gy = r * sinf(theta);
}

// Uniform direction on the unit sphere (raytrace.comp.glsl:256-259).
__device__ __forceinline__ V3 random_unit_sphere(uint32_t& state) {
  float a = pcg_step(state);
  float b = pcg_step(state);
  float theta = kTwoPi * a;
  float u = 2.0f * b - 1.0f;
  float r = sqrtf(fmaxf(1.0f - u * u, 0.0f));
  return {r * cosf(theta), r * sinf(theta), u};
}

// --- camera (ops/camera.py pixel_rays) -----------------------------------
// rot: row-major camera->world (3, 3). Center ray when jx = jy = 0.
__device__ __forceinline__ V3 pixel_ray(int x, int y, float jx, float jy, int width, int height,
                                        float slope, const float* rot) {
  float fx = (float)x + 0.5f;
  float fy = (float)y + 0.5f;
  fx = fx + jx;
  fy = fy + jy;
  float w = (float)width, h = (float)height;
  float u = (2.0f * fx - w) / h;
  float v = -(2.0f * fy - h) / h;
  V3 c = {slope * u, slope * v, -1.0f};
  V3 d = {rot[0] * c.x + rot[1] * c.y + rot[2] * c.z,
          rot[3] * c.x + rot[4] * c.y + rot[5] * c.z,
          rot[6] * c.x + rot[7] * c.y + rot[8] * c.z};
  float n = norm(d);
  return div(d, n);
}

// --- nearest hit (ops/intersect.py) --------------------------------------
// Triangle rows start with the 21 intersection constants:
// v0[0:3] e1[3:6] e2[6:9] n[9:12] d0[12] n1[13:16] d1[16] n2[17:20] d2[20]
struct Hit {
  bool hit;
  int prim;
  float t, u, v;
};

// Work counted by the kernels' counting instantiations (for the bounds):
// ray/triangle tests and ray/box slab tests, and (LBVH walks) a 1 in
// seen_node[i] / seen_tri[p] for every node row and triangle-test row read.
struct Counts {
  int tri, box;
  int* seen_node;
  int* seen_tri;
};

// One ray/triangle test from the plane constants n, d0, n1, d1, n2, d2:
// the hit distance t and the barycentrics u, v, and whether the hit is
// valid (ops/intersect.py).
__device__ __forceinline__ bool tri_test(V3 n, float d0, V3 n1, float d1, V3 n2, float d2, V3 o,
                                         V3 d, float t_max, float eps, float& t, float& u,
                                         float& v) {
  float no = dot(o, n), nd = dot(d, n);
  float n1o = dot(o, n1), n1d = dot(d, n1);
  float n2o = dot(o, n2), n2d = dot(d, n2);
  bool parallel = fabsf(nd) < eps;
  float safe_nd = parallel ? eps : nd;
  t = (d0 - no) / safe_nd;
  u = n1o + t * n1d + d1;
  v = n2o + t * n2d + d2;
  return !parallel && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f && t <= t_max;
}

// The same test against a table row.
__device__ __forceinline__ bool tri_test(const float* r, V3 o, V3 d, float t_max, float eps,
                                         float& t, float& u, float& v) {
  return tri_test(load3(r + 9), r[12], load3(r + 13), r[16], load3(r + 17), r[20], o, d, t_max,
                  eps, t, u, v);
}

__device__ __forceinline__ Hit nearest_hit(const float* tab, int stride, int num_tris, V3 o, V3 d,
                                           float t_max, float eps) {
  // argmin over t_cand (invalid -> 2 t_max) takes the first minimum: a
  // strict < in triangle order does the same.
  float best = INFINITY;
  Hit h = {false, 0, 0.0f, 0.0f, 0.0f};
  const float miss_t = 2.0f * t_max;
  for (int i = 0; i < num_tris; ++i) {
    float t, u, v;
    bool valid = tri_test(tab + i * stride, o, d, t_max, eps, t, u, v);
    float t_cand = valid ? t : miss_t;
    if (t_cand < best) {
      best = t_cand;
      h = {valid, i, t, u, v};
    }
  }
  if (!h.hit) return {false, 0, t_max, 0.0f, 0.0f};
  return h;
}

// Whether any triangle is hit at a distance t <= cap: the same boolean as
// "the nearest hit is at t <= cap", since the nearest valid t is <= cap
// exactly when some valid t is. Stops at the first such triangle; under
// kCount adds the number of triangles tested to ``tests``.
template <bool kCount>
__device__ __forceinline__ bool any_hit_within(const float* tab, int stride, int num_tris, V3 o,
                                               V3 d, float cap, float t_max, float eps,
                                               int& tests) {
  for (int i = 0; i < num_tris; ++i) {
    if (kCount) ++tests;
    float t, u, v;
    if (tri_test(tab + i * stride, o, d, t_max, eps, t, u, v) && t <= cap) return true;
  }
  return false;
}

// v0 + u*e1 + v*e2 of the committed triangle (ops/intersect.hit_position).
__device__ __forceinline__ V3 hit_position(const float* tab, int stride, const Hit& h) {
  const float* r = tab + h.prim * stride;
  return add(add(load3(r), scale(h.u, load3(r + 3))), scale(h.v, load3(r + 6)));
}

// Copy a (rows, stride) table into shared memory, all threads of the block.
__device__ __forceinline__ void stage_table(float* dst, const float* __restrict__ src, int count) {
  int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < count; i += blockDim.x * blockDim.y) dst[i] = __ldg(src + i);
  __syncthreads();
}

}  // namespace ptsf
