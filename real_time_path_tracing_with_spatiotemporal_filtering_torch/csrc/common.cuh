// Device helpers shared by the geometry and path-trace kernels: float3
// arithmetic in the plain PyTorch version's operation order, the PCG
// generator of ops/rng.py, and the ray/triangle test of ops/intersect.py
// (the geometry kernel's dense loop over it, with its tile cull, is
// geometry.cu tile_nearest_hit).
//
// Every expression here is written in the order the plain version
// evaluates it (dot products as (a0*b0 + a1*b1) + a2*b2, no reassociation).
// The library is built with --fmad=false, so no a*b + c is contracted
// into an FMA and both versions round the same way.
#pragma once

#include <cstdint>
#include <mutex>

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
// The geometry kernel's triangle rows start with the 21 intersection
// constants: v0[0:3] e1[3:6] e2[6:9] n[9:12] d0[12] n1[13:16] d1[16]
// n2[17:20] d2[20] (the trace kernel's rows: bounce.cuh DenseTable).
struct Hit {
  bool hit;
  int prim;
  float t, u, v;
};

// Work counted by the kernels' counting instantiations (for the bounds):
// ray/triangle tests and ray/box slab tests, and (LBVH walks) a 1 in
// seen_node[i] / seen_tri[p] for every node row and triangle-test row read;
// and, for the lane efficiency of the walks, the lane steps of their loops
// (count_lanes).
struct Counts {
  int tri, box;
  int* seen_node;
  int* seen_tri;
  unsigned walk_lanes, walk_steps;
  // the dense shadow loop (bounce.cuh DenseTable::occluded): the lane
  // steps and warp steps (count_lanes) of its plane pass, then of its
  // barycentric pass (whole tests, also counted in tri and walk_*)
  unsigned shadow[4];
};

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ unsigned lane_id() {
  unsigned r;
  asm("mov.u32 %0, %%laneid;" : "=r"(r));
  return r;
}

// Lanes below the calling one, as a mask.
__device__ __forceinline__ unsigned lanes_below() {
  unsigned r;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(r));
  return r;
}

// Lane efficiency: one step of a loop. Every lane that runs the step adds 1
// to ``lanes``, the lowest of the warp's lanes that run it together adds 1
// to ``steps``; lanes / (32 steps) is the share of the warp's lane slots
// that did the loop's work.
__device__ __forceinline__ void count_lanes(unsigned& lanes, unsigned& steps) {
  unsigned m = __activemask();
  lanes += 1;
  if ((int)lane_id() == __ffs(m) - 1) steps += 1;
}

// Adds the warp's sums of v[0:n] to out[0:n]; all 32 lanes call it together.
template <int n>
__device__ __forceinline__ void flush_sums(unsigned long long* out, const unsigned (&v)[n]) {
  for (int k = 0; k < n; ++k) {
    unsigned sum = __reduce_add_sync(kFullMask, v[k]);
    if (lane_id() == 0) atomicAdd(out + k, (unsigned long long)sum);
  }
}

// Adds a warp's lane counts to out[0:4] (the outer loop's lanes and steps,
// the walks' lanes and steps); all 32 lanes call it together.
__device__ __forceinline__ void flush_lanes(unsigned long long* out, unsigned loop_lanes,
                                            unsigned loop_steps, const Counts& c) {
  unsigned v[4] = {loop_lanes, loop_steps, c.walk_lanes, c.walk_steps};
  flush_sums(out, v);
}

// Blocks of ``block`` threads with ``smem`` bytes of dynamic shared memory
// that the card holds at once (all SMs): the grid of a persistent kernel.
// Kept per (kernel, block, shared memory, device) after the first query.
template <class Kernel>
inline int resident_blocks(Kernel kernel, int block, size_t smem) {
  struct Entry {
    const void* fn;
    int block;
    size_t smem;
    int dev, blocks;
  };
  static Entry cache[64];
  static int used = 0;
  static std::mutex lock;
  int dev = 0;
  cudaGetDevice(&dev);
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> hold(lock);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.fn == fn && e.block == block && e.smem == smem && e.dev == dev) return e.blocks;
  }
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block, smem);
  int blocks = per_sm > 0 ? per_sm * sms : 1;
  if (used < 64) cache[used++] = {fn, block, smem, dev, blocks};
  return blocks;
}

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

// The bound that may_reach compares with, for a segment that ends at cap:
// lim = min(cap, t_max) raised by 2^-20 of itself; infinite where lim is
// too small for may_reach's argument (lim min(eps, 1) < 2^-125), and then
// only the sign cuts.
__device__ __forceinline__ float upper_reach(float cap, float t_max, float eps) {
  float lim = fminf(cap, t_max);
  return lim * fminf(eps, 1.0f) >= 2.3509887e-38f /* 2^-125 */
             ? lim * 1.00000095367431640625f /* 1 + 2^-20 */
             : INFINITY;
}

// Whether tri_test's plane t may lie in (0, lim] (reach = upper_reach(cap,
// t_max, eps)), from the plane (n, d0) alone and with no division: false
// only where tri_test fails or gives a t above lim, so a triangle it rules
// out needs no barycentric half. tri_test computes num = d0 - o.n and
// nd = d.n as here and, unless |nd| < eps (then it fails), t = RN(num / nd).
// q is num with nd's sign folded in, exactly.
// - q <= 0 or NaN: num / nd <= 0 or NaN, so t > 0 fails.
// - q > RN(reach |nd|): since lim min(eps, 1) >= 2^-125 and |nd| >= eps, the
//   products reach = RN(lim k), k = 1 + 2^-20, and RN(reach |nd|) are normal,
//   each within a factor 1 - 2^-24 of exact, so num / nd > lim |nd| k
//   (1 - 2^-24)^2 / |nd| > lim (1 + 2^-21) >= the next float above lim
//   (lim is normal); rounding keeps t at or above that float, so t > lim.
//   An infinite bound never cuts.
__device__ __forceinline__ bool may_reach(V3 n, float d0, V3 o, V3 d, float reach) {
  float num = d0 - dot(o, n), nd = dot(d, n);
  float q = __int_as_float(__float_as_int(num) ^ (__float_as_int(nd) & 0x80000000));
  return (q > 0.0f) & (q <= reach * fabsf(nd));
}

// The same test against a table row.
__device__ __forceinline__ bool tri_test(const float* r, V3 o, V3 d, float t_max, float eps,
                                         float& t, float& u, float& v) {
  return tri_test(load3(r + 9), r[12], load3(r + 13), r[16], load3(r + 17), r[20], o, d, t_max,
                  eps, t, u, v);
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
