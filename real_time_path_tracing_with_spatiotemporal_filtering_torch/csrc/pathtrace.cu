// Bounce-loop path tracer, one thread per pixel.
//
// Replaces the TPU kernel _trace_kernel
// (real_time_path_tracing_with_spatiotemporal_filtering_tpu/ops/pallas/pathtrace.py:1716),
// in its parity mode (1 spp, 1 sample batch, no next-event estimation, no
// Russian roulette). It computes ops/pathtrace.path_trace_pass: per-pixel
// PCG seed, Gaussian AA jitter, then up to max_bounces segments of nearest
// hit, sphere light (ignoring occluders unless light_through_walls is off),
// first-hit dimming, normal-keyed albedo, unit-sphere diffuse bounce, sky,
// and the loop fall-through that returns the bare throughput.
//
// What bounds it on the H100: arithmetic and divergence. A pixel's path
// runs a data-dependent number of segments, each testing all T triangles
// (~40 flops per test), and writes 12 bytes at the end. The triangle rows
// (27 floats: 21 intersection constants, unit normal, albedo) sit in shared
// memory and every thread of a warp reads the same row (a broadcast). A
// finished path leaves its loop at once -- the plain version's masked lanes
// change nothing after termination -- so a warp runs as long as its longest
// path; the TPU kernel's roll compaction has no counterpart here. The
// triangles are tested in index order, as the plain version's argmin does;
// coplanar pairing is left to a later change.

#include "common.cuh"

namespace {

using namespace ptsf;

constexpr int kStride = 27;  // 21 intersect | unit normal 3 | albedo 3

// checkRayLightIntersection (ops/intersect.ray_sphere)
__device__ __forceinline__ bool ray_sphere(V3 o, V3 d, V3 center, float r2, float& t_out) {
  V3 oc = sub(o, center);
  float a = dot(d, d);
  float b = 2.0f * dot(oc, d);
  float c = dot(oc, oc) - r2;
  float disc = b * b - 4.0f * a * c;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float t1 = (-b - sq) / (2.0f * a);
  float t2 = (-b + sq) / (2.0f * a);
  float t = t1 > 0.0f ? t1 : t2;
  bool hit = disc >= 0.0f && t > 0.0f;
  t_out = hit ? t : 0.0f;
  return hit;
}

// skyColor (ops/shading.sky_color)
__device__ __forceinline__ V3 sky(V3 d) {
  float y = d.y;
  if (!(y > 0.0f)) return {0.03f, 0.03f, 0.03f};
  float s = 1.0f - y;
  return {s * 1.0f + y * 0.25f, s * 1.0f + y * 0.5f, s * 1.0f + y * 1.0f};
}

// params: cam[0:3] rot[3:12] light_pos[12:15] light_color_hdr[15:18]
__global__ void trace_kernel(const float* __restrict__ table, int num_tris,
                             const float* __restrict__ params, int width, int height, int frame,
                             int max_bounces, float slope, float aa_sigma, float ray_eps,
                             float t_max, float eps, float light_r2, float first_dim,
                             int light_through_walls, float* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ float prm[18];
  int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < 18) prm[tid] = params[tid];
  stage_table(smem, table, num_tris * kStride);

  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;

  V3 light_pos = load3(prm + 12);
  V3 light_hdr = load3(prm + 15);
  uint32_t state = seed_per_pixel((uint32_t)x, (uint32_t)y, (uint32_t)frame, 0u);
  float gx, gy;
  random_gaussian(state, gx, gy);
  V3 o = load3(prm);
  V3 d = pixel_ray(x, y, aa_sigma * gx, aa_sigma * gy, width, height, slope, prm + 3);

  V3 accum = {1.0f, 1.0f, 1.0f};
  V3 result = {0.0f, 0.0f, 0.0f};
  bool alive = true;
  for (int seg = 0; seg < max_bounces; ++seg) {
    Hit h = nearest_hit(smem, kStride, num_tris, o, d, t_max, eps);
    float light_t;
    bool light_hit = ray_sphere(o, d, light_pos, light_r2, light_t);
    if (!light_through_walls) light_hit = light_hit && (!h.hit || light_t < h.t);
    if (light_hit) {  // light termination, checked first (raytrace:226-235)
      float dim = seg == 0 ? first_dim : 1.0f;
      result = scale(dim, mul(accum, light_hdr));
      alive = false;
      break;
    }
    if (!h.hit) {  // sky termination (raytrace:263-268)
      result = mul(accum, sky(d));
      alive = false;
      break;
    }
    // diffuse bounce (raytrace:238-262)
    const float* row = smem + h.prim * kStride;
    accum = mul(accum, load3(row + 24));
    V3 n = load3(row + 21);
    V3 n_ff = dot(d, n) < 0.0f ? n : neg(n);
    V3 hit_pos = hit_position(smem, kStride, h);
    o = add(hit_pos, scale(ray_eps, n_ff));
    V3 nd = add(n_ff, random_unit_sphere(state));
    d = div(nd, norm(nd));
  }
  // loop fall-through: surviving paths return the bare albedo product
  store3(out + 3 * (y * width + x), alive ? accum : result);
}

}  // namespace

extern "C" int ptsf_trace(const float* table, int num_tris, const float* params, int width,
                          int height, int frame, int max_bounces, float slope, float aa_sigma,
                          float ray_eps, float t_max, float eps, float light_r2, float first_dim,
                          int light_through_walls, float* out, cudaStream_t stream) {
  dim3 block(16, 16);
  dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  size_t smem = sizeof(float) * num_tris * kStride;
  trace_kernel<<<grid, block, smem, stream>>>(table, num_tris, params, width, height, frame,
                                              max_bounces, slope, aa_sigma, ray_eps, t_max, eps,
                                              light_r2, first_dim, light_through_walls, out);
  return (int)cudaGetLastError();
}
