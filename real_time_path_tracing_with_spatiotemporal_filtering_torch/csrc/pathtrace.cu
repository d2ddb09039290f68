// Bounce-loop path tracer, one thread per pixel.
//
// Replaces the TPU kernel _trace_kernel
// (real_time_path_tracing_with_spatiotemporal_filtering_tpu/ops/pallas/pathtrace.py:1716).
// It computes ops/pathtrace.path_trace_pass: for each of sample_batches
// batches a per-pixel PCG seed, then spp samples, each a Gaussian AA jitter
// and a path of up to max_bounces segments of nearest hit, sphere light
// (ignoring occluders unless light_through_walls is off or NEE is on),
// first-hit dimming, normal-keyed albedo, unit-sphere diffuse bounce and
// sky. The optional estimators follow the plain version draw for draw:
// next-event estimation (a solid-angle cone sample of the light after the
// bounce draws, shadow-tested against the same triangle table), Russian
// roulette (one draw after the NEE draws, survivors divided by p), and the
// loop fall-through that returns the bare throughput unless NEE or
// truncate_radiance drops it. The average is (sum / spp) per batch, then
// / batches, as the plain version divides.
//
// What bounds it on the H100: arithmetic and divergence. A pixel's path
// runs a data-dependent number of segments, each testing all T triangles
// (~39 flops per test), plus under NEE one shadow walk per bounce that
// stops at the first occluder; it writes 12 bytes at the end. The triangle
// rows (27 floats: 21 intersection constants, unit normal, albedo) sit in
// shared memory and every thread of a warp reads the same row (a
// broadcast); the shadow walk reuses them. A finished path leaves its loop
// at once -- the plain version's masked lanes change nothing after
// termination -- so a warp runs as long as its longest path; the TPU
// kernel's roll compaction has no counterpart here. The triangles are
// tested in index order, as the plain version's argmin does. NEE, Russian
// roulette, the sample and batch loops and the count of triangle tests
// (written only for chip_smoke.py's bound) are template parameters (sixteen
// instantiations, chosen at launch), so the parity mode carries none of
// their code or registers. The sample-loop kernels take
// __launch_bounds__(256, 4), which caps them at 64 registers so that four
// 16x16 blocks fit on an SM; the one-sample kernels need ~45 registers and
// run faster without the attribute (measured with frame_profile.py on an
// H100: the bounds make the quality trace ~1% faster and the parity trace
// ~6% slower).

#include "common.cuh"

namespace {

using namespace ptsf;

constexpr int kStride = 27;  // 21 intersect | unit normal 3 | albedo 3
constexpr float kInvPi = (float)(1.0 / 3.14159265);

struct TraceArgs {
  int width, height, frame, max_bounces, spp, batches;
  float slope, aa_sigma, ray_eps, t_max, eps, light_r, light_r2, first_dim;
  int light_through_walls, rr_start, truncate;
  float rr_min, rr_max;
};

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

// Next-event estimation at the bounce vertex o (ops/pathtrace._nee_sample):
// draws two uniforms, and returns true with the banked radiance in ``bank``
// when the light sample is unoccluded.
template <bool kCount>
__device__ __forceinline__ bool nee_sample(const float* tab, int num_tris, V3 o, V3 n_ff,
                                           V3 accum, uint32_t& state, V3 light_pos,
                                           V3 light_hdr, const TraceArgs& a, V3& bank,
                                           int& tests) {
  V3 to_l = sub(light_pos, o);
  float safe_dist = fmaxf(norm(to_l), 1e-20f);
  V3 wc = div(to_l, safe_dist);
  float sin_max = fminf(fmaxf(a.light_r / safe_dist, 0.0f), 1.0f);
  float cos_max = sqrtf(fmaxf(1.0f - sin_max * sin_max, 0.0f));
  float u1 = pcg_step(state);
  float u2 = pcg_step(state);
  float cos_t = 1.0f - u1 * (1.0f - cos_max);
  float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
  float phi = kTwoPi * u2;
  V3 axis = fabsf(wc.x) > 0.9f ? v3(0.0f, 1.0f, 0.0f) : v3(1.0f, 0.0f, 0.0f);
  V3 tang = cross(axis, wc);
  tang = div(tang, fmaxf(norm(tang), 1e-20f));
  V3 bitang = cross(wc, tang);
  V3 w_l = add(add(scale(cos_t, wc), scale(sin_t * cosf(phi), tang)),
               scale(sin_t * sinf(phi), bitang));
  float cos_x = dot(n_ff, w_l);
  float s_t;
  bool s_hit = ray_sphere(o, w_l, light_pos, a.light_r2, s_t);
  // lit = cos_x > 0 & s_hit & (no triangle hit | s_t < nearest t)
  if (!(cos_x > 0.0f) || !s_hit) return false;
  if (any_hit_within<kCount>(tab, kStride, num_tris, o, w_l, s_t, a.t_max, a.eps, tests)) {
    return false;
  }
  float omega = kTwoPi * (1.0f - cos_max);
  float gain = cos_x * omega * kInvPi;
  bank = scale(gain, mul(accum, light_hdr));
  return true;
}

// One path from the camera (ops/pathtrace.trace_paths); ``state`` is the
// post-jitter state, passed by value as GLSL does (raytrace.comp.glsl:200).
// kNee / kRr compile NEE and Russian roulette in or out, kCount the count
// of triangle tests, so that the parity mode keeps its register count.
template <bool kNee, bool kRr, bool kCount>
__device__ __forceinline__ V3 trace_path(const float* tab, int num_tris, V3 o, V3 d,
                                         uint32_t state, V3 light_pos, V3 light_hdr,
                                         const TraceArgs& a, int& tests) {
  V3 accum = {1.0f, 1.0f, 1.0f};
  V3 result = {0.0f, 0.0f, 0.0f};
  bool alive = true;
  for (int seg = 0; seg < a.max_bounces; ++seg) {
    Hit h = nearest_hit(tab, kStride, num_tris, o, d, a.t_max, a.eps);
    if (kCount) tests += num_tris;
    float light_t;
    bool light_hit = ray_sphere(o, d, light_pos, a.light_r2, light_t);
    if (!a.light_through_walls || kNee) light_hit = light_hit && (!h.hit || light_t < h.t);
    if (light_hit) {  // light termination, checked first (raytrace:226-235)
      // under NEE only the camera segment adds the emission
      if (!kNee || seg == 0) {
        float dim = seg == 0 ? a.first_dim : 1.0f;
        result = scale(dim, mul(accum, light_hdr));
      }
      alive = false;
      break;
    }
    if (!h.hit) {  // sky termination (raytrace:263-268); NEE adds to its bank
      V3 sky_c = mul(accum, sky(d));
      result = kNee ? add(result, sky_c) : sky_c;
      alive = false;
      break;
    }
    // diffuse bounce (raytrace:238-262)
    const float* row = tab + h.prim * kStride;
    accum = mul(accum, load3(row + 24));
    V3 n = load3(row + 21);
    V3 n_ff = dot(d, n) < 0.0f ? n : neg(n);
    V3 hit_pos = hit_position(tab, kStride, h);
    o = add(hit_pos, scale(a.ray_eps, n_ff));
    V3 nd = add(n_ff, random_unit_sphere(state));
    d = div(nd, norm(nd));
    V3 bank;
    if (kNee && nee_sample<kCount>(tab, num_tris, o, n_ff, accum, state, light_pos, light_hdr, a, bank,
                            tests)) {
      result = add(result, bank);
    }
    if (kRr && seg >= a.rr_start) {  // Russian roulette
      float u = pcg_step(state);
      float p = fminf(fmaxf(fmaxf(fmaxf(accum.x, accum.y), accum.z), a.rr_min), a.rr_max);
      if (!(u < p)) {  // killed: keeps its result, takes no fall-through
        alive = false;
        break;
      }
      accum = div(accum, p);
    }
  }
  // loop fall-through: surviving paths return the bare albedo product,
  // unless NEE or truncate_radiance drops it
  return alive && !kNee && !a.truncate ? accum : result;
}

// The body of both kernels: one pixel. params: cam[0:3] rot[3:12]
// light_pos[12:15] light_color_hdr[15:18]. Without kMulti the launch has one
// batch of one sample, and the loops hold no state across the path.
template <bool kNee, bool kRr, bool kCount, bool kMulti>
__device__ __forceinline__ void trace_pixel(const float* __restrict__ table, int num_tris,
                                            const float* __restrict__ params, const TraceArgs& a,
                                            float* __restrict__ out, int* __restrict__ tests_out) {
  extern __shared__ float smem[];
  __shared__ float prm[18];
  int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < 18) prm[tid] = params[tid];
  stage_table(smem, table, num_tris * kStride);

  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= a.width || y >= a.height) return;

  V3 cam = load3(prm);
  V3 light_pos = load3(prm + 12);
  V3 light_hdr = load3(prm + 15);
  int tests = 0;
  V3 total = {0.0f, 0.0f, 0.0f};
  const int batches = kMulti ? a.batches : 1;
  const int spp = kMulti ? a.spp : 1;
  for (int b = 0; b < batches; ++b) {
    uint32_t state = seed_per_pixel((uint32_t)x, (uint32_t)y, (uint32_t)a.frame, (uint32_t)b);
    V3 summed = {0.0f, 0.0f, 0.0f};
    for (int s = 0; s < spp; ++s) {
      float gx, gy;
      random_gaussian(state, gx, gy);
      V3 d = pixel_ray(x, y, a.aa_sigma * gx, a.aa_sigma * gy, a.width, a.height, a.slope,
                       prm + 3);
      summed = add(summed, trace_path<kNee, kRr, kCount>(smem, num_tris, cam, d, state, light_pos,
                                                         light_hdr, a, tests));
    }
    total = add(total, div(summed, (float)spp));
  }
  int pix = y * a.width + x;
  store3(out + 3 * pix, div(total, (float)batches));
  if (kCount) tests_out[pix] = tests;
}

// One sample per pixel (spp = sample_batches = 1).
template <bool kNee, bool kRr, bool kCount>
__global__ void trace_kernel(const float* __restrict__ table, int num_tris,
                             const float* __restrict__ params, TraceArgs a,
                             float* __restrict__ out, int* __restrict__ tests_out) {
  trace_pixel<kNee, kRr, kCount, false>(table, num_tris, params, a, out, tests_out);
}

// The sample and batch loops.
template <bool kNee, bool kRr, bool kCount>
__global__ void __launch_bounds__(256, 4)
    trace_samples_kernel(const float* __restrict__ table, int num_tris,
                         const float* __restrict__ params, TraceArgs a,
                         float* __restrict__ out, int* __restrict__ tests_out) {
  trace_pixel<kNee, kRr, kCount, true>(table, num_tris, params, a, out, tests_out);
}

using TraceFn = void (*)(const float*, int, const float*, TraceArgs, float*, int*);

template <bool kNee, bool kRr>
TraceFn pick_trace(bool count, bool multi) {
  if (multi) {
    return count ? trace_samples_kernel<kNee, kRr, true> : trace_samples_kernel<kNee, kRr, false>;
  }
  return count ? trace_kernel<kNee, kRr, true> : trace_kernel<kNee, kRr, false>;
}

}  // namespace

extern "C" int ptsf_trace(const float* table, int num_tris, const float* params, int width,
                          int height, int frame, int max_bounces, int spp, int batches,
                          float slope, float aa_sigma, float ray_eps, float t_max, float eps,
                          float light_r, float light_r2, float first_dim,
                          int light_through_walls, int nee, int rr_start, float rr_min,
                          float rr_max, int truncate, float* out, int* tests_out,
                          cudaStream_t stream) {
  TraceArgs a = {width,   height,   frame,   max_bounces, spp,       batches,
                 slope,   aa_sigma, ray_eps, t_max,       eps,       light_r,
                 light_r2, first_dim, light_through_walls, rr_start, truncate, rr_min,
                 rr_max};
  dim3 block(16, 16);
  dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  size_t smem = sizeof(float) * num_tris * kStride;
  bool count = tests_out != nullptr;
  bool multi = spp != 1 || batches != 1;
  TraceFn kernel = nee ? (rr_start > 0 ? pick_trace<true, true>(count, multi)
                                       : pick_trace<true, false>(count, multi))
                       : (rr_start > 0 ? pick_trace<false, true>(count, multi)
                                       : pick_trace<false, false>(count, multi));
  kernel<<<grid, block, smem, stream>>>(table, num_tris, params, a, out, tests_out);
  return (int)cudaGetLastError();
}
