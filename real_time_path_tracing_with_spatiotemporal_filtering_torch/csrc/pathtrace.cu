// Bounce-loop path tracer, one thread per pixel.
//
// Replaces the TPU kernel _trace_kernel
// (real_time_path_tracing_with_spatiotemporal_filtering_tpu/ops/pallas/pathtrace.py:1716).
// It computes ops/pathtrace.path_trace_pass: for each of sample_batches
// batches a per-pixel PCG seed, then spp samples, each a Gaussian AA jitter
// and a path of up to max_bounces segments (bounce.cuh, shared with the
// segment tracer of wavefront.cu) of nearest hit, sphere light
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

#include "bounce.cuh"

namespace {

using namespace ptsf;

// One path from the camera (ops/pathtrace.trace_paths); ``state`` is the
// post-jitter state, passed by value as GLSL does (raytrace.comp.glsl:200).
template <bool kNee, bool kRr, bool kCount>
__device__ __forceinline__ V3 trace_path(const DenseTable& sc, V3 o, V3 d, uint32_t state,
                                         V3 light_pos, V3 light_hdr, const TraceArgs& a,
                                         Counts& c) {
  PathState p = {o, d, {1.0f, 1.0f, 1.0f}, {0.0f, 0.0f, 0.0f}, state};
  bool alive = true;
  for (int seg = 0; seg < a.max_bounces; ++seg) {
    if (!bounce<kNee, kRr, kCount>(sc, seg, p, light_pos, light_hdr, a, c)) {
      alive = false;
      break;
    }
  }
  // loop fall-through: surviving paths return the bare albedo product,
  // unless NEE or truncate_radiance drops it
  return alive && !kNee && !a.truncate ? p.accum : p.result;
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
  stage_table(smem, table, num_tris * kTraceStride);

  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= a.width || y >= a.height) return;

  V3 cam = load3(prm);
  V3 light_pos = load3(prm + 12);
  V3 light_hdr = load3(prm + 15);
  DenseTable sc = {smem, num_tris};
  Counts c = {0, 0};
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
      summed = add(summed, trace_path<kNee, kRr, kCount>(sc, cam, d, state, light_pos, light_hdr,
                                                         a, c));
    }
    total = add(total, div(summed, (float)spp));
  }
  int pix = y * a.width + x;
  store3(out + 3 * pix, div(total, (float)batches));
  if (kCount) tests_out[pix] = c.tri;
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
  size_t smem = sizeof(float) * num_tris * kTraceStride;
  bool count = tests_out != nullptr;
  bool multi = spp != 1 || batches != 1;
  TraceFn kernel = nee ? (rr_start > 0 ? pick_trace<true, true>(count, multi)
                                       : pick_trace<true, false>(count, multi))
                       : (rr_start > 0 ? pick_trace<false, true>(count, multi)
                                       : pick_trace<false, false>(count, multi));
  kernel<<<grid, block, smem, stream>>>(table, num_tris, params, a, out, tests_out);
  return (int)cudaGetLastError();
}
