// Bounce-loop path tracer with pixel-persistent path regeneration.
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
// What bounds it on the H100: arithmetic and divergence. A path runs a
// data-dependent number of segments (1 to max_bounces), each testing all T
// triangles (~39 flops per test), plus under NEE one shadow walk per bounce
// that stops at the first occluder and runs the whole test only on the
// triangles whose plane the lane's segment to the light may cross
// (bounce.cuh DenseTable::occluded); a pixel writes 12 bytes at the end.
// With one thread per pixel and the sample loop around the path, a warp
// paid, for each sample, the longest path among its 32 lanes. Here a lane
// never waits on a neighbour's path:
//
// - The grid is the card's resident blocks. Warps take pixels from a
//   device counter (one per stream, ops/cuda/pathtrace.py), one
//   warp-aggregated atomicAdd per fetch; the last block to finish resets
//   the counter, so no launch is added. (A warp pool of 64
//   pixels per atomicAdd measured ~5% slower on the quality preset.)
// - Each lane runs its pixel's batches and samples in the plain order in
//   one flattened loop: one bounce per step; when the path ends it is folded
//   into the sample sum (and the batch total), and the next sample's jitter
//   starts from the carried post-jitter batch state (the path takes the
//   state by value, as GLSL does, raytrace.comp.glsl:200); after the last
//   batch the pixel is stored and the lane fetches another. A pixel's
//   operations and sum order are those of the plain version, so the image
//   is bit-equal whichever thread ran which pixel.
// - The triangle rows are staged into 128-byte shared-memory rows
//   (bounce.cuh): a test reads its 12 constants as three 16-byte loads, a
//   broadcast, since every lane of a warp tests the same row. The table is
//   staged once per persistent block.
//
// NEE, Russian roulette and the counting instantiation (whole triangle
// tests per pixel, each sample's path length, the lane efficiency of the
// bounce loop and of the triangle loops, and the lane and warp steps of the
// shadow loop's two passes, for chip_smoke.py) are template parameters,
// chosen at launch.
//
// A row slab (row_offset, rows: the row-sharded frame of parallel/, the TPU
// kernel's row_offset): the work counter runs over rows x width pixels,
// pixel p is global pixel (p % width, row_offset + p / width), whose seed,
// jitter and ray it traces, and the outputs hold rows x width pixels. The
// defaults (0, height) are the whole frame.

#include "bounce.cuh"

namespace {

using namespace ptsf;

constexpr int kBlock = 256;

struct TraceOut {
  float* out;            // (H, W, 3)
  int* tests;            // (H, W) whole triangle tests per pixel, or null
  int* path_len;         // (batches * spp, H, W) segments each sample's path ran, or null
  unsigned long long* lanes;  // 4 lane-efficiency sums (common.cuh flush_lanes), or null
  // the dense shadow loop's lane steps and warp steps of its plane pass and
  // of its barycentric pass (Counts::shadow), or null
  unsigned long long* shadow;
  // [next pixel to fetch, blocks finished]: zero at the start of a launch,
  // and reset by its last block (launches that share them run in order)
  int* fetch;
  int row_offset, rows;  // the slab: rows x width pixels from global row row_offset
};

// params: cam[0:3] rot[3:12] light_pos[12:15] light_color_hdr[15:18]
template <bool kNee, bool kRr, bool kCount>
__global__ void __launch_bounds__(kBlock)
    trace_kernel(const float* __restrict__ table, int num_tris,
                 const float* __restrict__ params, TraceArgs a, TraceOut o) {
  extern __shared__ float4 smem[];
  __shared__ float prm[18];
  if (threadIdx.x < 18) prm[threadIdx.x] = params[threadIdx.x];
  stage_rows(smem, table, num_tris);
  __syncthreads();

  const int npix = a.width * o.rows;
  const V3 cam = load3(prm);
  const V3 light_pos = load3(prm + 12);
  const V3 light_hdr = load3(prm + 15);
  const DenseTable sc = {smem, num_tris};
  const unsigned lane = lane_id();
  Counts c = {};
  unsigned loop_lanes = 0, loop_steps = 0;

  // The lane's pixel (npix and above: none left) and where its loops stand.
  int pix = -1, x = 0, y = 0, b = 0, s = 0, seg = 0;
  bool fetch = true;
  uint32_t batch_state = 0;
  V3 summed = {0.0f, 0.0f, 0.0f}, total = {0.0f, 0.0f, 0.0f};
  PathState p;

  // Sample s of the batch: the jitter draws advance the batch state, the
  // path starts from a copy of the post-jitter state.
  auto start_sample = [&]() {
    float gx, gy;
    random_gaussian(batch_state, gx, gy);
    V3 d = pixel_ray(x, y, a.aa_sigma * gx, a.aa_sigma * gy, a.width, a.height, a.slope, prm + 3);
    p = {cam, d, {1.0f, 1.0f, 1.0f}, {0.0f, 0.0f, 0.0f}, batch_state};
    seg = 0;
  };

  while (true) {
    unsigned want = __ballot_sync(kFullMask, fetch);
    if (want != 0) {
      // one atomicAdd for all the lanes that want a pixel, in lane order
      int leader = __ffs(want) - 1;
      int base = 0;
      if ((int)lane == leader) base = atomicAdd(o.fetch, __popc(want));
      base = __shfl_sync(kFullMask, base, leader);
      if (fetch) {
        fetch = false;
        pix = base + __popc(want & lanes_below());
        if (pix < npix) {
          x = pix % a.width;
          y = o.row_offset + pix / a.width;
          b = s = 0;
          summed = total = {0.0f, 0.0f, 0.0f};
          batch_state = seed_per_pixel((uint32_t)x, (uint32_t)y, (uint32_t)a.frame, 0u);
          start_sample();
        }
      }
    }
    bool has = pix >= 0 && pix < npix;
    if (!__any_sync(kFullMask, has)) break;
    if (!has) continue;
    if (kCount) count_lanes(loop_lanes, loop_steps);
    bool go = bounce<kNee, kRr, kCount>(sc, seg, p, light_pos, light_hdr, a, c);
    ++seg;
    if (go && seg < a.max_bounces) continue;
    // the path ended: the loop fall-through returns a surviving path's bare
    // throughput, unless NEE or truncate_radiance drops it
    if (kCount && o.path_len != nullptr) o.path_len[(b * a.spp + s) * npix + pix] = seg;
    summed = add(summed, go && !kNee && !a.truncate ? p.accum : p.result);
    if (++s == a.spp) {
      total = add(total, div(summed, (float)a.spp));
      summed = {0.0f, 0.0f, 0.0f};
      s = 0;
      if (++b == a.batches) {
        store3(o.out + 3 * pix, div(total, (float)a.batches));
        if (kCount && o.tests != nullptr) o.tests[pix] = c.tri;
        c.tri = 0;
        fetch = true;
        continue;
      }
      batch_state = seed_per_pixel((uint32_t)x, (uint32_t)y, (uint32_t)a.frame, (uint32_t)b);
    }
    start_sample();
  }
  if (kCount && o.lanes != nullptr) flush_lanes(o.lanes, loop_lanes, loop_steps, c);
  if (kCount && o.shadow != nullptr) flush_sums(o.shadow, c.shadow);

  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(o.fetch + 1, 1) == (int)gridDim.x - 1) {
      atomicExch(o.fetch, 0);
      atomicExch(o.fetch + 1, 0);
    }
  }
}

// A test hook, launched by no frame: for the card tests of the shadow
// loop's plane cut, ray i (rays[8 i:], o, d, cap, t_max) asks
// DenseTable::occluded (out[2 i]) and, the same question, the whole test of
// every triangle (out[2 i + 1]); t[i] is the least t of a valid hit,
// whatever cap (infinite if none).
__global__ void occluded_probe_kernel(const float* __restrict__ table, int num_tris,
                                      const float* __restrict__ rays, int n, float eps,
                                      float* t, int* out) {
  extern __shared__ float4 smem[];
  stage_rows(smem, table, num_tris);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const DenseTable sc = {smem, num_tris};
  const float* r = rays + 8 * i;
  const V3 o = load3(r), d = load3(r + 3);
  const float cap = r[6], t_max = r[7];
  bool every = false;
  float least = INFINITY;
  for (int k = 0; k < num_tris; ++k) {
    float tk, u, v;
    bool valid = sc.test(k, o, d, t_max, eps, tk, u, v);
    every |= valid && tk <= cap;
    if (valid) least = fminf(least, tk);
  }
  Counts c = {};
  t[i] = least;
  out[2 * i] = sc.occluded<false>(o, d, cap, t_max, eps, c);
  out[2 * i + 1] = every;
}

using TraceFn = void (*)(const float*, int, const float*, TraceArgs, TraceOut);

template <bool kNee, bool kRr>
TraceFn pick_trace(bool count) {
  return count ? trace_kernel<kNee, kRr, true> : trace_kernel<kNee, kRr, false>;
}

}  // namespace

extern "C" int ptsf_trace(const float* table, int num_tris, const float* params, int width,
                          int height, int row_offset, int rows, int frame, int max_bounces,
                          int spp, int batches,
                          float slope, float aa_sigma, float ray_eps, float t_max, float eps,
                          float light_r, float light_r2, float first_dim,
                          int light_through_walls, int nee, int rr_start, float rr_min,
                          float rr_max, int truncate, int* fetch, float* out, int* tests_out,
                          int* path_len, unsigned long long* lanes,
                          unsigned long long* shadow, cudaStream_t stream) {
  TraceArgs a = {width,   height,   frame,   max_bounces, spp,       batches,
                 slope,   aa_sigma, ray_eps, t_max,       eps,       light_r,
                 light_r2, first_dim, light_through_walls, rr_start, truncate, rr_min,
                 rr_max};
  if (row_offset < 0 || rows < 1 || row_offset + rows > height) return (int)cudaErrorInvalidValue;
  TraceOut o = {out, tests_out, path_len, lanes, shadow, fetch, row_offset, rows};
  size_t smem = sizeof(float4) * kRowVec * num_tris;
  bool count =
      tests_out != nullptr || path_len != nullptr || lanes != nullptr || shadow != nullptr;
  TraceFn kernel = nee ? (rr_start > 0 ? pick_trace<true, true>(count)
                                       : pick_trace<true, false>(count))
                       : (rr_start > 0 ? pick_trace<false, true>(count)
                                       : pick_trace<false, false>(count));
  int pixel_blocks = (width * rows + kBlock - 1) / kBlock;
  int grid = resident_blocks(kernel, kBlock, smem);
  if (grid > pixel_blocks) grid = pixel_blocks;
  kernel<<<grid, kBlock, smem, stream>>>(table, num_tris, params, a, o);
  return (int)cudaGetLastError();
}

extern "C" int ptsf_occluded_probe(const float* table, int num_tris, const float* rays, int n,
                                   float eps, float* t, int* out, cudaStream_t stream) {
  constexpr int block = 128;
  occluded_probe_kernel<<<(n + block - 1) / block, block, sizeof(float4) * kRowVec * num_tris,
                          stream>>>(table, num_tris, rays, n, eps, t, out);
  return (int)cudaGetLastError();
}
