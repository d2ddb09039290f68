// Segment tracer for large scenes: one launch per path segment over rays
// kept in device memory, and the bounce-0 shadow walk.
//
// trace_segment replaces the TPU kernel _wavefront_kernel
// (real_time_path_tracing_with_spatiotemporal_filtering_tpu/ops/pallas/wavefront.py:300),
// shadow_segment replaces _shadow_kernel (ops/pallas/wavefront.py:487
// there). The host loop is ops/cuda/wavefront.path_trace_wavefront.
//
// trace_segment: one segment (bounce.cuh, the body the one-launch tracer
// runs too) per live ray, with the LBVH as its scene (bvh.cuh): the
// nearest-hit walk, the shading and, under NEE, the shadow walk. The ray
// state is flat structure-of-arrays in device memory, updated in place: 12
// float planes (origin, direction, throughput, result; x, y, z each), the
// uint32 PCG state and an int32 alive flag -- 14 words, 116 MB at
// 1920x1080. Segment 0 generates the primary ray from the pixel and the
// PCG seed, as trace_kernel does (sample s of a batch starts from the seed
// advanced past the 2s jitter draws of the samples before it). The pixel of
// ray i is (i % width, i / width) over a whole frame, or (px[i], py[i]) in
// the explicit-pixel mode (the pixel-list half of the TPU kernel, its
// trace_pixels_wavefront: the path gradient's stratum pixels, the multi-res
// coarse tail). The seed is always that of the global pixel, so a ray traces
// what that pixel of a full frame would, bit for bit. A row slab of the
// frame (the row-sharded frame of parallel/; the TPU kernel's row_offset)
// gives the kernel its first global row: ray i is then pixel
// (i % width, row_offset + i / width), and n = rows x width; the live lists
// and the ray state are sized to the slab.
//
// What bounds it on the H100: the walks' dependent loads (a node row, then
// its children) and divergence, not bytes: a live ray moves 108 bytes of
// state per segment, against ~22 node visits and ~3 triangle tests (path A
// on 32,768 triangles, counted by the kernel). With one thread per ray slot
// over all n rays, every launch ran n threads, and a segment's live rays sat
// among dead lanes in warps that each lasted as long as their longest walk.
// Now:
//
// - In-kernel live-ray compaction. A launch reads a list of live ray slots
//   and its count from device memory and appends each ray that goes on to
//   the next list, one atomicAdd per warp. The first launch of a path (the
//   frame, the pixel list, or the G-buffer seed's rays at segment 1) runs
//   every slot and reads the alive flags. Three lists rotate, so each launch
//   zeroes the counters of the list it neither reads nor writes: no launch is
//   added and nothing is read back to the host.
// - Persistent work fetching. The grid is the card's resident blocks; warps
//   take 32 listed slots at a time from the list's fetch counter until it
//   runs out. A launch whose live rays do not fill the grid's warps spreads
//   them evenly over the warps instead: packed 32 to a warp, a late
//   segment's few thousand rays ran as long as a warp's longest walk with
//   its divergence, on a card otherwise idle (measured: the late launches
//   of paths D and E took 1.6-2x those of one thread per slot).
// - The ray state stays in slot order and a thread reads and writes only the
//   slots it runs, so every ray's bits are what one thread per slot gave,
//   and the counters index by slot.
//
// The TPU kernel re-sorted the rays between segments by an (octant, origin
// cell) key for its cluster culling. Here the listed order keeps the rays a
// warp ran together, which were neighbouring pixels at segment 0; re-sorting
// the live list by that key made the segments themselves slower on paths A
// and B, before counting the sort (segment_sort_ab.py), so none is done.
//
// shadow_segment: an any-hit walk per lane of ``mask``, capped at the
// sphere-entry distance (ops/pathtrace's deferred NEE sample of the
// G-buffer-seeded bounce 0), writing one int32 "occluded" plane (0 outside
// the mask), one thread a lane. Its inputs are read where
// ops/cuda/wavefront._seed_from_gbuffer made them: origins and light-sample
// directions (N, 3), caps (N,) and the bool mask (N,). Like the geometry
// kernel's, its walk is bounded by latency, so what counts is warps in
// flight and lanes that step together. The rays of a frame are taken 8x4
// pixels a warp, as the geometry kernel takes them (their walks agree more
// than a row of 32's); a list of rays in no frame order, 32 consecutive
// lanes a warp. Queueing the lanes of the mask into full warps, with or
// without refilling a lane when its walk ends, left fewer warps to hide the
// walks' latency and measured slower, as did a walk shared by the warp
// (these rays diverge: the union of a warp's walks is ~3x a walk; PERF.md).

#include "bounce.cuh"

namespace {

using namespace ptsf;

constexpr int kBlock = 256;

struct SegArgs {
  int n, seg, batch, sample;
  const int* px;  // explicit pixels (both null: ray i is pixel i of the slab)
  const int* py;
  int row_offset;  // the slab's first global row (frame order only)
};

// The live lists of a launch (ops/cuda/wavefront.LiveLists): three rotating
// lists of ray slots, each with two counters [listed, fetched]. A launch
// runs the slots of the list it reads (null: every slot 0..n-1, the first
// launch of a path; the fetch counter of in_ctr is used either way),
// appends the slots of the rays that go on to the list it writes, and
// zeroes the counters of the third.
struct LiveArgs {
  const int* in;
  int* in_ctr;
  int* out;
  int* out_ctr;
  int* zero_ctr;
};

// One segment of ray ``i`` (the body of the one-thread-per-ray kernel of
// earlier versions): segment 0 generates the ray, a later one loads it;
// runs the bounce and writes the ray back. Returns whether the ray goes on.
template <bool kNee, bool kRr, bool kCount>
__device__ __forceinline__ bool segment_ray(const BvhTable& sc, const float* __restrict__ params,
                                            const TraceArgs& a, const SegArgs& s, int i,
                                            float* __restrict__ rays,
                                            uint32_t* __restrict__ state,
                                            int* __restrict__ alive, Counts& c) {
  const int n = s.n;
  PathState p;
  if (s.seg == 0) {
    int x, y;
    if (s.px != nullptr) {
      x = s.px[i];
      y = s.py[i];
    } else {
      x = i % a.width;
      y = s.row_offset + i / a.width;
    }
    uint32_t st = seed_per_pixel((uint32_t)x, (uint32_t)y, (uint32_t)a.frame, (uint32_t)s.batch);
    for (int k = 0; k < 2 * s.sample; ++k) st = st * 747796405u + 1u;
    float gx, gy;
    random_gaussian(st, gx, gy);
    p.o = load3(params);
    p.d = pixel_ray(x, y, a.aa_sigma * gx, a.aa_sigma * gy, a.width, a.height, a.slope,
                    params + 3);
    p.accum = {1.0f, 1.0f, 1.0f};
    p.result = {0.0f, 0.0f, 0.0f};
    p.state = st;
  } else {
    p.o = {rays[i], rays[n + i], rays[2 * n + i]};
    p.d = {rays[3 * n + i], rays[4 * n + i], rays[5 * n + i]};
    p.accum = {rays[6 * n + i], rays[7 * n + i], rays[8 * n + i]};
    p.result = {rays[9 * n + i], rays[10 * n + i], rays[11 * n + i]};
    p.state = state[i];
  }
  bool go = bounce<kNee, kRr, kCount>(sc, s.seg, p, load3(params + 12), load3(params + 15), a, c);
  rays[i] = p.o.x;
  rays[n + i] = p.o.y;
  rays[2 * n + i] = p.o.z;
  rays[3 * n + i] = p.d.x;
  rays[4 * n + i] = p.d.y;
  rays[5 * n + i] = p.d.z;
  rays[6 * n + i] = p.accum.x;
  rays[7 * n + i] = p.accum.y;
  rays[8 * n + i] = p.accum.z;
  rays[9 * n + i] = p.result.x;
  rays[10 * n + i] = p.result.y;
  rays[11 * n + i] = p.result.z;
  state[i] = p.state;
  alive[i] = go ? 1 : 0;
  return go;
}

// params: cam[0:3] rot[3:12] light_pos[12:15] light_color_hdr[15:18]
// Persistent warps: each step a warp takes 32 slots (of the list read, or of
// every slot), first its own static ones, then a chunk from the fetch
// counter (one atomicAdd per warp), runs them, and appends the slots that go
// on with one atomicAdd per warp (__ballot_sync / __popc). When the slots do
// not fill the grid's warps, they are spread over all of them instead.
template <bool kNee, bool kRr, bool kCount>
__global__ void __launch_bounds__(kBlock)
    trace_segment_kernel(BvhTable sc, const float* __restrict__ params, TraceArgs a, SegArgs s,
                         LiveArgs live, float* __restrict__ rays, uint32_t* __restrict__ state,
                         int* __restrict__ alive, int* __restrict__ counts, int* seen_node,
                         int* seen_tri, unsigned long long* __restrict__ lanes) {
  if (blockIdx.x == 0 && threadIdx.x < 2) live.zero_ctr[threadIdx.x] = 0;
  const unsigned lane = lane_id();
  const int total = live.in != nullptr ? live.in_ctr[0] : s.n;
  const int warps = (int)(gridDim.x * blockDim.x) / 32;
  // Slots a warp runs at a step: 32 while the slots fill the grid's warps,
  // else spread evenly over them (fewer rays in a warp diverge less, and
  // the grid's other warps hide the walks' latency), in one static pass.
  const int per = total >= 32 * warps ? 32 : (total + warps - 1) / warps;
  // A warp's first slots are static; then chunks of 32 from the fetch
  // counter of the list read (zero at the launch's start, also when no list
  // is read).
  int* fetch = live.in_ctr + 1;
  Counts c = {0, 0, seen_node, seen_tri};
  unsigned loop_lanes = 0, loop_steps = 0;
  for (int base = (int)(blockIdx.x * blockDim.x + threadIdx.x) / 32 * per; base < total;) {
    int k = base + (int)lane;
    int i = -1;
    if ((int)lane < per && k < total) i = live.in != nullptr ? live.in[k] : k;
    // a listed slot is alive; without a list a dead ray is left untouched
    bool run = i >= 0 && (live.in != nullptr || s.seg == 0 || alive[i] != 0);
    bool go = false;
    if (run) {
      if (kCount) {
        count_lanes(loop_lanes, loop_steps);
        c.tri = c.box = 0;
      }
      go = segment_ray<kNee, kRr, kCount>(sc, params, a, s, i, rays, state, alive, c);
      if (kCount) {
        counts[i] += c.tri;
        counts[s.n + i] += c.box;
      }
    }
    unsigned m = __ballot_sync(kFullMask, go);
    int at = 0;
    if (lane == 0 && m != 0) at = atomicAdd(live.out_ctr, __popc(m));
    at = __shfl_sync(kFullMask, at, 0);
    if (go) live.out[at + __popc(m & lanes_below())] = i;
    if (per < 32) break;  // the static pass held every slot
    int got = 0;
    if (lane == 0) got = atomicAdd(fetch, 32);
    base = 32 * warps + __shfl_sync(kFullMask, got, 0);
  }
  if (kCount && lanes != nullptr) flush_lanes(lanes, loop_lanes, loop_steps, c);
}

// The rays of shadow_segment, read in place; ``width`` > 0: they are a
// frame's pixels in raster order, ``width`` to a row (0: any order).
struct ShadowArgs {
  const float* origins;       // (n, 3)
  const float* dirs;          // (n, 3)
  const float* cap;           // (n,)
  const unsigned char* mask;  // (n,) bool
  int n, width;
  float t_max, eps;
  int* occluded;
};

constexpr int kShadowTileW = 8, kShadowTileH = 4;  // a warp's pixels in a frame

// Under kCount, ``counts`` (2, n) receives each lane's triangle and box
// tests, and seen_node / seen_tri the rows read; ``lanes`` (4,), when not
// null, the lane counts (flush_lanes): lanes of the mask and warps, then
// the walk's lanes and steps.
template <bool kCount>
__global__ void shadow_segment_kernel(BvhScene sc, ShadowArgs a, int* __restrict__ counts,
                                      int* seen_node, int* seen_tri,
                                      unsigned long long* __restrict__ lanes) {
  int i = blockIdx.x * kBlock + threadIdx.x;
  if (a.width > 0) {  // tile (tx, ty) of the frame's pixels
    const int warp = i / 32, lane = i % 32, tiles_x = (a.width + kShadowTileW - 1) / kShadowTileW;
    const int x = warp % tiles_x * kShadowTileW + lane % kShadowTileW;
    const int y = warp / tiles_x * kShadowTileH + lane / kShadowTileW;
    i = x < a.width ? y * a.width + x : a.n;  // rows past the last give i >= n
  }
  Counts c = {0, 0, seen_node, seen_tri};
  unsigned ray_lanes = 0, warps = 0;
  if (i < a.n) {
    bool hit = false;
    if (a.mask[i] != 0) {
      if (kCount) count_lanes(ray_lanes, warps);
      hit = bvh_any_hit_within<kCount>(sc, load3(a.origins + 3 * i), load3(a.dirs + 3 * i),
                                       a.cap[i], a.t_max, a.eps, c);
      if (kCount) {
        counts[i] += c.tri;
        counts[a.n + i] += c.box;
      }
    }
    a.occluded[i] = hit ? 1 : 0;
  }
  if (kCount && lanes != nullptr) flush_lanes(lanes, ray_lanes, warps, c);
}

using SegmentFn = void (*)(BvhTable, const float*, TraceArgs, SegArgs, LiveArgs, float*,
                           uint32_t*, int*, int*, int*, int*, unsigned long long*);

template <bool kNee, bool kRr>
SegmentFn pick_segment(bool count) {
  return count ? trace_segment_kernel<kNee, kRr, true> : trace_segment_kernel<kNee, kRr, false>;
}

}  // namespace

extern "C" int ptsf_trace_segment(const float* nodes, const float* tris, const float* v0,
                                  const float* e1, const float* e2, const float* normals,
                                  const float* albedo, const float* params, int n, int width,
                                  int height, int row_offset, int frame, int batch, int sample,
                                  int seg,
                                  float slope, float aa_sigma, float ray_eps, float t_max,
                                  float eps, float light_r, float light_r2, float first_dim,
                                  int light_through_walls, int nee, int rr_start, float rr_min,
                                  float rr_max, const int* px, const int* py,
                                  const int* live_in, int* live_in_ctr, int* live_out,
                                  int* live_out_ctr, int* live_zero_ctr, float* rays,
                                  int* state, int* alive, int* counts, int* seen_node,
                                  int* seen_tri, unsigned long long* lanes,
                                  cudaStream_t stream) {
  BvhTable sc = {{reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(tris),
                  v0, e1, e2, normals, albedo}};
  TraceArgs a = {width,   height,   frame,   0,     1,        1,        slope,
                 aa_sigma, ray_eps, t_max,   eps,   light_r,  light_r2, first_dim,
                 light_through_walls, rr_start, 0, rr_min, rr_max};
  SegArgs s = {n, seg, batch, sample, px, py, row_offset};
  LiveArgs live = {live_in, live_in_ctr, live_out, live_out_ctr, live_zero_ctr};
  bool count = counts != nullptr;  // ``lanes`` is written only with the other counts
  SegmentFn kernel = nee ? (rr_start > 0 ? pick_segment<true, true>(count)
                                         : pick_segment<true, false>(count))
                         : (rr_start > 0 ? pick_segment<false, true>(count)
                                         : pick_segment<false, false>(count));
  int ray_blocks = (n + kBlock - 1) / kBlock;
  int grid = resident_blocks(kernel, kBlock, 0);
  if (grid > ray_blocks) grid = ray_blocks;
  kernel<<<grid, kBlock, 0, stream>>>(sc, params, a, s, live, rays,
                                      reinterpret_cast<uint32_t*>(state), alive, counts,
                                      seen_node, seen_tri, lanes);
  return (int)cudaGetLastError();
}

extern "C" int ptsf_shadow_segment(const float* nodes, const float* tris, const float* origins,
                                   const float* dirs, const float* cap, const unsigned char* mask,
                                   int n, int width, float t_max, float eps, int* occluded,
                                   int* counts, int* seen_node, int* seen_tri,
                                   unsigned long long* lanes, cudaStream_t stream) {
  BvhScene sc = {reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(tris),
                 nullptr, nullptr, nullptr, nullptr, nullptr};
  ShadowArgs a = {origins, dirs, cap, mask, n, width, t_max, eps, occluded};
  long long threads = n;
  if (width > 0) {
    const long long rows = n / width;
    threads = 32LL * ((width + kShadowTileW - 1) / kShadowTileW) *
              ((rows + kShadowTileH - 1) / kShadowTileH);
  }
  const int grid = (int)((threads + kBlock - 1) / kBlock);
  if (grid == 0) return 0;
  auto kernel = counts != nullptr ? shadow_segment_kernel<true> : shadow_segment_kernel<false>;
  kernel<<<grid, kBlock, 0, stream>>>(sc, a, counts, seen_node, seen_tri, lanes);
  return (int)cudaGetLastError();
}
