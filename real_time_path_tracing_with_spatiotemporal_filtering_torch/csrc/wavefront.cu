// Segment tracer for large scenes: one launch per path segment over rays
// kept in device memory, and the bounce-0 shadow walk.
//
// trace_segment replaces the TPU kernel _wavefront_kernel
// (real_time_path_tracing_with_spatiotemporal_filtering_tpu/ops/pallas/wavefront.py:300),
// shadow_segment replaces _shadow_kernel (ops/pallas/wavefront.py:487
// there). The host loop is ops/cuda/wavefront.path_trace_wavefront.
//
// trace_segment: one thread per ray runs one segment (bounce.cuh, the body
// the one-launch tracer runs too) with the LBVH as its scene (bvh.cuh): the
// nearest-hit walk, the shading and, under NEE, the shadow walk. The ray
// state is flat structure-of-arrays in device memory, updated in place: 12
// float planes (origin, direction, throughput, result; x, y, z each), the
// uint32 PCG state and an int32 alive flag -- 14 words, 116 MB at
// 1920x1080. Segment 0 generates the primary ray from the pixel index and
// the PCG seed, as trace_kernel does (sample s of a batch starts from the
// seed advanced past the 2s jitter draws of the samples before it). A dead
// ray returns at once, so the host launches every segment without reading
// back how many rays live. The TPU kernel re-sorted the rays between
// segments to make its cluster culling work; a per-thread walk needs no
// sort (a sort would only change which boxes get tested, never the hit),
// so none is done yet.
//
// What bounds it on the H100: the walks' dependent loads (a node row, then
// its children) and divergence, not bytes: a live ray moves 108 bytes of
// state per segment, against ~22 node visits and ~3 triangle tests (path A
// on 32,768 triangles, counted by the kernel).
//
// shadow_segment: an any-hit walk per lane, capped at the sphere-entry
// distance (ops/pathtrace's deferred NEE sample of the G-buffer-seeded
// bounce 0), writing one int32 "occluded" plane. Inputs: 7 float planes
// (origin, light-sample direction, cap) and the int32 mask of lanes that
// sampled the light.

#include "bounce.cuh"

namespace {

using namespace ptsf;

struct SegArgs {
  int n, seg, batch, sample;
};

// params: cam[0:3] rot[3:12] light_pos[12:15] light_color_hdr[15:18]
template <bool kNee, bool kRr, bool kCount>
__global__ void trace_segment_kernel(BvhTable sc, const float* __restrict__ params, TraceArgs a,
                                     SegArgs s, float* __restrict__ rays,
                                     uint32_t* __restrict__ state, int* __restrict__ alive,
                                     int* __restrict__ counts, int* seen_node, int* seen_tri) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= s.n) return;
  const int n = s.n;
  PathState p;
  if (s.seg == 0) {
    int x = i % a.width, y = i / a.width;
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
    if (!alive[i]) return;
    p.o = {rays[i], rays[n + i], rays[2 * n + i]};
    p.d = {rays[3 * n + i], rays[4 * n + i], rays[5 * n + i]};
    p.accum = {rays[6 * n + i], rays[7 * n + i], rays[8 * n + i]};
    p.result = {rays[9 * n + i], rays[10 * n + i], rays[11 * n + i]};
    p.state = state[i];
  }
  Counts c = {0, 0, seen_node, seen_tri};
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
  if (kCount) {
    counts[i] += c.tri;
    counts[n + i] += c.box;
  }
}

template <bool kCount>
__global__ void shadow_segment_kernel(BvhScene sc, const float* __restrict__ planes,
                                      const int* __restrict__ mask, int n, float t_max, float eps,
                                      int* __restrict__ occluded, int* __restrict__ counts,
                                      int* seen_node, int* seen_tri) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (!mask[i]) {
    occluded[i] = 0;
    return;
  }
  V3 o = {planes[i], planes[n + i], planes[2 * n + i]};
  V3 w = {planes[3 * n + i], planes[4 * n + i], planes[5 * n + i]};
  Counts c = {0, 0, seen_node, seen_tri};
  occluded[i] = bvh_any_hit_within<kCount>(sc, o, w, planes[6 * n + i], t_max, eps, c) ? 1 : 0;
  if (kCount) {
    counts[i] += c.tri;
    counts[n + i] += c.box;
  }
}

using SegmentFn = void (*)(BvhTable, const float*, TraceArgs, SegArgs, float*, uint32_t*, int*,
                           int*, int*, int*);

template <bool kNee, bool kRr>
SegmentFn pick_segment(bool count) {
  return count ? trace_segment_kernel<kNee, kRr, true> : trace_segment_kernel<kNee, kRr, false>;
}

constexpr int kBlock = 256;

}  // namespace

extern "C" int ptsf_trace_segment(const float* nodes, const float* tris, const float* v0,
                                  const float* e1, const float* e2, const float* normals,
                                  const float* albedo, const float* params, int n, int width,
                                  int height, int frame, int batch, int sample, int seg,
                                  float slope, float aa_sigma, float ray_eps, float t_max,
                                  float eps, float light_r, float light_r2, float first_dim,
                                  int light_through_walls, int nee, int rr_start, float rr_min,
                                  float rr_max, float* rays, int* state, int* alive, int* counts,
                                  int* seen_node, int* seen_tri, cudaStream_t stream) {
  BvhTable sc = {{reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(tris),
                  v0, e1, e2, normals, albedo}};
  TraceArgs a = {width,   height,   frame,   0,     1,        1,        slope,
                 aa_sigma, ray_eps, t_max,   eps,   light_r,  light_r2, first_dim,
                 light_through_walls, rr_start, 0, rr_min, rr_max};
  SegArgs s = {n, seg, batch, sample};
  bool count = counts != nullptr;
  SegmentFn kernel = nee ? (rr_start > 0 ? pick_segment<true, true>(count)
                                         : pick_segment<true, false>(count))
                         : (rr_start > 0 ? pick_segment<false, true>(count)
                                         : pick_segment<false, false>(count));
  kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
      sc, params, a, s, rays, reinterpret_cast<uint32_t*>(state), alive, counts, seen_node,
      seen_tri);
  return (int)cudaGetLastError();
}

extern "C" int ptsf_shadow_segment(const float* nodes, const float* tris, const float* planes,
                                   const int* mask, int n, float t_max, float eps, int* occluded,
                                   int* counts, int* seen_node, int* seen_tri,
                                   cudaStream_t stream) {
  BvhScene sc = {reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(tris),
                 nullptr, nullptr, nullptr, nullptr, nullptr};
  if (counts != nullptr) {
    shadow_segment_kernel<true><<<(n + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
        sc, planes, mask, n, t_max, eps, occluded, counts, seen_node, seen_tri);
  } else {
    shadow_segment_kernel<false><<<(n + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
        sc, planes, mask, n, t_max, eps, occluded, counts, seen_node, seen_tri);
  }
  return (int)cudaGetLastError();
}
