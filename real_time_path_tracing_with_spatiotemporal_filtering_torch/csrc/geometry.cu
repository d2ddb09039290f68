// Fused geometry pass: G-buffer, temporal gradient and backprojection.
//
// Two kernels over one epilogue. geometry_kernel replaces the TPU kernel
// _geometry_kernel
// (real_time_path_tracing_with_spatiotemporal_filtering_tpu/ops/pallas/geometry.py:116);
// geometry_bvh_kernel replaces _geometry_clustered_kernel
// (ops/pallas/geometry.py:388 there), its streamed Morton-cluster walk for
// large scenes, with an LBVH walk per pixel (bvh.cuh). The BVH kernel is
// bounded by the walk's latency, not by bytes or arithmetic: on 32,768
// triangles a primary ray visits ~11 nodes (22 box tests) and tests ~1
// triangle, each a dependent load from the L2-resident tables, and writes
// 44 bytes.
//
// geometry_kernel:
// One thread per pixel traces the center primary ray against every
// triangle, then computes, while the committed triangle is at hand, the
// outputs of ops/gbuffer.visibility_pass, ops/gradient.temporal_gradient_pass,
// ops/atrous.backproject_pixels and the filter normal lut_normals[vis]:
//   vis (H,W) f32, depth (H,W) f32, normal (H,W,3) f32, lam (H,W) f32,
//   prev_y / prev_x (H,W) i32, world (H,W,3) f32,
// and, when asked (emit_albedo, for albedo demodulation), the committed
// triangle's albedo (H,W,3) f32, 1.0 for the background
// (ops/atrous.albedo_image). The albedo is one load per pixel from a (T,3)
// array in global memory, so the shared table keeps its 42-float rows.
//
// What bounds it on the H100: arithmetic. Each pixel runs T ray/triangle
// tests (~40 flops each; T = 32 for the Cornell box) and writes 44 bytes, so
// at 1000x800 it moves ~35 MB and does ~1 GFLOP. The triangle rows (42
// floats each: 21 intersection constants, the unit normal, the current and
// the previous LUT vertices) sit in shared memory, read by every thread of
// a warp at the same address (a broadcast). The committed triangle's
// vertices are a direct load from that table, where the TPU kernel needed a
// select loop over all triangles.
//
// The arithmetic follows the plain PyTorch version operation for operation
// (see common.cuh): barycentrics are recombined as v0 + u e1 + v e2, not
// o + t d, and the Phong exponent 128 is seven squarings in both.

#include "bvh.cuh"

namespace {

using namespace ptsf;

constexpr int kStride = 42;  // 21 intersect | normal 3 | cur verts 9 | prev verts 9

__device__ __forceinline__ float area(V3 a, V3 b, V3 c) {
  return 0.5f * norm(cross(sub(b, a), sub(c, a)));
}

// getBarycentricCoordinates (ops/barycentric.py): (A_pbc, A_apc, A_abp) / A_abc
__device__ __forceinline__ V3 barycentric(V3 p, V3 a, V3 b, V3 c) {
  float total = fmaxf(area(a, b, c), 1e-20f);
  return {area(p, b, c) / total, area(a, p, c) / total, area(a, b, p) / total};
}

__device__ __forceinline__ V3 recombine(V3 w, V3 a, V3 b, V3 c) {
  return add(add(scale(w.x, a), scale(w.y, b)), scale(w.z, c));
}

__device__ __forceinline__ float pow128(float x) {
  for (int i = 0; i < 7; ++i) x = x * x;
  return x;
}

// phongShading (ops/shading.phong; temporalGradient.comp.glsl:71-101)
__device__ __forceinline__ V3 phong(V3 p, V3 n, V3 cam, V3 light_pos, V3 light_color) {
  V3 ld = sub(light_pos, p);
  ld = div(ld, norm(ld));
  V3 ambient = scale(0.1f, light_color);
  float diff = fmaxf(dot(n, ld), 0.0f);
  V3 diffuse = scale(diff, light_color);
  V3 vd = sub(cam, p);
  vd = div(vd, norm(vd));
  V3 inc = neg(ld);
  V3 refl = sub(inc, scale(2.0f * dot(n, inc), n));
  float spec = pow128(fmaxf(dot(vd, refl), 0.0f));
  V3 specular = scale(0.5f * spec, light_color);
  return scale(0.7f, add(add(ambient, diffuse), specular));
}

// float screen coordinate -> clamped pixel index, as ops/atrous.py does it
__device__ __forceinline__ int to_pixel(float s, int size) {
  if (isnan(s)) s = -1.0f;
  s = fminf(fmaxf(s, -1.0f), (float)size);
  int i = (int)s;  // truncation toward zero, GLSL int()
  return min(max(i, 0), size - 1);
}

// The outputs of both kernels, per pixel.
struct GeoOut {
  float *vis, *depth, *normal, *lam;
  int *py, *px;
  float* world;
  const float* albedo;  // (T, 3) triangle albedos, read when out_albedo is set
  float* out_albedo;    // null: no albedo planes
};

// The committed triangle's unit normal and its current and previous LUT
// vertices.
struct TriVerts {
  V3 normal, v1, v2, v3, p1, p2, p3;
};

// Everything after the nearest hit, for one pixel (shared by both kernels):
// depth, filter normal, temporal gradient, backprojection, albedo.
// prm: cam[0:3] rot[3:12] M[12:28] Mprev[28:44] light[44:47]
//      light_prev[47:50] color[50:53] color_prev[53:56]
__device__ __forceinline__ void geometry_epilogue(int x, int y, int width, int height,
                                                  const float* prm, const Hit& h, V3 world,
                                                  const TriVerts& tv, const GeoOut& o) {
  int pix = y * width + x;
  V3 cam = load3(prm);
  const float* M = prm + 12;
  const float* Mp = prm + 28;
  float vis = 0.0f, depth = 1.0f, lam = 0.0f;
  V3 normal = {0.0f, 0.0f, 1.0f};  // background sentinel, lut_normals[0]
  int py = y, px = x;  // background keeps its own pixel
  if (h.hit) {
    vis = (float)(h.prim + 1);
    float cz = M[8] * world.x + M[9] * world.y + M[10] * world.z + M[11];
    float cw = M[12] * world.x + M[13] * world.y + M[14] * world.z + M[15];
    depth = cz / cw;
    normal = tv.normal;

    // temporal gradient (ops/gradient.py)
    V3 ng = cross(sub(tv.v2, tv.v1), sub(tv.v3, tv.v1));
    ng = div(ng, fmaxf(norm(ng), 1e-20f));
    V3 prev_pos = recombine(barycentric(world, tv.v1, tv.v2, tv.v3), tv.p1, tv.p2, tv.p3);
    V3 cur = phong(world, ng, cam, load3(prm + 44), load3(prm + 50));
    V3 prv = phong(prev_pos, ng, cam, load3(prm + 47), load3(prm + 53));
    float delta = fmaxf(norm(cur), norm(prv));
    lam = fminf(norm(sub(cur, prv)) / fmaxf(delta, 1e-20f), 1.0f);

    // backprojection quirk: barycentrics against the PREVIOUS vertices
    // (ops/atrous.backproject_pixels; temporalFiltering.comp.glsl:221-229)
    V3 q = recombine(barycentric(world, tv.p1, tv.p2, tv.p3), tv.p1, tv.p2, tv.p3);
    float qx = Mp[0] * q.x + Mp[1] * q.y + Mp[2] * q.z + Mp[3];
    float qy = Mp[4] * q.x + Mp[5] * q.y + Mp[6] * q.z + Mp[7];
    float qw = Mp[12] * q.x + Mp[13] * q.y + Mp[14] * q.z + Mp[15];
    px = to_pixel((qx / qw * 0.5f + 0.5f) * (float)width, width);
    py = to_pixel((qy / qw * 0.5f + 0.5f) * (float)height, height);
  }
  o.vis[pix] = vis;
  o.depth[pix] = depth;
  store3(o.normal + 3 * pix, normal);
  o.lam[pix] = lam;
  o.py[pix] = py;
  o.px[pix] = px;
  store3(o.world + 3 * pix, world);
  if (o.out_albedo != nullptr) {
    store3(o.out_albedo + 3 * pix, h.hit ? load3(o.albedo + 3 * h.prim) : v3(1.0f, 1.0f, 1.0f));
  }
}

// Copy the 56 parameter floats into shared memory.
__device__ __forceinline__ void stage_params(float* prm, const float* __restrict__ params) {
  int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < 56) prm[tid] = params[tid];
}

// The dense kernel: every triangle of a shared-memory table, in index order.
__global__ void geometry_kernel(const float* __restrict__ table, int num_tris,
                                const float* __restrict__ params, int width, int height,
                                float slope, float t_max, float eps, GeoOut o) {
  extern __shared__ float smem[];
  __shared__ float prm[56];
  stage_params(prm, params);
  stage_table(smem, table, num_tris * kStride);

  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;
  V3 d = pixel_ray(x, y, 0.0f, 0.0f, width, height, slope, prm + 3);
  Hit h = nearest_hit(smem, kStride, num_tris, load3(prm), d, t_max, eps);
  V3 world = {0.0f, 0.0f, 0.0f};
  TriVerts tv = {};
  if (h.hit) {
    const float* row = smem + h.prim * kStride;
    world = hit_position(smem, kStride, h);
    tv = {load3(row + 21), load3(row + 24), load3(row + 27), load3(row + 30),
          load3(row + 33), load3(row + 36), load3(row + 39)};
  }
  geometry_epilogue(x, y, width, height, prm, h, world, tv, o);
}

// The LBVH kernel (large scenes): the walk commits (t, u, v, prim) only;
// the committed triangle's position, normal and vertices are read once
// from global memory after it. Under kCount, ``counts`` (2, H*W) receives
// each pixel's triangle and box tests, and seen_node / seen_tri a 1 for
// every node row and triangle-test row a walk read.
template <bool kCount>
__global__ void geometry_bvh_kernel(BvhScene sc, const float* __restrict__ lut_normals,
                                    const float* __restrict__ lut,
                                    const float* __restrict__ lut_prev,
                                    const float* __restrict__ params, int width, int height,
                                    float slope, float t_max, float eps, GeoOut o,
                                    int* __restrict__ counts, int* seen_node, int* seen_tri) {
  __shared__ float prm[56];
  stage_params(prm, params);
  __syncthreads();

  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;
  V3 d = pixel_ray(x, y, 0.0f, 0.0f, width, height, slope, prm + 3);
  Counts c = {0, 0, seen_node, seen_tri};
  Hit h = bvh_nearest_hit<kCount>(sc, load3(prm), d, t_max, eps, c);
  V3 world = {0.0f, 0.0f, 0.0f};
  TriVerts tv = {};
  if (h.hit) {
    int p = 3 * h.prim;
    world = add(add(load3(sc.v0 + p), scale(h.u, load3(sc.e1 + p))), scale(h.v, load3(sc.e2 + p)));
    const float* cur = lut + 9 * (h.prim + 1);  // slot 0 is the background
    const float* prev = lut_prev + 9 * (h.prim + 1);
    tv = {load3(lut_normals + 3 * (h.prim + 1)), load3(cur), load3(cur + 3), load3(cur + 6),
          load3(prev), load3(prev + 3), load3(prev + 6)};
  }
  geometry_epilogue(x, y, width, height, prm, h, world, tv, o);
  if (kCount) {
    int pix = y * width + x;
    counts[pix] = c.tri;
    counts[width * height + pix] = c.box;
  }
}

}  // namespace

extern "C" int ptsf_geometry(const float* table, int num_tris, const float* params, int width,
                             int height, float slope, float t_max, float eps, float* vis,
                             float* depth, float* normal, float* lam, int* prev_y, int* prev_x,
                             float* world, const float* albedo, float* out_albedo,
                             cudaStream_t stream) {
  dim3 block(16, 16);
  dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  size_t smem = sizeof(float) * num_tris * kStride;
  GeoOut o = {vis, depth, normal, lam, prev_y, prev_x, world, albedo, out_albedo};
  geometry_kernel<<<grid, block, smem, stream>>>(table, num_tris, params, width, height, slope,
                                                 t_max, eps, o);
  return (int)cudaGetLastError();
}

extern "C" int ptsf_geometry_bvh(const float* nodes, const float* tris, const float* v0,
                                 const float* e1, const float* e2, const float* lut_normals,
                                 const float* lut, const float* lut_prev, const float* params,
                                 int width, int height, float slope, float t_max, float eps,
                                 float* vis, float* depth, float* normal, float* lam,
                                 int* prev_y, int* prev_x, float* world, const float* albedo,
                                 float* out_albedo, int* counts, int* seen_node, int* seen_tri,
                                 cudaStream_t stream) {
  dim3 block(16, 16);
  dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  BvhScene sc = {reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(tris),
                 v0, e1, e2, nullptr, nullptr};
  GeoOut o = {vis, depth, normal, lam, prev_y, prev_x, world, albedo, out_albedo};
  if (counts != nullptr) {
    geometry_bvh_kernel<true><<<grid, block, 0, stream>>>(sc, lut_normals, lut, lut_prev, params,
                                                          width, height, slope, t_max, eps, o,
                                                          counts, seen_node, seen_tri);
  } else {
    geometry_bvh_kernel<false><<<grid, block, 0, stream>>>(sc, lut_normals, lut, lut_prev, params,
                                                           width, height, slope, t_max, eps, o,
                                                           counts, seen_node, seen_tri);
  }
  return (int)cudaGetLastError();
}
