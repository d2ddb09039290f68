// Fused geometry pass: G-buffer, temporal gradient and backprojection.
//
// Two kernels over one epilogue. geometry_kernel replaces the TPU kernel
// _geometry_kernel
// (real_time_path_tracing_with_spatiotemporal_filtering_tpu/ops/pallas/geometry.py:116);
// geometry_bvh_kernel replaces _geometry_clustered_kernel
// (ops/pallas/geometry.py:388 there), its streamed Morton-cluster walk of a
// tile of rays for large scenes, with an LBVH walk per pixel (bvh.cuh). The
// BVH kernel is bounded by the walk's latency, not by bytes or arithmetic:
// on 32,768 triangles a primary ray visits ~11 nodes (22 box tests) and
// tests ~1 triangle, each step a chain of dependent loads and compares on
// the L2-resident tables, and writes 44 bytes. So it wants warps in flight
// and lanes that step together: a warp traces an 8x4 tile of pixels, whose
// walks agree more than a 16x2 strip's (their lanes step together 0.905 of
// the time on path A, against 0.874), and the registers are capped so that
// 48 warps an SM hide the latency, not 32. A walk shared by the warp (one
// node for all lanes) measured slower: primary rays already step together,
// and the union of their walks is longer than the longest (PERF.md).
//
// geometry_kernel:
// A warp traces an 8x4 tile of pixels, one center primary ray a lane, and a
// block 2x4 warps (16x16 pixels) that stage the triangle rows into shared
// memory once. Before it tests anything, the warp culls the table against
// its tile's frustum (tile_nearest_hit): lane i decides for triangle
// 32c + i of each chunk of 32, a ballot makes the survivors a warp-uniform
// mask, and every lane tests the survivors in index order. So the loop has
// no divergence and needs no shared memory beyond the table. Then, while
// the committed triangle is at hand, each lane computes the outputs of
// ops/gbuffer.visibility_pass, ops/gradient.temporal_gradient_pass,
// ops/atrous.backproject_pixels and the filter normal lut_normals[vis]:
//   vis (H,W) f32, depth (H,W) f32, normal (H,W,3) f32, lam (H,W) f32,
//   prev_y / prev_x (H,W) i32, world (H,W,3) f32,
// and, when asked (emit_albedo, for albedo demodulation), the committed
// triangle's albedo (H,W,3) f32, 1.0 for the background
// (ops/atrous.albedo_image). The albedo is one load per pixel from a (T,3)
// array in global memory, so the shared table keeps its 42-float rows.
//
// What bounds it on the H100: instruction throughput. Testing all T = 32
// triangles of the Cornell box took ~1,900 instructions a pixel (a test is
// ~39 flops and an IEEE divide, built without contraction or fast math)
// of ~2,600 with the epilogue, while it writes 44-56 bytes. An 8x4 tile
// spans ~0.1 degree at 1920x1080, and on the Cornell box its frustum holds
// a few of the 32 triangles (the wall behind it, a box face, the light);
// the reference made this G-buffer with a rasteriser, which never looks at
// a triangle outside a tile. Culling costs one evaluation of ~140 flops a
// lane for every 32 triangles, plus the tile's four side planes (~100
// flops and four divides a lane), so the pixels test only the few
// survivors and the epilogue (the barycentric solves and the two Phong
// evaluations) becomes the larger share. The triangle rows (42 floats each: 21 intersection
// constants, the unit normal, the current and the previous LUT vertices)
// are read by every lane of a warp at the same address (a broadcast); the
// committed triangle's vertices are a direct load from that table, where
// the TPU kernel needed a select loop over all triangles.
//
// The cull keeps every output bit-equal (the argument is beside
// outside_tile): a culled triangle is invalid for every ray of the tile,
// so the strict < over the survivors in increasing index commits the
// plain argmin's first minimum, the same (prim, t, u, v). The counting
// instantiation (kCount) writes each pixel's triangle tests and its
// warp's survivors; ops/tilecull.py is the cull's plain twin, op for op.
//
// The arithmetic follows the plain PyTorch version operation for operation
// (see common.cuh): barycentrics are recombined as v0 + u e1 + v e2, not
// o + t d, and the Phong exponent 128 is seven squarings in both.
//
// The visibility-only mode (kVisOnly, a template flag of both kernels)
// replaces the TPU kernel _gbuffer_kernel
// (real_time_path_tracing_with_spatiotemporal_filtering_tpu/ops/pallas/pathtrace.py:1946),
// the drop-in for ops/gbuffer.visibility_pass: the same walk and the same
// first lines of the epilogue, writing only vis, depth and world position
// (5 planes, 20 bytes a pixel) and skipping the gradient, the
// backprojection, the normal and the albedo. Its planes are those of the
// full mode bit for bit.

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
// depth, then (unless kVisOnly) filter normal, temporal gradient,
// backprojection, albedo.
// prm: cam[0:3] rot[3:12] M[12:28] Mprev[28:44] light[44:47]
//      light_prev[47:50] color[50:53] color_prev[53:56]
template <bool kVisOnly>
__device__ __forceinline__ void geometry_epilogue(int x, int y, int width, int height,
                                                  const float* prm, const Hit& h, V3 world,
                                                  const TriVerts& tv, const GeoOut& o) {
  int pix = y * width + x;
  const float* M = prm + 12;
  float vis = 0.0f, depth = 1.0f;
  if (h.hit) {
    vis = (float)(h.prim + 1);
    float cz = M[8] * world.x + M[9] * world.y + M[10] * world.z + M[11];
    float cw = M[12] * world.x + M[13] * world.y + M[14] * world.z + M[15];
    depth = cz / cw;
  }
  o.vis[pix] = vis;
  o.depth[pix] = depth;
  store3(o.world + 3 * pix, world);
  if (kVisOnly) return;

  V3 cam = load3(prm);
  const float* Mp = prm + 28;
  float lam = 0.0f;
  V3 normal = {0.0f, 0.0f, 1.0f};  // background sentinel, lut_normals[0]
  int py = y, px = x;  // background keeps its own pixel
  if (h.hit) {
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
  store3(o.normal + 3 * pix, normal);
  o.lam[pix] = lam;
  o.py[pix] = py;
  o.px[pix] = px;
  if (o.out_albedo != nullptr) {
    store3(o.out_albedo + 3 * pix, h.hit ? load3(o.albedo + 3 * h.prim) : v3(1.0f, 1.0f, 1.0f));
  }
}

// Copy the 56 parameter floats into shared memory.
__device__ __forceinline__ void stage_params(float* prm, const float* __restrict__ params) {
  int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < 56) prm[tid] = params[tid];
}

// The tiles of both kernels: a warp traces kWarpW x kWarpH pixels, a block
// kBlockWarpsX x kBlockWarpsY warps (kBlockW x kBlockH pixels); the LBVH
// kernel keeps at least kBvhMinBlocks blocks an SM. (The dense kernel in
// blocks of 512 or 1024 threads, which stage its table less often, and in
// persistent blocks that stage it once were measured: faster at 288
// triangles, no faster on the Cornell box, PERF.md.)
constexpr int kWarpW = 8, kWarpH = 4, kBlockWarpsX = 2, kBlockWarpsY = 4;
constexpr int kTileBlock = 32 * kBlockWarpsX * kBlockWarpsY, kBvhMinBlocks = 6;
constexpr int kBlockW = kWarpW * kBlockWarpsX, kBlockH = kWarpH * kBlockWarpsY;

// A lane's pixel: its warp's tile at (x0, y0) and its own (x, y), which may
// lie outside the image on the right and bottom edges.
struct TilePixel {
  int x0, y0, x, y;
  bool in_image;
};

__device__ __forceinline__ TilePixel tile_pixel(int width, int height) {
  const int warp = threadIdx.x / 32, lane = (int)lane_id();
  TilePixel p;
  p.x0 = blockIdx.x * kBlockW + warp % kBlockWarpsX * kWarpW;
  p.y0 = blockIdx.y * kBlockH + warp / kBlockWarpsX * kWarpH;
  p.x = p.x0 + lane % kWarpW;
  p.y = p.y0 + lane / kWarpW;
  p.in_image = p.x < width && p.y < height;
  return p;
}

// --- the tile cull (its plain twin: ops/tilecull.py) ----------------------
// The four side planes of a warp tile's frustum, through the camera: the
// tile widened by one pixel on each side (the centres of pixel columns
// x0 - 1 and x0 + 8 and rows y0 - 1 and y0 + 4, unclamped at the image's
// edge), as pixel_ray places them: screen coordinates u, v scaled by the
// slope, on the camera's right, up and back axes (the columns of rot).
// Plane k has the inward normal n[k] and the length len[k]:
//   left / right  +-cross(s u right - back, up)  at u of x0 - 1 / x0 + 8,
//   top / bottom  +-cross(right, s v up - back)  at v of y0 - 1 / y0 + 4,
// each oriented so that the opposite side's edge direction is inside. Two
// axes of the basis enter each cross product, so it has no cancellation:
// the cross product of two corner rays a few pixels apart would lose
// their angle's share of the digits (~1e-7 / 1e-3 radians).
struct Frustum {
  V3 n[4];
  float len[4];
};

constexpr float kCullAbs = 0.000244140625f;  // 2^-12: the absolute margin per unit of scale

__device__ __forceinline__ float screen_u(int x, int width, int height) {
  float fx = (float)x + 0.5f;
  return (2.0f * fx - (float)width) / (float)height;
}

__device__ __forceinline__ float screen_v(int y, int height) {
  float fy = (float)y + 0.5f;
  float h = (float)height;
  return -(2.0f * fy - h) / h;
}

__device__ __forceinline__ V3 inward(V3 n, V3 inside) { return dot(n, inside) < 0.0f ? neg(n) : n; }

__device__ __forceinline__ Frustum tile_frustum(int x0, int y0, int width, int height,
                                                float slope, const float* rot) {
  const V3 right = {rot[0], rot[3], rot[6]}, up = {rot[1], rot[4], rot[7]},
           back = {rot[2], rot[5], rot[8]};
  const V3 left_e = sub(scale(slope * screen_u(x0 - 1, width, height), right), back);
  const V3 right_e = sub(scale(slope * screen_u(x0 + kWarpW, width, height), right), back);
  const V3 top_e = sub(scale(slope * screen_v(y0 - 1, height), up), back);
  const V3 bottom_e = sub(scale(slope * screen_v(y0 + kWarpH, height), up), back);
  Frustum f;
  f.n[0] = inward(cross(left_e, up), right_e);
  f.n[1] = inward(cross(right_e, up), left_e);
  f.n[2] = inward(cross(right, top_e), bottom_e);
  f.n[3] = inward(cross(right, bottom_e), top_e);
  for (int k = 0; k < 4; ++k) f.len[k] = norm(f.n[k]);
  return f;
}

__device__ __forceinline__ float l1(V3 a) { return fabsf(a.x) + fabsf(a.y) + fabsf(a.z); }

// Whether no ray of the tile can hit the triangle of ``row``: all three of
// its vertices v0, v0 + e1, v0 + e2 (the vertices its test's planes are
// built from) lie outside one side plane by more than their margin
//   m = max(pix * |p - o|_1, 2^-12 * scale),
// pix = 2 slope / height (no pixel spans a larger angle), scale =
// |o|_1 + |v0|_1 + |e1|_1 + |e2|_1.
//
// Why no valid hit is lost. A pixel's ray d is pixel_ray of a pixel
// centre a whole pixel inside the widened tile, on the same screen
// coordinates as the planes; rounding moves d and the normals by ~1e-7 of
// their length, far less than a pixel (>= 2e-4 radians at 1920x1080 and
// the default field of view). So every point o + t d, t > 0, lies strictly
// inside the four planes. If tri_test accepts t, the point o + t d lies
// within delta of the closed triangle (v0, v0 + e1, v0 + e2): its offset
// from the triangle's plane is the rounding of d0 - n.o and of the divide
// (a few ulps of |o| + |v0| + t); u and v carry a few ulps of
// |n1| (|o| + t) + |d1|, and the rounded n1, n2 move the accepted region's
// edges by a few ulps of |v0| and of the edge lengths (a sliver's
// ill-conditioned n scales n1 and its height alike, so that error does not
// grow with the sliver). With t <= |o| + |v| + delta, delta is below 64
// ulps of scale, 2^-18 scale. The point is a convex combination of the
// vertices, so some vertex v has n.(v - o) >= -|n| delta: a triangle whose
// three vertices all lie more than |n| m >= |n| 2^-12 scale outside one
// plane has no valid hit in the tile. The cull's own rounding (v - o and
// the dot product) is a few ulps of |n| |v - o|_1 <= |n| scale, inside
// the same margin; the pix term widens the tile by one more pixel at each
// vertex's distance. A NaN anywhere makes every comparison false, so the
// triangle survives.
__device__ __forceinline__ bool outside_tile(const Frustum& f, const float* row, V3 o, float o_l1,
                                             float pix) {
  const V3 v0 = load3(row), e1 = load3(row + 3), e2 = load3(row + 6);
  const V3 p[3] = {sub(v0, o), sub(add(v0, e1), o), sub(add(v0, e2), o)};
  const float floor_m = kCullAbs * (((o_l1 + l1(v0)) + l1(e1)) + l1(e2));
  float m[3];
  for (int j = 0; j < 3; ++j) m[j] = fmaxf(pix * l1(p[j]), floor_m);
  bool out = false;
  for (int k = 0; k < 4; ++k) {
    bool all = true;
    for (int j = 0; j < 3; ++j) all &= dot(f.n[k], p[j]) < -(f.len[k] * m[j]);
    out |= all;
  }
  return out;
}

// The nearest hit of ray (o, d) among the table's triangles that survive
// the tile's cull, tested in increasing index. The plain version's argmin
// over t_cand (invalid -> 2 t_max) takes the first minimum, and so does a
// strict < in index order; a culled triangle's t_cand is 2 t_max for every
// ray of the tile. All 32 lanes call it together. Under kCount, ``tests``
// counts the lane's triangle tests and ``survivors`` its warp's.
template <bool kCount>
__device__ __forceinline__ Hit tile_nearest_hit(const float* tab, int num_tris, const Frustum& f,
                                                float pix, V3 o, V3 d, float t_max, float eps,
                                                int& tests, int& survivors) {
  float best = INFINITY;
  Hit h = {false, 0, 0.0f, 0.0f, 0.0f};
  const float miss_t = 2.0f * t_max;
  const float o_l1 = l1(o);
  const int lane = (int)lane_id();
  for (int base = 0; base < num_tris; base += 32) {
    const int i = base + lane;
    const bool keep = i < num_tris && !outside_tile(f, tab + i * kStride, o, o_l1, pix);
    unsigned mask = __ballot_sync(kFullMask, keep);
    if (kCount) survivors += __popc(mask);
    while (mask != 0u) {
      const int j = base + __ffs(mask) - 1;
      mask &= mask - 1u;
      float t, u, v;
      const bool valid = tri_test(tab + j * kStride, o, d, t_max, eps, t, u, v);
      const float t_cand = valid ? t : miss_t;
      if (t_cand < best) {
        best = t_cand;
        h = {valid, j, t, u, v};
      }
      if (kCount) ++tests;
    }
  }
  if (!h.hit) return {false, 0, t_max, 0.0f, 0.0f};
  return h;
}

// The dense kernel: a shared-memory table, culled per warp tile. Under
// kCount, ``counts`` (2, H*W) receives each pixel's triangle tests, then
// the survivors of its warp's cull (the same number in this design).
template <bool kCount, bool kVisOnly>
__global__ void __launch_bounds__(kTileBlock)
    geometry_kernel(const float* __restrict__ table, int num_tris,
                    const float* __restrict__ params, int width, int height, float slope,
                    float t_max, float eps, GeoOut o, int* __restrict__ counts) {
  extern __shared__ float smem[];
  __shared__ float prm[56];
  stage_params(prm, params);
  stage_table(smem, table, num_tris * kStride);

  const TilePixel tp = tile_pixel(width, height);
  if (tp.x0 >= width || tp.y0 >= height) return;  // the whole warp: no pixel in the image
  const float pix = 2.0f * slope / (float)height;
  const V3 cam = load3(prm);
  const Frustum f = tile_frustum(tp.x0, tp.y0, width, height, slope, prm + 3);
  // a lane outside the image traces too (its ray is discarded), so that
  // every lane joins the ballots
  const V3 d = pixel_ray(tp.x, tp.y, 0.0f, 0.0f, width, height, slope, prm + 3);
  int tests = 0, survivors = 0;
  const Hit h = tile_nearest_hit<kCount>(smem, num_tris, f, pix, cam, d, t_max, eps, tests,
                                         survivors);
  if (!tp.in_image) return;
  V3 world = {0.0f, 0.0f, 0.0f};
  TriVerts tv = {};
  if (h.hit) {
    world = hit_position(smem, kStride, h);
    if (!kVisOnly) {
      const float* row = smem + h.prim * kStride;
      tv = {load3(row + 21), load3(row + 24), load3(row + 27), load3(row + 30),
            load3(row + 33), load3(row + 36), load3(row + 39)};
    }
  }
  geometry_epilogue<kVisOnly>(tp.x, tp.y, width, height, prm, h, world, tv, o);
  if (kCount) {
    const int pix_id = tp.y * width + tp.x;
    counts[pix_id] = tests;
    counts[width * height + pix_id] = survivors;
  }
}

using DenseFn = void (*)(const float*, int, const float*, int, int, float, float, float, GeoOut,
                         int*);

template <bool kVisOnly>
DenseFn pick_dense(bool count) {
  return count ? geometry_kernel<true, kVisOnly> : geometry_kernel<false, kVisOnly>;
}

// The LBVH kernel (large scenes): the walk commits (t, u, v, prim) only;
// the committed triangle's position, normal and vertices are read once
// from global memory after it. Under kCount, ``counts`` (2, H*W) receives
// each pixel's triangle and box tests, and seen_node / seen_tri a 1 for
// every node row and triangle-test row a walk read; ``lanes`` (4,), when
// not null, the lane counts (flush_lanes): lanes with a pixel and warps,
// then the walk's lanes and steps.
template <bool kCount, bool kVisOnly>
__global__ void __launch_bounds__(kTileBlock, kBvhMinBlocks)
    geometry_bvh_kernel(BvhScene sc, const float* __restrict__ lut_normals,
                        const float* __restrict__ lut, const float* __restrict__ lut_prev,
                        const float* __restrict__ params, int width, int height, float slope,
                        float t_max, float eps, GeoOut o, int* __restrict__ counts,
                        int* seen_node, int* seen_tri, unsigned long long* __restrict__ lanes) {
  __shared__ float prm[56];
  stage_params(prm, params);
  __syncthreads();

  const TilePixel tp = tile_pixel(width, height);
  const int x = tp.x, y = tp.y;
  const bool in_image = tp.in_image;
  Counts c = {0, 0, seen_node, seen_tri};
  unsigned pixel_lanes = 0, warps = 0;
  Hit h = {false, 0, t_max, 0.0f, 0.0f};
  if (in_image) {
    V3 d = pixel_ray(x, y, 0.0f, 0.0f, width, height, slope, prm + 3);
    if (kCount) count_lanes(pixel_lanes, warps);
    h = bvh_nearest_hit<kCount>(sc, load3(prm), d, t_max, eps, c);
  }
  if (kCount && lanes != nullptr) flush_lanes(lanes, pixel_lanes, warps, c);
  if (!in_image) return;
  V3 world = {0.0f, 0.0f, 0.0f};
  TriVerts tv = {};
  if (h.hit) {
    int p = 3 * h.prim;
    world = add(add(load3(sc.v0 + p), scale(h.u, load3(sc.e1 + p))), scale(h.v, load3(sc.e2 + p)));
    if (!kVisOnly) {
      const float* cur = lut + 9 * (h.prim + 1);  // slot 0 is the background
      const float* prev = lut_prev + 9 * (h.prim + 1);
      tv = {load3(lut_normals + 3 * (h.prim + 1)), load3(cur), load3(cur + 3), load3(cur + 6),
            load3(prev), load3(prev + 3), load3(prev + 6)};
    }
  }
  geometry_epilogue<kVisOnly>(x, y, width, height, prm, h, world, tv, o);
  if (kCount) {
    int pix = y * width + x;
    counts[pix] = c.tri;
    counts[width * height + pix] = c.box;
  }
}

using BvhFn = void (*)(BvhScene, const float*, const float*, const float*, const float*, int,
                       int, float, float, float, GeoOut, int*, int*, int*, unsigned long long*);

template <bool kVisOnly>
BvhFn pick_bvh(bool count) {
  return count ? geometry_bvh_kernel<true, kVisOnly> : geometry_bvh_kernel<false, kVisOnly>;
}

}  // namespace

// vis_only: write vis, depth and world only (normal, lam, prev_y, prev_x,
// albedo and out_albedo may then be null). counts (null: not counted): see
// geometry_kernel.
extern "C" int ptsf_geometry(const float* table, int num_tris, const float* params, int width,
                             int height, float slope, float t_max, float eps, float* vis,
                             float* depth, float* normal, float* lam, int* prev_y, int* prev_x,
                             float* world, const float* albedo, float* out_albedo, int vis_only,
                             int* counts, cudaStream_t stream) {
  dim3 grid((width + kBlockW - 1) / kBlockW, (height + kBlockH - 1) / kBlockH);
  size_t smem = sizeof(float) * num_tris * kStride;
  GeoOut o = {vis, depth, normal, lam, prev_y, prev_x, world, albedo, out_albedo};
  bool count = counts != nullptr;
  DenseFn kernel = vis_only ? pick_dense<true>(count) : pick_dense<false>(count);
  kernel<<<grid, kTileBlock, smem, stream>>>(
      table, num_tris, params, width, height, slope, t_max, eps, o, counts);
  return (int)cudaGetLastError();
}

extern "C" int ptsf_geometry_bvh(const float* nodes, const float* tris, const float* v0,
                                 const float* e1, const float* e2, const float* lut_normals,
                                 const float* lut, const float* lut_prev, const float* params,
                                 int width, int height, float slope, float t_max, float eps,
                                 float* vis, float* depth, float* normal, float* lam,
                                 int* prev_y, int* prev_x, float* world, const float* albedo,
                                 float* out_albedo, int vis_only, int* counts, int* seen_node,
                                 int* seen_tri, unsigned long long* lanes,
                                 cudaStream_t stream) {
  dim3 grid((width + kBlockW - 1) / kBlockW, (height + kBlockH - 1) / kBlockH);
  BvhScene sc = {reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(tris),
                 v0, e1, e2, nullptr, nullptr};
  GeoOut o = {vis, depth, normal, lam, prev_y, prev_x, world, albedo, out_albedo};
  bool count = counts != nullptr;
  BvhFn kernel = vis_only ? pick_bvh<true>(count) : pick_bvh<false>(count);
  kernel<<<grid, kTileBlock, 0, stream>>>(
      sc, lut_normals, lut, lut_prev, params, width, height, slope, t_max, eps, o, counts,
      seen_node, seen_tri, lanes);
  return (int)cudaGetLastError();
}
