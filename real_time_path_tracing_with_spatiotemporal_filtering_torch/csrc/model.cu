// The per-frame model matrix: the moved scene's tables and its LBVH's boxes,
// remade on the card every frame in two launches (the refit only where the
// frame walks the tree).
//
// No TPU kernel: the JAX package applies the matrix as an XLA map inside its
// frame (scene/scene.py transform_triangle_data) and sends moved scenes to
// its dense kernels, since its moved tables carry no hierarchy. Here both
// routes walk the LBVH from 128 triangles on (ops/intersect.py
// BVH_MIN_TRIANGLES), so a moved scene needs its tree's boxes anew: the
// rest pose's tree, refitted (any valid tree gives the walks' least
// (t, prim)). Plain versions: scene/scene.py transform_triangle_data
// (transform_vertices, triangle_tables) and scene/lbvh.py refit_nodes_plain;
// both kernels equal them bit for bit (--fmad=false, no fast math: the
// divide and the square root are the IEEE ones).
//
// transform_tables_kernel: one thread a triangle writes every table of the
// moved triangle in one pass (the LUT row, v0, e1, e2, n, d0, n1, d1, n2, d2,
// the unit normal, the albedo, lut_normals and the LBVH test row) and the
// scene's largest |coordinate| (the boxes' pad scale) by a warp max and one
// atomicMax a warp on the bits of non-negative floats. Bound by bytes: 36 B
// read and 204 B written a triangle.
//
// bvh_refit_kernel: one thread a triangle's leaf, bottom-up (Karras 2012):
// it writes its padded box into its parent row's slot, and an arrival
// counter per node row lets the second of the row's two children go on
// with the row's union into the grandparent's slot, up to the root. Bound
// by the latency of a chain of tree-depth atomics, not by its 64 B a row.
// The transform kernel zeroes the counters in the same stream. A frame that
// walks no tree (pipeline/frame.py walks_tree) launches no refit.
#include "common.cuh"

namespace ptsf {
namespace {

constexpr int kThreads = 256;
constexpr int kNodeWords = 16;  // scene/lbvh.py NODE_WORDS
constexpr double kBoxPad = 1e-4;  // scene/lbvh.py BOX_PAD

// Row i of the model matrix applied to p: ((m0 x + m1 y) + m2 z) + m3.
__device__ __forceinline__ float row_apply(const float* m, V3 p) {
  return ((m[0] * p.x + m[1] * p.y) + m[2] * p.z) + m[3];
}

__device__ __forceinline__ V3 apply(const float* m, V3 p) {
  return {row_apply(m, p), row_apply(m + 4, p), row_apply(m + 8, p)};
}

__device__ __forceinline__ float abs_max(V3 a) {
  return fmaxf(fmaxf(fabsf(a.x), fabsf(a.y)), fabsf(a.z));
}

// scene/scene.py triangle_tables, one triangle; the model rows in m (12
// floats, row-major). workspace[0] takes the pad scale's bits (zeroed by the
// entry point), workspace[1 + r] is node row r's arrival counter.
__global__ void transform_tables_kernel(const float* __restrict__ rest_lut,
                                        const float* __restrict__ model, int num_tris,
                                        int num_rows, float* __restrict__ lut,
                                        float* __restrict__ v0_out, float* __restrict__ e1_out,
                                        float* __restrict__ e2_out, float* __restrict__ n_out,
                                        float* __restrict__ d0_out, float* __restrict__ n1_out,
                                        float* __restrict__ d1_out, float* __restrict__ n2_out,
                                        float* __restrict__ d2_out, float* __restrict__ normals,
                                        float* __restrict__ albedo, float* __restrict__ lut_normals,
                                        float* __restrict__ tests, unsigned* workspace) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < num_rows) workspace[1 + t] = 0u;
  if (t == 0) {
    for (int k = 0; k < 9; ++k) lut[k] = 0.0f;
    store3(lut_normals, v3(0.0f, 0.0f, 1.0f));
  }
  float coord_max = 0.0f;
  if (t < num_tris) {
    float m[12];
    for (int k = 0; k < 12; ++k) m[k] = model[k];
    const float* p = rest_lut + 9 * (t + 1);
    const V3 q0 = apply(m, load3(p)), q1 = apply(m, load3(p + 3)), q2 = apply(m, load3(p + 6));
    float* l = lut + 9 * (t + 1);
    store3(l, q0);
    store3(l + 3, q1);
    store3(l + 6, q2);
    const V3 e1 = sub(q1, q0), e2 = sub(q2, q0);
    const V3 n = cross(e1, e2);
    const float nn = dot(n, n);
    const float inv_nn = 1.0f / nn;
    const V3 n1 = scale(inv_nn, cross(e2, n)), n2 = scale(inv_nn, cross(n, e1));
    const V3 unit = div(n, sqrtf(nn));
    const float d0 = dot(n, q0), d1 = -dot(n1, q0), d2 = -dot(n2, q0);
    store3(v0_out + 3 * t, q0);
    store3(e1_out + 3 * t, e1);
    store3(e2_out + 3 * t, e2);
    store3(n_out + 3 * t, n);
    d0_out[t] = d0;
    store3(n1_out + 3 * t, n1);
    d1_out[t] = d1;
    store3(n2_out + 3 * t, n2);
    d2_out[t] = d2;
    store3(normals + 3 * t, unit);
    store3(lut_normals + 3 * (t + 1), unit);
    // ops/shading.py albedo_from_normal: +x red, -x green, else gray
    const V3 a = unit.x > 0.99f    ? v3(1.0f, 0.0f, 0.0f)
                 : unit.x < -0.99f ? v3(0.0f, 1.0f, 0.0f)
                                   : v3(0.7f, 0.7f, 0.7f);
    store3(albedo + 3 * t, a);
    float* row = tests + 12 * t;  // scene/lbvh.py pack_triangle_tests
    store3(row, n);
    row[3] = d0;
    store3(row + 4, n1);
    row[7] = d1;
    store3(row + 8, n2);
    row[11] = d2;
    coord_max = fmaxf(fmaxf(abs_max(q0), abs_max(q1)), abs_max(q2));
  }
  for (int off = 16; off > 0; off >>= 1)
    coord_max = fmaxf(coord_max, __shfl_xor_sync(0xffffffffu, coord_max, off));
  if ((threadIdx.x & 31) == 0 && coord_max > 0.0f)
    atomicMax(workspace, __float_as_uint(coord_max));
}

__device__ __forceinline__ void store_box(float* nodes, int slot, V3 lo, V3 hi) {
  float* box = nodes + (slot >> 1) * kNodeWords + (slot & 1) * 6;
  store3(box, lo);
  store3(box + 3, hi);
}

// The row's child ids and unused words, from the rest pose's table.
__device__ __forceinline__ void copy_children(const float* rest_nodes, float* nodes, int row) {
  reinterpret_cast<int4*>(nodes + row * kNodeWords)[3] =
      reinterpret_cast<const int4*>(rest_nodes + row * kNodeWords)[3];
}

// scene/lbvh.py refit_nodes_plain over the moved LUT; leaf_slot and
// row_slot are the scene's lbvh.RefitPlan.
__global__ void bvh_refit_kernel(const float* __restrict__ rest_nodes,
                                 const int* __restrict__ leaf_slot,
                                 const int* __restrict__ row_slot, const float* __restrict__ lut,
                                 unsigned* workspace, int num_tris, float* nodes) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= num_tris) return;
  const float coord_max = fmaxf(1.0f, __uint_as_float(workspace[0]));
  const float pad = __double2float_rn(kBoxPad * (double)coord_max);
  const float* p = lut + 9 * (t + 1);
  const V3 a = load3(p), b = load3(p + 3), c = load3(p + 6);
  V3 lo = v3(fminf(fminf(a.x, b.x), c.x), fminf(fminf(a.y, b.y), c.y),
             fminf(fminf(a.z, b.z), c.z));
  V3 hi = v3(fmaxf(fmaxf(a.x, b.x), c.x), fmaxf(fmaxf(a.y, b.y), c.y),
             fmaxf(fmaxf(a.z, b.z), c.z));
  lo = sub(lo, v3(pad, pad, pad));
  hi = add(hi, v3(pad, pad, pad));
  int slot = leaf_slot[t];
  store_box(nodes, slot, lo, hi);
  if (num_tris == 1) {  // the root holds the one triangle on both sides
    store_box(nodes, 1, lo, hi);
    copy_children(rest_nodes, nodes, 0);
    return;
  }
  unsigned* counters = workspace + 1;
  while (true) {
    const int row = slot >> 1;
    __threadfence();  // this child's box before its arrival
    if (atomicAdd(&counters[row], 1u) == 0u) return;  // the sibling goes on
    __threadfence();
    // the sibling's box, from L2 (it was written by another thread)
    const float* other = nodes + row * kNodeWords + ((slot & 1) ^ 1) * 6;
    lo = v3(fminf(lo.x, __ldcg(other)), fminf(lo.y, __ldcg(other + 1)),
            fminf(lo.z, __ldcg(other + 2)));
    hi = v3(fmaxf(hi.x, __ldcg(other + 3)), fmaxf(hi.y, __ldcg(other + 4)),
            fmaxf(hi.z, __ldcg(other + 5)));
    copy_children(rest_nodes, nodes, row);
    slot = row_slot[row];
    if (slot < 0) return;  // the root's union is held by no row
    store_box(nodes, slot, lo, hi);
  }
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace
}  // namespace ptsf

using namespace ptsf;

extern "C" int ptsf_transform_tables(const float* rest_lut, const float* model, int num_tris,
                                     int num_rows, float* lut, float* v0, float* e1, float* e2,
                                     float* n, float* d0, float* n1, float* d1, float* n2,
                                     float* d2, float* normals, float* albedo, float* lut_normals,
                                     float* tests, unsigned* workspace, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(workspace, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return (int)err;
  transform_tables_kernel<<<blocks_for(num_tris), kThreads, 0, stream>>>(
      rest_lut, model, num_tris, num_rows, lut, v0, e1, e2, n, d0, n1, d1, n2, d2, normals, albedo,
      lut_normals, tests, workspace);
  return (int)cudaGetLastError();
}

extern "C" int ptsf_bvh_refit(const float* rest_nodes, const int* leaf_slot, const int* row_slot,
                              const float* lut, unsigned* workspace, int num_tris, float* nodes,
                              cudaStream_t stream) {
  bvh_refit_kernel<<<blocks_for(num_tris), kThreads, 0, stream>>>(
      rest_nodes, leaf_slot, row_slot, lut, workspace, num_tris, nodes);
  return (int)cudaGetLastError();
}
