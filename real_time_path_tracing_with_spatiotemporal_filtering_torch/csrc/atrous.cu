// A-trous iterations on blocks of the stride-k lattice that compute each edge
// weight once, and the temporal EMA blends; one thread per pixel.
//
// atrous_iter replaces the TPU kernel _iter_kernel
// (real_time_path_tracing_with_spatiotemporal_filtering_tpu/ops/pallas/atrous.py:35):
// one iteration of ops/atrous.atrous_iteration at stride k, 3x3 taps with
// edge-clamped coordinates, weight max(n.n', 0)^sigma_n * exp(-|dz|/sigma_z)
// * exp(-|dc|/sigma_l) * 1/9. The frame launches it for k = 1..9,
// ping-ponging two (H, W, 3) buffers.
//
// temporal_blend replaces the TPU kernel _blend_kernel
// (real_time_path_tracing_with_spatiotemporal_filtering_tpu/ops/pallas/atrous.py:278),
// non-ramp variant: ops/atrous.temporal_accumulate_at, a gather of the
// history at the backprojected (prev_y, prev_x) and the EMA with alpha =
// 0.3 or the adaptive (1 - lam) alpha + lam; frame 0 passes through. The
// TPU version had to bound the reprojection window; a per-pixel gather
// handles any backprojection.
//
// atrous_iter_var replaces the TPU kernel _iter_var_kernel
// (real_time_path_tracing_with_spatiotemporal_filtering_tpu/ops/pallas/atrous.py:104):
// one iteration of ops/atrous.atrous_iteration_var, the variance-guided
// (SVGF) iteration. The centre pixel's variance is prefiltered by a 3x3
// [1/4 1/2 1/4]^2 Gaussian (stride 1, edge-clamped, row-major tap order);
// the luminance weight is exp(-|l_p - l_q| / (sigma_l sqrt(g) + eps)); the
// variance is propagated as sum (h w)^2 var_q / (sum h w)^2. It divides
// where the TPU kernel multiplied by reciprocals, as the XLA ops that made
// the goldens do. The frame launches it for k = 1..9, ping-ponging two
// (color, var) buffer pairs.
//
// temporal_blend_ramp is _blend_kernel's ramp mode (the same Pallas kernel
// with ramp=True): the blend of ops/atrous.temporal_accumulate_at with
// the accumulation ramp of ops/atrous.accumulate_age / ramp_alpha. One
// per-pixel gather of image, age and consistency plane at (prev_y, prev_x);
// age = min(age' + 1, cap), reset to 1 where lam > ramp_reset_lam or the
// consistency planes differ; alpha = max(ramp_alpha_min, 1/age), then the
// adaptive blend; frame 0 passes through with age 1. It writes the image
// and the new age. The TPU kernel routed small reprojection windows,
// aligned views and large ones three ways; a direct gather covers all.
//
// What bounds them on the H100, and the design. A pixel's 9 taps cost 9
// edge weights, each a precise powf, two expf, a sqrtf and two IEEE
// divides (the variance-guided one: powf, two expf, two divides), about
// 115 instructions with the loads; the kernels are bound by issuing them,
// not by the ~40-48 bytes a pixel moves. The weight of an edge is
// symmetric: the weight p gives q at offset +d equals, bit for bit, the
// weight q gives p at -d (n_p.n_q, |d_p - d_q| and |c_p - c_q|^2 are
// symmetric in IEEE float32 without contraction, and the build runs with
// --fmad=false). So each edge's weight is computed once:
// - A block covers 64 columns by 8 rows of the stride-k lattice (y0 + t k),
//   one thread a pixel; blockIdx.y picks the residue y0 mod k and a chunk of
//   lattice rows, so the block's halo is one lattice row above and below and
//   k columns to the left, whatever k.
// - Each thread computes its pixel's weights to the four forward taps
//   (k,0), (0,k), (k,k), (k,-k): the whole kHBox*((w_n*w_z)*w_l) for
//   atrous_iter, the prefix (kHBox*w_n)*w_z for atrous_iter_var, whose w_l
//   divides by p's own sigma_l sqrt(g) + eps. It keeps them in registers
//   and in shared memory; the block's threads share out the halo's
//   weights (the p - d of its pixels that lie outside the block).
// - After one barrier each pixel sums its taps in the plain order (x
//   offset outer, y offset inner): the centre tap computed as before, a
//   backward tap -d read as p - d's forward weight where p - d lies in the
//   image, and computed directly otherwise (there the clamped tap is not
//   p - d's forward tap).
// About 5.4-5.8 weight evaluations a pixel instead of 9 (atrous_time.py
// --count). Loads go through L1 as before: staging the tile in shared
// memory cost more instructions and barriers than it saved, and a 512-
// thread block at 40 registers (3 blocks an SM) keeps the issue slots
// fuller than smaller blocks do. The blend moves ~50 bytes per pixel (the
// ramp mode ~70) and is bound by memory bandwidth; its gather is coalesced
// while the camera moves slowly. powf/expf are the precise library
// functions (no fast math): __powf would drift on w_n = x^128.
//
// The row-sharded frame (parallel/) adds two modes. The a-trous kernels'
// halo mode (the TPU package's halo=, a slab's a-trous step): the inputs
// carry ``halo`` >= k exchanged neighbour rows above and below the ``height``
// output rows, and the taps read them with no vertical clamp (the x clamp
// stays); the lattice blocks are those of the output rows, and a pixel of
// the lower halo computes the forward weights a tile pixel above it reads.
// The blends' source mode: the history planes they gather from hold
// ``src_height`` rows of the frame from global row ``src_row0`` on (the
// halo-padded reprojection window, or the all-gathered frame), and a pixel
// gathers row clamp(prev_y - src_row0, 0, src_height - 1), as
// parallel/sharding.reproject_rows_sharded does. halo 0, src_height =
// height and src_row0 0 are the whole-frame kernels.

#include <cuda_runtime.h>

namespace {

constexpr float kHBox = (float)(1.0 / 9.0);

// Rec.709 luminance (ops/atrous.luminance_planes)
constexpr float kLumR = 0.2126f, kLumG = 0.7152f, kLumB = 0.0722f;

__device__ __forceinline__ float luminance(float r, float g, float b) {
  return kLumR * r + kLumG * g + kLumB * b;
}

// The a-trous block: kTX columns by kTY rows of the stride-k lattice, one
// thread a pixel; __launch_bounds__ asks for kMinBlocks blocks an SM (40
// registers, 48 warps an SM).
constexpr int kTX = 64, kTY = 8, kMinBlocks = 3;

__device__ __forceinline__ int clampi(int v, int hi) { return min(max(v, 0), hi); }

// A pixel's color, normal and depth.
struct Px {
  float c[3], n[3], d;
};

__device__ __forceinline__ Px load_px(const float* __restrict__ color,
                                      const float* __restrict__ normal,
                                      const float* __restrict__ depth, int g) {
  Px p;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p.c[i] = color[3 * g + i];
    p.n[i] = normal[3 * g + i];
  }
  p.d = depth[g];
  return p;
}

// The weight of the edge (p, q), symmetric in (p, q) bit for bit:
// atrous_iter's whole kHBox * (w_n * w_z * w_l), or (VAR) atrous_iter_var's
// prefix kHBox * w_n * w_z, whose w_l divides by p's own stddev.
template <bool VAR>
__device__ __forceinline__ float edge_weight(const Px& p, const Px& q, float sigma_n,
                                             float sigma_z, float sigma_l) {
  const float ndot = p.n[0] * q.n[0] + p.n[1] * q.n[1] + p.n[2] * q.n[2];
  const float w_n = powf(fmaxf(ndot, 0.0f), sigma_n);
  const float w_z = expf(-fabsf(p.d - q.d) / sigma_z);
  if (VAR) return kHBox * w_n * w_z;
  const float er = p.c[0] - q.c[0], eg = p.c[1] - q.c[1], eb = p.c[2] - q.c[2];
  const float w_l = expf(-sqrtf(er * er + eg * eg + eb * eb) / sigma_l);
  return kHBox * (w_n * w_z * w_l);
}

// The forward offsets d = 0..3: (k,0), (0,k), (k,k), (k,-k), in units of k.
__device__ __forceinline__ int offset_dx(int d) { return d == 1 ? 0 : 1; }
__device__ __forceinline__ int offset_dy(int d) { return d == 0 ? 0 : (d == 3 ? -1 : 1); }

// The forward offset of tap (i, j) (x, y offsets in units of k) that holds
// its weight; a backward tap takes the offset of (-i, -j).
__host__ __device__ constexpr int offset_index(int i, int j) {
  if (i < 0 || (i == 0 && j < 0)) i = -i, j = -j;
  return i == 0 ? 1 : (j == 0 ? 0 : (j > 0 ? 2 : 3));
}

// A block's place on the stride-k lattice and its weight positions.
// blockIdx.x is a kTX-column strip, blockIdx.y a residue y0 mod k and a chunk
// of kTY lattice rows y0 + t k. Weight positions (r, wc): rows r = t + 1 for
// t in [-1, kTY], columns wc in [0, m + kTX) with m = min(k, kTX): the tile's
// column u is wc = m + u, and its backward taps at -k read wc = u (the k
// columns left of the tile, or a band of kTX columns at -k once k >= kTX).
struct Lattice {
  static constexpr int R = kTY + 2;
  int k, m, ww, x0, y0;

  __device__ Lattice(int k_, int chunks) : k(k_) {
    m = min(k, kTX);
    ww = m + kTX;
    x0 = blockIdx.x * kTX;
    const int residue = blockIdx.y / chunks;
    y0 = residue + (blockIdx.y - residue * chunks) * kTY * k;
  }
  // image column and row of weight position (r, wc)
  __device__ int col_x(int wc) const { return wc < m ? x0 - k + wc : x0 + wc - m; }
  __device__ int row_y(int r) const { return y0 + (r - 1) * k; }
  // The halo: each p - d of the tile's pixels p that is not a pixel of the
  // tile. Row -1 for (0,k) and (k,k), row kTY for (k,-k), and the columns
  // at -k: (k,0) on rows [0, kTY), (k,k) on [0, kTY - 1), (k,-k) on [1, kTY).
  __device__ int halo_size() const { return 3 * kTX + m * (3 * kTY - 2); }
  __device__ void halo_item(int h, int* d, int* r, int* wc) const {
    if (h < 3 * kTX) {
      const int s = h / kTX, i = h - s * kTX;
      *d = s + 1;
      *r = s < 2 ? 0 : kTY + 1;
      *wc = s == 0 ? m + i : i;
      return;
    }
    h -= 3 * kTX;
    const int a = h / m;
    *wc = h - a * m;
    if (a < kTY) {
      *d = 0, *r = 1 + a;
    } else if (a < 2 * kTY - 1) {
      *d = 2, *r = 1 + a - kTY;
    } else {
      *d = 3, *r = 3 + a - 2 * kTY;
    }
  }
};

// Both kernels. Each thread computes its pixel's four forward weights
// (kept in registers and in shared memory), the block's threads share out
// the halo's weights, and after one barrier each pixel sums its 9 taps in
// the plain order (x offset outer, y offset inner): the centre tap computed
// as before, a forward tap from the registers, a backward tap -d as the
// forward weight of p - d where p - d lies in the image, computed directly
// otherwise (there the clamped tap is not p - d's forward tap). VAR
// multiplies the prefix by w_l, computed with p's own stddev, and
// propagates the variance.
// The inputs are read at rows [-halo, height + halo) (row 0 the first
// output row; halo > 0 only with halo >= k), the output written at rows
// [0, height).
template <bool VAR>
__device__ __forceinline__ void atrous_block(const float* __restrict__ color,
                                             const float* __restrict__ var,
                                             const float* __restrict__ normal,
                                             const float* __restrict__ depth,
                                             float* __restrict__ out, float* __restrict__ var_out,
                                             float sigma_n, float sigma_z, float sigma_l,
                                             float var_eps, int width, int height, int halo,
                                             int k, int chunks) {
  extern __shared__ float s_w[];  // four planes of R x (m + kTX) forward weights
  const Lattice L(k, chunks);
  if (L.y0 >= height) return;  // an empty chunk past the last row: the whole block
  const int u = threadIdx.x, t = threadIdx.y, x = L.x0 + u, y = L.y0 + t * k;
  const int plane = Lattice::R * L.ww;
  const int y_lo = -halo, y_hi = height - 1 + halo;  // the input rows
  const bool in = x < width && y < height;
  // a pixel whose forward weights the block reads: an output pixel, or one
  // of the lower halo's rows
  const bool weighs = x < width && y <= y_hi;
  auto clamped = [&](int gx, int gy) {
    return min(max(gy, y_lo), y_hi) * width + clampi(gx, width - 1);
  };
  Px p;
  float fw[4];
  if (weighs) {
    p = load_px(color, normal, depth, y * width + x);
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const Px q = load_px(color, normal, depth,
                           clamped(x + offset_dx(d) * k, y + offset_dy(d) * k));
      fw[d] = edge_weight<VAR>(p, q, sigma_n, sigma_z, sigma_l);
      s_w[d * plane + (t + 1) * L.ww + L.m + u] = fw[d];
    }
  }
  for (int h = t * kTX + u; h < L.halo_size(); h += kTX * kTY) {
    int d, r, wc;
    L.halo_item(h, &d, &r, &wc);
    const int gx = L.col_x(wc), gy = L.row_y(r);
    if (gx < 0 || gx >= width || gy < y_lo || gy > y_hi) continue;  // never read
    const Px a = load_px(color, normal, depth, gy * width + gx);
    const Px b = load_px(color, normal, depth,
                         clamped(gx + offset_dx(d) * k, gy + offset_dy(d) * k));
    s_w[d * plane + r * L.ww + wc] = edge_weight<VAR>(a, b, sigma_n, sigma_z, sigma_l);
  }
  __syncthreads();
  if (!in) return;
  float lp = 0.0f, denom_l = 0.0f;
  if (VAR) {
    // variance prefilter (ops/atrous._gauss3): rows outer, columns inner
    const float w3[3] = {0.25f, 0.5f, 0.25f};
    float g = 0.0f;
    for (int gy = -1; gy <= 1; ++gy) {
      for (int gx = -1; gx <= 1; ++gx)
        g = g + (w3[gy + 1] * w3[gx + 1]) * var[clamped(x + gx, y + gy)];
    }
    lp = luminance(p.c[0], p.c[1], p.c[2]);
    denom_l = sigma_l * sqrtf(g) + var_eps;
  }
  float sr = 0.0f, sg = 0.0f, sb = 0.0f, vnum = 0.0f, den = 0.0f;
#pragma unroll
  for (int i = -1; i <= 1; ++i) {
#pragma unroll
    for (int j = -1; j <= 1; ++j) {
      const int q = clamped(x + i * k, y + j * k);
      float hw;
      if (i == 0 && j == 0) {
        hw = edge_weight<VAR>(p, p, sigma_n, sigma_z, sigma_l);
      } else if (i > 0 || (i == 0 && j > 0)) {
        hw = fw[offset_index(i, j)];
      } else if (x + i * k >= 0 && y + j * k >= y_lo && y + j * k <= y_hi) {
        hw = s_w[offset_index(i, j) * plane + (t + 1 + j) * L.ww + (i + 1) * L.m + u];
      } else {
        hw = edge_weight<VAR>(p, load_px(color, normal, depth, q), sigma_n, sigma_z, sigma_l);
      }
      const float qr = color[3 * q], qg = color[3 * q + 1], qb = color[3 * q + 2];
      if (VAR) hw = hw * expf(-fabsf(lp - luminance(qr, qg, qb)) / denom_l);
      sr = sr + hw * qr;
      sg = sg + hw * qg;
      sb = sb + hw * qb;
      if (VAR) vnum = vnum + hw * hw * var[q];
      den = den + hw;
    }
  }
  const int o = y * width + x;
  out[3 * o] = sr / den;
  out[3 * o + 1] = sg / den;
  out[3 * o + 2] = sb / den;
  if (VAR) var_out[o] = vnum / (den * den);
}

__global__ void __launch_bounds__(kTX * kTY, kMinBlocks)
    atrous_iter_kernel(const float* __restrict__ color, const float* __restrict__ normal,
                       const float* __restrict__ depth, float* __restrict__ out, float sigma_n,
                       float sigma_z, float sigma_l, int width, int height, int halo, int k,
                       int chunks) {
  atrous_block<false>(color, nullptr, normal, depth, out, nullptr, sigma_n, sigma_z, sigma_l,
                      0.0f, width, height, halo, k, chunks);
}

__global__ void __launch_bounds__(kTX * kTY, kMinBlocks)
    atrous_iter_var_kernel(const float* __restrict__ color, const float* __restrict__ var,
                           const float* __restrict__ normal, const float* __restrict__ depth,
                           float* __restrict__ out, float* __restrict__ var_out, float sigma_n,
                           float sigma_z, float sigma_l, float var_eps, int width, int height,
                           int halo, int k, int chunks) {
  atrous_block<true>(color, var, normal, depth, out, var_out, sigma_n, sigma_z, sigma_l, var_eps,
                     width, height, halo, k, chunks);
}

__global__ void temporal_blend_kernel(const float* __restrict__ filtered,
                                      const float* __restrict__ prev_image,
                                      const int* __restrict__ prev_y,
                                      const int* __restrict__ prev_x, const float* __restrict__ lam,
                                      float* __restrict__ out, int width, int height,
                                      int src_height, int src_row0, float alpha, int adaptive,
                                      int frame) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;
  int p = y * width + x;
  if (frame <= 0) {  // frame 0 has no history (temporalFiltering.comp.glsl:251-259)
    for (int c = 0; c < 3; ++c) out[3 * p + c] = filtered[3 * p + c];
    return;
  }
  // clamped so that no index can read outside the history's source plane
  int q = min(max(prev_y[p] - src_row0, 0), src_height - 1) * width +
          min(max(prev_x[p], 0), width - 1);
  float a = alpha;
  if (adaptive) a = (1.0f - lam[p]) * alpha + lam[p];
  float keep = 1.0f - a;
  for (int c = 0; c < 3; ++c) out[3 * p + c] = prev_image[3 * q + c] * keep + filtered[3 * p + c] * a;
}

__global__ void temporal_blend_ramp_kernel(
    const float* __restrict__ filtered, const float* __restrict__ prev_image,
    const int* __restrict__ prev_y, const int* __restrict__ prev_x, const float* __restrict__ lam,
    const float* __restrict__ prev_age, const float* __restrict__ prev_cons,
    const float* __restrict__ cur_cons, float* __restrict__ out, float* __restrict__ age_out,
    int width, int height, int src_height, int src_row0, float alpha_min, float reset_lam,
    float age_cap, int adaptive, int frame) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;
  int p = y * width + x;
  if (frame <= 0) {  // no history: pass through, age 1
    for (int c = 0; c < 3; ++c) out[3 * p + c] = filtered[3 * p + c];
    age_out[p] = 1.0f;
    return;
  }
  int q = min(max(prev_y[p] - src_row0, 0), src_height - 1) * width +
          min(max(prev_x[p], 0), width - 1);
  float l = lam[p];
  float n = fminf(prev_age[q] + 1.0f, age_cap);
  if (l > reset_lam || prev_cons[q] != cur_cons[p]) n = 1.0f;
  float a = fmaxf(1.0f / n, alpha_min);
  if (adaptive) a = (1.0f - l) * a + l;
  float keep = 1.0f - a;
  for (int c = 0; c < 3; ++c) out[3 * p + c] = prev_image[3 * q + c] * keep + filtered[3 * p + c] * a;
  age_out[p] = n;
}

dim3 grid_for(int width, int height, dim3 block) {
  return dim3((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
}

// Launch a lattice kernel: blocks of kTX x kTY threads over (kTX-column
// strip, residue y0 mod k and chunk of kTY lattice rows); residues at or
// past the last row are left out. Shared memory: four planes of (kTY + 2) x
// (min(k, kTX) + kTX) weights, at most 20 KB at any k.
template <class Kernel, class... Args>
int launch_lattice(Kernel kernel, int width, int height, int halo, int k, cudaStream_t stream,
                   Args... args) {
  if (k < 1 || halo < 0 || (halo > 0 && halo < k)) return (int)cudaErrorInvalidValue;
  const int rows = (height + k - 1) / k;  // lattice rows of residue 0, the most
  const int chunks = (rows + kTY - 1) / kTY;
  const dim3 grid((width + kTX - 1) / kTX, min(k, height) * chunks), block(kTX, kTY);
  const size_t bytes = sizeof(float) * 4 * Lattice::R * (min(k, kTX) + kTX);
  kernel<<<grid, block, bytes, stream>>>(args..., width, height, halo, k, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// color, normal, depth: height + 2 halo rows (the first ``halo`` above the
// output's first row); out: height rows.
extern "C" int ptsf_atrous_iter(const float* color, const float* normal, const float* depth,
                                float* out, int width, int height, int halo, int k, float sigma_n,
                                float sigma_z, float sigma_l, cudaStream_t stream) {
  const long long skip = (long long)halo * width;
  return launch_lattice(atrous_iter_kernel, width, height, halo, k, stream, color + 3 * skip,
                        normal + 3 * skip, depth + skip, out, sigma_n, sigma_z, sigma_l);
}

extern "C" int ptsf_temporal_blend(const float* filtered, const float* prev_image,
                                   const int* prev_y, const int* prev_x, const float* lam,
                                   float* out, int width, int height, int src_height,
                                   int src_row0, float alpha, int adaptive, int frame,
                                   cudaStream_t stream) {
  if (src_height < 1) return (int)cudaErrorInvalidValue;
  dim3 block(32, 8);
  temporal_blend_kernel<<<grid_for(width, height, block), block, 0, stream>>>(
      filtered, prev_image, prev_y, prev_x, lam, out, width, height, src_height, src_row0, alpha,
      adaptive, frame);
  return (int)cudaGetLastError();
}

extern "C" int ptsf_atrous_iter_var(const float* color, const float* var, const float* normal,
                                    const float* depth, float* out, float* var_out, int width,
                                    int height, int halo, int k, float sigma_n, float sigma_z,
                                    float sigma_l, float var_eps, cudaStream_t stream) {
  const long long skip = (long long)halo * width;
  return launch_lattice(atrous_iter_var_kernel, width, height, halo, k, stream, color + 3 * skip,
                        var + skip, normal + 3 * skip, depth + skip, out, var_out, sigma_n,
                        sigma_z, sigma_l, var_eps);
}

extern "C" int ptsf_temporal_blend_ramp(const float* filtered, const float* prev_image,
                                        const int* prev_y, const int* prev_x, const float* lam,
                                        const float* prev_age, const float* prev_cons,
                                        const float* cur_cons, float* out, float* age_out,
                                        int width, int height, int src_height, int src_row0,
                                        float alpha_min, float reset_lam, float age_cap,
                                        int adaptive, int frame, cudaStream_t stream) {
  if (src_height < 1) return (int)cudaErrorInvalidValue;
  dim3 block(32, 8);
  temporal_blend_ramp_kernel<<<grid_for(width, height, block), block, 0, stream>>>(
      filtered, prev_image, prev_y, prev_x, lam, prev_age, prev_cons, cur_cons, out, age_out,
      width, height, src_height, src_row0, alpha_min, reset_lam, age_cap, adaptive, frame);
  return (int)cudaGetLastError();
}
