// A-trous iteration and temporal EMA blend, one thread per pixel.
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
// What bounds them on the H100: atrous_iter is bound by the special
// functions (one powf and two expf per tap, 81 per pixel) more than by its
// ~80 bytes per pixel of traffic; the taps of neighbouring threads overlap
// and are served by L1/L2, so no tile or halo is staged by hand. The blend
// moves ~50 bytes per pixel and is bound by memory bandwidth; its gather
// is coalesced while the camera moves slowly. powf/expf are the precise
// library functions (no fast math): __powf would drift on w_n = x^128.

#include <cuda_runtime.h>

namespace {

constexpr float kHBox = (float)(1.0 / 9.0);

__global__ void atrous_iter_kernel(const float* __restrict__ color, const float* __restrict__ normal,
                                   const float* __restrict__ depth, float* __restrict__ out,
                                   int width, int height, int k, float sigma_n, float sigma_z,
                                   float sigma_l) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;
  int p = y * width + x;
  float cr = color[3 * p], cg = color[3 * p + 1], cb = color[3 * p + 2];
  float nx = normal[3 * p], ny = normal[3 * p + 1], nz = normal[3 * p + 2];
  float dp = depth[p];
  float sr = 0.0f, sg = 0.0f, sb = 0.0f, den = 0.0f;
  // GLSL loops i (x offset) outer, j (y offset) inner: the same
  // accumulation order as the plain version
  for (int i = -1; i <= 1; ++i) {
    int qx = min(max(x + i * k, 0), width - 1);
    for (int j = -1; j <= 1; ++j) {
      int qy = min(max(y + j * k, 0), height - 1);
      int q = qy * width + qx;
      float qr = color[3 * q], qg = color[3 * q + 1], qb = color[3 * q + 2];
      float ndot = nx * normal[3 * q] + ny * normal[3 * q + 1] + nz * normal[3 * q + 2];
      float w_n = powf(fmaxf(ndot, 0.0f), sigma_n);
      float w_z = expf(-fabsf(dp - depth[q]) / sigma_z);
      float er = cr - qr, eg = cg - qg, eb = cb - qb;
      float w_l = expf(-sqrtf(er * er + eg * eg + eb * eb) / sigma_l);
      float hw = kHBox * (w_n * w_z * w_l);
      sr = sr + hw * qr;
      sg = sg + hw * qg;
      sb = sb + hw * qb;
      den = den + hw;
    }
  }
  out[3 * p] = sr / den;
  out[3 * p + 1] = sg / den;
  out[3 * p + 2] = sb / den;
}

__global__ void temporal_blend_kernel(const float* __restrict__ filtered,
                                      const float* __restrict__ prev_image,
                                      const int* __restrict__ prev_y,
                                      const int* __restrict__ prev_x, const float* __restrict__ lam,
                                      float* __restrict__ out, int width, int height, float alpha,
                                      int adaptive, int frame) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;
  int p = y * width + x;
  if (frame <= 0) {  // frame 0 has no history (temporalFiltering.comp.glsl:251-259)
    for (int c = 0; c < 3; ++c) out[3 * p + c] = filtered[3 * p + c];
    return;
  }
  // clamped so that no index can read outside the history image
  int q = min(max(prev_y[p], 0), height - 1) * width + min(max(prev_x[p], 0), width - 1);
  float a = alpha;
  if (adaptive) a = (1.0f - lam[p]) * alpha + lam[p];
  float keep = 1.0f - a;
  for (int c = 0; c < 3; ++c) out[3 * p + c] = prev_image[3 * q + c] * keep + filtered[3 * p + c] * a;
}

dim3 grid_for(int width, int height, dim3 block) {
  return dim3((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
}

}  // namespace

extern "C" int ptsf_atrous_iter(const float* color, const float* normal, const float* depth,
                                float* out, int width, int height, int k, float sigma_n,
                                float sigma_z, float sigma_l, cudaStream_t stream) {
  dim3 block(32, 8);
  atrous_iter_kernel<<<grid_for(width, height, block), block, 0, stream>>>(
      color, normal, depth, out, width, height, k, sigma_n, sigma_z, sigma_l);
  return (int)cudaGetLastError();
}

extern "C" int ptsf_temporal_blend(const float* filtered, const float* prev_image,
                                   const int* prev_y, const int* prev_x, const float* lam,
                                   float* out, int width, int height, float alpha, int adaptive,
                                   int frame, cudaStream_t stream) {
  dim3 block(32, 8);
  temporal_blend_kernel<<<grid_for(width, height, block), block, 0, stream>>>(
      filtered, prev_image, prev_y, prev_x, lam, out, width, height, alpha, adaptive, frame);
  return (int)cudaGetLastError();
}
