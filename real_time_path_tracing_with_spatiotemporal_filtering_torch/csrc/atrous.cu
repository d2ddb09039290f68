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
// What bounds them on the H100: atrous_iter is bound by the special
// functions (one powf and two expf per tap, 81 per pixel) more than by its
// ~80 bytes per pixel of traffic; atrous_iter_var has the same special
// functions per tap and adds 9 taps of the variance plane and the 9-tap
// prefilter, for 48 bytes in and out per pixel. The taps of neighbouring threads overlap and
// are served by L1/L2, so no tile or halo is staged by hand. The blend
// moves ~50 bytes per pixel (the ramp mode ~70) and is bound by memory
// bandwidth; its gather is coalesced while the camera moves slowly.
// powf/expf are the precise library functions (no fast math): __powf
// would drift on w_n = x^128.

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

// Rec.709 luminance (ops/atrous.luminance_planes)
constexpr float kLumR = 0.2126f, kLumG = 0.7152f, kLumB = 0.0722f;

__device__ __forceinline__ float luminance(float r, float g, float b) {
  return kLumR * r + kLumG * g + kLumB * b;
}

__global__ void atrous_iter_var_kernel(const float* __restrict__ color,
                                       const float* __restrict__ var,
                                       const float* __restrict__ normal,
                                       const float* __restrict__ depth, float* __restrict__ out,
                                       float* __restrict__ var_out, int width, int height, int k,
                                       float sigma_n, float sigma_z, float sigma_l,
                                       float var_eps) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;
  int p = y * width + x;
  // variance prefilter (ops/atrous._gauss3): rows outer, columns inner
  const float w3[3] = {0.25f, 0.5f, 0.25f};
  float g = 0.0f;
  for (int gy = -1; gy <= 1; ++gy) {
    int ry = min(max(y + gy, 0), height - 1);
    for (int gx = -1; gx <= 1; ++gx) {
      int rx = min(max(x + gx, 0), width - 1);
      g = g + (w3[gy + 1] * w3[gx + 1]) * var[ry * width + rx];
    }
  }
  float cr = color[3 * p], cg = color[3 * p + 1], cb = color[3 * p + 2];
  float nx = normal[3 * p], ny = normal[3 * p + 1], nz = normal[3 * p + 2];
  float dp = depth[p];
  float lp = luminance(cr, cg, cb);
  float denom_l = sigma_l * sqrtf(g) + var_eps;
  float sr = 0.0f, sg = 0.0f, sb = 0.0f, vnum = 0.0f, den = 0.0f;
  for (int i = -1; i <= 1; ++i) {
    int qx = min(max(x + i * k, 0), width - 1);
    for (int j = -1; j <= 1; ++j) {
      int qy = min(max(y + j * k, 0), height - 1);
      int q = qy * width + qx;
      float qr = color[3 * q], qg = color[3 * q + 1], qb = color[3 * q + 2];
      float ndot = nx * normal[3 * q] + ny * normal[3 * q + 1] + nz * normal[3 * q + 2];
      float w_n = powf(fmaxf(ndot, 0.0f), sigma_n);
      float w_z = expf(-fabsf(dp - depth[q]) / sigma_z);
      float w_l = expf(-fabsf(lp - luminance(qr, qg, qb)) / denom_l);
      float hw = kHBox * w_n * w_z * w_l;
      sr = sr + hw * qr;
      sg = sg + hw * qg;
      sb = sb + hw * qb;
      vnum = vnum + hw * hw * var[q];
      den = den + hw;
    }
  }
  out[3 * p] = sr / den;
  out[3 * p + 1] = sg / den;
  out[3 * p + 2] = sb / den;
  var_out[p] = vnum / (den * den);
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

__global__ void temporal_blend_ramp_kernel(
    const float* __restrict__ filtered, const float* __restrict__ prev_image,
    const int* __restrict__ prev_y, const int* __restrict__ prev_x, const float* __restrict__ lam,
    const float* __restrict__ prev_age, const float* __restrict__ prev_cons,
    const float* __restrict__ cur_cons, float* __restrict__ out, float* __restrict__ age_out,
    int width, int height, float alpha_min, float reset_lam, float age_cap, int adaptive,
    int frame) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;
  int p = y * width + x;
  if (frame <= 0) {  // no history: pass through, age 1
    for (int c = 0; c < 3; ++c) out[3 * p + c] = filtered[3 * p + c];
    age_out[p] = 1.0f;
    return;
  }
  int q = min(max(prev_y[p], 0), height - 1) * width + min(max(prev_x[p], 0), width - 1);
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

extern "C" int ptsf_atrous_iter_var(const float* color, const float* var, const float* normal,
                                    const float* depth, float* out, float* var_out, int width,
                                    int height, int k, float sigma_n, float sigma_z,
                                    float sigma_l, float var_eps, cudaStream_t stream) {
  dim3 block(32, 8);
  atrous_iter_var_kernel<<<grid_for(width, height, block), block, 0, stream>>>(
      color, var, normal, depth, out, var_out, width, height, k, sigma_n, sigma_z, sigma_l,
      var_eps);
  return (int)cudaGetLastError();
}

extern "C" int ptsf_temporal_blend_ramp(const float* filtered, const float* prev_image,
                                        const int* prev_y, const int* prev_x, const float* lam,
                                        const float* prev_age, const float* prev_cons,
                                        const float* cur_cons, float* out, float* age_out,
                                        int width, int height, float alpha_min,
                                        float reset_lam, float age_cap, int adaptive, int frame,
                                        cudaStream_t stream) {
  dim3 block(32, 8);
  temporal_blend_ramp_kernel<<<grid_for(width, height, block), block, 0, stream>>>(
      filtered, prev_image, prev_y, prev_x, lam, prev_age, prev_cons, cur_cons, out, age_out,
      width, height, alpha_min, reset_lam, age_cap, adaptive, frame);
  return (int)cudaGetLastError();
}
