// Micro-kernels: the eight Mosaic micro-benchmarks of the JAX package on Hopper.
//
// Each kernel replaces one pallas_call site of
// benchmarks/mosaic_micro.py (the JAX package's benchmark, lines 98, 128,
// 159, 189, 222, 250, 280 and 305) and computes what it computes, at the
// same iteration counts: the (8, 512) float32 output, equal to the input
// because the carry is added times zero, and the loop's carries, written
// to a side output so that the loop is live. The benchmark
// (benchmarks/mosaic_micro.py of this package) times each primitive by the
// slope between two iteration counts, in ns per iteration: the questions
// are those a per-lane BVH walk asks of the card (dependent shared-memory
// loads, dynamically indexed rows, guarded stores, block reductions fed
// back into control, divergent branches).
//
// The TPU's SMEM scalars become one thread's registers and a __shared__
// table; its VMEM rows become shared-memory rows read by one thread per
// element:
//   scalar, when, cond    one thread's dependent loop (a block of 128
//                         fills the table and writes the output);
//   dynrow                128 threads, one per column of a 64 KB
//                         (128, 128) table in dynamic shared memory;
//   assemble              1024 threads, one per element of the (8, 128)
//                         rows it gathers from the same table;
//   vec                   one thread per element (128, 1024 or 4096, 1024
//                         to a block);
//   reduce                one block of 1024 threads, four elements each: a
//                         warp-shuffle max, a shared-memory exchange and a
//                         second shuffle in every iteration, the result fed
//                         into every thread's carry;
//   dynwin                1024 threads over a (64, 128) shared table, each
//                         scaling its element of the (8, 128) window at the
//                         dynamic offset.
// Integer carries are uint32_t (int32 wrap-around, defined); the output
// carry converts the int32 bits to float. The JAX kernels run on the CPU in
// interpret mode, where XLA contracts a product that feeds an add into one
// fused multiply-add: the same places are __fmaf_rn here (the library is
// built with --fmad=false, so nothing else is contracted).
//
// What bounds them: latency, not bytes or operations. A launch moves 32 KB
// in and 32 KB out; the loops are chains of dependent operations on one
// thread or one block, so a single SM runs them and ns per iteration is the
// length of one step of the chain.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8, kCols = 512, kN = kRows * kCols;
constexpr int kTableRows = 128;  // dynrow / assemble: (128, 128) table
constexpr int kTableBytes = kTableRows * 128 * sizeof(float);

// out = x wherever the caller's threads do not write: outside rows
// [0, rows) x columns [0, cols).
__device__ void copy_outside(const float* __restrict__ x, float* __restrict__ out, int rows,
                             int cols) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < kN; i += gridDim.x * blockDim.x) {
    if (i / kCols >= rows || i % kCols >= cols) out[i] = x[i];
  }
}

__device__ __forceinline__ float int_bits_to_float(uint32_t u) { return (float)(int)u; }

// scalar: tab[i] = 3i + 1 (512 int32); iters steps of v = tab[a & 511];
// a = (a * 5 + v) & 0x7FFFFFF; b ^= a >> 3 (a < 2^27: the shift is the
// same signed or not). ints: a, b.
__global__ void micro_scalar_kernel(const float* __restrict__ x, float* __restrict__ out,
                                    int* __restrict__ ints, int iters) {
  __shared__ uint32_t tab[512];
  __shared__ float carry;
  for (int i = threadIdx.x; i < 512; i += blockDim.x) tab[i] = 3u * i + 1u;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t a = 1u, b = 2u;
    for (int i = 0; i < iters; ++i) {
      uint32_t v = tab[a & 511u];
      a = (a * 5u + v) & 0x7FFFFFFu;
      b ^= a >> 3;
    }
    ints[0] = (int)a;
    ints[1] = (int)b;
    carry = int_bits_to_float(a + b);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kN; i += blockDim.x) out[i] = x[i] + carry * 0.0f;
}

// dynrow: table row r = x[r % 8, :128]; iters steps of acc += table[a &
// 127]; a = a * 5 + 1. One thread per column. ints: a; floats: acc (1, 128).
__global__ void micro_dynrow_kernel(const float* __restrict__ x, float* __restrict__ out,
                                    int* __restrict__ ints, float* __restrict__ acc_out,
                                    int iters) {
  extern __shared__ float table[];
  int c = threadIdx.x;
  for (int r = 0; r < kTableRows; ++r) table[r * 128 + c] = x[(r % kRows) * kCols + c];
  __syncthreads();
  uint32_t a = 1u;
  float acc = 0.0f;
  for (int i = 0; i < iters; ++i) {
    acc = acc + table[(a & 127u) * 128 + c];
    a = a * 5u + 1u;
  }
  acc_out[c] = acc;
  if (c == 0) ints[0] = (int)a;
  out[c] = x[c] + acc * 0.0f;
  copy_outside(x, out, 1, 128);
}

// assemble: the same table; iters steps of acc[s] += table[(a + 37 s) &
// 127] for the 8 rows s at once; a = a * 5 + 1. One thread per (s,
// column). ints: a; floats: acc (8, 128).
__global__ void micro_assemble_kernel(const float* __restrict__ x, float* __restrict__ out,
                                      int* __restrict__ ints, float* __restrict__ acc_out,
                                      int iters) {
  extern __shared__ float table[];
  for (int i = threadIdx.x; i < kTableRows * 128; i += blockDim.x) {
    table[i] = x[((i / 128) % kRows) * kCols + i % 128];
  }
  __syncthreads();
  int s = threadIdx.x / 128, c = threadIdx.x % 128;
  uint32_t a = 1u;
  float acc = 0.0f;
  for (int i = 0; i < iters; ++i) {
    acc = acc + table[((a + 37u * s) & 127u) * 128 + c];
    a = a * 5u + 1u;
  }
  acc_out[threadIdx.x] = acc;
  if (threadIdx.x == 0) ints[0] = (int)a;
  out[s * kCols + c] = x[s * kCols + c] + acc * 0.0f;
  copy_outside(x, out, kRows, 128);
}

// vec: v = x[:rows, :cols]; acc = v * 0; iters steps of t = acc * 1.0001 +
// v (fused); t = min(max(t, v * 0.5), v * 2 + acc); acc = t - (acc * v) *
// 1e-7 (fused). One thread per element. floats: acc (rows, cols).
__global__ void micro_vec_kernel(const float* __restrict__ x, float* __restrict__ out,
                                 float* __restrict__ acc_out, int rows, int cols, int iters) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < rows * cols) {
    int p = (g / cols) * kCols + g % cols;
    float v = x[p];
    float acc = v * 0.0f;
    for (int i = 0; i < iters; ++i) {
      float t = __fmaf_rn(acc, 1.0001f, v);
      t = fminf(fmaxf(t, v * 0.5f), v * 2.0f + acc);
      acc = __fmaf_rn(-(acc * v), 1e-7f, t);
    }
    acc_out[g] = acc;
    out[p] = v + acc * 0.0f;
  }
  copy_outside(x, out, rows, cols);
}

// when: tab (256 int32) starts at INT_MIN, the value Pallas's interpret
// mode gives scratch it never wrote; iters steps of: if a is even, tab[a &
// 255] = a; a = a * 5 + 1. ints: a, then the table.
__global__ void micro_when_kernel(const float* __restrict__ x, float* __restrict__ out,
                                  int* __restrict__ ints, int iters) {
  __shared__ int tab[256];
  __shared__ float carry;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) tab[i] = INT_MIN;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t a = 1u;
    for (int i = 0; i < iters; ++i) {
      if ((a & 1u) == 0u) tab[a & 255u] = (int)a;
      a = a * 5u + 1u;
    }
    ints[0] = (int)a;
    carry = int_bits_to_float(a + (uint32_t)tab[0]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 256; i += blockDim.x) ints[1 + i] = tab[i];
  for (int i = threadIdx.x; i < kN; i += blockDim.x) out[i] = x[i] + carry * 0.0f;
}

// reduce: iters steps of m = max(x + s) over all (8, 512); s = s + m *
// 1e-20 (fused); a = a * 5 + 1. Every thread keeps s; the per-warp maxima go
// through a double-buffered shared array, so one barrier an iteration
// suffices (a buffer is rewritten only after the next barrier, when every
// thread has read it). A max is exact in any order. ints: a; floats: s.
__global__ void micro_reduce_kernel(const float* __restrict__ x, float* __restrict__ out,
                                    int* __restrict__ ints, float* __restrict__ s_out,
                                    int iters) {
  __shared__ float part[2][32];
  int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  float v0 = x[t], v1 = x[t + 1024], v2 = x[t + 2048], v3 = x[t + 3072];
  uint32_t a = 1u;
  float s = 0.0f;
  for (int i = 0; i < iters; ++i) {
    float m = fmaxf(fmaxf(v0 + s, v1 + s), fmaxf(v2 + s, v3 + s));
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) part[i & 1][warp] = m;
    __syncthreads();
    m = part[i & 1][lane];
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    s = __fmaf_rn(m, 1e-20f, s);
    a = a * 5u + 1u;
  }
  if (t == 0) {
    ints[0] = (int)a;
    s_out[0] = s;
  }
  float af = int_bits_to_float(a) * 0.0f;
  for (int k = 0; k < 4; ++k) out[t + 1024 * k] = x[t + 1024 * k] + s * 0.0f + af;
}

// dynwin: big (64, 128), row r = x[r % 8, :128]; iters steps of big[off:off
// + 8] *= 1.0000001 at off = (a & 7) * 8; a = a * 5 + 1. Thread (r, c)
// owns the elements (8k + r, c), the only ones it scales, so the loop needs
// no barrier. ints: a; floats: big.
__global__ void micro_dynwin_kernel(const float* __restrict__ x, float* __restrict__ out,
                                    int* __restrict__ ints, float* __restrict__ big_out,
                                    int iters) {
  __shared__ float big[64 * 128];
  int r = threadIdx.x / 128, c = threadIdx.x % 128;
  for (int k = 0; k < 8; ++k) big[(8 * k + r) * 128 + c] = x[r * kCols + c];
  uint32_t a = 1u;
  for (int i = 0; i < iters; ++i) {
    float* w = &big[((a & 7u) * 8 + r) * 128 + c];
    *w = *w * 1.0000001f;
    a = a * 5u + 1u;
  }
  for (int k = 0; k < 8; ++k) big_out[(8 * k + r) * 128 + c] = big[(8 * k + r) * 128 + c];
  if (threadIdx.x == 0) ints[0] = (int)a;
  if (r == 0) out[c] = x[c] + big[c] * 0.0f + int_bits_to_float(a) * 0.0f;
  copy_outside(x, out, 1, 128);
}

// cond: iters steps of b = a even ? b + 1 : b - 1; a = a * 5 + 1. ints: a, b.
__global__ void micro_cond_kernel(const float* __restrict__ x, float* __restrict__ out,
                                  int* __restrict__ ints, int iters) {
  __shared__ float carry;
  if (threadIdx.x == 0) {
    uint32_t a = 1u, b = 0u;
    for (int i = 0; i < iters; ++i) {
      if ((a & 1u) == 0u) {
        b = b + 1u;
      } else {
        b = b - 1u;
      }
      a = a * 5u + 1u;
    }
    ints[0] = (int)a;
    ints[1] = (int)b;
    carry = int_bits_to_float(a + b);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kN; i += blockDim.x) out[i] = x[i] + carry * 0.0f;
}

int table_kernel_ready(const void* kernel) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kTableBytes);
}

}  // namespace

// Every entry point: x and out (8, 512) float32; ints and floats the
// carries (floats null where the kernel has none); iters; rows and cols
// (vec only); stream. Returns the CUDA error of the launch.

extern "C" int ptsf_micro_scalar(const float* x, float* out, int* ints, float*, int iters, int,
                                 int, cudaStream_t stream) {
  micro_scalar_kernel<<<1, 128, 0, stream>>>(x, out, ints, iters);
  return (int)cudaGetLastError();
}

extern "C" int ptsf_micro_dynrow(const float* x, float* out, int* ints, float* floats, int iters,
                                 int, int, cudaStream_t stream) {
  int err = table_kernel_ready((const void*)micro_dynrow_kernel);
  if (err != 0) return err;
  micro_dynrow_kernel<<<1, 128, kTableBytes, stream>>>(x, out, ints, floats, iters);
  return (int)cudaGetLastError();
}

extern "C" int ptsf_micro_assemble(const float* x, float* out, int* ints, float* floats,
                                   int iters, int, int, cudaStream_t stream) {
  int err = table_kernel_ready((const void*)micro_assemble_kernel);
  if (err != 0) return err;
  micro_assemble_kernel<<<1, 1024, kTableBytes, stream>>>(x, out, ints, floats, iters);
  return (int)cudaGetLastError();
}

extern "C" int ptsf_micro_vec(const float* x, float* out, int*, float* floats, int iters,
                              int rows, int cols, cudaStream_t stream) {
  int n = rows * cols;
  int block = n < 1024 ? n : 1024;
  micro_vec_kernel<<<(n + block - 1) / block, block, 0, stream>>>(x, out, floats, rows, cols,
                                                                   iters);
  return (int)cudaGetLastError();
}

extern "C" int ptsf_micro_when(const float* x, float* out, int* ints, float*, int iters, int, int,
                               cudaStream_t stream) {
  micro_when_kernel<<<1, 128, 0, stream>>>(x, out, ints, iters);
  return (int)cudaGetLastError();
}

extern "C" int ptsf_micro_reduce(const float* x, float* out, int* ints, float* floats, int iters,
                                 int, int, cudaStream_t stream) {
  micro_reduce_kernel<<<1, 1024, 0, stream>>>(x, out, ints, floats, iters);
  return (int)cudaGetLastError();
}

extern "C" int ptsf_micro_dynwin(const float* x, float* out, int* ints, float* floats, int iters,
                                 int, int, cudaStream_t stream) {
  micro_dynwin_kernel<<<1, 1024, 0, stream>>>(x, out, ints, floats, iters);
  return (int)cudaGetLastError();
}

extern "C" int ptsf_micro_cond(const float* x, float* out, int* ints, float*, int iters, int, int,
                               cudaStream_t stream) {
  micro_cond_kernel<<<1, 128, 0, stream>>>(x, out, ints, iters);
  return (int)cudaGetLastError();
}
