// Building blocks shared by the port's hand-written Hopper kernels:
//   * the GEMM epilogues (GemmEpilogue, EpiArgs) of gemm_tc.cuh's products;
//   * the fixed-order sum of split-K partial planes (deterministic: no float
//     atomics);
//   * a row LayerNorm with float32 centered two-pass moments;
//   * the logistic sigmoid of the GRU kernels, and the position hash of the
//     dropout in the flash and trunk-block kernels;
//   * asynchronous global-to-shared copies (cp.async, 4 or 16 bytes, zero
//     fill for a ragged edge), and the per-process raise of a kernel's
//     dynamic shared-memory cap.
// Everything sits in an anonymous namespace, so each .cu file that includes
// this header gets its own copy and the shared library links cleanly.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// bf16 storage, float32 arithmetic (the bf16 instances of K1, K1b, K2 and
// K3): conversions only through the intrinsics, round to nearest even.
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16_rn(v); }
// v rounded to its nearest bf16 value, kept in float32
__device__ __forceinline__ float rbf(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
// An element of a float or bf16 array as float32, and one stored back
// (rounded to bf16 where the array is bf16): a kernel templated on its
// storage type reads and writes through these, so its float instance
// compiles to plain loads and stores.
__device__ __forceinline__ float ld_f(const float* p) { return *p; }
__device__ __forceinline__ float ld_f(const bf16* p) { return bf2f(*p); }
__device__ __forceinline__ void st_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void st_f(bf16* p, float v) { *p = f2bf(v); }
// v as a value of type T holds it: itself for float, rbf(v) for bf16
template <typename T>
__device__ __forceinline__ float as_t(float v) { return v; }
template <>
__device__ __forceinline__ float as_t<bf16>(float v) { return rbf(v); }

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// The dropout draw of position (row, col): murmur3 fmix32 of
// seed ^ row*0x9E3779B1 ^ col*0x85EBCA77 in uint32 arithmetic, top 24 bits
// times 2^-24.  It equals the JAX package's _hash_uniform
// (ops/attention_pallas.py) and the port's ops/attention_cuda.hash_uniform
// bit for bit, so a kernel regenerates the same mask at any tiling.
__device__ __forceinline__ float hash_uniform(uint32_t seed, int row, int col) {
  uint32_t h = ((uint32_t)row * 0x9E3779B1u) ^ ((uint32_t)col * 0x85EBCA77u) ^ seed;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return (float)(h >> 8) * (1.0f / 16777216.0f);
}

// What one block may take of an SM's shared memory on Hopper (227 KB).
constexpr int MAX_SMEM_BYTES = 232448;

// Raise a kernel's dynamic shared-memory cap to MAX_SMEM_BYTES once per
// device and process: *done is the caller's static, one bit per device.
inline cudaError_t allow_smem_once(const void* kernel, unsigned long long* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((*done >> dev) & 1ull) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SMEM_BYTES);
  if (err == cudaSuccess) *done |= 1ull << dev;
  return err;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy 16 (8, 4) bytes from global to shared memory without holding a
// register; !valid writes zeros and reads nothing (src must still be a
// mapped address).  A copy needs both addresses aligned to its size.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The bf16 tensor-core primitives of the mma.sync kernels (gemm_bf16.cuh,
// K2.bf16's attention, K1f.bf16's recurrence): ldmatrix of four 8 x 8 bf16
// tiles (plain or transposed), m16n8k16 with float32 sums, and two floats
// rounded to a bf16 pair (lo in the low half).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Not volatile: the compiler may interleave independent MMAs.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A product's epilogue.  The bf16 products (gemm_bf16.cuh) read a bf16
// bias and resid and round where the JAX kernels round at bf16: r(v), v
// rounded to bf16, and C rounded as it is stored where it is bf16; the
// float32 products do not round (r(v) = v).
enum GemmEpilogue {
  EPI_BIAS = 0,           // C = A@B + bias
  EPI_BIAS_GELU = 1,      // C = gelu_erf(r(A@B + bias))
  EPI_BIAS_RESIDUAL = 2,  // C = r(resid + r(A@B + bias))
  EPI_NONE = 3,           // C = A@B (bias is not read)
  // K9's (trunk_block.cu), with EpiArgs; d(r, c): the dropout factor
  // keep or 0 drawn at (global row r, c / rep), 1 without dropout
  EPI_K9_MID = 4,         // C = d * act((A@B + bias) * mask)
  EPI_K9_OUT = 5,         // C = resid + ((A@B + bias) * mask) * d
  EPI_K9_DP = 6,          // C = A@B * (d * act'(resid) * mask), resid the
                          //     EPI_K9_MID output (act' from its sign)
};

// What the K9 epilogues read besides bias and resid; the other epilogues
// take it zeroed and read nothing of it.
struct EpiArgs {
  const float* mask;      // [N]
  int act;                // 1: relu, 0: identity
  int use_drop, rep;      // dropout on; columns per draw
  uint32_t seed;
  float rate, keep;       // keep = 1 / (1 - rate)
};

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

constexpr int RED_THREADS = 256;

// The second pass: out[i] = sum over z = 0 .. splits-1 of P[z*n + i], in
// that order, so a rerun on the same inputs gives the same bits (O = bf16:
// the sum rounded as it is stored).
template <typename O>
__global__ void __launch_bounds__(RED_THREADS)
splitk_reduce_kernel(const float* __restrict__ P, O* __restrict__ out,
                     long long n, int splits) {
  const long long i = (long long)blockIdx.x * RED_THREADS + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += P[z * n + i];
  st_f(out + i, s);
}

constexpr int LN_THREADS = 256;

// Sum over the block; red holds 33 floats.  Every thread gets the result.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = (lane < (int)(blockDim.x / 32)) ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  const float total = red[32];
  __syncthreads();
  return total;
}

// out[row] = ((s - mean) / sqrt(var + eps)) * g + b over rows of length n,
// one block per row, centered two-pass moments in float32; T = bf16: s, g,
// b and out bf16, the arithmetic float32, out rounded as it is stored (the
// JAX kernels' _ln_epilogue then astype).
template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
layernorm_rows_kernel(const T* __restrict__ S, const T* __restrict__ g,
                      const T* __restrict__ b, T* __restrict__ out,
                      int n, float eps) {
  __shared__ float red[33];
  const long long row = blockIdx.x;
  const T* s = S + row * n;
  T* o = out + row * n;
  float sum = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) sum += ld_f(s + i);
  const float mu = block_sum(sum, red) / (float)n;
  float sq = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float d = ld_f(s + i) - mu;
    sq = fmaf(d, d, sq);
  }
  const float var = block_sum(sq, red) / (float)n;
  const float inv = 1.0f / sqrtf(var + eps);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    st_f(o + i, ((ld_f(s + i) - mu) * inv) * ld_f(g + i) + ld_f(b + i));
}

}  // namespace
