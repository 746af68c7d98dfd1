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

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

// Copy 16 (4) bytes from global to shared memory without holding a
// register; !valid writes zeros and reads nothing (src must still be a
// mapped address).  16-byte copies need both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

enum GemmEpilogue {
  EPI_BIAS = 0,           // C = A@B + bias
  EPI_BIAS_GELU = 1,      // C = gelu_erf(A@B + bias)
  EPI_BIAS_RESIDUAL = 2,  // C = resid + (A@B + bias)
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
// that order, so a rerun on the same inputs gives the same bits.
__global__ void __launch_bounds__(RED_THREADS)
splitk_reduce_kernel(const float* __restrict__ P, float* __restrict__ out,
                     long long n, int splits) {
  const long long i = (long long)blockIdx.x * RED_THREADS + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += P[z * n + i];
  out[i] = s;
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
// one block per row, centered two-pass moments in float32.
__global__ void __launch_bounds__(LN_THREADS)
layernorm_rows_kernel(const float* __restrict__ S, const float* __restrict__ g,
                      const float* __restrict__ b, float* __restrict__ out,
                      int n, float eps) {
  __shared__ float red[33];
  const long long row = blockIdx.x;
  const float* s = S + row * n;
  float* o = out + row * n;
  float sum = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) sum += s[i];
  const float mu = block_sum(sum, red) / (float)n;
  float sq = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float d = s[i] - mu;
    sq = fmaf(d, d, sq);
  }
  const float var = block_sum(sq, red) / (float)n;
  const float inv = 1.0f / sqrtf(var + eps);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    o[i] = ((s[i] - mu) * inv) * g[i] + b[i];
}

}  // namespace
