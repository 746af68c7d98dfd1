// Building blocks shared by the port's hand-written Hopper kernels:
//   * the GEMM epilogues (GemmEpilogue) of gemm_tc.cuh's products;
//   * a transposed-A float32 product with split-K, C = A^T @ B over very
//     long K, written with shared-memory tiles and FMA loops (no library
//     GEMM), writing per-split partials that a second pass adds in a fixed
//     order (deterministic: no float atomics);
//   * a row LayerNorm with float32 centered two-pass moments;
//   * the logistic sigmoid of the GRU kernels, and the position hash of the
//     dropout in the flash and trunk-block kernels;
//   * asynchronous global-to-shared copies (cp.async, 4 or 16 bytes, zero
//     fill for a ragged edge), and the per-process raise of a kernel's
//     dynamic shared-memory cap.
// Everything sits in an anonymous namespace, so each .cu file that includes
// this header gets its own copy and the shared library links cleanly.
//
// The transposed-A product is the first, simple form: 64x64 output tiles,
// 16-deep k steps, 256 threads with a 4x4 micro-tile each, CUDA-core FMAs
// (K9b's weight gradients); the tensor-core GEMMs are gemm_tc.cuh's.
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

constexpr int GEMM_TM = 64;
constexpr int GEMM_TN = 64;
constexpr int GEMM_TK = 16;
constexpr int GEMM_THREADS = 256;

enum GemmEpilogue {
  EPI_BIAS = 0,           // C = A@B + bias
  EPI_BIAS_GELU = 1,      // C = gelu_erf(A@B + bias)
  EPI_BIAS_RESIDUAL = 2,  // C = resid + (A@B + bias)
  EPI_NONE = 3,           // C = A@B (bias is not read)
};

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// Transposed-A split-K product: split z of C_part = sum over k in
// [z*kchunk, min(K, (z+1)*kchunk)) of At(k, m) * B(k, n), written row-major
// [M, N] at C + z*stride_c.  At(k, m) = A[k*lda + m], B(k, n) = B[k*ldb +
// n].  Both tile loads walk the contiguous (m or n) axis across threads.
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_f32_tn_splitk_kernel(const float* __restrict__ A, const float* __restrict__ B,
                          float* __restrict__ C, int M, int N, int K, int lda,
                          int ldb, int kchunk, long long stride_c) {
  __shared__ float As[GEMM_TK][GEMM_TM + 4];
  __shared__ float Bs[GEMM_TK][GEMM_TN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * GEMM_TM, col0 = blockIdx.x * GEMM_TN;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(K, kbeg + kchunk);
  C += blockIdx.z * stride_c;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += GEMM_TK) {
    for (int i = tid; i < GEMM_TM * GEMM_TK; i += GEMM_THREADS) {
      const int m = i % GEMM_TM, k = i / GEMM_TM;
      const int gm = row0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < kend) ? A[(long long)gk * lda + gm] : 0.f;
    }
    for (int i = tid; i < GEMM_TK * GEMM_TN; i += GEMM_THREADS) {
      const int n = i % GEMM_TN, k = i / GEMM_TN;
      const int gk = k0 + k, gc = col0 + n;
      Bs[k][n] = (gk < kend && gc < N) ? B[(long long)gk * ldb + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < GEMM_TK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < N) C[(long long)r * N + c] = acc[i][j];
    }
  }
}

void launch_gemm_tn_splitk(const float* A, const float* B, float* C, int M,
                           int N, int K, int lda, int ldb,
                           int kchunk, int splits, long long stride_c,
                           cudaStream_t stream) {
  const dim3 grid((N + GEMM_TN - 1) / GEMM_TN, (M + GEMM_TM - 1) / GEMM_TM,
                  splits);
  gemm_f32_tn_splitk_kernel<<<grid, GEMM_THREADS, 0, stream>>>(
      A, B, C, M, N, K, lda, ldb, kchunk, stride_c);
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
