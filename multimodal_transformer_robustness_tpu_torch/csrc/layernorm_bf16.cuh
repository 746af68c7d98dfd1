// The bf16 row LayerNorms that follow the persistent bf16 products
// (gemm_bf16.cuh's gemm_bf16_persistent_kernel): K3.bf16's after fc2,
// K2.bf16's and K6b.bf16's after the o-projection.  out = LN(S) over rows
// of n bf16, float32 centered moments, rounded to bf16 as it is stored, as
// common.cuh's layernorm_rows_kernel computes it, which the serving and
// eval rows keep (layernorm_bf16 picks by plan).
#pragma once

#include "common.cuh"

namespace {

// The row LayerNorm where the products before it ran on the persistent
// kernel (K3.bf16's after fc2, K2.bf16's and K6b.bf16's after the
// o-projection): a warp a row (layernorm_rows_kernel's block a row spent
// 0.39 ms at B=4096 L=32, 3x the bytes' time, in its block-wide
// reductions), the row in registers, NV 16-byte pieces a lane (h <= 256 NV,
// a multiple of 8), the moments float32 and centered in two passes, summed
// by shuffles; the output as layernorm_rows_kernel's, rounded as it is
// stored.
constexpr int LNW_ROWS = 8;   // rows (warps) a block

template <int NV>
__global__ void __launch_bounds__(32 * LNW_ROWS)
layernorm_rows_warp_bf16(const bf16* __restrict__ S, const bf16* __restrict__ g,
                         const bf16* __restrict__ b, bf16* __restrict__ out, int rows, int n,
                         float eps) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * LNW_ROWS + threadIdx.x / 32;
  if (row >= rows) return;
  float v[NV][8];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (32 * j + lane) * 8;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (c < n) u = *reinterpret_cast<const uint4*>(S + row * n + c);
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[j][i] = bf2f(e[i]);
      sum += v[j][i];
    }
  }
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float mu = sum / (float)n;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j)
    if ((32 * j + lane) * 8 < n)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d = v[j][i] - mu;
        sq = fmaf(d, d, sq);
      }
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  const float inv = 1.0f / sqrtf(sq / (float)n + eps);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (32 * j + lane) * 8;
    if (c >= n) continue;
    const uint4 gu = *reinterpret_cast<const uint4*>(g + c);
    const uint4 bu = *reinterpret_cast<const uint4*>(b + c);
    const bf16* ge = reinterpret_cast<const bf16*>(&gu);
    const bf16* be = reinterpret_cast<const bf16*>(&bu);
    uint4 o;
    uint32_t* w = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = pack_bf16(((v[j][2 * i] - mu) * inv) * bf2f(ge[2 * i]) + bf2f(be[2 * i]),
                       ((v[j][2 * i + 1] - mu) * inv) * bf2f(ge[2 * i + 1]) +
                           bf2f(be[2 * i + 1]));
    *reinterpret_cast<uint4*>(out + row * n + c) = o;
  }
}

// The bf16 row LayerNorm of K2, K3 and K6b: the warp form after the
// persistent products (warp_rows; h a multiple of 8 up to 1024, every row
// 16-byte aligned), else layernorm_rows_kernel as the other bf16 instances
// run it (the serving and eval rows keep their bits).
inline cudaError_t layernorm_bf16(bool warp_rows, const bf16* S, const bf16* g,
                                      const bf16* b, bf16* out, int rows, int n, float eps,
                                      cudaStream_t stream) {
  const bool aligned = n % 8 == 0 && n <= 1024 &&
                       ((reinterpret_cast<uintptr_t>(S) | reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(out)) &
                        15) == 0;
  if (!warp_rows || !aligned) {
    layernorm_rows_kernel<bf16><<<rows, LN_THREADS, 0, stream>>>(S, g, b, out, n, eps);
    return cudaGetLastError();
  }
  const unsigned blocks = (unsigned)((rows + LNW_ROWS - 1) / LNW_ROWS);
  const int nv = (n + 255) / 256;
  if (nv == 1)
    layernorm_rows_warp_bf16<1><<<blocks, 32 * LNW_ROWS, 0, stream>>>(S, g, b, out, rows, n, eps);
  else if (nv == 2)
    layernorm_rows_warp_bf16<2><<<blocks, 32 * LNW_ROWS, 0, stream>>>(S, g, b, out, rows, n, eps);
  else if (nv == 3)
    layernorm_rows_warp_bf16<3><<<blocks, 32 * LNW_ROWS, 0, stream>>>(S, g, b, out, rows, n, eps);
  else
    layernorm_rows_warp_bf16<4><<<blocks, 32 * LNW_ROWS, 0, stream>>>(S, g, b, out, rows, n, eps);
  return cudaGetLastError();
}

}  // namespace
