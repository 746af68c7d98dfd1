// K4: the frozen-BERT FFN block with int8 weights (--bert_int8),
//   out = LN(x + fc2_q(gelu_erf(fc1_q(x)))),
// each product int8 x int8 -> int32 with per-output-channel float32 weight
// scales and dynamic per-row int8 activations, forward only.
//
// Replaces the TPU kernel multimodal_transformer_robustness_tpu/ops/
// bert_ffn_pallas.py::_ffn_ln_kernel_q (public ffn_ln_block_q via _rows_call).
// Same contract: rows x [R, h] float32; w1q int8 [F, h] with scales w1s [F];
// b1 [F]; w2q int8 [h, F] with w2s [h]; b2, LN g/b [h]; eps.  The weights
// stay [out, in] (K-contiguous), which is the B operand layout ".col" of
// mma.sync ... .row.col ... s8, so they are never transposed.
//
//   xq, sx = qround(x)   sx = max(max|x|, 1e-8) / 127, xq = clamp(rint(x / sx))
//   h1 = float(xq @ w1q^T) * sx * w1s + b1;   g1 = gelu(h1)
//   gq, sg = qround(g1)
//   y  = float(gq @ w2q^T) * sg * w2s + b2;   out = LN(x + y)
//
// Numerics: int32 sums of int8 products are exact in any order, so the
// accumulators equal the plain version's bit for bit.  Rounding is rintf
// (half to even, as jnp.round / torch.round), x / sx a true IEEE division,
// and every multiply and add of the dequant and gelu epilogues is written
// with __fmul_rn / __fadd_rn / __fdiv_rn so nvcc cannot contract them into
// FMAs: with the same exact accumulators the kernel's h1, g1 and codes then
// match the plain PyTorch version's, which runs the same operations one by
// one.  gelu is the JAX kernel's erf rational polynomial (XLA's ErfImpl32,
// bert_ffn_pallas.py:59-85), in the kernel and in the plain version.
//
// Bound: at the training shape (R = 131,072 rows, h = 768, F = 3072) the two
// products are 2 * 2*R*h*F = 1.24e12 int8 operations, 0.63 ms at the
// H100's 1,979 TOP/s int8 tensor-core peak, against ~0.8 GB of float32
// activations in and out (0.24 ms at 3.35 TB/s): operations bound.  At
// serving rows (R = 8..512) the 4.7 MB of int8 weights and the launch
// latency bound it.  This first form runs the products on the int8 tensor
// cores with mma.sync.m16n8k32 (no wgmma, no TMA, no pipelining): 64x64
// output tiles, 64-byte k steps from shared memory, four warps of 32x32.
// The per-row scale of g1 needs the max over a whole F-wide row before any
// of it is quantized, so the block runs in five launches: quantize x; GEMM1
// with the dequant + bias + gelu epilogue into an [R, F] float32 scratch;
// quantize g1; GEMM2 with the dequant + bias + residual epilogue; the row
// LayerNorm.  Keeping g1 on chip is later work.
//
// The same source exports the int8 GEMM with the dequant + bias epilogue as
// mmtr_qdot (the int8 q/k/v/o projections of a fully quantized BERT, XLA's
// int8 dot in the JAX package), the raw int32 product as mmtr_qgemm_i32 (to
// check exactness on the card), and the row quantization as mmtr_qrows.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int Q_THREADS = 256;

// One block per row: sx = max(max|x|, 1e-8) / 127, q = clamp(rint(x / sx)).
__global__ void __launch_bounds__(Q_THREADS)
qrows_kernel(const float* __restrict__ X, int8_t* __restrict__ Q,
             float* __restrict__ S, int n) {
  __shared__ float red[Q_THREADS / 32];
  __shared__ float row_max;
  const long long row = blockIdx.x;
  const float* x = X + row * n;
  int8_t* q = Q + row * n;
  float m = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) m = fmaxf(m, fabsf(x[i]));
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < Q_THREADS / 32 ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) row_max = m;
  }
  __syncthreads();
  const float sx = __fdiv_rn(fmaxf(row_max, (float)1e-8), 127.0f);
  if (threadIdx.x == 0) S[row] = sx;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = fminf(fmaxf(rintf(__fdiv_rn(x[i], sx)), -127.f), 127.f);
    q[i] = (int8_t)v;
  }
}

// XLA's float32 erf rational approximation (the JAX kernel's _ERF_P/_ERF_Q):
// erf(w) = w * P(w^2) / Q(w^2), w clamped to [-4, 4]; gelu(v) = v/2 (1+erf).
__device__ __forceinline__ float gelu_erf_poly(float v) {
  const float w = fminf(fmaxf(__fmul_rn(v, (float)0.7071067811865476), -4.0f), 4.0f);
  const float w2 = __fmul_rn(w, w);
  float p = (float)0.00022905065861350646;
  p = __fadd_rn(__fmul_rn(p, w2), (float)0.0034082910107109506);
  p = __fadd_rn(__fmul_rn(p, w2), (float)0.050955695062380861);
  p = __fadd_rn(__fmul_rn(p, w2), (float)0.18520832239976145);
  p = __fadd_rn(__fmul_rn(p, w2), (float)1.128379143519084);
  float q = (float)-1.1791602954361697e-7;
  q = __fadd_rn(__fmul_rn(q, w2), (float)2.3547966471313185e-5);
  q = __fadd_rn(__fmul_rn(q, w2), (float)0.0010179625278914885);
  q = __fadd_rn(__fmul_rn(q, w2), (float)0.014070470171167667);
  q = __fadd_rn(__fmul_rn(q, w2), (float)0.11098505178285362);
  q = __fadd_rn(__fmul_rn(q, w2), (float)0.49746925110067538);
  q = __fadd_rn(__fmul_rn(q, w2), 1.0f);
  const float erf = __fdiv_rn(__fmul_rn(w, p), q);
  return __fmul_rn(__fmul_rn(v, 0.5f), __fadd_rn(1.0f, erf));
}

constexpr int QG_BM = 64;
constexpr int QG_BN = 64;
constexpr int QG_BK = 64;            // bytes of k per shared-memory tile
constexpr int QG_LDS = QG_BK + 16;   // padded row: conflict-free fragment reads
constexpr int QG_THREADS = 128;      // four warps, 2 x 2, each 32 x 32 outputs

enum QEpilogue {
  QEPI_I32 = 0,           // Ci = A @ B^T (int32)
  QEPI_BIAS = 1,          // C = float(A @ B^T) * sa * sb + bias
  QEPI_BIAS_GELU = 2,     // C = gelu(float(A @ B^T) * sa * sb + bias)
  QEPI_BIAS_RESIDUAL = 3, // C = resid + (float(A @ B^T) * sa * sb + bias)
};

// D += A (16x32, row) * B (32x8, col), int8 in, int32 accumulators.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A 64-row x 64-byte tile of the row-major int8 matrix src [rows, K] (row
// stride K) into dst [64][QG_LDS]; zero outside the matrix.
__device__ __forceinline__ void load_tile_s8(int8_t* dst, const int8_t* __restrict__ src,
                                             int rows, int K, int row0, int k0,
                                             bool vec_ok) {
  for (int c = threadIdx.x; c < 64 * (QG_BK / 16); c += QG_THREADS) {
    const int r = c / (QG_BK / 16), kc = (c % (QG_BK / 16)) * 16;
    const int gr = row0 + r, gk = k0 + kc;
    int8_t* d = dst + r * QG_LDS + kc;
    if (vec_ok && gr < rows && gk + 16 <= K) {
      *reinterpret_cast<int4*>(d) =
          *reinterpret_cast<const int4*>(src + (long long)gr * K + gk);
    } else {
      for (int j = 0; j < 16; ++j)
        d[j] = (gr < rows && gk + j < K) ? src[(long long)gr * K + gk + j] : (int8_t)0;
    }
  }
}

// C [M, N] = epilogue(A [M, K] @ B [N, K]^T); A and B int8, both K-contiguous.
template <int EPI>
__global__ void __launch_bounds__(QG_THREADS)
qgemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B, int M,
             int N, int K, bool vec_ok, const float* __restrict__ sa,
             const float* __restrict__ sb, const float* __restrict__ bias,
             const float* __restrict__ resid, float* __restrict__ C,
             int* __restrict__ Ci) {
  __shared__ __align__(16) int8_t As[QG_BM * QG_LDS];
  __shared__ __align__(16) int8_t Bs[QG_BN * QG_LDS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int row0 = blockIdx.y * QG_BM, col0 = blockIdx.x * QG_BN;

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  for (int k0 = 0; k0 < K; k0 += QG_BK) {
    load_tile_s8(As, A, M, K, row0, k0, vec_ok);
    load_tile_s8(Bs, B, N, K, col0, k0, vec_ok);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < QG_BK; kk += 32) {
      // fragments (PTX ISA, mma.m16n8k32 .s8): A reg 0 = row g, k 4t..4t+3;
      // reg 1 = row g+8; regs 2/3 the same rows at k + 16.  B reg 0 = column
      // g, k 4t..4t+3; reg 1 at k + 16.  Lower k in the lower byte.
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* p = As + (wm + mi * 16 + g) * QG_LDS + kk + 4 * t;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * QG_LDS);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * QG_LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = Bs + (wn + ni * 8 + g) * QG_LDS + kk + 4 * t;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(p);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  // accumulators: reg j of tile (mi, ni) is row g + 8*(j/2), column 2t + j%2
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = row0 + wm + mi * 16 + g + 8 * (j >> 1);
        const int c = col0 + wn + ni * 8 + 2 * t + (j & 1);
        if (r >= M || c >= N) continue;
        const long long o = (long long)r * N + c;
        const int v = acc[mi][ni][j];
        if (EPI == QEPI_I32) {
          Ci[o] = v;
        } else {
          float f = __fadd_rn(__fmul_rn(__fmul_rn((float)v, sa[r]), sb[c]), bias[c]);
          if (EPI == QEPI_BIAS_GELU) f = gelu_erf_poly(f);
          if (EPI == QEPI_BIAS_RESIDUAL) f = __fadd_rn(resid[o], f);
          C[o] = f;
        }
      }
}

template <int EPI>
cudaError_t launch_qgemm(const int8_t* A, const int8_t* B, int M, int N, int K,
                         const float* sa, const float* sb, const float* bias,
                         const float* resid, float* C, int* Ci, cudaStream_t stream) {
  const bool vec_ok = K % 16 == 0 && (reinterpret_cast<uintptr_t>(A) % 16) == 0 &&
                      (reinterpret_cast<uintptr_t>(B) % 16) == 0;
  const dim3 grid((N + QG_BN - 1) / QG_BN, (M + QG_BM - 1) / QG_BM);
  qgemm_kernel<EPI><<<grid, QG_THREADS, 0, stream>>>(A, B, M, N, K, vec_ok, sa, sb,
                                                      bias, resid, C, Ci);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mmtr_qrows(const float* x, int8_t* xq, float* sx, int rows, int n,
                          void* stream_ptr) {
  qrows_kernel<<<rows, Q_THREADS, 0, (cudaStream_t)stream_ptr>>>(x, xq, sx, n);
  return (int)cudaGetLastError();
}

extern "C" int mmtr_qgemm_i32(const int8_t* a, const int8_t* b, int* out, int M,
                              int N, int K, void* stream_ptr) {
  return (int)launch_qgemm<QEPI_I32>(a, b, M, N, K, nullptr, nullptr, nullptr,
                                     nullptr, nullptr, out, (cudaStream_t)stream_ptr);
}

extern "C" int mmtr_qdot(const int8_t* xq, const float* sx, const int8_t* wq,
                         const float* ws, const float* bias, float* out, int M,
                         int N, int K, void* stream_ptr) {
  return (int)launch_qgemm<QEPI_BIAS>(xq, wq, M, N, K, sx, ws, bias, nullptr, out,
                                      nullptr, (cudaStream_t)stream_ptr);
}

extern "C" int mmtr_ffn_ln_q_fwd(const float* x, const int8_t* w1q, const float* w1s,
                                 const float* b1, const int8_t* w2q, const float* w2s,
                                 const float* b2, const float* ln_g, const float* ln_b,
                                 int8_t* xq, float* sx, float* hidden, int8_t* hq,
                                 float* sh, float* resid_sum, float* out, int rows,
                                 int h, int ffn, float eps, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  qrows_kernel<<<rows, Q_THREADS, 0, stream>>>(x, xq, sx, h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_qgemm<QEPI_BIAS_GELU>(xq, w1q, rows, ffn, h, sx, w1s, b1, nullptr,
                                     hidden, nullptr, stream);
  if (err != cudaSuccess) return (int)err;
  qrows_kernel<<<rows, Q_THREADS, 0, stream>>>(hidden, hq, sh, ffn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_qgemm<QEPI_BIAS_RESIDUAL>(hq, w2q, rows, h, ffn, sh, w2s, b2, x,
                                         resid_sum, nullptr, stream);
  if (err != cudaSuccess) return (int)err;
  layernorm_rows_kernel<<<rows, LN_THREADS, 0, stream>>>(resid_sum, ln_g, ln_b,
                                                         out, h, eps);
  return (int)cudaGetLastError();
}
