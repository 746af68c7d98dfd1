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
// latency bound it.
// Each product takes its plan's tiles (ops/bert_ffn_cuda._plan_ffn_q): where
// the rows fill the card, a persistent, warp-specialized kernel of
// wgmma.mma_async m64n128k32 s32.s8.s8 over 128 x 128 tiles, both operands
// read K-major from shared memory, the layout xq, the hidden codes and the
// [out, in] weights already have, the epilogue overlapping the MMAs (below);
// for few rows the 64 x 64 mma.sync.m16n8k32 tiles (64-byte k steps, four
// warps of 32 x 32).
// The per-row scale of g1 needs the max over a whole F-wide row before any
// of it is quantized, so the block runs in five launches: quantize x; GEMM1
// with the dequant + bias epilogue into an [R, F] float32 scratch (h1);
// gelu and quantize h1 (g1 = gelu(h1) kept in registers between the row's
// max and its codes, never written: the gelu's ~60 instructions an output
// run in a streaming pass at full occupancy rather than in the GEMM's
// epilogue); GEMM2 with the dequant + bias + residual epilogue; the row
// LayerNorm.  The hidden round trip is h1 written and read once (1.61 GB
// each at the training rows) and its codes written and read once (0.40 GB
// each).  Keeping h1 on chip is later work.
//
// The same source exports the int8 GEMM with the dequant + bias epilogue as
// mmtr_qdot (the int8 q/k/v/o projections of a fully quantized BERT, XLA's
// int8 dot in the JAX package), the raw int32 product as mmtr_qgemm_i32 (to
// check exactness on the card), and the row quantization as mmtr_qrows.
//
// K4, qdot and qrows have bf16 instances (the *_bf16 entries: the int8 BERT
// under the bf16 compute policy, the JAX kernel at bf16 rows): the quantize
// pass and the epilogues are templates on the rows' storage type T, the
// int8 products and their plans unchanged.  bf16 rows, scales, biases and
// LN parameters are read as float32; h1 and y are rounded to bf16 after
// their dequant + bias, g1 = gelu(h1) before its max and codes, x + y after
// the sum, and the LN's output as it is stored.  Bound at the training
// shape: the same 1.24e12 int8 operations (0.63 ms), against 0.40 GB of bf16
// rows in and out; h1 is 0.81 GB a way instead of 1.61.
#include <stdint.h>

#include "gemm_tc.cuh"

namespace {

constexpr int Q_THREADS = 256;
constexpr int Q_VECS = 4;   // float4s of a row a thread keeps in registers

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

// Row quantization: v = x (GELU: gelu_erf_poly(x), K4's g1 from GEMM1's
// dequantized sums h1), sx = max(max|v|, 1e-8) / 127, q = clamp(rint(v /
// sx)), TPR threads a row (64, four rows a block, or Q_THREADS).  The row's
// v stay in registers between the max and the codes (Q_VECS float4s a
// thread; a longer row's tail is recomputed), so x is read once and g1 is
// never written; 16-byte loads (8-byte at bf16) and 4-byte stores where n
// is a multiple of 4 and X, Q aligned.  The max is exact in any order, so
// the codes do not depend on the path.  T: the rows' storage type, float,
// or bf16 for K4's bf16 instance, where x is read as float32 and g1 is
// rounded to bf16 before its max and codes (the JAX kernel's
// _gelu_erf(h1) in the bf16 h1's dtype).
template <bool GELU, typename T>
__device__ __forceinline__ float q_value(float v) {
  return GELU ? as_t<T>(gelu_erf_poly(v)) : v;
}

template <bool GELU, typename T>
__device__ __forceinline__ float4 q_value4(float4 v) {
  return make_float4(q_value<GELU, T>(v.x), q_value<GELU, T>(v.y), q_value<GELU, T>(v.z),
                     q_value<GELU, T>(v.w));
}

// A value of the rows' storage type T as float32, and float32 stored as T
// (rounded where T is bf16); four elements in one load (QVec: 16 bytes of
// float, 8 of bf16) as a float4.  The float overloads are the identity, so
// the float instances compile to the loads and stores they always had.
__device__ __forceinline__ float q_f(float v) { return v; }
__device__ __forceinline__ float q_f(bf16 v) { return bf2f(v); }
template <typename T>
__device__ __forceinline__ T q_t(float v);
template <>
__device__ __forceinline__ float q_t<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 q_t<bf16>(float v) { return f2bf(v); }

template <typename T>
struct QVec;
template <>
struct QVec<float> {
  using type = float4;
};
template <>
struct QVec<bf16> {
  using type = uint2;
};

__device__ __forceinline__ float4 q_f4(float4 v) { return v; }
__device__ __forceinline__ float4 q_f4(uint2 u) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float q_max4(float m, float4 v) {
  return fmaxf(fmaxf(m, fmaxf(fabsf(v.x), fabsf(v.y))), fmaxf(fabsf(v.z), fabsf(v.w)));
}

__device__ __forceinline__ int q_code(float v, float sx) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(v, sx)), -127.f), 127.f);
}

// Four codes in one word, the lower k in the lower byte.
__device__ __forceinline__ int q_code4(float4 v, float sx) {
  return (q_code(v.x, sx) & 0xff) | (q_code(v.y, sx) & 0xff) << 8 |
         (q_code(v.z, sx) & 0xff) << 16 | (int)((unsigned)q_code(v.w, sx) << 24);
}

template <bool GELU, int TPR, typename T>
__global__ void __launch_bounds__(Q_THREADS)
qrows_kernel(const T* __restrict__ X, int8_t* __restrict__ Q, float* __restrict__ S,
             int rows, int n) {
  __shared__ float red[Q_THREADS / 32];
  const int lt = threadIdx.x % TPR;   // this thread's place in its row
  const long long row = (long long)blockIdx.x * (Q_THREADS / TPR) + threadIdx.x / TPR;
  const bool live = TPR == Q_THREADS || row < rows;   // a block a row: the grid has rows
  const T* x = X + (live ? row : 0) * n;
  int8_t* q = Q + (live ? row : 0) * n;
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(X) % (4 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(Q) % 4 == 0;
  const auto* x4 = reinterpret_cast<const typename QVec<T>::type*>(x);
  const int n4 = vec && live ? n / 4 : 0;
  float4 keep[Q_VECS];
#pragma unroll
  for (int j = 0; j < Q_VECS; ++j) {
    const int i = lt + j * TPR;
    keep[j] = i < n4 ? q_value4<GELU, T>(q_f4(x4[i])) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < Q_VECS; ++j) m = q_max4(m, keep[j]);
  for (int i = lt + Q_VECS * TPR; i < n4; i += TPR)
    m = q_max4(m, q_value4<GELU, T>(q_f4(x4[i])));
  if (!vec && live)
    for (int i = lt; i < n; i += TPR) m = fmaxf(m, fabsf(q_value<GELU, T>(q_f(x[i]))));
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) red[warp] = m;
  __syncthreads();
  const int w0 = warp - lt / 32;   // the row's first warp
#pragma unroll
  for (int w = 0; w < TPR / 32; ++w) m = fmaxf(m, red[w0 + w]);
  if (!live) return;
  const float sx = __fdiv_rn(fmaxf(m, (float)1e-8), 127.0f);
  if (lt == 0) S[row] = sx;
  int* q4 = reinterpret_cast<int*>(q);
#pragma unroll
  for (int j = 0; j < Q_VECS; ++j) {
    const int i = lt + j * TPR;
    if (i < n4) q4[i] = q_code4(keep[j], sx);
  }
  for (int i = lt + Q_VECS * TPR; i < n4; i += TPR)
    q4[i] = q_code4(q_value4<GELU, T>(q_f4(x4[i])), sx);
  if (!vec)
    for (int i = lt; i < n; i += TPR) q[i] = (int8_t)q_code(q_value<GELU, T>(q_f(x[i])), sx);
}

// Rows of up to 4 * Q_VECS * 64 = 1,024 (x at BERT-base width) share a
// block four to one; longer ones (the hidden 3,072) take a block each.
template <bool GELU, typename T>
void launch_qrows_t(const T* x, int8_t* xq, float* sx, int rows, int n, cudaStream_t stream) {
  if (n <= 4 * Q_VECS * 64)
    qrows_kernel<GELU, 64, T><<<(rows + 3) / 4, Q_THREADS, 0, stream>>>(x, xq, sx, rows, n);
  else
    qrows_kernel<GELU, Q_THREADS, T><<<rows, Q_THREADS, 0, stream>>>(x, xq, sx, rows, n);
}

template <typename T>
cudaError_t launch_qrows(const T* x, int8_t* xq, float* sx, int rows, int n, bool gelu,
                         cudaStream_t stream) {
  if (gelu)
    launch_qrows_t<true>(x, xq, sx, rows, n, stream);
  else
    launch_qrows_t<false>(x, xq, sx, rows, n, stream);
  return cudaGetLastError();
}

constexpr int QG_BM = 64;
constexpr int QG_BN = 64;
constexpr int QG_BK = 64;            // bytes of k per shared-memory tile
constexpr int QG_LDS = QG_BK + 16;   // padded row: conflict-free fragment reads
constexpr int QG_THREADS = 128;      // four warps, 2 x 2, each 32 x 32 outputs

// T, the type of C and of the scales, biases and residual the epilogue
// reads (sa, the rows' scales, stay float32): float, or bf16 for the bf16
// instances of K4 and qdot.
enum QEpilogue {
  QEPI_I32 = 0,           // Ci = A @ B^T (int32)
  QEPI_BIAS = 1,          // C = float(A @ B^T) * sa * sb + bias
  QEPI_BIAS_RESIDUAL = 2, // C = resid + (float(A @ B^T) * sa * sb + bias)
};

// Output o = (r, c) of a product from its exact int32 sum v, the row's
// scale sa_r and the column's scale and bias: float(v) * sa_r * sb_c +
// bias_c (then resid[o] + it), each operation rounded on its own, in the
// plain version's order.  T = bf16 (the bf16 instances): each of the two
// results rounded to bf16, as the JAX kernel's astype rounds them.
template <int EPI, typename T>
__device__ __forceinline__ float q_epilogue(int v, float sa_r, float sb_c, float bias_c,
                                            const T* __restrict__ resid, long long o) {
  const float f = as_t<T>(__fadd_rn(__fmul_rn(__fmul_rn((float)v, sa_r), sb_c), bias_c));
  return EPI == QEPI_BIAS_RESIDUAL ? as_t<T>(__fadd_rn(q_f(resid[o]), f)) : f;
}

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
template <int EPI, typename T>
__global__ void __launch_bounds__(QG_THREADS)
qgemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B, int M,
             int N, int K, bool vec_ok, const float* __restrict__ sa,
             const T* __restrict__ sb, const T* __restrict__ bias,
             const T* __restrict__ resid, T* __restrict__ C,
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
        if (EPI == QEPI_I32)
          Ci[o] = v;
        else
          C[o] = q_t<T>(q_epilogue<EPI, T>(v, sa[r], q_f(sb[c]), q_f(bias[c]), resid, o));
      }
}

template <int EPI, typename T>
cudaError_t launch_qgemm_sync(const int8_t* A, const int8_t* B, int M, int N, int K,
                              const float* sa, const T* sb, const T* bias, const T* resid,
                              T* C, int* Ci, cudaStream_t stream) {
  const bool vec_ok = K % 16 == 0 && (reinterpret_cast<uintptr_t>(A) % 16) == 0 &&
                      (reinterpret_cast<uintptr_t>(B) % 16) == 0;
  const dim3 grid((N + QG_BN - 1) / QG_BN, (M + QG_BM - 1) / QG_BM);
  qgemm_kernel<EPI, T><<<grid, QG_THREADS, 0, stream>>>(A, B, M, N, K, vec_ok, sa, sb,
                                                         bias, resid, C, Ci);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Many rows: warpgroup MMA.  wgmma.mma_async m64n128k32 s32.s8.s8 reads both
// operands from shared memory K-major (for 8-bit types the only layout it
// takes), which is how A [M, K] (xq, the hidden codes) and B [N, K] (the
// [out, in] weights) lie in memory: nothing is transposed.
//
// On an H100 the products alone run about as fast as cuBLAS's int8 GEMM
// (tools/k4_trials.py times both), and an epilogue that follows the MMAs in
// the same warps cost as much again: GEMM2's residual stream, and GEMM1's
// gelu, ~60 float32 instructions an output at 402M outputs.  So the gelu
// moved to the quantize pass (qrows_kernel), and the kernel is persistent
// (one block an SM walks 128 x 128 output tiles, the column tiles of a row
// tile together) and warp-specialized:
//   * two MMA warpgroups, 64 rows x 128 columns each, feed a 4-stage ring of
//     128-byte k tiles (four k32 steps) by 16-byte cp.async two tiles ahead,
//     in 128-byte-swizzled rows (16-byte chunk c of row r at c ^ (r % 8),
//     1024-byte atoms: gemm_tc.cuh's TF32 stages' byte geometry, so its
//     descriptor), one named barrier a k tile, a batch in flight while the
//     next tile's copies go out; at a tile's end they hand the int32 sums
//     to shared memory (Cs) and start the next tile;
//   * two epilogue warpgroups take Cs row by row (a warp a row, four
//     columns a lane: 16-byte loads of the residual and stores of C) while
//     the MMAs of the next tile run.
// Cs is handed over by two named barriers (full / empty).  The accumulator
// reset and the handoff sit outside the k loop: a branch in it that reads
// the sums made ptxas serialize the wgmmas (its C7518 note).  A thread holds
// at most 64 int32 sums; int32 sums of int8 products are exact in any order,
// so nothing is promoted and the sums equal the mma.sync tiles' and the
// plain version's.
constexpr int QW_BM = 128;                                // rows of a tile
constexpr int QW_BN = 128;                                // columns of a tile
constexpr int QW_BK = 128;                                // k bytes of a tile
constexpr int QW_STAGES = 4;
constexpr int QW_MMA_THREADS = 256;                       // two MMA warpgroups
constexpr int QW_THREADS = 512;                           // + two epilogue warpgroups
constexpr int QW_TILE = QW_BM * QW_BK;                    // bytes of one A or B stage
constexpr int QW_LDC = QW_BN + 8;                         // Cs row, int32 words
constexpr int QW_SMEM = QW_STAGES * 2 * QW_TILE + 4 * QW_BM * QW_LDC + 1024;  // + atoms
static_assert(QW_BM == QW_BN && QW_SMEM <= MAX_SMEM_BYTES, "wgmma tile");

// Named barriers (0 is __syncthreads, which this kernel never uses): the
// MMA warpgroups' ring, and Cs empty / full between them and the epilogue.
constexpr int QW_BAR_RING = 1, QW_BAR_EMPTY = 2, QW_BAR_FULL = 3;

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// D [64 x 128] += A [64 x 32] x B [32 x 128], both by descriptor, int8 in,
// int32 accumulate; the warpgroup's 128 threads issue it together.
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t desc_a,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// Keep the compiler from moving accumulator reads or writes across a batch
// in flight (gemm_tc.cuh's wgmma_fence_acc for int32 sums).
__device__ __forceinline__ void wgmma_fence_acc_s32(int (&acc)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(acc[i])::"memory");
}

// One stage, by the MMA warpgroups: rows [row0, +128) of A and [col0, +128)
// of B at k bytes [k0, +128), swizzled; rows past M or N and k past K read
// as zero.  K a multiple of 16, A and B 16-byte aligned.
__device__ __forceinline__ void qw_load(int8_t* as, int8_t* bs, const int8_t* A,
                                        const int8_t* B, int M, int N, int K, int row0,
                                        int col0, int k0) {
  constexpr int CHUNKS = QW_BM * (QW_BK / 16);            // 16-byte copies an operand
  for (int i = threadIdx.x; i < 2 * CHUNKS; i += QW_MMA_THREADS) {
    const bool is_b = i >= CHUNKS;
    const int rest = is_b ? i - CHUNKS : i, r = rest / (QW_BK / 16), c = rest % (QW_BK / 16);
    const int g = (is_b ? col0 : row0) + r, k = k0 + c * 16;
    const bool ok = g < (is_b ? N : M) && k < K;
    const int8_t* src = is_b ? B : A;
    cp_async16((is_b ? bs : as) + r * QW_BK + ((c ^ (r & 7)) << 4),
               ok ? src + (long long)g * K + k : src, ok);
  }
}

// One output tile's sums, by the MMA warpgroups, into acc.
__device__ __forceinline__ void qw_mma_tile(int (&acc)[64], int8_t* As, int8_t* Bs,
                                            const int8_t* A, const int8_t* B, int M, int N,
                                            int K, int row0, int col0) {
  const int wg = threadIdx.x / 128, ktiles = (K + QW_BK - 1) / QW_BK;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  wgmma_fence_acc_s32(acc);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (s < ktiles)
      qw_load(As + s * QW_TILE, Bs + s * QW_TILE, A, B, M, N, K, row0, col0, s * QW_BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<1>();
    // this thread's copies visible to the wgmma (async) proxy, then to both
    // warpgroups; stage (kt + 2) % 4 was read by tile kt - 2's batch,
    // retired by both warpgroups' wait_group 1 before this barrier
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(QW_BAR_RING, QW_MMA_THREADS);
    if (kt + 2 < ktiles) {
      const int ns = (kt + 2) % QW_STAGES;
      qw_load(As + ns * QW_TILE, Bs + ns * QW_TILE, A, B, M, N, K, row0, col0,
              (kt + 2) * QW_BK);
    }
    cp_async_commit();
    const int s = kt % QW_STAGES;
    const int8_t* as = As + s * QW_TILE + wg * 64 * QW_BK;
    const int8_t* bs = Bs + s * QW_TILE;
    wgmma_fence_acc_s32(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int q = 0; q < QW_BK / 32; ++q)   // k step q: 32 bytes into each 128-byte row
      wgmma_s8_n128(acc, wgmma_desc_sw128(as + q * 32), wgmma_desc_sw128(bs + q * 32));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    wgmma_fence_acc_s32(acc);
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    wgmma_fence_acc_s32(acc);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wgmma_fence_acc_s32(acc);
  cp_async_wait<0>();
}

// Four outputs stored at once: 16 bytes of float, 8 of bf16.
__device__ __forceinline__ void q_store4(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

__device__ __forceinline__ void q_store4(bf16* p, const float (&f)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(f[2], f[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&a), *reinterpret_cast<const unsigned*>(&b));
}

// One staged row of a tile, by one epilogue warp: columns c = col0 + 4 lane
// .. + 3 of row r (< M) from its sums cs, the columns' scales and biases
// sbv, bv already in registers; 16-byte stores (8-byte at bf16) where the
// four are in the matrix and N is a multiple of 4.
template <int EPI, typename T>
__device__ __forceinline__ void qw_epilogue_row(const int* cs, int r, int c, int N,
                                                const float* __restrict__ sa,
                                                const float (&sbv)[4], const float (&bv)[4],
                                                const T* __restrict__ resid,
                                                T* __restrict__ C, int* __restrict__ Ci) {
  const int lane = threadIdx.x % 32;
  const int4 v = *reinterpret_cast<const int4*>(cs + 4 * lane);
  const int vs[4] = {v.x, v.y, v.z, v.w};
  const long long o = (long long)r * N + c;
  const bool four = c + 3 < N && N % 4 == 0;
  if (EPI == QEPI_I32) {
    if (four) {
      *reinterpret_cast<int4*>(Ci + o) = v;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < N) Ci[o + e] = vs[e];
    }
    return;
  }
  const float sa_r = sa[r];
  float f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = c + e < N ? q_epilogue<EPI, T>(vs[e], sa_r, sbv[e], bv[e], resid, o + e) : 0.f;
  if (four) {
    q_store4(C + o, f);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < N) C[o + e] = q_t<T>(f[e]);
  }
}

// C [M, N] = epilogue(A [M, K] @ B [N, K]^T), tiles t = blockIdx.x, +
// gridDim.x, ...
template <int EPI, typename T>
__global__ void __launch_bounds__(QW_THREADS, 1)
qgemm_wgmma_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B, int M, int N,
                   int K, const float* __restrict__ sa, const T* __restrict__ sb,
                   const T* __restrict__ bias, const T* __restrict__ resid,
                   T* __restrict__ C, int* __restrict__ Ci) {
  extern __shared__ float4 qw_smem4[];
  int8_t* As = reinterpret_cast<int8_t*>(
      (reinterpret_cast<uintptr_t>(qw_smem4) + 1023) & ~uintptr_t(1023));   // [S][128][128]
  int8_t* Bs = As + QW_STAGES * QW_TILE;                                    // [S][128][128]
  int* Cs = reinterpret_cast<int*>(Bs + QW_STAGES * QW_TILE);               // [128][LDC]
  const int tiles_n = (N + QW_BN - 1) / QW_BN;
  const int tiles = tiles_n * ((M + QW_BM - 1) / QW_BM);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x < QW_MMA_THREADS) {
    const int g8 = lane / 4, t4 = lane % 4;
    const int wrow = (warp / 4) * 64 + (warp % 4) * 16;   // warpgroup's 64 rows, warp's 16
    int acc[64];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      qw_mma_tile(acc, As, Bs, A, B, M, N, K, (t / tiles_n) * QW_BM, (t % tiles_n) * QW_BN);
      // the epilogue has read the last tile out of Cs (and both MMA
      // warpgroups retired their batches, so the ring is free)
      named_sync(QW_BAR_EMPTY, QW_THREADS);
      // acc[4i + e]: row wrow + g8 (+8 for e >= 2), column 8i + 2 t4 + (e & 1)
#pragma unroll
      for (int i = 0; i < QW_BN / 8; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<int2*>(Cs + (wrow + g8 + 8 * half) * QW_LDC + 8 * i + 2 * t4) =
              make_int2(acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1]);
      named_arrive(QW_BAR_FULL, QW_THREADS);
    }
  } else {
    const int ew = warp - QW_MMA_THREADS / 32;            // epilogue warp, 0..7
    constexpr int EWARPS = (QW_THREADS - QW_MMA_THREADS) / 32;
    named_arrive(QW_BAR_EMPTY, QW_THREADS);              // Cs starts empty
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int row0 = (t / tiles_n) * QW_BM, c = (t % tiles_n) * QW_BN + 4 * lane;
      float sbv[4], bv[4];   // this lane's columns' scales and biases, for every row
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = EPI != QEPI_I32 && c + e < N;
        sbv[e] = in ? q_f(sb[c + e]) : 0.f;
        bv[e] = in ? q_f(bias[c + e]) : 0.f;
      }
      named_sync(QW_BAR_FULL, QW_THREADS);
      if (c < N) {
#pragma unroll 4
        for (int rl = ew; rl < QW_BM; rl += EWARPS)
          if (row0 + rl < M)
            qw_epilogue_row<EPI, T>(Cs + rl * QW_LDC, row0 + rl, c, N, sa, sbv, bv, resid, C,
                                    Ci);
      }
      if (t + (int)gridDim.x < tiles) named_arrive(QW_BAR_EMPTY, QW_THREADS);
    }
  }
}

// A product's plan, three host ints from ops/bert_ffn_cuda._plan_qgemm: wgmma
// (1: the persistent wgmma kernel over 128 x 128 tiles; 0: the 64 x 64
// mma.sync tiles), vec (K a multiple of 16, A and B 16-byte aligned: the
// wgmma tiles need it) and grid (the wgmma kernel's blocks: one an SM, at
// most one a tile).  Returns the launch's cudaError_t.
template <int EPI, typename T = float>
cudaError_t launch_qgemm(const int* plan, const int8_t* A, const int8_t* B, int M, int N,
                         int K, const float* sa, const T* sb, const T* bias, const T* resid,
                         T* C, int* Ci, cudaStream_t stream) {
  if (!plan[0])
    return launch_qgemm_sync<EPI, T>(A, B, M, N, K, sa, sb, bias, resid, C, Ci, stream);
  if (!plan[1] || plan[2] < 1) return cudaErrorInvalidValue;
  static unsigned long long smem_set = 0;
  const cudaError_t err =
      allow_smem_once((const void*)qgemm_wgmma_kernel<EPI, T>, &smem_set);
  if (err != cudaSuccess) return err;
  qgemm_wgmma_kernel<EPI, T><<<plan[2], QW_THREADS, QW_SMEM, stream>>>(A, B, M, N, K, sa, sb,
                                                                       bias, resid, C, Ci);
  return cudaGetLastError();
}

// K4 in the rows' storage type T (float; bf16 for its bf16 instance, the
// JAX kernel at bf16 rows: h1 and y rounded to bf16 after their dequant,
// g1 rounded before its codes, x + y rounded, the LN's output rounded).
template <typename T>
cudaError_t ffn_ln_q_fwd(const T* x, const int8_t* w1q, const T* w1s, const T* b1,
                         const int8_t* w2q, const T* w2s, const T* b2, const T* ln_g,
                         const T* ln_b, int8_t* xq, float* sx, T* hidden, int8_t* hq, float* sh,
                         T* resid_sum, T* out, int rows, int h, int ffn, float eps,
                         const int* plan, cudaStream_t stream) {
  cudaError_t err = launch_qrows(x, xq, sx, rows, h, false, stream);
  if (err != cudaSuccess) return err;
  err = launch_qgemm<QEPI_BIAS, T>(plan, xq, w1q, rows, ffn, h, sx, w1s, b1, nullptr, hidden,
                                   nullptr, stream);
  if (err != cudaSuccess) return err;
  err = launch_qrows(hidden, hq, sh, rows, ffn, true, stream);
  if (err != cudaSuccess) return err;
  err = launch_qgemm<QEPI_BIAS_RESIDUAL, T>(plan + 3, hq, w2q, rows, h, ffn, sh, w2s, b2, x,
                                            resid_sum, nullptr, stream);
  if (err != cudaSuccess) return err;
  layernorm_rows_kernel<T><<<rows, LN_THREADS, 0, stream>>>(resid_sum, ln_g, ln_b, out, h, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mmtr_qrows(const float* x, int8_t* xq, float* sx, int rows, int n,
                          void* stream_ptr) {
  return (int)launch_qrows(x, xq, sx, rows, n, false, (cudaStream_t)stream_ptr);
}

// plan: a product's three host ints from ops/bert_ffn_cuda._plan_qgemm.
extern "C" int mmtr_qgemm_i32(const int8_t* a, const int8_t* b, int* out, int M,
                              int N, int K, const int* plan, void* stream_ptr) {
  return (int)launch_qgemm<QEPI_I32, float>(plan, a, b, M, N, K, nullptr, nullptr, nullptr,
                                            nullptr, nullptr, out, (cudaStream_t)stream_ptr);
}

extern "C" int mmtr_qdot(const int8_t* xq, const float* sx, const int8_t* wq,
                         const float* ws, const float* bias, float* out, int M,
                         int N, int K, const int* plan, void* stream_ptr) {
  return (int)launch_qgemm<QEPI_BIAS, float>(plan, xq, wq, M, N, K, sx, ws, bias, nullptr,
                                             out, nullptr, (cudaStream_t)stream_ptr);
}

// plan: six host ints from ops/bert_ffn_cuda._plan_ffn_q, GEMM1's then
// GEMM2's.  hidden [rows, ffn]: GEMM1's dequantized sums h1 (g1 = gelu(h1)
// is formed, quantized and dropped in the quantize pass).
extern "C" int mmtr_ffn_ln_q_fwd(const float* x, const int8_t* w1q, const float* w1s,
                                 const float* b1, const int8_t* w2q, const float* w2s,
                                 const float* b2, const float* ln_g, const float* ln_b,
                                 int8_t* xq, float* sx, float* hidden, int8_t* hq,
                                 float* sh, float* resid_sum, float* out, int rows, int h,
                                 int ffn, float eps, const int* plan, void* stream_ptr) {
  return (int)ffn_ln_q_fwd(x, w1q, w1s, b1, w2q, w2s, b2, ln_g, ln_b, xq, sx, hidden, hq, sh,
                           resid_sum, out, rows, h, ffn, eps, plan,
                           (cudaStream_t)stream_ptr);
}

// The bf16 instances (the int8 BERT under the bf16 compute policy): rows,
// scales, biases and LN parameters bf16, codes int8 and row scales float32
// as above.  qrows reads bf16 rows as float32; qdot's output is rounded to
// bf16 (the JAX package's _qdot with out_dtype bf16); K4's hidden h1 and
// resid_sum are bf16, half the float32 instance's bytes.  The int8 products
// and their plans are the float32 instance's.
extern "C" int mmtr_qrows_bf16(const bf16* x, int8_t* xq, float* sx, int rows, int n,
                               void* stream_ptr) {
  return (int)launch_qrows(x, xq, sx, rows, n, false, (cudaStream_t)stream_ptr);
}

extern "C" int mmtr_qdot_bf16(const int8_t* xq, const float* sx, const int8_t* wq,
                              const bf16* ws, const bf16* bias, bf16* out, int M, int N, int K,
                              const int* plan, void* stream_ptr) {
  return (int)launch_qgemm<QEPI_BIAS, bf16>(plan, xq, wq, M, N, K, sx, ws, bias, nullptr, out,
                                            nullptr, (cudaStream_t)stream_ptr);
}

extern "C" int mmtr_ffn_ln_q_fwd_bf16(const bf16* x, const int8_t* w1q, const bf16* w1s,
                                      const bf16* b1, const int8_t* w2q, const bf16* w2s,
                                      const bf16* b2, const bf16* ln_g, const bf16* ln_b,
                                      int8_t* xq, float* sx, bf16* hidden, int8_t* hq,
                                      float* sh, bf16* resid_sum, bf16* out, int rows, int h,
                                      int ffn, float eps, const int* plan, void* stream_ptr) {
  return (int)ffn_ln_q_fwd(x, w1q, w1s, b1, w2q, w2s, b2, ln_g, ln_b, xq, sx, hidden, hq, sh,
                           resid_sum, out, rows, h, ffn, eps, plan,
                           (cudaStream_t)stream_ptr);
}
