// A float32-accurate GEMM on Hopper's tensor cores: C = epilogue(A @ B) in
// 3xTF32.
//
// Each operand element x is split into hi = tf32(x) and lo = tf32(x - hi)
// (10-bit mantissas each, 21 bits together), and every product is summed as
// lo*hi + hi*lo + hi*hi in float32 accumulators (TF32 MMAs, mma.sync or
// wgmma): what is dropped (lo*lo, and lo's cut) is ~2^-20 relative, at the
// tensor cores' rate (495 TFLOP/s TF32 dense on an H100 SXM; 165 TFLOP/s of
// float32 products at three MMAs each) rather than the CUDA cores' 67.  A
// single TF32 product (errors ~1e-3) would not do for the float32 kernels.
// The tensor cores add into their accumulators with truncation, so a sum
// drifts toward zero with the number of MMAs that feed one accumulator
// (K1b's reductions over 25,600-deep k ranges: 1.9e-4 of max |ref|,
// tools/k1b_trials.py; K3 after fc2's 3072: 6.0e-5 absolute, chip_smoke.py;
// both against 1e-4 allowed).  So the accumulators are promoted: added
// into float32 sums on the CUDA cores, rounded to nearest, and restarted
// every few k tiles, so no chain is longer than that: the reductions always
// (TN_PROMOTE), the other two kernels by a PROMOTE template parameter (k
// tiles, 0: never) that K3 sets; K1f (768 deep) keeps its instance and
// bits.
//
// Operands: A [M, K] row-major with row stride lda (>= K); B "gated"
// [G, K, hg] with N = G*hg columns, column c = g*hg + j read at B[g][k][j]
// (G = 1, hg = N: a plain [K, N]); bias [N]; C written gated too,
// C[g][m][j] for column c = g*hg + j (G = 1: a plain [M, N]).  So the GRU's
// input projection runs as ONE N = 3H product over x [T*B, in] into its
// [3, T*B, H] gate scratch, and x is read once.  With the template flag BT,
// B is given as [N, K] instead (a torch Linear weight as it is stored, read
// without a transpose; G = 1).  The epilogue is a template parameter
// (common.cuh's GemmEpilogue): + bias (K1f), + bias then exact-erf gelu
// (K3's fc1), + bias + a row-major resid [M, N] (K3's fc2), none (K1b's
// dx), or K9's three, which read EpiArgs (a mask, the act flag and the hash
// dropout's seed and rate) and the output's global row: EPI_K9_MID (bias,
// mask, act, dropout: K9's hidden activation), EPI_K9_OUT (bias, mask,
// dropout, + resid: the block's residual output) and EPI_K9_DP (the
// backward's dp, gated by the hidden activation's sign); with split-K each
// runs once, after the fixed-order sum.
//
// Two kernels for C = A @ B, picked by the caller's plan (ops/gemm_tc.py):
// wgmma over 128-row tiles of a plan-chosen width where the rows fill the
// card (below), and 64 x 64 mma.sync tiles for few rows.  Both: 32-deep k
// steps in a ring of shared-memory tiles fed by 16-byte cp.async (the
// mma.sync tiles fall back to 4-byte copies where a row is not 16-byte
// aligned: K, lda or hg not a multiple of 4), one barrier per k step,
// fragment loads free of bank conflicts (padded or swizzled rows); the
// column tile is the fastest grid axis, so the column tiles of one row tile
// run together and A comes from L2 after its first read.  A third kernel,
// gemm_tc_tn_kernel, reduces over very long K with A stored transposed
// (K1b's weight gradients x^T dg over T*B rows), split over K into partial
// planes that a fixed-order pass adds.
#pragma once

#include "common.cuh"

namespace {

constexpr int TC_BK = 32;
constexpr int TC_STAGES = 3;
constexpr int TC_LDA = TC_BK + 4;

// hi: x cut to TF32's 10-bit mantissa (toward zero) and lo: x - hi (exact
// in float32), in a mask and a float subtract: the conversion instruction
// (cvt.rna.tf32) issues at a quarter of their rate, and the split runs for
// every fragment (K1f's projection and K5b share it).  The TF32 MMAs read
// the top 19 bits of a 32-bit operand, so lo is cut there with no mask of
// its own.  |lo| < 2^-10 |x|, cut with an error below 2^-10 |lo|: 2^-20
// |x| at most, the size of the dropped lo*lo term.  Rounding hi to nearest
// (an integer add more) halves both and costs K5b ~4% (tools/k5b_trials.py).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Not volatile: the compiler may interleave independent MMAs.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// K9's dropout factor of output (r, c): keep where the position hash at
// (r, c / rep) is at least rate, else 0; 1 without dropout.
__device__ __forceinline__ float tc_drop(const EpiArgs& ex, int r, int c) {
  if (!ex.use_drop) return 1.f;
  return hash_uniform(ex.seed, r, ex.rep > 1 ? c / ex.rep : c) >= ex.rate ? ex.keep : 0.f;
}

// The epilogue of output (r, c) of an [M, N] product: acc (+ bias[c])
// (then gelu_erf) (then resid[r][c] + it); or K9's (common.cuh's
// GemmEpilogue).  T: the type of bias and resid, float, or bf16 for the
// bf16 products (gemm_bf16.cuh), which round where GemmEpilogue says; TB:
// the bias's, T's but for K9's bf16 instance, whose biases stay float32
// (its JAX kernel upcasts them) while resid (x, or the stored bf16 hidden
// activation) is bf16.  K9's epilogues never round: their bf16 outputs
// round once as they are stored.
template <int EPI, typename T = float, typename TB = T>
__device__ __forceinline__ float tc_epilogue(float acc, const TB* __restrict__ bias,
                                             const T* __restrict__ resid, int r, int c,
                                             int N, const EpiArgs& ex) {
  if constexpr (EPI == EPI_K9_MID) {
    const float u = (acc + bias[c]) * ex.mask[c];
    return (ex.act ? fmaxf(u, 0.f) : u) * tc_drop(ex, r, c);
  } else if constexpr (EPI == EPI_K9_OUT) {
    return ld_f(resid + (long long)r * N + c) +
           ((acc + bias[c]) * ex.mask[c]) * tc_drop(ex, r, c);
  } else if constexpr (EPI == EPI_K9_DP) {
    // relu' from the sign of EPI_K9_MID's output: d * relu(u) > 0 iff u > 0
    // where d > 0, and the factor is 0 anyway where d = 0 (rounding to bf16
    // keeps the sign)
    const bool dead = ex.act && !(ld_f(resid + (long long)r * N + c) > 0.f);
    return acc * (tc_drop(ex, r, c) * (dead ? 0.f : 1.f) * ex.mask[c]);
  } else {
    float v = acc;
    if (EPI != EPI_NONE) v += ld_f(bias + c);
    if (EPI != EPI_NONE && EPI != EPI_BIAS) v = as_t<T>(v);
    if (EPI == EPI_BIAS_GELU) v = gelu_erf(v);
    if (EPI == EPI_BIAS_RESIDUAL) v = as_t<T>(ld_f(resid + (long long)r * N + c) + v);
    return v;
  }
}

// An mma.sync block tile: BM x BN outputs, WARPS_M x WARPS_N warps each
// owning a (BM / WARPS_M) x (BN / WARPS_N) warp tile of m16 x n8 MMA tiles.
template <int BM_, int BN_, int WARPS_M_, int WARPS_N_>
struct TcTile {
  static constexpr int BM = BM_, BN = BN_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MT = WM / 16, NT = WN / 8;
  // LDB = BN + 8: 8 mod 32 for BN a multiple of 32 (24 for the reductions'
  // 80), so the B fragment loads, bank (LDB t4 + g8) mod 32, are
  // conflict-free
  static constexpr int LDB = BN + 8;
  static constexpr int SMEM = (int)sizeof(float) * TC_STAGES * (BM * TC_LDA + TC_BK * LDB);
};

// Stage one BM x 32 tile of A and one 32 x BN tile of B into the ring; BT:
// B [N, K], staged as [BN][TC_LDA] (k fastest, as A).
template <class Tile, bool VEC, bool BT = false>
__device__ __forceinline__ void gemm_tc_load(float* As, float* Bs, const float* A,
                                             const float* B, int M, int N, int K, int lda,
                                             int hg, int row0, int col0, int k0) {
  constexpr int BM = Tile::BM, BN = Tile::BN, T = Tile::THREADS, LDB = Tile::LDB;
  const int tid = threadIdx.x;
  if (VEC) {
    for (int i = tid; i < BM * (TC_BK / 4); i += T) {
      const int r = i / (TC_BK / 4), c = (i % (TC_BK / 4)) * 4;
      const bool ok = row0 + r < M && k0 + c < K;
      cp_async16(As + r * TC_LDA + c, ok ? A + (long long)(row0 + r) * lda + k0 + c : A, ok);
    }
    if constexpr (!BT) {
      for (int i = tid; i < TC_BK * (BN / 4); i += T) {
        const int kr = i / (BN / 4), c = (i % (BN / 4)) * 4;
        const int col = col0 + c, g = col / hg, j = col - g * hg;
        const bool ok = k0 + kr < K && col < N;
        cp_async16(Bs + kr * LDB + c, ok ? B + ((long long)g * K + k0 + kr) * hg + j : B, ok);
      }
    }
  } else {
    for (int i = tid; i < BM * TC_BK; i += T) {
      const int r = i / TC_BK, c = i % TC_BK;
      const bool ok = row0 + r < M && k0 + c < K;
      cp_async4(As + r * TC_LDA + c, ok ? A + (long long)(row0 + r) * lda + k0 + c : A, ok);
    }
    if constexpr (!BT) {
      for (int i = tid; i < TC_BK * BN; i += T) {
        const int kr = i / BN, c = i % BN;
        const int col = col0 + c, g = col / hg, j = col - g * hg;
        const bool ok = k0 + kr < K && col < N;
        cp_async4(Bs + kr * LDB + c, ok ? B + ((long long)g * K + k0 + kr) * hg + j : B, ok);
      }
    }
  }
  if constexpr (BT) {
    constexpr int CW = VEC ? 4 : 1;   // floats a copy
    for (int i = tid; i < BN * (TC_BK / CW); i += T) {
      const int n = i / (TC_BK / CW), c = (i % (TC_BK / CW)) * CW;
      const bool ok = col0 + n < N && k0 + c < K;
      const float* src = ok ? B + (long long)(col0 + n) * K + k0 + c : B;
      if (VEC) cp_async16(Bs + n * TC_LDA + c, src, ok);
      else cp_async4(Bs + n * TC_LDA + c, src, ok);
    }
  }
}

// Load the B fragments of k step kk (rows kk + t4, kk + t4 + 4 of a staged
// [32][LDB] tile; BT: columns kk + t4, kk + t4 + 4 of a staged [BN][TC_LDA]
// one, bank 4 g8 + t4, conflict-free) for NT n8 tiles at column n0, split
// into hi and lo.
template <int NT, int LDB, bool BT = false>
__device__ __forceinline__ void tc_b_frags(const float* bs, int kk, int n0, int g8, int t4,
                                           uint32_t (&bh)[NT][2], uint32_t (&bl)[NT][2]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if constexpr (BT) {
      const float* b = bs + (n0 + j * 8 + g8) * TC_LDA + kk + t4;
      split_tf32(b[0], bh[j][0], bl[j][0]);
      split_tf32(b[4], bh[j][1], bl[j][1]);
    } else {
      const float* b = bs + (kk + t4) * LDB + n0 + j * 8 + g8;
      split_tf32(b[0], bh[j][0], bl[j][0]);
      split_tf32(b[4 * LDB], bh[j][1], bl[j][1]);
    }
  }
}

// The small terms first, each pass over all MT x NT tiles, so that no MMA
// waits on the one just issued.
template <int MT, int NT>
__device__ __forceinline__ void tc_mma_3x(float (&acc)[MT][NT][4], const uint32_t (&ah)[MT][4],
                                          const uint32_t (&al)[MT][4],
                                          const uint32_t (&bh)[NT][2],
                                          const uint32_t (&bl)[NT][2]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], al[i], bh[j]);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ah[i], bl[j]);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ah[i], bh[j]);
}

// sum += acc, acc = 0: the MMA accumulators promoted into float32 sums.
template <int MT, int NT>
__device__ __forceinline__ void tc_promote(float (&sum)[MT][NT][4], float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sum[i][j][e] += acc[i][j][e];
        acc[i][j][e] = 0.f;
      }
}

// VEC: K, lda and hg multiples of 4 and A, B 16-byte aligned.  Split-K:
// block z sums k tiles [z * kps, (z + 1) * kps) into plane z of C (M * N
// words a plane, no epilogue) when gridDim.z > 1, for gemm_splitk_sum (or
// the caller's own pass) to add in order.  BT: B [N, K] (hg = N).
template <class Tile, bool VEC, int EPI, int PROMOTE, bool BT = false>
__global__ void __launch_bounds__(Tile::THREADS)
gemm_tc_kernel(const float* __restrict__ A, const float* __restrict__ B,
               const float* __restrict__ bias, const float* __restrict__ resid,
               float* __restrict__ C, int M, int N, int K, int lda, int hg, int kps,
               EpiArgs ex) {
  constexpr int BM = Tile::BM, BN = Tile::BN, LDB = Tile::LDB;
  constexpr int MT = Tile::MT, NT = Tile::NT;
  static_assert(!BT || Tile::BN * TC_LDA <= TC_BK * LDB, "a B^T stage fits B's slot");
  extern __shared__ float4 tc_smem4[];
  float* As = reinterpret_cast<float*>(tc_smem4);    // [STAGES][BM][LDA]
  float* Bs = As + TC_STAGES * BM * TC_LDA;          // [STAGES][BK][LDB]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;            // mma group / thread in group
  const int wm0 = (warp / Tile::WARPS_N) * Tile::WM, wn0 = (warp % Tile::WARPS_N) * Tile::WN;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int kt0 = blockIdx.z * kps;
  const int ktiles = min(kps, (K + TC_BK - 1) / TC_BK - kt0);

  float acc[MT][NT][4], sum[PROMOTE ? MT : 1][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0.f;
        if (PROMOTE) sum[i][j][e] = 0.f;
      }

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < ktiles)
      gemm_tc_load<Tile, VEC, BT>(As + s * BM * TC_LDA, Bs + s * TC_BK * LDB, A, B, M, N, K,
                                  lda, hg, row0, col0, (kt0 + s) * TC_BK);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();   // tile kt landed for all; stage (kt-1) % STAGES is free
    const int nk = kt + TC_STAGES - 1;
    if (nk < ktiles) {
      const int s = nk % TC_STAGES;
      gemm_tc_load<Tile, VEC, BT>(As + s * BM * TC_LDA, Bs + s * TC_BK * LDB, A, B, M, N, K,
                                  lda, hg, row0, col0, (kt0 + nk) * TC_BK);
    }
    cp_async_commit();

    const float* as = As + (kt % TC_STAGES) * BM * TC_LDA;
    const float* bs = Bs + (kt % TC_STAGES) * TC_BK * LDB;
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 8) {
      uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* a = as + (wm0 + i * 16 + g8) * TC_LDA + kk + t4;
        split_tf32(a[0], ah[i][0], al[i][0]);
        split_tf32(a[8 * TC_LDA], ah[i][1], al[i][1]);
        split_tf32(a[4], ah[i][2], al[i][2]);
        split_tf32(a[8 * TC_LDA + 4], ah[i][3], al[i][3]);
      }
      tc_b_frags<NT, LDB, BT>(bs, kk, wn0, g8, t4, bh, bl);
      tc_mma_3x<MT, NT>(acc, ah, al, bh, bl);
    }
    if constexpr (PROMOTE > 0) {
      if (kt % PROMOTE == PROMOTE - 1 || kt == ktiles - 1) tc_promote<MT, NT>(sum, acc);
    }
  }
  cp_async_wait<0>();

  // c0/c1: row g8, columns 2*t4 and 2*t4+1; c2/c3: row g8 + 8
  const bool split = gridDim.z > 1;
  C += split ? (long long)blockIdx.z * M * N : 0;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + wm0 + i * 16 + g8 + (e >= 2 ? 8 : 0);
        const int c = col0 + wn0 + j * 8 + 2 * t4 + (e & 1);
        if (r < M && c < N) {
          const int g = c / hg, jj = c - g * hg;
          const float v = PROMOTE ? sum[PROMOTE ? i : 0][j][e] : acc[i][j][e];
          C[((long long)g * M + r) * hg + jj] =
              split ? v : tc_epilogue<EPI>(v, bias, resid, r, c, N, ex);
        }
      }
}

// C[i] = epilogue(P[0][i] + ... + P[splits-1][i]), the planes added in that
// order (a rerun gives the same bits), over the gated [N/hg, M, hg] layout;
// T, O and TB: the bf16 products' resid, output and bias types.
template <int EPI, typename T = float, typename O = float, typename TB = T>
__global__ void gemm_splitk_sum(const float* __restrict__ P, const TB* __restrict__ bias,
                                const T* __restrict__ resid, O* __restrict__ C,
                                long long total, int M, int N, int hg, int splits,
                                EpiArgs ex) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float v = 0.f;
  for (int z = 0; z < splits; ++z) v += P[z * total + i];
  const int g = (int)(i / ((long long)M * hg)), j = (int)(i % hg);
  const int r = (int)((i / hg) % M);
  st_f(C + i, tc_epilogue<EPI, T, TB>(v, bias, resid, r, g * hg + j, N, ex));
}

// Few rows: 64 x 64 mma.sync tiles (4 warps of 32 x 32), where more blocks
// matter more than the tensor cores' rate; split over K into `splits`
// partial planes (scratch, splits * M * N floats) and, unless the caller
// adds them itself (`sum` false), summed by a second launch that runs the
// epilogue, where the tiles alone would leave the card idle: at the serving
// batch of 1 a block's 24 serial k tiles, not its MMAs, set the time.
using TcSmall = TcTile<64, 64, 2, 2>;

template <bool VEC, int EPI, int PROMOTE, bool BT>
cudaError_t launch_gemm_tc_small(const float* A, int lda, const float* B, const float* bias,
                                 const float* resid, float* C, int M, int N, int K, int hg,
                                 int splits, float* partials, bool sum, const EpiArgs& ex,
                                 cudaStream_t stream) {
  static unsigned long long smem_set = 0;
  cudaError_t err =
      allow_smem_once((const void*)gemm_tc_kernel<TcSmall, VEC, EPI, PROMOTE, BT>, &smem_set);
  if (err != cudaSuccess) return err;
  const int ktiles = (K + TC_BK - 1) / TC_BK;
  const int kps = (ktiles + splits - 1) / splits;
  const dim3 grid((N + TcSmall::BN - 1) / TcSmall::BN, (M + TcSmall::BM - 1) / TcSmall::BM,
                  splits);
  gemm_tc_kernel<TcSmall, VEC, EPI, PROMOTE, BT><<<grid, TcSmall::THREADS, TcSmall::SMEM,
                                                   stream>>>(
      A, B, bias, resid, splits > 1 ? partials : C, M, N, K, lda, hg, kps, ex);
  if (splits > 1 && sum) {
    const long long total = (long long)M * N;
    gemm_splitk_sum<EPI><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        partials, bias, resid, C, total, M, N, hg, splits, ex);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Many rows: warpgroup MMA (wgmma).  A block of two warpgroups computes a
// 128 x BN tile, BN a template parameter the plan picks per product (152 =
// 8 * 19 for the GRU's N = 3H = 300: two tiles, 1% to spare; 128 for the
// BERT FFN's 3072 and 768; 104 for K1b's dx at N = in = 200), 32-deep k
// steps in a 4-stage cp.async ring loaded two tiles ahead.  A comes from
// shared memory into registers in the mma.sync fragment layout and is split
// there; B is split once per call into TF32 hi and lo planes, K-major (wgmma
// takes TF32 operands K-major only), by gemm_tc_presplit.  Both are staged
// in 128-byte-swizzled rows (row r's 16-byte chunk c at c ^ (r % 8),
// 1024-byte atoms), which the B descriptors and the A fragment loads read
// without bank conflicts.  Per k step of 8: wgmma(A_lo, B_hi), wgmma(A_hi,
// B_lo), wgmma(A_hi, B_hi); a k tile's 12 form one batch, and one batch
// stays in flight while the next tile's A is split (its registers
// double-buffered, the k loop unrolled by two), so the stage a batch reads
// is refilled two tiles later.  A thread holds BN / 2 accumulators and 64
// A-split registers: 140 at BN = 152.
constexpr int WG_BM = 128;
constexpr int WG_THREADS = 256;
constexpr int WG_STAGES = 4;
constexpr int WG_APLANE = WG_BM * TC_BK;                 // floats of one A stage

template <int BN>
struct WgTile {
  static constexpr int BPLANE = BN * TC_BK;              // 32-bit words of one B plane
  static constexpr int SMEM = (int)sizeof(float) * WG_STAGES * (WG_APLANE + 2 * BPLANE) +
                              1024;                      // + alignment of the swizzle atoms
  static_assert(BN % 8 == 0 && SMEM <= MAX_SMEM_BYTES, "wgmma tile");
};

// D [64 x N] += A [64 x 8] (registers, the mma.sync A fragment layout
// per warp) x B [8 x N] (shared memory, by descriptor), TF32 in, float32
// accumulate; the warpgroup's 128 threads issue it together.  One
// specialization per column-tile width the launch plans pick.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_tf32<104>(float (&d)[52], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51 "
      "}, "
      "{%52, %53, %54, %55}, %56, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<152>(float (&d)[76], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %81, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n152k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75 "
      "}, "
      "{%76, %77, %78, %79}, %80, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


// A shared-memory matrix descriptor: 128-byte swizzle, K-major; the 8-row
// groups 1024 bytes apart.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* smem_ptr) {
  return ((uint64_t)(smem_addr(smem_ptr) & 0x3FFFFu) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// B (gated [G][K][hg]; BT: [N][K] as it is) -> hi, lo [N][K] TF32 planes,
// K-major.
template <bool BT>
__global__ void gemm_tc_presplit(const float* __restrict__ B, uint32_t* __restrict__ hi,
                                 uint32_t* __restrict__ lo, int N, int K, int hg) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)N * K) return;
  uint32_t h, l;
  if constexpr (BT) {
    split_tf32(B[i], h, l);
  } else {
    const int n = (int)(i / K), k = (int)(i - (long long)n * K);
    const int g = n / hg, j = n - g * hg;
    split_tf32(B[((long long)g * K + k) * hg + j], h, l);
  }
  hi[i] = h;
  lo[i] = l;
}

// Keep the compiler from moving accumulator reads or writes across a wgmma
// batch still in flight (ptxas would otherwise serialize the batches).
template <int NA>
__device__ __forceinline__ void wgmma_fence_acc(float (&acc)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// Word k of row r in a 128-byte-swizzled [rows][32] stage.
__device__ __forceinline__ int sw128(int r, int k) {
  return r * TC_BK + ((((k >> 2) ^ (r & 7))) << 2) + (k & 3);
}

// One stage: the A tile [128 r][32 k] and the two B planes' [BN n][32 k]
// tiles, swizzled; rows past M or N and k past K read as zero.
template <int BN>
__device__ __forceinline__ void wgmma_load(float* as, uint32_t* bs, const float* A,
                                           const uint32_t* Bhi, const uint32_t* Blo, int M,
                                           int N, int K, int lda, int row0, int col0, int k0) {
  for (int i = threadIdx.x; i < WG_BM * (TC_BK / 4); i += WG_THREADS) {
    const int r = i / (TC_BK / 4), c = i % (TC_BK / 4);
    const bool ok = row0 + r < M && k0 + c * 4 < K;
    cp_async16(as + sw128(r, c * 4), ok ? A + (long long)(row0 + r) * lda + k0 + c * 4 : A,
               ok);
  }
  for (int i = threadIdx.x; i < 2 * BN * (TC_BK / 4); i += WG_THREADS) {
    const int plane = i / (BN * (TC_BK / 4)), rest = i - plane * (BN * (TC_BK / 4));
    const int n = rest / (TC_BK / 4), c = rest % (TC_BK / 4);
    const bool ok = col0 + n < N && k0 + c * 4 < K;
    const uint32_t* src = plane ? Blo : Bhi;
    cp_async16(bs + plane * WgTile<BN>::BPLANE + sw128(n, c * 4),
               ok ? src + (long long)(col0 + n) * K + k0 + c * 4 : src, ok);
  }
}

// Wait for k tile kt, start loading tile kt + 2 (its stage was read by the
// batch of tile kt - 2, retired by the last wait_group 1 in both
// warpgroups before this barrier), split tile kt's A into ah / al, and
// issue its batch, leaving one batch in flight.
template <int BN>
__device__ __forceinline__ void wgmma_k_tile(float (&acc)[BN / 2], uint32_t (&ah)[4][4],
                                             uint32_t (&al)[4][4], float* As, uint32_t* Bs,
                                             const float* A, const uint32_t* Bhi,
                                             const uint32_t* Blo, int M, int N, int K, int lda,
                                             int row0, int col0, int kt, int ktiles,
                                             int wrow) {
  constexpr int BPLANE = WgTile<BN>::BPLANE;
  cp_async_wait<1>();
  // this thread's copies visible to the wgmma (async) proxy, then to all
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (kt + 2 < ktiles) {
    const int s = (kt + 2) % WG_STAGES;
    wgmma_load<BN>(As + s * WG_APLANE, Bs + s * 2 * BPLANE, A, Bhi, Blo, M, N, K, lda, row0,
                   col0, (kt + 2) * TC_BK);
  }
  cp_async_commit();
  const int s = kt % WG_STAGES, lane = threadIdx.x % 32;
  const int r = wrow + lane / 4, t4 = lane % 4;
  const float* as = As + s * WG_APLANE;
  const uint32_t* bh = Bs + s * 2 * BPLANE;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    split_tf32(as[sw128(r, q * 8 + t4)], ah[q][0], al[q][0]);
    split_tf32(as[sw128(r + 8, q * 8 + t4)], ah[q][1], al[q][1]);
    split_tf32(as[sw128(r, q * 8 + t4 + 4)], ah[q][2], al[q][2]);
    split_tf32(as[sw128(r + 8, q * 8 + t4 + 4)], ah[q][3], al[q][3]);
  }
  wgmma_fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int q = 0; q < 4; ++q) {   // k step q: 32 bytes into each 128-byte row
    const uint64_t dh = wgmma_desc_sw128(bh + q * 8);
    const uint64_t dl = wgmma_desc_sw128(bh + BPLANE + q * 8);
    wgmma_tf32<BN>(acc, al[q], dh);
    wgmma_tf32<BN>(acc, ah[q], dl);
    wgmma_tf32<BN>(acc, ah[q], dh);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  wgmma_fence_acc(acc);
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  wgmma_fence_acc(acc);
}

// K, lda and hg multiples of 4, A 16-byte aligned; Bhi / Blo from
// gemm_tc_presplit.  PROMOTE (even, or 0): every PROMOTE k tiles the
// batches in flight are retired and the accumulators promoted.
template <int BN, int EPI, int PROMOTE>
__global__ void __launch_bounds__(WG_THREADS)
gemm_wgmma_kernel(const float* __restrict__ A, const uint32_t* __restrict__ Bhi,
                  const uint32_t* __restrict__ Blo, const float* __restrict__ bias,
                  const float* __restrict__ resid, float* __restrict__ C, int M, int N, int K,
                  int lda, int hg, EpiArgs ex) {
  extern __shared__ float4 wg_smem4[];
  uint32_t* Bs = reinterpret_cast<uint32_t*>(
      (reinterpret_cast<uintptr_t>(wg_smem4) + 1023) & ~uintptr_t(1023));   // [S][2][plane]
  float* As = reinterpret_cast<float*>(Bs + WG_STAGES * 2 * WgTile<BN>::BPLANE);  // [S][128][32]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int wrow = (warp / 4) * 64 + (warp % 4) * 16;   // warpgroup's 64 rows, warp's 16
  const int row0 = blockIdx.y * WG_BM, col0 = blockIdx.x * BN;
  // an even number of k tiles (an odd last one reads zeros), so the loop
  // below, unrolled by two for the two A register buffers, has no tail
  const int ktiles = ((K + TC_BK - 1) / TC_BK + 1) & ~1;

  float acc[BN / 2], sum[PROMOTE ? BN / 2 : 1];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    acc[i] = 0.f;
    if (PROMOTE) sum[i] = 0.f;
  }
  wgmma_fence_acc(acc);
  uint32_t ah0[4][4], al0[4][4], ah1[4][4], al1[4][4];

#pragma unroll
  for (int s = 0; s < 2; ++s) {
    wgmma_load<BN>(As + s * WG_APLANE, Bs + s * 2 * WgTile<BN>::BPLANE, A, Bhi, Blo, M, N, K,
                   lda, row0, col0, s * TC_BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; kt += 2) {
    wgmma_k_tile<BN>(acc, ah0, al0, As, Bs, A, Bhi, Blo, M, N, K, lda, row0, col0, kt, ktiles,
                     wrow);
    wgmma_k_tile<BN>(acc, ah1, al1, As, Bs, A, Bhi, Blo, M, N, K, lda, row0, col0, kt + 1,
                     ktiles, wrow);
    if constexpr (PROMOTE > 0) {
      if ((kt + 2) % PROMOTE == 0 || kt + 2 >= ktiles) {
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        wgmma_fence_acc(acc);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          sum[i] += acc[i];
          acc[i] = 0.f;
        }
        wgmma_fence_acc(acc);
      }
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wgmma_fence_acc(acc);
  cp_async_wait<0>();

  // acc[4i + e]: row g8 (+8 for e >= 2), column 8i + 2 t4 + (e & 1)
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + wrow + g8 + (e >= 2 ? 8 : 0);
      const int c = col0 + i * 8 + 2 * t4 + (e & 1);
      if (r < M && c < N) {
        const int g = c / hg, jj = c - g * hg;
        C[((long long)g * M + r) * hg + jj] = tc_epilogue<EPI>(
            PROMOTE ? sum[PROMOTE ? i * 4 + e : 0] : acc[i * 4 + e], bias, resid, r, c, N,
            ex);
      }
    }
}

template <int BN, int EPI, int PROMOTE, bool BT>
cudaError_t launch_gemm_wgmma(const float* A, int lda, const float* B, const float* bias,
                              const float* resid, float* C, int M, int N, int K, int hg,
                              uint32_t* planes, const EpiArgs& ex, cudaStream_t stream) {
  uint32_t* hi = planes;
  uint32_t* lo = planes + (long long)N * K;
  const long long nk = (long long)N * K;
  gemm_tc_presplit<BT><<<(unsigned)((nk + 255) / 256), 256, 0, stream>>>(B, hi, lo, N, K, hg);
  static unsigned long long smem_set = 0;
  cudaError_t err =
      allow_smem_once((const void*)gemm_wgmma_kernel<BN, EPI, PROMOTE>, &smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + WG_BM - 1) / WG_BM);
  gemm_wgmma_kernel<BN, EPI, PROMOTE><<<grid, WG_THREADS, WgTile<BN>::SMEM, stream>>>(
      A, hi, lo, bias, resid, C, M, N, K, lda, hg, ex);
  return cudaGetLastError();
}

// A product's launch plan, four host ints from ops/gemm_tc.plan_product:
// wgmma (1: the wgmma tiles, B's TF32 planes in `scratch`, 2 * N * K words;
// 0: the 64 x 64 mma.sync tiles), vec (K, lda and hg multiples of 4, A and
// B 16-byte aligned), splits (the mma.sync tiles' k ranges; > 1: splits * M
// * N floats of `scratch`) and bn (the wgmma column tile: 104, 128 or 152).
struct TcPlan {
  int wgmma, vec, splits, bn;
};

inline TcPlan tc_plan(const int* p) { return TcPlan{p[0], p[1], p[2], p[3]}; }

// C (gated [N/hg, M, hg]) = epilogue(A [M, K] (row stride lda) @ B (gated
// [N/hg, K, hg]; BT: [N, K], hg = N)) in 3xTF32, by the caller's plan.
// With `sum` false and the plan's mma.sync splits > 1, only the partial
// planes are written (to scratch), for the caller's own pass to add.
// PROMOTE: gemm_tc_kernel's and gemm_wgmma_kernel's (k tiles, even; 0:
// never).  `ex`: the K9 epilogues' arguments.  Returns the launches'
// cudaError_t.
template <int EPI, int PROMOTE = 0, bool BT = false>
cudaError_t launch_gemm_tc(const TcPlan& p, const float* A, int lda, const float* B,
                           const float* bias, const float* resid, float* C, int M, int N,
                           int K, int hg, void* scratch, cudaStream_t stream, bool sum = true,
                           const EpiArgs& ex = EpiArgs{}) {
  if (p.wgmma) {
    if (!p.vec || scratch == nullptr) return cudaErrorInvalidValue;
    uint32_t* planes = static_cast<uint32_t*>(scratch);
    switch (p.bn) {
      case 104:
        return launch_gemm_wgmma<104, EPI, PROMOTE, BT>(A, lda, B, bias, resid, C, M, N, K,
                                                        hg, planes, ex, stream);
      case 128:
        return launch_gemm_wgmma<128, EPI, PROMOTE, BT>(A, lda, B, bias, resid, C, M, N, K,
                                                        hg, planes, ex, stream);
      case 152:   // promoted, a thread's BN / 2 sums more spill at 152
        if constexpr (PROMOTE == 0)
          return launch_gemm_wgmma<152, EPI, 0, BT>(A, lda, B, bias, resid, C, M, N, K, hg,
                                                    planes, ex, stream);
        else
          return cudaErrorInvalidValue;
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (p.splits < 1 || (p.splits > 1 && scratch == nullptr)) return cudaErrorInvalidValue;
  float* partials = static_cast<float*>(scratch);
  return p.vec ? launch_gemm_tc_small<true, EPI, PROMOTE, BT>(A, lda, B, bias, resid, C, M, N,
                                                              K, hg, p.splits, partials, sum,
                                                              ex, stream)
               : launch_gemm_tc_small<false, EPI, PROMOTE, BT>(A, lda, B, bias, resid, C, M,
                                                               N, K, hg, p.splits, partials,
                                                               sum, ex, stream);
}

// ---------------------------------------------------------------------------
// Reductions over very long K with A stored transposed: plane z of
//   C[m][n] = sum over k in z's k tiles of At(k, m) * B(k, n),
// At(k, m) = A[(k + shift) * lda + m] for m < Mdata (zero where k + shift
// falls outside [0, K): a time-shifted view of a [T*B, H] state needs no
// copy), 1 for m == ones_row (so that row of C is B's column sums: K1b's
// bias gradients ride on a product), 0 beyond; B(k, n) = B[k * ldb + n].
// C is [M, N] row-major, M = Mdata (+ 1 with a ones row), plane z at C + z
// * stride_c; a fixed-order pass (common.cuh's splitk_reduce_kernel) adds
// the planes, so a rerun gives the same bits and no float atomics are used.
// TF32 wgmma reads shared-memory operands K-major only, and here both
// operands are stored with K outermost, so this runs on mma.sync tiles,
// whose fragments load lane by lane from any staged layout: A is staged
// as [32 k][BM m] in rows of 136 floats (8 mod 32, so the fragment loads,
// bank 8 t4 + g8, are conflict-free), B as the other kernels' [32 k][BN].
// 128 x 80 block tiles (N = 300 in four, 400 in five), four warps of 64 x
// 40: a k step of 8 loads 26 fragment words a lane for 60 MMAs.  Two
// blocks an SM (86 KB of shared memory each).  A k range runs thousands of
// k steps, so the MMA accumulators are promoted (see the top of this file)
// every TN_PROMOTE = 4 k tiles: no chain is longer than 128 k.
using TcTn = TcTile<128, 80, 2, 2>;
constexpr int TN_PROMOTE = 4;
constexpr int TN_LDA = TcTn::BM + 8;
constexpr int TN_SMEM = (int)sizeof(float) * TC_STAGES * TC_BK * (TN_LDA + TcTn::LDB);

// Stage the 32 x 128 tile of At and the 32 x 80 tile of B at k0.  VEC: Mdata,
// N, lda and ldb multiples of 4, A and B 16-byte aligned.
template <bool VEC>
__device__ __forceinline__ void gemm_tn_load(float* As, float* Bs, const float* A,
                                             const float* B, int Mdata, int ones_row, int N,
                                             int K, int lda, int ldb, int shift, int row0,
                                             int col0, int k0) {
  constexpr int BM = TcTn::BM, BN = TcTn::BN, T = TcTn::THREADS, LDB = TcTn::LDB;
  const int tid = threadIdx.x;
  constexpr int CW = VEC ? 4 : 1;   // floats a copy
  for (int i = tid; i < TC_BK * (BM / CW); i += T) {
    const int kr = i / (BM / CW), m = (i % (BM / CW)) * CW;
    const int k = k0 + kr, ak = k + shift, gm = row0 + m;
    float* dst = As + kr * TN_LDA + m;
    if (gm < Mdata) {
      const bool ok = k < K && ak >= 0 && ak < K;
      const float* src = ok ? A + (long long)ak * lda + gm : A;
      if (VEC) cp_async16(dst, src, ok);
      else cp_async4(dst, src, ok);
    } else {
#pragma unroll
      for (int q = 0; q < CW; ++q) dst[q] = gm + q == ones_row && k < K ? 1.f : 0.f;
    }
  }
  for (int i = tid; i < TC_BK * (BN / CW); i += T) {
    const int kr = i / (BN / CW), c = (i % (BN / CW)) * CW;
    const bool ok = k0 + kr < K && col0 + c < N;
    const float* src = ok ? B + (long long)(k0 + kr) * ldb + col0 + c : B;
    if (VEC) cp_async16(Bs + kr * LDB + c, src, ok);
    else cp_async4(Bs + kr * LDB + c, src, ok);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(TcTn::THREADS)
gemm_tc_tn_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  float* __restrict__ C, int Mdata, int ones_row, int N, int K, int lda,
                  int ldb, int shift, int kps, long long stride_c) {
  constexpr int BM = TcTn::BM, BN = TcTn::BN, LDB = TcTn::LDB;
  constexpr int MT = TcTn::MT, NT = TcTn::NT;
  extern __shared__ float4 tn_smem4[];
  float* As = reinterpret_cast<float*>(tn_smem4);    // [STAGES][BK][TN_LDA]
  float* Bs = As + TC_STAGES * TC_BK * TN_LDA;       // [STAGES][BK][LDB]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int wm0 = (warp / TcTn::WARPS_N) * TcTn::WM, wn0 = (warp % TcTn::WARPS_N) * TcTn::WN;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int M = Mdata + (ones_row >= 0 ? 1 : 0);
  const int kt0 = blockIdx.z * kps;
  const int ktiles = min(kps, (K + TC_BK - 1) / TC_BK - kt0);

  float acc[MT][NT][4], sum[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = sum[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < ktiles)
      gemm_tn_load<VEC>(As + s * TC_BK * TN_LDA, Bs + s * TC_BK * LDB, A, B, Mdata, ones_row,
                        N, K, lda, ldb, shift, row0, col0, (kt0 + s) * TC_BK);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();   // tile kt landed for all; stage (kt-1) % STAGES is free
    const int nk = kt + TC_STAGES - 1;
    if (nk < ktiles) {
      const int s = nk % TC_STAGES;
      gemm_tn_load<VEC>(As + s * TC_BK * TN_LDA, Bs + s * TC_BK * LDB, A, B, Mdata, ones_row,
                        N, K, lda, ldb, shift, row0, col0, (kt0 + nk) * TC_BK);
    }
    cp_async_commit();

    const float* as = As + (kt % TC_STAGES) * TC_BK * TN_LDA;
    const float* bs = Bs + (kt % TC_STAGES) * TC_BK * LDB;
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 8) {
      uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        // (row g8, k t4), (row g8 + 8, k t4), (row g8, k t4 + 4), (both)
        const float* a = as + (kk + t4) * TN_LDA + wm0 + i * 16 + g8;
        split_tf32(a[0], ah[i][0], al[i][0]);
        split_tf32(a[8], ah[i][1], al[i][1]);
        split_tf32(a[4 * TN_LDA], ah[i][2], al[i][2]);
        split_tf32(a[4 * TN_LDA + 8], ah[i][3], al[i][3]);
      }
      tc_b_frags<NT, LDB>(bs, kk, wn0, g8, t4, bh, bl);
      tc_mma_3x<MT, NT>(acc, ah, al, bh, bl);
    }
    if (kt % TN_PROMOTE == TN_PROMOTE - 1 || kt == ktiles - 1) tc_promote<MT, NT>(sum, acc);
  }
  cp_async_wait<0>();

  C += (long long)blockIdx.z * stride_c;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + wm0 + i * 16 + g8 + (e >= 2 ? 8 : 0);
        const int c = col0 + wn0 + j * 8 + 2 * t4 + (e & 1);
        if (r < M && c < N) C[(long long)r * N + c] = sum[i][j][e];
      }
}

// Plane z < splits of the reduction above, k tiles [z * kps, (z + 1) *
// kps); VEC as gemm_tn_load's.  Returns the launch's cudaError_t.
template <bool VEC>
cudaError_t launch_gemm_tc_tn(const float* A, int lda, int shift, int Mdata, int ones_row,
                              const float* B, int ldb, float* C, int N, int K, int splits,
                              int kps, long long stride_c, cudaStream_t stream) {
  static unsigned long long smem_set = 0;
  cudaError_t err = allow_smem_once((const void*)gemm_tc_tn_kernel<VEC>, &smem_set);
  if (err != cudaSuccess) return err;
  const int M = Mdata + (ones_row >= 0 ? 1 : 0);
  const dim3 grid((N + TcTn::BN - 1) / TcTn::BN, (M + TcTn::BM - 1) / TcTn::BM, splits);
  gemm_tc_tn_kernel<VEC><<<grid, TcTn::THREADS, TN_SMEM, stream>>>(
      A, B, C, Mdata, ones_row, N, K, lda, ldb, shift, kps, stride_c);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// out[row] = LN(resid[row] + (P[0][row] + ... + P[splits-1][row] + bias)):
// a product's split-K planes [splits][R][n] (launch_proj_resid_ln's)
// added in order, then the row LayerNorm as layernorm_rows_kernel computes
// it; one block a row, the row staged in shared memory (n floats).
__global__ void __launch_bounds__(LN_THREADS)
splitk_resid_ln_kernel(const float* __restrict__ P, const float* __restrict__ bias,
                       const float* __restrict__ resid, const float* __restrict__ g,
                       const float* __restrict__ b, float* __restrict__ out, int rows, int n,
                       int splits, float eps) {
  extern __shared__ float srow[];
  __shared__ float red[33];
  const long long row = blockIdx.x;
  const long long plane = (long long)rows * n;
  float sum = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float v = 0.f;
    for (int z = 0; z < splits; ++z) v += P[z * plane + row * n + i];
    const float s = resid[row * n + i] + (v + bias[i]);
    srow[i] = s;
    sum += s;
  }
  const float mu = block_sum(sum, red) / (float)n;
  float sq = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float d = srow[i] - mu;
    sq = fmaf(d, d, sq);
  }
  const float var = block_sum(sq, red) / (float)n;
  const float inv = 1.0f / sqrtf(var + eps);
  float* o = out + row * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    o[i] = ((srow[i] - mu) * inv) * g[i] + b[i];
}

// out = LN(resid + (A @ B + bias)) over [rows, n], A [rows, K] with row
// stride lda, B [K, n]: the tail of K2 (the o-projection), K6b (the same
// function alone) and K3 (fc2, K = ffn), one plan each (ops/gemm_tc.py
// plan_product; K2's and K6b's from ops/bert_ffn_cuda._plan_proj_ln).  The
// product runs with the bias + residual epilogue into resid_sum, then
// layernorm_rows_kernel; where the plan splits over K on the mma.sync
// tiles, the split planes go to `scratch` (resid_sum is not written) and
// splitk_resid_ln_kernel adds them, the bias and the residual and applies
// the LN in one launch.  Returns the launches' cudaError_t.
template <int PROMOTE>
cudaError_t launch_proj_resid_ln(const TcPlan& p, const float* A, int lda, const float* B,
                                 const float* bias, const float* resid, const float* ln_g,
                                 const float* ln_b, float* resid_sum, float* out, int rows,
                                 int n, int K, float eps, void* scratch, cudaStream_t stream) {
  const bool fused = !p.wgmma && p.splits > 1;
  const cudaError_t err = launch_gemm_tc<EPI_BIAS_RESIDUAL, PROMOTE>(
      p, A, lda, B, bias, resid, resid_sum, rows, n, K, n, scratch, stream, !fused);
  if (err != cudaSuccess) return err;
  if (fused)
    splitk_resid_ln_kernel<<<rows, LN_THREADS, sizeof(float) * n, stream>>>(
        static_cast<const float*>(scratch), bias, resid, ln_g, ln_b, out, rows, n, p.splits,
        eps);
  else
    layernorm_rows_kernel<float><<<rows, LN_THREADS, 0, stream>>>(resid_sum, ln_g, ln_b, out, n,
                                                                  eps);
  return cudaGetLastError();
}

}  // namespace
