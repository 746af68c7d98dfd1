// bf16 operands on Hopper's bf16 tensor cores, float32 sums:
// C = epilogue(A @ B), the products of the bf16 instances of K1f (the input
// projection), K1b (dx and the weight reductions), K2 (q/k/v and the
// o-projection) and K3 (fc1, fc2), beside gemm_tc.cuh's 3xTF32 products of
// their float32 instances.
//
// A bf16 product is one MMA (mma.sync m16n8k16, float32 accumulators), not
// three: the operands need no hi / lo split, and the products of bf16
// values are exact in float32, so the result is what the JAX kernels get
// from a bf16 dot with preferred_element_type=float32 (up to the order of
// the float32 sums).  The rounding points are the JAX kernels': the
// epilogue, gemm_tc.cuh's tc_epilogue at T = bf16, adds the bias in float32,
// then rounds to bf16 where they round (common.cuh's GemmEpilogue), and the
// output rounds as it is stored where it is bf16.  Split planes are added
// by gemm_tc.cuh's gemm_splitk_sum, at T = bf16.  The tensor cores'
// truncating accumulation is not promoted here: the bf16 comparisons allow
// 2e-2 of max |ref| and the truncation drifts ~1e-4 (PERF.md records the
// measured errors).
//
// Operands: A bf16, either [M, K] row-major with row stride lda (AK true:
// "K-major"), or stored transposed (AK false: At(k, m) = A[(k + shift) *
// lda + m] for m < mdata, zero where k + shift falls outside [0, K), 1 at m
// == ones_row, 0 beyond: K1b's x^T dg and [h_prev | 1]^T dg over T*B rows,
// as gemm_tc_tn_kernel reads them); B bf16 "gated" [G, K, ldb] with N = G *
// hgb columns, column n read at B[n / hgb][k][n % hgb] (G = 1, hgb = N: a
// plain [K, N] with row stride ldb).  Both arrive in shared memory by
// cp.async in copies of acw / bcw elements (8, 4 or 2; 1: through a
// register), the plan's widest that the strides and the alignment allow
// (ops/gemm_tc.plan_bf16); a copy past an edge reads only its valid
// elements and zero-fills the rest, so padded k steps multiply zeros.
//
// Two kernels, picked by the plan: where the rows fill the card (two
// 128 x 128 tiles an SM and more) and A is 16-byte aligned with K a
// multiple of 8, warpgroup MMA (gemm_wgmma_bf16_kernel, below); else one
// mma.sync tile kernel: 128 x 128 outputs, eight warps of 64 x 32, 32-deep
// k steps in a 4-stage ring; A staged [m][k] (AK) or [k][m], B [k][n], rows
// padded by 16 bytes so the ldmatrix fragment loads are conflict-free
// (ldmatrix.trans turns the k-outer layouts into the MMA's fragments).
// Where the tiles do not fill the card (few rows, or the reductions'
// small M x N over a long K) the plan splits K over blockIdx.z into float32
// planes that gemm_splitk_sum adds in a fixed order (no float atomics: a
// rerun gives the same bits) before it applies the epilogue.  The k loops,
// tiles, fragment loads and MMAs are this file's: bf16 operands need no hi
// / lo split and take k steps of 16, and routing gemm_tc.cuh's float loops
// through a ring shared with these changed the float kernels' machine code
// (tools/float_sass_check.py), so the loops stay apart.  K9's bf16 instance
// (trunk_block.cu) runs its products here with its own epilogues
// (EPI_K9_*: the kernels carry EpiArgs) and float32 biases (TB).  Two
// kernels of their own, fed by TMA from a producer warp, serve the
// products that fill the card (below): K3.bf16's and K2.bf16's products
// (and K6b.bf16's, K2's tail) on a persistent, warp-specialized wgmma
// kernel (gemm_bf16_persistent_kernel, plan wgmma 2) and K1b.bf16's
// reductions over T*B rows on a split-K wgmma kernel (gemm_bf16_tn_kernel,
// plan wgmma 3).
#pragma once

#include <cuda.h>   // CUtensorMap and its enums (the encoder comes through the runtime)

#include "common.cuh"
#include "gemm_tc.cuh"   // the wgmma descriptor, swizzle and fence helpers

namespace {

constexpr int BF_BM = 128, BF_BN = 128, BF_BK = 32, BF_STAGES = 4;
constexpr int BF_WARPS_M = 2, BF_WARPS_N = 4, BF_THREADS = 32 * BF_WARPS_M * BF_WARPS_N;
constexpr int BF_WM = BF_BM / BF_WARPS_M, BF_WN = BF_BN / BF_WARPS_N;   // 64 x 32
constexpr int BF_MT = BF_WM / 16, BF_NT = BF_WN / 8;                     // 4 x 4 MMA tiles
constexpr int BF_LDK = BF_BK + 8;    // A staged [m][k]: 80-byte rows
constexpr int BF_LDM = BF_BM + 8;    // A staged [k][m]: 272-byte rows
constexpr int BF_LDN = BF_BN + 8;    // B staged [k][n]: 272-byte rows
constexpr int BF_A_ELEMS =
    BF_BM * BF_LDK > BF_BK * BF_LDM ? BF_BM * BF_LDK : BF_BK * BF_LDM;
constexpr int BF_B_ELEMS = BF_BK * BF_LDN;
constexpr int BF_SMEM = 2 * BF_STAGES * (BF_A_ELEMS + BF_B_ELEMS);        // 75,776 bytes

// Where a bias argument's type should come from the template arguments
// (their default), not from the call: a nullptr bias deduces nothing.
template <typename T>
struct bf_given {
  using type = T;
};

struct BfGemm {
  const bf16* A;
  const bf16* B;
  int M, N, K;
  int lda, shift, mdata, ones_row;   // A's layout (shift, mdata, ones_row: AK false)
  int ldb, hgb;                      // B's row stride and gate width
  int acw, bcw, kps;                 // copy widths; k tiles a split
};

// Output (r, c) of an [M, N] product: epilogue v of the sum acc, stored
// at C[c / hg][r][c % hg], rounded where O is bf16.  hg = N, a plain [M,
// N], skips the integer division, which would run once an output (4e8 of
// them in K3's bf16 fc1); the branch is uniform.  TB: the bias's type
// (bf16, or float for K9's).
template <int EPI, typename O, typename TB>
__device__ __forceinline__ void bf_store(O* C, const TB* bias, const bf16* resid, int M,
                                         int N, int hg, int r, int c, float acc,
                                         const EpiArgs& ex) {
  long long at = (long long)r * N + c;
  if (hg != N) {
    const int g = c / hg;
    at = ((long long)g * M + r) * hg + (c - g * hg);
  }
  st_f(C + at, tc_epilogue<EPI, bf16, TB>(acc, bias, resid, r, c, N, ex));
}

// Copy cw elements (8, 4 or 2 by cp.async; 1 through a register), the
// first n of them (0 <= n <= cw) from src, zeros for the rest; src must be
// a mapped address even where n is 0.
__device__ __forceinline__ void bf_copy(bf16* dst, const bf16* src, int cw, int n) {
  const unsigned d = smem_addr(dst);
  const int bytes = 2 * n;
  if (cw == 8) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes));
  } else if (cw == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes));
  } else if (cw == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes));
  } else {
    *dst = n > 0 ? *src : f2bf(0.f);
  }
}

// Stage the A and B tiles of k step k0 into one ring slot.
template <bool AK>
__device__ __forceinline__ void bf_load(bf16* As, bf16* Bs, const BfGemm& p, int row0,
                                        int col0, int k0) {
  const int tid = threadIdx.x;
  if constexpr (AK) {
    const int cw = p.acw, per = BF_BK / cw;
    for (int i = tid; i < BF_BM * per; i += BF_THREADS) {
      const int r = i / per, c = (i - r * per) * cw;
      const int m = row0 + r, k = k0 + c;
      const int n = m < p.M ? max(0, min(cw, p.K - k)) : 0;
      bf_copy(As + r * BF_LDK + c, n ? p.A + (long long)m * p.lda + k : p.A, cw, n);
    }
  } else {
    // a copy never straddles mdata where a ones row follows it (the plan's
    // acw divides mdata then)
    const int cw = p.acw, per = BF_BM / cw;
    for (int i = tid; i < BF_BK * per; i += BF_THREADS) {
      const int kr = i / per, c = (i - kr * per) * cw;
      const int k = k0 + kr, ak = k + p.shift, m = row0 + c;
      bf16* dst = As + kr * BF_LDM + c;
      if (m < p.mdata) {
        const bool ok = k < p.K && ak >= 0 && ak < p.K;
        const int n = ok ? min(cw, p.mdata - m) : 0;
        bf_copy(dst, n ? p.A + (long long)ak * p.lda + m : p.A, cw, n);
      } else {
        for (int q = 0; q < cw; ++q) dst[q] = f2bf(m + q == p.ones_row && k < p.K ? 1.f : 0.f);
      }
    }
  }
  const int cw = p.bcw, per = BF_BN / cw;
  const long long gate = (long long)p.K * p.ldb;
  for (int i = tid; i < BF_BK * per; i += BF_THREADS) {
    const int kr = i / per, c = (i - kr * per) * cw;
    const int k = k0 + kr, col = col0 + c;
    const int g = col / p.hgb, j = col - g * p.hgb;
    const int n = k < p.K && col < p.N ? min(cw, p.N - col) : 0;
    bf_copy(Bs + kr * BF_LDN + c, n ? p.B + g * gate + (long long)k * p.ldb + j : p.B, cw, n);
  }
}

// Block (column tile, row tile, split): the k tiles [z * kps, (z + 1) *
// kps) of its 128 x 128 outputs.  One split: the epilogue into C; more:
// plane z of `partial`, in C's gated layout.
template <bool AK, int EPI, typename O, typename TB = bf16>
__global__ void __launch_bounds__(BF_THREADS)
gemm_bf16_kernel(const BfGemm p, const TB* __restrict__ bias, const bf16* __restrict__ resid,
                 O* __restrict__ C, int hg, float* __restrict__ partial, EpiArgs ex) {
  extern __shared__ float4 bf_smem4[];
  bf16* As = reinterpret_cast<bf16*>(bf_smem4);     // [STAGES][A_ELEMS]
  bf16* Bs = As + BF_STAGES * BF_A_ELEMS;           // [STAGES][BK][LDN]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int wm0 = (warp / BF_WARPS_N) * BF_WM, wn0 = (warp % BF_WARPS_N) * BF_WN;
  const int row0 = blockIdx.y * BF_BM, col0 = blockIdx.x * BF_BN;
  const int kt0 = blockIdx.z * p.kps;
  const int ktiles = min(p.kps, (p.K + BF_BK - 1) / BF_BK - kt0);

  float acc[BF_MT][BF_NT][4];
#pragma unroll
  for (int i = 0; i < BF_MT; ++i)
#pragma unroll
    for (int j = 0; j < BF_NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < BF_STAGES - 1; ++s) {
    if (s < ktiles)
      bf_load<AK>(As + s * BF_A_ELEMS, Bs + s * BF_B_ELEMS, p, row0, col0, (kt0 + s) * BF_BK);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<BF_STAGES - 2>();
    __syncthreads();   // tile kt landed for all; slot (kt - 1) % STAGES is free
    const int nk = kt + BF_STAGES - 1;
    if (nk < ktiles) {
      const int s = nk % BF_STAGES;
      bf_load<AK>(As + s * BF_A_ELEMS, Bs + s * BF_B_ELEMS, p, row0, col0, (kt0 + nk) * BF_BK);
    }
    cp_async_commit();

    const bf16* as = As + (kt % BF_STAGES) * BF_A_ELEMS;
    const bf16* bs = Bs + (kt % BF_STAGES) * BF_B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BF_BK; kk += 16) {
      // A's four 8 x 8 matrices (m 0-7 | 8-15) x (k 0-7 | 8-15), B's
      // (k 0-7 | 8-15) x (n 0-7 | 8-15): lane l addresses row l % 8 of
      // matrix l / 8
      uint32_t a[BF_MT][4], b[BF_NT][2];
#pragma unroll
      for (int i = 0; i < BF_MT; ++i) {
        if constexpr (AK)
          ldsm_x4(a[i], as + (wm0 + i * 16 + (lane & 15)) * BF_LDK + kk + (lane >> 4) * 8);
        else
          ldsm_x4_t(a[i], as + (kk + (lane >> 4) * 8 + (lane & 7)) * BF_LDM + wm0 + i * 16 +
                              ((lane >> 3) & 1) * 8);
      }
#pragma unroll
      for (int jp = 0; jp < BF_NT / 2; ++jp) {
        uint32_t r[4];
        ldsm_x4_t(r, bs + (kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * BF_LDN + wn0 + jp * 16 +
                         (lane >> 4) * 8);
        b[2 * jp][0] = r[0];
        b[2 * jp][1] = r[1];
        b[2 * jp + 1][0] = r[2];
        b[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < BF_MT; ++i)
#pragma unroll
        for (int j = 0; j < BF_NT; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  const bool split = gridDim.z > 1;
  float* plane = partial + (long long)blockIdx.z * p.M * p.N;
#pragma unroll
  for (int i = 0; i < BF_MT; ++i)
#pragma unroll
    for (int j = 0; j < BF_NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + wm0 + i * 16 + g8 + (e >= 2 ? 8 : 0);
        const int c = col0 + wn0 + j * 8 + 2 * t4 + (e & 1);
        if (r >= p.M || c >= p.N) continue;
        if (split)
          bf_store<EPI_NONE>(plane, bias, resid, p.M, p.N, hg, r, c, acc[i][j][e], ex);
        else
          bf_store<EPI>(C, bias, resid, p.M, p.N, hg, r, c, acc[i][j][e], ex);
      }
}

// ---------------------------------------------------------------------------
// Many rows: warpgroup MMA, m64n128k16 bf16 with float32 accumulators.  The
// TF32 wgmma kernel's walk (gemm_tc.cuh: two warpgroups a 128 x 128 tile,
// a 4-stage cp.async ring loaded two tiles ahead, A from shared memory into
// registers in the mma.sync fragment layout, B by descriptor, one batch in
// flight), at one MMA a k step of 16 instead of three of 8: a 64-element
// bf16 k tile is 128 bytes a row, the TF32 tile's 32 floats, so the
// 128-byte-swizzled stages, the descriptors and the fragment words are the
// TF32 kernel's.  B is read K-major (B^T [N][K], transposed once a call
// into the plan's scratch by bf_transpose_b, as gemm_tc_presplit splits the
// TF32 planes).  A thread holds 64 accumulators and 32 A registers.
constexpr int BW_BN = 128, BW_BK = 64;
constexpr int BW_PLANE = WG_BM * BW_BK;                           // bf16 of one stage's A or B
constexpr int BW_SMEM = 2 * WG_STAGES * 2 * BW_PLANE + 1024;       // 132,096 bytes
static_assert(BW_BN == WG_BM && BW_SMEM <= MAX_SMEM_BYTES, "bf16 wgmma tile");

__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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

// B (gated, as BfGemm reads it) -> B^T [N][K], K-major.
__global__ void bf_transpose_b(const bf16* __restrict__ B, bf16* __restrict__ Bt, int N,
                               int K, int ldb, int hgb) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)N * K) return;
  const int n = (int)(i / K), k = (int)(i - (long long)n * K);
  const int g = n / hgb, j = n - g * hgb;
  Bt[i] = B[(long long)g * K * ldb + (long long)k * ldb + j];
}

// One stage: A's [128 r][64 k] and B^T's [128 n][64 k] tiles in 16-byte
// copies (8 elements; K a multiple of 8), 128-byte-swizzled as the TF32
// kernel's 32-word rows (sw128 counts 32-bit words: two bf16 each); rows
// past M or N and k past K read as zero.
__device__ __forceinline__ void bw_load(bf16* as, bf16* bs, const bf16* A, const bf16* Bt,
                                        int M, int N, int K, int lda, int row0, int col0,
                                        int k0) {
  for (int i = threadIdx.x; i < 2 * WG_BM * 8; i += WG_THREADS) {
    const int b = i / (WG_BM * 8), rest = i - b * (WG_BM * 8);
    const int r = rest / 8, c = rest % 8;
    const bool ok = (b ? col0 + r < N : row0 + r < M) && k0 + c * 8 < K;
    const bf16* src = b ? Bt + (long long)(col0 + r) * K : A + (long long)(row0 + r) * lda;
    cp_async16((b ? bs : as) + 2 * sw128(r, c * 4), ok ? src + k0 + c * 8 : (b ? Bt : A), ok);
  }
}

// gemm_tc.cuh's wgmma_k_tile at bf16: wait for k tile kt, start loading
// tile kt + 2, load tile kt's A fragments, issue its batch of four MMAs and
// leave one batch in flight.
__device__ __forceinline__ void bw_k_tile(float (&acc)[64], uint32_t (&a)[4][4], bf16* As,
                                          bf16* Bs, const bf16* A, const bf16* Bt, int M,
                                          int N, int K, int lda, int row0, int col0, int kt,
                                          int ktiles, int wrow) {
  cp_async_wait<1>();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (kt + 2 < ktiles) {
    const int s = (kt + 2) % WG_STAGES;
    bw_load(As + s * BW_PLANE, Bs + s * BW_PLANE, A, Bt, M, N, K, lda, row0, col0,
            (kt + 2) * BW_BK);
  }
  cp_async_commit();
  const int s = kt % WG_STAGES, lane = threadIdx.x % 32;
  const int r = wrow + lane / 4, t4 = lane % 4;
  const uint32_t* as = reinterpret_cast<const uint32_t*>(As + s * BW_PLANE);
  const bf16* bs = Bs + s * BW_PLANE;
#pragma unroll
  for (int q = 0; q < 4; ++q) {   // (row, k pair): k 16q + 2 t4 (+ 8), rows r, r + 8
    a[q][0] = as[sw128(r, q * 8 + t4)];
    a[q][1] = as[sw128(r + 8, q * 8 + t4)];
    a[q][2] = as[sw128(r, q * 8 + t4 + 4)];
    a[q][3] = as[sw128(r + 8, q * 8 + t4 + 4)];
  }
  wgmma_fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int q = 0; q < 4; ++q)   // k step q: 32 bytes into each 128-byte row
    wgmma_bf16_n128(acc, a[q], wgmma_desc_sw128(bs + q * 16));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  wgmma_fence_acc(acc);
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  wgmma_fence_acc(acc);
}

template <int EPI, typename O, typename TB = bf16>
__global__ void __launch_bounds__(WG_THREADS)
gemm_wgmma_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Bt, int M, int N,
                       int K, int lda, const TB* __restrict__ bias,
                       const bf16* __restrict__ resid, O* __restrict__ C, int hg, EpiArgs ex) {
  extern __shared__ float4 bw_smem4[];
  bf16* Bs = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(bw_smem4) + 1023) &
                                     ~uintptr_t(1023));        // [S][128][64]
  bf16* As = Bs + WG_STAGES * BW_PLANE;                        // [S][128][64]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int wrow = (warp / 4) * 64 + (warp % 4) * 16;   // warpgroup's 64 rows, warp's 16
  const int row0 = blockIdx.y * WG_BM, col0 = blockIdx.x * BW_BN;
  // an even number of k tiles (an odd last one reads zeros): no loop tail
  const int ktiles = ((K + BW_BK - 1) / BW_BK + 1) & ~1;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  wgmma_fence_acc(acc);
  uint32_t a0[4][4], a1[4][4];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    bw_load(As + s * BW_PLANE, Bs + s * BW_PLANE, A, Bt, M, N, K, lda, row0, col0, s * BW_BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; kt += 2) {
    bw_k_tile(acc, a0, As, Bs, A, Bt, M, N, K, lda, row0, col0, kt, ktiles, wrow);
    bw_k_tile(acc, a1, As, Bs, A, Bt, M, N, K, lda, row0, col0, kt + 1, ktiles, wrow);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wgmma_fence_acc(acc);
  cp_async_wait<0>();

  // acc[4i + e]: row g8 (+8 for e >= 2), column 8i + 2 t4 + (e & 1)
#pragma unroll
  for (int i = 0; i < BW_BN / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + wrow + g8 + (e >= 2 ? 8 : 0);
      const int c = col0 + i * 8 + 2 * t4 + (e & 1);
      if (r < M && c < N) bf_store<EPI>(C, bias, resid, M, N, hg, r, c, acc[i * 4 + e], ex);
    }
}

// ---------------------------------------------------------------------------
// Many rows, K3.bf16's two products (plan wgmma 2): a persistent,
// warp-specialized wgmma kernel (K4's design in bert_ffn_q.cu, at bf16).
// fc1 is 618 GFLOP at B=4096 L=32 (0.63 ms at 989 TFLOP/s), fc2 as much,
// against ~1.8 GB of x, the hidden and the residual sum: bound by the
// tensor cores, where the first port (gemm_wgmma_bf16_kernel: one 128 x 128
// tile a block, A through registers, B transposed every call, one scalar
// store an output) ran them at 13% of the peak.  Here:
//   * one block an SM walks 128 x 192 output tiles t = blockIdx.x, +
//     gridDim.x, ... the column tiles of a row tile together, so a row
//     panel of A is read from memory once and B (the weights, 4.7 MB at
//     BERT-base width) stays in L2;
//   * a producer warp keeps a ring of BP_STAGES k tiles in flight by TMA
//     (cp.async.bulk.tensor, one thread, completion on an mbarrier a
//     stage): A [128 m][64 k] K-major and B [64 k][192 n] as stored (row
//     k of w1t or w2t, N contiguous: "MN-major"), three [64 k][64 n]
//     boxes, both 128-byte swizzled by the tensor map, rows past M or N and
//     k past K read as zero;
//   * two MMA warpgroups, 64 rows each, run m64n192k16 with both operands
//     by descriptor (B through the descriptor's transpose bit: no copy of
//     the weights, no register staging of A), one batch in flight while the
//     next stage lands, and free a stage (an mbarrier a stage) once the
//     batch that read it retired; at a tile's end they round the sums plus
//     the bias to bf16 (the JAX kernels' first rounding point) into a
//     staging tile in shared memory and start the next tile;
//   * six epilogue warps take the staging tile 16 bytes a lane: fc1's
//     exact-erf gelu, fc2's residual sum, each rounded, and 16-byte
//     stores, while the MMAs of the next tile run (fc1's gelu, ~36
//     instructions an output, takes about as many cycles of the SM's
//     schedulers as the tile's MMAs take: the epilogue gets the warps the
//     registers leave).
// The staging tile is handed over at two named barriers (full / empty), as
// K4's Cs; the MMA warpgroups never wait on the epilogue's stores, only on
// its reading of the staging tile.  480 threads give 136 registers each,
// room for an MMA thread's 96 sums: the 128 x 256 tile (128 sums) needed
// setmaxnreg, whose raised count ptxas did not apply to the MMA code
// (C7602 at the launch bound's 96).  EPI: EPI_BIAS_GELU (fc1),
// EPI_BIAS_RESIDUAL (fc2, K2.bf16's o-projection and K6b.bf16) or EPI_BIAS
// (K2.bf16's q/k/v: the staged bf16(acc + bias) stored as it is),
// tc_epilogue's rounding points at T = bf16.
//
// K2.bf16's q/k/v product reads a gated B and writes a gated C, as
// gemm_bf16_kernel does (hg: the gate width, N for a plain product): B
// [N / hg][K][ldb] through one tensor map over its N / hg * K rows, C [N /
// hg][M][hg].  A column tile at col0 lies in plane p = col0 / hg, whose k
// rows start at row p * K of the map; hg a multiple of BP_BN and K of
// BP_BK (the launcher checks both) keep every column tile in one plane and
// every k box in one plane's rows.
constexpr int BP_BM = 128, BP_BN = 192, BP_BK = 64, BP_STAGES = 4;
constexpr int BP_A_BYTES = BP_BM * BP_BK * 2;          // [128 m][64 k], 128-byte rows
constexpr int BP_B_CHUNK = BP_BK * 64 * 2;             // [64 k][64 n], 128-byte rows
constexpr int BP_B_BYTES = BP_BN / 64 * BP_B_CHUNK;    // 192 columns
constexpr int BP_LDS = BP_BN + 8;                      // staging row (bf16): 400 bytes
constexpr int BP_STAGING = BP_BM * BP_LDS * 2;
constexpr int BP_MMA_THREADS = 256, BP_EPI_THREADS = 192;
constexpr int BP_THREADS = BP_MMA_THREADS + BP_EPI_THREADS + 32;   // + the producer warp
constexpr int BP_HANDOFF = BP_MMA_THREADS + BP_EPI_THREADS;        // the named barriers' count
constexpr int BP_SMEM = BP_STAGES * (BP_A_BYTES + BP_B_BYTES) + BP_STAGING +
                        2 * BP_STAGES * 8 + 1024;      // + mbarriers, + 1 KB to align atoms
constexpr int BP_BAR_FULL = 1, BP_BAR_EMPTY = 2;       // the staging tile's named barriers
static_assert(BP_SMEM <= MAX_SMEM_BYTES && BP_BN % 64 == 0, "persistent bf16 tile");

__device__ __forceinline__ void bp_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bp_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase differs from `parity`; a wait of some
// seconds (a fault: the stage never lands) traps, so the launch fails
// rather than holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// A 2D box of `map` at (c0 innermost, c1) into shared memory, completion on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// A 128-byte-swizzled shared-memory operand's descriptor: lbo and sbo in
// bytes (K-major: sbo the 8-row groups' stride; MN-major: lbo the stride of
// 64-element column chunks, sbo the 8-row k groups').
__device__ __forceinline__ uint64_t wgmma_desc_sw128_strides(const void* p, int lbo, int sbo) {
  return ((uint64_t)(smem_addr(p) & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// D [64 x 192] (+)= A [64 x 16] B [16 x 192], A K-major and B MN-major, both
// by descriptor; scale_d 0 starts the sums.
__device__ __forceinline__ void wgmma_bf16_n192_ss(float (&d)[96], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95 "
      "}, %96, %97, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
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
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <int EPI>
__global__ void __launch_bounds__(BP_THREADS, 1)
gemm_bf16_persistent_kernel(const __grid_constant__ CUtensorMap map_a,
                            const __grid_constant__ CUtensorMap map_b, int M, int N, int K,
                            int hg, const bf16* __restrict__ bias,
                            const bf16* __restrict__ resid, bf16* __restrict__ C) {
  extern __shared__ float4 bp_smem4[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(bp_smem4) + 1023) & ~uintptr_t(1023));
  uint8_t* As = ring;                                         // [S][128][64] bf16
  uint8_t* Bs = As + BP_STAGES * BP_A_BYTES;                  // [S][3][64][64] bf16
  bf16* staged = reinterpret_cast<bf16*>(Bs + BP_STAGES * BP_B_BYTES);   // [128][LDS]
  uint64_t* full = reinterpret_cast<uint64_t*>(staged + BP_BM * BP_LDS);
  uint64_t* empty = full + BP_STAGES;
  const int tiles_n = (N + BP_BN - 1) / BP_BN;
  const int tiles = tiles_n * ((M + BP_BM - 1) / BP_BM);
  const int ktiles = (K + BP_BK - 1) / BP_BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < BP_STAGES; ++s) {
      mbar_init(full + s, 1);                       // the producer's expect_tx
      mbar_init(empty + s, BP_MMA_THREADS / 32);    // a lane of each MMA warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= BP_HANDOFF) {
    // the producer warp
    if (lane == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int row0 = (t / tiles_n) * BP_BM, col0 = (t % tiles_n) * BP_BN;
        const int plane = col0 / hg, bx = col0 - plane * hg, by = plane * K;
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(empty + s, ph ^ 1);   // passes at once on the ring's first lap
          mbar_expect_tx(full + s, BP_A_BYTES + BP_B_BYTES);
          tma_load_2d(As + s * BP_A_BYTES, &map_a, kt * BP_BK, row0, full + s);
#pragma unroll
          for (int c = 0; c < BP_BN / 64; ++c)
            tma_load_2d(Bs + s * BP_B_BYTES + c * BP_B_CHUNK, &map_b, bx + 64 * c,
                        by + kt * BP_BK, full + s);
          if (++s == BP_STAGES) s = 0, ph ^= 1;
        }
      }
    }
  } else if (threadIdx.x < BP_MMA_THREADS) {
    // the MMA warpgroups: rows wg * 64 .. + 63 of a tile
    const int wg = threadIdx.x / 128, g8 = lane / 4, t4 = lane % 4;
    const int srow = wg * 64 + (warp % 4) * 16 + g8;   // this lane's staged rows: srow, + 8
    float acc[96];
#pragma unroll
    for (int i = 0; i < 96; ++i) acc[i] = 0.f;
    int s = 0;
    uint32_t ph = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int col0 = (t % tiles_n) * BP_BN;
      int prev = 0;
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(full + s, ph);
        const uint8_t* as = As + s * BP_A_BYTES + wg * 64 * 128;
        const uint8_t* bs = Bs + s * BP_B_BYTES;
        wgmma_fence_acc(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int q = 0; q < BP_BK / 16; ++q)   // k step q: 32 bytes into A's rows, 16 rows of B
          wgmma_bf16_n192_ss(acc, wgmma_desc_sw128(as + q * 32),
                             wgmma_desc_sw128_strides(bs + q * 16 * 128, BP_B_CHUNK, 1024),
                             kt + q > 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        wgmma_fence_acc(acc);
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        wgmma_fence_acc(acc);
        // the previous k tile's batch retired: its stage is free
        if (kt > 0 && lane == 0) mbar_arrive(empty + prev);
        prev = s;
        if (++s == BP_STAGES) s = 0, ph ^= 1;
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      wgmma_fence_acc(acc);
      if (lane == 0) mbar_arrive(empty + prev);
      // the epilogue has read the last tile out of the staging tile
      bp_bar_sync(BP_BAR_EMPTY, BP_HANDOFF);
      // acc[4i + e]: row srow (+8 for e >= 2), column 8i + 2 t4 + (e & 1)
#pragma unroll
      for (int i = 0; i < BP_BN / 8; ++i) {
        const int c = col0 + 8 * i + 2 * t4;
        const float b0 = c < N ? bf2f(bias[c]) : 0.f, b1 = c + 1 < N ? bf2f(bias[c + 1]) : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<uint32_t*>(staged + (srow + 8 * half) * BP_LDS + 8 * i + 2 * t4) =
              pack_bf16(acc[4 * i + 2 * half] + b0, acc[4 * i + 2 * half + 1] + b1);
      }
      bp_bar_arrive(BP_BAR_FULL, BP_HANDOFF);
    }
  } else {
    // the epilogue warps: 16-byte pieces p = et + j * BP_EPI_THREADS (j <
    // PIECES) of the staged tile, row p / (BP_BN / 8), columns 8 (p % (BP_BN
    // / 8)) ..  The residual (EPI_BIAS_RESIDUAL) runs RESID_AHEAD pieces
    // ahead of its use: the first RESID_AHEAD load before the staging tile
    // is waited for, while the MMAs of the tile run, and each later one as
    // the piece RESID_AHEAD before it is stored.  Behind K2's o-projection
    // and K6b's (12 k tiles a tile) the loads' latency otherwise set the
    // product's time (0.47 ms against 0.30 at B=4096 L=32,
    // tools/k2_bf16_trials.py); all of them ahead took 64 more registers
    // and spilled.
    constexpr int PER_ROW = BP_BN / 8, PIECES = BP_BM * PER_ROW / BP_EPI_THREADS;
    constexpr int RESID_AHEAD = PIECES / 2;
    static_assert(PIECES * BP_EPI_THREADS == BP_BM * PER_ROW, "whole pieces a thread");
    const int et = threadIdx.x - BP_MMA_THREADS;
    bp_bar_arrive(BP_BAR_EMPTY, BP_HANDOFF);   // it starts empty
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int row0 = (t / tiles_n) * BP_BM, col0 = (t % tiles_n) * BP_BN;
      const int plane = col0 / hg;
      // C's element (row0, col0): plane `plane`, column col0 - plane * hg
      const long long cbase = ((long long)plane * M + row0) * hg + (col0 - plane * hg);
      // piece j's residual (a plain C: its offset is C's), zeros past the edges
      auto resid_piece = [&](int j) {
        const int p = et + j * BP_EPI_THREADS, r = p / PER_ROW, cc = 8 * (p - r * PER_ROW);
        return row0 + r < M && col0 + cc < N
                   ? *reinterpret_cast<const uint4*>(resid + cbase + (long long)r * hg + cc)
                   : make_uint4(0, 0, 0, 0);
      };
      uint4 ahead[RESID_AHEAD];
      if constexpr (EPI == EPI_BIAS_RESIDUAL) {
#pragma unroll
        for (int j = 0; j < RESID_AHEAD; ++j) ahead[j] = resid_piece(j);
      }
      bp_bar_sync(BP_BAR_FULL, BP_HANDOFF);
#pragma unroll
      for (int j = 0; j < PIECES; ++j) {
        const int p = et + j * BP_EPI_THREADS;
        const int r = p / PER_ROW, cc = 8 * (p - r * PER_ROW), c = col0 + cc;
        uint4 xv = make_uint4(0, 0, 0, 0);
        if constexpr (EPI == EPI_BIAS_RESIDUAL) {
          xv = ahead[j % RESID_AHEAD];
          if (j + RESID_AHEAD < PIECES) ahead[j % RESID_AHEAD] = resid_piece(j + RESID_AHEAD);
        }
        if (row0 + r >= M || c >= N) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(staged + r * BP_LDS + cc);
        const bf16* h = reinterpret_cast<const bf16*>(&v);
        uint4 out;
        uint32_t* w = reinterpret_cast<uint32_t*>(&out);
        if constexpr (EPI == EPI_BIAS) {
          out = v;
        } else if constexpr (EPI == EPI_BIAS_GELU) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            w[e] = pack_bf16(gelu_erf(bf2f(h[2 * e])), gelu_erf(bf2f(h[2 * e + 1])));
        } else {
          const bf16* x = reinterpret_cast<const bf16*>(&xv);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            w[e] = pack_bf16(bf2f(x[2 * e]) + bf2f(h[2 * e]),
                             bf2f(x[2 * e + 1]) + bf2f(h[2 * e + 1]));
        }
        *reinterpret_cast<uint4*>(C + cbase + (long long)r * hg + cc) = out;
      }
      if (t + (int)gridDim.x < tiles) bp_bar_arrive(BP_BAR_EMPTY, BP_HANDOFF);
    }
  }
}

// cuTensorMapEncodeTiled, found through the CUDA runtime's entry-point
// query (no link to libcuda): null where it is not found.
using TensorMapEncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                          const cuuint64_t*, const cuuint64_t*,
                                          const cuuint32_t*, const cuuint32_t*,
                                          CUtensorMapInterleave, CUtensorMapSwizzle,
                                          CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline TensorMapEncodeTiled tensor_map_encoder() {
  static TensorMapEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<TensorMapEncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a row-major bf16 [rows, cols] matrix of row stride ld
// (elements; a multiple of 8), read in 128-byte-swizzled boxes of [box_rows]
// [64 cols]; reads past the edges give zeros.
inline bool bf16_tensor_map(CUtensorMap* map, const bf16* base, int rows, int cols, int ld,
                            int box_rows) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr || ld % 8 != 0 || reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// C = epilogue(A [M, K] @ B) on the persistent kernel, A of row stride lda,
// B [N / hg][K][ldb] and C [N / hg][M][hg] (hg = N: a plain B [K, N] and C
// [M, N]; hg < N, gated: hg a multiple of BP_BN and K of BP_BK, no
// residual), resid [M, N], over `grid` blocks (the plan's: one an SM, at
// most one a tile).  Returns the launch's cudaError_t.
template <int EPI>
cudaError_t launch_gemm_bf16_persistent(const bf16* A, int lda, const bf16* B, int ldb, int hg,
                                        const bf16* bias, const bf16* resid, bf16* C, int M,
                                        int N, int K, int grid, cudaStream_t stream) {
  static_assert(EPI == EPI_BIAS || EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_RESIDUAL,
                "K2's and K3's epilogues");
  const bool gated = hg != N;
  CUtensorMap map_a, map_b;
  if (grid < 1 || hg < 8 || hg % 8 != 0 || N % hg != 0 ||
      (gated && (hg % BP_BN != 0 || K % BP_BK != 0 || EPI == EPI_BIAS_RESIDUAL)) ||
      reinterpret_cast<uintptr_t>(C) % 16 != 0 ||
      (EPI == EPI_BIAS_RESIDUAL && reinterpret_cast<uintptr_t>(resid) % 16 != 0) ||
      !bf16_tensor_map(&map_a, A, M, K, lda, BP_BM) ||
      !bf16_tensor_map(&map_b, B, N / hg * K, hg, ldb, BP_BK))
    return cudaErrorInvalidValue;
  static unsigned long long smem_set = 0;
  const cudaError_t err =
      allow_smem_once((const void*)gemm_bf16_persistent_kernel<EPI>, &smem_set);
  if (err != cudaSuccess) return err;
  gemm_bf16_persistent_kernel<EPI><<<grid, BP_THREADS, BP_SMEM, stream>>>(map_a, map_b, M, N, K,
                                                                         hg, bias, resid, C);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K1b.bf16's dwp = x^T dg[:, :3H] and dwt = [h_prev | 1]^T dg over the T*B
// rows (plan wgmma 3): reductions over a long K (204,800 rows at B=4096,
// T=50) of a small M x N ([in, 3H], [H + 1, 4H]), 94 GFLOP for dwp at in =
// 768 against ~0.48 GB of x and dg.  The first port ran them on the
// transposed-A mma.sync tiles at ~80 TFLOP/s (1.38 ms of K1b.bf16's 2.68 at
// in = 768).  Here both operands are read as stored, rows of k: A = x
// [K][lda] (or the recurrence's [h_prev | 1] rows) and B = dg [K][ldb],
// each "MN-major" for the wgmma (the descriptor's transpose bits), by TMA in
// [64 k][64] 128-byte-swizzled boxes, rows past K and columns past M or N
// zero.  A
// block takes one 128 x 128 output tile over one k range (blockIdx.z: the
// plan splits K so that tiles x ranges fill one wave), a producer warp
// keeps BT_STAGES k tiles in flight, two MMA warpgroups (m64n128k16, 64 rows
// each) consume them, and the float32 sums go to plane z of `partial`,
// which gemm_splitk_sum adds in a fixed order (a rerun gives the same
// bits) and rounds to bf16, as the mma.sync path's planes.
constexpr int BT_BM = 128, BT_BN = 128, BT_BK = 64, BT_STAGES = 6;
constexpr int BT_OP_BYTES = BT_BK * 128 * 2;            // [64 k][128] as two [64][64] chunks
constexpr int BT_MMA_THREADS = 256, BT_THREADS = BT_MMA_THREADS + 32;
constexpr int bt_smem(int stages) { return stages * (2 * BT_OP_BYTES + 16) + 1024; }
static_assert(bt_smem(BT_STAGES) <= MAX_SMEM_BYTES, "bf16 reduction tile");

// D [64 x 128] (+)= A [64 x 16] B [16 x 128], both MN-major by descriptor.
__device__ __forceinline__ void wgmma_bf16_n128_tt(float (&d)[64], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
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
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// (STAGES: BT_STAGES; a template, so only a unit that launches it builds it.)
template <int STAGES>
__global__ void __launch_bounds__(BT_THREADS, 1)
gemm_bf16_tn_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b, int M, int N, int K, int kps,
                    float* __restrict__ partial) {
  extern __shared__ float4 bt_smem4[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(bt_smem4) + 1023) & ~uintptr_t(1023));
  uint8_t* As = ring;                                   // [S][2][64 k][64 m]
  uint8_t* Bs = As + STAGES * BT_OP_BYTES;           // [S][2][64 k][64 n]
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + STAGES * BT_OP_BYTES);
  uint64_t* empty = full + STAGES;
  const int m0 = blockIdx.y * BT_BM, n0 = blockIdx.x * BT_BN;
  const int kt0 = blockIdx.z * kps;
  const int ktiles = min(kps, (K + BT_BK - 1) / BT_BK - kt0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, BT_MMA_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= BT_MMA_THREADS) {
    if (lane == 0) {   // the producer
      int s = 0;
      uint32_t ph = 0;
      for (int kt = 0; kt < ktiles; ++kt) {
        const int k0 = (kt0 + kt) * BT_BK;
        mbar_wait(empty + s, ph ^ 1);
        mbar_expect_tx(full + s, 2 * BT_OP_BYTES);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          tma_load_2d(As + s * BT_OP_BYTES + c * BP_B_CHUNK, &map_a, m0 + 64 * c, k0, full + s);
          tma_load_2d(Bs + s * BT_OP_BYTES + c * BP_B_CHUNK, &map_b, n0 + 64 * c, k0, full + s);
        }
        if (++s == STAGES) s = 0, ph ^= 1;
      }
    }
    return;
  }
  const int wg = threadIdx.x / 128, g8 = lane / 4, t4 = lane % 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int s = 0, prev = 0;
  uint32_t ph = 0;
  for (int kt = 0; kt < ktiles; ++kt) {
    mbar_wait(full + s, ph);
    const uint8_t* as = As + s * BT_OP_BYTES + wg * BP_B_CHUNK;   // this warpgroup's 64 rows
    const uint8_t* bs = Bs + s * BT_OP_BYTES;
    wgmma_fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int q = 0; q < BT_BK / 16; ++q)   // k step q: 16 rows of 128 bytes
      wgmma_bf16_n128_tt(acc, wgmma_desc_sw128_strides(as + q * 2048, BP_B_CHUNK, 1024),
                         wgmma_desc_sw128_strides(bs + q * 2048, BP_B_CHUNK, 1024), 1);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    wgmma_fence_acc(acc);
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    wgmma_fence_acc(acc);
    if (kt > 0 && lane == 0) mbar_arrive(empty + prev);
    prev = s;
    if (++s == STAGES) s = 0, ph ^= 1;
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wgmma_fence_acc(acc);
  float* plane = partial + (long long)blockIdx.z * M * N;
  // acc[4i + e]: row g8 (+8 for e >= 2) of the warp's 16, column 8i + 2 t4 + (e & 1)
  const int r0 = m0 + wg * 64 + (warp % 4) * 16 + g8;
#pragma unroll
  for (int i = 0; i < BT_BN / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + (e >= 2 ? 8 : 0), c = n0 + 8 * i + 2 * t4 + (e & 1);
      if (r < M && c < N) plane[(long long)r * N + c] = acc[4 * i + e];
    }
}

// C [M, N] (bf16) = A^T B over K rows, A [K][lda], B [K][ldb] bf16, on the
// reduction kernel in `splits` k ranges of kps k tiles (the plan's), the
// planes in `partial` (splits * M * N floats), added and rounded by
// gemm_splitk_sum.  Returns the launches' cudaError_t.
template <int STAGES = BT_STAGES>
cudaError_t launch_gemm_bf16_tn(const bf16* A, int lda, const bf16* B, int ldb, bf16* C, int M,
                                int N, int K, int splits, int kps, float* partial,
                                cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  if (splits < 1 || kps < 1 || partial == nullptr ||
      !bf16_tensor_map(&map_a, A, K, M, lda, BT_BK) ||
      !bf16_tensor_map(&map_b, B, K, N, ldb, BT_BK))
    return cudaErrorInvalidValue;
  static unsigned long long smem_set = 0;
  cudaError_t err = allow_smem_once((const void*)gemm_bf16_tn_kernel<STAGES>, &smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BT_BN - 1) / BT_BN, (M + BT_BM - 1) / BT_BM, splits);
  gemm_bf16_tn_kernel<STAGES><<<grid, BT_THREADS, bt_smem(STAGES), stream>>>(
      map_a, map_b, M, N, K, kps, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = (long long)M * N;
  gemm_splitk_sum<EPI_NONE, bf16, bf16, bf16><<<(unsigned)((n + RED_THREADS - 1) / RED_THREADS),
                                                RED_THREADS, 0, stream>>>(
      partial, nullptr, nullptr, C, n, M, N, N, splits, EpiArgs{});
  return cudaGetLastError();
}

// A product's launch plan, five host ints from ops/gemm_tc.plan_bf16:
// wgmma (1: gemm_wgmma_bf16_kernel, B^T in `partial`, N * K bf16; 2:
// gemm_bf16_persistent_kernel, K2's and K3's products (and K6b's, K2's
// tail) only, by launch_product_bf16; 3: gemm_bf16_tn_kernel, K1b.bf16's
// reductions only, by launch_gemm_bf16_tn), splits (the mma.sync kernel's blockIdx.z;
// > 1: splits * M * N floats of `partial`), kps (k tiles a split), acw and
// bcw (elements an A / B copy).
struct BfPlan {
  int wgmma, splits, kps, acw, bcw;
};

inline BfPlan bf_plan(const int* q) { return BfPlan{q[0], q[1], q[2], q[3], q[4]}; }

inline bool bf_cw_ok(int cw) { return cw == 1 || cw == 2 || cw == 4 || cw == 8; }

// C (gated [N/hg, M, hg], O float32 or bf16) = epilogue(A @ B) by the
// plan, resid bf16, bias TB (bf16, or float32 for K9's); with splits > 1
// the planes go to `partial` and gemm_splitk_sum adds them and applies the
// epilogue.  ex: K9's epilogue arguments.  p.M must count a ones row.
// Returns the launches' cudaError_t.
template <bool AK, int EPI, typename O, typename TB = bf16>
cudaError_t launch_gemm_bf16(const BfPlan& pl, BfGemm p, const typename bf_given<TB>::type* bias,
                             const bf16* resid, O* C, int hg, float* partial,
                             cudaStream_t stream, const EpiArgs& ex = EpiArgs{}) {
  if (pl.wgmma > 1) return cudaErrorInvalidValue;
  if (pl.wgmma) {
    if constexpr (AK) {
      if (pl.acw != 8 || p.K % 8 != 0 || partial == nullptr) return cudaErrorInvalidValue;
      bf16* bt = reinterpret_cast<bf16*>(partial);
      const long long nk = (long long)p.N * p.K;
      bf_transpose_b<<<(unsigned)((nk + 255) / 256), 256, 0, stream>>>(p.B, bt, p.N, p.K,
                                                                        p.ldb, p.hgb);
      static unsigned long long wg_smem_set = 0;
      cudaError_t err =
          allow_smem_once((const void*)gemm_wgmma_bf16_kernel<EPI, O, TB>, &wg_smem_set);
      if (err != cudaSuccess) return err;
      const dim3 grid((p.N + BW_BN - 1) / BW_BN, (p.M + WG_BM - 1) / WG_BM);
      gemm_wgmma_bf16_kernel<EPI, O, TB><<<grid, WG_THREADS, BW_SMEM, stream>>>(
          p.A, bt, p.M, p.N, p.K, p.lda, bias, resid, C, hg, ex);
      return cudaGetLastError();
    } else {
      return cudaErrorInvalidValue;
    }
  }
  if (pl.splits < 1 || pl.kps < 1 || !bf_cw_ok(pl.acw) || !bf_cw_ok(pl.bcw) ||
      (pl.splits > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  static unsigned long long smem_set = 0;
  cudaError_t err =
      allow_smem_once((const void*)gemm_bf16_kernel<AK, EPI, O, TB>, &smem_set);
  if (err != cudaSuccess) return err;
  p.acw = pl.acw;
  p.bcw = pl.bcw;
  p.kps = pl.kps;
  const dim3 grid((p.N + BF_BN - 1) / BF_BN, (p.M + BF_BM - 1) / BF_BM, pl.splits);
  gemm_bf16_kernel<AK, EPI, O, TB><<<grid, BF_THREADS, BF_SMEM, stream>>>(p, bias, resid, C,
                                                                          hg, partial, ex);
  err = cudaGetLastError();
  if (err != cudaSuccess || pl.splits == 1) return err;
  const long long n = (long long)p.M * p.N;
  gemm_splitk_sum<EPI, bf16, O, TB><<<(unsigned)((n + RED_THREADS - 1) / RED_THREADS),
                                      RED_THREADS, 0, stream>>>(partial, bias, resid, C, n,
                                                                p.M, p.N, hg, pl.splits, ex);
  return cudaGetLastError();
}

// A plain (G = 1) K-major product's operands: A [M, K] row stride lda, B
// [K, N] row stride ldb.
inline BfGemm bf_gemm(const bf16* A, int lda, const bf16* B, int ldb, int hgb, int M, int N,
                      int K) {
  BfGemm p{};
  p.A = A;
  p.B = B;
  p.M = M;
  p.N = N;
  p.K = K;
  p.lda = lda;
  p.mdata = M;
  p.ones_row = -1;
  p.ldb = ldb;
  p.hgb = hgb;
  return p;
}

// One K-major product of K2.bf16, K3.bf16 or K6b.bf16 by its plan (five
// host ints, `grid` the persistent grid): the persistent kernel where the
// plan says wgmma 2 (B's gate width must be C's plane width hg), else
// launch_gemm_bf16.  Returns the launches' cudaError_t.
template <int EPI>
cudaError_t launch_product_bf16(const int* plan, int grid, const BfGemm& g, const bf16* bias,
                                const bf16* resid, bf16* C, int hg, float* partial,
                                cudaStream_t stream) {
  const BfPlan pl = bf_plan(plan);
  if (pl.wgmma == 2) {
    if (g.hgb != hg) return cudaErrorInvalidValue;
    return launch_gemm_bf16_persistent<EPI>(g.A, g.lda, g.B, g.ldb, hg, bias, resid, C, g.M,
                                            g.N, g.K, grid, stream);
  }
  return launch_gemm_bf16<true, EPI>(pl, g, bias, resid, C, hg, partial, stream);
}

}  // namespace
