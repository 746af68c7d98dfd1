// K5: flash attention over already-projected q / k / v, forward with
// its log-sum-exp, and the backward (K5b at Tq, Tk <= 64; K5dq + K5dkv).
//
// Replaces the TPU kernels of multimodal_transformer_robustness_tpu/ops/:
//   * attention_pallas.py::_flash_fwd_impl (K5f, kernel body _flash_kernel):
//     softmax(q k^T + future-mask rule) v with the in-softmax position-hash
//     dropout, and lse = m + log(l) for the backward;
//   * attention_pallas_bwd.py::flash_attention_bwd, its two pallas_calls
//     _dq_kernel and _dkv_kernel and the XLA delta between them, which
//     recompute p = exp(s - lse) tile by tile: K5b, one fused pass a (b*h)
//     slice that computes delta itself, where both lengths are at most 64
//     (every MOSEI flash stack); K5dq and K5dkv (with delta = rowsum(dO * O)
//     from the caller) otherwise;
//
// Layout: q/out [B*H, Tq, D], k/v [B*H, Tk, D] row-major float32 (q already
// scaled); lse and delta = rowsum(dO * O) [B*H, Tq]; seeds int32 and rates
// float32 [B*H].  The future-mask rule masks col - row >= offset; the key
// padding col >= Tk.  Masked weights are exactly 0 (the TPU kernel fills
// the finite -1e30 and lets a later tile's rescale wipe them; the result is
// the same for every row that sees at least one key, which the causal rule
// with offset >= 1 guarantees).  K8, the key-padding forward, runs
// bert_attn.cu's kernels.
//
// Dropout: the keep bit of weight (row, col) is murmur3 fmix32 of
// seed ^ row*0x9E3779B1 ^ col*0x85EBCA77 (uint32 arithmetic), top 24 bits
// times 2^-24, kept where u >= rate, in global positions, so the forward
// and the backward kernels regenerate the same mask at any tiling and it
// equals the JAX package's _hash_uniform bit for bit.  The normalizer
// sums the raw p; only the value accumulation sees p * keep / (1 - rate).
//
// What bounds it on the H100: at the MOSEI stack shapes (T <= 64, D = 25)
// a slice's work is a few products of at most 64 x 64 x 25, about 2.5
// FLOPs (forward) to 6 (backward) per byte each kernel must move, far
// below the card's 49 float32 FLOPs a byte at the 3xTF32 tensor-core rate
// (165 TFLOP/s of float32-accurate products, 3.35 TB/s): the bound is
// bytes (q, k, v, dO, O, lse read once, outputs written once: 0.2 ms for
// the forward, 0.32 / 0.39 ms for K5b at the cross / self shapes at
// B*H = 32768).  At long T (2048) the products set the bound (operations).
// K5f, K5dq and K5dkv keep the whole [64, 64] score tile, the running
// max and normalizer and the output accumulator on chip, so no [Tq, Tk]
// tensor touches device memory; each tile is staged once in shared memory,
// transposed with a row stride of 65 floats so that both the score product
// (reading along rows) and the value product (reading along columns) are
// free of bank conflicts; key tiles a causal query tile cannot see, and
// query tiles that cannot see a key tile in dkv, are skipped.  Their
// products are float32 FMAs on the CUDA cores; K5b's (below) run on the
// tensor cores.  No float atomics: dq loops over key tiles and dk/dv over
// query tiles inside one block each, and K5b's block owns a slice, so a
// rerun gives the same bits.
#include "gemm_tc.cuh"

namespace {

constexpr int FA_BQ = 64;        // query rows per tile
constexpr int FA_BK = 64;        // key rows per tile
constexpr int FA_THREADS = 256;  // 16 x 16 threads, a 4 x 4 score micro-tile each
constexpr int FA_LD = 65;        // row stride of a transposed [D][64] tile
constexpr float FA_NEG_INF = -1e30f;

// The inverted-dropout factor M of weight (row, col): keep / (1 - rate).
__device__ __forceinline__ float keep_factor(int use_dropout, uint32_t seed, float rate,
                                             float keep_scale, int row, int col) {
  if (!use_dropout) return 1.f;
  return hash_uniform(seed, row, col) >= rate ? keep_scale : 0.f;
}

// Rows [t0, t0 + 64) of a row-major [T, D] matrix into dst[d * FA_LD + r],
// zero past row T.  The source rows are contiguous, so the reads coalesce.
__device__ __forceinline__ void load_tile_t(float* dst, const float* __restrict__ src,
                                            int t0, int T, int D) {
  const float* base = src + (long long)t0 * D;
  const int valid = min(FA_BQ, T - t0) * D;
  for (int i = threadIdx.x; i < FA_BQ * D; i += FA_THREADS) {
    const int r = i / D, d = i - r * D;
    dst[d * FA_LD + r] = i < valid ? base[i] : 0.f;
  }
}

// max / sum over the 16 lanes that share a score row
__device__ __forceinline__ float row_max16(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// K5f.  One block per (b*h, 64-query tile); DJ = ceil(D / 16) output
// columns per thread.
template <int DJ>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                 const float* __restrict__ V, const int* __restrict__ seeds,
                 const float* __restrict__ rates, float* __restrict__ O,
                 float* __restrict__ LSE, int Tq, int Tk, int D, int causal, int offset,
                 int use_dropout) {
  extern __shared__ float smem[];
  float* qt = smem;                       // [D][LD] query tile
  float* kt = qt + D * FA_LD;             // [D][LD] key tile
  float* vt = kt + D * FA_LD;             // [D][LD] value tile
  float* ps = vt + D * FA_LD;             // [BQ][LD] weights for the value product
  int* kok = reinterpret_cast<int*>(ps + FA_BQ * FA_LD);  // [BK] key column valid

  const int bh = blockIdx.x, q0 = blockIdx.y * FA_BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long qoff = (long long)bh * Tq * D, koff = (long long)bh * Tk * D;
  load_tile_t(qt, Q + qoff, q0, Tq, D);

  // the last query row of the tile sees columns < q_last + offset
  const int q_last = min(q0 + FA_BQ, Tq) - 1;
  const int k_end = causal ? min(Tk, q_last + offset) : Tk;
  const uint32_t seed = use_dropout ? (uint32_t)seeds[bh] : 0u;
  const float rate = use_dropout ? rates[bh] : 0.f;
  const float keep_scale = use_dropout ? 1.0f / (1.0f - rate) : 1.f;

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = FA_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  }

  for (int k0 = 0; k0 < k_end; k0 += FA_BK) {
    __syncthreads();  // the previous tile's reads are done
    load_tile_t(kt, K + koff, k0, Tk, D);
    load_tile_t(vt, V + koff, k0, Tk, D);
    if (tid < FA_BK) kok[tid] = k0 + tid < Tk;
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float* qd = qt + d * FA_LD;
      const float* kd = kt + d * FA_LD;
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qd[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = kd[tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      bool ok[4];
      float mx = FA_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        ok[j] = kok[tx + 16 * j] && (!causal || col - row < offset);
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max16(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        ps[(ty + 16 * i) * FA_LD + tx + 16 * j] =
            ok[j] ? p * keep_factor(use_dropout, seed, rate, keep_scale, row, col) : 0.f;
      }
      rs = row_sum16(rs);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

    const int nk = min(FA_BK, Tk - k0);
    for (int c = 0; c < nk; ++c) {
      float p[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * FA_LD + c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) vv[jj] = vt[min(tx + 16 * jj, D - 1) * FA_LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = fmaf(p[i], vv[jj], acc[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int d = tx + 16 * jj;
      if (d < D) O[qoff + (long long)row * D + d] = acc[i][jj] / l_safe;
    }
    if (tx == 0) LSE[(long long)bh * Tq + row] = m[i] + logf(l_safe);
  }
}

// K5dq.  One block per (b*h, 64-query tile), looping over the key tiles it
// sees: dS = p * (M * (dO V^T) - delta), dQ = dS K.
template <int DJ>
__global__ void __launch_bounds__(FA_THREADS)
flash_bwd_dq_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                    const float* __restrict__ V, const float* __restrict__ dO,
                    const float* __restrict__ LSE, const float* __restrict__ DELTA,
                    const int* __restrict__ seeds, const float* __restrict__ rates,
                    float* __restrict__ dQ, int Tq, int Tk, int D, int causal, int offset,
                    int use_dropout) {
  extern __shared__ float smem[];
  float* qt = smem;
  float* dot = qt + D * FA_LD;
  float* kt = dot + D * FA_LD;
  float* vt = kt + D * FA_LD;
  float* dss = vt + D * FA_LD;  // [BQ][LD] dS tile

  const int bh = blockIdx.x, q0 = blockIdx.y * FA_BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long qoff = (long long)bh * Tq * D, koff = (long long)bh * Tk * D;
  load_tile_t(qt, Q + qoff, q0, Tq, D);
  load_tile_t(dot, dO + qoff, q0, Tq, D);

  float lse_r[4], del_r[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < Tq ? LSE[(long long)bh * Tq + row] : 0.f;
    del_r[i] = row < Tq ? DELTA[(long long)bh * Tq + row] : 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  }
  const int q_last = min(q0 + FA_BQ, Tq) - 1;
  const int k_end = causal ? min(Tk, q_last + offset) : Tk;
  const uint32_t seed = use_dropout ? (uint32_t)seeds[bh] : 0u;
  const float rate = use_dropout ? rates[bh] : 0.f;
  const float keep_scale = use_dropout ? 1.0f / (1.0f - rate) : 1.f;

  for (int k0 = 0; k0 < k_end; k0 += FA_BK) {
    __syncthreads();
    load_tile_t(kt, K + koff, k0, Tk, D);
    load_tile_t(vt, V + koff, k0, Tk, D);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], b[4], a2[4], b2[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qt[d * FA_LD + ty + 16 * i];
        a2[i] = dot[d * FA_LD + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = kt[d * FA_LD + tx + 16 * j];
        b2[j] = vt[d * FA_LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(a2[i], b2[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = row < Tq && col < Tk && (!causal || col - row < offset);
        float ds = 0.f;
        if (ok) {
          const float p = expf(s[i][j] - lse_r[i]);
          const float mk = keep_factor(use_dropout, seed, rate, keep_scale, row, col);
          ds = p * (dp[i][j] * mk - del_r[i]);
        }
        dss[(ty + 16 * i) * FA_LD + tx + 16 * j] = ds;
      }
    }
    __syncthreads();

    const int nk = min(FA_BK, Tk - k0);
    for (int c = 0; c < nk; ++c) {
      float a[4], kk[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = dss[(ty + 16 * i) * FA_LD + c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) kk[jj] = kt[min(tx + 16 * jj, D - 1) * FA_LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = fmaf(a[i], kk[jj], acc[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tq) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int d = tx + 16 * jj;
      if (d < D) dQ[qoff + (long long)row * D + d] = acc[i][jj];
    }
  }
}

// K5dkv.  One block per (b*h, 64-key tile), looping over the query tiles
// that can see it: dV = (M p)^T dO, dK = dS^T Q.  A thread holds key rows
// ty + 16i and query columns tx + 16j of the transposed score tile.
template <int DJ>
__global__ void __launch_bounds__(FA_THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                     const float* __restrict__ V, const float* __restrict__ dO,
                     const float* __restrict__ LSE, const float* __restrict__ DELTA,
                     const int* __restrict__ seeds, const float* __restrict__ rates,
                     float* __restrict__ dK, float* __restrict__ dV, int Tq, int Tk, int D,
                     int causal, int offset, int use_dropout) {
  extern __shared__ float smem[];
  float* kt = smem;
  float* vt = kt + D * FA_LD;
  float* qt = vt + D * FA_LD;
  float* dot = qt + D * FA_LD;
  float* ts = dot + D * FA_LD;       // [BK][LD]: (M p)^T, then dS^T
  float* lse_s = ts + FA_BK * FA_LD;  // [BQ]
  float* del_s = lse_s + FA_BQ;       // [BQ]

  const int bh = blockIdx.x, k0 = blockIdx.y * FA_BK;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long qoff = (long long)bh * Tq * D, koff = (long long)bh * Tk * D;
  load_tile_t(kt, K + koff, k0, Tk, D);
  load_tile_t(vt, V + koff, k0, Tk, D);
  const uint32_t seed = use_dropout ? (uint32_t)seeds[bh] : 0u;
  const float rate = use_dropout ? rates[bh] : 0.f;
  const float keep_scale = use_dropout ? 1.0f / (1.0f - rate) : 1.f;

  float dk[4][DJ], dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) dk[i][jj] = dv[i][jj] = 0.f;

  // the first query row that sees column k0 is k0 - offset + 1
  const int q_begin = causal ? max(0, k0 - offset + 1) / FA_BQ * FA_BQ : 0;
  for (int q0 = q_begin; q0 < Tq; q0 += FA_BQ) {
    __syncthreads();
    load_tile_t(qt, Q + qoff, q0, Tq, D);
    load_tile_t(dot, dO + qoff, q0, Tq, D);
    if (tid < FA_BQ) {
      const int r = q0 + tid;
      lse_s[tid] = r < Tq ? LSE[(long long)bh * Tq + r] : 0.f;
      del_s[tid] = r < Tq ? DELTA[(long long)bh * Tq + r] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], b[4], a2[4], b2[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = kt[d * FA_LD + ty + 16 * i];
        a2[i] = vt[d * FA_LD + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = qt[d * FA_LD + tx + 16 * j];
        b2[j] = dot[d * FA_LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(a2[i], b2[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = k0 + ty + 16 * i;  // key index
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + tx + 16 * j;  // query index
        const bool ok = row < Tq && col < Tk && (!causal || col - row < offset);
        float pm = 0.f, ds = 0.f;
        if (ok) {
          const float p = expf(s[i][j] - lse_s[tx + 16 * j]);
          const float mk = keep_factor(use_dropout, seed, rate, keep_scale, row, col);
          pm = p * mk;
          ds = p * (dp[i][j] * mk - del_s[tx + 16 * j]);
        }
        ts[(ty + 16 * i) * FA_LD + tx + 16 * j] = pm;
        s[i][j] = ds;
      }
    }
    __syncthreads();

    const int nq = min(FA_BQ, Tq - q0);
    for (int r = 0; r < nq; ++r) {
      float a[4], o[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ts[(ty + 16 * i) * FA_LD + r];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) o[jj] = dot[min(tx + 16 * jj, D - 1) * FA_LD + r];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) dv[i][jj] = fmaf(a[i], o[jj], dv[i][jj]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ts[(ty + 16 * i) * FA_LD + tx + 16 * j] = s[i][j];
    __syncthreads();
    for (int r = 0; r < nq; ++r) {
      float a[4], qq[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ts[(ty + 16 * i) * FA_LD + r];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) qq[jj] = qt[min(tx + 16 * jj, D - 1) * FA_LD + r];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) dk[i][jj] = fmaf(a[i], qq[jj], dk[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= Tk) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int d = tx + 16 * jj;
      if (d < D) {
        dK[koff + (long long)c * D + d] = dk[i][jj];
        dV[koff + (long long)c * D + d] = dv[i][jj];
      }
    }
  }
}

// K5b: the whole backward of one (b*h) slice in one pass, for Tq, Tk <= 64,
// its five products on the tensor cores in 3xTF32 (mma.sync m16n8k8 from
// gemm_tc.cuh, operands split into TF32 hi + lo: float32 accuracy).  It
// reads each input once and writes each output once, where K5dq + K5dkv
// read q, k, v, dO twice, recompute S, dP', p and the hash twice and need
// the delta op before them.  A persistent block walks slices u =
// blockIdx.x, + gridDim.x, ...; it owns a slice's dq, dk and dv outright (no
// atomics, the same bits on a rerun).  Shared memory: one slice's q, dO, O
// [qp8][ld], k, v [kp8][ld], lse [qp8] and (seed, rate), zero-filled past
// the slice and staged by 4-byte cp.async (a [T][25] slice starts only
// 8-byte aligned); then the M*p tile [qp8][ldp] and the dS tile
// [16*mq][ldp].  One slot, so that FB_BLOCKS_PER_SM (3) blocks fit an SM at
// the MOSEI shapes; a second slot, the next slice in flight, would cost a
// block, and ran slower in every trial.  Row strides: ld = 4 mod 8 words
// and ldp = 8 mod 32, so the fragment loads of the score products and of
// dV / dK are free of bank conflicts (those of dQ and the value operands of phase 2 meet two-way
// conflicts).  A 16-row fragment may read past qp8 into the next operand:
// those rows are past Tq, and what they make is dropped.
//   phase 1: a warp per (16-row tile, group of ng1 8-key tiles): S = Q K^T
//            and dP' = dO V^T, delta = rowsum(dO * O) for its rows, then per
//            pair p = exp(s - lse), M from the hash, once, and M*p and dS =
//            p * (M*dP' - delta) into the tiles (0 where the causal rule or
//            the slice's edge hides the pair); tiles the rule hides whole
//            are not multiplied;
//   phase 2: a warp per unit of 16 output rows x 16 columns: dV = (M p)^T dO
//            and dK = dS^T Q over the rows that see the unit's keys, dQ = dS
//            K over the keys its rows see; each output written once.
// Bound: bytes (0.32 / 0.39 ms at the MOSEI cross / self shapes, B*H =
// 32768); the products are ~0.08 ms at the 3xTF32 rate.  What holds it
// above that is the instruction stream: the staging and the two phases take
// their times one after another, with little overlap between the blocks of
// an SM, and the 3xTF32 correction MMAs are a fifth of the whole (PERF.md,
// tools/k5b_trials.py).
struct FbDims {
  int Tq, Tk, D, dp4, ld, qp8, kp8, mq, mk, nk, ldp, ng1, causal, offset, use_dropout, buf;
};

// FB_BLOCKS_PER_SM, the launch bound below, comes from the build's flags
// (_build.FB_BLOCKS_PER_SM), which the plan sizes its grid by too.
constexpr int FB_THREADS = 256;
constexpr int FB_WARPS = FB_THREADS / 32;

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Rows [0, n) of a row-major [n][D] slice into dst[r * ld + c], rows n ..
// fill-1 and columns D .. 4*dp4-1 zero: a warp a row, lanes over columns,
// the pointers stepped from row to row so a copy costs a few instructions.
__device__ __forceinline__ void fb_stage_rows(float* dst, const float* src, int n, int fill,
                                              const FbDims& d) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c = lane; c < 4 * d.dp4; c += 32) {
    const bool col_ok = c < d.D;
    const float* sp = col_ok ? src + (long long)warp * d.D + c : src;
    const long long sstep = col_ok ? (long long)FB_WARPS * d.D : 0;
    float* dp_ = dst + warp * d.ld + c;
    int r = warp;
    for (; r < n; r += FB_WARPS, sp += sstep, dp_ += FB_WARPS * d.ld)
      cp_async4(dp_, sp, col_ok);
    for (; r < fill; r += FB_WARPS, dp_ += FB_WARPS * d.ld) cp_async4(dp_, src, false);
  }
}

__device__ __forceinline__ void fb_stage_slice(float* buf, const float* Q, const float* K,
                                               const float* V, const float* dO,
                                               const float* O, const float* LSE,
                                               const int* seeds, const float* rates, int u,
                                               const FbDims& d) {
  float* qs = buf;
  float* dos = qs + d.qp8 * d.ld;
  float* os = dos + d.qp8 * d.ld;
  float* ks = os + d.qp8 * d.ld;
  float* vs = ks + d.kp8 * d.ld;
  float* ls = vs + d.kp8 * d.ld;
  const long long qo = (long long)u * d.Tq * d.D, ko = (long long)u * d.Tk * d.D;
  fb_stage_rows(qs, Q + qo, d.Tq, d.qp8, d);
  fb_stage_rows(dos, dO + qo, d.Tq, d.qp8, d);
  fb_stage_rows(os, O + qo, d.Tq, d.qp8, d);
  fb_stage_rows(ks, K + ko, d.Tk, d.kp8, d);
  fb_stage_rows(vs, V + ko, d.Tk, d.kp8, d);
  const float* lrow = LSE + (long long)u * d.Tq;
  for (int i = threadIdx.x; i < d.qp8; i += FB_THREADS)
    cp_async4(ls + i, i < d.Tq ? lrow + i : lrow, i < d.Tq);
  if (d.use_dropout && threadIdx.x == 0) {
    cp_async4(ls + d.qp8, seeds + u, true);
    cp_async4(ls + d.qp8 + 1, rates + u, true);
  }
}

// The A fragment (16 x 8, row-major) of rows m0.., columns k0.. of a
// matrix at p[row * sr + col * sc], split into TF32 hi / lo.
__device__ __forceinline__ void fb_frag_a(const float* p, int sr, int sc, int m0, int k0,
                                          uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int g = (threadIdx.x % 32) >> 2, t = threadIdx.x & 3;
  const float* b = p + (m0 + g) * sr + (k0 + t) * sc;
  split_tf32(b[0], hi[0], lo[0]);
  split_tf32(b[8 * sr], hi[1], lo[1]);
  split_tf32(b[4 * sc], hi[2], lo[2]);
  split_tf32(b[8 * sr + 4 * sc], hi[3], lo[3]);
}

// The B fragment (8 x 8) of B(k, n) = p[k * sk + n * sn], k0.., n0...
__device__ __forceinline__ void fb_frag_b(const float* p, int sk, int sn, int k0, int n0,
                                          uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const int g = (threadIdx.x % 32) >> 2, t = threadIdx.x & 3;
  const float* b = p + (k0 + t) * sk + (n0 + g) * sn;
  split_tf32(b[0], hi[0], lo[0]);
  split_tf32(b[4 * sk], hi[1], lo[1]);
}

// c += a b in 3xTF32 (lo*hi + hi*lo + hi*hi; lo*lo dropped)
__device__ __forceinline__ void fb_mma3(float (&c)[4], const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                        const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// Phase 1 for one warp: rows m0 .. m0+15, key tiles nt0 .. nt0+ng1-1 of 8
// keys (fewer at the slice's edge; ng1 <= 4).
__device__ __forceinline__ void fb_scores(const float* qs, const float* dos, const float* os,
                                          const float* ks, const float* vs, const float* ls,
                                          float* pm_t, float* ds_t, const FbDims& d, int m0,
                                          int nt0, uint32_t seed, float rate,
                                          float keep_scale) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int ld = d.ld, ng = min(d.ng1, d.nk - nt0);
  const int r0 = m0 + g, r1 = r0 + 8;
  // delta of rows r0 and r1: the four lanes of a row split its columns
  float del0 = 0.f, del1 = 0.f;
  for (int c = 4 * t; c < 4 * d.dp4; c += 16) {
    del0 = dot4(ld4(dos + r0 * ld + c), ld4(os + r0 * ld + c), del0);
    del1 = dot4(ld4(dos + r1 * ld + c), ld4(os + r1 * ld + c), del1);
  }
  del0 += __shfl_xor_sync(0xffffffffu, del0, 1);
  del0 += __shfl_xor_sync(0xffffffffu, del0, 2);
  del1 += __shfl_xor_sync(0xffffffffu, del1, 1);
  del1 += __shfl_xor_sync(0xffffffffu, del1, 2);
  bool live[4];
  float s[4][4], dp[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // the tile's first key against its last row
    live[j] = j < ng && (!d.causal || 8 * (nt0 + j) - (m0 + 15) < d.offset);
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
  }
#pragma unroll 2
  for (int k0 = 0; k0 < 4 * d.dp4; k0 += 8) {
    uint32_t qh[4], ql[4], oh[4], ol[4];
    fb_frag_a(qs, ld, 1, m0, k0, qh, ql);
    fb_frag_a(dos, ld, 1, m0, k0, oh, ol);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!live[j]) continue;
      uint32_t bh[2], bl[2];
      fb_frag_b(ks, 1, ld, k0, 8 * (nt0 + j), bh, bl);
      fb_mma3(s[j], qh, ql, bh, bl);
      fb_frag_b(vs, 1, ld, k0, 8 * (nt0 + j), bh, bl);
      fb_mma3(dp[j], oh, ol, bh, bl);
    }
  }
  const float lse0 = r0 < d.Tq ? ls[r0] : 0.f, lse1 = r1 < d.Tq ? ls[r1] : 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= ng) break;
    float pm[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? r0 : r1, col = 8 * (nt0 + j) + 2 * t + (e & 1);
      const bool ok = live[j] && row < d.Tq && col < d.Tk &&
                      (!d.causal || col - row < d.offset);
      pm[e] = ds[e] = 0.f;
      if (ok) {
        const float p = __expf(s[j][e] - (e < 2 ? lse0 : lse1));
        const float mk = keep_factor(d.use_dropout, seed, rate, keep_scale, row, col);
        pm[e] = p * mk;
        ds[e] = p * (dp[j][e] * mk - (e < 2 ? del0 : del1));
      }
    }
    const int c = 8 * (nt0 + j) + 2 * t;
    *reinterpret_cast<float2*>(ds_t + r0 * d.ldp + c) = make_float2(ds[0], ds[1]);
    *reinterpret_cast<float2*>(ds_t + r1 * d.ldp + c) = make_float2(ds[2], ds[3]);
    *reinterpret_cast<float2*>(pm_t + r0 * d.ldp + c) = make_float2(pm[0], pm[1]);
    if (r1 < d.qp8)   // the M*p tile holds qp8 rows (dV reads no more)
      *reinterpret_cast<float2*>(pm_t + r1 * d.ldp + c) = make_float2(pm[2], pm[3]);
  }
}

// Phase 2 for one warp: out[m0 .. m0+15][n0 .. n0+15] (two 8-column tiles,
// the second only if n0 + 8 < 4*dp4) = sum over k in [k_lo, k_hi) (steps
// of 8) of A(m, k) B(k, n), A(m, k) = a[m * asr + k * asc], B(k, n) =
// b[k * ld + n]; written to dst[m * D + n] for m < m_end, n < D.
__device__ __forceinline__ void fb_product(const float* a, int asr, int asc, const float* b,
                                           int ld, int m0, int n0, int k_lo, int k_hi,
                                           bool two, float* dst, int m_end, int D) {
  // the three TF32 products of each tile in chains of their own (the MMA's
  // latency, not its rate, would bound one chain), added at the end
  float c[2][4], ca[2][4], cb[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = ca[j][e] = cb[j][e] = 0.f;
#pragma unroll 2
  for (int k0 = k_lo; k0 < k_hi; k0 += 8) {
    uint32_t ah[4], al[4], bh[2], bl[2];
    fb_frag_a(a, asr, asc, m0, k0, ah, al);
    fb_frag_b(b, ld, 1, k0, n0, bh, bl);
    mma_tf32(ca[0], al, bh);
    mma_tf32(cb[0], ah, bl);
    mma_tf32(c[0], ah, bh);
    if (two) {
      fb_frag_b(b, ld, 1, k0, n0 + 8, bh, bl);
      mma_tf32(ca[1], al, bh);
      mma_tf32(cb[1], ah, bl);
      mma_tf32(c[1], ah, bh);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] += ca[j][e] + cb[j][e];
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + g + (e < 2 ? 0 : 8), n = n0 + 8 * j + 2 * t + (e & 1);
      if (m < m_end && n < D && (j == 0 || two)) dst[(long long)m * D + n] = c[j][e];
    }
  }
}

__global__ void __launch_bounds__(FB_THREADS, FB_BLOCKS_PER_SM)
flash_bwd_fused_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                       const float* __restrict__ V, const float* __restrict__ dO,
                       const float* __restrict__ O, const float* __restrict__ LSE,
                       const int* __restrict__ seeds, const float* __restrict__ rates,
                       float* __restrict__ dQ, float* __restrict__ dK, float* __restrict__ dV,
                       int units, FbDims d) {
  extern __shared__ float4 fb_smem4[];
  float* smem = reinterpret_cast<float*>(fb_smem4);
  const int ld = d.ld, ldp = d.ldp, Tq = d.Tq, Tk = d.Tk, D = d.D;
  float* pm_t = smem + d.buf;          // [qp8][ldp] M * p
  float* ds_t = pm_t + d.qp8 * ldp;    // [16 mq][ldp] dS
  const int warp = threadIdx.x / 32;
  const int n_items = d.mq * ((d.nk + d.ng1 - 1) / d.ng1);   // phase 1
  const int ngr = (d.dp4 + 3) / 4;   // phase 2's 16-column groups
  const int n_kv = d.mk * ngr, n_units = 2 * n_kv + d.mq * ngr;

  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    fb_stage_slice(smem, Q, K, V, dO, O, LSE, seeds, rates, u, d);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();   // slice u landed, from every thread's copies
    const float* qs = smem;
    const float* dos = qs + d.qp8 * ld;
    const float* os = dos + d.qp8 * ld;
    const float* ks = os + d.qp8 * ld;
    const float* vs = ks + d.kp8 * ld;
    const float* ls = vs + d.kp8 * ld;
    const uint32_t seed = d.use_dropout ? __float_as_uint(ls[d.qp8]) : 0u;
    const float rate = d.use_dropout ? ls[d.qp8 + 1] : 0.f;
    const float keep_scale = d.use_dropout ? 1.0f / (1.0f - rate) : 1.f;

    for (int w = warp; w < n_items; w += FB_WARPS) {
      const int mt = w % d.mq, ngrp = w / d.mq;
      fb_scores(qs, dos, os, ks, vs, ls, pm_t, ds_t, d, 16 * mt, ngrp * d.ng1, seed, rate,
                keep_scale);
    }
    __syncthreads();   // the M*p and dS tiles are whole

    const long long qo = (long long)u * Tq * D, ko = (long long)u * Tk * D;
    for (int w = warp; w < n_units; w += FB_WARPS) {
      const int kind = w < n_kv ? 0 : (w < 2 * n_kv ? 1 : 2);
      const int x = w - kind * n_kv;
      const int mt = x / ngr, n0 = 16 * (x - mt * ngr), m0 = 16 * mt;
      const bool two = n0 + 8 < 4 * d.dp4;
      if (kind < 2) {
        // dV (kind 0) or dK (1): keys m0.., rows from the first that sees m0
        const int k_lo = d.causal ? max(0, m0 - d.offset + 1) & ~7 : 0;
        fb_product(kind ? ds_t : pm_t, 1, ldp, kind ? qs : dos, ld, m0, n0, k_lo, d.qp8, two,
                   (kind ? dK : dV) + ko, Tk, D);
      } else {
        // dQ: rows m0.., keys up to the last its rows see
        const int k_hi = d.causal ? min(d.kp8, (m0 + 15 + d.offset + 7) & ~7) : d.kp8;
        fb_product(ds_t, ldp, 1, ks, ld, m0, n0, 0, k_hi, two, dQ + qo, Tq, D);
      }
    }
    __syncthreads();   // the slot and the tiles are refilled next iteration
  }
}

// K5b's launch from the plan (ops/attention_cuda._plan_flash_bwd), host
// ints: path (0: K5b; anything else is refused here), blocks (the
// persistent grid), smem bytes, then dp4, ld, qp8, kp8, mq, mk, nk, ldp,
// ng1 as FbDims names them.
cudaError_t launch_fused_bwd(const float* q, const float* k, const float* v,
                             const float* dout, const float* out, const float* lse,
                             const int* seeds, const float* rates, float* dq, float* dk,
                             float* dv, int BH, int Tq, int Tk, int D, int causal, int offset,
                             int use_dropout, const int* plan, cudaStream_t stream) {
  const int path = plan[0], blocks = plan[1], smem = plan[2];
  const FbDims d{Tq, Tk, D, plan[3], plan[4], plan[5], plan[6], plan[7], plan[8], plan[9],
                 plan[10], plan[11], causal, offset, use_dropout,
                 plan[4] * (3 * plan[5] + 2 * plan[6]) + plan[5] + 4};
  if (path != 0 || Tq > 64 || Tk > 64 || blocks < 1 || d.dp4 % 2 || d.ng1 < 1 || d.ng1 > 4)
    return cudaErrorInvalidValue;
  static unsigned long long set = 0;
  const cudaError_t err = allow_smem_once((const void*)flash_bwd_fused_kernel, &set);
  if (err != cudaSuccess) return err;
  flash_bwd_fused_kernel<<<blocks, FB_THREADS, smem, stream>>>(
      q, k, v, dout, out, lse, seeds, rates, dq, dk, dv, BH, d);
  return cudaGetLastError();
}

// Shared memory per block, in bytes, and the launch itself; more than the
// card allows refuses the launch (the error comes back to the wrapper).
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int DJ>
cudaError_t launch_fwd(const float* q, const float* k, const float* v, const int* seeds,
                       const float* rates, float* out, float* lse, int BH, int Tq, int Tk,
                       int D, int causal, int offset, int use_dropout, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * (size_t)D * FA_LD + FA_BQ * FA_LD) +
                      sizeof(int) * FA_BK;
  cudaError_t err = prepare(flash_fwd_kernel<DJ>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tq + FA_BQ - 1) / FA_BQ);
  flash_fwd_kernel<DJ><<<grid, FA_THREADS, smem, stream>>>(
      q, k, v, seeds, rates, out, lse, Tq, Tk, D, causal, offset, use_dropout);
  return cudaGetLastError();
}

template <int DJ>
cudaError_t launch_dq(const float* q, const float* k, const float* v, const float* dout,
                      const float* lse, const float* delta, const int* seeds,
                      const float* rates, float* dq, int BH, int Tq, int Tk, int D,
                      int causal, int offset, int use_dropout, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * (size_t)D * FA_LD + FA_BQ * FA_LD);
  cudaError_t err = prepare(flash_bwd_dq_kernel<DJ>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tq + FA_BQ - 1) / FA_BQ);
  flash_bwd_dq_kernel<DJ><<<grid, FA_THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, seeds, rates, dq, Tq, Tk, D, causal, offset, use_dropout);
  return cudaGetLastError();
}

template <int DJ>
cudaError_t launch_dkv(const float* q, const float* k, const float* v, const float* dout,
                       const float* lse, const float* delta, const int* seeds,
                       const float* rates, float* dk, float* dv, int BH, int Tq, int Tk,
                       int D, int causal, int offset, int use_dropout,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * (size_t)D * FA_LD + FA_BK * FA_LD + 2 * FA_BQ);
  cudaError_t err = prepare(flash_bwd_dkv_kernel<DJ>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tk + FA_BK - 1) / FA_BK);
  flash_bwd_dkv_kernel<DJ><<<grid, FA_THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, seeds, rates, dk, dv, Tq, Tk, D, causal, offset,
      use_dropout);
  return cudaGetLastError();
}

}  // namespace

// DJ = ceil(D / 16) rounded up to 1, 2, 4 or 8 (a thread's spare columns
// past D are neither read nor written), so D <= 128; a wider D is refused
// with cudaErrorInvalidValue.  Four instances of each kernel keep the build
// short.
#define FA_CASES(FN, ...)                                \
  switch ((D + 15) / 16) {                               \
    case 1: return (int)FN<1>(__VA_ARGS__);              \
    case 2: return (int)FN<2>(__VA_ARGS__);              \
    case 3: case 4: return (int)FN<4>(__VA_ARGS__);      \
    case 5: case 6: case 7: case 8:                      \
      return (int)FN<8>(__VA_ARGS__);                    \
    default: return (int)cudaErrorInvalidValue;          \
  }

// K5f: out [B*H, Tq, D] and lse [B*H, Tq].  Each entry returns the
// launch's cudaError_t.
extern "C" int mmtr_flash_fwd(const float* q, const float* k, const float* v,
                              const int* seeds, const float* rates, float* out, float* lse,
                              int BH, int Tq, int Tk, int D, int causal, int offset,
                              int use_dropout, void* stream_ptr) {
  FA_CASES(launch_fwd, q, k, v, seeds, rates, out, lse, BH, Tq, Tk, D, causal, offset,
           use_dropout, (cudaStream_t)stream_ptr)
}

// K5dq: dq [B*H, Tq, D] from q, k, v, dout, lse and delta.
extern "C" int mmtr_flash_bwd_dq(const float* q, const float* k, const float* v,
                                 const float* dout, const float* lse, const float* delta,
                                 const int* seeds, const float* rates, float* dq, int BH,
                                 int Tq, int Tk, int D, int causal, int offset,
                                 int use_dropout, void* stream_ptr) {
  FA_CASES(launch_dq, q, k, v, dout, lse, delta, seeds, rates, dq, BH, Tq, Tk, D, causal,
           offset, use_dropout, (cudaStream_t)stream_ptr)
}

// K5dkv: dk and dv [B*H, Tk, D].
extern "C" int mmtr_flash_bwd_dkv(const float* q, const float* k, const float* v,
                                  const float* dout, const float* lse, const float* delta,
                                  const int* seeds, const float* rates, float* dk, float* dv,
                                  int BH, int Tq, int Tk, int D, int causal, int offset,
                                  int use_dropout, void* stream_ptr) {
  FA_CASES(launch_dkv, q, k, v, dout, lse, delta, seeds, rates, dk, dv, BH, Tq, Tk, D,
           causal, offset, use_dropout, (cudaStream_t)stream_ptr)
}

// K5b: dq, dk and dv in one launch from q, k, v, dout, out and lse (delta
// computed inside), Tq, Tk <= 64; plan as launch_fused_bwd's.
extern "C" int mmtr_flash_bwd(const float* q, const float* k, const float* v,
                              const float* dout, const float* out, const float* lse,
                              const int* seeds, const float* rates, float* dq, float* dk,
                              float* dv, int BH, int Tq, int Tk, int D, int causal,
                              int offset, int use_dropout, const int* plan,
                              void* stream_ptr) {
  return (int)launch_fused_bwd(q, k, v, dout, out, lse, seeds, rates, dq, dk, dv, BH, Tq, Tk,
                               D, causal, offset, use_dropout, plan,
                               (cudaStream_t)stream_ptr);
}
