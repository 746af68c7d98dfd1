// K5 and K8: flash attention over already-projected q / k / v, forward with
// its log-sum-exp, and the two backward kernels.
//
// Replaces the TPU kernels of multimodal_transformer_robustness_tpu/ops/:
//   * attention_pallas.py::_flash_fwd_impl (K5f, kernel body _flash_kernel):
//     softmax(q k^T + future-mask rule) v with the in-softmax position-hash
//     dropout, and lse = m + log(l) for the backward;
//   * attention_pallas_bwd.py::flash_attention_bwd, its two pallas_calls
//     _dq_kernel (K5dq) and _dkv_kernel (K5dkv), which recompute
//     p = exp(s - lse) tile by tile;
//   * attention_pallas.py::flash_attention_masked (K8, _flash_kpm_kernel):
//     the forward with a per-sample key-padding mask instead of the causal
//     rule, no dropout and no lse.  K8 is a second entry over K5f's kernel.
//
// Layout: q/out [B*H, Tq, D], k/v [B*H, Tk, D] row-major float32 (q already
// scaled); lse and delta = rowsum(dO * O) [B*H, Tq]; seeds int32 and rates
// float32 [B*H]; key_mask int32 [B, Tk] (1 = attend), shared by the heads
// of a sample.  The future-mask rule masks col - row >= offset; the key
// padding col >= Tk.  Masked weights are exactly 0 (the TPU kernel fills
// the finite -1e30 and lets a later tile's rescale wipe them; the result is
// the same for every row that sees at least one key, which the causal rule
// with offset >= 1 and K8's all-zero-row rewrite guarantee).
//
// Dropout: the keep bit of weight (row, col) is murmur3 fmix32 of
// seed ^ row*0x9E3779B1 ^ col*0x85EBCA77 (uint32 arithmetic), top 24 bits
// times 2^-24, kept where u >= rate, in global positions, so the forward
// and both backward kernels regenerate the same mask at any tiling and it
// equals the JAX package's _hash_uniform bit for bit.  The normalizer
// sums the raw p; only the value accumulation sees p * keep / (1 - rate).
//
// What bounds it on the H100: at the MOSEI stack shapes (T <= 64, D = 25)
// one 64-query tile meets one 64-key tile, about 4*64*64*25 FLOPs per
// 4 * 64 * 25 * 4 bytes moved, so the kernels are bound by bytes (q, k, v,
// dO read once, outputs written once: 0.2 ms for the forward at
// B*H = 32768).  At long T (2048) every q tile walks up to 32 k tiles and
// the float32 FMAs bound it (operations, 67 TFLOP/s on the CUDA cores).
// The design keeps the whole [64, 64] score tile, the running max and
// normalizer and the output accumulator on chip, so no [Tq, Tk] tensor
// touches device memory; each tile is staged once in shared memory,
// transposed with a row stride of 65 floats so that both the score product
// (reading along rows) and the value product (reading along columns) are
// free of bank conflicts; key tiles a causal query tile cannot see, and
// query tiles that cannot see a key tile in dkv, are skipped.  The products
// are float32 FMAs on the CUDA cores (tensor cores are later work).  No
// float atomics: dq loops over key tiles and dk/dv over query tiles inside
// one block each, so a rerun gives the same bits.
#include "common.cuh"

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

// K5f / K8.  One block per (b*h, 64-query tile); DJ = ceil(D / 16) output
// columns per thread.  key_mask null: the causal rule (if causal); LSE null:
// no log-sum-exp store (K8).
template <int DJ>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                 const float* __restrict__ V, const int* __restrict__ seeds,
                 const float* __restrict__ rates, const int* __restrict__ key_mask,
                 float* __restrict__ O, float* __restrict__ LSE, int H, int Tq, int Tk,
                 int D, int causal, int offset, int use_dropout) {
  extern __shared__ float smem[];
  float* qt = smem;                       // [D][LD] query tile
  float* kt = qt + D * FA_LD;             // [D][LD] key tile
  float* vt = kt + D * FA_LD;             // [D][LD] value tile
  float* ps = vt + D * FA_LD;             // [BQ][LD] weights for the value product
  int* kok = reinterpret_cast<int*>(ps + FA_BQ * FA_LD);  // [BK] key column valid

  const int bh = blockIdx.x, q0 = blockIdx.y * FA_BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long qoff = (long long)bh * Tq * D, koff = (long long)bh * Tk * D;
  const int* mrow = key_mask ? key_mask + (long long)(bh / H) * Tk : nullptr;
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
    if (tid < FA_BK) {
      const int c = k0 + tid;
      kok[tid] = c < Tk && (mrow == nullptr || mrow[c] > 0);
    }
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
    if (LSE != nullptr && tx == 0) LSE[(long long)bh * Tq + row] = m[i] + logf(l_safe);
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

// Shared memory per block, in bytes, and the launch itself; more than the
// card allows refuses the launch (the error comes back to the wrapper).
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int DJ>
cudaError_t launch_fwd(const float* q, const float* k, const float* v, const int* seeds,
                       const float* rates, const int* key_mask, float* out, float* lse,
                       int BH, int H, int Tq, int Tk, int D, int causal, int offset,
                       int use_dropout, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * (size_t)D * FA_LD + FA_BQ * FA_LD) +
                      sizeof(int) * FA_BK;
  cudaError_t err = prepare(flash_fwd_kernel<DJ>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tq + FA_BQ - 1) / FA_BQ);
  flash_fwd_kernel<DJ><<<grid, FA_THREADS, smem, stream>>>(
      q, k, v, seeds, rates, key_mask, out, lse, H, Tq, Tk, D, causal, offset, use_dropout);
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

// K5f (key_mask null, lse written) and K8 (key_mask [B, Tk], H heads per
// sample, causal 0, no dropout, lse null).  Each entry returns the
// launch's cudaError_t.
extern "C" int mmtr_flash_fwd(const float* q, const float* k, const float* v,
                              const int* seeds, const float* rates, const int* key_mask,
                              float* out, float* lse, int BH, int H, int Tq, int Tk, int D,
                              int causal, int offset, int use_dropout, void* stream_ptr) {
  FA_CASES(launch_fwd, q, k, v, seeds, rates, key_mask, out, lse, BH, H, Tq, Tk, D, causal,
           offset, use_dropout, (cudaStream_t)stream_ptr)
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
