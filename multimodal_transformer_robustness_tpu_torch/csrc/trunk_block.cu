// K9f / K9b: the fused residual block of a T==1 trunk layer, forward and
// backward.
//
// Replaces the TPU kernels of multimodal_transformer_robustness_tpu/ops/
// trunk_block_pallas.py: _make_block_fn's forward pallas_call (K9f, body
// _fwd_kernel) and its backward (K9b, _bwd_kernel), behind the library op
// fused_residual_block.  Same function, over rows of width E:
//
//   s  = LN(src, m_in)      masked LayerNorm: float32 moments over the
//                           channels where m_in is 1, biased variance,
//                           n = max(sum m_in, 1), output re-masked
//   a  = d_mid * act((s W1^T + b1) * m_mid)        act: identity or relu
//   y  = x + d_res * (m_out * (a W2^T + b2))
//
// W1 [F1, E], W2 [E, F1] in torch's [out, in] layout; the kernels read
// w1t = W1^T and w2t = W2^T (as the TPU kernel does) so the forward's
// column loops walk contiguous weight rows.  d_mid keeps (row, col / mid_rep)
// and d_res (row, col) where hash_uniform(seed, global row, col) >= rate,
// scaled by 1 / (1 - rate): the TPU kernel's draw, bit for bit, at any
// tiling, and regenerated in the backward instead of stored.
//
// K9f: one block per tile of 16 rows.  Warps take the rows' masked-LN
// moments; the LN'd tile s stays in shared memory; a thread per column of
// F1 takes s W1^T for the tile's 16 rows (float4 reads of s, 16
// accumulators), with bias, mask, act and dropout in its epilogue, into a
// second shared tile; a thread per column of E then takes a W2^T, with the
// output mask, residual dropout and residual in its epilogue.  Neither the
// [R, F1] hidden activation nor s touches device memory.
//
// K9b: the TPU kernel recomputed the forward in each row block and added
// dW1 = dp^T s, dW2 = dz^T a_d and the four column sums into output blocks
// that its sequential grid revisited.  Blocks here run in parallel and carry
// nothing, so the backward is two passes in one entry:
//   1. per 16-row tile: recompute s and a_d; dz = m_out * d_res * dout;
//      dp = m_mid * act' * d_mid * (dz W2); ds = dp W1; the masked-LN
//      backward to dsrc; per-tile column sums of dp, dz, ds*m*t and ds*m;
//      s, dz, a_d and dp go to device memory for the weight products.
//   2. dW1 and dW2 as transposed-A split-K products over the R rows
//      (common.cuh), and one fixed-order pass that adds the split and tile
//      partials: no float atomics, so a rerun gives the same bits.
// dx is dout itself; the wrapper returns it.
//
// What bounds it on the H100: the products, 4*R*E*F1 FLOPs forward (at
// R=4096, E=1000, F1=800: 13.1 GFLOP, 0.20 ms at 67 TFLOP/s float32 on the
// CUDA cores) against 4*(2*R*E + 2*E*F1) bytes (39 MB, 0.012 ms): operations.
// The backward does five such products.  This first form runs them as FMA
// loops from L2-resident weights; tensor cores are later work.
#include "common.cuh"

namespace {

constexpr int TB_ROWS = 16;      // rows per tile
constexpr int TB_THREADS = 256;  // 8 warps
constexpr int TB_WARPS = TB_THREADS / 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float keep_factor(int use, uint32_t seed, float rate,
                                             float keep_scale, int row, int col) {
  if (!use) return 1.f;
  return hash_uniform(seed, row, col) >= rate ? keep_scale : 0.f;
}

// Masked-LN of the tile's rows of src into S [TB_ROWS][EP] (zero past the
// last row and past column E); mean and 1/std per row into mu / inv.
__device__ void masked_ln_tile(float* S, float* mu_s, float* inv_s,
                               const float* __restrict__ src, const float* __restrict__ g,
                               const float* __restrict__ lb, const float* __restrict__ m,
                               int row0, int nrows, int E, int EP, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float msum = 0.f;
  for (int e = lane; e < E; e += 32) msum += m[e];
  const float n = fmaxf(warp_sum(msum), 1.0f);
  for (int r = warp; r < TB_ROWS; r += TB_WARPS) {
    float* srow = S + r * EP;
    if (r >= nrows) {
      for (int e = lane; e < EP; e += 32) srow[e] = 0.f;
      if (lane == 0) mu_s[r] = inv_s[r] = 0.f;
      continue;
    }
    const float* x = src + (long long)(row0 + r) * E;
    float sum = 0.f;
    for (int e = lane; e < E; e += 32) sum += x[e] * m[e];
    const float mu = warp_sum(sum) / n;
    float sq = 0.f;
    for (int e = lane; e < E; e += 32) {
      const float d = (x[e] - mu) * m[e];
      sq += d * d;
    }
    const float inv = rsqrtf(warp_sum(sq) / n + eps);
    for (int e = lane; e < EP; e += 32)
      srow[e] = e < E ? (((x[e] - mu) * inv) * g[e] + lb[e]) * m[e] : 0.f;
    if (lane == 0) {
      mu_s[r] = mu;
      inv_s[r] = inv;
    }
  }
}

// acc[r] = sum over k < K of A[r][k] * W[k * ldw + col] for the tile's rows:
// A in shared memory [TB_ROWS][KP] (KP = K rounded up to 4, zero padded),
// W in device memory, read along its contiguous column axis across threads.
__device__ __forceinline__ void tile_dot(float (&acc)[TB_ROWS], const float* A, int KP,
                                         const float* __restrict__ W, int K, int ldw,
                                         int col) {
#pragma unroll
  for (int r = 0; r < TB_ROWS; ++r) acc[r] = 0.f;
  for (int k = 0; k < KP; k += 4) {
    const float w0 = W[(long long)k * ldw + col];
    const float w1 = k + 1 < K ? W[(long long)(k + 1) * ldw + col] : 0.f;
    const float w2 = k + 2 < K ? W[(long long)(k + 2) * ldw + col] : 0.f;
    const float w3 = k + 3 < K ? W[(long long)(k + 3) * ldw + col] : 0.f;
#pragma unroll
    for (int r = 0; r < TB_ROWS; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(A + r * KP + k);
      acc[r] = fmaf(a.x, w0, acc[r]);
      acc[r] = fmaf(a.y, w1, acc[r]);
      acc[r] = fmaf(a.z, w2, acc[r]);
      acc[r] = fmaf(a.w, w3, acc[r]);
    }
  }
}

struct BlockArgs {
  int R, E, F1, act, mid_rep, use_dm, use_dr;
  uint32_t seed_mid, seed_res;
  float rate_mid, rate_res, eps;
};

__global__ void __launch_bounds__(TB_THREADS)
trunk_block_fwd_kernel(const float* __restrict__ x, const float* __restrict__ src,
                       const float* __restrict__ w1t, const float* __restrict__ b1,
                       const float* __restrict__ w2t, const float* __restrict__ b2,
                       const float* __restrict__ g, const float* __restrict__ lb,
                       const float* __restrict__ m_in, const float* __restrict__ m_mid,
                       const float* __restrict__ m_out, float* __restrict__ out,
                       BlockArgs p) {
  extern __shared__ __align__(16) float smem[];  // float4 reads
  const int E = p.E, F1 = p.F1;
  const int EP = (E + 3) & ~3, FP = (F1 + 3) & ~3;
  float* S = smem;                       // [TB_ROWS][EP]  LN(src)
  float* A = S + TB_ROWS * EP;           // [TB_ROWS][FP]  d_mid * act(...)
  __shared__ float mu_s[TB_ROWS], inv_s[TB_ROWS];
  const int row0 = blockIdx.x * TB_ROWS;
  const int nrows = min(TB_ROWS, p.R - row0);
  const float keep_mid = 1.0f / (1.0f - p.rate_mid), keep_res = 1.0f / (1.0f - p.rate_res);

  masked_ln_tile(S, mu_s, inv_s, src, g, lb, m_in, row0, nrows, E, EP, p.eps);
  for (int i = threadIdx.x; i < TB_ROWS * (FP - F1); i += TB_THREADS)
    A[(i / (FP - F1)) * FP + F1 + i % (FP - F1)] = 0.f;
  __syncthreads();

  float acc[TB_ROWS];
  for (int f = threadIdx.x; f < F1; f += TB_THREADS) {
    tile_dot(acc, S, EP, w1t, E, F1, f);
    const float bf = b1[f], mf = m_mid[f];
    const int col = p.mid_rep > 1 ? f / p.mid_rep : f;
#pragma unroll
    for (int r = 0; r < TB_ROWS; ++r) {
      const float u = (acc[r] + bf) * mf;
      const float a = p.act ? fmaxf(u, 0.f) : u;
      A[r * FP + f] = a * keep_factor(p.use_dm, p.seed_mid, p.rate_mid, keep_mid, row0 + r, col);
    }
  }
  __syncthreads();

  for (int c = threadIdx.x; c < E; c += TB_THREADS) {
    tile_dot(acc, A, FP, w2t, F1, E, c);
    const float bc = b2[c], mc = m_out[c];
#pragma unroll
    for (int r = 0; r < TB_ROWS; ++r) {   // unrolled: acc stays in registers
      if (r >= nrows) break;
      const long long at = (long long)(row0 + r) * E + c;
      const float y0 = ((acc[r] + bc) * mc) *
                       keep_factor(p.use_dr, p.seed_res, p.rate_res, keep_res, row0 + r, c);
      out[at] = x[at] + y0;
    }
  }
}

// Pass 1 of K9b.  part holds, per tile, the column sums over its rows of
// dp [F1], dz [E], ds*m*t [E] and ds*m [E], in that order.
__global__ void __launch_bounds__(TB_THREADS)
trunk_block_bwd_kernel(const float* __restrict__ src, const float* __restrict__ dout,
                       const float* __restrict__ w1t, const float* __restrict__ w1,
                       const float* __restrict__ w2, const float* __restrict__ b1,
                       const float* __restrict__ g, const float* __restrict__ lb,
                       const float* __restrict__ m_in, const float* __restrict__ m_mid,
                       const float* __restrict__ m_out, float* __restrict__ dsrc,
                       float* __restrict__ s_out, float* __restrict__ dz_out,
                       float* __restrict__ ad_out, float* __restrict__ dp_out,
                       float* __restrict__ part, BlockArgs p) {
  extern __shared__ __align__(16) float smem[];  // float4 reads
  const int E = p.E, F1 = p.F1;
  const int EP = (E + 3) & ~3, FP = (F1 + 3) & ~3;
  float* S = smem;                       // [TB_ROWS][EP]  s, later t
  float* Z = S + TB_ROWS * EP;           // [TB_ROWS][EP]  dz, later dtn = ds*m*g
  float* A = Z + TB_ROWS * EP;           // [TB_ROWS][FP]  d_mid*act'*m_mid, later dp
  __shared__ float mu_s[TB_ROWS], inv_s[TB_ROWS];
  const int row0 = blockIdx.x * TB_ROWS;
  const int nrows = min(TB_ROWS, p.R - row0);
  const float keep_mid = 1.0f / (1.0f - p.rate_mid), keep_res = 1.0f / (1.0f - p.rate_res);
  float* tile_part = part + (long long)blockIdx.x * (F1 + 3 * E);

  masked_ln_tile(S, mu_s, inv_s, src, g, lb, m_in, row0, nrows, E, EP, p.eps);
  for (int i = threadIdx.x; i < TB_ROWS * EP; i += TB_THREADS) {
    const int r = i / EP, c = i - r * EP;
    float dz = 0.f;
    if (r < nrows && c < E) {
      const long long at = (long long)(row0 + r) * E + c;
      dz = (dout[at] * keep_factor(p.use_dr, p.seed_res, p.rate_res, keep_res, row0 + r, c)) *
           m_out[c];
      dz_out[at] = dz;
    }
    Z[i] = dz;
  }
  for (int i = threadIdx.x; i < TB_ROWS * (FP - F1); i += TB_THREADS)
    A[(i / (FP - F1)) * FP + F1 + i % (FP - F1)] = 0.f;
  __syncthreads();
  for (int i = threadIdx.x; i < nrows * E; i += TB_THREADS)
    s_out[(long long)row0 * E + i] = S[(i / E) * EP + i % E];

  // recompute a_d = d_mid * act(u), u = (s W1^T + b1) * m_mid; keep the
  // factor dp / (dz W2) = d_mid * act'(u) * m_mid
  float acc[TB_ROWS];
  for (int f = threadIdx.x; f < F1; f += TB_THREADS) {
    tile_dot(acc, S, EP, w1t, E, F1, f);
    const float bf = b1[f], mf = m_mid[f];
    const int col = p.mid_rep > 1 ? f / p.mid_rep : f;
#pragma unroll
    for (int r = 0; r < TB_ROWS; ++r) {
      const float u = (acc[r] + bf) * mf;
      const float dm = keep_factor(p.use_dm, p.seed_mid, p.rate_mid, keep_mid, row0 + r, col);
      const float a = p.act ? fmaxf(u, 0.f) : u;
      if (r < nrows) ad_out[(long long)(row0 + r) * F1 + f] = a * dm;
      A[r * FP + f] = dm * ((p.act && !(u > 0.f)) ? 0.f : 1.f) * mf;
    }
  }
  __syncthreads();

  // dp = (dz W2) * factor, with its column sums
  for (int f = threadIdx.x; f < F1; f += TB_THREADS) {
    tile_dot(acc, Z, EP, w2, E, F1, f);
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < TB_ROWS; ++r) {
      const float dp = acc[r] * A[r * FP + f];
      A[r * FP + f] = dp;
      if (r < nrows) {
        dp_out[(long long)(row0 + r) * F1 + f] = dp;
        sum += dp;
      }
    }
    tile_part[f] = sum;
  }
  __syncthreads();

  // ds = dp W1; column sums of dz, ds*m*t and ds*m; t and dtn into S and Z
  for (int e = threadIdx.x; e < E; e += TB_THREADS) {
    tile_dot(acc, A, FP, w1, F1, E, e);
    const float me = m_in[e], ge = g[e];
    float sdz = 0.f, sdg = 0.f, sdb = 0.f;
#pragma unroll
    for (int r = 0; r < TB_ROWS; ++r) {
      if (r >= nrows) break;
      const float t = (src[(long long)(row0 + r) * E + e] - mu_s[r]) * inv_s[r];
      const float dsm = acc[r] * me;
      sdz += Z[r * EP + e];
      sdg += dsm * t;
      sdb += dsm;
      S[r * EP + e] = t;
      Z[r * EP + e] = dsm * ge;
    }
    tile_part[F1 + e] = sdz;
    tile_part[F1 + E + e] = sdg;
    tile_part[F1 + 2 * E + e] = sdb;
  }
  __syncthreads();

  // the masked-LN backward, one warp per row:
  // dsrc = m * inv * (dtn - mean(dtn) - t * mean(dtn * t)), means over n
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float msum = 0.f;
  for (int e = lane; e < E; e += 32) msum += m_in[e];
  const float n = fmaxf(warp_sum(msum), 1.0f);
  for (int r = warp; r < nrows; r += TB_WARPS) {
    const float* dtn = Z + r * EP;
    const float* t = S + r * EP;
    float s1 = 0.f, s2 = 0.f;
    for (int e = lane; e < E; e += 32) {
      s1 += dtn[e];
      s2 += dtn[e] * t[e];
    }
    const float mean1 = warp_sum(s1) / n, mean2 = warp_sum(s2) / n;
    float* d = dsrc + (long long)(row0 + r) * E;
    for (int e = lane; e < E; e += 32)
      d[e] = (m_in[e] * inv_s[r]) * (dtn[e] - mean1 - t[e] * mean2);
  }
}

int set_smem(const void* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

BlockArgs block_args(int R, int E, int F1, int act, int mid_rep, int use_dm, int use_dr,
                     int seed_mid, int seed_res, float rate_mid, float rate_res, float eps) {
  return BlockArgs{R, E, F1, act, mid_rep, use_dm, use_dr, (uint32_t)seed_mid,
                   (uint32_t)seed_res, rate_mid, rate_res, eps};
}

}  // namespace

extern "C" int mmtr_trunk_block_fwd(const float* x, const float* src, const float* w1t,
                                    const float* b1, const float* w2t, const float* b2,
                                    const float* g, const float* lb, const float* m_in,
                                    const float* m_mid, const float* m_out, float* out, int R,
                                    int E, int F1, int act, int mid_rep, int use_dm, int use_dr,
                                    int seed_mid, int seed_res, float rate_mid, float rate_res,
                                    float eps, void* stream_ptr) {
  const BlockArgs p = block_args(R, E, F1, act, mid_rep, use_dm, use_dr, seed_mid, seed_res,
                                 rate_mid, rate_res, eps);
  const size_t smem = sizeof(float) * TB_ROWS * (((E + 3) & ~3) + ((F1 + 3) & ~3));
  int err = set_smem((const void*)trunk_block_fwd_kernel, smem);
  if (err) return err;
  trunk_block_fwd_kernel<<<(R + TB_ROWS - 1) / TB_ROWS, TB_THREADS, smem,
                           (cudaStream_t)stream_ptr>>>(x, src, w1t, b1, w2t, b2, g, lb, m_in,
                                                       m_mid, m_out, out, p);
  return (int)cudaGetLastError();
}

// part [tiles, F1 + 3E] holds pass 1's tile sums and partial [splits, 2*E*F1]
// the split-K products; red [2*E*F1 + F1 + 3E] receives dW1 [F1, E],
// dW2 [E, F1], db1 [F1], db2 [E], dgamma [E], dbeta [E].
extern "C" int mmtr_trunk_block_bwd(const float* src, const float* dout, const float* w1t,
                                    const float* w1, const float* w2, const float* b1,
                                    const float* g, const float* lb, const float* m_in,
                                    const float* m_mid, const float* m_out, float* dsrc,
                                    float* s_buf, float* dz_buf, float* ad_buf, float* dp_buf,
                                    float* part, float* partial, float* red, int R, int E,
                                    int F1, int act, int mid_rep, int use_dm, int use_dr,
                                    int seed_mid, int seed_res, int kchunk, int splits,
                                    float rate_mid, float rate_res, float eps,
                                    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const BlockArgs p = block_args(R, E, F1, act, mid_rep, use_dm, use_dr, seed_mid, seed_res,
                                 rate_mid, rate_res, eps);
  const int tiles = (R + TB_ROWS - 1) / TB_ROWS;
  const size_t smem = sizeof(float) * TB_ROWS * (2 * ((E + 3) & ~3) + ((F1 + 3) & ~3));
  int err = set_smem((const void*)trunk_block_bwd_kernel, smem);
  if (err) return err;
  trunk_block_bwd_kernel<<<tiles, TB_THREADS, smem, stream>>>(
      src, dout, w1t, w1, w2, b1, g, lb, m_in, m_mid, m_out, dsrc, s_buf, dz_buf, ad_buf,
      dp_buf, part, p);
  cudaError_t cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return (int)cerr;

  const long long wsize = (long long)E * F1, total = 2 * wsize;
  launch_gemm_tn_splitk(dp_buf, s_buf, partial, F1, E, R, F1, E, kchunk, splits, total,
                        stream);
  launch_gemm_tn_splitk(dz_buf, ad_buf, partial + wsize, E, F1, R, E, F1, kchunk, splits,
                        total, stream);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return (int)cerr;
  splitk_reduce_kernel<<<(unsigned)((total + RED_THREADS - 1) / RED_THREADS), RED_THREADS, 0,
                         stream>>>(partial, red, total, splits);
  const long long nsum = F1 + 3LL * E;
  splitk_reduce_kernel<<<(unsigned)((nsum + RED_THREADS - 1) / RED_THREADS), RED_THREADS, 0,
                         stream>>>(part, red + total, nsum, tiles);
  return (int)cudaGetLastError();
}
