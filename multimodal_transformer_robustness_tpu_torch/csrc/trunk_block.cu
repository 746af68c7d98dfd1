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
// W1 [F1, E], W2 [E, F1] in torch's [out, in] layout, read as they are:
// the forward's products take them as B [N, K] (gemm_tc.cuh's BT), the
// backward's as B [K, N].  d_mid keeps (row, col / mid_rep) and d_res
// (row, col) where hash_uniform(seed, global row, col) >= rate, scaled by
// 1 / (1 - rate): the TPU kernel's draw, bit for bit, at any tiling, and
// regenerated in the backward instead of stored.
//
// What bounds it on the H100: the products, 4*R*E*F1 FLOPs forward (at
// R=4096, E=1000, F1=800: 13.1 GFLOP, 0.079 ms at the 165 TFLOP/s of
// float32-accurate 3xTF32 tensor-core products) against 4*(3*R*E + 2*E*F1)
// bytes (39 MB, 0.012 ms): operations.  The backward does five such
// products (0.199 ms).  A 128-row tile of s at E = 1000 is 512 KB, more than
// an SM holds, so the TPU kernel's one pass (LN'd tile and hidden tile kept
// on chip) cannot feed tensor cores here.  So each half is row passes plus
// products on gemm_tc.cuh's 3xTF32 tensor-core GEMM, by the plan
// ops/trunk_block_cuda._plan_block computes on the host; the intermediates
// (s 16 MB, a 13 MB at R=4096) cost ~10 us each way against the products'
// tenths of a millisecond.
//
// K9f, one host call:
//   1. k9_rows_kernel, a block a row: s [R, E];
//   2. product "u" (s W1^T) with EPI_K9_MID (bias, m_mid, act, d_mid):
//      a [R, F1];
//   3. product "y" (a W2^T) with EPI_K9_OUT (bias, m_out, d_res, + x): out.
// K9b, one host call, every launch on the caller's stream, no float
// atomics (a rerun gives the same bits):
//   1. k9_rows_kernel again: s, each row's mean and 1/std, and
//      dz = m_out * d_res * dout;
//   2. product "u" by the forward's plan, so a_d = d_mid * act(u) carries
//      the forward's bits (an entry at relu's kink lands on the same side);
//   3. product "dp" (dz W2) with EPI_K9_DP: dp = (dz W2) * d_mid * act'(u) *
//      m_mid, act' read from a_d's sign;
//   4. product "ds" (dp W1);
//   5. k9_ln_bwd_kernel, a warp a row: dsrc, and per 32-row tile the
//      column sums of ds*m*t and ds*m (dgamma, dbeta), added by
//      splitk_reduce_kernel;
//   6. dW1^T = s^T dp and dW2^T = a_d^T dz on gemm_tc_tn_kernel, each with a
//      ones row that gives db1 = sum dp and db2 = sum dz; k9_reduce_t_kernel
//      adds the split planes in order and writes dW1 [F1, E], dW2 [E, F1].
// dx is dout itself; the wrapper returns it.  Every product's sums are
// promoted every K9_PROMOTE k tiles (gemm_tc.cuh), the reductions' every
// TN_PROMOTE.
//
// The bf16 instances (mmtr_trunk_block_fwd_bf16 / _bwd_bf16) are the TPU
// kernels at bf16 x and src (trunk_block_pallas.py: the weights cast to
// x's dtype on every call, which the wrapper does, and given both as
// stored and transposed; biases, LN parameters and masks float32).  Their
// rounding points are the JAX kernels': s = LN(src) in float32 from the
// upcast src, rounded to bf16; both products bf16 x bf16 with float32 sums
// on gemm_bf16.cuh (exact products on the bf16 tensor cores: no 3xTF32
// split); bias, mask, act and dropout in float32 in the same EPI_K9_*
// epilogues; a rounded to bf16 for the second product; out = x + y0 in
// float32, rounded once.  Backward: dz = m_out * d_res * dout in float32
// and dz_c its bf16 rounding (k9_round_colsum_kernel, which also sums dz's
// columns for db2), dp = (dz_c W2) * d_mid * act'(u) * m_mid in float32
// and dp_c its rounding (db1 from the unrounded dp), ds = dp_c W1 in
// float32, the LN backward in float32 with dsrc rounded; dW1 = dp_c^T s_c
// and dW2 = dz_c^T a_c on gemm_bf16.cuh's transposed-A kernel with float32
// split planes, written in float32, as every db, dgamma and dbeta: the
// wrapper casts each to its parameter's dtype, as the JAX VJP does.
// Bound: the products at the bf16 tensor cores' 989 TFLOP/s (13.1 GFLOP
// forward at R=4096 E=1000 F1=800: 0.013 ms), so bytes (the bf16 rows and
// weights, 18 MB: 0.005 ms) come second; the launches and row passes set
// what it takes.  They build as a translation unit of their own,
// trunk_block_bf16.cu, which includes this file with TRUNK_BLOCK_BF16
// defined, beside the float32 one (as flash_attn_bf16.cu does).
#include "gemm_tc.cuh"
#ifdef TRUNK_BLOCK_BF16
#include "gemm_bf16.cuh"
#endif

namespace {

// The products' promotion (gemm_tc.cuh's PROMOTE): their sums are 200-1000
// deep.  ops/trunk_block_cuda._K9_WIDTHS must agree (PROMOTED_WIDTHS unless
// 0).
constexpr int K9_PROMOTE = 8;

constexpr int ROW_THREADS = 256;                // a block a row
constexpr int LNB_WARPS = 16;                   // the LN backward: a warp a row,
constexpr int LNB_THREADS = 32 * LNB_WARPS;     // LNB_ROWS rows a block
constexpr int LNB_ROWS = 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float active_count(const float* __restrict__ m, int E) {
  float msum = 0.f;
  for (int e = threadIdx.x % 32; e < E; e += 32) msum += m[e];
  return fmaxf(warp_sum(msum), 1.0f);
}

#ifndef TRUNK_BLOCK_BF16
// s = LN(src, m) for row blockIdx.x (a block a row: at the serving row a
// warp's serial loads would set the time).  With mu_inv, the row's mean
// and 1/std at [2 r], [2 r + 1]; with dz, dz = (dout * d_res) * m_out (dr:
// d_res's draw, EPI_K9_OUT's arguments).
__global__ void __launch_bounds__(ROW_THREADS)
k9_rows_kernel(const float* __restrict__ src, const float* __restrict__ g,
               const float* __restrict__ lb, const float* __restrict__ m,
               float* __restrict__ s, float* __restrict__ mu_inv,
               const float* __restrict__ dout, float* __restrict__ dz, int E, float eps,
               EpiArgs dr) {
  __shared__ float red[33];
  const int r = blockIdx.x;
  const float* x = src + (long long)r * E;
  float msum = 0.f, sum = 0.f;
  for (int e = threadIdx.x; e < E; e += ROW_THREADS) {
    msum += m[e];
    sum += x[e] * m[e];
  }
  const float n = fmaxf(block_sum(msum, red), 1.0f);
  const float mu = block_sum(sum, red) / n;
  float sq = 0.f;
  for (int e = threadIdx.x; e < E; e += ROW_THREADS) {
    const float d = (x[e] - mu) * m[e];
    sq += d * d;
  }
  const float inv = rsqrtf(block_sum(sq, red) / n + eps);
  float* srow = s + (long long)r * E;
  for (int e = threadIdx.x; e < E; e += ROW_THREADS)
    srow[e] = (((x[e] - mu) * inv) * g[e] + lb[e]) * m[e];
  if (mu_inv != nullptr && threadIdx.x == 0) {
    mu_inv[2 * r] = mu;
    mu_inv[2 * r + 1] = inv;
  }
  if (dz != nullptr) {
    const float* d = dout + (long long)r * E;
    float* z = dz + (long long)r * E;
    for (int e = threadIdx.x; e < E; e += ROW_THREADS)
      z[e] = (d[e] * tc_drop(dr, r, e)) * dr.mask[e];
  }
}
#else
// s = LN(src, m) for row blockIdx.x (a block a row: at the serving row a
// warp's serial loads would set the time).  With mu_inv, the row's mean
// and 1/std at [2 r], [2 r + 1]; with dz, dz = (dout * d_res) * m_out (dr:
// d_res's draw, EPI_K9_OUT's arguments).  The bf16 unit's copy is a
// template on T, the type of src, s and dout (bf16: read upcast, s rounded
// as it is stored; dz float32 either way); the float32 unit keeps its own,
// whose machine code a template instance at float did not keep.
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
k9_rows_kernel(const T* __restrict__ src, const float* __restrict__ g,
               const float* __restrict__ lb, const float* __restrict__ m,
               T* __restrict__ s, float* __restrict__ mu_inv,
               const T* __restrict__ dout, float* __restrict__ dz, int E, float eps,
               EpiArgs dr) {
  __shared__ float red[33];
  const int r = blockIdx.x;
  const T* x = src + (long long)r * E;
  float msum = 0.f, sum = 0.f;
  for (int e = threadIdx.x; e < E; e += ROW_THREADS) {
    msum += m[e];
    sum += ld_f(x + e) * m[e];
  }
  const float n = fmaxf(block_sum(msum, red), 1.0f);
  const float mu = block_sum(sum, red) / n;
  float sq = 0.f;
  for (int e = threadIdx.x; e < E; e += ROW_THREADS) {
    const float d = (ld_f(x + e) - mu) * m[e];
    sq += d * d;
  }
  const float inv = rsqrtf(block_sum(sq, red) / n + eps);
  T* srow = s + (long long)r * E;
  for (int e = threadIdx.x; e < E; e += ROW_THREADS)
    st_f(srow + e, (((ld_f(x + e) - mu) * inv) * g[e] + lb[e]) * m[e]);
  if (mu_inv != nullptr && threadIdx.x == 0) {
    mu_inv[2 * r] = mu;
    mu_inv[2 * r + 1] = inv;
  }
  if (dz != nullptr) {
    const T* d = dout + (long long)r * E;
    float* z = dz + (long long)r * E;
    for (int e = threadIdx.x; e < E; e += ROW_THREADS)
      z[e] = (ld_f(d + e) * tc_drop(dr, r, e)) * dr.mask[e];
  }
}
#endif

// The masked-LN backward, a warp a row, LNB_ROWS rows a block:
//   dsrc = m * inv * (dtn - mean(dtn) - t * mean(dtn * t)), means over n,
//   dtn = ds * m * g, t = (src - mu) * inv;
// part[block] = the block's column sums of ds*m*t [E] then ds*m [E], each
// warp's kept in its own shared row [2][E] and added in warp order.  T:
// src and dsrc float, or bf16 (src read upcast, dsrc rounded as stored).
template <typename T>
__global__ void __launch_bounds__(LNB_THREADS)
k9_ln_bwd_kernel(const float* __restrict__ ds, const T* __restrict__ src,
                 const float* __restrict__ mu_inv, const float* __restrict__ g,
                 const float* __restrict__ m, T* __restrict__ dsrc,
                 float* __restrict__ part, int R, int E) {
  extern __shared__ float colp[];   // [LNB_WARPS][2][E]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* mine = colp + warp * 2 * E;
  for (int e = lane; e < 2 * E; e += 32) mine[e] = 0.f;
  const float n = active_count(m, E);
  for (int i = warp; i < LNB_ROWS; i += LNB_WARPS) {
    const int r = blockIdx.x * LNB_ROWS + i;
    if (r >= R) break;
    const float mu = mu_inv[2 * r], inv = mu_inv[2 * r + 1];
    const T* x = src + (long long)r * E;
    const float* d = ds + (long long)r * E;
    float s1 = 0.f, s2 = 0.f;
    for (int e = lane; e < E; e += 32) {
      const float t = (ld_f(x + e) - mu) * inv, dsm = d[e] * m[e], dtn = dsm * g[e];
      s1 += dtn;
      s2 += dtn * t;
      mine[e] += dsm * t;
      mine[E + e] += dsm;
    }
    const float mean1 = warp_sum(s1) / n, mean2 = warp_sum(s2) / n;
    T* out = dsrc + (long long)r * E;
    for (int e = lane; e < E; e += 32) {
      const float t = (ld_f(x + e) - mu) * inv, dtn = (d[e] * m[e]) * g[e];
      st_f(out + e, (m[e] * inv) * (dtn - mean1 - t * mean2));
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * E; c += LNB_THREADS) {
    float v = 0.f;
    for (int w = 0; w < LNB_WARPS; ++w) v += colp[w * 2 * E + c];
    part[(long long)blockIdx.x * 2 * E + c] = v;
  }
}

#ifdef TRUNK_BLOCK_BF16
// K9b's bf16 instance: q = P rounded to bf16, [R, N], and part[tile] the
// column sums of the unrounded P over its 32-row tile (block (column
// range, tile), a thread a column, the rows in order), which
// splitk_reduce_kernel adds in tile order: db2 from dz, db1 from dp.
__global__ void __launch_bounds__(ROW_THREADS)
k9_round_colsum_kernel(const float* __restrict__ P, bf16* __restrict__ q,
                       float* __restrict__ part, int R, int N) {
  const int c = blockIdx.x * ROW_THREADS + threadIdx.x;
  if (c >= N) return;
  const int r0 = blockIdx.y * LNB_ROWS, r1 = min(R, r0 + LNB_ROWS);
  float sum = 0.f;
  for (int r = r0; r < r1; ++r) {
    const float v = P[(long long)r * N + c];
    q[(long long)r * N + c] = f2bf(v);
    sum += v;
  }
  part[(long long)blockIdx.y * N + c] = sum;
}

// Round P [R, N] into q and add its columns into out [N] (part: the tiles'
// sums, ceil(R / 32) * N floats).
cudaError_t round_colsum(const float* P, bf16* q, float* part, float* out, int R, int N,
                         cudaStream_t stream) {
  const int tiles = (R + LNB_ROWS - 1) / LNB_ROWS;
  k9_round_colsum_kernel<<<dim3((N + ROW_THREADS - 1) / ROW_THREADS, tiles), ROW_THREADS, 0,
                           stream>>>(P, q, part, R, N);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  splitk_reduce_kernel<float><<<(N + RED_THREADS - 1) / RED_THREADS, RED_THREADS, 0, stream>>>(
      part, out, (long long)N, tiles);
  return cudaGetLastError();
}
#else
constexpr int RT_TILE = 32;

// A transposed-A reduction's planes P [splits][Md + 1][N] (rows 0..Md-1 the
// product, row Md the ones row's column sums) added in order, written
// transposed: out [N][Md] (the weight's own layout) and bias_out [N].
__global__ void __launch_bounds__(RT_TILE * 8)
k9_reduce_t_kernel(const float* __restrict__ P, float* __restrict__ out,
                   float* __restrict__ bias_out, int Md, int N, int splits) {
  __shared__ float tile[RT_TILE][RT_TILE + 1];
  const int tx = threadIdx.x % RT_TILE, ty = threadIdx.x / RT_TILE;
  const int m0 = blockIdx.y * RT_TILE, n0 = blockIdx.x * RT_TILE;
  const long long plane = (long long)(Md + 1) * N;
  for (int i = ty; i < RT_TILE; i += 8) {
    const int m = m0 + i, n = n0 + tx;
    if (m > Md || n >= N) continue;
    float v = 0.f;
    for (int z = 0; z < splits; ++z) v += P[z * plane + (long long)m * N + n];
    if (m == Md) bias_out[n] = v;
    else tile[i][tx] = v;
  }
  __syncthreads();
  for (int i = ty; i < RT_TILE; i += 8) {
    const int n = n0 + i, m = m0 + tx;
    if (m < Md && n < N) out[(long long)n * Md + m] = tile[tx][i];
  }
}

cudaError_t launch_reduce_t(const float* P, float* out, float* bias_out, int Md, int N,
                            int splits, cudaStream_t stream) {
  const dim3 grid((N + RT_TILE - 1) / RT_TILE, (Md + 1 + RT_TILE - 1) / RT_TILE);
  k9_reduce_t_kernel<<<grid, RT_TILE * 8, 0, stream>>>(P, out, bias_out, Md, N, splits);
  return cudaGetLastError();
}
#endif  // TRUNK_BLOCK_BF16

EpiArgs drop_args(const float* mask, int act, int use, int rep, int seed, float rate) {
  return EpiArgs{mask, act, use, rep, (uint32_t)seed, rate, 1.0f / (1.0f - rate)};
}

}  // namespace

#ifndef TRUNK_BLOCK_BF16
// plan: the 21 host ints of ops/trunk_block_cuda._plan_block (PLAN_KEYS):
// the TcPlans of products u, y, dp and ds, then tn_vec and the two
// reductions' splits and k tiles a split.  s [R, E] and a [R, F1] are
// scratch rows; scratch: the products' TF32 planes or split planes.
extern "C" int mmtr_trunk_block_fwd(const float* x, const float* src, const float* w1,
                                    const float* b1, const float* w2, const float* b2,
                                    const float* g, const float* lb, const float* m_in,
                                    const float* m_mid, const float* m_out, float* out,
                                    float* s, float* a, void* scratch, int R, int E, int F1,
                                    int act, int mid_rep, int use_dm, int use_dr,
                                    int seed_mid, int seed_res, float rate_mid,
                                    float rate_res, float eps, const int* plan,
                                    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  k9_rows_kernel<<<R, ROW_THREADS, 0, stream>>>(src, g, lb, m_in, s, nullptr, nullptr,
                                                 nullptr, E, eps, EpiArgs{});
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_gemm_tc<EPI_K9_MID, K9_PROMOTE, true>(
      tc_plan(plan), s, E, w1, b1, nullptr, a, R, F1, E, F1, scratch, stream, true,
      drop_args(m_mid, act, use_dm, mid_rep, seed_mid, rate_mid));
  if (err != cudaSuccess) return (int)err;
  return (int)launch_gemm_tc<EPI_K9_OUT, K9_PROMOTE, true>(
      tc_plan(plan + 4), a, F1, w2, b2, x, out, R, E, F1, E, scratch, stream, true,
      drop_args(m_out, 0, use_dr, 1, seed_res, rate_res));
}

// The backward by the same plan.  dsrc [R, E]; red [2*E*F1 + F1 + 3E]
// receives dW1 [F1, E], dW2 [E, F1], db1 [F1], db2 [E], dgamma [E],
// dbeta [E].  Scratch rows: s, dz, ds [R, E], ad, dp [R, F1], mu_inv [2R];
// part [ceil(R / 32)][2E] the LN backward's tile sums; partial the
// reductions' planes, dW1^T's [splits][E + 1][F1] then dW2^T's
// [splits][F1 + 1][E]; scratch as the forward's.
extern "C" int mmtr_trunk_block_bwd(const float* src, const float* dout, const float* w1,
                                    const float* b1, const float* w2, const float* g,
                                    const float* lb, const float* m_in, const float* m_mid,
                                    const float* m_out, float* dsrc, float* red, float* s,
                                    float* dz, float* ds, float* ad, float* dp, float* mu_inv,
                                    float* part, float* partial, void* scratch, int R, int E,
                                    int F1, int act, int mid_rep, int use_dm, int use_dr,
                                    int seed_mid, int seed_res, float rate_mid,
                                    float rate_res, float eps, const int* plan,
                                    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const EpiArgs mid = drop_args(m_mid, act, use_dm, mid_rep, seed_mid, rate_mid);
  k9_rows_kernel<<<R, ROW_THREADS, 0, stream>>>(
      src, g, lb, m_in, s, mu_inv, dout, dz, E, eps,
      drop_args(m_out, 0, use_dr, 1, seed_res, rate_res));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_gemm_tc<EPI_K9_MID, K9_PROMOTE, true>(tc_plan(plan), s, E, w1, b1, nullptr, ad,
                                                     R, F1, E, F1, scratch, stream, true, mid);
  if (err != cudaSuccess) return (int)err;
  err = launch_gemm_tc<EPI_K9_DP, K9_PROMOTE>(tc_plan(plan + 8), dz, E, w2, nullptr, ad, dp, R,
                                              F1, E, F1, scratch, stream, true, mid);
  if (err != cudaSuccess) return (int)err;
  err = launch_gemm_tc<EPI_NONE, K9_PROMOTE>(tc_plan(plan + 12), dp, F1, w1, nullptr, nullptr,
                                             ds, R, E, F1, E, scratch, stream);
  if (err != cudaSuccess) return (int)err;

  static unsigned long long smem_set = 0;
  err = allow_smem_once((const void*)k9_ln_bwd_kernel<float>, &smem_set);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (R + LNB_ROWS - 1) / LNB_ROWS;
  k9_ln_bwd_kernel<float><<<tiles, LNB_THREADS, sizeof(float) * LNB_WARPS * 2 * E, stream>>>(
      ds, src, mu_inv, g, m_in, dsrc, part, R, E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int tn_vec = plan[16], s1 = plan[17], kps1 = plan[18], s2 = plan[19], kps2 = plan[20];
  const long long plane1 = (long long)(E + 1) * F1, plane2 = (long long)(F1 + 1) * E;
  float* partial2 = partial + s1 * plane1;
  err = tn_vec ? launch_gemm_tc_tn<true>(s, E, 0, E, E, dp, F1, partial, F1, R, s1, kps1,
                                         plane1, stream)
               : launch_gemm_tc_tn<false>(s, E, 0, E, E, dp, F1, partial, F1, R, s1, kps1,
                                          plane1, stream);
  if (err != cudaSuccess) return (int)err;
  err = tn_vec ? launch_gemm_tc_tn<true>(ad, F1, 0, F1, F1, dz, E, partial2, E, R, s2, kps2,
                                         plane2, stream)
               : launch_gemm_tc_tn<false>(ad, F1, 0, F1, F1, dz, E, partial2, E, R, s2, kps2,
                                          plane2, stream);
  if (err != cudaSuccess) return (int)err;
  const long long wsize = (long long)E * F1;
  float* vecs = red + 2 * wsize;   // db1 [F1], db2 [E], dgamma [E], dbeta [E]
  err = launch_reduce_t(partial, red, vecs, E, F1, s1, stream);
  if (err != cudaSuccess) return (int)err;
  err = launch_reduce_t(partial2, red + wsize, vecs + F1, F1, E, s2, stream);
  if (err != cudaSuccess) return (int)err;
  splitk_reduce_kernel<float><<<(unsigned)((2LL * E + RED_THREADS - 1) / RED_THREADS),
                                RED_THREADS, 0, stream>>>(part, vecs + F1 + E, 2LL * E, tiles);
  return (int)cudaGetLastError();
}

#else
// The bf16 instances.  plan: the 30 host ints of
// ops/trunk_block_cuda._plan_block_bf16: the BfPlans (ops/gemm_tc.plan_bf16)
// of products u (s W1^T), y (a W2^T), dp (dz_c W2) and ds (dp_c W1), then
// of the reductions dW1 (dp_c^T s_c) and dW2 (dz_c^T a_c).  w1t [E, F1] and
// w2t [F1, E]: the bf16 weights transposed (the forward's B operands); w1
// [F1, E] and w2 [E, F1] as stored (the backward's).  partial: the largest
// product's or reduction's scratch (a B^T on the wgmma path, or split
// planes), in turn.
extern "C" int mmtr_trunk_block_fwd_bf16(const bf16* x, const bf16* src, const bf16* w1t,
                                         const float* b1, const bf16* w2t, const float* b2,
                                         const float* g, const float* lb, const float* m_in,
                                         const float* m_mid, const float* m_out, bf16* out,
                                         bf16* s, bf16* a, float* partial, int R, int E, int F1,
                                         int act, int mid_rep, int use_dm, int use_dr,
                                         int seed_mid, int seed_res, float rate_mid,
                                         float rate_res, float eps, const int* plan,
                                         void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  k9_rows_kernel<bf16><<<R, ROW_THREADS, 0, stream>>>(src, g, lb, m_in, s, nullptr, nullptr,
                                                       nullptr, E, eps, EpiArgs{});
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_gemm_bf16<true, EPI_K9_MID, bf16, float>(
      bf_plan(plan), bf_gemm(s, E, w1t, F1, F1, R, F1, E), b1, nullptr, a, F1, partial, stream,
      drop_args(m_mid, act, use_dm, mid_rep, seed_mid, rate_mid));
  if (err != cudaSuccess) return (int)err;
  return (int)launch_gemm_bf16<true, EPI_K9_OUT, bf16, float>(
      bf_plan(plan + 5), bf_gemm(a, F1, w2t, E, E, R, E, F1), b2, x, out, E, partial, stream,
      drop_args(m_out, 0, use_dr, 1, seed_res, rate_res));
}

// dsrc [R, E] bf16; red [2*E*F1 + F1 + 3E] float32 as the float entry's
// (dW1 [F1, E], dW2 [E, F1], db1, db2, dgamma, dbeta).  Scratch: s, dz_c
// [R, E] and a, dp_c [R, F1] bf16; dz, ds [R, E] and dp [R, F1] float32;
// mu_inv [2R]; part [ceil(R / 32)][max(2E, F1)], the column sums' tiles.
extern "C" int mmtr_trunk_block_bwd_bf16(
    const bf16* src, const bf16* dout, const bf16* w1, const bf16* w1t, const float* b1,
    const bf16* w2, const float* g, const float* lb, const float* m_in, const float* m_mid,
    const float* m_out, bf16* dsrc, float* red, bf16* s, bf16* dz_c, bf16* ad, bf16* dp_c,
    float* dz, float* ds, float* dp, float* mu_inv, float* part, float* partial, int R, int E,
    int F1, int act, int mid_rep, int use_dm, int use_dr, int seed_mid, int seed_res,
    float rate_mid, float rate_res, float eps, const int* plan, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const EpiArgs mid = drop_args(m_mid, act, use_dm, mid_rep, seed_mid, rate_mid);
  const long long wsize = (long long)E * F1;
  float* db1 = red + 2 * wsize;
  float* db2 = db1 + F1;
  k9_rows_kernel<bf16><<<R, ROW_THREADS, 0, stream>>>(
      src, g, lb, m_in, s, mu_inv, dout, dz, E, eps,
      drop_args(m_out, 0, use_dr, 1, seed_res, rate_res));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_gemm_bf16<true, EPI_K9_MID, bf16, float>(
      bf_plan(plan), bf_gemm(s, E, w1t, F1, F1, R, F1, E), b1, nullptr, ad, F1, partial, stream,
      mid);
  if (err != cudaSuccess) return (int)err;
  err = round_colsum(dz, dz_c, part, db2, R, E, stream);
  if (err != cudaSuccess) return (int)err;
  err = launch_gemm_bf16<true, EPI_K9_DP, float, float>(
      bf_plan(plan + 10), bf_gemm(dz_c, E, w2, F1, F1, R, F1, E), nullptr, ad, dp, F1, partial,
      stream, mid);
  if (err != cudaSuccess) return (int)err;
  err = round_colsum(dp, dp_c, part, db1, R, F1, stream);
  if (err != cudaSuccess) return (int)err;
  err = launch_gemm_bf16<true, EPI_NONE, float>(bf_plan(plan + 15),
                                                bf_gemm(dp_c, F1, w1, E, E, R, E, F1), nullptr,
                                                nullptr, ds, E, partial, stream);
  if (err != cudaSuccess) return (int)err;

  static unsigned long long smem_set = 0;
  err = allow_smem_once((const void*)k9_ln_bwd_kernel<bf16>, &smem_set);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (R + LNB_ROWS - 1) / LNB_ROWS;
  k9_ln_bwd_kernel<bf16><<<tiles, LNB_THREADS, sizeof(float) * LNB_WARPS * 2 * E, stream>>>(
      ds, src, mu_inv, g, m_in, dsrc, part, R, E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  splitk_reduce_kernel<float><<<(unsigned)((2LL * E + RED_THREADS - 1) / RED_THREADS),
                                RED_THREADS, 0, stream>>>(part, db2 + E, 2LL * E, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // dW1 [F1, E]: At(k, m) = dp_c[k][m] over the R rows, B = s_c; dW2 [E,
  // F1]: At(k, m) = dz_c[k][m], B = a_c
  err = launch_gemm_bf16<false, EPI_NONE, float>(bf_plan(plan + 20),
                                                 bf_gemm(dp_c, F1, s, E, E, F1, E, R), nullptr,
                                                 nullptr, red, E, partial, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_gemm_bf16<false, EPI_NONE, float>(bf_plan(plan + 25),
                                                       bf_gemm(dz_c, E, ad, F1, F1, E, F1, R),
                                                       nullptr, nullptr, red + wsize, F1,
                                                       partial, stream);
}
#endif  // TRUNK_BLOCK_BF16
