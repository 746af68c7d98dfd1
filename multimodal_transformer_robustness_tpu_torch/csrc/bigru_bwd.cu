// K1b: the backward of one GRU direction (K1 forward in bigru.cu).
//
// Replaces the TPU kernel multimodal_transformer_robustness_tpu/ops/
// bigru_pallas.py::_bwd_kernel / _bwd_impl (the custom VJP of gru_dir_pallas).
// Same contract: x [T, B, in], the forward's h [T, B, H] and its cotangent
// dh [T, B, H], wt [3, H, H], bhn [H] -> dwp [3, in, H], dwt [3, H, H],
// dbc [3, H], dbhn [H], and dx [T, B, in] only when need_dx.  Gate order
// (r, z, n); `reverse` is the direction the forward walked.
//
// The TPU kernel walked a sequential grid and accumulated dW / db across it
// in revisited output blocks.  Blocks here run in parallel and carry nothing
// from one to the next, so the work splits in two passes:
//
//   1. Recurrence (gru_bwd_recurrence_kernel): one block per group of batch
//      rows walks the steps newest-first, as the forward walked them oldest-
//      first.  The whole recurrent weight stays in shared memory (rows padded
//      to H+1 floats, 121 KB at H=100, so both the h_prev @ wt recompute of
//      r/z/n and the da @ wt^T carry update read it without bank conflicts),
//      with the carried dh.  The input-side gate pre-activations come from
//      the forward's [3, T*B, H] scratch, saved for backward (246 MB per
//      direction at B=4096, T=50, H=100): the card has the memory, and
//      recomputing x @ wp would cost as much again as the dwp product.  The
//      pass writes the pre-activation gradients da_r, da_z, da_n [T*B, 3H]
//      and dghn = da_n * r [T*B, H] for every (step, row).
//   2. Reductions over all T*B rows, hand-written products from common.cuh:
//      dwp = x^T [da_r da_z da_n], dwt = h_prev^T [da_r da_z dghn] (h_prev is
//      h shifted one step, read in place with zeros at the sequence start),
//      dbc / dbhn as column sums, each split over K = T*B rows into partials
//      that one fixed-order pass adds (no float atomics: a rerun gives the
//      same bits); dx = [da_r da_z da_n] @ wp^T only when need_dx.
//
// Bound: at B=4096, T=50, in=768 the products are 2*T*B*in*3H = 94 GFLOP
// for dwp and as much again for dx, against ~0.75 GB of x, dx, h and dh;
// it is FLOP-bound on the CUDA cores (float32, no tensor cores in this first
// form).  The recurrence pass is sequential in T and latency-bound per step.
#include "common.cuh"

namespace {

__global__ void gru_bwd_recurrence_kernel(
    const float* __restrict__ G, const float* __restrict__ hs,
    const float* __restrict__ dhs, const float* __restrict__ wt,
    const float* __restrict__ bhn, float* __restrict__ Dg,
    float* __restrict__ Dghn, int T, int B, int H, int rows_per_block,
    int reverse) {
  extern __shared__ float smem[];
  const int H3 = 3 * H, HP = H + 1;
  float* w = smem;                        // [3, H, HP]  w[g][k][j] = wt[g][k][j]
  float* hp = w + 3 * H * HP;             // [rows, H]   h_prev of this step
  float* dh = hp + rows_per_block * H;    // [rows, H]   carried dh
  float* gh = dh + rows_per_block * H;    // [rows, 3H]  h_prev @ wt
  float* da = gh + rows_per_block * H3;   // [rows, 3H]  da_r, da_z, dghn
  const int b0 = blockIdx.x * rows_per_block;
  const int nrows = min(rows_per_block, B - b0);
  const long long gate_stride = (long long)T * B * H;

  for (int i = threadIdx.x; i < 3 * H * H; i += blockDim.x) {
    const int g = i / (H * H), r = i - g * H * H, k = r / H, j = r - k * H;
    w[(g * H + k) * HP + j] = wt[i];
  }
  for (int i = threadIdx.x; i < nrows * H; i += blockDim.x) dh[i] = 0.f;
  __syncthreads();

  for (int step = 0; step < T; ++step) {
    // newest first: the forward direction's last step is t = T-1, the
    // reverse direction's is t = 0
    const int t = reverse ? step : T - 1 - step;
    const int tp = reverse ? t + 1 : t - 1;   // where h_prev was written
    const bool has_prev = tp >= 0 && tp < T;
    for (int i = threadIdx.x; i < nrows * H; i += blockDim.x) {
      const int n = i / H, k = i - n * H;
      hp[i] = has_prev ? hs[((long long)tp * B + b0 + n) * H + k] : 0.f;
    }
    __syncthreads();
    // the forward's h @ wt, in its order, so r, z, n come out bit-identical
    for (int idx = threadIdx.x; idx < nrows * H3; idx += blockDim.x) {
      const int n = idx / H3, j3 = idx - n * H3;
      const int g = j3 / H, jj = j3 - g * H;
      const float* wg = w + g * H * HP + jj;
      const float* hn = hp + n * H;
      float acc = 0.f;
      for (int k = 0; k < H; ++k) acc = fmaf(hn[k], wg[k * HP], acc);
      gh[idx] = acc;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nrows * H; idx += blockDim.x) {
      const int n = idx / H, j = idx - n * H;
      const long long row = (long long)t * B + b0 + n;
      const long long at = row * H + j;
      const float* ghn = gh + n * H3;
      const float r = sigmoid_f(G[at] + ghn[j]);
      const float z = sigmoid_f(G[gate_stride + at] + ghn[H + j]);
      const float gh_n = ghn[2 * H + j] + bhn[j];
      const float nn = tanhf(G[2 * gate_stride + at] + r * gh_n);
      const float dht = dhs[at] + dh[idx];
      const float dz = dht * (hp[idx] - nn);
      const float dn = dht * (1.0f - z);
      const float da_n = dn * (1.0f - nn * nn);
      const float dghn = da_n * r;
      const float dr = da_n * gh_n;
      const float da_r = dr * r * (1.0f - r);
      const float da_z = dz * z * (1.0f - z);
      float* dg = Dg + row * H3;
      dg[j] = da_r;
      dg[H + j] = da_z;
      dg[2 * H + j] = da_n;
      Dghn[at] = dghn;
      float* dan = da + n * H3;
      dan[j] = da_r;
      dan[H + j] = da_z;
      dan[2 * H + j] = dghn;
      dh[idx] = dht * z;
    }
    __syncthreads();
    // dh_prev[k] = dht z + sum_g sum_j da_g[j] wt[g][k][j]
    for (int idx = threadIdx.x; idx < nrows * H; idx += blockDim.x) {
      const int n = idx / H, k = idx - n * H;
      const float* dan = da + n * H3;
      float acc = dh[idx];
      for (int g = 0; g < 3; ++g) {
        const float* wk = w + (g * H + k) * HP;
        const float* dg = dan + g * H;
        for (int j = 0; j < H; ++j) acc = fmaf(dg[j], wk[j], acc);
      }
      dh[idx] = acc;
    }
    __syncthreads();
  }
}

}  // namespace

// partial [splits, total] and red [total] hold, in order, dwp as [in, 3H],
// dwt's r and z parts as [H, 2H], its n part as [H, H], dbc [3H], dbhn [H];
// the wrapper reshapes them.  wpT is wp as [3H, in] (rows g*H + j).
extern "C" int mmtr_gru_dir_bwd(const float* x, const float* hs,
                                const float* gates, const float* dhs,
                                const float* wt, const float* bhn,
                                const float* wpT, float* dg, float* dghn,
                                float* partial, float* red, float* dx, int T,
                                int B, int in_dim, int H, int reverse,
                                int need_dx, int kchunk, int splits,
                                void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int rows = T * B, H3 = 3 * H;

  int rpb = (B + 131) / 132;
  rpb = rpb < 1 ? 1 : (rpb > 8 ? 8 : rpb);
  int threads = ((rpb * H3 + 31) / 32) * 32;
  threads = threads < 64 ? 64 : (threads > 1024 ? 1024 : threads);
  const size_t smem = sizeof(float) * (3ULL * H * (H + 1) + 8ULL * rpb * H);
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_recurrence_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gru_bwd_recurrence_kernel<<<(B + rpb - 1) / rpb, threads, smem, stream>>>(
      gates, hs, dhs, wt, bhn, dg, dghn, T, B, H, rpb, reverse);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  if (need_dx) {
    launch_gemm<EPI_NONE>(dg, wpT, nullptr, nullptr, dx, rows, in_dim, H3, 1,
                          0, 0, 0, 0, stream);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  const long long o_dwt_rz = (long long)in_dim * H3;
  const long long o_dwt_n = o_dwt_rz + 2LL * H * H;
  const long long o_dbc = o_dwt_n + (long long)H * H;
  const long long o_dbhn = o_dbc + H3;
  const long long total = o_dbhn + H;
  const int shift = reverse ? B : -B;   // h_prev row = row + shift
  launch_gemm_tn_splitk(x, dg, partial, in_dim, H3, rows, in_dim, H3, 0,
                        kchunk, splits, total, stream);
  launch_gemm_tn_splitk(hs, dg, partial + o_dwt_rz, H, 2 * H, rows, H, H3,
                        shift, kchunk, splits, total, stream);
  launch_gemm_tn_splitk(hs, dghn, partial + o_dwt_n, H, H, rows, H, H, shift,
                        kchunk, splits, total, stream);
  launch_colsum_splitk(dg, partial + o_dbc, rows, H3, H3, kchunk, splits,
                       total, stream);
  launch_colsum_splitk(dghn, partial + o_dbhn, rows, H, H, kchunk, splits,
                       total, stream);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  splitk_reduce_kernel<<<(unsigned)((total + RED_THREADS - 1) / RED_THREADS),
                         RED_THREADS, 0, stream>>>(partial, red, total, splits);
  return (int)cudaGetLastError();
}
