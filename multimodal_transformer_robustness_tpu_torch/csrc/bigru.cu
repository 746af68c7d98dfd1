// K1 forward: one direction of a torch-semantics GRU level over T-major input.
//
// Replaces the TPU kernel multimodal_transformer_robustness_tpu/ops/
// bigru_pallas.py::_fwd_kernel / _fwd_impl (public gru_dir_pallas).  Same
// contract: x [T, B, in], wp [3, in, H], wt [3, H, H], bc [3, H] (b_ir+b_hr,
// b_iz+b_hz, b_in), bhn [H] -> h [T, B, H] in storage time order; `reverse`
// walks t = T-1 .. 0.  h starts at zero and is carried in float32.
//
//   r = sigmoid(x W_ir^T + bc_r + h W_hr^T)
//   z = sigmoid(x W_iz^T + bc_z + h W_hz^T)
//   n = tanh(x W_in^T + bc_n + r * (h W_hn^T + b_hn))
//   h' = (1 - z) n + z h
//
// Two launches: (1) the input projection for all time steps as one batched
// tiled GEMM over the three gates (bias bc folded into its epilogue) into a
// [3, T*B, H] scratch; (2) the recurrence.  The recurrence is sequential in T
// and, at the serving batch of 1, latency-bound: every step is a [rows, H] x
// [H, 3H] product (30k FMAs at H=100) and two block barriers.  Its design
// keeps the whole recurrent weight (3*H*H floats, 120 KB at H=100) and h in
// shared memory for the entire time loop, so a step reads only its three
// projected gate rows from device memory.  Blocks run in parallel over batch
// rows, never over time; rows per block grow with B only once every SM
// has a block.
#include "common.cuh"

namespace {

__global__ void gru_recurrence_kernel(const float* __restrict__ G,
                                      const float* __restrict__ wt,
                                      const float* __restrict__ bhn,
                                      float* __restrict__ out, int T, int B,
                                      int H, int rows_per_block, int reverse) {
  extern __shared__ float smem[];
  const int H3 = 3 * H;
  float* w = smem;                       // [3, H, H]
  float* hs = w + 3 * H * H;             // [rows, H]   carried state
  float* gh = hs + rows_per_block * H;   // [rows, 3H]  h @ wt for this step
  const int b0 = blockIdx.x * rows_per_block;
  const int nrows = min(rows_per_block, B - b0);
  const long long gate_stride = (long long)T * B * H;

  for (int i = threadIdx.x; i < 3 * H * H; i += blockDim.x) w[i] = wt[i];
  for (int i = threadIdx.x; i < nrows * H; i += blockDim.x) hs[i] = 0.f;
  __syncthreads();

  for (int step = 0; step < T; ++step) {
    const int t = reverse ? T - 1 - step : step;
    for (int idx = threadIdx.x; idx < nrows * H3; idx += blockDim.x) {
      const int n = idx / H3, j = idx - n * H3;
      const int g = j / H, jj = j - g * H;
      const float* wg = w + g * H * H + jj;
      const float* hn = hs + n * H;
      float acc = 0.f;
      for (int k = 0; k < H; ++k) acc = fmaf(hn[k], wg[k * H], acc);
      gh[idx] = acc;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nrows * H; idx += blockDim.x) {
      const int n = idx / H, j = idx - n * H;
      const long long at = ((long long)t * B + b0 + n) * H + j;
      const float* ghn = gh + n * H3;
      const float r = sigmoid_f(G[at] + ghn[j]);
      const float z = sigmoid_f(G[gate_stride + at] + ghn[H + j]);
      const float nn = tanhf(G[2 * gate_stride + at] + r * (ghn[2 * H + j] + bhn[j]));
      const float h_new = (1.0f - z) * nn + z * hs[idx];
      hs[idx] = h_new;
      out[at] = h_new;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int mmtr_gru_dir_fwd(const float* x, const float* wp, const float* wt,
                                const float* bc, const float* bhn, float* gates,
                                float* out, int T, int B, int in_dim, int H,
                                int reverse, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int rows = T * B;
  launch_gemm<EPI_BIAS>(x, wp, bc, nullptr, gates, rows, H, in_dim, 3, 0,
                        (long long)in_dim * H, H, (long long)rows * H, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  int rpb = (B + 131) / 132;
  rpb = rpb < 1 ? 1 : (rpb > 8 ? 8 : rpb);
  int threads = ((rpb * 3 * H + 31) / 32) * 32;
  threads = threads < 64 ? 64 : (threads > 1024 ? 1024 : threads);
  // w_hh^T, h and h @ w_hh^T; more than the card allows refuses the launch
  const size_t smem = sizeof(float) * (3ULL * H * H + 4ULL * rpb * H);
  err = cudaFuncSetAttribute(gru_recurrence_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  gru_recurrence_kernel<<<(B + rpb - 1) / rpb, threads, smem, stream>>>(
      gates, wt, bhn, out, T, B, H, rpb, reverse);
  return (int)cudaGetLastError();
}
