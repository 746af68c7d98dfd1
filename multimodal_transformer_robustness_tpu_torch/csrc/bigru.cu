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
// Two kernels.  (1) The input projection for all time steps as ONE
// [T*B, in] x [in, 3H] product in 3xTF32 on the tensor cores (gemm_tc.cuh:
// wgmma where the rows fill the card, after a launch that splits W_ih into
// TF32 planes; 64 x 64 mma.sync tiles split over K, and a launch summing
// the splits, for few rows),
// bias bc folded in at the end, scattered into the [3, T*B, H] gate
// scratch that K1b reads back.  At B=4096 it is 94 of the 107 GFLOP, so it
// is bound by operations: 0.57 ms at 165 TFLOP/s of float32-accurate
// products.  (2) The recurrence, sequential in T: every step is a
// [rows, H] x [H, 3H] product and the gate math, with W_hh^T (3*H*H floats,
// 120 KB at H=100) in shared memory for the whole time loop.  The launch
// plan (rows per block, threads, shared memory) is the caller's
// (ops/bigru_cuda._plan_gru_fwd); two forms:
//   * tiled (large B): 4 x 4 (row, column) register tiles for all three
//     gates, so one float4 of h and three of W feed 48 FMAs; rows per
//     block chosen so that B=4096 runs in one wave (32 rows: 128 blocks on
//     132 SMs); the next step's gate rows stream in by cp.async while this
//     step's product runs; h double-buffered in shared memory, each thread
//     keeping its own previous h in registers: one barrier a step;
//   * small (B <= 132, the serving batch of 1; H <= 104): a block a batch
//     row, a thread per (column, k-slice) of KS = 8 lanes holding its slice
//     of W_hh^T in registers, so a step reads only h from shared memory;
//     a shuffle reduction adds the slices, so a step's dependent chain is
//     ~H/(2 KS) FMAs rather than H.
// The dynamic shared-memory cap is raised once per process.
#include "gemm_tc.cuh"

namespace {

// The small form: KS lanes a column, each holding up to MAXK terms of each
// gate's W_hh^T column (H <= KS * MAXK = 104), so H * KS <= 832 threads and
// the launch bound leaves 78 registers a thread.
constexpr int REC_SMALL_KS = 8;
constexpr int REC_SMALL_MAXK = 13;
constexpr int REC_SMALL_THREADS = 832;
constexpr int REC_TILED_THREADS = 256;   // the tiled form's launch bound

// W_hh^T into shared memory as [3][H][hp], columns H..hp-1 zero.
__device__ __forceinline__ void load_wt(float* w, const float* __restrict__ wt, int H,
                                        int hp) {
  for (int i = threadIdx.x; i < 3 * H * hp; i += blockDim.x) {
    const int gk = i / hp, j = i - gk * hp;
    w[i] = j < H ? wt[(long long)gk * H + j] : 0.f;
  }
}

// The gate nonlinearities on the fast exponential and divide (MUFU): with
// the accurate expf / tanhf / IEEE division the gate math and stores took a
// large share of a tiled step in an instrumented trial.  Relative error ~1e-6
// (__expf: 2 + 1.2 |x| ulp), far inside K1's 1e-4; tanh via
// 1 - 2 / (e^2x + 1) is exact to ~1e-7 absolute, and saturates to +-1
// where e^2x overflows or vanishes.
__device__ __forceinline__ float gate_sigmoid(float v) {
  return __fdividef(1.0f, 1.0f + __expf(-v));
}

__device__ __forceinline__ float gate_tanh(float v) {
  return 1.0f - __fdividef(2.0f, __expf(2.0f * v) + 1.0f);
}

constexpr int REC_RT = 4;   // rows a thread of the tiled form owns (a multiple of 4)

// The tiled form's copies of one step's gate rows into this thread's slots
// (buffer `buf` of gs [2][3 * RT][threads] float4): rows b0 + r0 .. + RT-1,
// columns j0 .. j0 + 3 of the three gates; rows past B read as zero.
template <bool VEC>
__device__ __forceinline__ void tiled_prefetch(float4* gs, const float* G, int t, int buf,
                                               int B, int H, long long gate_stride, int b0,
                                               int r0, int j0) {
  const int nthreads = blockDim.x, tid = threadIdx.x;
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int i = 0; i < REC_RT; ++i) {
      const int b = b0 + r0 + i;
      float4* dst = gs + (buf * 3 * REC_RT + g * REC_RT + i) * nthreads + tid;
      const long long at = g * gate_stride + ((long long)t * B + b) * H + j0;
      if (VEC) {
        cp_async16(dst, b < B ? G + at : G, b < B);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool ok = b < B && j0 + c < H;
          cp_async4(reinterpret_cast<float*>(dst) + c, ok ? G + at + c : G, ok);
        }
      }
    }
}

// Tiled form.  Thread (rg, jg) owns rows 4rg..4rg+3 and columns 4jg..4jg+3
// of the block's R rows, for all three gates: per k, one float4 of h and
// three of W feed 48 FMAs (8-row tiles, 96 FMAs on five float4s, halved the
// warps and ran slower on the card).  Shared memory: w [3][H][hp], hT
// [2][hp][R+4] (h transposed, so a float4 is four rows of one column), gs
// [2][3 * 4][threads] float4 (each thread's own gate rows,
// double-buffered).  VEC: H a multiple of 4 (hp == H, 16-byte gate rows).
template <bool VEC>
__global__ void __launch_bounds__(REC_TILED_THREADS)
gru_rec_tiled_kernel(const float* __restrict__ G, const float* __restrict__ wt,
                     const float* __restrict__ bhn, float* __restrict__ out, int T,
                     int B, int H, int hp, int R, int reverse) {
  extern __shared__ float4 rec_smem4[];
  float* w = reinterpret_cast<float*>(rec_smem4);
  const int ldh = R + 4;
  float* hT = w + 3 * H * hp;
  float4* gs = reinterpret_cast<float4*>(hT + 2 * hp * ldh);
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int jgroups = hp / 4;
  const int jg = tid % jgroups, rg = tid / jgroups;
  const int j0 = 4 * jg, r0 = REC_RT * rg;
  const int b0 = blockIdx.x * R;
  const long long gate_stride = (long long)T * B * H;

  load_wt(w, wt, H, hp);
  for (int i = tid; i < 2 * hp * ldh; i += nthreads) hT[i] = 0.f;

  float bn[4], hold[REC_RT][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) bn[c] = j0 + c < H ? bhn[j0 + c] : 0.f;
#pragma unroll
  for (int i = 0; i < REC_RT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) hold[i][c] = 0.f;

  tiled_prefetch<VEC>(gs, G, reverse ? T - 1 : 0, 0, B, H, gate_stride, b0, r0, j0);
  cp_async_commit();
  __syncthreads();

  for (int step = 0; step < T; ++step) {
    const int cur = step & 1;
    if (step + 1 < T)
      tiled_prefetch<VEC>(gs, G, reverse ? T - 2 - step : step + 1, cur ^ 1, B, H,
                          gate_stride, b0, r0, j0);
    cp_async_commit();

    float acc[3][REC_RT][4];
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int i = 0; i < REC_RT; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[g][i][c] = 0.f;
    const float* h = hT + cur * hp * ldh + r0;
#pragma unroll 2
    for (int k = 0; k < H; ++k) {
      float hr[REC_RT];
#pragma unroll
      for (int q = 0; q < REC_RT; q += 4) {
        const float4 hv = *reinterpret_cast<const float4*>(h + k * ldh + q);
        hr[q] = hv.x, hr[q + 1] = hv.y, hr[q + 2] = hv.z, hr[q + 3] = hv.w;
      }
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const float4 wv = *reinterpret_cast<const float4*>(w + (g * H + k) * hp + j0);
        const float wc[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int i = 0; i < REC_RT; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[g][i][c] = fmaf(hr[i], wc[c], acc[g][i][c]);
      }
    }

    cp_async_wait<1>();   // this step's gate rows (this thread's own copies)
    const int t = reverse ? T - 1 - step : step;
    float* hn_next = hT + (cur ^ 1) * hp * ldh + r0;
#pragma unroll
    for (int i = 0; i < REC_RT; ++i) {
      const float4 gr = gs[(cur * 3 * REC_RT + 0 * REC_RT + i) * nthreads + tid];
      const float4 gz = gs[(cur * 3 * REC_RT + 1 * REC_RT + i) * nthreads + tid];
      const float4 gn = gs[(cur * 3 * REC_RT + 2 * REC_RT + i) * nthreads + tid];
      const float xr[4] = {gr.x, gr.y, gr.z, gr.w};
      const float xz[4] = {gz.x, gz.y, gz.z, gz.w};
      const float xn[4] = {gn.x, gn.y, gn.z, gn.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float r = gate_sigmoid(xr[c] + acc[0][i][c]);
        const float z = gate_sigmoid(xz[c] + acc[1][i][c]);
        const float n = gate_tanh(xn[c] + r * (acc[2][i][c] + bn[c]));
        hold[i][c] = j0 + c < H ? (1.0f - z) * n + z * hold[i][c] : 0.f;
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int q = 0; q < REC_RT; q += 4)
        *reinterpret_cast<float4*>(hn_next + (j0 + c) * ldh + q) =
            make_float4(hold[q][c], hold[q + 1][c], hold[q + 2][c], hold[q + 3][c]);
#pragma unroll
    for (int i = 0; i < REC_RT; ++i) {
      const int b = b0 + r0 + i;
      if (b >= B) continue;
      float* o = out + ((long long)t * B + b) * H + j0;
      if (VEC) {
        *reinterpret_cast<float4*>(o) = make_float4(hold[i][0], hold[i][1], hold[i][2],
                                                    hold[i][3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (j0 + c < H) o[c] = hold[i][c];
      }
    }
    __syncthreads();   // h of step+1 complete; this step's h buffer free
  }
  cp_async_wait<0>();
}

// Small form, one batch row a block.  Thread (j, ks), ks fastest over KS
// lanes of one warp, keeps its slice k = ks, ks+KS, ... of column j of the
// three W_hh^T gates in registers for the whole time loop, so a step reads
// only h from shared memory (one broadcast word per FMA triple); the KS
// lanes add their sums by shuffles, and lane 0 does column j's gate math,
// its next step's three gate values loaded into registers a step ahead.
// Shared memory: hs [2][hp].
__global__ void __launch_bounds__(REC_SMALL_THREADS)
gru_rec_small_kernel(const float* __restrict__ G, const float* __restrict__ wt,
                     const float* __restrict__ bhn, float* __restrict__ out, int T, int B,
                     int H, int hp, int reverse) {
  constexpr int KS = REC_SMALL_KS;
  extern __shared__ float4 rec_smem4[];
  float* hs = reinterpret_cast<float*>(rec_smem4);
  const int tid = threadIdx.x;
  const int j = tid / KS, ks = tid % KS;
  const bool active = j < H;
  const bool owner = active && ks == 0;
  const long long gate_stride = (long long)T * B * H;
  // this column's gate values at step 0; a step moves them by +-B*H
  const long long step_stride = reverse ? -(long long)B * H : (long long)B * H;
  const float* gp = G + ((long long)(reverse ? T - 1 : 0) * B + blockIdx.x) * H + j;
  float* op = out + ((long long)(reverse ? T - 1 : 0) * B + blockIdx.x) * H + j;

  float w[3][REC_SMALL_MAXK];
#pragma unroll
  for (int i = 0; i < REC_SMALL_MAXK; ++i) {
    const int k = ks + KS * i;
#pragma unroll
    for (int g = 0; g < 3; ++g)
      w[g][i] = active && k < H ? wt[((long long)g * H + k) * H + j] : 0.f;
  }
  for (int i = tid; i < 2 * hp; i += blockDim.x) hs[i] = 0.f;

  const float bn = active ? bhn[j] : 0.f;
  float gx[3] = {0.f, 0.f, 0.f};
  if (owner) {
#pragma unroll
    for (int g = 0; g < 3; ++g) gx[g] = gp[g * gate_stride];
  }
  float hold = 0.f;
  __syncthreads();

  for (int step = 0; step < T; ++step) {
    const int cur = step & 1;
    float gnext[3] = {0.f, 0.f, 0.f};
    if (owner && step + 1 < T) {
#pragma unroll
      for (int g = 0; g < 3; ++g) gnext[g] = gp[step_stride + g * gate_stride];
    }

    // two partial sums a gate halve the dependent chain
    float acc[3][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    const float* h = hs + cur * hp;
#pragma unroll
    for (int i = 0; i < REC_SMALL_MAXK; ++i) {
      const int k = ks + KS * i;
      if (k < H) {
        const float hv = h[k];
#pragma unroll
        for (int g = 0; g < 3; ++g) acc[g][i & 1] = fmaf(hv, w[g][i], acc[g][i & 1]);
      }
    }
    float gh[3];
#pragma unroll
    for (int g = 0; g < 3; ++g) gh[g] = acc[g][0] + acc[g][1];
#pragma unroll
    for (int off = KS / 2; off > 0; off >>= 1)
#pragma unroll
      for (int g = 0; g < 3; ++g) gh[g] += __shfl_xor_sync(0xffffffffu, gh[g], off);

    if (owner) {
      const float r = gate_sigmoid(gx[0] + gh[0]);
      const float z = gate_sigmoid(gx[1] + gh[1]);
      const float n = gate_tanh(gx[2] + r * (gh[2] + bn));
      hold = (1.0f - z) * n + z * hold;
      hs[(cur ^ 1) * hp + j] = hold;
      *op = hold;
    }
    gp += step_stride;
    op += step_stride;
#pragma unroll
    for (int g = 0; g < 3; ++g) gx[g] = gnext[g];
    __syncthreads();
  }
}

}  // namespace

// The launch plan comes from ops/bigru_cuda._plan_gru_fwd, as ten host ints
// at `plan`: gemm_wgmma (1: the wgmma GEMM, W_ih's TF32 planes in `scratch`,
// 2 * 3H * in words; 0: 64 x 64 mma.sync tiles), gemm_vec and gemm_splits
// (the mma.sync tiles' k ranges; > 1: splits * T*B * 3H floats of
// `scratch`) for the projection;
// rec_small (1: the small form, one row a block), rec_rows (rows per
// block), rec_threads, rec_smem (bytes), rec_ks (lanes a column in the
// small form), rec_vec (tiled form: H a multiple of 4) and hp (H rounded
// up to 4) for the recurrence.
extern "C" int mmtr_gru_dir_fwd(const float* x, const float* wp, const float* wt,
                                const float* bc, const float* bhn, float* gates,
                                float* out, void* scratch, int T, int B, int in_dim,
                                int H, int reverse, const int* plan, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int gemm_wgmma = plan[0], gemm_vec = plan[1], gemm_splits = plan[2],
            rec_small = plan[3], rec_rows = plan[4], rec_threads = plan[5],
            rec_smem = plan[6], rec_ks = plan[7], rec_vec = plan[8], hp = plan[9];
  cudaError_t err = launch_gemm_tc(gemm_wgmma != 0, gemm_vec != 0, gemm_splits, x, wp, bc,
                                   gates, T * B, 3 * H, in_dim, H, scratch, stream);
  if (err != cudaSuccess) return (int)err;

  const int blocks = (B + rec_rows - 1) / rec_rows;
  if (rec_small) {
    if (rec_ks != REC_SMALL_KS) return (int)cudaErrorInvalidValue;
    gru_rec_small_kernel<<<blocks, rec_threads, rec_smem, stream>>>(
        gates, wt, bhn, out, T, B, H, hp, reverse);
  } else if (rec_vec) {
    static unsigned long long smem_set = 0;
    err = allow_smem_once((const void*)gru_rec_tiled_kernel<true>, &smem_set);
    if (err != cudaSuccess) return (int)err;
    gru_rec_tiled_kernel<true><<<blocks, rec_threads, rec_smem, stream>>>(
        gates, wt, bhn, out, T, B, H, hp, rec_rows, reverse);
  } else {
    static unsigned long long smem_set = 0;
    err = allow_smem_once((const void*)gru_rec_tiled_kernel<false>, &smem_set);
    if (err != cudaSuccess) return (int)err;
    gru_rec_tiled_kernel<false><<<blocks, rec_threads, rec_smem, stream>>>(
        gates, wt, bhn, out, T, B, H, hp, rec_rows, reverse);
  }
  return (int)cudaGetLastError();
}
