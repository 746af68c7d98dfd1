// The GRU recurrence over pre-projected gates, G independent recurrences,
// shared by K1f (bigru.cu: one direction, G = 1, the projection's [3, T*B,
// H] gate scratch with the input biases folded in) and K7f
// (gru_recurrence.cu: G recurrences with their own weights over three gate
// arrays [G, T, N, H], the recurrent biases b_hr and b_hz added to h W^T).
// Per group g and step:
//
//   r = sigmoid(gate_r + h W_hr^T (+ b_hr))
//   z = sigmoid(gate_z + h W_hz^T (+ b_hz))
//   n = tanh(gate_n + r * (h W_hn^T + b_hn))
//   h' = (1 - z) n + z h
//
// h starts at zero and is carried in float32; `reverse` walks t = T-1 .. 0
// (K1's backward direction; K7 runs forward only, its caller flips).  Every
// step is a [rows, H] x [H, 3H] product and the gate math, sequential in T,
// so a block's per-step latency is what the recurrence pays.  Three forms, the
// launch plan's (ops/bigru_cuda._plan_recurrence, _plan_recurrence_bf16) choice:
//   * tiled (many rows): a block holds W_hh^T of its group in shared memory
//     for the whole time loop; 4 x 4 (row, column) register tiles for all
//     three gates, so one float4 of h and three of W feed 48 FMAs; the next
//     step's gate rows stream in by cp.async while this step's product runs;
//     h double-buffered in shared memory, each thread keeping its own
//     previous h in registers: one barrier a step.  W_hh^T (120 KB at
//     H = 100) leaves room for one block an SM, so the plan picks the rows
//     that give the fewest waves of blocks, and the fewest rows in them;
//   * small (G * rows <= the SM count, H <= 104): a block a (row, group), a
//     thread per (column, k-slice) of KS = 8 lanes holding its slice of
//     W_hh^T in registers, so a step reads only h from shared memory; a
//     shuffle reduction adds the slices, so a step's dependent chain is
//     ~H/(2 KS) FMAs rather than H;
//   * mma (K1f's bf16 instance where the tiled form would run, H <= 104):
//     the product of bf16 hm and bf16 W_hh on the bf16 tensor cores, a warp
//     16 rows with h in its registers; see gru_rec_mma_kernel.
// BIAS_RZ is a template parameter, so K1's instance carries no bias adds.
// WT is the storage type of the weights, b_hn and h (float, or bf16 for
// K1f's bf16 instance: the gates stay float32, h is carried in float32 and
// rounded to bf16 where the JAX kernel rounds it, for the recurrent
// product and the output); the float instances compile as before.  GT is
// the storage type of the gates and of b_hr, b_hz, and CT the type h is
// rounded to before the recurrent product (WT by default).  K7f's bf16
// instance stores everything in bf16 (WT = GT = bf16) but keeps CT float:
// its JAX kernel multiplies the float32 carry by the upcast bf16 weights
// (gru_pallas.py _gates_f32: h float32, w bf16, a float32 dot), so h is
// rounded only where it is stored.
//
// The backward form (gru_rec_bwd_tiled_kernel: K1b's recurrence in
// bigru_bwd.cu, K7b's in gru_recurrence.cu) walks the steps newest-first
// with the same tiling ideas: rows per block chosen so that B=4096 runs in
// one wave, W_hh^T staged once in shared memory, register tiles for both of
// a step's products, the next step's h_prev copied in by cp.async a step
// ahead; see its comment.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace {

// The small form: KS lanes a column, each holding up to MAXK terms of each
// gate's W_hh^T column (H <= KS * MAXK = 104), so H * KS <= 832 threads and
// the launch bound leaves 78 registers a thread.
constexpr int REC_SMALL_KS = 8;
constexpr int REC_SMALL_MAXK = 13;
constexpr int REC_SMALL_THREADS = 832;
constexpr int REC_TILED_THREADS = 256;   // the tiled form's launch bound
constexpr int REC_RT = 4;                // rows a thread of the tiled form owns

// The operands of G recurrences.  Group g's gate and output arrays start
// g * group elements past these pointers, its weights g * H * H and its
// biases g * H.
template <typename WT, typename GT = float, typename CT = WT>
struct GruRecT {
  const GT* gate[3];         // input-side pre-activations r, z, n: [T, B, H] a group
  const WT* w[3];            // W_hh^T of the gates r, z, n: [H, H] a group
  const GT* bias_rz[2];      // b_hr, b_hz [H] a group (read only when BIAS_RZ)
  const WT* bhn;             // b_hn [H] a group
  WT* out;                   // h [T, B, H] a group
  long long group;
  int T, B, H, hp, reverse;
};
using GruRec = GruRecT<float>;

// The gate nonlinearities on the fast exponential and divide (MUFU): with
// the accurate expf / tanhf / IEEE division the gate math and stores took a
// large share of a tiled step in an instrumented trial.  Relative error ~1e-6
// (__expf: 2 + 1.2 |x| ulp), far inside K1's and K7's 1e-4; tanh via
// 1 - 2 / (e^2x + 1) is exact to ~1e-7 absolute, and saturates to +-1
// where e^2x overflows or vanishes.
__device__ __forceinline__ float gate_sigmoid(float v) {
  return __fdividef(1.0f, 1.0f + __expf(-v));
}

__device__ __forceinline__ float gate_tanh(float v) {
  return 1.0f - __fdividef(2.0f, __expf(2.0f * v) + 1.0f);
}

// Group g's W_hh^T (w0, w1, w2: the gates' [H, H] arrays of group 0) into
// shared memory as [3][H][hp], columns H..hp-1 zero.
template <typename WT>
__device__ __forceinline__ void load_wt(float* w, const WT* w0, const WT* w1, const WT* w2,
                                        int g, int H, int hp) {
  const long long wo = (long long)g * H * H;
  for (int i = threadIdx.x; i < 3 * H * hp; i += blockDim.x) {
    const int gk = i / hp, j = i - gk * hp;
    const int gate = gk / H, k = gk - gate * H;
    const WT* src = gate == 0 ? w0 : (gate == 1 ? w1 : w2);
    w[i] = j < H ? ld_f(src + wo + (long long)k * H + j) : 0.f;
  }
}

// The tiled form's copies of one step's gate rows into this thread's slots
// (buffer `buf` of gs [2][3 * RT][threads] float4): rows b0 + r0 .. + RT-1,
// columns j0 .. j0 + 3 of the three gates (gate[]: the group's arrays);
// rows past B read as zero.
template <bool VEC>
__device__ __forceinline__ void tiled_prefetch(float4* gs, const float* const (&gate)[3], int t,
                                               int buf, int B, int H, int b0, int r0, int j0) {
  const int nthreads = blockDim.x, tid = threadIdx.x;
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int i = 0; i < REC_RT; ++i) {
      const int b = b0 + r0 + i;
      float4* dst = gs + (buf * 3 * REC_RT + g * REC_RT + i) * nthreads + tid;
      const float* src = gate[g] + ((long long)t * B + b) * H + j0;
      if (VEC) {
        cp_async16(dst, b < B ? src : gate[g], b < B);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool ok = b < B && j0 + c < H;
          cp_async4(reinterpret_cast<float*>(dst) + c, ok ? src + c : gate[g], ok);
        }
      }
    }
}

// tiled_prefetch for bf16 gates (no cp.async can widen them): this step's
// values of the same rows and columns into registers, zero past B or H.
__device__ __forceinline__ void tiled_read(float (&gx)[3][REC_RT][4], const bf16* const (&gate)[3],
                                           int t, int B, int H, int b0, int r0, int j0) {
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int i = 0; i < REC_RT; ++i) {
      const int b = b0 + r0 + i;
      const bf16* src = gate[g] + ((long long)t * B + b) * H + j0;
#pragma unroll
      for (int c = 0; c < 4; ++c) gx[g][i][c] = b < B && j0 + c < H ? bf2f(src[c]) : 0.f;
    }
}

// Tiled form, block (group of R rows, g).  Thread (rg, jg) owns rows
// 4rg..4rg+3 and columns 4jg..4jg+3 of the block's R rows, for all three
// gates: per k, one float4 of h and three of W feed 48 FMAs (8-row tiles,
// 96 FMAs on five float4s, halved the warps and ran slower on the card).
// Shared memory: w [3][H][hp], hT [2][hp][R+4] (h transposed, so a float4
// is four rows of one column), gs [2][3 * 4][threads] float4 (each thread's
// own gate rows, double-buffered).  VEC: H a multiple of 4 (hp == H,
// 16-byte gate rows).  bf16 gates (GT) skip gs: each step reads its own
// into registers (tiled_read) before the product, used after it.
template <bool VEC, bool BIAS_RZ, typename WT = float, typename GT = float, typename CT = WT>
__global__ void __launch_bounds__(REC_TILED_THREADS)
gru_rec_tiled_kernel(const GruRecT<WT, GT, CT> p, int R) {
  constexpr bool GF = std::is_same<GT, float>::value;
  extern __shared__ float4 rec_smem4[];
  const int T = p.T, B = p.B, H = p.H, hp = p.hp;
  float* w = reinterpret_cast<float*>(rec_smem4);
  const int ldh = R + 4;
  float* hT = w + 3 * H * hp;
  float4* gs = reinterpret_cast<float4*>(hT + 2 * hp * ldh);
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int jgroups = hp / 4;
  const int jg = tid % jgroups, rg = tid / jgroups;
  const int j0 = 4 * jg, r0 = REC_RT * rg;
  const int b0 = blockIdx.x * R, g = blockIdx.y;
  const long long goff = (long long)g * p.group;
  const GT* const gate[3] = {p.gate[0] + goff, p.gate[1] + goff, p.gate[2] + goff};
  WT* const out = p.out + goff;

  load_wt(w, p.w[0], p.w[1], p.w[2], g, H, hp);
  for (int i = tid; i < 2 * hp * ldh; i += nthreads) hT[i] = 0.f;

  float bn[4], br[4], bz[4], hold[REC_RT][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const bool ok = j0 + c < H;
    bn[c] = ok ? ld_f(p.bhn + g * H + j0 + c) : 0.f;
    if constexpr (BIAS_RZ) {
      br[c] = ok ? ld_f(p.bias_rz[0] + (g * H + j0 + c)) : 0.f;
      bz[c] = ok ? ld_f(p.bias_rz[1] + (g * H + j0 + c)) : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < REC_RT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) hold[i][c] = 0.f;

  if constexpr (GF) {
    tiled_prefetch<VEC>(gs, gate, p.reverse ? T - 1 : 0, 0, B, H, b0, r0, j0);
    cp_async_commit();
  }
  __syncthreads();

  for (int step = 0; step < T; ++step) {
    const int cur = step & 1;
    float gx[3][REC_RT][4];   // bf16 gates: this step's, in registers
    if constexpr (GF) {
      if (step + 1 < T)
        tiled_prefetch<VEC>(gs, gate, p.reverse ? T - 2 - step : step + 1, cur ^ 1, B, H, b0,
                            r0, j0);
      cp_async_commit();
    } else {
      tiled_read(gx, gate, p.reverse ? T - 1 - step : step, B, H, b0, r0, j0);
    }

    float acc[3][REC_RT][4];
#pragma unroll
    for (int gt = 0; gt < 3; ++gt)
#pragma unroll
      for (int i = 0; i < REC_RT; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[gt][i][c] = 0.f;
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
      for (int gt = 0; gt < 3; ++gt) {
        const float4 wv = *reinterpret_cast<const float4*>(w + (gt * H + k) * hp + j0);
        const float wc[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int i = 0; i < REC_RT; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[gt][i][c] = fmaf(hr[i], wc[c], acc[gt][i][c]);
      }
    }

    if constexpr (GF) cp_async_wait<1>();   // this step's gate rows (this thread's own copies)
    const int t = p.reverse ? T - 1 - step : step;
    float* hn_next = hT + (cur ^ 1) * hp * ldh + r0;
#pragma unroll
    for (int i = 0; i < REC_RT; ++i) {
      float4 gr, gz, gn;
      if constexpr (GF) {
        gr = gs[(cur * 3 * REC_RT + 0 * REC_RT + i) * nthreads + tid];
        gz = gs[(cur * 3 * REC_RT + 1 * REC_RT + i) * nthreads + tid];
        gn = gs[(cur * 3 * REC_RT + 2 * REC_RT + i) * nthreads + tid];
      } else {
        gr = make_float4(gx[0][i][0], gx[0][i][1], gx[0][i][2], gx[0][i][3]);
        gz = make_float4(gx[1][i][0], gx[1][i][1], gx[1][i][2], gx[1][i][3]);
        gn = make_float4(gx[2][i][0], gx[2][i][1], gx[2][i][2], gx[2][i][3]);
      }
      const float xr[4] = {gr.x, gr.y, gr.z, gr.w};
      const float xz[4] = {gz.x, gz.y, gz.z, gz.w};
      const float xn[4] = {gn.x, gn.y, gn.z, gn.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float ar = acc[0][i][c], az = acc[1][i][c];
        if constexpr (BIAS_RZ) ar += br[c], az += bz[c];
        const float r = gate_sigmoid(xr[c] + ar);
        const float z = gate_sigmoid(xz[c] + az);
        const float n = gate_tanh(xn[c] + r * (acc[2][i][c] + bn[c]));
        hold[i][c] = j0 + c < H ? (1.0f - z) * n + z * hold[i][c] : 0.f;
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int q = 0; q < REC_RT; q += 4)
        *reinterpret_cast<float4*>(hn_next + (j0 + c) * ldh + q) =
            make_float4(as_t<CT>(hold[q][c]), as_t<CT>(hold[q + 1][c]),
                        as_t<CT>(hold[q + 2][c]), as_t<CT>(hold[q + 3][c]));
#pragma unroll
    for (int i = 0; i < REC_RT; ++i) {
      const int b = b0 + r0 + i;
      if (b >= B) continue;
      WT* o = out + ((long long)t * B + b) * H + j0;
      if constexpr (!std::is_same<WT, float>::value) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (j0 + c < H) st_f(o + c, hold[i][c]);
      } else if (VEC) {
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
  if constexpr (GF) cp_async_wait<0>();
}

// Small form, block (row, g).  Thread (j, ks), ks fastest over KS lanes of
// one warp, keeps its slice k = ks, ks+KS, ... of column j of the three
// W_hh^T gates in registers for the whole time loop, so a step reads only h
// from shared memory (one broadcast word per FMA triple); the KS lanes add
// their sums by shuffles, and lane 0 does column j's gate math, its next
// step's three gate values loaded into registers a step ahead.  The gate
// and output elements of a step are found by one 64-bit index off the
// parameter pointers, and b_hr, b_hz sit in shared memory: the launch
// bound leaves 72 registers, and three gate pointers, an output pointer or
// two bias registers more spill.  Shared memory: hs [2][hp], then b_hr and
// b_hz [2][hp] (BIAS_RZ).
template <bool BIAS_RZ, typename WT = float, typename GT = float, typename CT = WT>
__global__ void __launch_bounds__(REC_SMALL_THREADS)
gru_rec_small_kernel(const GruRecT<WT, GT, CT> p) {
  constexpr int KS = REC_SMALL_KS;
  extern __shared__ float4 rec_smem4[];
  float* hs = reinterpret_cast<float*>(rec_smem4);
  const int T = p.T, B = p.B, H = p.H, hp = p.hp;
  float* hb = hs + 2 * hp;
  const int tid = threadIdx.x, g = blockIdx.y;
  const int j = tid / KS, ks = tid % KS;
  const bool active = j < H;
  const bool owner = active && ks == 0;
  // this column's gate values and output at step 0; a step moves them by +-B*H
  const long long step_stride = p.reverse ? -(long long)B * H : (long long)B * H;
  long long at = (long long)g * p.group +
                 ((long long)(p.reverse ? T - 1 : 0) * B + blockIdx.x) * H + j;

  float w[3][REC_SMALL_MAXK];
  const long long wo = (long long)g * H * H;
#pragma unroll
  for (int i = 0; i < REC_SMALL_MAXK; ++i) {
    const int k = ks + KS * i;
#pragma unroll
    for (int gt = 0; gt < 3; ++gt)
      w[gt][i] = active && k < H ? ld_f(p.w[gt] + wo + (long long)k * H + j) : 0.f;
  }
  for (int i = tid; i < 2 * hp; i += blockDim.x) hs[i] = 0.f;

  if constexpr (BIAS_RZ) {
    for (int i = tid; i < H; i += blockDim.x) {
      hb[i] = ld_f(p.bias_rz[0] + (g * H + i));
      hb[hp + i] = ld_f(p.bias_rz[1] + (g * H + i));
    }
  }
  const float bn = active ? ld_f(p.bhn + g * H + j) : 0.f;
  float gx[3] = {0.f, 0.f, 0.f};
  if (owner) {
#pragma unroll
    for (int gt = 0; gt < 3; ++gt) gx[gt] = ld_f(p.gate[gt] + at);
  }
  float hold = 0.f;
  __syncthreads();

  for (int step = 0; step < T; ++step) {
    const int cur = step & 1;
    float gnext[3] = {0.f, 0.f, 0.f};
    if (owner && step + 1 < T) {
#pragma unroll
      for (int gt = 0; gt < 3; ++gt) gnext[gt] = ld_f(p.gate[gt] + (at + step_stride));
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
        for (int gt = 0; gt < 3; ++gt) acc[gt][i & 1] = fmaf(hv, w[gt][i], acc[gt][i & 1]);
      }
    }
    float gh[3];
#pragma unroll
    for (int gt = 0; gt < 3; ++gt) gh[gt] = acc[gt][0] + acc[gt][1];
#pragma unroll
    for (int off = KS / 2; off > 0; off >>= 1)
#pragma unroll
      for (int gt = 0; gt < 3; ++gt) gh[gt] += __shfl_xor_sync(0xffffffffu, gh[gt], off);

    if (owner) {
      if constexpr (BIAS_RZ) gh[0] += hb[j], gh[1] += hb[hp + j];
      const float r = gate_sigmoid(gx[0] + gh[0]);
      const float z = gate_sigmoid(gx[1] + gh[1]);
      const float n = gate_tanh(gx[2] + r * (gh[2] + bn));
      hold = (1.0f - z) * n + z * hold;
      hs[(cur ^ 1) * hp + j] = as_t<CT>(hold);
      st_f(p.out + at, hold);
    }
    at += step_stride;
#pragma unroll
    for (int gt = 0; gt < 3; ++gt) gx[gt] = gnext[gt];
    __syncthreads();
  }
}

// The mma form: K1f's bf16 instance only (WT = CT = bf16, float32 gates, G
// = 1, no b_hr / b_hz), whose product operands are both bf16 values: hm =
// h rounded to bf16, and W_hh.  That is a bf16 tensor-core product with
// float32 sums, so it runs on mma.sync m16n8k16: a step's [16, 112] x [112,
// 3 x 104] for a row group of 16 (H padded to 104 columns, 13 n tiles a
// gate, and K to 112, 7 k steps).  RM_WPG = 4 warps share a row group and
// split its n tiles (4, 3, 3, 3 at H = 100): each runs its tiles' three
// gate products from ldmatrix loads of W_hh, then the gate math in the
// accumulator layout on the float32 carry it holds in that same layout, for
// the whole time loop.  The new h, rounded to bf16 (the bf16 output too),
// goes to the row group's double-buffered hm [16][RM_HLD] in shared memory,
// and the group's warps meet at a named barrier, once a step, before they
// load the next step's A fragments from it.  On the card at B=4096, T=50
// (tools/k1f_bf16_trials.py): a warp holding all 13 tiles, its h handed
// from the accumulators to the next step's A fragments in registers with no
// barrier at all, ran 0.87 ms against the tiled form's 0.64 (its gate math
// and 273 MMAs a step left it latency-bound at one warp an SM
// sub-partition); split over two warps 0.32, over four 0.23; four warps of
// four tile slots each (16 for 13, no branch among the MMAs) 0.27.
// Each lane prefetches its own gate values a step ahead by cp.async (8 or 4
// bytes, zero past B and H) into a slot of its own, so no lane waits on
// another's copies.  W_hh (row j = column j of W_hh^T, k contiguous) is
// staged once and read by ldmatrix, two k steps of one n tile a load.
// Shared memory: W [3][8 nt][RM_WLD] bf16, b_hn [8 nt] float, hm [RG][2][16]
// [RM_HLD] bf16, then per warp gates [2][3][RM_TPW][2][32] float2: 188,960
// bytes at H = 100 and RG = 2 row groups, one block an SM.  The plan
// (ops/bigru_cuda._plan_recurrence_bf16) gives a block 32 rows where 16-row
// blocks would overfill the card (B=4096: 128 blocks of 8 warps, one wave),
// else 16.
constexpr int RM_NT = 13;       // n tiles of 8 columns a gate: H <= 104
constexpr int RM_KS = 7;        // k steps of 16 (A fragments)
constexpr int RM_WPG = 4;       // warps a row group of 16
constexpr int RM_TPW = 4;       // n tiles a warp at most (ceil(RM_NT / RM_WPG))
constexpr int RM_WLD = 120;     // W's row pitch (bf16): 240 bytes, 15 16-byte words (odd)
constexpr int RM_HLD = 120;     // hm's row pitch (bf16), as W's
constexpr int RM_MAX_RG = 2;
constexpr int RM_JCH = (8 * RM_NT + 31) / 32;   // 32-row chunks of W's rows
static_assert(RM_WPG * RM_TPW >= RM_NT && 16 * RM_KS >= 8 * RM_NT && RM_HLD >= 16 * RM_KS &&
                  RM_WLD >= 16 * RM_KS,
              "mma form tiles");

// This lane's gate values of step t: rows b0 + g8 (+ 8), columns 8 j + 2 t4
// (+ 1) of its warp's tiles j = j0 .. j0 + cnt - 1, three gates, into its
// slots gs[(g * RM_TPW + q) * 2 + half][lane] (float2); zero past B or H.
// VEC: H even, one 8-byte copy a pair.
template <bool VEC>
__device__ __forceinline__ void mma_prefetch(float2* gs, const float* const (&gate)[3], int t,
                                             int B, int H, int b0, int j0, int cnt) {
  const int lane = threadIdx.x % 32, g8 = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int q = 0; q < RM_TPW; ++q) {
    if (q < cnt) {
      const int col = 8 * (j0 + q) + 2 * t4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = b0 + g8 + 8 * half;
        const long long at = ((long long)t * B + row) * H + col;
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          float2* dst = gs + ((g * RM_TPW + q) * 2 + half) * 32 + lane;
          if (VEC) {
            const bool ok = row < B && col < H;
            cp_async8(dst, ok ? gate[g] + at : gate[g], ok);
          } else {
            const bool ok0 = row < B && col < H, ok1 = row < B && col + 1 < H;
            cp_async4(&dst->x, ok0 ? gate[g] + at : gate[g], ok0);
            cp_async4(&dst->y, ok1 ? gate[g] + at + 1 : gate[g], ok1);
          }
        }
      }
    }
  }
}

// One element of the gate math, as the tiled form's (no b_hr, b_hz).
__device__ __forceinline__ float mma_cell(float xr, float xz, float xn, float ar, float az,
                                          float an, float bn, float h, bool ok) {
  const float r = gate_sigmoid(xr + ar);
  const float z = gate_sigmoid(xz + az);
  const float n = gate_tanh(xn + r * (an + bn));
  return ok ? (1.0f - z) * n + z * h : 0.f;
}

template <bool VEC>
__global__ void __launch_bounds__(32 * RM_WPG * RM_MAX_RG)
gru_rec_mma_kernel(const GruRecT<bf16> p) {
  extern __shared__ float4 rec_smem4[];
  const int T = p.T, B = p.B, H = p.H;
  const int nt = (H + 7) / 8, ks = (H + 15) / 16, np = 8 * nt;
  const int rgs = blockDim.x / (32 * RM_WPG);
  bf16* w = reinterpret_cast<bf16*>(rec_smem4);               // [3][np][RM_WLD]
  float* bn = reinterpret_cast<float*>(w + 3 * np * RM_WLD);  // [np]
  bf16* hs0 = reinterpret_cast<bf16*>(bn + np);               // [rgs][2][16][RM_HLD]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g8 = lane / 4, t4 = lane % 4;
  const int rg = warp / RM_WPG, c = warp - rg * RM_WPG;
  bf16* hs = hs0 + rg * 2 * 16 * RM_HLD;                      // [2][16][RM_HLD]
  float2* gs = reinterpret_cast<float2*>(hs0 + rgs * 2 * 16 * RM_HLD) +
               warp * 2 * 3 * RM_TPW * 2 * 32;                // [2][3][TPW][2][32]
  const int b0 = (blockIdx.x * rgs + rg) * 16;
  // this warp's n tiles j0 .. j0 + cnt - 1: nt split as evenly as it goes
  const int cnt = nt / RM_WPG + (c < nt % RM_WPG), j0 = c * (nt / RM_WPG) + min(c, nt % RM_WPG);
  const float* const gate[3] = {p.gate[0], p.gate[1], p.gate[2]};

  // W_hh^T read along its rows (a warp a row (gate, k), lanes over j),
  // stored as W_hh (row j, k contiguous), zero past H: eight rows' loads in
  // flight before their stores.  hm's buffers start zero (its padded k
  // columns stay so).
  const int nwarps = blockDim.x / 32;
  for (int gk0 = warp; gk0 < 3 * RM_WLD; gk0 += 8 * nwarps) {
    bf16 v[8][RM_JCH];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int gk = gk0 + u * nwarps, gt = gk / RM_WLD, k = gk - gt * RM_WLD;
#pragma unroll
      for (int jj = 0; jj < RM_JCH; ++jj) {
        const int j = lane + 32 * jj;
        v[u][jj] = gk < 3 * RM_WLD && j < H && k < H ? p.w[gt][(long long)k * H + j]
                                                     : f2bf(0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int gk = gk0 + u * nwarps, gt = gk / RM_WLD, k = gk - gt * RM_WLD;
#pragma unroll
      for (int jj = 0; jj < RM_JCH; ++jj) {
        const int j = lane + 32 * jj;
        if (gk < 3 * RM_WLD && j < np) w[(gt * np + j) * RM_WLD + k] = v[u][jj];
      }
    }
  }
  for (int j = threadIdx.x; j < np; j += blockDim.x) bn[j] = j < H ? ld_f(p.bhn + j) : 0.f;
  for (int i = threadIdx.x; i < rgs * 2 * 16 * RM_HLD; i += blockDim.x) hs0[i] = f2bf(0.f);
  __syncthreads();
  if (b0 >= B) return;   // the whole row group: its barrier is its own
  mma_prefetch<VEC>(gs, gate, p.reverse ? T - 1 : 0, B, H, b0, j0, cnt);
  cp_async_commit();

  // the carry of tiles j0 + q: rows g8 (e < 2) and g8 + 8, columns
  // 8 (j0 + q) + 2 t4 + (e & 1)
  float hc[RM_TPW][4];
#pragma unroll
  for (int q = 0; q < RM_TPW; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) hc[q][e] = 0.f;

  for (int step = 0; step < T; ++step) {
    const int cur = step & 1;
    const bf16* hcur = hs + cur * 16 * RM_HLD;
    bf16* hnext = hs + (cur ^ 1) * 16 * RM_HLD;
    uint32_t a[RM_KS][4];   // hm as the A operand (zero at step 0)
#pragma unroll
    for (int m = 0; m < RM_KS; ++m)
      if (m < ks) ldsm_x4(a[m], hcur + (lane & 15) * RM_HLD + 16 * m + (lane >> 4) * 8);
    cp_async_wait<0>();      // this lane's gate values of this step
    const float2* gcur = gs + cur * 3 * RM_TPW * 2 * 32;
    if (step + 1 < T)
      mma_prefetch<VEC>(gs + (cur ^ 1) * 3 * RM_TPW * 2 * 32, gate,
                        p.reverse ? T - 2 - step : step + 1, B, H, b0, j0, cnt);
    cp_async_commit();
    const int t = p.reverse ? T - 1 - step : step;
#pragma unroll
    for (int q = 0; q < RM_TPW; ++q) {
      if (q < cnt) {
        const int j = j0 + q;
        float acc[3][4] = {};
        const bf16* wj = w + (8 * j + (lane & 7)) * RM_WLD + (lane >> 3) * 8;
#pragma unroll
        for (int m = 0; m < RM_KS; m += 2) {
          if (m < ks) {
#pragma unroll
            for (int gt = 0; gt < 3; ++gt) {
              uint32_t r[4];   // b0, b1 of k steps m and m + 1, n tile j
              ldsm_x4(r, wj + gt * np * RM_WLD + 16 * m);
              mma_bf16(acc[gt], a[m], r[0], r[1]);
              if (m + 1 < ks) mma_bf16(acc[gt], a[m + 1 < RM_KS ? m + 1 : m], r[2], r[3]);
            }
          }
        }
        const int col = 8 * j + 2 * t4;
        const float2 bv = *reinterpret_cast<const float2*>(bn + col);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int e = 2 * half;
          const float2 xr = gcur[((0 * RM_TPW + q) * 2 + half) * 32 + lane];
          const float2 xz = gcur[((1 * RM_TPW + q) * 2 + half) * 32 + lane];
          const float2 xn = gcur[((2 * RM_TPW + q) * 2 + half) * 32 + lane];
          hc[q][e] = mma_cell(xr.x, xz.x, xn.x, acc[0][e], acc[1][e], acc[2][e], bv.x,
                              hc[q][e], col < H);
          hc[q][e + 1] = mma_cell(xr.y, xz.y, xn.y, acc[0][e + 1], acc[1][e + 1],
                                  acc[2][e + 1], bv.y, hc[q][e + 1], col + 1 < H);
          // h rounded to bf16: the next step's hm and the output
          const uint32_t hm = pack_bf16(hc[q][e], hc[q][e + 1]);
          const int r = g8 + 8 * half, row = b0 + r;
          *reinterpret_cast<uint32_t*>(hnext + r * RM_HLD + col) = hm;
          if (row < B && col < H) {
            bf16* o = p.out + ((long long)t * B + row) * H + col;
            if (H % 2 == 0) {
              *reinterpret_cast<uint32_t*>(o) = hm;
            } else {
              o[0] = __ushort_as_bfloat16((unsigned short)(hm & 0xffffu));
              if (col + 1 < H) o[1] = __ushort_as_bfloat16((unsigned short)(hm >> 16));
            }
          }
        }
      }
    }
    // the row group's hm of step + 1 complete; its hm of this step read
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + rg), "r"(32 * RM_WPG) : "memory");
  }
  cp_async_wait<0>();
}

// Launch the mma form by its four host ints (ops/bigru_cuda.
// _plan_recurrence_bf16): rows (16 a row group), threads (RM_WPG warps a
// row group), smem (bytes), vec (H even: 8-byte gate copies).  The grid is
// ceil(B / rows).  (A template, so a unit that includes this header and
// never calls it builds no instance of the kernel.)
template <typename WT>
cudaError_t launch_gru_rec_mma(const GruRecT<WT>& p, const int* rec, cudaStream_t stream) {
  static_assert(std::is_same<WT, bf16>::value, "the mma form takes bf16 weights and carry");
  const int rows = rec[0], threads = rec[1], smem = rec[2], vec = rec[3];
  if (rows % 16 != 0 || rows > 16 * RM_MAX_RG || threads != rows / 16 * 32 * RM_WPG ||
      p.H > 8 * RM_NT || (vec && p.H % 2 != 0))
    return cudaErrorInvalidValue;
  const dim3 grid((p.B + rows - 1) / rows);
  if (vec) {
    static unsigned long long smem_set = 0;
    const cudaError_t err = allow_smem_once((const void*)gru_rec_mma_kernel<true>, &smem_set);
    if (err != cudaSuccess) return err;
    gru_rec_mma_kernel<true><<<grid, threads, smem, stream>>>(p);
  } else {
    static unsigned long long smem_set = 0;
    const cudaError_t err = allow_smem_once((const void*)gru_rec_mma_kernel<false>, &smem_set);
    if (err != cudaSuccess) return err;
    gru_rec_mma_kernel<false><<<grid, threads, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The backward form: the gradients of G recurrences (K1b: G = 1) walked
// newest-first.  Per group and step t, for h_prev = h[t-1] (h[t+1] in
// reverse; zero at the sequence's start) and the carried dh:
//
//   gh_g = h_prev W_hg^T (g = r, z, n), recomputed in the forward's order,
//   so r, z, n come out as the forward's tiled form made them
//   r = sigmoid(gate_r + gh_r (+ b_hr)), z = sigmoid(gate_z + gh_z (+ b_hz)),
//   n = tanh(gate_n + r * (gh_n + b_hn))
//   dht = dh_in[t] + dh;  da_n = dht (1 - z) (1 - n^2);  dghn = da_n r
//   da_r = da_n (gh_n + b_hn) r (1 - r);  da_z = dht (h_prev - n) z (1 - z)
//   dh <- dht z + [da_r da_z dghn] W_hh      (the carry, a [3H] x [3H, H] product)
//
// and writes the row (da_n, da_r, da_z, dghn) of dg [T*B, 4H]: columns
// 0..3H are the input-side pre-activation gradients (dwp = x^T dg[:, :3H],
// dx = dg[:, :3H] wp^T in that gate order) and H..4H the recurrent ones
// (dwt = h_prev^T dg[:, H:], taken from [h_prev | 1]^T dg with the column
// sums), so each weight reduction reads one contiguous column range.
// Thread (rg, jg) owns rows 4rg..4rg+3 and the strided columns jg + js*c
// (c < 4, js = ceil(H / 4)) of the block's R rows, in the gate math and in
// both products, so the carried dh stays in its registers from one step to
// the next.  Both products read W_hh^T from
// one copy in shared memory, w [3][4js][wp] with an odd row pitch wp:
// the recompute reads w[g][k][jg + js c] (consecutive jg, consecutive
// words), the carry w[g][jg + js c][j] (consecutive jg, words wp apart:
// distinct banks because wp is odd), both free of bank conflicts, one
// broadcast float4 of the other operand (h_prev or da, stored transposed,
// four rows of one column) per 12 or 4 words of w.  Shared memory: w, then
// hT [2][4js][R+4] (h_prev transposed, double-buffered: the next step's
// rows arrive by 4-byte cp.async while this step computes) and daT
// [3][4js][R+4] (da_r, da_z, dghn transposed, for the carry).  The gate
// rows and dh_in come from global memory into registers at the start of a
// step and are used after the recompute (W_hh^T and these leave no room
// for a shared-memory copy of them).  Two barriers a step: da complete
// before the carry reads it, the carry done (and the next h_prev landed)
// before the next step writes da.  The gate math is the forward's fast
// gate_sigmoid / gate_tanh, so r, z, n match the forward's tiled form bit
// for bit (BIAS_RZ, as the forward's: b_hr and b_hz added to h W^T where
// its tiled form adds them).  Group g (blockIdx.y) reads its arrays `group`
// floats (dg: 4 group) past the pointers, its weights g*H*H and biases g*H:
// K1b runs one group over the [3, T*B, H] gate scratch with the biases
// folded in (BIAS_RZ false), K7b G groups over [G, T, N, H] gate arrays.
// WT as the forward's: K1b's bf16 instance reads bf16 weights, h and dh,
// rounds da_r, da_z and dghn to bf16 for the carry and writes dg in bf16,
// where the JAX kernel casts them to the operand dtype (h_prev, read from
// the forward's bf16 output, is then the value the JAX kernel reads too).
// GT and CT as the forward's: K7b's bf16 instance reads bf16 gates and
// biases and writes dg in bf16 but carries da unrounded (CT float), as its
// JAX kernel's float32 dot_general does; its h_prev is the rounded stored
// h, so its r, z, n are not K7f's, nor meant to be.
template <typename WT, typename GT = float, typename CT = WT>
struct GruRecBwdT {
  const GT* gate[3];        // input-side pre-activations r, z, n: [T, B, H] a group
  const WT* w[3];           // W_hh^T of r, z, n: [H, H] a group
  const GT* bias_rz[2];     // b_hr, b_hz [H] a group (read only when BIAS_RZ)
  const WT* bhn;            // b_hn [H] a group
  const WT* hs;             // the forward's h [T, B, H] a group
  const WT* dhs;            // its cotangent [T, B, H] a group
  WT* dg;                   // [T*B, 4H] a group: da_n, da_r, da_z, dghn
  long long group;
  int T, B, H, js, wp, reverse;
};
using GruRecBwd = GruRecBwdT<float>;

// hT[j][r] = h[tp][b][j] for this thread's own rows b = b0 + r0 .. + 3 and
// columns j = jg + js c (zero where tp falls outside [0, T) or b >= B):
// 4-byte copies, coalesced along j across the warp.
__device__ __forceinline__ void bwd_stage_h(float* hT, const float* hs, int tp, int T, int B,
                                            int H, int b0, int r0, int jg, int js, int ldr) {
  const bool has = tp >= 0 && tp < T;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + r0 + i;
    const float* row = hs + ((long long)tp * B + b) * H;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = jg + js * c;
      const bool ok = has && b < B && j < H;
      cp_async4(hT + j * ldr + r0 + i, ok ? row + j : hs, ok);
    }
  }
}

// bwd_stage_h for bf16 h (no cp.async can widen it): the same elements
// read into registers (v), and stored by bwd_store_h.
__device__ __forceinline__ void bwd_read_h(float (&v)[4][4], const bf16* hs, int tp, int T,
                                           int B, int H, int b0, int r0, int jg, int js) {
  const bool has = tp >= 0 && tp < T;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + r0 + i;
    const bf16* row = hs + ((long long)tp * B + b) * H;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = jg + js * c;
      v[i][c] = has && b < B && j < H ? bf2f(row[j]) : 0.f;
    }
  }
}

__device__ __forceinline__ void bwd_store_h(float* hT, const float (&v)[4][4], int r0, int jg,
                                            int js, int H, int ldr) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = jg + js * c;
      if (j < H) hT[j * ldr + r0 + i] = v[i][c];
    }
}

template <bool BIAS_RZ, typename WT = float, typename GT = float, typename CT = WT>
__global__ void __launch_bounds__(REC_TILED_THREADS)
gru_rec_bwd_tiled_kernel(const GruRecBwdT<WT, GT, CT> p, int R) {
  constexpr bool F32 = std::is_same<WT, float>::value;
  extern __shared__ float4 rec_smem4[];
  const int T = p.T, B = p.B, H = p.H, js = p.js, hk = 4 * js, wp = p.wp, ldr = R + 4;
  float* w = reinterpret_cast<float*>(rec_smem4);   // [3][hk][wp]
  float* hT = w + 3 * hk * wp;                      // [2][hk][ldr]
  float* daT = hT + 2 * hk * ldr;                   // [3][hk][ldr]
  const int tid = threadIdx.x;
  const int jg = tid % js, rg = tid / js, r0 = 4 * rg;
  const int b0 = blockIdx.x * R, g = blockIdx.y;
  const long long goff = (long long)g * p.group;
  const GT* const gate[3] = {p.gate[0] + goff, p.gate[1] + goff, p.gate[2] + goff};
  const WT* const hs = p.hs + goff;
  const WT* const dhs = p.dhs + goff;
  WT* const dg = p.dg + 4 * goff;
  const int H4 = 4 * H;

  const long long wo = (long long)g * H * H;
  for (int i = tid; i < 3 * hk * wp; i += blockDim.x) {
    const int gk = i / wp, j = i - gk * wp;
    const int gt = gk / hk, k = gk - gt * hk;
    // a select, not p.w[gt]: a runtime index into the parameter struct
    // would copy it to local memory
    const WT* src = gt == 0 ? p.w[0] : (gt == 1 ? p.w[1] : p.w[2]);
    w[i] = k < H && j < H ? ld_f(src + wo + (long long)k * H + j) : 0.f;
  }
  float bn[4], br[4], bz[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = jg + js * c;
    bn[c] = j < H ? ld_f(p.bhn + g * H + j) : 0.f;
    if constexpr (BIAS_RZ) {
      br[c] = j < H ? ld_f(p.bias_rz[0] + (g * H + j)) : 0.f;
      bz[c] = j < H ? ld_f(p.bias_rz[1] + (g * H + j)) : 0.f;
    }
  }
  for (int i = tid; i < 2 * hk * ldr; i += blockDim.x) hT[i] = 0.f;   // rows H.. stay 0
  __syncthreads();
  // newest first: the forward direction's last step is t = T-1, the
  // reverse direction's is t = 0; step t's h_prev is h[t + dt]
  const int t_first = p.reverse ? 0 : T - 1, dt = p.reverse ? 1 : -1;
  float hnx[4][4];   // the bf16 instance's next h_prev, in flight in registers
  if constexpr (F32) {
    bwd_stage_h(hT, hs, t_first + dt, T, B, H, b0, r0, jg, js, ldr);
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    bwd_read_h(hnx, hs, t_first + dt, T, B, H, b0, r0, jg, js);
    bwd_store_h(hT, hnx, r0, jg, js, H, ldr);
  }
  __syncthreads();

  float dh[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) dh[i][c] = 0.f;

  for (int step = 0; step < T; ++step) {
    const int t = t_first + dt * step, cur = step & 1;
    if constexpr (F32) {
      if (step + 1 < T)
        bwd_stage_h(hT + (cur ^ 1) * hk * ldr, hs, t + 2 * dt, T, B, H, b0, r0, jg, js, ldr);
      cp_async_commit();
    } else if (step + 1 < T) {
      bwd_read_h(hnx, hs, t + 2 * dt, T, B, H, b0, r0, jg, js);
    }

    // this step's gate inputs and incoming dh, used after the recompute
    float gx[3][4][4], dy[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int b = b0 + r0 + i, j = jg + js * c;
        const bool ok = b < B && j < H;
        const long long at = ((long long)t * B + b) * H + j;
#pragma unroll
        for (int gt = 0; gt < 3; ++gt) gx[gt][i][c] = ok ? ld_f(gate[gt] + at) : 0.f;
        dy[i][c] = ok ? ld_f(dhs + at) : 0.f;
      }

    // the recompute, h_prev W^T, in the forward's k order
    float acc[3][4][4];
#pragma unroll
    for (int gt = 0; gt < 3; ++gt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[gt][i][c] = 0.f;
    const float* h = hT + cur * hk * ldr + r0;
#pragma unroll 2
    for (int k = 0; k < H; ++k) {
      const float4 hv = *reinterpret_cast<const float4*>(h + k * ldr);
      const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int gt = 0; gt < 3; ++gt) {
        const float* wk = w + (gt * hk + k) * wp + jg;
        float wc[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) wc[c] = wk[js * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[gt][i][c] = fmaf(hr[i], wc[c], acc[gt][i][c]);
      }
    }

    // the gate math: dg's row, da for the carry, dht z as the carry's start
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = jg + js * c;
      const float4 hv = *reinterpret_cast<const float4*>(h + j * ldr);
      const float hprev[4] = {hv.x, hv.y, hv.z, hv.w};
      float dar[4], daz[4], dgn[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float ar = acc[0][i][c], az = acc[1][i][c];
        if constexpr (BIAS_RZ) ar += br[c], az += bz[c];
        const float r = gate_sigmoid(gx[0][i][c] + ar);
        const float z = gate_sigmoid(gx[1][i][c] + az);
        const float ghn = acc[2][i][c] + bn[c];
        const float n = gate_tanh(gx[2][i][c] + r * ghn);
        const float dht = dy[i][c] + dh[i][c];
        const float da_n = dht * (1.0f - z) * (1.0f - n * n);
        // K1b's bf16 instance's carry reads these rounded, as dg holds them
        dgn[i] = as_t<CT>(da_n * r);
        dar[i] = as_t<CT>(da_n * ghn * r * (1.0f - r));
        daz[i] = as_t<CT>(dht * (hprev[i] - n) * z * (1.0f - z));
        dh[i][c] = dht * z;
        const int b = b0 + r0 + i;
        if (b < B && j < H) {
          WT* o = dg + ((long long)t * B + b) * H4 + j;
          st_f(o, da_n);
          st_f(o + H, dar[i]);
          st_f(o + 2 * H, daz[i]);
          st_f(o + 3 * H, dgn[i]);
        }
      }
      *reinterpret_cast<float4*>(daT + (0 * hk + j) * ldr + r0) =
          make_float4(dar[0], dar[1], dar[2], dar[3]);
      *reinterpret_cast<float4*>(daT + (1 * hk + j) * ldr + r0) =
          make_float4(daz[0], daz[1], daz[2], daz[3]);
      *reinterpret_cast<float4*>(daT + (2 * hk + j) * ldr + r0) =
          make_float4(dgn[0], dgn[1], dgn[2], dgn[3]);
    }
    __syncthreads();   // da of every row and column in daT

    // the carry: dh[k] = dht z + sum over (g, j) of da_g[j] W_hg^T[k][j]
#pragma unroll
    for (int gt = 0; gt < 3; ++gt) {
      const float* wk = w + (gt * hk + jg) * wp;
      const float* da = daT + gt * hk * ldr + r0;
#pragma unroll 4
      for (int j = 0; j < H; ++j) {
        const float4 dv = *reinterpret_cast<const float4*>(da + j * ldr);
        const float dr[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float wv = wk[js * c * wp + j];
#pragma unroll
          for (int i = 0; i < 4; ++i) dh[i][c] = fmaf(dr[i], wv, dh[i][c]);
        }
      }
    }
    if constexpr (F32) {
      cp_async_wait<0>();   // this thread's copies of the next h_prev
    } else if (step + 1 < T) {
      bwd_store_h(hT + (cur ^ 1) * hk * ldr, hnx, r0, jg, js, H, ldr);
    }
    __syncthreads();      // ... everyone's; daT free for the next step
  }
}

// The backward's mma form: K1b's bf16 instance where the tiled form would
// run (B past the SM count) and H <= 104.  Both of a step's products are
// bf16 x bf16 with float32 sums in the JAX kernel (bigru_pallas.py
// _bwd_kernel: the recompute h_prev @ wt[g], the carry da_g . wt[g]^T with
// da_g cast to bf16), so they run on mma.sync m16n8k16, as the forward's
// gru_rec_mma_kernel runs its product.  A row group of 16 rows, its n tiles
// of 8 columns (13 at H = 100) split over RM_WPG = 4 warps (4, 3, 3, 3), for
// the whole time loop; per step, newest first:
//   * the recompute: h_prev [16][112] (the forward's stored bf16 h, zeros
//     at the sequence's start; H padded to 7 k steps) times W_hh^T, three
//     gates, a warp its own tiles;
//   * the gate math in the accumulator layout, on the forward's float32
//     gate scratch (each lane's own values, prefetched a step ahead by
//     cp.async into a slot of its own) and the float32 dh carried in the
//     same layout: da_n, da_r, da_z and dghn, the last three rounded to bf16
//     as the JAX kernel rounds them, written to dg [T*B, 4H] (bf16, columns
//     n, r, z, dghn as the reductions read them) and, for the carry, to the
//     row group's da [3][16][112] in shared memory;
//   * a named barrier (the row group's four warps: da complete, the next
//     step's h_prev landed);
//   * the carry: dh = dht z + da_r W_r^T + da_z W_z^T + dghn W_n^T, one
//     chain of K = 3 x 112 on the tensor cores, started from dht z and
//     summed gate by gate (r, z, n) and k step by k step: another float32
//     order than the JAX kernel's three dots added to dht z, within the
//     bf16 tolerance.
// One copy of W_hh^T serves both products: w[g][a][b] = wt[g][a][b], rows
// and columns padded to 112; the recompute reads it as B [k = a][n = b] by
// ldmatrix.trans, the carry as B^T [n = a][k = b] by ldmatrix.  h_prev and
// da are double-buffered, so a step has one barrier.  Shared memory: w
// [3][112][RM_WLD] bf16 (80,640 bytes), b_hn [104] float, per row group hm
// [2][16][RM_HLD] and da [2][3][16][RM_HLD] bf16, per warp the gate slots
// [3][RM_TPW][2][32] float2 and dh_in's [RM_TPW][2][32] bf16 pairs:
// 199,840 bytes at two row groups, one block an SM.  VEC: H a multiple of 4
// (8-byte copies of h_prev and of gate pairs, 4-byte dg and dh_in pairs);
// else element by element.
constexpr int RB_KP = 16 * RM_KS;   // H padded to whole k steps: W's rows and columns

// This lane's gate values and dh_in of step t (rows b0 + g8 (+ 8), columns
// 8 j + 2 t4 (+ 1) of its tiles j0 .. j0 + cnt - 1) into its slots; zero
// past B or H.  Without VEC dh_in is read where it is used.
template <bool VEC>
__device__ __forceinline__ void bwd_mma_prefetch(float2* gs, uint32_t* ds,
                                                 const float* const (&gate)[3],
                                                 const bf16* dhs, int t, int B, int H, int b0,
                                                 int j0, int cnt) {
  const int lane = threadIdx.x % 32, g8 = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int q = 0; q < RM_TPW; ++q) {
    if (q < cnt) {
      const int col = 8 * (j0 + q) + 2 * t4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = b0 + g8 + 8 * half, slot = (q * 2 + half) * 32 + lane;
        const long long at = ((long long)t * B + row) * H + col;
        const bool ok0 = row < B && col < H, ok1 = row < B && col + 1 < H;
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          float2* dst = gs + g * RM_TPW * 2 * 32 + slot;
          if (VEC) {
            cp_async8(dst, ok0 ? gate[g] + at : gate[g], ok0);
          } else {
            cp_async4(&dst->x, ok0 ? gate[g] + at : gate[g], ok0);
            cp_async4(&dst->y, ok1 ? gate[g] + at + 1 : gate[g], ok1);
          }
        }
        if (VEC) cp_async4(ds + slot, ok0 ? dhs + at : dhs, ok0);
      }
    }
  }
}

// The row group's h_prev of step t (h[tp], zeros where tp falls outside
// [0, T) or a row past B) into hm [16][RM_HLD], columns 0 .. H-1: 8-byte
// copies (VEC), else element by element through registers.
template <bool VEC>
__device__ __forceinline__ void bwd_mma_stage_h(bf16* hm, const bf16* hs, int tp, int T, int B,
                                                int H, int b0) {
  const int tid = threadIdx.x % (32 * RM_WPG);
  const bool has = tp >= 0 && tp < T;
  const int per = VEC ? H / 4 : H;
  for (int i = tid; i < 16 * per; i += 32 * RM_WPG) {
    const int r = i / per, c = (i - r * per) * (VEC ? 4 : 1), row = b0 + r;
    const bool ok = has && row < B;
    const bf16* src = hs + ((long long)(ok ? tp : 0) * B + (ok ? row : 0)) * H + c;
    if (VEC)
      cp_async8(hm + r * RM_HLD + c, src, ok);
    else
      hm[r * RM_HLD + c] = ok ? *src : f2bf(0.f);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(32 * RM_WPG * RM_MAX_RG)
gru_rec_bwd_mma_kernel(const GruRecBwdT<bf16> p, bf16* __restrict__ hp, int hpc) {
  extern __shared__ float4 rec_smem4[];
  const int T = p.T, B = p.B, H = p.H, H4 = 4 * H;
  const int nt = (H + 7) / 8, ks = (H + 15) / 16;
  const int rgs = blockDim.x / (32 * RM_WPG), nwarps = blockDim.x / 32;
  bf16* w = reinterpret_cast<bf16*>(rec_smem4);                  // [3][RB_KP][RM_WLD]
  float* bn = reinterpret_cast<float*>(w + 3 * RB_KP * RM_WLD);  // [8 RM_NT]
  bf16* hm0 = reinterpret_cast<bf16*>(bn + 8 * RM_NT);           // [rgs][2][16][RM_HLD]
  bf16* da0 = hm0 + rgs * 2 * 16 * RM_HLD;                       // [rgs][2][3][16][RM_HLD]
  float2* gs0 = reinterpret_cast<float2*>(da0 + rgs * 2 * 3 * 16 * RM_HLD);
  uint32_t* ds0 = reinterpret_cast<uint32_t*>(gs0 + nwarps * 3 * RM_TPW * 2 * 32);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g8 = lane / 4, t4 = lane % 4;
  const int rg = warp / RM_WPG, c = warp - rg * RM_WPG;
  bf16* hm = hm0 + rg * 2 * 16 * RM_HLD;                         // [2][16][RM_HLD]
  bf16* da = da0 + rg * 2 * 3 * 16 * RM_HLD;                     // [2][3][16][RM_HLD]
  float2* gs = gs0 + warp * 3 * RM_TPW * 2 * 32;                 // [3][TPW][2][32]
  uint32_t* ds = ds0 + warp * RM_TPW * 2 * 32;                   // [TPW][2][32]
  const int b0 = (blockIdx.x * rgs + rg) * 16;
  // this warp's n tiles j0 .. j0 + cnt - 1 (the recompute's columns, the
  // carry's output rows of W_hh^T)
  const int cnt = nt / RM_WPG + (c < nt % RM_WPG), j0 = c * (nt / RM_WPG) + min(c, nt % RM_WPG);
  const float* const gate[3] = {p.gate[0], p.gate[1], p.gate[2]};

  for (int i = threadIdx.x; i < 3 * RB_KP * RB_KP; i += blockDim.x) {
    const int ga = i / RB_KP, b = i - ga * RB_KP, gt = ga / RB_KP, a = ga - gt * RB_KP;
    const bf16* src = gt == 0 ? p.w[0] : (gt == 1 ? p.w[1] : p.w[2]);
    w[ga * RM_WLD + b] = a < H && b < H ? src[(long long)a * H + b] : f2bf(0.f);
  }
  for (int j = threadIdx.x; j < 8 * RM_NT; j += blockDim.x) bn[j] = j < H ? ld_f(p.bhn + j) : 0.f;
  for (int i = threadIdx.x; i < rgs * 2 * 4 * 16 * RM_HLD; i += blockDim.x) hm0[i] = f2bf(0.f);
  __syncthreads();
  if (b0 >= B) return;   // the whole row group: its barrier is its own
  const int bar = 1 + rg;
  // newest first; step t's h_prev is h[t + dt]
  const int t_first = p.reverse ? 0 : T - 1, dt = p.reverse ? 1 : -1;
  bwd_mma_stage_h<VEC>(hm, p.hs, t_first + dt, T, B, H, b0);
  bwd_mma_prefetch<VEC>(gs, ds, gate, p.dhs, t_first, B, H, b0, j0, cnt);
  cp_async_commit();
  cp_async_wait<0>();
  asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(32 * RM_WPG) : "memory");

  // the carried dh of tiles j0 + q: rows g8 (e < 2) and g8 + 8, columns
  // 8 (j0 + q) + 2 t4 + (e & 1); then dht z, the carry's start
  float hc[RM_TPW][4];
#pragma unroll
  for (int q = 0; q < RM_TPW; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) hc[q][e] = 0.f;

  for (int step = 0; step < T; ++step) {
    const int cur = step & 1, t = t_first + dt * step;
    const bf16* hcur = hm + cur * 16 * RM_HLD;
    bf16* dcur = da + cur * 3 * 16 * RM_HLD;
    if (step + 1 < T) bwd_mma_stage_h<VEC>(hm + (cur ^ 1) * 16 * RM_HLD, p.hs, t + 2 * dt, T, B,
                                           H, b0);
    cp_async_commit();
    cp_async_wait<1>();   // this lane's gate slots of this step

    uint32_t a[RM_KS][4];   // h_prev as the A operand
#pragma unroll
    for (int m = 0; m < RM_KS; ++m)
      if (m < ks) ldsm_x4(a[m], hcur + (lane & 15) * RM_HLD + 16 * m + (lane >> 4) * 8);
#pragma unroll
    for (int q = 0; q < RM_TPW; ++q) {
      if (q < cnt) {
        const int j = j0 + q;
        float acc[3][4] = {};
#pragma unroll
        for (int m = 0; m < RM_KS; m += 2) {
          if (m < ks) {
#pragma unroll
            for (int gt = 0; gt < 3; ++gt) {
              uint32_t r[4];   // b0, b1 of k steps m and m + 1, n tile j
              ldsm_x4_t(r, w + (gt * RB_KP + 16 * m + lane) * RM_WLD + 8 * j);
              mma_bf16(acc[gt], a[m], r[0], r[1]);
              if (m + 1 < ks) mma_bf16(acc[gt], a[m + 1 < RM_KS ? m + 1 : m], r[2], r[3]);
            }
          }
        }
        const int col = 8 * j + 2 * t4;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = g8 + 8 * half, row = b0 + r, slot = (q * 2 + half) * 32 + lane;
          const float2 xr = gs[(0 * RM_TPW * 2) * 32 + slot];
          const float2 xz = gs[(1 * RM_TPW * 2) * 32 + slot];
          const float2 xn = gs[(2 * RM_TPW * 2) * 32 + slot];
          const long long at = ((long long)t * B + row) * H + col;
          float dy[2];
          if (VEC) {
            const uint32_t d2 = ds[slot];
            dy[0] = bf2f(__ushort_as_bfloat16((unsigned short)(d2 & 0xffffu)));
            dy[1] = bf2f(__ushort_as_bfloat16((unsigned short)(d2 >> 16)));
          } else {
            dy[0] = row < B && col < H ? bf2f(p.dhs[at]) : 0.f;
            dy[1] = row < B && col + 1 < H ? bf2f(p.dhs[at + 1]) : 0.f;
          }
          const uint32_t h2 = *reinterpret_cast<const uint32_t*>(hcur + r * RM_HLD + col);
          if (hpc && row < B && col < H) {   // h_prev for dwt's reduction
            bf16* o = hp + ((long long)t * B + row) * hpc + col;
            if (VEC) {
              *reinterpret_cast<uint32_t*>(o) = h2;
            } else {
              o[0] = hcur[r * RM_HLD + col];
              if (col + 1 < H) o[1] = hcur[r * RM_HLD + col + 1];
            }
          }
          const float hp[2] = {bf2f(__ushort_as_bfloat16((unsigned short)(h2 & 0xffffu))),
                               bf2f(__ushort_as_bfloat16((unsigned short)(h2 >> 16)))};
          const float gx[3][2] = {{xr.x, xr.y}, {xz.x, xz.y}, {xn.x, xn.y}};
          float dan[2], dar[2], daz[2], dgn[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 2 * half + e;
            const bool ok = row < B && col + e < H;
            const float rr = gate_sigmoid(gx[0][e] + acc[0][k]);
            const float z = gate_sigmoid(gx[1][e] + acc[1][k]);
            const float ghn = acc[2][k] + bn[col + e];
            const float n = gate_tanh(gx[2][e] + rr * ghn);
            const float dht = dy[e] + hc[q][k];
            const float da_n = dht * (1.0f - z) * (1.0f - n * n);
            // rounded as the JAX kernel casts them for the carry and dg
            dan[e] = ok ? da_n : 0.f;
            dgn[e] = ok ? rbf(da_n * rr) : 0.f;
            dar[e] = ok ? rbf(da_n * ghn * rr * (1.0f - rr)) : 0.f;
            daz[e] = ok ? rbf(dht * (hp[e] - n) * z * (1.0f - z)) : 0.f;
            hc[q][k] = ok ? dht * z : 0.f;
          }
          const int so = r * RM_HLD + col;
          *reinterpret_cast<uint32_t*>(dcur + so) = pack_bf16(dar[0], dar[1]);
          *reinterpret_cast<uint32_t*>(dcur + 16 * RM_HLD + so) = pack_bf16(daz[0], daz[1]);
          *reinterpret_cast<uint32_t*>(dcur + 2 * 16 * RM_HLD + so) = pack_bf16(dgn[0], dgn[1]);
          if (row < B && col < H) {
            bf16* o = p.dg + ((long long)t * B + row) * H4 + col;
            const float v[4][2] = {{dan[0], dan[1]}, {dar[0], dar[1]}, {daz[0], daz[1]},
                                   {dgn[0], dgn[1]}};
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              if (VEC) {
                *reinterpret_cast<uint32_t*>(o + g * H) = pack_bf16(v[g][0], v[g][1]);
              } else {
                o[g * H] = f2bf(v[g][0]);
                if (col + 1 < H) o[g * H + 1] = f2bf(v[g][1]);
              }
            }
          }
        }
      }
    }
    // hp's columns past H: the ones column (dwt's bias sums), then zeros
    for (int i = threadIdx.x % (32 * RM_WPG); i < 16 * (hpc - H); i += 32 * RM_WPG) {
      const int r = i / (hpc - H), col = H + (i - r * (hpc - H));
      if (b0 + r < B) hp[((long long)t * B + b0 + r) * hpc + col] = f2bf(col == H ? 1.f : 0.f);
    }
    // the slots are read (into registers): prefetch the next step's
    asm volatile("" ::: "memory");
    if (step + 1 < T)
      bwd_mma_prefetch<VEC>(gs, ds, gate, p.dhs, t + dt, B, H, b0, j0, cnt);
    cp_async_commit();
    cp_async_wait<1>();   // this lane's copies of the next h_prev
    // the row group's da of this step complete, its next h_prev landed
    asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(32 * RM_WPG) : "memory");

    // the carry into hc, from dht z, gate by gate
#pragma unroll
    for (int gt = 0; gt < 3; ++gt) {
      uint32_t ad[RM_KS][4];   // da_g as the A operand
#pragma unroll
      for (int m = 0; m < RM_KS; ++m)
        if (m < ks)
          ldsm_x4(ad[m], dcur + gt * 16 * RM_HLD + (lane & 15) * RM_HLD + 16 * m +
                             (lane >> 4) * 8);
#pragma unroll
      for (int q = 0; q < RM_TPW; ++q) {
        if (q < cnt) {
          const bf16* wj = w + (gt * RB_KP + 8 * (j0 + q) + (lane & 7)) * RM_WLD + (lane >> 3) * 8;
#pragma unroll
          for (int m = 0; m < RM_KS; m += 2) {
            if (m < ks) {
              uint32_t r[4];   // b0, b1 of k steps m and m + 1, n tile j0 + q
              ldsm_x4(r, wj + 16 * m);
              mma_bf16(hc[q], ad[m], r[0], r[1]);
              if (m + 1 < ks) mma_bf16(hc[q], ad[m + 1 < RM_KS ? m + 1 : m], r[2], r[3]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

// Launch the backward's mma form by the plan's rows (16 a row group),
// threads (RM_WPG warps a row group), smem (bytes) and vec (H a multiple of
// 4).  hp (hpc > 0, at least H + 1 columns, even): [T*B, hpc] is also
// written, each row the step's h_prev, then a 1 (the ones column of dwt's
// bias sums) and zeros.  The grid is ceil(B / rows).  (A template, so a
// unit that includes this header and never calls it builds no instance of
// the kernel.)
template <typename WT>
cudaError_t launch_gru_rec_bwd_mma(const GruRecBwdT<WT>& p, WT* hp, int hpc, int rows,
                                   int threads, int smem, int vec, cudaStream_t stream) {
  static_assert(std::is_same<WT, bf16>::value, "the mma form takes bf16 weights, h and dh");
  if (rows % 16 != 0 || rows > 16 * RM_MAX_RG || threads != rows / 16 * 32 * RM_WPG ||
      p.H > 8 * RM_NT || (vec && p.H % 4 != 0) ||
      (hpc && (hpc <= p.H || hpc % 2 != 0 || hp == nullptr)))
    return cudaErrorInvalidValue;
  const dim3 grid((p.B + rows - 1) / rows);
  if (vec) {
    static unsigned long long smem_set = 0;
    const cudaError_t err =
        allow_smem_once((const void*)gru_rec_bwd_mma_kernel<true>, &smem_set);
    if (err != cudaSuccess) return err;
    gru_rec_bwd_mma_kernel<true><<<grid, threads, smem, stream>>>(p, hp, hpc);
  } else {
    static unsigned long long smem_set = 0;
    const cudaError_t err =
        allow_smem_once((const void*)gru_rec_bwd_mma_kernel<false>, &smem_set);
    if (err != cudaSuccess) return err;
    gru_rec_bwd_mma_kernel<false><<<grid, threads, smem, stream>>>(p, hp, hpc);
  }
  return cudaGetLastError();
}

// Launch the backward form over `groups` groups by the plan's five host
// ints (ops/bigru_cuda._plan_rec_bwd): rows (a block's, a multiple of 4),
// threads (rows / 4 * js), smem (bytes), js and wp (already in p).  The grid
// is (ceil(B / rows), groups).  Returns the launch's cudaError_t.
template <bool BIAS_RZ, typename WT = float, typename GT = float, typename CT = WT>
cudaError_t launch_gru_rec_bwd_tiled(const GruRecBwdT<WT, GT, CT>& p, int groups,
                                     const int* rec, cudaStream_t stream) {
  const int rows = rec[0], threads = rec[1], smem = rec[2];
  if (rows % 4 != 0 || threads != rows / 4 * p.js || threads > REC_TILED_THREADS ||
      p.wp % 2 == 0 || p.wp < 4 * p.js || 4 * p.js < p.H)
    return cudaErrorInvalidValue;
  static unsigned long long smem_set = 0;
  const cudaError_t err =
      allow_smem_once((const void*)gru_rec_bwd_tiled_kernel<BIAS_RZ, WT, GT, CT>, &smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.B + rows - 1) / rows, groups);
  gru_rec_bwd_tiled_kernel<BIAS_RZ, WT, GT, CT><<<grid, threads, smem, stream>>>(p, rows);
  return cudaGetLastError();
}

// Launch the recurrence of `groups` groups by the plan's seven host ints
// (ops/bigru_cuda._plan_recurrence): small (1: the small form, a block a
// row), rows (rows a block), threads, smem (bytes), ks (lanes a column in
// the small form), vec (tiled form: H a multiple of 4, 16-byte aligned gate
// and output arrays) and hp (H rounded up to 4, already in p).  The grid is
// (ceil(B / rows), groups).  Returns the launch's cudaError_t.
template <bool BIAS_RZ, typename WT = float, typename GT = float, typename CT = WT>
cudaError_t launch_gru_rec(const GruRecT<WT, GT, CT>& p, int groups, const int* rec,
                           cudaStream_t stream) {
  const int small = rec[0], rows = rec[1], threads = rec[2], smem = rec[3], ks = rec[4],
            vec = rec[5];
  const dim3 grid((p.B + rows - 1) / rows, groups);
  if (small) {
    if (ks != REC_SMALL_KS || rows != 1) return cudaErrorInvalidValue;
    gru_rec_small_kernel<BIAS_RZ, WT, GT, CT><<<grid, threads, smem, stream>>>(p);
  } else if (vec) {
    static unsigned long long smem_set = 0;
    const cudaError_t err = allow_smem_once(
        (const void*)gru_rec_tiled_kernel<true, BIAS_RZ, WT, GT, CT>, &smem_set);
    if (err != cudaSuccess) return err;
    gru_rec_tiled_kernel<true, BIAS_RZ, WT, GT, CT><<<grid, threads, smem, stream>>>(p, rows);
  } else {
    static unsigned long long smem_set = 0;
    const cudaError_t err = allow_smem_once(
        (const void*)gru_rec_tiled_kernel<false, BIAS_RZ, WT, GT, CT>, &smem_set);
    if (err != cudaSuccess) return err;
    gru_rec_tiled_kernel<false, BIAS_RZ, WT, GT, CT><<<grid, threads, smem, stream>>>(p, rows);
  }
  return cudaGetLastError();
}

// K1f's bf16 recurrence by the plan's eight host ints (ops/bigru_cuda.
// _plan_recurrence_bf16): rec_mma (1: the mma form, by rec_rows,
// rec_threads, rec_smem and rec_vec), then launch_gru_rec's seven (the small
// or the tiled form where rec_mma is 0).
template <typename WT>
cudaError_t launch_gru_rec_bf16(const GruRecT<WT>& p, const int* rec, cudaStream_t stream) {
  if (rec[0]) {
    const int mma[4] = {rec[2], rec[3], rec[4], rec[6]};
    return launch_gru_rec_mma(p, mma, stream);
  }
  return launch_gru_rec<false>(p, 1, rec + 1, stream);
}

}  // namespace
