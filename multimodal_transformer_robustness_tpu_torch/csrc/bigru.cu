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
// [rows, H] x [H, 3H] product and the gate math: gru_rec.cuh's two forms,
// shared with K7f (gru_recurrence.cu), here with G = 1 and the biases
// folded into the gates except b_hn.  The launch plan is the caller's
// (ops/bigru_cuda._plan_gru_fwd):
//   * tiled (large B): 4 x 4 register tiles, W_hh^T (3*H*H floats, 120 KB
//     at H=100) in shared memory; rows per block chosen so that B=4096
//     runs in one wave (32 rows: 128 blocks on 132 SMs);
//   * small (B <= 132, the serving batch of 1; H <= 104): a block a batch
//     row, W_hh^T in registers;
//   * mma (the bf16 instance where the tiled form would run, H <= 104):
//     hm W_hh^T on the bf16 tensor cores, a warp 16 rows with h in its
//     registers (_plan_gru_fwd_bf16).
#include "gemm_bf16.cuh"
#include "gemm_tc.cuh"
#include "gru_rec.cuh"

namespace {

// K1f.bf16's projection where the rows fill the card (its plan's
// gemm_wgmma 2): gemm_bf16.cuh's wgmma walk (two warpgroups, a 4-stage
// cp.async ring loaded two k tiles ahead, A from 128-byte-swizzled shared
// memory into registers, B^T by descriptor, one batch in flight) over one
// 128 x 304 tile a block, so that 3H = 300 columns take one tile: x is read
// once, where gemm_bf16.cuh's 128-wide tiles read it three times and pad
// 300 to 384.  A warpgroup's 64 rows by 304 columns are two m64n152k16 MMAs
// a k step of 16, 152 accumulators a thread.  The epilogue goes through
// shared memory: a block's rows of one gate lie one after another in the
// gate scratch [3][M][H], so each gate's 128 x H floats, + bc in float32
// (tc_epilogue's EPI_BIAS), leave in one run of 16-byte stores (storing the
// accumulators' float pairs straight from registers, eight rows a warp
// instruction, took two thirds of the kernel's 0.84 ms at B=4096, T=50:
// tools/k1f_bf16_trials.py).  Shared memory: 4 stages of A [128][64] and
// B^T [304][64] bf16, reused by the [128][312] float32 output tile:
// 222,208 bytes, one block an SM.
constexpr int KP_BN = 304, KP_HALF = 152;
constexpr int KP_BPLANE = KP_BN * BW_BK;                            // bf16 of one B stage
constexpr int KP_SMEM = 2 * WG_STAGES * (BW_PLANE + KP_BPLANE) + 1024;
// the output tile's row pitch (floats): 24 mod 32, so a half warp's float2
// writes of four rows hit 32 different banks
constexpr int KP_CLD = KP_BN + 8;
static_assert(KP_SMEM <= MAX_SMEM_BYTES && (KP_HALF * BW_BK * 2) % 1024 == 0 &&
                  4 * WG_BM * KP_CLD <= 2 * WG_STAGES * (BW_PLANE + KP_BPLANE),
              "K1f tile");

__device__ __forceinline__ void wgmma_bf16_n152(float (&d)[76], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %81, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n152k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75 "
      "}, "
      "{%76, %77, %78, %79}, %80, p, 1, 1, 0;\n}\n"
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

// One stage: A's [128 r][64 k] and B^T's [304 n][64 k] tiles in 16-byte
// copies, swizzled as bw_load's; rows past M or N and k past K read zero.
__device__ __forceinline__ void kp_load(bf16* as, bf16* bs, const bf16* A, const bf16* Bt,
                                        int M, int N, int K, int lda, int row0, int k0) {
  for (int i = threadIdx.x; i < (WG_BM + KP_BN) * 8; i += WG_THREADS) {
    const int rr = i / 8, c = i % 8;
    const bool b = rr >= WG_BM;
    const int r = b ? rr - WG_BM : rr;
    const bool ok = (b ? r < N : row0 + r < M) && k0 + c * 8 < K;
    const bf16* src = b ? Bt + (long long)r * K : A + (long long)(row0 + r) * lda;
    cp_async16((b ? bs : as) + 2 * sw128(r, c * 4), ok ? src + k0 + c * 8 : (b ? Bt : A), ok);
  }
}

// bw_k_tile at 304 columns: wait for k tile kt, start loading kt + 2, load
// kt's A fragments, issue its batch of eight MMAs, leave one batch in flight.
__device__ __forceinline__ void kp_k_tile(float (&acc0)[76], float (&acc1)[76],
                                          uint32_t (&a)[4][4], bf16* As, bf16* Bs,
                                          const bf16* A, const bf16* Bt, int M, int N, int K,
                                          int lda, int row0, int kt, int ktiles, int wrow) {
  cp_async_wait<1>();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (kt + 2 < ktiles) {
    const int s = (kt + 2) % WG_STAGES;
    kp_load(As + s * BW_PLANE, Bs + s * KP_BPLANE, A, Bt, M, N, K, lda, row0,
            (kt + 2) * BW_BK);
  }
  cp_async_commit();
  const int s = kt % WG_STAGES, lane = threadIdx.x % 32;
  const int r = wrow + lane / 4, t4 = lane % 4;
  const bf16* bs = Bs + s * KP_BPLANE;
  const uint32_t* as = reinterpret_cast<const uint32_t*>(As + s * BW_PLANE);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    a[q][0] = as[sw128(r, q * 8 + t4)];
    a[q][1] = as[sw128(r + 8, q * 8 + t4)];
    a[q][2] = as[sw128(r, q * 8 + t4 + 4)];
    a[q][3] = as[sw128(r + 8, q * 8 + t4 + 4)];
  }
  wgmma_fence_acc(acc0);
  wgmma_fence_acc(acc1);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    wgmma_bf16_n152(acc0, a[q], wgmma_desc_sw128(bs + q * 16));
    wgmma_bf16_n152(acc1, a[q], wgmma_desc_sw128(bs + KP_HALF * BW_BK + q * 16));
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  wgmma_fence_acc(acc0);
  wgmma_fence_acc(acc1);
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  wgmma_fence_acc(acc0);
  wgmma_fence_acc(acc1);
}

// One half's 76 sums into the block's output tile ct [128][KP_CLD] float32
// (the stage buffers, free once the k loop is done): acc[4i + e] at row r0
// (+8 for e >= 2), column c0 + 8i + c1 + (e & 1).
__device__ __forceinline__ void kp_to_tile(const float (&acc)[76], float* ct, int c0, int r0,
                                           int c1) {
#pragma unroll
  for (int i = 0; i < KP_HALF / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; e += 2)
      *reinterpret_cast<float2*>(ct + (r0 + (e >= 2 ? 8 : 0)) * KP_CLD + c0 + i * 8 + c1) =
          make_float2(acc[i * 4 + e], acc[i * 4 + e + 1]);
}

// gates (gated [N / hg][M][hg], float32) = x @ B + bc, B^T [N][K] bf16.
__global__ void __launch_bounds__(WG_THREADS)
k1f_proj_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Bt, int M, int N,
                     int K, int lda, const bf16* __restrict__ bias, float* __restrict__ C,
                     int hg) {
  extern __shared__ float4 kp_smem4[];
  bf16* Bs = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(kp_smem4) + 1023) &
                                     ~uintptr_t(1023));        // [S][304][64]
  bf16* As = Bs + WG_STAGES * KP_BPLANE;                       // [S][128][64]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int wrow = (warp / 4) * 64 + (warp % 4) * 16;
  const int row0 = blockIdx.x * WG_BM;
  const int ktiles = ((K + BW_BK - 1) / BW_BK + 1) & ~1;

  float acc0[76], acc1[76];
#pragma unroll
  for (int i = 0; i < 76; ++i) acc0[i] = acc1[i] = 0.f;
  wgmma_fence_acc(acc0);
  wgmma_fence_acc(acc1);
  uint32_t a0[4][4], a1[4][4];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    kp_load(As + s * BW_PLANE, Bs + s * KP_BPLANE, A, Bt, M, N, K, lda, row0, s * BW_BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; kt += 2) {
    kp_k_tile(acc0, acc1, a0, As, Bs, A, Bt, M, N, K, lda, row0, kt, ktiles, wrow);
    kp_k_tile(acc0, acc1, a1, As, Bs, A, Bt, M, N, K, lda, row0, kt + 1, ktiles, wrow);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wgmma_fence_acc(acc0);
  wgmma_fence_acc(acc1);
  cp_async_wait<0>();

  __syncthreads();   // every warp's last reads of the stages done

  // The epilogue through shared memory: the tile's sums, then + bc in
  // float32 (tc_epilogue's EPI_BIAS) as gate g's rows row0 .. row0 + nr - 1,
  // which lie one after another in the scratch: nr * hg floats in one run,
  // written in 16-byte stores where hg is a multiple of 4.
  float* ct = reinterpret_cast<float*>(Bs);
  kp_to_tile(acc0, ct, 0, wrow + g8, 2 * t4);
  kp_to_tile(acc1, ct, KP_HALF, wrow + g8, 2 * t4);
  __syncthreads();
  const EpiArgs ex{};
  const int nr = min(WG_BM, M - row0);
  for (int g = 0; g < N / hg; ++g) {
    float* out = C + ((long long)g * M + row0) * hg;
    if (hg % 4 == 0) {
      for (int f = 4 * threadIdx.x; f < nr * hg; f += 4 * WG_THREADS) {
        const int r = f / hg, c = g * hg + f - r * hg;
        const float4 s = *reinterpret_cast<const float4*>(ct + r * KP_CLD + c);
        *reinterpret_cast<float4*>(out + f) = make_float4(
            tc_epilogue<EPI_BIAS, bf16, bf16>(s.x, bias, nullptr, row0 + r, c, N, ex),
            tc_epilogue<EPI_BIAS, bf16, bf16>(s.y, bias, nullptr, row0 + r, c + 1, N, ex),
            tc_epilogue<EPI_BIAS, bf16, bf16>(s.z, bias, nullptr, row0 + r, c + 2, N, ex),
            tc_epilogue<EPI_BIAS, bf16, bf16>(s.w, bias, nullptr, row0 + r, c + 3, N, ex));
      }
    } else {
      for (int f = threadIdx.x; f < nr * hg; f += WG_THREADS) {
        const int r = f / hg, c = g * hg + f - r * hg;
        out[f] = tc_epilogue<EPI_BIAS, bf16, bf16>(ct[r * KP_CLD + c], bias, nullptr, row0 + r,
                                                   c, N, ex);
      }
    }
  }
}

// The projection by K1f.bf16's plan: gemm_wgmma 2 takes the 304-wide tile
// above (3H <= 304; B^T made into `partial` by bf_transpose_b, as
// launch_gemm_bf16's wgmma path), else launch_gemm_bf16.
cudaError_t launch_k1f_proj_bf16(const int* plan, const BfGemm& g, const bf16* bc, float* gates,
                                 int H, float* partial, cudaStream_t stream) {
  if (plan[0] != 2)
    return launch_gemm_bf16<true, EPI_BIAS>(bf_plan(plan), g, bc, nullptr, gates, H, partial,
                                            stream);
  if (g.N > KP_BN || g.K % 8 != 0 || plan[3] != 8 || partial == nullptr)
    return cudaErrorInvalidValue;
  bf16* bt = reinterpret_cast<bf16*>(partial);
  const long long nk = (long long)g.N * g.K;
  bf_transpose_b<<<(unsigned)((nk + 255) / 256), 256, 0, stream>>>(g.B, bt, g.N, g.K, g.ldb,
                                                                    g.hgb);
  static unsigned long long smem_set = 0;
  const cudaError_t err = allow_smem_once((const void*)k1f_proj_bf16_kernel, &smem_set);
  if (err != cudaSuccess) return err;
  k1f_proj_bf16_kernel<<<(g.M + WG_BM - 1) / WG_BM, WG_THREADS, KP_SMEM, stream>>>(
      g.A, bt, g.M, g.N, g.K, g.lda, bc, gates, H);
  return cudaGetLastError();
}

}  // namespace

// The launch plan comes from ops/bigru_cuda._plan_gru_fwd, as eleven host
// ints at `plan`: the projection's four (gemm_tc.cuh's TcPlan: gemm_wgmma,
// gemm_vec, gemm_splits, gemm_bn; its scratch: W_ih's TF32 planes, 2 * 3H *
// in words, or splits * T*B * 3H floats of partials), then the recurrence's
// seven (gru_rec.cuh's launch_gru_rec): rec_small, rec_rows, rec_threads,
// rec_smem, rec_ks, rec_vec and hp.
extern "C" int mmtr_gru_dir_fwd(const float* x, const float* wp, const float* wt,
                                const float* bc, const float* bhn, float* gates,
                                float* out, void* scratch, int T, int B, int in_dim,
                                int H, int reverse, const int* plan, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t err = launch_gemm_tc<EPI_BIAS>(tc_plan(plan), x, in_dim, wp, bc, nullptr, gates,
                                             T * B, 3 * H, in_dim, H, scratch, stream);
  if (err != cudaSuccess) return (int)err;
  const long long plane = (long long)T * B * H;
  const GruRec p{{gates, gates + plane, gates + 2 * plane},
                 {wt, wt + (long long)H * H, wt + 2LL * H * H},
                 {nullptr, nullptr}, bhn, out, 0, T, B, H, plan[10], reverse};
  return (int)launch_gru_rec<false>(p, 1, plan + 4, stream);
}

// The bf16 instance (the JAX kernel at bf16 operands): x, wp, wt, bc, bhn
// bf16 -> h bf16.  The projection on the bf16 tensor cores (gemm_bf16.cuh),
// + bc in float32, into the float32 gate scratch K1b reads back; the
// recurrence carries h in float32 and rounds it to bf16 for h W_hh^T and
// for the output, as the JAX kernel casts h to the weights' dtype.  plan:
// the projection's five BfPlan ints (ops/gemm_tc.plan_bf16; partial: W_ih's
// transpose on the wgmma path, or its split planes), then the recurrence's
// eight (gru_rec.cuh's launch_gru_rec_bf16: the mma form where the rows
// fill the card, else the float entry's seven).
extern "C" int mmtr_gru_dir_fwd_bf16(const bf16* x, const bf16* wp, const bf16* wt,
                                     const bf16* bc, const bf16* bhn, float* gates, bf16* out,
                                     float* partial, int T, int B, int in_dim, int H,
                                     int reverse, const int* plan, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long long plane = (long long)T * B * H;
  const BfGemm g = bf_gemm(x, in_dim, wp, H, H, T * B, 3 * H, in_dim);
  cudaError_t err = launch_k1f_proj_bf16(plan, g, bc, gates, H, partial, stream);
  if (err != cudaSuccess) return (int)err;
  const GruRecT<bf16> p{{gates, gates + plane, gates + 2 * plane},
                        {wt, wt + (long long)H * H, wt + 2LL * H * H},
                        {nullptr, nullptr}, bhn, out, 0, T, B, H, plan[12], reverse};
  return (int)launch_gru_rec_bf16(p, plan + 5, stream);
}
