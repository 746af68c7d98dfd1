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
//   1. Recurrence (gru_rec.cuh's backward form, gru_rec_bwd_tiled_kernel): blocks
//      of rows walk the steps newest-first, as the forward walked them
//      oldest-first, rows per block chosen so that B=4096 runs in one wave
//      (32 rows: 128 blocks).  The input-side gate pre-activations come from
//      the forward's [3, T*B, H] scratch, saved for backward (246 MB per
//      direction at B=4096, T=50, H=100): the card has the memory, and
//      recomputing x @ wp would cost as much again as the dwp product.  The
//      pass writes dg [T*B, 4H] = (da_n, da_r, da_z, dghn) for every (step,
//      row).
//   2. Products over all T*B rows on gemm_tc.cuh's 3xTF32 tensor-core
//      tiles: dwp = x^T dg[:, :3H] and, with a row of ones appended to A,
//      dwt and the bias gradients at once: [h_prev | 1]^T dg, whose rows
//      0..H-1 hold h_prev^T (da_n, da_r, da_z, dghn) (dwt is its last three
//      column blocks) and whose row H holds dg's column sums (dbc in the
//      order n, r, z, then dbhn).  h_prev is h shifted one step, read in
//      place with zeros at the sequence start.  Both are split over K = T*B
//      rows into partial planes that one fixed-order pass each adds (no
//      float atomics: a rerun gives the same bits).  dx = dg[:, :3H] wp^T
//      (wp's gate blocks in dg's order n, r, z), only when need_dx, on the
//      wgmma tiles where the rows fill the card.  The wrapper reorders the
//      gate blocks.
//
// Bound: at B=4096, T=50, in=768 the products are 2*T*B*3H*(in + H) = 107
// GFLOP for dwp and dwt (and 2*T*B*3H*in more for dx), 0.65 ms at the 165
// TFLOP/s of float32-accurate tensor-core products, against ~0.75 GB of x,
// h, dh and dg: bound by operations.  The recurrence adds two [rows, H] x
// [H, 3H]-sized products a step (the recompute of h_prev W^T and the dh
// carry), sequential in T: its steps' latency, not the card's rate, is
// what it pays.
#include "gemm_bf16.cuh"
#include "gemm_tc.cuh"
#include "gru_rec.cuh"

// The launch plan comes from ops/bigru_cuda._plan_gru_bwd, as fourteen host
// ints at `plan`: the recurrence's five (rows, threads, smem, js, wp); tn_vec
// (16-byte copies in the reductions); dwp's splits and k tiles a split;
// dwt's splits and k tiles a split; dx's four (gemm_tc.cuh's TcPlan, its
// scratch in `scratch`).  partial holds dwp's planes [splits][in][3H] then
// dwt's [splits][H+1][4H]; red their sums, [in][3H] then [H+1][4H]; the
// wrapper reshapes them.  wpT is wp as [3H, in], rows in dg's gate order.
extern "C" int mmtr_gru_dir_bwd(const float* x, const float* hs, const float* gates,
                                const float* dhs, const float* wt, const float* bhn,
                                const float* wpT, float* dg, float* partial, float* red,
                                float* dx, void* scratch, int T, int B, int in_dim, int H,
                                int reverse, int need_dx, const int* plan,
                                void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int rows = T * B, H3 = 3 * H, H4 = 4 * H;
  const long long plane = (long long)rows * H;
  const GruRecBwd p{{gates, gates + plane, gates + 2 * plane},
                    {wt, wt + (long long)H * H, wt + 2LL * H * H},
                    {nullptr, nullptr}, bhn, hs, dhs, dg, 0, T, B, H, plan[3], plan[4],
                    reverse};
  cudaError_t err = launch_gru_rec_bwd_tiled<false>(p, 1, plan, stream);
  if (err != cudaSuccess) return (int)err;

  if (need_dx) {
    err = launch_gemm_tc<EPI_NONE>(tc_plan(plan + 10), dg, H4, wpT, nullptr, nullptr, dx,
                                   rows, in_dim, H3, in_dim, scratch, stream);
    if (err != cudaSuccess) return (int)err;
  }

  const long long n_wp = (long long)in_dim * H3, n_wt = (long long)(H + 1) * H4;
  float* part_wt = partial + plan[6] * n_wp;
  const int shift = reverse ? B : -B;   // h_prev row = row + shift
  err = plan[5] ? launch_gemm_tc_tn<true>(x, in_dim, 0, in_dim, -1, dg, H4, partial, H3, rows,
                                          plan[6], plan[7], n_wp, stream)
                : launch_gemm_tc_tn<false>(x, in_dim, 0, in_dim, -1, dg, H4, partial, H3, rows,
                                           plan[6], plan[7], n_wp, stream);
  if (err != cudaSuccess) return (int)err;
  err = plan[5] ? launch_gemm_tc_tn<true>(hs, H, shift, H, H, dg, H4, part_wt, H4, rows,
                                          plan[8], plan[9], n_wt, stream)
                : launch_gemm_tc_tn<false>(hs, H, shift, H, H, dg, H4, part_wt, H4, rows,
                                           plan[8], plan[9], n_wt, stream);
  if (err != cudaSuccess) return (int)err;
  splitk_reduce_kernel<float><<<(unsigned)((n_wp + RED_THREADS - 1) / RED_THREADS),
                                RED_THREADS, 0, stream>>>(partial, red, n_wp, plan[6]);
  splitk_reduce_kernel<float><<<(unsigned)((n_wt + RED_THREADS - 1) / RED_THREADS),
                                RED_THREADS, 0, stream>>>(part_wt, red + n_wp, n_wt, plan[8]);
  return (int)cudaGetLastError();
}

// The bf16 instance (the JAX kernel's VJP at bf16 operands): x, hs, dhs,
// wt, bhn and wpT bf16, the forward's gates float32.  The recurrence as the
// float entry's, with da_r, da_z and dghn rounded to bf16 for the carry and
// dg [T*B, 4H] written in bf16 (gru_rec.cuh, WT = bf16); then the products
// on the bf16 tensor cores (gemm_bf16.cuh): dx = dg[:, :3H] wpT, rounded to
// bf16; dwp = x^T dg[:, :3H] (where x and dg take 16-byte rows, on the
// wgmma reduction, gemm_bf16_tn_kernel) and [h_prev | 1]^T dg over T*B
// rows, split into float32 planes added in a fixed order, rounded to bf16
// (the JAX VJP rounds dW and db to the weights' dtype), into red
// ([in][3H] then [H+1][4H], bf16).  plan: twenty-two host ints (ops/bigru_cuda.
// _plan_gru_bwd_bf16): the recurrence's seven (rec_mma: 1 for gru_rec.cuh's
// mma form, both products on the bf16 tensor cores, by rows, threads,
// smem and rec_vec; 0 for the tiled form by rows, threads, smem, js and
// wp), then the BfPlans (ops/gemm_tc.plan_bf16) of dwp, dwt and dx.
// partial: dwp's planes then dwt's (a product that does not split has
// none); dx_partial: dx's split planes (when it splits).
extern "C" int mmtr_gru_dir_bwd_bf16(const bf16* x, const bf16* hs, const float* gates,
                                     const bf16* dhs, const bf16* wt, const bf16* bhn,
                                     const bf16* wpT, bf16* dg, float* partial, bf16* red,
                                     bf16* dx, float* dx_partial, bf16* hp, int T, int B,
                                     int in_dim, int H, int reverse, int need_dx,
                                     const int* plan, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int rows = T * B, H3 = 3 * H, H4 = 4 * H;
  const long long plane = (long long)rows * H;
  const int* rec = plan + 1;
  const GruRecBwdT<bf16> p{{gates, gates + plane, gates + 2 * plane},
                           {wt, wt + (long long)H * H, wt + 2LL * H * H},
                           {nullptr, nullptr}, bhn, hs, dhs, dg, 0, T, B, H, rec[3], rec[4],
                           reverse};
  const BfPlan pwp = bf_plan(plan + 7), pwt = bf_plan(plan + 12);
  // dwt on the wgmma reduction reads h_prev from hp, which the mma form
  // writes: [T*B, hpc], H + 1 columns (the ones column) rounded up to 8
  const int hpc = pwt.wgmma == 3 ? (H + 8) / 8 * 8 : 0;
  if (hpc && !plan[0]) return (int)cudaErrorInvalidValue;
  cudaError_t err = plan[0] ? launch_gru_rec_bwd_mma(p, hp, hpc, rec[0], rec[1], rec[2], plan[6],
                                                     stream)
                            : launch_gru_rec_bwd_tiled<false>(p, 1, rec, stream);
  if (err != cudaSuccess) return (int)err;

  if (need_dx) {
    const BfGemm g = bf_gemm(dg, H4, wpT, in_dim, in_dim, rows, in_dim, H3);
    err = launch_gemm_bf16<true, EPI_NONE>(bf_plan(plan + 17), g, nullptr, nullptr, dx, in_dim,
                                           dx_partial, stream);
    if (err != cudaSuccess) return (int)err;
  }

  const long long n_wp = (long long)in_dim * H3;
  float* part_wt = partial + (pwp.splits > 1 ? pwp.splits * n_wp : 0);
  // dwp: At(k, m) = x[k][m], B = dg's first 3H columns; on the wgmma
  // reduction (plan wgmma 3) where x and dg take TMA's 16-byte rows
  if (pwp.wgmma == 3) {
    err = launch_gemm_bf16_tn(x, in_dim, dg, H4, red, in_dim, H3, rows, pwp.splits, pwp.kps,
                              partial, stream);
  } else {
    BfGemm gwp = bf_gemm(x, in_dim, dg, H4, H3, in_dim, H3, rows);
    err = launch_gemm_bf16<false, EPI_NONE>(pwp, gwp, nullptr, nullptr, red, H3, partial,
                                            stream);
  }
  if (err != cudaSuccess) return (int)err;
  // dwt and the bias sums: At(k, m) = h[k + shift][m] (h_prev), row H ones;
  // on the wgmma reduction from hp, whose column H is the ones
  if (pwt.wgmma == 3)
    return (int)launch_gemm_bf16_tn(hp, hpc, dg, H4, red + n_wp, H + 1, H4, rows, pwt.splits,
                                    pwt.kps, part_wt, stream);
  BfGemm gwt = bf_gemm(hs, H, dg, H4, H4, H + 1, H4, rows);
  gwt.shift = reverse ? B : -B;
  gwt.mdata = H;
  gwt.ones_row = H;
  return (int)launch_gemm_bf16<false, EPI_NONE>(pwt, gwt, nullptr, nullptr, red + n_wp, H4,
                                                part_wt, stream);
}
