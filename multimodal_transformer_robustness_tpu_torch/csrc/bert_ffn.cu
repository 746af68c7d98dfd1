// K3: the frozen-BERT FFN block, out = LN(x + fc2(gelu_erf(fc1 x))).
//
// Replaces the TPU kernel multimodal_transformer_robustness_tpu/ops/
// bert_ffn_pallas.py::_ffn_ln_kernel (public ffn_ln_block via _rows_call).
// Same contract: rows x [R, h], w1t [h, F] (= fc1.weight^T), b1 [F],
// w2t [F, h], b2 [h], LN g/b [h], eps -> [R, h].  gelu is exact-erf (erff);
// LayerNorm moments are float32, centered, two-pass; no block splits a
// row's LN reduction (one block owns a whole row).
//
// Bound: at BERT-base width (h=768, F=3072) the two products are 4*R*h*F
// FLOPs, 1.24 TFLOP at the training rows (R = 131,072): 7.5 ms at the
// 165 TFLOP/s of float32-accurate (3xTF32) tensor-core products, against
// ~0.8 GB of x, out and weights, so it is bound by operations; at serving
// rows (R = L <= 512) it reads about as many weight bytes as it computes
// FLOPs, and a block's serial k steps and the launches set the time.
// Both products run on gemm_tc.cuh's 3xTF32 tensor-core GEMM, each by its
// own plan (ops/bert_ffn_cuda._plan_ffn): fc1 with the bias + gelu epilogue
// into an [R, F] scratch, fc2 with the bias + residual epilogue into [R, h],
// then the row LayerNorm; both promote their MMA sums every 8 k tiles
// (K3_PROMOTE).  Many rows: wgmma over 128 x 128 tiles (both N
// divide by 128), W1^T's and W2^T's TF32 planes split per call into
// `scratch` (2 * h * F words, reused by fc2 after fc1; ~57 MB of traffic, a
// few tens of microseconds beside a call of milliseconds).  Few rows: 64 x 64
// mma.sync tiles split over K so that the card has blocks to run (fc2's 96
// k tiles at R = 8: 20 ranges of 5, not 12 blocks walking all 96), the
// split planes in `scratch`; fc2's planes are then added, in order, by the
// LayerNorm's own launch (bias, residual, LN: one block a row), which saves
// a launch at serving.  Keeping the [R, F] activation on chip (one fused
// pass) is later work.
//
// K6b, mmtr_proj_ln_fwd, is the attention epilogue LN(resid + a @ w_t + b)
// (HF BertSelfOutput) for the frozen BERT's unfused attention paths
// (ATTN_IMPL "dense" and "xla").  It replaces the TPU kernel
// bert_ffn_pallas.py::_proj_ln_kernel (public proj_ln_block via _rows_call):
// resid, a [R, h], w_t [h, h] (= o_proj.weight^T), b, LN g/b [h].  Bound:
// 2*R*h^2 FLOPs (1.55e11 at R = 131,072, h = 768: 0.94 ms at 165 TFLOP/s);
// at serving rows the 2.4 MB weight read and the launch latency.  It is
// exactly K2's tail (bert_attn.cu), so it runs the same host function,
// gemm_tc.cuh's launch_proj_resid_ln, by the same plan
// (ops/bert_ffn_cuda._plan_proj_ln, K2's "o" entry): the 3xTF32 product
// with the bias + residual epilogue on the wgmma tiles (128 x 128 at h =
// 768, W^T's TF32 planes split per call into `scratch`) then the row
// LayerNorm, or at few rows split-K mma.sync tiles whose planes (in
// `scratch`) the LayerNorm's launch adds.  Its sums are 768 deep and stay
// unpromoted, as K2's (K6B_PROMOTE).  Its bf16 instance,
// mmtr_proj_ln_fwd_bf16, is K2's bf16 tail alone (gemm_bf16.cuh, then the
// bf16 LayerNorm, layernorm_bf16.cuh): 0.60 GB of bf16 rows at R = 131,072,
// 0.18 ms at 3.35 TB/s, against 0.16 ms of bf16 tensor-core work; at the
// training rows on the persistent kernel and the warp-row LayerNorm, as
// K3.bf16's fc2.
#include "gemm_bf16.cuh"
#include "gemm_tc.cuh"
#include "layernorm_bf16.cuh"

namespace {

// K3's products promote their tensor-core sums every 8 k tiles (256 k; see
// gemm_tc.cuh): fc2's 3072-deep chain otherwise left 6e-5 of the 1e-4
// allowed (B=4096 L=32, HF-scale weights).
constexpr int K3_PROMOTE = 8;

// K6b's product, as K2's o-projection (K2_PROMOTE): unpromoted, so every
// wgmma width the header instantiates may serve it (_plan_proj_ln); its
// 768-deep sums left 2.2e-5 of the 1e-4 allowed (B=4096 L=32, HF-scale
// weights).
constexpr int K6B_PROMOTE = 0;

}  // namespace

// plan: eight host ints from ops/bert_ffn_cuda._plan_ffn, fc1's TcPlan then
// fc2's.  scratch: the larger of the two plans' needs (the wgmma's TF32
// planes or the split planes).  resid_sum [R, h] is written unless fc2
// splits over K on the mma.sync tiles (its LayerNorm then adds the planes).
extern "C" int mmtr_ffn_ln_fwd(const float* x, const float* w1t, const float* b1,
                               const float* w2t, const float* b2,
                               const float* ln_g, const float* ln_b,
                               float* hidden, float* resid_sum, float* out, void* scratch,
                               int rows, int h, int ffn, float eps, const int* plan,
                               void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t err = launch_gemm_tc<EPI_BIAS_GELU, K3_PROMOTE>(
      tc_plan(plan), x, h, w1t, b1, nullptr, hidden, rows, ffn, h, ffn, scratch, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_proj_resid_ln<K3_PROMOTE>(tc_plan(plan + 4), hidden, ffn, w2t, b2, x,
                                               ln_g, ln_b, resid_sum, out, rows, h, ffn, eps,
                                               scratch, stream);
}

// plan: the four host ints of ops/bert_ffn_cuda._plan_proj_ln (a TcPlan).
// scratch: its need (W^T's TF32 planes or the split planes); resid_sum [R,
// h] is written unless the product splits over K on the mma.sync tiles.
extern "C" int mmtr_proj_ln_fwd(const float* resid, const float* a, const float* w_t,
                                const float* b, const float* ln_g, const float* ln_b,
                                float* resid_sum, float* out, void* scratch, int rows, int h,
                                float eps, const int* plan, void* stream_ptr) {
  return (int)launch_proj_resid_ln<K6B_PROMOTE>(tc_plan(plan), a, h, w_t, b, resid, ln_g, ln_b,
                                                resid_sum, out, rows, h, h, eps, scratch,
                                                (cudaStream_t)stream_ptr);
}


// K3's bf16 instance (the JAX kernel at bf16 operands): x, weights, biases
// and LN parameters bf16.  fc1 on the bf16 tensor cores (gemm_bf16.cuh),
// + b1 rounded to bf16, then the exact-erf gelu in float32, rounded: the
// bf16 hidden [R, F]; fc2, + b2 rounded, + x rounded (resid_sum [R, h],
// bf16); the row LayerNorm with float32 moments, rounded to bf16 (a warp a
// row after the persistent products).  plan: twelve host ints, fc1's and
// fc2's BfPlans (ops/gemm_tc.plan_bf16), then their persistent grids
// (ops/bert_ffn_cuda._plan_ffn_bf16): where the rows fill the card both
// products run gemm_bf16_persistent_kernel (wgmma 2), the weights read as
// stored; else the mma.sync tiles, split over K at few rows.  partial: the
// larger of the two products' needs (split planes, or a weight's transpose
// where a plan takes the 128 x 128 wgmma tiles).
extern "C" int mmtr_ffn_ln_fwd_bf16(const bf16* x, const bf16* w1t, const bf16* b1,
                                    const bf16* w2t, const bf16* b2, const bf16* ln_g,
                                    const bf16* ln_b, bf16* hidden, bf16* resid_sum, bf16* out,
                                    float* partial, int rows, int h, int ffn, float eps,
                                    const int* plan, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t err = launch_product_bf16<EPI_BIAS_GELU>(
      plan, plan[10], bf_gemm(x, h, w1t, ffn, ffn, rows, ffn, h), b1, nullptr, hidden, ffn,
      partial, stream);
  if (err != cudaSuccess) return (int)err;
  err = launch_product_bf16<EPI_BIAS_RESIDUAL>(plan + 5, plan[11],
                                               bf_gemm(hidden, ffn, w2t, h, h, rows, h, ffn),
                                               b2, x, resid_sum, h, partial, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)layernorm_bf16(plan[5] == 2, resid_sum, ln_g, ln_b, out, rows, h, eps, stream);
}

// K6b's bf16 instance (the JAX kernel at bf16 operands), K2's bf16 tail
// alone: resid, a, w_t, b and LN parameters bf16.  The product on the bf16
// tensor cores (gemm_bf16.cuh), + b rounded to bf16, + resid rounded
// (resid_sum [R, h], bf16), then the row LayerNorm with float32 moments,
// rounded to bf16.  plan: six host ints, a BfPlan (ops/bert_ffn_cuda.
// _plan_proj_ln_bf16, K2's bf16 "o" plan) and its persistent grid: where
// the rows fill the card the product runs gemm_bf16_persistent_kernel
// (wgmma 2, w_t read as stored) and the LayerNorm a warp a row, as K3.bf16's
// fc2 and LN; else the mma.sync tiles, split over K at few rows, and the
// LayerNorm a block a row.  partial: its need (split planes, or W's
// transpose where the plan takes the 128 x 128 wgmma tiles).
extern "C" int mmtr_proj_ln_fwd_bf16(const bf16* resid, const bf16* a, const bf16* w_t,
                                     const bf16* b, const bf16* ln_g, const bf16* ln_b,
                                     bf16* resid_sum, bf16* out, float* partial, int rows, int h,
                                     float eps, const int* plan, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const cudaError_t err = launch_product_bf16<EPI_BIAS_RESIDUAL>(
      plan, plan[5], bf_gemm(a, h, w_t, h, h, rows, h, h), b, resid, resid_sum, h, partial,
      stream);
  if (err != cudaSuccess) return (int)err;
  return (int)layernorm_bf16(plan[0] == 2, resid_sum, ln_g, ln_b, out, rows, h, eps, stream);
}
