// K3: the frozen-BERT FFN block, out = LN(x + fc2(gelu_erf(fc1 x))).
//
// Replaces the TPU kernel multimodal_transformer_robustness_tpu/ops/
// bert_ffn_pallas.py::_ffn_ln_kernel (public ffn_ln_block via _rows_call).
// Same contract: rows x [R, h], w1t [h, F] (= fc1.weight^T), b1 [F],
// w2t [F, h], b2 [h], LN g/b [h], eps -> [R, h].  gelu is exact-erf (erff);
// LayerNorm moments are float32, centered, two-pass; no block splits a
// row's LN reduction (one block owns a whole row).
//
// Bound: at BERT-base width (h=768, F=3072) both products are 2*R*h*F FLOPs
// against 2*h*F weight floats, so at serving rows (R = L <= 512) the kernel
// reads about as many bytes as it computes FLOPs: it is weight-bandwidth and
// latency bound, not FLOP bound.  This first form runs three launches:
// fc1 with the bias+gelu epilogue into an [R, F] scratch, fc2 with the
// bias+residual epilogue, then the row LayerNorm.  Keeping the [R, F]
// activation on chip (one fused pass, wgmma) is later work.
//
// K6b, mmtr_proj_ln_fwd, is the attention epilogue LN(resid + a @ w_t + b)
// (HF BertSelfOutput) for the frozen BERT's unfused attention paths
// (ATTN_IMPL "dense" and "xla").  It replaces the TPU kernel
// bert_ffn_pallas.py::_proj_ln_kernel (public proj_ln_block via _rows_call):
// resid, a [R, h], w_t [h, h] (= o_proj.weight^T), b, LN g/b [h].  The same
// two stages as K2's tail: the GEMM with the bias+residual epilogue, then the
// row LayerNorm.  Bound: 2*R*h^2 FLOPs (1.55e11 at R = 131,072, h = 768:
// 2.3 ms at the 67 TFLOP/s float32 CUDA-core peak); at serving rows the
// 2.4 MB weight read and the launch latency.
#include "common.cuh"

extern "C" int mmtr_ffn_ln_fwd(const float* x, const float* w1t, const float* b1,
                               const float* w2t, const float* b2,
                               const float* ln_g, const float* ln_b,
                               float* hidden, float* resid_sum, float* out,
                               int rows, int h, int ffn, float eps,
                               void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  launch_gemm<EPI_BIAS_GELU>(x, w1t, b1, nullptr, hidden, rows, ffn, h, 1, 0,
                             0, 0, 0, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launch_gemm<EPI_BIAS_RESIDUAL>(hidden, w2t, b2, x, resid_sum, rows, h, ffn, 1,
                                 0, 0, 0, 0, stream);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  layernorm_rows_kernel<<<rows, LN_THREADS, 0, stream>>>(resid_sum, ln_g, ln_b,
                                                         out, h, eps);
  return (int)cudaGetLastError();
}

extern "C" int mmtr_proj_ln_fwd(const float* resid, const float* a, const float* w_t,
                                const float* b, const float* ln_g, const float* ln_b,
                                float* resid_sum, float* out, int rows, int h,
                                float eps, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  launch_gemm<EPI_BIAS_RESIDUAL>(a, w_t, b, resid, resid_sum, rows, h, h, 1, 0, 0,
                                 0, 0, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  layernorm_rows_kernel<<<rows, LN_THREADS, 0, stream>>>(resid_sum, ln_g, ln_b,
                                                         out, h, eps);
  return (int)cudaGetLastError();
}
