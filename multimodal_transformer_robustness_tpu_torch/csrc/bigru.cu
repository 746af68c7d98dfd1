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
//     row, W_hh^T in registers.
#include "gemm_bf16.cuh"
#include "gemm_tc.cuh"
#include "gru_rec.cuh"

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
// seven, as the float entry's.
extern "C" int mmtr_gru_dir_fwd_bf16(const bf16* x, const bf16* wp, const bf16* wt,
                                     const bf16* bc, const bf16* bhn, float* gates, bf16* out,
                                     float* partial, int T, int B, int in_dim, int H,
                                     int reverse, const int* plan, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long long plane = (long long)T * B * H;
  const BfGemm g = bf_gemm(x, in_dim, wp, H, H, T * B, 3 * H, in_dim);
  cudaError_t err = launch_gemm_bf16<true, EPI_BIAS>(bf_plan(plan), g, bc, nullptr, gates, H,
                                                     partial, stream);
  if (err != cudaSuccess) return (int)err;
  const GruRecT<bf16> p{{gates, gates + plane, gates + 2 * plane},
                        {wt, wt + (long long)H * H, wt + 2LL * H * H},
                        {nullptr, nullptr}, bhn, out, 0, T, B, H, plan[11], reverse};
  return (int)launch_gru_rec<false>(p, 1, plan + 5, stream);
}
