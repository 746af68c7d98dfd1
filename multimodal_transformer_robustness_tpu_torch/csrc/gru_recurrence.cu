// K7f / K7b: the whole-sequence GRU recurrence over pre-projected gates,
// G independent recurrences with their own weights, forward and backward.
//
// Replaces the TPU kernels of multimodal_transformer_robustness_tpu/ops/
// gru_pallas.py: _recurrence_fwd_impl (K7f, kernel body _fwd_kernel) and
// _recurrence_bwd_impl (K7b, _bwd_kernel), behind gru_recurrence_pallas.
// Same contract: gi_r, gi_z, gi_n [G, T, N, H] (x W_ix^T + b_ix, already
// projected), w_r, w_z, w_n [G, H, H] (W_hx^T, so gh_x = h @ w_x + b_x),
// b_r, b_z, b_n [G, H]; h0 = 0 and
//
//   r = sigmoid(gi_r + gh_r),  z = sigmoid(gi_z + gh_z)
//   n = tanh(gi_n + r * gh_n), h' = (1 - z) n + z h
//
// K7f writes hs [G, T, N, H].  K7b walks the steps newest-first from the
// cotangent dhs, recomputing r, z, n from h_{t-1} (zero at t = 0) as the TPU
// kernel does, and writes the pre-activation gradients da_r, da_z, da_n and
// dghn = da_n * r for every (g, t, n); the weight and bias gradients are
// sums of those over t and n, reduced outside the kernel as in JAX.
//
// What bounds it on the H100: at the MOSEI header level (G=2, T=50,
// N=4096, H=100) the recurrent products are 2*G*T*N*3*H*H = 24.6 GFLOP
// forward (0.15 ms at 165 TFLOP/s of float32-accurate products) and twice
// that backward, against 0.66 GB of gates and states (0.2 ms); but the 50
// steps are sequential, so each block's per-step latency is what it pays.
//
// K7f runs gru_rec.cuh's recurrence, the code of K1f's (bigru.cu), with a
// group axis (grid y), three gate arrays and b_hr / b_hz added to h W^T:
// the tiled form (W_hh^T of the block's group in shared memory, 4 x 4
// register tiles, cp.async prefetch of the next step's gates, one barrier a
// step) where G * N rows exceed the SM count, else the small form (a block
// a (row, g), W_hh^T in registers).  At G * N = 8192 the tiled blocks hold
// 32 rows (225,600 bytes of shared memory, one block an SM): 256 blocks, two
// waves on 132 SMs; one wave would need 64-row blocks, 328,000 bytes.  The
// launch plan is ops/bigru_cuda._plan_recurrence's.
//
// K7b runs gru_rec.cuh's backward form, K1b's recurrence
// (gru_rec_bwd_tiled_kernel), over the G groups of grid y with b_hr / b_hz
// added where the forward's tiled form adds them (BIAS_RZ), so its
// recomputed r, z, n are the ones K7f's tiled form made, bit for bit: W_hh^T
// of the block's group staged once in shared memory for both of a step's
// products (the recompute h_{t-1} W^T and the carry da W), 4-row x 4-column
// register tiles, h_{t-1} copied in a step ahead by cp.async, the carried
// dh in registers.  It writes dg [G, T*N, 4H], a row (da_n, da_r, da_z,
// dghn) per (g, t, n): K1b's layout, which the wrapper hands out as four
// strided [G, T, N, H] views.  Rows a block by the plan
// (ops/bigru_cuda._plan_rec_bwd): at G=2 N=4096 H=100, 32 rows (40 fit the
// 256-thread bound, but 40 give 206 blocks, already two waves), 256 blocks
// in two waves of one block an SM.  While G * N is at most four times the
// SM count (ops/gru_cuda._plan_gru_rec_bwd), a block owns one row and its
// threads split the row's 3H gate columns (gru_rec_bwd_row_kernel below):
// at few rows the tiled form's 4-row tiles leave a block one 25-thread warp
// with four rows of serial work, 1.37 ms at G=2 T=64 N=1 against the row
// form's 0.32 (tools/k7b_trials.py).  No float atomics: a rerun gives the
// same bits.
//
// The bf16 instances (mmtr_gru_rec_fwd_bf16 / _bwd_bf16) are the TPU
// kernels at bf16 operands: gates, weights, biases, hs, dhs and dg bf16,
// every value upcast where it is read, the arithmetic float32.  K7f carries
// h in float32 and multiplies it unrounded by the upcast weights, as the
// JAX kernel's jnp.dot(h, w) of a float32 h and a bf16 w does, and rounds
// h only where it stores it: the float32 recurrence with bf16 storage
// (gru_rec.cuh at WT = GT = bf16, CT = float), not K1f's bf16 instance,
// which rounds h before the product.  K7b reads h_{t-1} from the rounded
// stored hs, carries dh in float32, feeds the unrounded da to the carry
// and rounds da_r, da_z, da_n and dghn where it stores them.  The weights
// are upcast into the float32 shared-memory layout, so the float32 plans
// hold unchanged.  Bound at G=2 T=50 N=4096 H=100: the products, now with
// one bf16 and one float32 operand (989 / 3 TFLOP/s), against 0.33 GB of
// bf16 gates and states; the steps stay sequential.
#include "gru_rec.cuh"

namespace {

// The three weights of group g into w[gate][k][0..H) with row stride H+1,
// and the biases into b[gate][j] (T: float, or bf16 upcast).
template <typename T>
__device__ __forceinline__ void load_weights(float* w, float* b, const T* wr, const T* wz,
                                             const T* wn, const T* br, const T* bz,
                                             const T* bn, int g, int H) {
  const int HP = H + 1, HH = H * H;
  const long long wo = (long long)g * HH, bo = (long long)g * H;
  for (int i = threadIdx.x; i < 3 * HH; i += blockDim.x) {
    const int gate = i / HH, rem = i - gate * HH, k = rem / H, j = rem - k * H;
    const T* src = gate == 0 ? wr : (gate == 1 ? wz : wn);
    w[(gate * H + k) * HP + j] = ld_f(src + wo + rem);
  }
  for (int i = threadIdx.x; i < 3 * H; i += blockDim.x) {
    const int gate = i / H, j = i - gate * H;
    b[i] = ld_f((gate == 0 ? br : (gate == 1 ? bz : bn)) + bo + j);
  }
}

// Few rows: block (n, g) walks row n of group g newest-first.  Shared
// memory: the weights w [3][H][H+1] (odd row pitch: the carry reads a
// weight row a thread, free of bank conflicts), the biases [3][H], then
// h_{t-1} [H], dh [H], gh = h_{t-1} W^T + b [3H] and da_r, da_z, dghn [3H].
// A thread a gate column for the recompute, a thread a column of dh for
// the carry; accurate expf / tanhf.  S: every array's storage type (bf16:
// read upcast, dg rounded where it is stored, the carry's da unrounded).
template <typename S>
__global__ void gru_rec_bwd_row_kernel(const S* __restrict__ gi_r, const S* __restrict__ gi_z,
                                       const S* __restrict__ gi_n, const S* __restrict__ hs,
                                       const S* __restrict__ dhs, const S* __restrict__ wr,
                                       const S* __restrict__ wz, const S* __restrict__ wn,
                                       const S* __restrict__ br, const S* __restrict__ bz,
                                       const S* __restrict__ bn, S* __restrict__ dg, int T,
                                       int N, int H) {
  extern __shared__ float smem[];
  const int H3 = 3 * H, HP = H + 1;
  float* w = smem;                  // [3, H, H+1]
  float* b = w + 3 * H * HP;        // [3, H]
  float* hp = b + H3;               // [H]   h_{t-1}
  float* dh = hp + H;               // [H]   carried dh
  float* gh = dh + H;               // [3H]  h_{t-1} @ w + b
  float* da = gh + H3;              // [3H]  da_r, da_z, dghn
  const int g = blockIdx.y, n = blockIdx.x;

  load_weights(w, b, wr, wz, wn, br, bz, bn, g, H);
  for (int i = threadIdx.x; i < H; i += blockDim.x) dh[i] = 0.f;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const long long row = ((long long)g * T + t) * N + n;   // of [G*T*N] rows
    for (int j = threadIdx.x; j < H; j += blockDim.x)
      hp[j] = t > 0 ? ld_f(hs + (row - N) * H + j) : 0.f;
    __syncthreads();
    for (int j3 = threadIdx.x; j3 < H3; j3 += blockDim.x) {
      const int gate = j3 / H, j = j3 - gate * H;
      const float* wg = w + gate * H * HP + j;
      float acc = 0.f;
      for (int k = 0; k < H; ++k) acc = fmaf(hp[k], wg[k * HP], acc);
      gh[j3] = acc + b[j3];
    }
    __syncthreads();
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      const long long at = row * H + j;
      const float r = sigmoid_f(ld_f(gi_r + at) + gh[j]);
      const float z = sigmoid_f(ld_f(gi_z + at) + gh[H + j]);
      const float gh_n = gh[2 * H + j];
      const float nn = tanhf(ld_f(gi_n + at) + r * gh_n);
      const float dht = ld_f(dhs + at) + dh[j];
      const float da_n = dht * (1.0f - z) * (1.0f - nn * nn);
      const float dghn = da_n * r;
      const float da_r = da_n * gh_n * r * (1.0f - r);
      const float da_z = dht * (hp[j] - nn) * z * (1.0f - z);
      S* o = dg + row * 4 * H + j;
      st_f(o, da_n);
      st_f(o + H, da_r);
      st_f(o + 2 * H, da_z);
      st_f(o + 3 * H, dghn);
      da[j] = da_r;
      da[H + j] = da_z;
      da[2 * H + j] = dghn;
      dh[j] = dht * z;
    }
    __syncthreads();
    // dh_{t-1}[k] = dht z + sum over gates and j of da_gate[j] w[gate][k][j]
    for (int k = threadIdx.x; k < H; k += blockDim.x) {
      float acc = dh[k];
      for (int gate = 0; gate < 3; ++gate) {
        const float* wk = w + (gate * H + k) * HP;
        const float* dgt = da + gate * H;
        for (int j = 0; j < H; ++j) acc = fmaf(dgt[j], wk[j], acc);
      }
      dh[k] = acc;
    }
    __syncthreads();
  }
}

}  // namespace

// K7f: hs [G, T, N, H]; the plan's seven host ints as gru_rec.cuh's
// launch_gru_rec reads them (ops/gru_cuda._cached_plan).
extern "C" int mmtr_gru_rec_fwd(const float* gi_r, const float* gi_z, const float* gi_n,
                                const float* wr, const float* wz, const float* wn,
                                const float* br, const float* bz, const float* bn,
                                float* hs, int G, int T, int N, int H, const int* plan,
                                void* stream_ptr) {
  const GruRec p{{gi_r, gi_z, gi_n}, {wr, wz, wn}, {br, bz}, bn, hs, (long long)T * N * H,
                 T, N, H, plan[6], 0};
  return (int)launch_gru_rec<true>(p, G, plan, (cudaStream_t)stream_ptr);
}

// K7b: dg [G, T*N, 4H] (da_n, da_r, da_z, dghn a row); the plan's six host
// ints (ops/gru_cuda._plan_gru_rec_bwd): row (1: gru_rec_bwd_row_kernel, a
// block a row), then rows, threads, smem (bytes), js and wp as
// launch_gru_rec_bwd_tiled reads them.
extern "C" int mmtr_gru_rec_bwd(const float* gi_r, const float* gi_z, const float* gi_n,
                                const float* hs, const float* dhs, const float* wr,
                                const float* wz, const float* wn, const float* br,
                                const float* bz, const float* bn, float* dg, int G, int T,
                                int N, int H, const int* plan, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (plan[0]) {
    static unsigned long long smem_set = 0;
    const cudaError_t err =
        allow_smem_once((const void*)gru_rec_bwd_row_kernel<float>, &smem_set);
    if (err != cudaSuccess) return (int)err;
    gru_rec_bwd_row_kernel<float><<<dim3(N, G), plan[2], plan[3], stream>>>(
        gi_r, gi_z, gi_n, hs, dhs, wr, wz, wn, br, bz, bn, dg, T, N, H);
    return (int)cudaGetLastError();
  }
  const GruRecBwd p{{gi_r, gi_z, gi_n}, {wr, wz, wn}, {br, bz}, bn, hs, dhs, dg,
                    (long long)T * N * H, T, N, H, plan[4], plan[5], 0};
  return (int)launch_gru_rec_bwd_tiled<true>(p, G, plan + 1, stream);
}

// K7f's bf16 instance: every array bf16, hs [G, T, N, H] bf16; the float
// entry's plan.
extern "C" int mmtr_gru_rec_fwd_bf16(const bf16* gi_r, const bf16* gi_z, const bf16* gi_n,
                                     const bf16* wr, const bf16* wz, const bf16* wn,
                                     const bf16* br, const bf16* bz, const bf16* bn, bf16* hs,
                                     int G, int T, int N, int H, const int* plan,
                                     void* stream_ptr) {
  const GruRecT<bf16, bf16, float> p{{gi_r, gi_z, gi_n}, {wr, wz, wn}, {br, bz}, bn, hs,
                                     (long long)T * N * H, T, N, H, plan[6], 0};
  return (int)launch_gru_rec<true>(p, G, plan, (cudaStream_t)stream_ptr);
}

// K7b's bf16 instance: every array bf16, dg [G, T*N, 4H] bf16; the float
// entry's plan.
extern "C" int mmtr_gru_rec_bwd_bf16(const bf16* gi_r, const bf16* gi_z, const bf16* gi_n,
                                     const bf16* hs, const bf16* dhs, const bf16* wr,
                                     const bf16* wz, const bf16* wn, const bf16* br,
                                     const bf16* bz, const bf16* bn, bf16* dg, int G, int T,
                                     int N, int H, const int* plan, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (plan[0]) {
    static unsigned long long smem_set = 0;
    const cudaError_t err =
        allow_smem_once((const void*)gru_rec_bwd_row_kernel<bf16>, &smem_set);
    if (err != cudaSuccess) return (int)err;
    gru_rec_bwd_row_kernel<bf16><<<dim3(N, G), plan[2], plan[3], stream>>>(
        gi_r, gi_z, gi_n, hs, dhs, wr, wz, wn, br, bz, bn, dg, T, N, H);
    return (int)cudaGetLastError();
  }
  const GruRecBwdT<bf16, bf16, float> p{{gi_r, gi_z, gi_n}, {wr, wz, wn}, {br, bz}, bn, hs,
                                        dhs, dg, (long long)T * N * H, T, N, H, plan[4],
                                        plan[5], 0};
  return (int)launch_gru_rec_bwd_tiled<true>(p, G, plan + 1, stream);
}
