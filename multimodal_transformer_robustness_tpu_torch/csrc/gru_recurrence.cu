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
// K7b keeps its own loop: one block per (g, group of rows), the three
// [H, H] weights of its g in shared memory for the whole time loop (rows
// padded to H+1 floats, 121 KB at H=100, so da @ w^T, which reads a weight
// row per thread, is free of bank conflicts), recomputing r, z, n from the
// stored h_{t-1} with the accurate expf / tanhf; a step reads its gate rows
// and h_{t-1} from device memory.  No float atomics: a rerun gives the
// same bits.
#include "gru_rec.cuh"

namespace {

constexpr int SMEM_LIMIT = 232448;   // bytes of shared memory a block may use

// The three weights of group g into w[gate][k][0..H) with row stride H+1,
// and the biases into b[gate][j].
__device__ __forceinline__ void load_weights(float* w, float* b, const float* wr,
                                             const float* wz, const float* wn,
                                             const float* br, const float* bz,
                                             const float* bn, int g, int H) {
  const int HP = H + 1, HH = H * H;
  const long long wo = (long long)g * HH, bo = (long long)g * H;
  for (int i = threadIdx.x; i < 3 * HH; i += blockDim.x) {
    const int gate = i / HH, rem = i - gate * HH, k = rem / H, j = rem - k * H;
    const float* src = gate == 0 ? wr : (gate == 1 ? wz : wn);
    w[(gate * H + k) * HP + j] = src[wo + rem];
  }
  for (int i = threadIdx.x; i < 3 * H; i += blockDim.x) {
    const int gate = i / H, j = i - gate * H;
    b[i] = (gate == 0 ? br : (gate == 1 ? bz : bn))[bo + j];
  }
}

// gh[n][gate*H + j] = h[n] @ w[gate][:, j] + b[gate][j] for the block's rows:
// K7b's recompute of r, z and n from the stored h_{t-1}.  K7f runs
// gru_rec.cuh's forms (other summation order, fast gate math), so the
// recomputed gates may differ from the forward's in the last bits; K7b's
// outputs depend only on hs, not on how the forward computed it.
__device__ __forceinline__ void hidden_gates(float* gh, const float* h, const float* w,
                                             const float* b, int nrows, int H) {
  const int H3 = 3 * H, HP = H + 1;
  for (int idx = threadIdx.x; idx < nrows * H3; idx += blockDim.x) {
    const int n = idx / H3, j3 = idx - n * H3;
    const int gate = j3 / H, j = j3 - gate * H;
    const float* wg = w + gate * H * HP + j;
    const float* hn = h + n * H;
    float acc = 0.f;
    for (int k = 0; k < H; ++k) acc = fmaf(hn[k], wg[k * HP], acc);
    gh[idx] = acc + b[j3];
  }
}

__global__ void gru_rec_bwd_kernel(const float* __restrict__ gi_r,
                                   const float* __restrict__ gi_z,
                                   const float* __restrict__ gi_n,
                                   const float* __restrict__ hs, const float* __restrict__ dhs,
                                   const float* __restrict__ wr, const float* __restrict__ wz,
                                   const float* __restrict__ wn, const float* __restrict__ br,
                                   const float* __restrict__ bz, const float* __restrict__ bn,
                                   float* __restrict__ dar, float* __restrict__ daz,
                                   float* __restrict__ dan, float* __restrict__ dghn_out,
                                   int T, int N, int H, int rows_per_block) {
  extern __shared__ float smem[];
  const int H3 = 3 * H, HP = H + 1;
  float* w = smem;                                // [3, H, H+1]
  float* b = w + 3 * H * HP;                      // [3, H]
  float* hp = b + H3;                             // [rows, H]   h_{t-1}
  float* dh = hp + rows_per_block * H;            // [rows, H]   carried dh
  float* gh = dh + rows_per_block * H;            // [rows, 3H]  h_{t-1} @ w + b
  float* da = gh + rows_per_block * H3;           // [rows, 3H]  da_r, da_z, dghn
  const int g = blockIdx.y, n0 = blockIdx.x * rows_per_block;
  const int nrows = min(rows_per_block, N - n0);

  load_weights(w, b, wr, wz, wn, br, bz, bn, g, H);
  for (int i = threadIdx.x; i < nrows * H; i += blockDim.x) dh[i] = 0.f;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const long long base = (((long long)g * T + t) * N + n0) * H;
    for (int i = threadIdx.x; i < nrows * H; i += blockDim.x)
      hp[i] = t > 0 ? hs[base - (long long)N * H + i] : 0.f;
    __syncthreads();
    hidden_gates(gh, hp, w, b, nrows, H);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nrows * H; idx += blockDim.x) {
      const int n = idx / H, j = idx - n * H;
      const long long at = base + idx;
      const float* ghn = gh + n * H3;
      const float r = sigmoid_f(gi_r[at] + ghn[j]);
      const float z = sigmoid_f(gi_z[at] + ghn[H + j]);
      const float gh_n = ghn[2 * H + j];
      const float nn = tanhf(gi_n[at] + r * gh_n);
      const float dht = dhs[at] + dh[idx];
      const float dz = dht * (hp[idx] - nn);
      const float dn = dht * (1.0f - z);
      const float da_n = dn * (1.0f - nn * nn);
      const float dghn = da_n * r;
      const float dr = da_n * gh_n;
      const float da_r = dr * r * (1.0f - r);
      const float da_z = dz * z * (1.0f - z);
      dar[at] = da_r;
      daz[at] = da_z;
      dan[at] = da_n;
      dghn_out[at] = dghn;
      float* dan_s = da + n * H3;
      dan_s[j] = da_r;
      dan_s[H + j] = da_z;
      dan_s[2 * H + j] = dghn;
      dh[idx] = dht * z;
    }
    __syncthreads();
    // dh_{t-1}[k] = dht z + sum over gates and j of da_gate[j] w[gate][k][j]
    for (int idx = threadIdx.x; idx < nrows * H; idx += blockDim.x) {
      const int n = idx / H, k = idx - n * H;
      const float* dan_s = da + n * H3;
      float acc = dh[idx];
      for (int gate = 0; gate < 3; ++gate) {
        const float* wk = w + (gate * H + k) * HP;
        const float* dg = dan_s + gate * H;
        for (int j = 0; j < H; ++j) acc = fmaf(dg[j], wk[j], acc);
      }
      dh[idx] = acc;
    }
    __syncthreads();
  }
}

// K7b's rows per block: enough blocks for every SM (132) before a block
// takes more than one row, at most 8, and fewer if shared memory runs out
// (8 * H floats a row besides the weights: h_{t-1}, dh, gh, da).
void launch_shape(int G, int N, int H, int* rpb, int* threads, size_t* smem) {
  const int per_row = 8 * H;
  int r = (G * N + 131) / 132;
  r = r < 1 ? 1 : (r > 8 ? 8 : r);
  const size_t fixed = 3ULL * H * (H + 1) + 3ULL * H;
  while (r > 1 && sizeof(float) * (fixed + (size_t)r * per_row) > SMEM_LIMIT) --r;
  int th = ((r * 3 * H + 31) / 32) * 32;
  *threads = th < 64 ? 64 : (th > 1024 ? 1024 : th);
  *rpb = r;
  *smem = sizeof(float) * (fixed + (size_t)r * per_row);
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

extern "C" int mmtr_gru_rec_bwd(const float* gi_r, const float* gi_z, const float* gi_n,
                                const float* hs, const float* dhs, const float* wr,
                                const float* wz, const float* wn, const float* br,
                                const float* bz, const float* bn, float* dar, float* daz,
                                float* dan, float* dghn, int G, int T, int N, int H,
                                void* stream_ptr) {
  int rpb, threads;
  size_t smem;
  launch_shape(G, N, H, &rpb, &threads, &smem);
  cudaError_t err = cudaFuncSetAttribute(
      gru_rec_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + rpb - 1) / rpb, G);
  gru_rec_bwd_kernel<<<grid, threads, smem, (cudaStream_t)stream_ptr>>>(
      gi_r, gi_z, gi_n, hs, dhs, wr, wz, wn, br, bz, bn, dar, daz, dan, dghn, T, N, H, rpb);
  return (int)cudaGetLastError();
}
