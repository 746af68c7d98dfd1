// K5: flash attention over already-projected q / k / v, forward with
// its log-sum-exp, and the backward (K5b at Tq, Tk <= 64; K5dq + K5dkv).
//
// Replaces the TPU kernels of multimodal_transformer_robustness_tpu/ops/:
//   * attention_pallas.py::_flash_fwd_impl (K5f, kernel body _flash_kernel):
//     softmax(q k^T + future-mask rule) v with the in-softmax position-hash
//     dropout, and lse = m + log(l) for the backward;
//   * attention_pallas_bwd.py::flash_attention_bwd, its two pallas_calls
//     _dq_kernel and _dkv_kernel and the XLA delta between them, which
//     recompute p = exp(s - lse) tile by tile: K5b, one fused pass a (b*h)
//     slice that computes delta itself, where both lengths are at most 64
//     (every MOSEI flash stack); K5dq and K5dkv (with delta = rowsum(dO * O)
//     from the caller) otherwise;
//
// Layout: q/out [B*H, Tq, D], k/v [B*H, Tk, D] row-major float32 (q already
// scaled); lse and delta = rowsum(dO * O) [B*H, Tq]; seeds int32 and rates
// float32 [B*H].  The future-mask rule masks col - row >= offset; the key
// padding col >= Tk.  Masked weights are exactly 0 (the TPU kernel fills
// the finite -1e30 and lets a later tile's rescale wipe them; the result is
// the same for every row that sees at least one key, which the causal rule
// with offset >= 1 guarantees).  K8, the key-padding forward, runs
// bert_attn.cu's kernels.
//
// bf16 instances (the kernels are templates on the storage type T, the
// last template argument): q, k, v, dO, O and the outputs bf16, lse and
// delta float32, everything between float32, as the JAX kernels compute at
// bf16 operands: the products at HIGHEST precision, p kept in float32
// through P V, out, dq, dk and dv each rounded to nearest even once, at
// the store, and K5b's delta summed in float32 from the stored bf16 O.  A
// bf16 row of D = 25 starts on any 2-byte boundary, which cp.async cannot
// copy from, so the bf16 operands come through registers into the same
// float32 staging (stage_rows4's bf16 form: done when it returns, with no
// slice or tile in flight behind the compute); every plan and carve-up is
// the float32 one.  A bf16 value is exact in TF32, so its lo plane is zero
// and the 3xTF32 products of two bf16 operands are exact (their correction
// MMAs add zeros: a later saving).
//
// Dropout: the keep bit of weight (row, col) is murmur3 fmix32 of
// seed ^ row*0x9E3779B1 ^ col*0x85EBCA77 (uint32 arithmetic), top 24 bits
// times 2^-24, kept where u >= rate, in global positions, so the forward
// and the backward kernels regenerate the same mask at any tiling and it
// equals the JAX package's _hash_uniform bit for bit.  The normalizer
// sums the raw p; only the value accumulation sees p * keep / (1 - rate).
//
// What bounds them on the H100 (bytes: every input read once, every output
// written once, at 3.35 TB/s; operations: the visible score pairs' products
// at the 3xTF32 rate, 165 TFLOP/s): at the MOSEI stack shapes (T <= 64,
// D = 25, B*H = 32768) a slice's work is a few products of at most
// 64 x 64 x 25, a few FLOPs per byte against the card's 49, so bytes bound
// them: K5f 0.198 ms (self T=50) and 0.163 (cross Tq=50 Tk=32), K5b 0.39 /
// 0.32, K5dkv 0.30 / 0.23.  At T = 2048 (B*H = 128, causal) the products
// do: K5f 0.163 ms, K5dq 0.244, K5dkv 0.326.  No [Tq, Tk] tensor touches
// device memory, key tiles a causal query tile cannot see (and query tiles
// that cannot see a key tile) are skipped, and no kernel uses float
// atomics, so a rerun gives the same bits.
//
// Every kernel here runs its products on the tensor cores in 3xTF32
// (mma.sync m16n8k8 from gemm_tc.cuh, operands split into TF32 hi + lo:
// float32 accuracy); their float32 operands arrive by 4-byte cp.async (a
// [T][25] slice starts only 4-byte aligned) into rows of ld = 4 mod 8 floats,
// zero-filled past D and past the slice, so the fragment loads are free of
// bank conflicts.  A score tile's C fragments feed the value product
// without a trip through shared memory: the product's k index is permuted
// (k = t for column 2t, k = t + 4 for 2t + 1: c_to_a, frag_b_perm).  Each
// pair's mask, exp and dropout draw run without a branch, and every warp
// runs the products, a warp past the slice on zero rows that it does not
// store: a branch the compiler cannot prove warp-uniform costs each shuffle
// and MMA under it a convergence step.
//   * K5f, path 0 (Tq, Tk <= 64, every MOSEI stack): a persistent block of
//     4 warps walks slices u = blockIdx.x, + gridDim.x, ...; one barrier a
//     slice, after which the next slice goes in flight into the other of
//     two shared-memory slots.  A warp takes 16 query rows against every
//     key of the slice, so the row max and sum are taken once, in
//     registers, by quad shuffles; out / l is stored from the registers.
//   * K5f, path 1 (longer): a block per (slice, 128 query rows; 64 where
//     D > 64, for shared memory), the heaviest query tiles first under the
//     causal rule; 64-key tiles of k and v in a 2-stage cp.async ring; q
//     split into hi / lo once, into two shared-memory planes; the online
//     softmax keeps m and l per row in registers, and only the tiles the
//     rule or Tk cuts test each pair.
//   * K5dkv: a block per (slice, 64 keys), 16 keys a warp, the key tile
//     that the most queries see first; from the first query tile that sees
//     its keys it walks 64-query tiles of q, dO, lse and delta in a 2-stage
//     cp.async ring, 32 queries at a time: S^T = K Q^T and dP'^T = V dO^T,
//     then p, M, M*p and dS in registers, and dV += (M p)^T dO, dK += dS^T
//     Q into accumulators that stay in registers for the whole walk,
//     unpromoted (2.8e-5 of max |ref| at T=2048 against 7.6e-6 promoted
//     every 4 query tiles, which cost 1-4% more time: tools/k5_trials.py).
//   * K5dq: path 1's walk, a block per (slice, bq query rows) of bq / 16
//     warps (bq 64, 32 at D > 64 with Tk > 64 for shared memory, down to Tq
//     rounded up to a power of two, at least 16: one warp where Tq <= 16),
//     the heaviest query tile first, 3 blocks an SM at D <= 32; 64-key
//     tiles of k and v in a cp.async ring (one stage where Tk <= 64); q and
//     dO split into hi / lo once, into four planes; lse and delta in
//     registers.  A key tile's S = Q K^T and dP' = dO V^T come from
//     score_tile, p, M and dS from registers, dQ += dS K from value_product
//     with k's rows as its B operand; dQ is stored once from the registers.
// What holds them above their bounds (PERF.md, tools/k5_trials.py): path 0
// stages a slice in about its byte time but computes for 2.7 times it
// (16 warps an SM, latency-bound: a fifth of it the 3xTF32 corrections, a
// sixth the hash); path 1 and K5dkv spend two fifths of their time in the
// correction MMAs and most of the rest loading and splitting B fragments,
// which each warp of a block repeats for the same tile; K5dq spends about
// two fifths of its time at T = 2048 in the correction MMAs and 11-15% at
// the MOSEI shapes in the hash, and registers hold it to 12 warps an SM.
// The plans are Python: ops/attention_cuda._plan_flash_fwd,
// _plan_flash_dkv, _plan_flash_dq and _plan_flash_bwd (K5b).
#include "gemm_tc.cuh"

namespace {

constexpr float FA_NEG_INF = -1e30f;

// The inverted-dropout factor M of weight (row, col): keep / (1 - rate).
__device__ __forceinline__ float keep_factor(int use_dropout, uint32_t seed, float rate,
                                             float keep_scale, int row, int col) {
  if (!use_dropout) return 1.f;
  return hash_uniform(seed, row, col) >= rate ? keep_scale : 0.f;
}

// Rows [0, n) of a row-major [., D] bf16 source into dst[r * ld + c] as
// float32 (exact), zero past column D (to dp) and in rows n .. fill-1: the
// bf16 instances' staging.  A bf16 row may start on any 2-byte boundary,
// which cp.async cannot copy from, so the rows come through registers, R
// rows a lane in flight at once: the block's warps over rows, lanes over
// columns.  The copies are done when it returns (the cp.async groups the
// callers commit stay empty), so a slot or ring stage is filled before the
// barrier that hands it on, as the float32 forms' waits guarantee.
__device__ __forceinline__ void stage_rows4(float* dst, const bf16* src, int n, int fill,
                                            int D, int dp, int ld) {
  constexpr int R = 8;
  const int nw = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c = lane; c < dp; c += 32) {
    const bool col_ok = c < D;
    for (int r0 = warp; r0 < fill; r0 += R * nw) {
      float x[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = r0 + i * nw;
        x[i] = col_ok && r < n ? bf2f(src[(long long)r * D + c]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (r0 + i * nw < fill) dst[(r0 + i * nw) * ld + c] = x[i];
    }
  }
}

// K5b: the whole backward of one (b*h) slice in one pass, for Tq, Tk <= 64,
// its five products on the tensor cores in 3xTF32 (mma.sync m16n8k8 from
// gemm_tc.cuh, operands split into TF32 hi + lo: float32 accuracy).  It
// reads each input once and writes each output once, where K5dq + K5dkv
// read q, k, v, dO twice, recompute S, dP', p and the hash twice and need
// the delta op before them.  A persistent block walks slices u =
// blockIdx.x, + gridDim.x, ...; it owns a slice's dq, dk and dv outright (no
// atomics, the same bits on a rerun).  Shared memory: one slice's q, dO, O
// [qp8][ld], k, v [kp8][ld], lse [qp8] and (seed, rate), zero-filled past
// the slice and staged by 4-byte cp.async (a [T][25] slice starts only
// 8-byte aligned); then the M*p tile [qp8][ldp] and the dS tile
// [16*mq][ldp].  One slot, so that FB_BLOCKS_PER_SM (3) blocks fit an SM at
// the MOSEI shapes; a second slot, the next slice in flight, would cost a
// block, and ran slower in every trial.  Row strides: ld = 4 mod 8 words
// and ldp = 8 mod 32, so the fragment loads of the score products and of
// dV / dK are free of bank conflicts (those of dQ and the value operands of phase 2 meet two-way
// conflicts).  A 16-row fragment may read past qp8 into the next operand:
// those rows are past Tq, and what they make is dropped.
//   phase 1: a warp per (16-row tile, group of ng1 8-key tiles): S = Q K^T
//            and dP' = dO V^T, delta = rowsum(dO * O) for its rows, then per
//            pair p = exp(s - lse), M from the hash, once, and M*p and dS =
//            p * (M*dP' - delta) into the tiles (0 where the causal rule or
//            the slice's edge hides the pair); tiles the rule hides whole
//            are not multiplied;
//   phase 2: a warp per unit of 16 output rows x 16 columns: dV = (M p)^T dO
//            and dK = dS^T Q over the rows that see the unit's keys, dQ = dS
//            K over the keys its rows see; each output written once.
// Bound: bytes (0.32 / 0.39 ms at the MOSEI cross / self shapes, B*H =
// 32768); the products are ~0.08 ms at the 3xTF32 rate.  What holds it
// above that is the instruction stream: the staging and the two phases take
// their times one after another, with little overlap between the blocks of
// an SM, and the 3xTF32 correction MMAs are a fifth of the whole (PERF.md,
// tools/k5b_trials.py).
struct FbDims {
  int Tq, Tk, D, dp4, ld, qp8, kp8, mq, mk, nk, ldp, ng1, causal, offset, use_dropout, buf;
};

// FB_BLOCKS_PER_SM, the launch bound below, comes from the build's flags
// (_build.FB_BLOCKS_PER_SM), which the plan sizes its grid by too.
constexpr int FB_THREADS = 256;
constexpr int FB_WARPS = FB_THREADS / 32;

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Rows [0, n) of a row-major [n][D] slice into dst[r * ld + c], rows n ..
// fill-1 and columns D .. 4*dp4-1 zero: a warp a row, lanes over columns,
// the pointers stepped from row to row so a copy costs a few instructions.
__device__ __forceinline__ void fb_stage_rows(float* dst, const float* src, int n, int fill,
                                              const FbDims& d) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c = lane; c < 4 * d.dp4; c += 32) {
    const bool col_ok = c < d.D;
    const float* sp = col_ok ? src + (long long)warp * d.D + c : src;
    const long long sstep = col_ok ? (long long)FB_WARPS * d.D : 0;
    float* dp_ = dst + warp * d.ld + c;
    int r = warp;
    for (; r < n; r += FB_WARPS, sp += sstep, dp_ += FB_WARPS * d.ld)
      cp_async4(dp_, sp, col_ok);
    for (; r < fill; r += FB_WARPS, dp_ += FB_WARPS * d.ld) cp_async4(dp_, src, false);
  }
}

// The bf16 instance's form (stage_rows4's).
__device__ __forceinline__ void fb_stage_rows(float* dst, const bf16* src, int n, int fill,
                                              const FbDims& d) {
  stage_rows4(dst, src, n, fill, d.D, 4 * d.dp4, d.ld);
}

template <typename T>
__device__ __forceinline__ void fb_stage_slice(float* buf, const T* Q, const T* K, const T* V,
                                               const T* dO, const T* O, const float* LSE,
                                               const int* seeds, const float* rates, int u,
                                               const FbDims& d) {
  float* qs = buf;
  float* dos = qs + d.qp8 * d.ld;
  float* os = dos + d.qp8 * d.ld;
  float* ks = os + d.qp8 * d.ld;
  float* vs = ks + d.kp8 * d.ld;
  float* ls = vs + d.kp8 * d.ld;
  const long long qo = (long long)u * d.Tq * d.D, ko = (long long)u * d.Tk * d.D;
  fb_stage_rows(qs, Q + qo, d.Tq, d.qp8, d);
  fb_stage_rows(dos, dO + qo, d.Tq, d.qp8, d);
  fb_stage_rows(os, O + qo, d.Tq, d.qp8, d);
  fb_stage_rows(ks, K + ko, d.Tk, d.kp8, d);
  fb_stage_rows(vs, V + ko, d.Tk, d.kp8, d);
  const float* lrow = LSE + (long long)u * d.Tq;
  for (int i = threadIdx.x; i < d.qp8; i += FB_THREADS)
    cp_async4(ls + i, i < d.Tq ? lrow + i : lrow, i < d.Tq);
  if (d.use_dropout && threadIdx.x == 0) {
    cp_async4(ls + d.qp8, seeds + u, true);
    cp_async4(ls + d.qp8 + 1, rates + u, true);
  }
}

// The A fragment (16 x 8, row-major) of rows m0.., columns k0.. of a
// matrix at p[row * sr + col * sc], split into TF32 hi / lo.
__device__ __forceinline__ void fb_frag_a(const float* p, int sr, int sc, int m0, int k0,
                                          uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int g = (threadIdx.x % 32) >> 2, t = threadIdx.x & 3;
  const float* b = p + (m0 + g) * sr + (k0 + t) * sc;
  split_tf32(b[0], hi[0], lo[0]);
  split_tf32(b[8 * sr], hi[1], lo[1]);
  split_tf32(b[4 * sc], hi[2], lo[2]);
  split_tf32(b[8 * sr + 4 * sc], hi[3], lo[3]);
}

// The B fragment (8 x 8) of B(k, n) = p[k * sk + n * sn], k0.., n0...
__device__ __forceinline__ void fb_frag_b(const float* p, int sk, int sn, int k0, int n0,
                                          uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const int g = (threadIdx.x % 32) >> 2, t = threadIdx.x & 3;
  const float* b = p + (k0 + t) * sk + (n0 + g) * sn;
  split_tf32(b[0], hi[0], lo[0]);
  split_tf32(b[4 * sk], hi[1], lo[1]);
}

// c += a b in 3xTF32 (lo*hi + hi*lo + hi*hi; lo*lo dropped)
__device__ __forceinline__ void fb_mma3(float (&c)[4], const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                        const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// Phase 1 for one warp: rows m0 .. m0+15, key tiles nt0 .. nt0+ng1-1 of 8
// keys (fewer at the slice's edge; ng1 <= 4).
__device__ __forceinline__ void fb_scores(const float* qs, const float* dos, const float* os,
                                          const float* ks, const float* vs, const float* ls,
                                          float* pm_t, float* ds_t, const FbDims& d, int m0,
                                          int nt0, uint32_t seed, float rate,
                                          float keep_scale) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int ld = d.ld, ng = min(d.ng1, d.nk - nt0);
  const int r0 = m0 + g, r1 = r0 + 8;
  // delta of rows r0 and r1: the four lanes of a row split its columns
  float del0 = 0.f, del1 = 0.f;
  for (int c = 4 * t; c < 4 * d.dp4; c += 16) {
    del0 = dot4(ld4(dos + r0 * ld + c), ld4(os + r0 * ld + c), del0);
    del1 = dot4(ld4(dos + r1 * ld + c), ld4(os + r1 * ld + c), del1);
  }
  del0 += __shfl_xor_sync(0xffffffffu, del0, 1);
  del0 += __shfl_xor_sync(0xffffffffu, del0, 2);
  del1 += __shfl_xor_sync(0xffffffffu, del1, 1);
  del1 += __shfl_xor_sync(0xffffffffu, del1, 2);
  bool live[4];
  float s[4][4], dp[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // the tile's first key against its last row
    live[j] = j < ng && (!d.causal || 8 * (nt0 + j) - (m0 + 15) < d.offset);
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
  }
#pragma unroll 2
  for (int k0 = 0; k0 < 4 * d.dp4; k0 += 8) {
    uint32_t qh[4], ql[4], oh[4], ol[4];
    fb_frag_a(qs, ld, 1, m0, k0, qh, ql);
    fb_frag_a(dos, ld, 1, m0, k0, oh, ol);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!live[j]) continue;
      uint32_t bh[2], bl[2];
      fb_frag_b(ks, 1, ld, k0, 8 * (nt0 + j), bh, bl);
      fb_mma3(s[j], qh, ql, bh, bl);
      fb_frag_b(vs, 1, ld, k0, 8 * (nt0 + j), bh, bl);
      fb_mma3(dp[j], oh, ol, bh, bl);
    }
  }
  const float lse0 = r0 < d.Tq ? ls[r0] : 0.f, lse1 = r1 < d.Tq ? ls[r1] : 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= ng) break;
    float pm[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? r0 : r1, col = 8 * (nt0 + j) + 2 * t + (e & 1);
      const bool ok = live[j] && row < d.Tq && col < d.Tk &&
                      (!d.causal || col - row < d.offset);
      pm[e] = ds[e] = 0.f;
      if (ok) {
        const float p = __expf(s[j][e] - (e < 2 ? lse0 : lse1));
        const float mk = keep_factor(d.use_dropout, seed, rate, keep_scale, row, col);
        pm[e] = p * mk;
        ds[e] = p * (dp[j][e] * mk - (e < 2 ? del0 : del1));
      }
    }
    const int c = 8 * (nt0 + j) + 2 * t;
    *reinterpret_cast<float2*>(ds_t + r0 * d.ldp + c) = make_float2(ds[0], ds[1]);
    *reinterpret_cast<float2*>(ds_t + r1 * d.ldp + c) = make_float2(ds[2], ds[3]);
    *reinterpret_cast<float2*>(pm_t + r0 * d.ldp + c) = make_float2(pm[0], pm[1]);
    if (r1 < d.qp8)   // the M*p tile holds qp8 rows (dV reads no more)
      *reinterpret_cast<float2*>(pm_t + r1 * d.ldp + c) = make_float2(pm[2], pm[3]);
  }
}

// Phase 2 for one warp: out[m0 .. m0+15][n0 .. n0+15] (two 8-column tiles,
// the second only if n0 + 8 < 4*dp4) = sum over k in [k_lo, k_hi) (steps
// of 8) of A(m, k) B(k, n), A(m, k) = a[m * asr + k * asc], B(k, n) =
// b[k * ld + n]; written to dst[m * D + n] for m < m_end, n < D.
template <typename T>
__device__ __forceinline__ void fb_product(const float* a, int asr, int asc, const float* b,
                                           int ld, int m0, int n0, int k_lo, int k_hi,
                                           bool two, T* dst, int m_end, int D) {
  // the three TF32 products of each tile in chains of their own (the MMA's
  // latency, not its rate, would bound one chain), added at the end
  float c[2][4], ca[2][4], cb[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = ca[j][e] = cb[j][e] = 0.f;
#pragma unroll 2
  for (int k0 = k_lo; k0 < k_hi; k0 += 8) {
    uint32_t ah[4], al[4], bh[2], bl[2];
    fb_frag_a(a, asr, asc, m0, k0, ah, al);
    fb_frag_b(b, ld, 1, k0, n0, bh, bl);
    mma_tf32(ca[0], al, bh);
    mma_tf32(cb[0], ah, bl);
    mma_tf32(c[0], ah, bh);
    if (two) {
      fb_frag_b(b, ld, 1, k0, n0 + 8, bh, bl);
      mma_tf32(ca[1], al, bh);
      mma_tf32(cb[1], ah, bl);
      mma_tf32(c[1], ah, bh);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] += ca[j][e] + cb[j][e];
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + g + (e < 2 ? 0 : 8), n = n0 + 8 * j + 2 * t + (e & 1);
      if (m < m_end && n < D && (j == 0 || two)) st_f(dst + (long long)m * D + n, c[j][e]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(FB_THREADS, FB_BLOCKS_PER_SM)
flash_bwd_fused_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                       const T* __restrict__ V, const T* __restrict__ dO,
                       const T* __restrict__ O, const float* __restrict__ LSE,
                       const int* __restrict__ seeds, const float* __restrict__ rates,
                       T* __restrict__ dQ, T* __restrict__ dK, T* __restrict__ dV,
                       int units, FbDims d) {
  extern __shared__ float4 fb_smem4[];
  float* smem = reinterpret_cast<float*>(fb_smem4);
  const int ld = d.ld, ldp = d.ldp, Tq = d.Tq, Tk = d.Tk, D = d.D;
  float* pm_t = smem + d.buf;          // [qp8][ldp] M * p
  float* ds_t = pm_t + d.qp8 * ldp;    // [16 mq][ldp] dS
  const int warp = threadIdx.x / 32;
  const int n_items = d.mq * ((d.nk + d.ng1 - 1) / d.ng1);   // phase 1
  const int ngr = (d.dp4 + 3) / 4;   // phase 2's 16-column groups
  const int n_kv = d.mk * ngr, n_units = 2 * n_kv + d.mq * ngr;

  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    fb_stage_slice(smem, Q, K, V, dO, O, LSE, seeds, rates, u, d);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();   // slice u landed, from every thread's copies
    const float* qs = smem;
    const float* dos = qs + d.qp8 * ld;
    const float* os = dos + d.qp8 * ld;
    const float* ks = os + d.qp8 * ld;
    const float* vs = ks + d.kp8 * ld;
    const float* ls = vs + d.kp8 * ld;
    const uint32_t seed = d.use_dropout ? __float_as_uint(ls[d.qp8]) : 0u;
    const float rate = d.use_dropout ? ls[d.qp8 + 1] : 0.f;
    const float keep_scale = d.use_dropout ? 1.0f / (1.0f - rate) : 1.f;

    for (int w = warp; w < n_items; w += FB_WARPS) {
      const int mt = w % d.mq, ngrp = w / d.mq;
      fb_scores(qs, dos, os, ks, vs, ls, pm_t, ds_t, d, 16 * mt, ngrp * d.ng1, seed, rate,
                keep_scale);
    }
    __syncthreads();   // the M*p and dS tiles are whole

    const long long qo = (long long)u * Tq * D, ko = (long long)u * Tk * D;
    for (int w = warp; w < n_units; w += FB_WARPS) {
      const int kind = w < n_kv ? 0 : (w < 2 * n_kv ? 1 : 2);
      const int x = w - kind * n_kv;
      const int mt = x / ngr, n0 = 16 * (x - mt * ngr), m0 = 16 * mt;
      const bool two = n0 + 8 < 4 * d.dp4;
      if (kind < 2) {
        // dV (kind 0) or dK (1): keys m0.., rows from the first that sees m0
        const int k_lo = d.causal ? max(0, m0 - d.offset + 1) & ~7 : 0;
        fb_product(kind ? ds_t : pm_t, 1, ldp, kind ? qs : dos, ld, m0, n0, k_lo, d.qp8, two,
                   (kind ? dK : dV) + ko, Tk, D);
      } else {
        // dQ: rows m0.., keys up to the last its rows see
        const int k_hi = d.causal ? min(d.kp8, (m0 + 15 + d.offset + 7) & ~7) : d.kp8;
        fb_product(ds_t, ldp, 1, ks, ld, m0, n0, 0, k_hi, two, dQ + qo, Tq, D);
      }
    }
    __syncthreads();   // the slot and the tiles are refilled next iteration
  }
}

// K5b's launch from the plan (ops/attention_cuda._plan_flash_bwd), host
// ints: path (0: K5b; anything else is refused here), blocks (the
// persistent grid), smem bytes, then dp4, ld, qp8, kp8, mq, mk, nk, ldp,
// ng1 as FbDims names them.
template <typename T>
cudaError_t launch_fused_bwd(const T* q, const T* k, const T* v, const T* dout, const T* out,
                             const float* lse, const int* seeds, const float* rates, T* dq,
                             T* dk, T* dv, int BH, int Tq, int Tk, int D, int causal,
                             int offset, int use_dropout, const int* plan,
                             cudaStream_t stream) {
  const int path = plan[0], blocks = plan[1], smem = plan[2];
  const FbDims d{Tq, Tk, D, plan[3], plan[4], plan[5], plan[6], plan[7], plan[8], plan[9],
                 plan[10], plan[11], causal, offset, use_dropout,
                 plan[4] * (3 * plan[5] + 2 * plan[6]) + plan[5] + 4};
  if (path != 0 || Tq > 64 || Tk > 64 || blocks < 1 || d.dp4 % 2 || d.ng1 < 1 || d.ng1 > 4)
    return cudaErrorInvalidValue;
  static unsigned long long set = 0;
  const cudaError_t err = allow_smem_once((const void*)flash_bwd_fused_kernel<T>, &set);
  if (err != cudaSuccess) return err;
  flash_bwd_fused_kernel<T><<<blocks, FB_THREADS, smem, stream>>>(
      q, k, v, dout, out, lse, seeds, rates, dq, dk, dv, BH, d);
  return cudaGetLastError();
}

// ---- K5f, K5dkv and K5dq ----------------------------------------------------

// K5f's, K5dkv's and K5dq's launch, from the plan (ops/attention_cuda.
// _plan_flash_fwd / _plan_flash_dkv / _plan_flash_dq) and the call.
struct FlashDims {
  int Tq, Tk, D, causal, offset, use_dropout;
  int dt;            // 8-column tiles over D, a power of two: the padded width 8 dt
  int ld;            // a staged row's stride, 8 dt + 4 (4 mod 8) floats
  int qp, kp;        // K5f path 0: staged query rows (16 a warp), key rows (8 NKT)
  int slot;          // K5f path 0: floats a shared-memory slot (of two)
  int bq;            // K5f path 1, K5dq: query rows a block
  int stages;        // K5dq: the key ring's stages, min(DQ_STAGES, Tk's 64-key tiles)
};

constexpr int FK_TILE = 64;    // keys (K5f path 1) or queries (K5dkv) a ring stage holds
constexpr int FK_STAGES = 2;   // the ring's stages (K5f path 1, K5dkv)

// The loops over tiles below run to bounds known at compile time (DT, NK,
// the FULL flag) on every tile but the edges of a key range: a loop that
// leaves early on a runtime count makes each tile a basic block of its own,
// and the dependent MMAs of one tile then run back to back instead of
// interleaving with the next tile's.

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The A fragment (16 x 8) of a tile whose C fragments the thread holds
// (rows g and g + 8, columns 2t and 2t + 1 of an 8-column tile), with the
// product's k index permuted: k = t stands for column 2t, k = t + 4 for
// column 2t + 1.  A sum over k does not care about the order, so scores go
// from one product's accumulators into the next product's A operand in
// registers; frag_b_perm reads the B rows in the same order.
__device__ __forceinline__ void c_to_a(const float (&c)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

// The B fragment (8 x 8) that pairs with c_to_a: B(k, n) = p[row * ld + n]
// at rows k0 + 2t (k = t) and k0 + 2t + 1 (k = t + 4), columns n0 + g.
__device__ __forceinline__ void frag_b_perm(const float* p, int ld, int k0, int n0,
                                            uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const int g = (threadIdx.x % 32) >> 2, t = threadIdx.x & 3;
  const float* b = p + (k0 + 2 * t) * ld + n0 + g;
  split_tf32(b[0], hi[0], lo[0]);
  split_tf32(b[ld], hi[1], lo[1]);
}

// An A fragment already split, from two uint32 planes (hi, lo) of rows m0..
// and columns k0.. at row stride ld.
__device__ __forceinline__ void frag_a_planes(const uint32_t* hp, const uint32_t* lp, int ld,
                                              int m0, int k0, uint32_t (&hi)[4],
                                              uint32_t (&lo)[4]) {
  const int g = (threadIdx.x % 32) >> 2, t = threadIdx.x & 3;
  const int i = (m0 + g) * ld + k0 + t;
  hi[0] = hp[i];
  hi[1] = hp[i + 8 * ld];
  hi[2] = hp[i + 4];
  hi[3] = hp[i + 8 * ld + 4];
  lo[0] = lp[i];
  lo[1] = lp[i + 8 * ld];
  lo[2] = lp[i + 4];
  lo[3] = lp[i + 8 * ld + 4];
}

// Rows [0, n) of a row-major [., D] source into dst[r * ld + c] for c < dp,
// zero past column D and in rows n .. fill-1, by 4-byte cp.async: the
// block's warps over rows, lanes over columns (one coalesced read a row).
__device__ __forceinline__ void stage_rows4(float* dst, const float* src, int n, int fill,
                                            int D, int dp, int ld) {
  const int nw = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c = lane; c < dp; c += 32) {
    const bool col_ok = c < D;
    const float* sp = src + (long long)warp * D + c;
    float* dst_ = dst + warp * ld + c;
    int r = warp;
    for (; r < n; r += nw, sp += (long long)nw * D, dst_ += nw * ld)
      cp_async4(dst_, col_ok ? sp : src, col_ok);
    for (; r < fill; r += nw, dst_ += nw * ld) cp_async4(dst_, src, false);
  }
}

// Rows [0, n) of src [.][ld], columns < D, to a row-major [., D] dst (each
// value rounded once where dst is bf16): the block's warps over rows,
// lanes over columns (one coalesced store a row).
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, const float* src, int n, int D, int ld) {
  const int nw = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < n; r += nw)
    for (int c = lane; c < D; c += 32) st_f(dst + (long long)r * D + c, src[r * ld + c]);
}

// C fragments (rows m0 + g and + 8, all 8 DT columns) into rows m0.. of
// dst [.][ld].
template <int DT>
__device__ __forceinline__ void put_rows(float* dst, int ld, int m0, const float (&o)[DT][4]) {
  const int g = (threadIdx.x % 32) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    const int c = 8 * n + 2 * t;
    *reinterpret_cast<float2*>(dst + (m0 + g) * ld + c) = make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(dst + (m0 + g + 8) * ld + c) = make_float2(o[n][2], o[n][3]);
  }
}

// out / l of C fragments (rows row0 + g and + 8, inv_a and inv_b their
// 1 / l) to the slice's rows of a row-major [Tq, D] out, rows < Tq and
// columns < D only: stores straight from the registers (each value rounded
// once where out is bf16).
template <int DT, typename T>
__device__ __forceinline__ void store_out(T* out, int row0, const FlashDims& d,
                                          const float (&o)[DT][4], float inv_a, float inv_b) {
  const int g = (threadIdx.x % 32) >> 2, t = threadIdx.x & 3;
  const int ra = row0 + g, rb = ra + 8;
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e < 2 ? ra : rb, c = 8 * n + 2 * t + (e & 1);
      if (r < d.Tq && c < d.D)
        st_f(out + (long long)r * d.D + c, o[n][e] * (e < 2 ? inv_a : inv_b));
    }
}

// The score tile of one warp: s[j] (j < nk <= NK, 8 keys each) = Q K^T for
// query rows m0.. (A fragments from aq(kk, hi, lo)) against key rows 8j..
// of ks; s[j] for j >= nk stays zero.  Callers pass nk = NK where they can
// (the test folds away); an edge tile passes its count.
template <int DT, int NK, typename QFrag>
__device__ __forceinline__ void score_tile(float (&s)[8][4], QFrag aq, const float* ks, int ld,
                                           int nk) {
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DT; ++kk) {
    uint32_t ah[4], al[4];
    aq(kk, ah, al);
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      if (j >= nk) break;
      uint32_t bh[2], bl[2];
      fb_frag_b(ks, 1, ld, 8 * kk, 8 * j, bh, bl);
      fb_mma3(s[j], ah, al, bh, bl);
    }
  }
}

// s[j][e] (j < NK) -> -inf where the pair at (query row0 + g (+8), key col0
// + 8j + 2t (+1)) is past Tk or hidden by the causal rule (only if TEST);
// then the rows' maxima over the tile (quad-reduced).
template <int NK, bool TEST>
__device__ __forceinline__ void mask_and_max(float (&s)[8][4], int row0, int col0,
                                             const FlashDims& d, float& mx_a, float& mx_b) {
  const int g = (threadIdx.x % 32) >> 2, t = threadIdx.x & 3;
  mx_a = mx_b = -INFINITY;
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    if constexpr (TEST) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + g + (e < 2 ? 0 : 8), col = col0 + 8 * j + 2 * t + (e & 1);
        if (col >= d.Tk || (d.causal && col - row >= d.offset)) s[j][e] = -INFINITY;
      }
    }
    mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
    mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
  }
  mx_a = quad_max(mx_a);
  mx_b = quad_max(mx_b);
}

// p = exp(s - m) in place (j < NK), its raw row sums added to l_a / l_b
// (this thread's share), then p * M, M the dropout factor at (row, col):
// no branch a pair, the hash drawn for every pair of the tile.
template <int NK>
__device__ __forceinline__ void exp_and_drop(float (&s)[8][4], int row0, int col0, float m_a,
                                             float m_b, float& l_a, float& l_b,
                                             const FlashDims& d, uint32_t seed, float rate,
                                             float keep_scale) {
  const int g = (threadIdx.x % 32) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = __expf(s[j][e] - (e < 2 ? m_a : m_b));
      if (e < 2) l_a += p; else l_b += p;
      s[j][e] = p;
    }
  if (!d.use_dropout) return;
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float u = hash_uniform(seed, row0 + g + (e < 2 ? 0 : 8),
                                   col0 + 8 * j + 2 * t + (e & 1));
      s[j][e] = u >= rate ? s[j][e] * keep_scale : 0.f;
    }
}

// o[n] + oc[n] += P V over nk <= NK 8-key tiles (nk as in score_tile): P
// from the score registers (c_to_a), V rows [8 nk][ld] at vs.  The hi * hi
// products go to o, the two corrections (lo * hi, hi * lo) to oc: two
// shorter chains of dependent MMAs.
template <int DT, int NK>
__device__ __forceinline__ void value_product(float (&o)[DT][4], float (&oc)[DT][4],
                                              const float (&s)[8][4], const float* vs, int ld,
                                              int nk) {
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    if (j >= nk) break;
    uint32_t ah[4], al[4];
    c_to_a(s[j], ah, al);
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      uint32_t bh[2], bl[2];
      frag_b_perm(vs, ld, 8 * j, 8 * n, bh, bl);
      mma_tf32(oc[n], al, bh);
      mma_tf32(oc[n], ah, bl);
      mma_tf32(o[n], ah, bh);
    }
  }
}

// K5f path 0 for one warp: query rows m0 .. m0+15 of a slice staged whole
// (qs [64][ld], ks and vs [8 NKT][ld], zero-padded) against all NKT key
// tiles (the causal rule masks pairs; every warp does the same work, so the
// block's barrier waits for none).  Every key is in the tile, so max and
// sum are taken in one pass.  Writes out / l and lse.
template <int DT, int NKT, typename T>
__device__ __forceinline__ void fwd_unit_rows(const float* qs, const float* ks, const float* vs,
                                              T* out, float* lse_row, int m0,
                                              const FlashDims& d, uint32_t seed, float rate,
                                              float keep_scale) {
  const int g = (threadIdx.x % 32) >> 2, t = threadIdx.x & 3;
  float s[8][4];
  score_tile<DT, NKT>(s, [&](int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) {
    fb_frag_a(qs, d.ld, 1, m0, 8 * kk, ah, al);
  }, ks, d.ld, NKT);
  float m_a, m_b, l_a = 0.f, l_b = 0.f;
  mask_and_max<NKT, true>(s, m0, 0, d, m_a, m_b);
  m_a = fmaxf(m_a, FA_NEG_INF);   // a row that sees no key: p = 0, out 0
  m_b = fmaxf(m_b, FA_NEG_INF);
  exp_and_drop<NKT>(s, m0, 0, m_a, m_b, l_a, l_b, d, seed, rate, keep_scale);
  l_a = fmaxf(quad_sum(l_a), 1e-30f);
  l_b = fmaxf(quad_sum(l_b), 1e-30f);
  float o[DT][4], oc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = oc[n][e] = 0.f;
  value_product<DT, NKT>(o, oc, s, vs, d.ld, NKT);
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] += oc[n][e];
  store_out<DT>(out, m0, d, o, 1.f / l_a, 1.f / l_b);
  if (t == 0) {
    if (m0 + g < d.Tq) lse_row[m0 + g] = m_a + logf(l_a);
    if (m0 + g + 8 < d.Tq) lse_row[m0 + g + 8] = m_b + logf(l_b);
  }
}

// One slice's q, k, v (and seed, rate) into a slot of path 0: q [qp][ld],
// k and v [kp][ld], then seed and rate.
template <typename T>
__device__ __forceinline__ void fwd_stage_slice(float* qs, const T* Q, const T* K, const T* V,
                                                const int* seeds, const float* rates, int u,
                                                const FlashDims& d) {
  float* ks = qs + d.qp * d.ld;
  float* vs = ks + d.kp * d.ld;
  const long long qo = (long long)u * d.Tq * d.D, ko = (long long)u * d.Tk * d.D;
  stage_rows4(qs, Q + qo, d.Tq, d.qp, d.D, 8 * d.dt, d.ld);
  stage_rows4(ks, K + ko, d.Tk, d.kp, d.D, 8 * d.dt, d.ld);
  stage_rows4(vs, V + ko, d.Tk, d.kp, d.D, 8 * d.dt, d.ld);
  if (d.use_dropout && threadIdx.x == 0) {
    cp_async4(vs + d.kp * d.ld, seeds + u, true);
    cp_async4(vs + d.kp * d.ld + 1, rates + u, true);
  }
}

// K5f, path 0 (Tq, Tk <= 64): persistent blocks of 4 warps, a warp a
// 16-row query tile (qp = 64 staged rows), NKT = 4 or 8 key tiles (kp =
// 8 NKT staged key rows); FU_BLOCKS_PER_SM (the build's flag, which the
// plan sizes its grid by) blocks an SM where D <= 32; wider slots hold
// fewer (2 at D <= 64, 1 beyond), and the launch bound leaves those
// instances the registers.
constexpr int FU_THREADS = 128;

template <int DT, int NKT, typename T>
__global__ void __launch_bounds__(FU_THREADS, DT <= 4 ? FU_BLOCKS_PER_SM : 16 / DT)
flash_fwd_unit_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                      const T* __restrict__ V, const int* __restrict__ seeds,
                      const float* __restrict__ rates, T* __restrict__ O,
                      float* __restrict__ LSE, int units, FlashDims d) {
  extern __shared__ float4 fu_smem4[];
  float* smem = reinterpret_cast<float*>(fu_smem4);
  const int m0 = 16 * (threadIdx.x / 32);
  int u = blockIdx.x;
  if (u < units) fwd_stage_slice(smem, Q, K, V, seeds, rates, u, d);
  cp_async_commit();
  for (int it = 0; u < units; ++it, u += gridDim.x) {
    const float* qs = smem + (it & 1) * d.slot;
    cp_async_wait<0>();
    // slice u landed, from every thread's copies, and every warp is done
    // with the other slot, which takes the next slice now
    __syncthreads();
    if (u + (int)gridDim.x < units)
      fwd_stage_slice(smem + ((it + 1) & 1) * d.slot, Q, K, V, seeds, rates, u + gridDim.x, d);
    cp_async_commit();
    const float* ks = qs + d.qp * d.ld;
    const float* vs = ks + d.kp * d.ld;
    const float* sr = vs + d.kp * d.ld;
    const uint32_t seed = d.use_dropout ? __float_as_uint(sr[0]) : 0u;
    const float rate = d.use_dropout ? sr[1] : 0.f;
    const float keep_scale = d.use_dropout ? 1.0f / (1.0f - rate) : 1.f;
    // every warp computes: rows past Tq read zeros and store nothing
    fwd_unit_rows<DT, NKT, T>(qs, ks, vs, O + (long long)u * d.Tq * d.D,
                           LSE + (long long)u * d.Tq, m0, d, seed, rate, keep_scale);
  }
}

// 64 rows of k and of v from row t0 (zero past Tk) into a ring stage [2][64][ld].
template <typename T>
__device__ __forceinline__ void fwd_stage_kv(float* ks, const T* K, const T* V, int t0,
                                             const FlashDims& d) {
  const int n = min(FK_TILE, d.Tk - t0);
  const long long o = (long long)t0 * d.D;
  stage_rows4(ks, K + o, n, FK_TILE, d.D, 8 * d.dt, d.ld);
  stage_rows4(ks + FK_TILE * d.ld, V + o, n, FK_TILE, d.D, 8 * d.dt, d.ld);
}

// One 64-key tile of K5f path 1 for one warp: the online-softmax update of
// (m, l) and the value accumulators.  FULL: all 8 key tiles, no pair
// masked (the block's interior tiles); else nk 8-key tiles and each pair
// tested.
template <int DT, bool FULL, typename QFrag>
__device__ __forceinline__ void fwd_key_tile(QFrag aq, const float* ks, const float* vs,
                                             int nk, int row0, int k0, const FlashDims& d,
                                             float& m_a, float& m_b, float& l_a, float& l_b,
                                             float (&o)[DT][4], float (&oc)[DT][4],
                                             uint32_t seed, float rate, float keep_scale) {
  float s[8][4], mx_a, mx_b;
  score_tile<DT, 8>(s, aq, ks, d.ld, FULL ? 8 : nk);
  // an edge tile's tiles past nk hold zeros: masked like any pair past Tk
  // or hidden by the rule
  mask_and_max<8, !FULL>(s, row0, k0, d, mx_a, mx_b);
  const float n_a = fmaxf(m_a, mx_a), n_b = fmaxf(m_b, mx_b);
  const float c_a = __expf(m_a - n_a), c_b = __expf(m_b - n_b);
  m_a = n_a;
  m_b = n_b;
  l_a *= c_a;
  l_b *= c_b;
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[n][e] *= e < 2 ? c_a : c_b;
      oc[n][e] *= e < 2 ? c_a : c_b;
    }
  exp_and_drop<8>(s, row0, k0, m_a, m_b, l_a, l_b, d, seed, rate, keep_scale);
  value_product<DT, 8>(o, oc, s, vs, d.ld, FULL ? 8 : nk);
}

// K5f, path 1 (Tq or Tk > 64): a block per (slice, bq query rows), bq / 16
// warps, 64-key tiles through a ring of FK_STAGES; online softmax.  The
// warp's q rows are split once and stay in shared memory as a hi and a lo
// plane.
template <int DT, typename T>
__global__ void __launch_bounds__(256)
flash_fwd_tiled_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                       const T* __restrict__ V, const int* __restrict__ seeds,
                       const float* __restrict__ rates, T* __restrict__ O,
                       float* __restrict__ LSE, int BH, FlashDims d) {
  extern __shared__ float4 ft_smem4[];
  float* smem = reinterpret_cast<float*>(ft_smem4);
  const int ld = d.ld, stage = 2 * FK_TILE * ld;
  float* qs = smem + FK_STAGES * stage;   // [bq][ld], then the lo plane
  const int nqt = (d.Tq + d.bq - 1) / d.bq;
  const int qt = nqt - 1 - (int)blockIdx.x / BH, bh = blockIdx.x % BH;   // heaviest first
  const int q0 = qt * d.bq, nq = min(d.bq, d.Tq - q0);
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int m0 = 16 * (threadIdx.x / 32), row0 = q0 + m0;
  const long long qo = ((long long)bh * d.Tq + q0) * d.D, ko = (long long)bh * d.Tk * d.D;
  const int k_end = d.causal ? min(d.Tk, q0 + nq - 1 + d.offset) : d.Tk;
  const int ntiles = (k_end + FK_TILE - 1) / FK_TILE;
  const uint32_t seed = d.use_dropout ? (uint32_t)seeds[bh] : 0u;
  const float rate = d.use_dropout ? rates[bh] : 0.f;
  const float keep_scale = d.use_dropout ? 1.0f / (1.0f - rate) : 1.f;

  stage_rows4(qs, Q + qo, nq, d.bq, d.D, 8 * DT, ld);   // joins tile 0's group
  for (int s = 0; s < FK_STAGES - 1; ++s) {
    if (s < ntiles) fwd_stage_kv(smem + s * stage, K + ko, V + ko, s * FK_TILE, d);
    cp_async_commit();
  }
  const uint32_t* qhp = reinterpret_cast<const uint32_t*>(qs);
  const uint32_t* qlp = qhp + d.bq * ld;
  const auto aq = [&](int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) {
    frag_a_planes(qhp, qlp, ld, m0, 8 * kk, ah, al);
  };
  float m_a = FA_NEG_INF, m_b = FA_NEG_INF, l_a = 0.f, l_b = 0.f, o[DT][4], oc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = oc[n][e] = 0.f;

  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<FK_STAGES - 2>();
    __syncthreads();   // tile kt landed; the stage refilled below was read last iteration
    const int next = kt + FK_STAGES - 1;
    if (next < ntiles) fwd_stage_kv(smem + (next % FK_STAGES) * stage, K + ko, V + ko,
                                    next * FK_TILE, d);
    cp_async_commit();
    // every warp computes: rows past the tile's nq read zeros and store nothing
    if (kt == 0) {   // q landed with tile 0: split the warp's rows once
      uint32_t* hp = reinterpret_cast<uint32_t*>(qs) + m0 * ld;
      uint32_t* lp = hp + d.bq * ld;
      for (int r = 0; r < 16; ++r)
        for (int c = lane; c < 8 * DT; c += 32) {
          uint32_t h, l;
          split_tf32(qs[(m0 + r) * ld + c], h, l);
          hp[r * ld + c] = h;
          lp[r * ld + c] = l;
        }
      __syncwarp();
    }
    const int k0 = kt * FK_TILE;
    if (d.causal && k0 - (row0 + 15) >= d.offset) continue;   // the warp sees none of it
    const float* ks = smem + (kt % FK_STAGES) * stage;
    const float* vs = ks + FK_TILE * ld;
    // the interior of the block's key range: every pair of the 64 x 16 tile visible
    if (k0 + FK_TILE <= d.Tk && (!d.causal || k0 + FK_TILE - 1 - row0 < d.offset)) {
      fwd_key_tile<DT, true>(aq, ks, vs, 8, row0, k0, d, m_a, m_b, l_a, l_b, o, oc, seed, rate,
                             keep_scale);
    } else {
      int nk = min(8, (d.Tk - k0 + 7) / 8);
      if (d.causal) nk = min(nk, (row0 + 15 + d.offset - k0 + 7) / 8);
      fwd_key_tile<DT, false>(aq, ks, vs, nk, row0, k0, d, m_a, m_b, l_a, l_b, o, oc, seed,
                              rate, keep_scale);
    }
  }
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] += oc[n][e];
  l_a = fmaxf(quad_sum(l_a), 1e-30f);
  l_b = fmaxf(quad_sum(l_b), 1e-30f);
  store_out<DT>(O + (long long)bh * d.Tq * d.D, row0, d, o, 1.f / l_a, 1.f / l_b);
  float* lse_row = LSE + (long long)bh * d.Tq;
  if (t == 0) {
    if (row0 + g < d.Tq) lse_row[row0 + g] = m_a + logf(l_a);
    if (row0 + g + 8 < d.Tq) lse_row[row0 + g + 8] = m_b + logf(l_b);
  }
}

// K5dkv: dK and dV of a (slice, 64 keys) block, 4 warps of 16 keys, over
// the query tiles that see its keys.  dV and dK sum over up to Tq queries
// in the tensor cores' truncating accumulators; DKV_PROMOTE > 0 adds them
// into float32 sums every DKV_PROMOTE query tiles (0: never; PERF.md,
// tools/k5_trials.py).
constexpr int FD_THREADS = 128;
constexpr int DKV_PROMOTE = 0;

// 64 query rows of q and dO, lse and delta from row t0 (zero past Tq) into
// a ring stage: q, dO [64][ld], lse [64], delta [64].
template <typename T>
__device__ __forceinline__ void dkv_stage_q(float* qs, const T* Q, const T* dO, const float* lse,
                                            const float* delta, int t0, const FlashDims& d) {
  const int n = min(FK_TILE, d.Tq - t0);
  const long long o = (long long)t0 * d.D;
  float* ls = qs + 2 * FK_TILE * d.ld;
  stage_rows4(qs, Q + o, n, FK_TILE, d.D, 8 * d.dt, d.ld);
  stage_rows4(qs + FK_TILE * d.ld, dO + o, n, FK_TILE, d.D, 8 * d.dt, d.ld);
  for (int i = threadIdx.x; i < FK_TILE; i += blockDim.x) {
    const bool ok = i < n;
    cp_async4(ls + i, ok ? lse + t0 + i : lse, ok);
    cp_async4(ls + FK_TILE + i, ok ? delta + t0 + i : delta, ok);
  }
}

// One warp's 16 keys (first key c0) against 32 staged queries (rows h0..
// of qs / dos, the first q0 + h0): S^T = K Q^T and dP'^T = V dO^T (K and V
// fragments from akv(kk, which, hi, lo)), then M p and dS in registers,
// then dV += (M p)^T dO and dK += dS^T Q.  FULL: every pair visible (no
// test); else 8-query tiles that see none of the keys are skipped and each
// pair is tested.
template <int DT, bool FULL, typename KVFrag>
__device__ __forceinline__ void dkv_half(KVFrag akv, const float* qs, const float* dos,
                                         const float* ls, int h0, int q0, int c0,
                                         const FlashDims& d, float (&dk)[DT][4],
                                         float (&dv)[DT][4], uint32_t seed, float rate,
                                         float keep_scale) {
  const int g = (threadIdx.x % 32) >> 2, t = threadIdx.x & 3, ld = d.ld;
  const int qa = q0 + h0;
  bool on[4];
  float st[4][4], dpt[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    // an 8-query tile sees the warp's keys: its last query against the first key
    on[n] = FULL || (qa + 8 * n < d.Tq && (!d.causal || c0 - (qa + 8 * n + 7) < d.offset));
#pragma unroll
    for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < DT; ++kk) {
    uint32_t ka[4], kb[4], va[4], vb[4];   // hi, lo
    akv(kk, 0, ka, kb);
    akv(kk, 1, va, vb);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      if (!FULL && !on[n]) continue;
      uint32_t bh[2], bl[2];
      fb_frag_b(qs, 1, ld, 8 * kk, h0 + 8 * n, bh, bl);
      fb_mma3(st[n], ka, kb, bh, bl);
      fb_frag_b(dos, 1, ld, 8 * kk, h0 + 8 * n, bh, bl);
      fb_mma3(dpt[n], va, vb, bh, bl);
    }
  }
  // S^T and dP'^T (keys g / g + 8, queries 2t / 2t + 1) -> M p and dS, no
  // branch a pair
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = c0 + g + (e < 2 ? 0 : 8), lq = h0 + 8 * n + 2 * t + (e & 1);
      const int row = q0 + lq;
      float p = __expf(st[n][e] - ls[lq]);
      if constexpr (!FULL) {
        const bool ok = on[n] && row < d.Tq && key < d.Tk &&
                        (!d.causal || key - row < d.offset);
        p = ok ? p : 0.f;
      }
      float mk = 1.f;
      if (d.use_dropout) mk = hash_uniform(seed, row, key) >= rate ? keep_scale : 0.f;
      st[n][e] = p * mk;
      dpt[n][e] = p * (dpt[n][e] * mk - ls[FK_TILE + lq]);
    }
  // dV += (M p)^T dO and dK += dS^T Q, the 8-query tiles as k steps
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    if (!FULL && !on[n]) continue;
    uint32_t ph[4], pl[4], sh[4], sl[4];
    c_to_a(st[n], ph, pl);
    c_to_a(dpt[n], sh, sl);
#pragma unroll
    for (int m = 0; m < DT; ++m) {
      uint32_t bh[2], bl[2];
      frag_b_perm(dos, ld, h0 + 8 * n, 8 * m, bh, bl);
      fb_mma3(dv[m], ph, pl, bh, bl);
      frag_b_perm(qs, ld, h0 + 8 * n, 8 * m, bh, bl);
      fb_mma3(dk[m], sh, sl, bh, bl);
    }
  }
}

template <int DT, typename T>
__global__ void __launch_bounds__(FD_THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                     const T* __restrict__ V, const T* __restrict__ dO,
                     const float* __restrict__ LSE, const float* __restrict__ DELTA,
                     const int* __restrict__ seeds, const float* __restrict__ rates,
                     T* __restrict__ dK, T* __restrict__ dV, int BH, FlashDims d) {
  extern __shared__ float4 fd_smem4[];
  float* smem = reinterpret_cast<float*>(fd_smem4);
  const int ld = d.ld, stage = 2 * FK_TILE * ld + 2 * FK_TILE;
  float* ks = smem;                       // [64][ld] keys, then v [64][ld]
  float* vs = ks + FK_TILE * ld;
  float* ring = vs + FK_TILE * ld;
  const int kt = blockIdx.x / BH, bh = blockIdx.x % BH;   // key tile 0, the heaviest, first
  const int k0 = kt * FK_TILE, nkeys = min(FK_TILE, d.Tk - k0);
  const int w0 = 16 * (threadIdx.x / 32), c0 = k0 + w0;   // the warp's first key
  const long long qo = (long long)bh * d.Tq * d.D, ko = ((long long)bh * d.Tk + k0) * d.D;
  const float* lse = LSE + (long long)bh * d.Tq;
  const float* delta = DELTA + (long long)bh * d.Tq;
  const uint32_t seed = d.use_dropout ? (uint32_t)seeds[bh] : 0u;
  const float rate = d.use_dropout ? rates[bh] : 0.f;
  const float keep_scale = d.use_dropout ? 1.0f / (1.0f - rate) : 1.f;
  // the first query row that sees key k0 is k0 - offset + 1
  const int q_first = d.causal ? max(0, k0 - d.offset + 1) / FK_TILE : 0;
  const int ntiles = max(0, (d.Tq + FK_TILE - 1) / FK_TILE - q_first);

  stage_rows4(ks, K + ko, nkeys, FK_TILE, d.D, 8 * DT, ld);   // join query tile 0's group
  stage_rows4(vs, V + ko, nkeys, FK_TILE, d.D, 8 * DT, ld);
  for (int s = 0; s < FK_STAGES - 1; ++s) {
    if (s < ntiles) dkv_stage_q(ring + s * stage, Q + qo, dO + qo, lse, delta,
                                (q_first + s) * FK_TILE, d);
    cp_async_commit();
  }
  float dk[DT][4], dv[DT][4], dk_sum[DKV_PROMOTE ? DT : 1][4], dv_sum[DKV_PROMOTE ? DT : 1][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  if constexpr (DKV_PROMOTE > 0) {
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_sum[n][e] = dv_sum[n][e] = 0.f;
  }
  // the warp's k (which 0) and v (1) fragments, split as they are read: held
  // in registers for the whole walk instead, they cost the kernel a block an
  // SM and ran 10-25% slower (tools/k5_trials.py)
  const auto akv = [&](int kk, int which, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    fb_frag_a(which ? vs : ks, ld, 1, w0, 8 * kk, hi, lo);
  };

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<FK_STAGES - 2>();
    __syncthreads();   // query tile it landed; the stage refilled below was read last iteration
    const int next = it + FK_STAGES - 1;
    if (next < ntiles) dkv_stage_q(ring + (next % FK_STAGES) * stage, Q + qo, dO + qo, lse,
                                   delta, (q_first + next) * FK_TILE, d);
    cp_async_commit();
    // every warp computes: keys past Tk read zeros and store nothing
    const float* qs = ring + (it % FK_STAGES) * stage;
    const float* dos = qs + FK_TILE * ld;
    const float* ls = dos + FK_TILE * ld;
    const int q0 = (q_first + it) * FK_TILE;
#pragma unroll 1
    for (int h0 = 0; h0 < FK_TILE; h0 += 32) {   // 32 queries at a time
      const int qa = q0 + h0;
      if (qa >= d.Tq) break;
      if (d.causal && c0 - (qa + 31) >= d.offset) continue;   // sees none of the warp's keys
      if (qa + 32 <= d.Tq && c0 + 16 <= d.Tk && (!d.causal || c0 + 15 - qa < d.offset))
        dkv_half<DT, true>(akv, qs, dos, ls, h0, q0, c0, d, dk, dv, seed, rate, keep_scale);
      else
        dkv_half<DT, false>(akv, qs, dos, ls, h0, q0, c0, d, dk, dv, seed, rate, keep_scale);
    }
    if constexpr (DKV_PROMOTE > 0) {
      if ((it + 1) % max(DKV_PROMOTE, 1) == 0 || it + 1 == ntiles) {
#pragma unroll
        for (int n = 0; n < DT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dk_sum[n][e] += dk[n][e];
            dv_sum[n][e] += dv[n][e];
            dk[n][e] = dv[n][e] = 0.f;
          }
      }
    }
  }
  if constexpr (DKV_PROMOTE > 0) {
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk[n][e] = dk_sum[n][e];
        dv[n][e] = dv_sum[n][e];
      }
  }
  // the warp's own key rows of ks / vs take its dK / dV (no other warp reads
  // them); every copy into ks / vs has landed first, also where the causal
  // rule hides the block's keys from every query and the walk never ran
  cp_async_wait<0>();
  __syncthreads();
  put_rows<DT>(ks, ld, w0, dk);
  put_rows<DT>(vs, ld, w0, dv);
  __syncthreads();
  store_rows(dK + ko, ks, nkeys, d.D, ld);
  store_rows(dV + ko, vs, nkeys, d.D, ld);
}

// K5dq: dQ of a (slice, bq query rows) block, bq / 16 warps of 16 rows,
// over the 64-key tiles its rows see, as K5f path 1 walks them.  The k and
// v tiles go through a ring of d.stages stages (DQ_STAGES, fewer where Tk
// has fewer tiles).  The launch bound holds 3 blocks an SM where D <= 32
// (170 registers); 2 blocks of 256 threads (128 registers) spilled and ran
// 3-17% slower.  dQ sums over up to Tk keys in the tensor cores'
// truncating accumulators; DQ_PROMOTE > 0 adds them into float32 sums
// every DQ_PROMOTE key tiles (0: never; PERF.md, tools/k5_trials.py).
constexpr int DQ_STAGES = 2;
constexpr int DQ_PROMOTE = 0;
// 8-key tiles a run of dq_key_tile: an interior tile in one run, an edge
// tile in runs of 4 (the MOSEI cross shape's 32 keys are one) where D <=
// 32; wider, two run shapes in one kernel spill, so edges take 8 too
constexpr int DQ_NK_FULL = 8, DQ_NK_EDGE = 4;

// Rows m0 .. m0+15 of a staged [bq][ld] tile split in place into TF32 hi,
// their lo parts into the same rows of the plane bq rows below: one warp,
// lanes over the 8 dt columns.
__device__ __forceinline__ void split_rows16(float* p, int bq, int m0, int ld, int cols) {
  uint32_t* hp = reinterpret_cast<uint32_t*>(p) + m0 * ld;
  uint32_t* lp = hp + bq * ld;
  for (int r = 0; r < 16; ++r)
    for (int c = threadIdx.x % 32; c < cols; c += 32) {
      uint32_t h, l;
      split_tf32(p[(m0 + r) * ld + c], h, l);
      hp[r * ld + c] = h;
      lp[r * ld + c] = l;
    }
}

// One 64-key tile of K5dq for one warp, in runs of NK 8-key tiles (the
// scores of a run stay in registers): S = Q K^T and dP' = dO V^T (A
// fragments from aq / ao), then p = exp(s - lse), M and dS = p (M dP' -
// delta), no branch a pair, then dq + dqc += dS K.  FULL: every pair of
// the tile visible; else each pair is tested, and the runs stop after the
// first nk 8-key tiles (a run is multiplied whole, its tiles past nk
// masked: a loop bound fixed at compile time).
template <int DT, bool FULL, typename QFrag, typename OFrag>
__device__ __forceinline__ void dq_key_tile(QFrag aq, OFrag ao, const float* ks,
                                            const float* vs, int nk, int row0, int k0,
                                            const FlashDims& d, float lse_a, float lse_b,
                                            float del_a, float del_b, float (&dq)[DT][4],
                                            float (&dqc)[DT][4], uint32_t seed, float rate,
                                            float keep_scale) {
  constexpr int NK = FULL || DT >= 8 ? DQ_NK_FULL : DQ_NK_EDGE;
  const int g = (threadIdx.x % 32) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 8; h += NK) {
    if (!FULL && h >= nk) break;
    const float* kh = ks + 8 * h * d.ld;
    float s[8][4], dp[8][4];
    score_tile<DT, NK>(s, aq, kh, d.ld, NK);
    score_tile<DT, NK>(dp, ao, vs + 8 * h * d.ld, d.ld, NK);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + g + (e < 2 ? 0 : 8), col = k0 + 8 * (h + j) + 2 * t + (e & 1);
        float p = __expf(s[j][e] - (e < 2 ? lse_a : lse_b));
        if constexpr (!FULL) {
          const bool ok = col < d.Tk && (!d.causal || col - row < d.offset);
          p = ok ? p : 0.f;
        }
        float mk = 1.f;
        if (d.use_dropout) mk = hash_uniform(seed, row, col) >= rate ? keep_scale : 0.f;
        s[j][e] = p * (dp[j][e] * mk - (e < 2 ? del_a : del_b));
      }
    value_product<DT, NK>(dq, dqc, s, kh, d.ld, NK);
  }
}

template <int DT, typename T>
__global__ void __launch_bounds__(128, DT <= 4 ? 3 : 1)
flash_bwd_dq_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                    const T* __restrict__ V, const T* __restrict__ dO,
                    const float* __restrict__ LSE, const float* __restrict__ DELTA,
                    const int* __restrict__ seeds, const float* __restrict__ rates,
                    T* __restrict__ dQ, int BH, FlashDims d) {
  extern __shared__ float4 fq_smem4[];
  float* smem = reinterpret_cast<float*>(fq_smem4);
  const int ld = d.ld, stage = 2 * FK_TILE * ld;
  float* qs = smem + d.stages * stage;   // q [bq][ld] and its lo plane, then dO's two
  float* dos = qs + 2 * d.bq * ld;
  const int nqt = (d.Tq + d.bq - 1) / d.bq;
  const int qt = nqt - 1 - (int)blockIdx.x / BH, bh = blockIdx.x % BH;   // heaviest first
  const int q0 = qt * d.bq, nq = min(d.bq, d.Tq - q0);
  const int g = (threadIdx.x % 32) >> 2;
  const int m0 = 16 * (threadIdx.x / 32), row0 = q0 + m0;
  const long long qo = ((long long)bh * d.Tq + q0) * d.D, ko = (long long)bh * d.Tk * d.D;
  const int k_end = d.causal ? min(d.Tk, q0 + nq - 1 + d.offset) : d.Tk;
  const int ntiles = (k_end + FK_TILE - 1) / FK_TILE;
  const uint32_t seed = d.use_dropout ? (uint32_t)seeds[bh] : 0u;
  const float rate = d.use_dropout ? rates[bh] : 0.f;
  const float keep_scale = d.use_dropout ? 1.0f / (1.0f - rate) : 1.f;
  // the lse and delta of the thread's rows, 0 past Tq (those rows' dS is 0)
  const long long ro = (long long)bh * d.Tq;
  const int ra = row0 + g, rb = ra + 8;
  const float lse_a = ra < d.Tq ? LSE[ro + ra] : 0.f, lse_b = rb < d.Tq ? LSE[ro + rb] : 0.f;
  const float del_a = ra < d.Tq ? DELTA[ro + ra] : 0.f;
  const float del_b = rb < d.Tq ? DELTA[ro + rb] : 0.f;

  stage_rows4(qs, Q + qo, nq, d.bq, d.D, 8 * DT, ld);   // q and dO join tile 0's group
  stage_rows4(dos, dO + qo, nq, d.bq, d.D, 8 * DT, ld);
  for (int s = 0; s < DQ_STAGES - 1; ++s) {
    if (s < ntiles) fwd_stage_kv(smem + s * stage, K + ko, V + ko, s * FK_TILE, d);
    cp_async_commit();
  }
  const uint32_t* qhp = reinterpret_cast<const uint32_t*>(qs);
  const uint32_t* ohp = reinterpret_cast<const uint32_t*>(dos);
  const auto aq = [&](int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) {
    frag_a_planes(qhp, qhp + d.bq * ld, ld, m0, 8 * kk, ah, al);
  };
  const auto ao = [&](int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) {
    frag_a_planes(ohp, ohp + d.bq * ld, ld, m0, 8 * kk, ah, al);
  };
  float dq[DT][4], dqc[DT][4], dq_sum[DQ_PROMOTE ? DT : 1][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = dqc[n][e] = 0.f;
  if constexpr (DQ_PROMOTE > 0) {
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq_sum[n][e] = 0.f;
  }

  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<DQ_STAGES - 2>();
    __syncthreads();   // tile kt landed; the stage refilled below was read last iteration
    const int next = kt + DQ_STAGES - 1;
    if (next < ntiles) fwd_stage_kv(smem + (next % d.stages) * stage, K + ko, V + ko,
                                    next * FK_TILE, d);
    cp_async_commit();
    if (kt == 0) {   // q and dO landed with tile 0: split the warp's rows once
      split_rows16(qs, d.bq, m0, ld, 8 * DT);
      split_rows16(dos, d.bq, m0, ld, 8 * DT);
      __syncwarp();
    }
    const int k0 = kt * FK_TILE;
    // a warp whose rows are all past Tq, or see none of the tile, skips it
    if (row0 >= d.Tq || (d.causal && k0 - (row0 + 15) >= d.offset)) continue;
    const float* ks = smem + (kt % d.stages) * stage;
    const float* vs = ks + FK_TILE * ld;
    // the interior of the block's key range: every pair of the 64 x 16 tile visible
    if (k0 + FK_TILE <= d.Tk && (!d.causal || k0 + FK_TILE - 1 - row0 < d.offset)) {
      dq_key_tile<DT, true>(aq, ao, ks, vs, 8, row0, k0, d, lse_a, lse_b, del_a, del_b, dq,
                            dqc, seed, rate, keep_scale);
    } else {
      int nk = min(8, (d.Tk - k0 + 7) / 8);
      if (d.causal) nk = min(nk, (row0 + 15 + d.offset - k0 + 7) / 8);
      dq_key_tile<DT, false>(aq, ao, ks, vs, nk, row0, k0, d, lse_a, lse_b, del_a, del_b, dq,
                             dqc, seed, rate, keep_scale);
    }
    if constexpr (DQ_PROMOTE > 0) {
      if ((kt + 1) % max(DQ_PROMOTE, 1) == 0) {
#pragma unroll
        for (int n = 0; n < DT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dq_sum[n][e] += dq[n][e] + dqc[n][e];
            dq[n][e] = dqc[n][e] = 0.f;
          }
      }
    }
  }
  cp_async_wait<0>();   // no copy still landing when the block exits
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dq[n][e] += dqc[n][e];
      if constexpr (DQ_PROMOTE > 0) dq[n][e] += dq_sum[n][e];
    }
  store_out<DT>(dQ + (long long)bh * d.Tq * d.D, row0, d, dq, 1.f, 1.f);
}

// K5f's, K5dkv's and K5dq's launches.  Each kernel's dynamic shared-memory cap is
// raised once per process (allow_smem_once); the plan's carve-up is checked
// against the card by the launch itself.  T, the storage type (float or
// bf16), is deduced from the pointers.
template <int DT, int NKT, typename T>
cudaError_t launch_fwd_unit_nk(const T* q, const T* k, const T* v, const int* seeds,
                               const float* rates, T* out, float* lse, int BH,
                               const FlashDims& d, int blocks, int smem, cudaStream_t stream) {
  static unsigned long long set = 0;
  const cudaError_t err =
      allow_smem_once((const void*)flash_fwd_unit_kernel<DT, NKT, T>, &set);
  if (err != cudaSuccess) return err;
  flash_fwd_unit_kernel<DT, NKT, T><<<blocks, FU_THREADS, smem, stream>>>(
      q, k, v, seeds, rates, out, lse, BH, d);
  return cudaGetLastError();
}

// path 0's key tiles: NKT = kp / 8, 4 (Tk <= 32) or 8
template <int DT, typename T>
cudaError_t launch_fwd_unit(const T* q, const T* k, const T* v, const int* seeds,
                            const float* rates, T* out, float* lse, int BH, const FlashDims& d,
                            int blocks, int smem, cudaStream_t stream) {
  if (d.kp == 32)
    return launch_fwd_unit_nk<DT, 4>(q, k, v, seeds, rates, out, lse, BH, d, blocks, smem,
                                     stream);
  return launch_fwd_unit_nk<DT, 8>(q, k, v, seeds, rates, out, lse, BH, d, blocks, smem,
                                   stream);
}

template <int DT, typename T>
cudaError_t launch_fwd_tiled(const T* q, const T* k, const T* v, const int* seeds,
                             const float* rates, T* out, float* lse, int BH, const FlashDims& d,
                             int blocks, int smem, cudaStream_t stream) {
  static unsigned long long set = 0;
  const cudaError_t err = allow_smem_once((const void*)flash_fwd_tiled_kernel<DT, T>, &set);
  if (err != cudaSuccess) return err;
  flash_fwd_tiled_kernel<DT, T><<<blocks, 2 * d.bq, smem, stream>>>(q, k, v, seeds, rates, out,
                                                                     lse, BH, d);
  return cudaGetLastError();
}

template <int DT, typename T>
cudaError_t launch_dkv_tc(const T* q, const T* k, const T* v, const T* dout, const float* lse,
                          const float* delta, const int* seeds, const float* rates, T* dk, T* dv,
                          int BH, const FlashDims& d, int blocks, int smem,
                          cudaStream_t stream) {
  static unsigned long long set = 0;
  const cudaError_t err = allow_smem_once((const void*)flash_bwd_dkv_kernel<DT, T>, &set);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<DT, T><<<blocks, FD_THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, seeds, rates, dk, dv, BH, d);
  return cudaGetLastError();
}

template <int DT, typename T>
cudaError_t launch_dq_tc(const T* q, const T* k, const T* v, const T* dout, const float* lse,
                         const float* delta, const int* seeds, const float* rates, T* dq,
                         int BH, const FlashDims& d, int blocks, int smem,
                         cudaStream_t stream) {
  static unsigned long long set = 0;
  const cudaError_t err = allow_smem_once((const void*)flash_bwd_dq_kernel<DT, T>, &set);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<DT, T><<<blocks, 2 * d.bq, smem, stream>>>(q, k, v, dout, lse, delta,
                                                                  seeds, rates, dq, BH, d);
  return cudaGetLastError();
}

// The kernels' instances: DT = d.dt, the 8-column tiles over D, rounded up
// by the plan to 1, 2, 4, 8 or 16 (the staged columns past D are zero), so
// D <= 128.
#define FLASH_DT(FN, ...)                         \
  switch (d.dt) {                                 \
    case 1: return FN<1>(__VA_ARGS__);            \
    case 2: return FN<2>(__VA_ARGS__);            \
    case 4: return FN<4>(__VA_ARGS__);            \
    case 8: return FN<8>(__VA_ARGS__);            \
    default: return FN<16>(__VA_ARGS__);          \
  }

// The padding every plan shares: dt, the least power of two of 8-column
// tiles that covers D (D <= 128), and rows of ld >= 8 dt floats, 4 mod 8.
bool widths_ok(const FlashDims& d) {
  return d.D >= 1 && d.D <= 128 && (d.dt & (d.dt - 1)) == 0 && 8 * d.dt >= d.D &&
         (d.dt == 1 || 4 * d.dt < d.D) && d.ld >= 8 * d.dt && d.ld % 8 == 4;
}

// K5f from its plan, host ints: path (0: unit, 1: tiled), blocks, threads,
// smem bytes, dt, ld, qp, kp (path 0), bq (path 1).
template <typename T>
cudaError_t launch_fwd(const T* q, const T* k, const T* v, const int* seeds, const float* rates,
                       T* out, float* lse, int BH, int Tq, int Tk, int D, int causal,
                       int offset, int use_dropout, const int* plan, cudaStream_t stream) {
  const int path = plan[0], blocks = plan[1], threads = plan[2], smem = plan[3];
  FlashDims d{Tq, Tk, D, causal, offset, use_dropout, plan[4], plan[5], plan[6], plan[7], 0,
              plan[8]};
  d.slot = d.ld * (d.qp + 2 * d.kp) + 4;
  if (!widths_ok(d) || blocks < 1 || BH < 1 || Tq < 1 || Tk < 1) return cudaErrorInvalidValue;
  if (path == 0) {
    if (Tq > 64 || Tk > 64 || threads != FU_THREADS || d.qp != 16 * (FU_THREADS / 32) ||
        d.kp != (Tk <= 32 ? 32 : 64) || smem < 8 * d.slot)
      return cudaErrorInvalidValue;
    FLASH_DT(launch_fwd_unit, q, k, v, seeds, rates, out, lse, BH, d, blocks, smem, stream)
  }
  if (path != 1 || (d.bq != 64 && d.bq != 128) || threads != 2 * d.bq ||
      blocks != (Tq + d.bq - 1) / d.bq * BH ||
      smem < 4 * (FK_STAGES * 2 * FK_TILE + 2 * d.bq) * d.ld)
    return cudaErrorInvalidValue;
  FLASH_DT(launch_fwd_tiled, q, k, v, seeds, rates, out, lse, BH, d, blocks, smem, stream)
}

// K5dkv from its plan, host ints: blocks, threads, smem bytes, dt, ld.
template <typename T>
cudaError_t launch_dkv(const T* q, const T* k, const T* v, const T* dout, const float* lse,
                       const float* delta, const int* seeds, const float* rates, T* dk, T* dv,
                       int BH, int Tq, int Tk, int D, int causal, int offset, int use_dropout,
                       const int* plan, cudaStream_t stream) {
  const int blocks = plan[0], threads = plan[1], smem = plan[2];
  FlashDims d{Tq, Tk, D, causal, offset, use_dropout, plan[3], plan[4], 0, 0, 0, 0};
  if (!widths_ok(d) || BH < 1 || Tq < 1 || Tk < 1 || threads != FD_THREADS ||
      blocks != (Tk + FK_TILE - 1) / FK_TILE * BH ||
      smem < 4 * (2 * FK_TILE * d.ld + FK_STAGES * (2 * FK_TILE * d.ld + 2 * FK_TILE)))
    return cudaErrorInvalidValue;
  FLASH_DT(launch_dkv_tc, q, k, v, dout, lse, delta, seeds, rates, dk, dv, BH, d, blocks, smem,
           stream)
}

// K5dq from its plan, host ints: blocks, threads, smem bytes, dt, ld, bq,
// stages.
template <typename T>
cudaError_t launch_dq(const T* q, const T* k, const T* v, const T* dout, const float* lse,
                      const float* delta, const int* seeds, const float* rates, T* dq, int BH,
                      int Tq, int Tk, int D, int causal, int offset, int use_dropout,
                      const int* plan, cudaStream_t stream) {
  const int blocks = plan[0], threads = plan[1], smem = plan[2];
  FlashDims d{Tq, Tk, D, causal, offset, use_dropout, plan[3], plan[4], 0, 0, 0, plan[5],
              plan[6]};
  if (!widths_ok(d) || BH < 1 || Tq < 1 || Tk < 1 ||
      (d.bq != 16 && d.bq != 32 && d.bq != 64) || threads != 2 * d.bq ||
      blocks != (Tq + d.bq - 1) / d.bq * BH ||
      d.stages != min(DQ_STAGES, (Tk + FK_TILE - 1) / FK_TILE) ||
      smem < 4 * d.ld * (d.stages * 2 * FK_TILE + 4 * d.bq))
    return cudaErrorInvalidValue;
  FLASH_DT(launch_dq_tc, q, k, v, dout, lse, delta, seeds, rates, dq, BH, d, blocks, smem, stream)
}

}  // namespace

// The entries: the float32 instances here, the bf16 ones (q, k, v, dout,
// out and the gradients bf16; lse and delta float32 in both) where
// flash_attn_bf16.cu includes this file with FLASH_ATTN_BF16 defined, so
// that nvcc builds the two sets of instances as two translation units side
// by side.  Each returns the launch's cudaError_t.
#ifndef FLASH_ATTN_BF16

// K5f: out [B*H, Tq, D] and lse [B*H, Tq]; plan as launch_fwd's.
extern "C" int mmtr_flash_fwd(const float* q, const float* k, const float* v,
                              const int* seeds, const float* rates, float* out, float* lse,
                              int BH, int Tq, int Tk, int D, int causal, int offset,
                              int use_dropout, const int* plan, void* stream_ptr) {
  return (int)launch_fwd(q, k, v, seeds, rates, out, lse, BH, Tq, Tk, D, causal, offset,
                         use_dropout, plan, (cudaStream_t)stream_ptr);
}

// K5dq: dq [B*H, Tq, D] from q, k, v, dout, lse and delta; plan as
// launch_dq's.
extern "C" int mmtr_flash_bwd_dq(const float* q, const float* k, const float* v,
                                 const float* dout, const float* lse, const float* delta,
                                 const int* seeds, const float* rates, float* dq, int BH,
                                 int Tq, int Tk, int D, int causal, int offset,
                                 int use_dropout, const int* plan, void* stream_ptr) {
  return (int)launch_dq(q, k, v, dout, lse, delta, seeds, rates, dq, BH, Tq, Tk, D, causal,
                        offset, use_dropout, plan, (cudaStream_t)stream_ptr);
}

// K5dkv: dk and dv [B*H, Tk, D]; plan as launch_dkv's.
extern "C" int mmtr_flash_bwd_dkv(const float* q, const float* k, const float* v,
                                  const float* dout, const float* lse, const float* delta,
                                  const int* seeds, const float* rates, float* dk, float* dv,
                                  int BH, int Tq, int Tk, int D, int causal, int offset,
                                  int use_dropout, const int* plan, void* stream_ptr) {
  return (int)launch_dkv(q, k, v, dout, lse, delta, seeds, rates, dk, dv, BH, Tq, Tk, D,
                         causal, offset, use_dropout, plan, (cudaStream_t)stream_ptr);
}

// K5b: dq, dk and dv in one launch from q, k, v, dout, out and lse (delta
// computed inside), Tq, Tk <= 64; plan as launch_fused_bwd's.
extern "C" int mmtr_flash_bwd(const float* q, const float* k, const float* v,
                              const float* dout, const float* out, const float* lse,
                              const int* seeds, const float* rates, float* dq, float* dk,
                              float* dv, int BH, int Tq, int Tk, int D, int causal,
                              int offset, int use_dropout, const int* plan,
                              void* stream_ptr) {
  return (int)launch_fused_bwd(q, k, v, dout, out, lse, seeds, rates, dq, dk, dv, BH, Tq, Tk,
                               D, causal, offset, use_dropout, plan,
                               (cudaStream_t)stream_ptr);
}

#else
// The bf16 instances of the four entries above, by the same plans.
extern "C" int mmtr_flash_fwd_bf16(const bf16* q, const bf16* k, const bf16* v,
                                   const int* seeds, const float* rates, bf16* out, float* lse,
                                   int BH, int Tq, int Tk, int D, int causal, int offset,
                                   int use_dropout, const int* plan, void* stream_ptr) {
  return (int)launch_fwd(q, k, v, seeds, rates, out, lse, BH, Tq, Tk, D, causal, offset,
                         use_dropout, plan, (cudaStream_t)stream_ptr);
}

extern "C" int mmtr_flash_bwd_dq_bf16(const bf16* q, const bf16* k, const bf16* v,
                                      const bf16* dout, const float* lse, const float* delta,
                                      const int* seeds, const float* rates, bf16* dq, int BH,
                                      int Tq, int Tk, int D, int causal, int offset,
                                      int use_dropout, const int* plan, void* stream_ptr) {
  return (int)launch_dq(q, k, v, dout, lse, delta, seeds, rates, dq, BH, Tq, Tk, D, causal,
                        offset, use_dropout, plan, (cudaStream_t)stream_ptr);
}

extern "C" int mmtr_flash_bwd_dkv_bf16(const bf16* q, const bf16* k, const bf16* v,
                                       const bf16* dout, const float* lse, const float* delta,
                                       const int* seeds, const float* rates, bf16* dk,
                                       bf16* dv, int BH, int Tq, int Tk, int D, int causal,
                                       int offset, int use_dropout, const int* plan,
                                       void* stream_ptr) {
  return (int)launch_dkv(q, k, v, dout, lse, delta, seeds, rates, dk, dv, BH, Tq, Tk, D,
                         causal, offset, use_dropout, plan, (cudaStream_t)stream_ptr);
}

extern "C" int mmtr_flash_bwd_bf16(const bf16* q, const bf16* k, const bf16* v,
                                   const bf16* dout, const bf16* out, const float* lse,
                                   const int* seeds, const float* rates, bf16* dq, bf16* dk,
                                   bf16* dv, int BH, int Tq, int Tk, int D, int causal,
                                   int offset, int use_dropout, const int* plan,
                                   void* stream_ptr) {
  return (int)launch_fused_bwd(q, k, v, dout, out, lse, seeds, rates, dq, dk, dv, BH, Tq, Tk,
                               D, causal, offset, use_dropout, plan,
                               (cudaStream_t)stream_ptr);
}
#endif  // FLASH_ATTN_BF16
