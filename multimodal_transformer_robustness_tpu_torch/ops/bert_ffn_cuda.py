"""The frozen-BERT layer epilogues through hand-written CUDA kernels.

Counterpart of ``multimodal_transformer_robustness_tpu/ops/bert_ffn_pallas.py``
(forward only, BERT is frozen).  Each wrapper launches its kernel on a CUDA
tensor and runs its plain PyTorch version on a CPU tensor:

  * :func:`ffn_ln_block` (K3, ``csrc/bert_ffn.cu``): ``LN(x + fc2(gelu(fc1
    x)))``, replaces ``bert_ffn_pallas._ffn_ln_kernel``;
  * :func:`proj_ln_block` (K6b, ``csrc/bert_ffn.cu``): ``LN(resid + a @ w_t +
    b)``, the attention epilogue of the unfused attention paths, replaces
    ``bert_ffn_pallas._proj_ln_kernel``; K2's tail, the same host function
    by the same plan, :func:`_plan_proj_ln`;
  * :func:`ffn_ln_block_q` (K4, ``csrc/bert_ffn_q.cu``): K3 with int8 weights
    and dynamic per-row int8 activations (``--bert_int8``), replaces
    ``bert_ffn_pallas._ffn_ln_kernel_q``; its products run on a persistent
    int8 wgmma kernel where the rows fill the card, by the plan
    :func:`_plan_ffn_q`;
  * :func:`qrows` and :func:`qdot`, the row quantization and the int8 GEMM
    with its dequant + bias epilogue from K4's source: the int8 q/k/v/o
    projections of a fully quantized BERT (the JAX package's
    ``models/bert._qrows`` / ``_qdot``, an XLA int8 dot there);
    :func:`int8_matmul` exposes the raw int32 product to check it exact;
    each product takes :func:`_plan_qgemm`'s tiles.

K3's two products and K6b's run on ``csrc/gemm_tc.cuh``'s 3xTF32 tensor-core
GEMM by the plans :func:`_plan_ffn` and :func:`_plan_proj_ln` compute on the
host.  K3 has a bf16 instance (``mmtr_ffn_ln_fwd_bf16``, its products on
the bf16 tensor cores of ``csrc/gemm_bf16.cuh`` by :func:`_plan_ffn_bf16`):
bf16 ``x`` and weights take it, or its plain version on the CPU, at the
JAX kernel's rounding points (fc1 + b1, the gelu, fc2 + b2 and the
residual sum each rounded to bf16; LN moments in float32).  K6b has one
(``mmtr_proj_ln_fwd_bf16``): K2's bf16 tail alone, by
:func:`_plan_proj_ln_bf16`.  K4 and the int8 projections have bf16
instances on the same int8 products and plans (``mmtr_ffn_ln_q_fwd_bf16``,
``mmtr_qrows_bf16``, ``mmtr_qdot_bf16``): bf16 rows in and out, bf16 scales
and biases read as float32, the JAX kernel's rounding points (h1 and y
after their dequant + bias, g1 = gelu(h1), the residual sum, the LN), the
row scales float32.  Float weights come pre-transposed (``w_t = weight.T``, made once at
load time).  Quantized weights are ``{"q": int8 [out, in], "s": float32 [out]}``
dicts as ``models/bert.quantize_bert_params`` makes them, never transposed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

import functools

from .. import _build
from . import gemm_tc
from .layernorm import masked_layer_norm

# XLA's float32 erf rational approximation, as the JAX int8 kernel inlines it
# (bert_ffn_pallas._ERF_P / _ERF_Q): erf(x) = x * P(x^2) / Q(x^2) on [-4, 4]
_ERF_P = (0.00022905065861350646, 0.0034082910107109506,
          0.050955695062380861, 0.18520832239976145, 1.128379143519084)
_ERF_Q = (-1.1791602954361697e-7, 2.3547966471313185e-5,
          0.0010179625278914885, 0.014070470171167667,
          0.11098505178285362, 0.49746925110067538, 1.0)


def ffn_ln_block_plain(x, w1t, b1, w2t, b2, ln_g, ln_b, *, eps: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel; exact-erf gelu, float32 centered
    LayerNorm moments.  bf16 ``x``: the bf16 instance's, products of bf16
    values as float32 matmuls of the upcast operands, each bias added in
    float32 and then rounded, as JAX ``_ffn_ln_kernel`` at bf16; the
    residual sum ``x + y`` of bf16 values rounded to bf16, then the LN."""
    if x.dtype == torch.bfloat16:
        bf = torch.bfloat16
        h1 = (x.float() @ w1t.float() + b1.float()).to(bf)
        g1 = F.gelu(h1.float(), approximate="none").to(bf)
        y = (g1.float() @ w2t.float() + b2.float()).to(bf)
        return masked_layer_norm(x + y, ln_g, ln_b, eps=eps)
    h1 = F.gelu(torch.matmul(x, w1t) + b1, approximate="none")
    y = torch.matmul(h1, w2t) + b2
    return masked_layer_norm(x + y, ln_g, ln_b, eps=eps)


def _plan_ffn(rows: int, h: int, ffn: int, num_sms: int = _build.NUM_SMS,
              aligned: bool = True) -> dict:
    """K3's launch plan (``csrc/bert_ffn.cu`` takes it as given): for fc1
    (``[rows, h] x [h, ffn]``) and fc2 (``[rows, ffn] x [ffn, h]``) each,
    :func:`gemm_tc.plan_product`: the wgmma tiles (128 x 128 at BERT-base
    width) where they give every SM at least two blocks, else the 64 x 64
    mma.sync tiles split over K into up to 32 ranges (fc2 at 8 rows: 20
    ranges of 5 of its 96 k tiles, 240 blocks); both promote their tensor-core
    sums (``csrc/bert_ffn.cu``'s K3_PROMOTE), so their wgmma tiles are 104 or
    128 wide (:data:`gemm_tc.PROMOTED_WIDTHS`); 4-byte copies where ``h``
    or ``ffn`` is not a multiple of 4 or an operand is not ``aligned``.
    ``fused_ln``: fc2 split on the mma.sync tiles, its planes added by the
    LayerNorm's launch.  ``scratch``: the floats the larger of the two
    needs (they run one after the other)."""
    vec = aligned and h % 4 == 0 and ffn % 4 == 0
    fc1, fc2 = (gemm_tc.plan_product(m, n, k, vec, num_sms, max_splits=32,
                                     widths=gemm_tc.PROMOTED_WIDTHS)
                for m, n, k in ((rows, ffn, h), (rows, h, ffn)))
    return {"fc1": fc1, "fc2": fc2, "fused_ln": int(not fc2["wgmma"] and fc2["splits"] > 1),
            "scratch": max(fc1["scratch"], fc2["scratch"])}


@functools.lru_cache(maxsize=None)
def _cached_ffn_plan(rows, h, ffn, num_sms, aligned):
    """The plan as csrc/bert_ffn.cu reads it: (C int array, its address,
    the floats of scratch, whether fc2's sum is fused into the LN)."""
    p = _plan_ffn(rows, h, ffn, num_sms, aligned)
    ints = _build.host_ints([p[fc][k] for fc in ("fc1", "fc2") for k in gemm_tc.PLAN_KEYS])
    return ints + (p["scratch"], p["fused_ln"])


def _plan_ffn_bf16(rows: int, h: int, ffn: int, num_sms: int = _build.NUM_SMS,
                   x_addr: int = 0, w1_addr: int = 0, w2_addr: int = 0) -> dict:
    """K3's bf16 plan: :func:`gemm_tc.plan_bf16` for fc1 (``[rows, h] x
    [h, ffn]``) and fc2 (``[rows, ffn] x [ffn, h]``, A the fresh bf16
    hidden, x the residual, read in 16-byte pieces by the persistent
    kernel's epilogue), both on the persistent kernel where the rows fill
    the card; ``partial``: the larger of their needs."""
    x_cw = gemm_tc.bf16_copy_width((h,), (x_addr,))
    fc1 = gemm_tc.plan_bf16(rows, ffn, h, x_cw, gemm_tc.bf16_copy_width((ffn,), (w1_addr,)),
                            num_sms, persistent=True)
    fc2 = gemm_tc.plan_bf16(rows, h, ffn, gemm_tc.bf16_copy_width((ffn,)),
                            gemm_tc.bf16_copy_width((h,), (w2_addr,)), num_sms,
                            persistent=x_cw == 8)
    return {"fc1": fc1, "fc2": fc2, "partial": max(fc1["partial"], fc2["partial"])}


@functools.lru_cache(maxsize=None)
def _cached_ffn_plan_bf16(rows, h, ffn, num_sms, x_addr, w1_addr, w2_addr):
    """The plan as csrc/bert_ffn.cu reads it: (C int array, its address,
    the floats of partial): fc1's and fc2's five BfPlan ints, then their
    persistent grids (0 off the persistent kernel)."""
    p = _plan_ffn_bf16(rows, h, ffn, num_sms, x_addr, w1_addr, w2_addr)
    ints = [p[fc][k] for fc in ("fc1", "fc2") for k in gemm_tc.BF_PLAN_KEYS]
    ints += [p[fc].get("grid", 0) for fc in ("fc1", "fc2")]
    return _build.host_ints(ints) + (p["partial"],)


def _ffn_ln_block_bf16(x, w1t, b1, w2t, b2, ln_g, ln_b, eps: float) -> torch.Tensor:
    dev = x.device
    h = x.shape[-1]
    ffn = w1t.shape[-1]
    rows = x.numel() // h
    _build.require_all(dev, ((x, "x", x.shape), (w1t, "w1t", (h, ffn)), (b1, "b1", (ffn,)),
                             (w2t, "w2t", (ffn, h)), (b2, "b2", (h,)), (ln_g, "ln_g", (h,)),
                             (ln_b, "ln_b", (h,))), torch.bfloat16)
    plan = _cached_ffn_plan_bf16(rows, h, ffn, _build.num_sms(dev), x.data_ptr() % 16,
                                 w1t.data_ptr() % 16, w2t.data_ptr() % 16)
    bf = dict(dtype=torch.bfloat16, device=dev)
    hidden = torch.empty(rows, ffn, **bf)
    resid_sum = torch.empty(rows, h, **bf)
    partial = torch.empty(plan[2], dtype=torch.float32, device=dev) if plan[2] else None
    out = torch.empty_like(x)
    err = _build.load_library().mmtr_ffn_ln_fwd_bf16(
        x.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(), b2.data_ptr(),
        ln_g.data_ptr(), ln_b.data_ptr(), hidden.data_ptr(), resid_sum.data_ptr(),
        out.data_ptr(), partial.data_ptr() if partial is not None else 0, rows, h, ffn, eps,
        plan[1], _build.stream_ptr(dev))
    _build.check(err, "ffn_ln_block kernel (bf16)")
    ffn_ln_block.launches_bf16 += 1
    return out


def ffn_ln_block(x: torch.Tensor, w1t: torch.Tensor, b1: torch.Tensor,
                 w2t: torch.Tensor, b2: torch.Tensor, ln_g: torch.Tensor,
                 ln_b: torch.Tensor, *, eps: float) -> torch.Tensor:
    """``LN(x + (gelu(x @ w1t + b1) @ w2t + b2))`` for ``x [..., h]``,
    ``w1t [h, F]``, ``w2t [F, h]``.  W1^T's and W2^T's TF32 planes are made
    per call (the wgmma path's ``scratch``), so the signature and the plain
    version stay the frozen weights'."""
    if x.device.type == "cpu":
        return ffn_ln_block_plain(x, w1t, b1, w2t, b2, ln_g, ln_b, eps=eps)
    dev = _build.device_of(x)
    if x.dtype == torch.bfloat16:
        out = _ffn_ln_block_bf16(x, w1t, b1, w2t, b2, ln_g, ln_b, eps)
        ffn_ln_block.launches += 1
        return out
    h = x.shape[-1]
    ffn = w1t.shape[-1]
    rows = x.numel() // h
    _build.require_all(dev, ((x, "x", x.shape), (w1t, "w1t", (h, ffn)), (b1, "b1", (ffn,)),
                             (w2t, "w2t", (ffn, h)), (b2, "b2", (h,)), (ln_g, "ln_g", (h,)),
                             (ln_b, "ln_b", (h,))))
    plan = _cached_ffn_plan(rows, h, ffn, _build.num_sms(dev),
                            all(t.data_ptr() % 16 == 0 for t in (x, w1t, w2t)))
    f32 = dict(dtype=torch.float32, device=dev)
    hidden = torch.empty(rows, ffn, **f32)
    resid_sum = torch.empty(0 if plan[3] else rows * h, **f32)
    scratch = torch.empty(plan[2], **f32) if plan[2] else None
    out = torch.empty_like(x)
    err = _build.load_library().mmtr_ffn_ln_fwd(
        x.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(), b2.data_ptr(),
        ln_g.data_ptr(), ln_b.data_ptr(), hidden.data_ptr(), resid_sum.data_ptr(),
        out.data_ptr(), scratch.data_ptr() if scratch is not None else 0, rows, h, ffn, eps,
        plan[1], _build.stream_ptr(dev))
    _build.check(err, "ffn_ln_block kernel")
    ffn_ln_block.launches += 1
    return out


ffn_ln_block.launches = 0
ffn_ln_block.launches_bf16 = 0


# ------------------------------------------------------------------- K6b

def proj_ln_block_plain(resid, a, w_t, b, ln_g, ln_b, *, eps: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel.  bf16 operands: the bf16
    instance's (JAX ``_proj_ln_kernel`` at bf16): the product of bf16 values
    as a float32 matmul of the upcast operands, the bias added in float32,
    then rounded; the residual sum rounded to bf16, then the LN."""
    if resid.dtype == torch.bfloat16:
        y = (a.float() @ w_t.float() + b.float()).to(torch.bfloat16)
        return masked_layer_norm(resid + y, ln_g, ln_b, eps=eps)
    return masked_layer_norm(resid + (torch.matmul(a, w_t) + b), ln_g, ln_b, eps=eps)


def _plan_proj_ln(rows: int, h: int, num_sms: int = _build.NUM_SMS,
                  aligned: bool = True) -> dict:
    """K6b's launch plan, and K2's for its o-projection + LN
    (``bert_attn_cuda._plan_attn_block``'s ``"o"``): the ``[rows, h] x [h,
    h]`` product by :func:`gemm_tc.plan_product`, the wgmma tiles (128 x 128
    at BERT-base width) where they give every SM at least two blocks, else
    the 64 x 64 mma.sync tiles split over K (8 ranges at 8 rows); every wgmma
    width, since the sums stay unpromoted (``K2_PROMOTE`` / ``K6B_PROMOTE``
    0); 4-byte copies where ``h`` is not a multiple of 4 or an operand is not
    ``aligned``.  ``fused_ln``: split on the mma.sync tiles, the planes
    added by the LayerNorm's launch (``csrc/gemm_tc.cuh``
    ``launch_proj_resid_ln``).  ``scratch``: the floats it needs."""
    p = gemm_tc.plan_product(rows, h, h, aligned and h % 4 == 0, num_sms)
    return {**p, "fused_ln": int(not p["wgmma"] and p["splits"] > 1)}


@functools.lru_cache(maxsize=None)
def _cached_proj_ln_plan(rows, h, num_sms, aligned):
    """The plan as csrc/bert_ffn.cu reads it: (C int array, its address,
    the floats of scratch, whether the sum is fused into the LN)."""
    p = _plan_proj_ln(rows, h, num_sms, aligned)
    return _build.host_ints([p[k] for k in gemm_tc.PLAN_KEYS]) + (p["scratch"], p["fused_ln"])


def _plan_proj_ln_bf16(rows: int, h: int, num_sms: int = _build.NUM_SMS, a_addr: int = 0,
                       w_addr: int = 0, resid_addr: int = 0) -> dict:
    """K6b's bf16 plan, and K2.bf16's for its o-projection + LN
    (``bert_attn_cuda._plan_attn_block_bf16``'s ``"o"``, A there the fresh
    attention output and the residual K2's x): the ``[rows, h] x [h, h]``
    product by :func:`gemm_tc.plan_bf16`, copies as wide as ``h`` and the
    operands' addresses (residues mod 16) allow.  Where the rows fill the
    card it runs on the persistent kernel (``wgmma`` 2; its epilogue reads
    the residual in 16-byte pieces, so the residual must be 16-byte
    aligned), as K3.bf16's fc2, where K2.bf16's q/k/v product can too (h a
    multiple of :data:`gemm_tc.BP_BN` and :data:`gemm_tc.BP_BK`): K2.bf16
    moves as one block, and this stays its tail's plan.  The LayerNorm after
    it runs a warp a row on the persistent path, a block a row else."""
    cw = gemm_tc.bf16_copy_width((h,), (a_addr,))
    persistent = (gemm_tc.bf16_copy_width((h,), (resid_addr,)) == 8
                  and h % gemm_tc.BP_BN == 0 and h % gemm_tc.BP_BK == 0)
    return gemm_tc.plan_bf16(rows, h, h, cw, gemm_tc.bf16_copy_width((h,), (w_addr,)), num_sms,
                             persistent=persistent)


@functools.lru_cache(maxsize=None)
def _cached_proj_ln_plan_bf16(rows, h, num_sms, a_addr, w_addr, resid_addr):
    """K6b's bf16 plan as csrc/bert_ffn.cu reads it: (C int array, its
    address, the floats of ``partial``): the five BfPlan ints, then the
    persistent grid (0 off the persistent kernel)."""
    p = _plan_proj_ln_bf16(rows, h, num_sms, a_addr, w_addr, resid_addr)
    ints = [p[k] for k in gemm_tc.BF_PLAN_KEYS] + [p.get("grid", 0)]
    return _build.host_ints(ints) + (p["partial"],)


def _proj_ln_block_bf16(resid, a, w_t, b, ln_g, ln_b, eps: float) -> torch.Tensor:
    dev = resid.device
    h = resid.shape[-1]
    rows = resid.numel() // h
    _build.require_all(dev, ((resid, "resid", resid.shape), (a, "a", resid.shape),
                             (w_t, "w_t", (h, h)), (b, "b", (h,)), (ln_g, "ln_g", (h,)),
                             (ln_b, "ln_b", (h,))), torch.bfloat16)
    plan = _cached_proj_ln_plan_bf16(rows, h, _build.num_sms(dev), a.data_ptr() % 16,
                                     w_t.data_ptr() % 16, resid.data_ptr() % 16)
    resid_sum = torch.empty(rows, h, dtype=torch.bfloat16, device=dev)
    partial = torch.empty(plan[2], dtype=torch.float32, device=dev) if plan[2] else None
    out = torch.empty_like(resid)
    err = _build.load_library().mmtr_proj_ln_fwd_bf16(
        resid.data_ptr(), a.data_ptr(), w_t.data_ptr(), b.data_ptr(), ln_g.data_ptr(),
        ln_b.data_ptr(), resid_sum.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else 0, rows, h, eps, plan[1],
        _build.stream_ptr(dev))
    _build.check(err, "proj_ln_block kernel (bf16)")
    proj_ln_block.launches_bf16 += 1
    return out


def proj_ln_block(resid: torch.Tensor, a: torch.Tensor, w_t: torch.Tensor,
                  b: torch.Tensor, ln_g: torch.Tensor, ln_b: torch.Tensor, *,
                  eps: float) -> torch.Tensor:
    """``LN(resid + a @ w_t + b)``, HF BertSelfOutput: ``resid`` and ``a``
    ``[..., h]`` with the same leading dims, ``w_t [h, h]`` (= weight.T).
    W^T's TF32 planes are made per call (the wgmma path's ``scratch``), as
    K2's are.  bf16 operands take the bf16 instance."""
    if resid.device.type == "cpu":
        return proj_ln_block_plain(resid, a, w_t, b, ln_g, ln_b, eps=eps)
    dev = _build.device_of(resid)
    if resid.dtype == torch.bfloat16:
        out = _proj_ln_block_bf16(resid, a, w_t, b, ln_g, ln_b, eps)
        proj_ln_block.launches += 1
        return out
    h = resid.shape[-1]
    rows = resid.numel() // h
    _build.require_all(dev, ((resid, "resid", resid.shape), (a, "a", resid.shape),
                             (w_t, "w_t", (h, h)), (b, "b", (h,)), (ln_g, "ln_g", (h,)),
                             (ln_b, "ln_b", (h,))))
    plan = _cached_proj_ln_plan(rows, h, _build.num_sms(dev),
                                (a.data_ptr() | w_t.data_ptr()) % 16 == 0)
    f32 = dict(dtype=torch.float32, device=dev)
    resid_sum = torch.empty(0 if plan[3] else rows * h, **f32)
    scratch = torch.empty(plan[2], **f32) if plan[2] else None
    out = torch.empty_like(resid)
    err = _build.load_library().mmtr_proj_ln_fwd(
        resid.data_ptr(), a.data_ptr(), w_t.data_ptr(), b.data_ptr(), ln_g.data_ptr(),
        ln_b.data_ptr(), resid_sum.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if scratch is not None else 0, rows, h, eps, plan[1],
        _build.stream_ptr(dev))
    _build.check(err, "proj_ln_block kernel")
    proj_ln_block.launches += 1
    return out


proj_ln_block.launches = 0
proj_ln_block.launches_bf16 = 0


# ------------------------------------------------------------------ int8

# csrc/bert_ffn_q.cu's int8 tiles: the persistent wgmma kernel's (rows,
# columns, k bytes, ring stages; its shared memory: the ring, the staged
# int32 tile [128][136], + 1 KB to align the swizzle atoms; one block an SM)
# and the mma.sync tile (64 x 64, two 64 x 80-byte stages, static)
QW_BM, QW_BN, QW_BK, QW_STAGES = 128, 128, 128, 4
QW_SMEM = QW_STAGES * (QW_BM + QW_BN) * QW_BK + 4 * QW_BM * (QW_BN + 8) + 1024
QG_BM = QG_BN = 64
QG_SMEM = 2 * 64 * 80
QPLAN_KEYS = ("wgmma", "vec", "grid")


def _plan_qgemm(M: int, N: int, K: int, num_sms: int = _build.NUM_SMS,
                aligned: bool = True) -> dict:
    """One int8 ``[M, K] x [N, K]^T`` product (``csrc/bert_ffn_q.cu``): the
    persistent wgmma kernel over 128 x 128 tiles (``grid``: one block an SM,
    at most one a tile) where the tiles fill at least two waves of the card
    and the copies can be 16 bytes wide (``vec``: K a multiple of 16, both
    operands ``aligned``), else the 64 x 64 mma.sync tiles (``grid``: 0, the
    kernel's own).  ``tiles``: (column tiles, row tiles); ``smem``: a
    block's shared memory."""
    vec = int(aligned and K % 16 == 0)
    tiles = (-(-N // QW_BN), -(-M // QW_BM))
    wgmma = int(vec and tiles[0] * tiles[1] >= 2 * num_sms)
    if not wgmma:
        tiles = (-(-N // QG_BN), -(-M // QG_BM))
    return {"wgmma": wgmma, "vec": vec, "tiles": tiles,
            "grid": min(tiles[0] * tiles[1], num_sms) if wgmma else 0,
            "bn": QW_BN if wgmma else QG_BN, "stages": QW_STAGES if wgmma else 1,
            "smem": QW_SMEM if wgmma else QG_SMEM}


def _plan_ffn_q(rows: int, h: int, ffn: int, num_sms: int = _build.NUM_SMS,
                aligned: bool = True) -> dict:
    """K4's launch plan (``csrc/bert_ffn_q.cu`` takes it as given): GEMM1
    (``[rows, h] x [ffn, h]^T``) and GEMM2 (``[rows, ffn] x [h, ffn]^T``)
    each by :func:`_plan_qgemm`: at the training rows (131,072) both on the
    persistent wgmma kernel, at the serving rows (8-512) both on the
    mma.sync tiles."""
    return {"gemm1": _plan_qgemm(rows, ffn, h, num_sms, aligned),
            "gemm2": _plan_qgemm(rows, h, ffn, num_sms, aligned)}


@functools.lru_cache(maxsize=None)
def _cached_qgemm_plan(M, N, K, num_sms, aligned):
    """A product's plan as csrc/bert_ffn_q.cu reads it: (C int array, its
    address)."""
    p = _plan_qgemm(M, N, K, num_sms, aligned)
    return _build.host_ints([p[k] for k in QPLAN_KEYS])


@functools.lru_cache(maxsize=None)
def _cached_ffn_q_plan(rows, h, ffn, num_sms, aligned):
    """K4's plan as csrc/bert_ffn_q.cu reads it: (C int array, its address)."""
    p = _plan_ffn_q(rows, h, ffn, num_sms, aligned)
    return _build.host_ints([p[g][k] for g in ("gemm1", "gemm2") for k in QPLAN_KEYS])


def gelu_erf_poly(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf gelu through the JAX int8 kernel's float32 erf polynomial,
    one operation at a time (K4's epilogue computes the same sequence)."""
    w = torch.clamp(x * 0.7071067811865476, -4.0, 4.0)
    w2 = w * w
    p = torch.full_like(w2, _ERF_P[0])
    for c in _ERF_P[1:]:
        p = p * w2 + c
    q = torch.full_like(w2, _ERF_Q[0])
    for c in _ERF_Q[1:]:
        q = q * w2 + c
    erf = w * p / q
    return x * 0.5 * (1.0 + erf)


def qrows_plain(x: torch.Tensor):
    """Dynamic per-row int8: ``x [..., n]`` -> (``xq`` int8 [rows, n], ``sx``
    float32 [rows, 1]), sx = max(max|x|, 1e-8) / 127, xq = clamp(round(x /
    sx), -127, 127), rounding half to even."""
    rows = x.reshape(-1, x.shape[-1]).float()
    sx = div127(torch.clamp(rows.abs().amax(dim=-1, keepdim=True), min=1e-8))
    xq = torch.clamp(torch.round(rows / sx), -127, 127).to(torch.int8)
    return xq, sx


def div127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` as a true division.  The divisor is a tensor on ``t``'s
    device: PyTorch's CUDA division by a Python scalar multiplies by the
    reciprocal, which can miss the true quotient (the kernels' and the JAX
    package's) by one float32 step."""
    return t / t.new_tensor(127.0)


def int8_matmul_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``xq [M, K] @ wq [N, K]^T`` of int8 codes, as exact float64 integers.

    ``torch.matmul`` on two int8 tensors returns int8 and overflows without a
    word, and CUDA has no integer matmul; float64 holds every sum exactly
    (|sum| <= 127^2 * K < 2^53), and its conversion to float32 rounds as the
    int32 accumulator's does."""
    return torch.matmul(xq.double(), wq.double().t())


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The int8 GEMM's raw accumulators, int32 ``[M, N]`` (the plain version
    returns the same integers as int32)."""
    if xq.device.type == "cpu":
        return int8_matmul_plain(xq, wq).to(torch.int32)
    dev = _build.device_of(xq)
    (m, k), n = xq.shape, wq.shape[0]
    _build.require(xq, "xq", (m, k), dev, torch.int8)
    _build.require(wq, "wq", (n, k), dev, torch.int8)
    out = torch.empty(m, n, dtype=torch.int32, device=dev)
    plan = _cached_qgemm_plan(m, n, k, _build.num_sms(dev),
                              (xq.data_ptr() | wq.data_ptr()) % 16 == 0)
    err = _build.load_library().mmtr_qgemm_i32(
        xq.data_ptr(), wq.data_ptr(), out.data_ptr(), m, n, k, plan[1], _build.stream_ptr(dev))
    _build.check(err, "int8_matmul kernel")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def qrows(x: torch.Tensor):
    """:func:`qrows_plain` through K4's row-quantize kernel on a CUDA
    tensor (bf16 rows: its bf16 instance, the rows read as float32)."""
    if x.device.type == "cpu":
        return qrows_plain(x)
    dev = _build.device_of(x)
    n = x.shape[-1]
    rows = x.numel() // n
    bf = x.dtype == torch.bfloat16
    _build.require(x, "x", tuple(x.shape), dev, x.dtype if bf else torch.float32)
    xq = torch.empty(rows, n, dtype=torch.int8, device=dev)
    sx = torch.empty(rows, 1, dtype=torch.float32, device=dev)
    lib = _build.load_library()
    err = (lib.mmtr_qrows_bf16 if bf else lib.mmtr_qrows)(
        x.data_ptr(), xq.data_ptr(), sx.data_ptr(), rows, n, _build.stream_ptr(dev))
    _build.check(err, "qrows kernel")
    qrows.launches += 1
    qrows.launches_bf16 += bf
    return xq, sx


qrows.launches = 0
qrows.launches_bf16 = 0


def qdot_plain(xq, sx, wq: dict, bias) -> torch.Tensor:
    """Plain version of :func:`qdot`, the JAX package's ``_qdot``: the
    dequant in float32 (bf16 scales and bias upcast), the result in the
    bias's dtype (rounded where it is bf16)."""
    acc = int8_matmul_plain(xq, wq["q"]).float()
    return (acc * sx * wq["s"].float() + bias.float()).to(bias.dtype)


def qdot(xq: torch.Tensor, sx: torch.Tensor, wq: dict, bias: torch.Tensor) -> torch.Tensor:
    """``float(xq @ q^T) * sx * s + bias``: int8 codes ``xq [M, K]`` with
    row scales ``sx [M, 1]``, weights ``{"q": int8 [N, K], "s": [N]}``,
    ``bias [N]`` -> ``[M, N]`` in the bias's dtype: float32, or bf16 (with
    bf16 scales, the bf16 instance: the float32 dequant rounded to bf16)."""
    if xq.device.type == "cpu":
        return qdot_plain(xq, sx, wq, bias)
    dev = _build.device_of(xq)
    (m, k), n = xq.shape, wq["q"].shape[0]
    dt = torch.bfloat16 if bias.dtype == torch.bfloat16 else torch.float32
    _build.require(xq, "xq", (m, k), dev, torch.int8)
    _build.require(sx, "sx", (m, 1), dev)
    _build.require(wq["q"], "wq", (n, k), dev, torch.int8)
    _build.require(wq["s"], "ws", (n,), dev, dt)
    _build.require(bias, "bias", (n,), dev, dt)
    out = torch.empty(m, n, dtype=dt, device=dev)
    plan = _cached_qgemm_plan(m, n, k, _build.num_sms(dev),
                              (xq.data_ptr() | wq["q"].data_ptr()) % 16 == 0)
    lib = _build.load_library()
    err = (lib.mmtr_qdot_bf16 if dt == torch.bfloat16 else lib.mmtr_qdot)(
        xq.data_ptr(), sx.data_ptr(), wq["q"].data_ptr(), wq["s"].data_ptr(),
        bias.data_ptr(), out.data_ptr(), m, n, k, plan[1], _build.stream_ptr(dev))
    _build.check(err, "qdot kernel")
    qdot.launches += 1
    qdot.launches_bf16 += dt == torch.bfloat16
    return out


qdot.launches = 0
qdot.launches_bf16 = 0


def ffn_ln_block_q_plain(x, w1: dict, b1, w2: dict, b2, ln_g, ln_b, *, eps: float,
                         return_codes: bool = False):
    """Plain PyTorch version of K4, the JAX kernel's operations in order.
    bf16 ``x`` (its scales, biases and LN parameters bf16): the bf16
    instance's, h1 and y rounded to bf16 after their dequant, g1 =
    gelu(h1) rounded before its codes, the residual sum rounded, then the
    LN."""
    rows = x.reshape(-1, x.shape[-1])
    xq, sx = qrows_plain(rows)
    h1 = qdot_plain(xq, sx, w1, b1)
    g1 = gelu_erf_poly(h1.float()).to(h1.dtype)
    gq, sg = qrows_plain(g1)
    y = qdot_plain(gq, sg, w2, b2)
    out = masked_layer_norm(rows + y, ln_g, ln_b, eps=eps).reshape(x.shape)
    return (out, gq, sg) if return_codes else out


def ffn_ln_block_q(x: torch.Tensor, w1: dict, b1: torch.Tensor, w2: dict,
                   b2: torch.Tensor, ln_g: torch.Tensor, ln_b: torch.Tensor, *,
                   eps: float, return_codes: bool = False):
    """``LN(x + qproj(gelu(qproj(x, w1, b1)), w2, b2))`` for ``x [..., h]``,
    ``w1 = {"q": int8 [F, h], "s": [F]}``, ``w2 = {"q": int8 [h, F], "s":
    [h]}``.  ``return_codes`` also returns the hidden int8 codes ``[rows, F]``
    and their row scales ``[rows, 1]``, to count flipped codes in a check.
    bf16 ``x`` (scales, biases and LN parameters bf16) takes the bf16
    instance."""
    if x.device.type == "cpu":
        return ffn_ln_block_q_plain(x, w1, b1, w2, b2, ln_g, ln_b, eps=eps,
                                    return_codes=return_codes)
    dev = _build.device_of(x)
    h = x.shape[-1]
    ffn = w1["q"].shape[0]
    rows = x.numel() // h
    bf = x.dtype == torch.bfloat16
    dt = x.dtype if bf else torch.float32
    _build.require(x, "x", tuple(x.shape), dev, dt)
    _build.require(w1["q"], "w1q", (ffn, h), dev, torch.int8)
    _build.require(w2["q"], "w2q", (h, ffn), dev, torch.int8)
    for name, t, n in (("w1s", w1["s"], ffn), ("b1", b1, ffn), ("w2s", w2["s"], h),
                       ("b2", b2, h), ("ln_g", ln_g, h), ("ln_b", ln_b, h)):
        _build.require(t, name, (n,), dev, dt)
    plan = _cached_ffn_q_plan(rows, h, ffn, _build.num_sms(dev),
                              (w1["q"].data_ptr() | w2["q"].data_ptr()) % 16 == 0)
    i8, f32 = dict(dtype=torch.int8, device=dev), dict(dtype=torch.float32, device=dev)
    xq = torch.empty(rows, h, **i8)
    sx = torch.empty(rows, 1, **f32)
    hidden = torch.empty(rows, ffn, dtype=dt, device=dev)
    hq = torch.empty(rows, ffn, **i8)
    sh = torch.empty(rows, 1, **f32)
    resid_sum = torch.empty(rows, h, dtype=dt, device=dev)
    out = torch.empty_like(x)
    lib = _build.load_library()
    err = (lib.mmtr_ffn_ln_q_fwd_bf16 if bf else lib.mmtr_ffn_ln_q_fwd)(
        x.data_ptr(), w1["q"].data_ptr(), w1["s"].data_ptr(), b1.data_ptr(),
        w2["q"].data_ptr(), w2["s"].data_ptr(), b2.data_ptr(), ln_g.data_ptr(),
        ln_b.data_ptr(), xq.data_ptr(), sx.data_ptr(), hidden.data_ptr(), hq.data_ptr(),
        sh.data_ptr(), resid_sum.data_ptr(), out.data_ptr(), rows, h, ffn, eps, plan[1],
        _build.stream_ptr(dev))
    _build.check(err, "ffn_ln_block_q kernel")
    ffn_ln_block_q.launches += 1
    ffn_ln_block_q.launches_bf16 += bf
    return (out, hq, sh) if return_codes else out


ffn_ln_block_q.launches = 0
ffn_ln_block_q.launches_bf16 = 0
