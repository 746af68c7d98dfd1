"""The frozen-BERT attention through hand-written CUDA kernels.

Counterpart of ``multimodal_transformer_robustness_tpu/ops/bert_attn_pallas.py``
(forward only).  Both wrappers launch ``csrc/bert_attn.cu`` on a CUDA tensor
and run their plain PyTorch versions on a CPU tensor:

  * :func:`attention_block_fused` (K2): the whole block ``LN(x +
    o_proj(MHA(x)))``, replaces ``bert_attn_pallas._attn_block_kernel``;
    weights come pre-transposed (``w*_t = weight.T``), made once at load
    time, q/k/v's as views of one ``[3, h, h]`` tensor and their biases of
    one ``[3h]`` vector (``models/bert.prepare_bert``), so that its q/k/v
    product on ``csrc/gemm_tc.cuh``'s 3xTF32 tensor cores is one N = 3h
    product that reads ``x`` once; its launch plan is
    :func:`_plan_attn_block`;
  * :func:`dense_attention_blockdiag` (K6a): the projection-free attention
    core over q/k/v ``[B, L, H, dh]``, replaces
    ``bert_attn_pallas._dense_attn_kernel``; the same attention kernel as
    K2's attention stage, and as K8's
    (``attention_cuda.flash_attention_masked``) under a hard key mask.

The key-padding bias is HF's additive ``(1 - mask) * -10000``.

K2 has a bf16 instance (``mmtr_attn_block_fwd_bf16``): bf16 ``x`` and
weights take it on the card, its plain version on the CPU, at the JAX
kernel's rounding points (q/k/v after their float32 bias, the softmax
probabilities, each head's output, the o-projection after its bias; the
residual sum, then a float32-moment LN rounded to bf16), the products on
the bf16 tensor cores (the projections on ``csrc/gemm_bf16.cuh``, at the
training rows on its persistent kernel, Q K^T and P V on mma.sync
m16n8k16); ``softmax_dtype="bfloat16"`` runs the exp /
sum / divide tail in bf16, as ``ATTN_SOFTMAX`` selects in the JAX package.
K6a has one too (``mmtr_attention_fwd_bf16``), K2's bf16 attention stage
alone under the float32 softmax: bf16 q / k / v in, bf16 out.  Both take
every L, by :func:`_plan_attention_bf16` (a unit's queries and keys held
at once up to L = 64, the training shape being L = 32: on the unit walk
where the units fill the card, a block a unit on fewer; the whole row's
logits formed once and held in a block's registers up to L = 512, the
serving buckets; 64-key tiles in three passes beyond), and dh <= 64 with
dh and h multiples of 8.
"""

from __future__ import annotations

import functools
import math

import torch

from .. import _build
from . import gemm_tc
from .bert_ffn_cuda import _plan_proj_ln, _plan_proj_ln_bf16
from .layernorm import masked_layer_norm

# a lane holds up to 4 output columns (lane + 32c) of 8 query rows
_MAX_HEAD_DIM = 128
_ATT_RQ, _ATT_KT, _ATT_QT, _ATT_WARPS = 8, 64, 32, 4   # csrc/bert_attn.cu
_UNIT_BLOCKS_PER_SM = 4    # attention_unit_kernel's launch bound
# the wgmma widths K2's q/k/v product may take: csrc/bert_attn.cu's
# K2_PROMOTE is 0, so every width the header instantiates (promoted sums
# would need gemm_tc.PROMOTED_WIDTHS)
_K2_WIDTHS = gemm_tc.WG_WIDTHS
_ATTN_PLAN_KEYS = ("path", "vec", "blocks", "smem", "dp", "ldk", "qrows", "krows", "nc")


def _plan_attention(B: int, L: int, n_heads: int, dh: int, num_sms: int = _build.NUM_SMS,
                    aligned: bool = True, Lk: int | None = None) -> dict:
    """The attention kernels' launch plan (K6a, K2's attention stage, and
    K8, ``attention_cuda.flash_attention_masked``): ``L`` query rows a unit
    and ``Lk`` key rows (``L`` where None: self-attention).

    ``dp``: dh rounded up to 4; ``ldk``: a shared row, ``dp`` or ``dp + 4``
    so that it is an odd number of 16-byte words (conflict-free float4
    reads); ``nc``: output columns a lane holds (1, 2 or 4).  L, Lk <= 64
    take the unit path: q rows padded to 8, keys to 32 or 64, two units'
    tiles in the ring, and a persistent grid of at most four blocks an SM
    (fewer where shared memory allows fewer).  Longer units take the tiled
    path, a block per (unit, 32 queries) over 64-key tiles.  16-byte copies
    (``vec``) need dh a multiple of 4 and 16-byte aligned q, k, v."""
    Lk = L if Lk is None else Lk
    if not 1 <= dh <= _MAX_HEAD_DIM or min(L, Lk) < 1:
        raise ValueError(f"head_dim {dh}, L {L}, Lk {Lk}: the kernel takes 1 <= head_dim <= "
                         f"{_MAX_HEAD_DIM} and L, Lk >= 1")
    dp = _build.round_up(dh, 4)
    ldk = dp if (dp // 4) % 2 else dp + 4
    nc = {1: 1, 2: 2, 3: 4, 4: 4}[-(-dp // 32)]
    units = B * n_heads
    if max(L, Lk) <= 64:
        qrows, krows = _build.round_up(L, 8), (32 if Lk <= 32 else 64)
        smem = 4 * (2 * ((qrows + 2 * krows) * ldk + krows) + _ATT_WARPS * _ATT_RQ * krows)
        per_sm = min(_UNIT_BLOCKS_PER_SM, _build.SM_SMEM // (smem + 1024))
        path, blocks = 0, min(units, per_sm * num_sms)
    else:
        qrows, krows = _ATT_QT, _ATT_KT
        smem = 4 * (_ATT_QT * ldk + 2 * (2 * _ATT_KT * ldk + _ATT_KT)
                    + _ATT_WARPS * _ATT_RQ * _ATT_KT)
        path, blocks = 1, units * -(-L // _ATT_QT)
    if smem > _build.MAX_SMEM:
        raise ValueError(f"attention at L={L}, Lk={Lk}, head_dim={dh} needs {smem} bytes of "
                         f"shared memory, more than the card's {_build.MAX_SMEM}")
    return {"path": path, "vec": int(aligned and dh % 4 == 0), "blocks": blocks,
            "smem": smem, "dp": dp, "ldk": ldk, "qrows": qrows, "krows": krows, "nc": nc}


@functools.lru_cache(maxsize=None)
def _cached_plan(B, L, n_heads, dh, num_sms, aligned, Lk=None):
    """The plan as csrc/bert_attn.cu reads it: (C int array, its address)."""
    p = _plan_attention(B, L, n_heads, dh, num_sms, aligned, Lk)
    return _build.host_ints([p[k] for k in _ATTN_PLAN_KEYS])


def _plan_attn_block(B: int, L: int, h: int, n_heads: int, num_sms: int = _build.NUM_SMS,
                     aligned: bool = True) -> dict:
    """K2's launch plan (``csrc/bert_attn.cu`` takes it as given), built as
    ``bert_ffn_cuda._plan_ffn`` is: for the q/k/v product (``[B*L, h] x [h,
    3h]``), :func:`gemm_tc.plan_product`: the wgmma tiles (128 x 128 at
    BERT-base width: 18 column tiles) where they give every SM at least two
    blocks, else the 64 x 64 mma.sync tiles split over K (6 ranges at B=1
    L=8), widths :data:`_K2_WIDTHS`; 4-byte copies where ``h`` is not a
    multiple of 4 or an operand is not ``aligned``.  ``o``: the o-projection
    + LN's, K6b's plan (:func:`bert_ffn_cuda._plan_proj_ln`) at the same
    rows.
    ``attention``: :func:`_plan_attention` for the q, k, v planes of the
    product's fresh scratch (16-byte aligned when ``h`` is a multiple of 4).
    ``fused_ln``: the o-projection split on the mma.sync tiles, its planes
    added by the LayerNorm's launch.  ``scratch``: the floats the larger of
    the two products needs (they run one after the other)."""
    rows = B * L
    qkv = gemm_tc.plan_product(rows, 3 * h, h, aligned and h % 4 == 0, num_sms,
                               widths=_K2_WIDTHS)
    o = _plan_proj_ln(rows, h, num_sms, aligned)
    return {"qkv": qkv, "o": o,
            "attention": _plan_attention(B, L, n_heads, h // n_heads, num_sms, h % 4 == 0),
            "fused_ln": o["fused_ln"], "scratch": max(qkv["scratch"], o["scratch"])}


@functools.lru_cache(maxsize=None)
def _cached_block_plan(B, L, h, n_heads, num_sms, aligned):
    """K2's plan as csrc/bert_attn.cu reads it: (C int array, its address,
    the floats of scratch, whether the o-projection's sum is fused into the
    LN)."""
    p = _plan_attn_block(B, L, h, n_heads, num_sms, aligned)
    ints = ([p[k][key] for k in ("qkv", "o") for key in gemm_tc.PLAN_KEYS]
            + [p["attention"][key] for key in _ATTN_PLAN_KEYS])
    return _build.host_ints(ints) + (p["scratch"], p["fused_ln"])


def _gated(parts, n: int):
    """``parts`` (contiguous, ``n`` elements each) as one operand: (its
    address, a tensor to keep alive while it is read).  In place where each
    starts where the one before it ends, as the views of one stacked tensor
    do (None to keep); else stacked by ``torch.cat``."""
    base = parts[0].data_ptr()
    size = parts[0].element_size()
    if all(p.data_ptr() == base + size * n * i for i, p in enumerate(parts)):
        return base, None
    stacked = torch.cat(parts)
    return stacked.data_ptr(), stacked


def dense_attention_plain(q, k, v, key_mask) -> torch.Tensor:
    """Plain PyTorch version of K6a: ``softmax(q k^T / sqrt(dh) + (1 - mask)
    * -10000) v`` per (item, head), float32 softmax; q/k/v ``[B, L, H, dh]``
    -> ``[B, L, H * dh]``.  This is also the JAX package's XLA attention
    composition (``models/bert.bert_apply`` under ``ATTN_IMPL="xla"``).
    bf16 q / k / v: the bf16 instance's, float32 logits of the bf16 values,
    the float32 softmax ``e / sum(e)`` rounded to bf16, P V summed in
    float32 and rounded to bf16, as the JAX kernel (and the XLA
    composition) at bf16."""
    b, L, n_heads, dh = q.shape
    bias = (1.0 - key_mask.float()) * -10000.0
    if q.dtype == torch.bfloat16:
        s = (torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(dh)
             + bias[:, None, None, :])
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = (e / e.sum(dim=-1, keepdim=True)).to(torch.bfloat16).float()
        out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(torch.bfloat16)
        return out.reshape(b, L, n_heads * dh)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh) + bias[:, None, None, :]
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, L, n_heads * dh)


def _attention_block_plain_bf16(x, key_mask, wq_t, qb, wk_t, kb, wv_t, vb, wo_t, ob, ln_g,
                                ln_b, n_heads: int, eps: float,
                                softmax_dtype: str) -> torch.Tensor:
    """The bf16 instance's plain version (JAX ``_attn_block_kernel`` at
    bf16): products of bf16 values as float32 matmuls of the upcast
    operands, the bias added in float32, then rounded to bf16; the
    residual sum ``x + y`` rounded to bf16, then the LN."""
    b, L, h = x.shape
    dh = h // n_heads
    bf = torch.bfloat16
    xf = x.float()

    def proj(w, bias):
        return (xf @ w.float() + bias.float()).to(bf).float().reshape(b, L, n_heads, dh)

    q, k, v = proj(wq_t, qb), proj(wk_t, kb), proj(wv_t, vb)
    bias = (1.0 - key_mask.float()) * -10000.0
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh) + bias[:, None, None, :]
    d = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(d.to(bf)) if softmax_dtype == "bfloat16" else torch.exp(d)
    p = (e / e.sum(dim=-1, keepdim=True)).to(bf).float()
    attn = torch.einsum("bhqk,bkhd->bqhd", p, v).to(bf).reshape(b * L, h)
    y = (attn.float() @ wo_t.float() + ob.float()).to(bf).reshape(b, L, h)
    return masked_layer_norm(x + y, ln_g, ln_b, eps=eps)


def attention_block_plain(x, key_mask, wq_t, qb, wk_t, kb, wv_t, vb, wo_t, ob,
                          ln_g, ln_b, *, n_heads: int, eps: float,
                          softmax_dtype: str = "float32") -> torch.Tensor:
    """Plain PyTorch version of the kernel (float32 softmax; bf16 ``x``:
    the bf16 instance's, ``softmax_dtype`` its softmax tail)."""
    if x.dtype == torch.bfloat16:
        return _attention_block_plain_bf16(x, key_mask, wq_t, qb, wk_t, kb, wv_t, vb, wo_t,
                                           ob, ln_g, ln_b, n_heads, eps, softmax_dtype)
    b, L, h = x.shape

    def proj(w, bias):
        return (torch.matmul(x, w) + bias).reshape(b, L, n_heads, h // n_heads)

    attn = dense_attention_plain(proj(wq_t, qb), proj(wk_t, kb), proj(wv_t, vb), key_mask)
    return masked_layer_norm(x + (torch.matmul(attn, wo_t) + ob), ln_g, ln_b, eps=eps)


# csrc/bert_attn.cu's bf16 attention: a unit's rows (L <= 64) on the unit
# path; query rows a block, keys a warp and the row length its registers
# hold on the row path; query rows a block and keys a tile on the tiled path
_AB_ROWS, _AB_LD = 64, 72
_AR_QROWS, _AR_KEYS, _AR_MAX_KW = 32, 128, 4
_AB_PLAN_KEYS = ("path", "units", "qtiles", "threads", "smem", "blocks")
# the unit walk (attention_bf16_walk_kernel): warps a block, ring slots a
# warp, blocks an SM (its launch bound); the units from which K6a.bf16 and
# K2.bf16 take it at L <= 64: fewer keep the block-a-unit kernel, which ran
# faster up to 192 units (B=16, 12 heads) and slower from 768 (B=64) in
# tools/k6a_k8_bf16_split.py --small on the H100 (PERF.md)
_AW_WARPS, _AW_STAGES, _AW_BLOCKS_PER_SM = 4, 2, 2
_WALK_MIN_UNITS = 768


def _walk_slot_bytes(Lq: int, Lk: int) -> int:
    """A walk ring slot: q [Lq rounded up to 32][72], k and v [Lk rounded
    up to 16][72] bf16, the key bias row [64] float32."""
    return ((_build.round_up(Lq, 32) + 2 * _build.round_up(Lk, 16)) * _AB_LD * 2
            + 4 * _AB_ROWS)


def _plan_walk(units: int, Lq: int, Lk: int, num_sms: int = _build.NUM_SMS) -> dict:
    """The unit walk's plan (path 3, in the bf16 attention plan's keys):
    ``min(4, units)`` warps a block, each with a two-slot ring, at most two
    blocks an SM as shared memory allows (Lq = Lk = 32: 112,640 bytes a
    block, two an SM; 64: 223,232, one), and a persistent grid of at most
    that many blocks an SM, no block without a unit."""
    warps = min(_AW_WARPS, units)
    smem = warps * _AW_STAGES * _walk_slot_bytes(Lq, Lk)
    per_sm = min(_AW_BLOCKS_PER_SM, _build.SM_SMEM // (smem + 1024))
    blocks = min(-(-units // warps), per_sm * num_sms)
    return {"path": 3, "units": units, "qtiles": 1, "threads": 32 * warps, "smem": smem,
            "blocks": blocks}


def _plan_attention_bf16(B: int, L: int, n_heads: int, dh: int,
                         num_sms: int = _build.NUM_SMS) -> dict:
    """The bf16 attention kernels' launch plan (K6a.bf16 and K2.bf16's
    attention stage): path, units, query tiles a unit, threads a block,
    dynamic shared memory and blocks launched:

    * path 3 at L <= 64 on at least ``_WALK_MIN_UNITS`` units (the training
      rows: B=4096, 12 heads): the unit walk (``attention_bf16_walk_kernel``,
      :func:`_plan_walk`), a persistent grid whose warps each own a unit,
      the next unit's rows in flight;
    * path 0 at L <= 64 on fewer units (serving, evaluation batches):
      ``attention_bf16_kernel``, a block a unit, every query and key held at
      once, 128 threads, static shared memory;
    * path 2 at 64 < L <= 512 (``attention_bf16_row_kernel``): a block per
      (unit, 32 queries) of 64 * KW threads, KW = ceil(L / 128) key groups
      of 128 keys by two 16-row groups, S for the whole row in registers
      (computed once); dynamic shared memory: q [32][72] bf16, one [kp][72]
      bf16 buffer for K then V (kp = L rounded up to 16; the KW - 1 partial
      outputs [32][dh rounded to 16] float32 reuse it), the max / sum
      exchange [2][KW][32] float32 and the key bias [KW * 128] float32:
      81,408 bytes at L = 512, dh = 64, two blocks an SM, so B=1, 12 heads
      gives 192 blocks in one wave;
    * path 1 past 512, beyond the row path's registers (``attention_bf16_
      tiled_kernel``): a block per (unit, 64 queries) over 64-key tiles in
      three passes (max, sum, P V), 128 threads, static shared memory.

    Heads arrive in 16-byte copies and their products run on m16n8k16
    tiles: dh > 64, or dh not a multiple of 8, raises NotImplementedError."""
    if dh > 64 or dh % 8 or L < 1:
        raise NotImplementedError(f"the bf16 attention at L={L}, head_dim={dh}: the bf16 "
                                  "instance takes head_dim <= 64, a multiple of 8 (ROADMAP "
                                  "Queue 2, 'bf16')")
    units = B * n_heads
    if L <= _AB_ROWS:
        if units >= _WALK_MIN_UNITS:
            return _plan_walk(units, L, L, num_sms)
        return {"path": 0, "units": units, "qtiles": 1, "threads": 128, "smem": 0,
                "blocks": units}
    if L > _AR_KEYS * _AR_MAX_KW:
        qtiles = -(-L // _AB_ROWS)
        return {"path": 1, "units": units, "qtiles": qtiles, "threads": 128, "smem": 0,
                "blocks": units * qtiles}
    kw, kp, dp = -(-L // _AR_KEYS), _build.round_up(L, 16), _build.round_up(dh, 16)
    kv = 2 * kp * _AB_LD
    assert 4 * (kw - 1) * _AR_QROWS * dp <= kv     # the partial outputs fit K / V's buffer
    qtiles = -(-L // _AR_QROWS)
    return {"path": 2, "units": units, "qtiles": qtiles, "threads": 64 * kw,
            "smem": 2 * _AR_QROWS * _AB_LD + kv + 4 * 2 * kw * _AR_QROWS + 4 * kw * _AR_KEYS,
            "blocks": units * qtiles}


@functools.lru_cache(maxsize=None)
def _cached_plan_bf16(B, L, n_heads, dh, num_sms=_build.NUM_SMS):
    """The plan as csrc/bert_attn.cu reads it: (C int array, its address)."""
    p = _plan_attention_bf16(B, L, n_heads, dh, num_sms)
    return _build.host_ints([p[k] for k in _AB_PLAN_KEYS])


def _plan_attention_masked_bf16(B: int, Tq: int, Tk: int, H: int, D: int, aligned: bool,
                                num_sms: int = _build.NUM_SMS) -> dict | None:
    """K8.bf16's plan (``attention_cuda.flash_attention_masked`` on bf16
    operands): the unit walk (:func:`_plan_walk`, its RULE 0: S and P V on
    the bf16 tensor cores, p never rounded) where Tq, Tk <= 64, D is a
    multiple of 8 up to 64 and q, k, v are 16-byte ``aligned``; None
    elsewhere, where the float32 HARD kernels run the bf16 rows by the
    float32 plan (:func:`_plan_attention` with ``Lk=Tk``)."""
    if max(Tq, Tk) > _AB_ROWS or D % 8 or D > _AB_ROWS or not aligned:
        return None
    return _plan_walk(B * H, Tq, Tk, num_sms)


@functools.lru_cache(maxsize=None)
def _cached_plan_masked_bf16(B, Tq, Tk, H, D, aligned, num_sms=_build.NUM_SMS):
    """K8.bf16's walk plan as csrc/bert_attn.cu reads it (C int array, its
    address), or None (the float32 plan)."""
    p = _plan_attention_masked_bf16(B, Tq, Tk, H, D, aligned, num_sms)
    return None if p is None else _build.host_ints([p[k] for k in _AB_PLAN_KEYS])


def _plan_attn_block_bf16(B: int, L: int, h: int, n_heads: int,
                          num_sms: int = _build.NUM_SMS, x_addr: int = 0, w_addr: int = 0,
                          wo_addr: int = 0) -> dict:
    """K2's bf16 plan: :func:`gemm_tc.plan_bf16` for the q/k/v product
    (``[B*L, h] x [h, 3h]``, B gated [3, h, h]) with ``persistent`` and
    ``gate=h``: where the rows fill the card and h is a multiple of 192 and
    64, the persistent kernel, reading the gated weights as stored and
    writing the q, k and v planes (``grid``); elsewhere the first port's
    plans.  The o-projection + LN's, K6b.bf16's plan
    (:func:`bert_ffn_cuda._plan_proj_ln_bf16`) with A the fresh bf16
    attention output and the residual x; ``attention``:
    :func:`_plan_attention_bf16`.  h not a multiple of 8 raises
    NotImplementedError, as the attention stage's limits do."""
    if h % 8:
        raise NotImplementedError(f"the bf16 attention block at h={h}: the bf16 instance "
                                  "takes h a multiple of 8 (ROADMAP Queue 2, 'bf16')")
    attention = _plan_attention_bf16(B, L, n_heads, h // n_heads, num_sms)
    rows = B * L
    qkv = gemm_tc.plan_bf16(rows, 3 * h, h, gemm_tc.bf16_copy_width((h,), (x_addr,)),
                            gemm_tc.bf16_copy_width((h,), (w_addr,)), num_sms,
                            persistent=True, gate=h)
    o = _plan_proj_ln_bf16(rows, h, num_sms, 0, wo_addr, x_addr)
    return {"qkv": qkv, "o": o, "attention": attention,
            "partial": max(qkv["partial"], o["partial"])}


@functools.lru_cache(maxsize=None)
def _cached_block_plan_bf16(B, L, h, n_heads, num_sms, x_addr, w_addr, wo_addr):
    """K2's bf16 plan as csrc/bert_attn.cu reads it: (C int array, its
    address, the floats of split planes): the two products' BfPlans, the
    attention plan (six ints), then the two persistent grids (0 off the
    persistent kernel)."""
    p = _plan_attn_block_bf16(B, L, h, n_heads, num_sms, x_addr, w_addr, wo_addr)
    ints = ([p[k][key] for k in ("qkv", "o") for key in gemm_tc.BF_PLAN_KEYS]
            + [p["attention"][key] for key in _AB_PLAN_KEYS]
            + [p[k].get("grid", 0) for k in ("qkv", "o")])
    return _build.host_ints(ints) + (p["partial"],)


def _attention_block_bf16(x, mask, wq_t, qb, wk_t, kb, wv_t, vb, wo_t, ob, ln_g, ln_b,
                          n_heads: int, eps: float, softmax_dtype: str) -> torch.Tensor:
    dev = x.device
    b, L, h = x.shape
    _build.require_all(dev, [(x, "x", (b, L, h))]
                       + [(t, name, (h, h)) for name, t in (("wq_t", wq_t), ("wk_t", wk_t),
                                                           ("wv_t", wv_t), ("wo_t", wo_t))]
                       + [(t, name, (h,)) for name, t in (("qb", qb), ("kb", kb), ("vb", vb),
                                                         ("ob", ob), ("ln_g", ln_g),
                                                         ("ln_b", ln_b))], torch.bfloat16)
    _build.require(mask, "key_mask", (b, L), dev)
    wqkv, _w = _gated((wq_t, wk_t, wv_t), h * h)
    bqkv, _b = _gated((qb, kb, vb), h)
    plan = _cached_block_plan_bf16(b, L, h, n_heads, _build.num_sms(dev), x.data_ptr() % 16,
                                   wqkv % 16, wo_t.data_ptr() % 16)
    qkv = torch.empty(3, b * L, h, dtype=torch.bfloat16, device=dev)
    attn = torch.empty(b * L, h, dtype=torch.bfloat16, device=dev)
    resid_sum = torch.empty(b * L, h, dtype=torch.bfloat16, device=dev)
    partial = torch.empty(plan[2], dtype=torch.float32, device=dev) if plan[2] else None
    out = torch.empty_like(x)
    err = _build.load_library().mmtr_attn_block_fwd_bf16(
        x.data_ptr(), mask.data_ptr(), wqkv, bqkv, wo_t.data_ptr(), ob.data_ptr(),
        ln_g.data_ptr(), ln_b.data_ptr(), qkv.data_ptr(), attn.data_ptr(),
        resid_sum.data_ptr(), out.data_ptr(), partial.data_ptr() if partial is not None else 0,
        b, L, h, n_heads, eps, int(softmax_dtype == "bfloat16"), plan[1],
        _build.stream_ptr(dev))
    _build.check(err, "attention_block_fused kernel (bf16)")
    attention_block_fused.launches_bf16 += 1
    return out


def attention_block_fused(x: torch.Tensor, key_mask: torch.Tensor,
                          wq_t, qb, wk_t, kb, wv_t, vb, wo_t, ob, ln_g, ln_b,
                          *, n_heads: int, eps: float,
                          softmax_dtype: str = "float32") -> torch.Tensor:
    """HF BertSelfAttention + BertSelfOutput: ``x [B, L, h]``,
    ``key_mask [B, L]`` (1 = attend), weights ``[h, h]`` in ``x @ w_t``
    orientation, biases and LN params ``[h]``.  ``wq_t, wk_t, wv_t`` that
    lie one after the other in memory (views of one ``[3, h, h]`` tensor,
    as ``models/bert.prepare_bert`` makes them) are the q/k/v product's
    operand in place, as are ``qb, kb, vb`` (of one ``[3h]``); others are
    stacked into one per call.  bf16 ``x`` and weights take the bf16
    instance; ``softmax_dtype="bfloat16"`` (its softmax tail in bf16)
    needs them."""
    if softmax_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown softmax_dtype {softmax_dtype!r}")
    if softmax_dtype == "bfloat16" and x.dtype != torch.bfloat16:
        raise NotImplementedError("the bf16 softmax tail runs on bf16 activations only, as "
                                  "in the JAX package (ROADMAP)")
    if x.dtype == torch.bfloat16:
        # on every device, so that the CPU computes nothing the card refuses
        _plan_attn_block_bf16(x.shape[0], x.shape[1], x.shape[2], n_heads)
    if x.device.type == "cpu":
        return attention_block_plain(x, key_mask, wq_t, qb, wk_t, kb, wv_t, vb,
                                     wo_t, ob, ln_g, ln_b, n_heads=n_heads, eps=eps,
                                     softmax_dtype=softmax_dtype)
    dev = _build.device_of(x)
    b, L, h = x.shape
    if h % n_heads or h // n_heads > _MAX_HEAD_DIM:
        raise ValueError(f"width {h} with {n_heads} heads: the kernel takes "
                         f"head_dim = h / n_heads <= {_MAX_HEAD_DIM}")
    mask = key_mask.to(device=dev, dtype=torch.float32).contiguous()
    if x.dtype == torch.bfloat16:
        out = _attention_block_bf16(x, mask, wq_t, qb, wk_t, kb, wv_t, vb, wo_t, ob, ln_g,
                                    ln_b, n_heads, eps, softmax_dtype)
        attention_block_fused.launches += 1
        return out
    _build.require_all(dev, [(x, "x", (b, L, h)), (mask, "key_mask", (b, L))]
                       + [(t, name, (h, h)) for name, t in (("wq_t", wq_t), ("wk_t", wk_t),
                                                           ("wv_t", wv_t), ("wo_t", wo_t))]
                       + [(t, name, (h,)) for name, t in (("qb", qb), ("kb", kb), ("vb", vb),
                                                         ("ob", ob), ("ln_g", ln_g),
                                                         ("ln_b", ln_b))])
    wqkv, _w = _gated((wq_t, wk_t, wv_t), h * h)
    bqkv, _b = _gated((qb, kb, vb), h)
    plan = _cached_block_plan(b, L, h, n_heads, _build.num_sms(dev),
                              (x.data_ptr() | wqkv | wo_t.data_ptr()) % 16 == 0)
    f32 = dict(dtype=torch.float32, device=dev)
    qkv = torch.empty(3, b * L, h, **f32)
    attn = torch.empty(b * L, h, **f32)
    resid_sum = torch.empty(0 if plan[3] else b * L * h, **f32)
    scratch = torch.empty(plan[2], **f32) if plan[2] else None
    out = torch.empty_like(x)
    err = _build.load_library().mmtr_attn_block_fwd(
        x.data_ptr(), mask.data_ptr(), wqkv, bqkv, wo_t.data_ptr(), ob.data_ptr(),
        ln_g.data_ptr(), ln_b.data_ptr(), qkv.data_ptr(), attn.data_ptr(),
        resid_sum.data_ptr(), out.data_ptr(), scratch.data_ptr() if scratch is not None else 0,
        b, L, h, n_heads, eps, plan[1], _build.stream_ptr(dev))
    _build.check(err, "attention_block_fused kernel")
    attention_block_fused.launches += 1
    return out


attention_block_fused.launches = 0
attention_block_fused.launches_bf16 = 0


def _dense_attention_bf16(q, k, v, mask) -> torch.Tensor:
    dev = q.device
    b, L, n_heads, dh = q.shape
    shape = (b, L, n_heads, dh)
    _build.require_all(dev, ((q, "q", shape), (k, "k", shape), (v, "v", shape)),
                       torch.bfloat16)
    _build.require(mask, "key_mask", (b, L), dev)
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    if (qp | kp | vp) % 16:
        raise ValueError("the bf16 attention reads q, k, v in 16-byte copies: their data "
                         "must be 16-byte aligned")
    plan = _cached_plan_bf16(b, L, n_heads, dh, _build.num_sms(dev))
    out = torch.empty(b, L, n_heads * dh, dtype=torch.bfloat16, device=dev)
    err = _build.load_library().mmtr_attention_fwd_bf16(
        qp, kp, vp, mask.data_ptr(), out.data_ptr(), b, L, n_heads * dh, n_heads, plan[1],
        _build.stream_ptr(dev))
    _build.check(err, "dense_attention_blockdiag kernel (bf16)")
    dense_attention_blockdiag.launches_bf16 += 1
    return out


def dense_attention_blockdiag(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              key_mask: torch.Tensor) -> torch.Tensor:
    """Multi-head attention over projected ``q, k, v [B, L, H, dh]``
    (unscaled; the 1/sqrt(dh) happens in the kernel) with ``key_mask [B, L]``
    (1 = attend) -> ``[B, L, H * dh]`` in q's dtype.  A fully masked item
    stays finite.  bf16 q / k / v take the bf16 instance (head_dim <= 64, a
    multiple of 8, checked on every device)."""
    if q.dtype == torch.bfloat16:
        _plan_attention_bf16(*q.shape)
    if q.device.type == "cpu":
        return dense_attention_plain(q, k, v, key_mask)
    dev = _build.device_of(q)
    b, L, n_heads, dh = q.shape
    shape = (b, L, n_heads, dh)
    mask = key_mask.to(device=dev, dtype=torch.float32).contiguous()
    if q.dtype == torch.bfloat16:
        out = _dense_attention_bf16(q, k, v, mask)
        dense_attention_blockdiag.launches += 1
        return out
    _build.require_all(dev, ((q, "q", shape), (k, "k", shape), (v, "v", shape),
                             (mask, "key_mask", (b, L))))
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    plan = _cached_plan(b, L, n_heads, dh, _build.num_sms(dev), (qp | kp | vp) % 16 == 0)
    out = torch.empty(b, L, n_heads * dh, dtype=torch.float32, device=dev)
    err = _build.load_library().mmtr_attention_fwd(
        qp, kp, vp, mask.data_ptr(), out.data_ptr(), b, L, n_heads * dh, n_heads, plan[1],
        _build.stream_ptr(dev))
    _build.check(err, "dense_attention_blockdiag kernel")
    dense_attention_blockdiag.launches += 1
    return out


dense_attention_blockdiag.launches = 0
dense_attention_blockdiag.launches_bf16 = 0
