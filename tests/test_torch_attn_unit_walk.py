"""The bf16 unit walk's launch plans and arithmetic, on the CPU.

``csrc/bert_attn.cu``'s ``attention_bf16_walk_kernel`` runs K6a.bf16 and
K2.bf16's attention stage at L <= 64 where the units fill the card, and
K8.bf16 at Tq, Tk <= 64: a persistent grid whose warps each own whole
(item, head) units, warp w of W taking units w, w + W, w + 2W, ..., each
warp with a ring of two shared-memory slots.  The kernel runs only on the
card; its plans (``ops.bert_attn_cuda._plan_walk``,
``_plan_attention_bf16``, ``_plan_attention_masked_bf16``) are Python, and
so is a model of the split its K8 rule makes of the float32 probabilities
before P V (``ops.attention_cuda.split_bf16_3``).  These tests hold the
walk's deal of units to warps to every unit exactly once with no block
left without one, its shared memory to the card at the residency the plan
claims, K8.bf16's choice between the walk and the float32 plan, and the
three bf16 terms to the float32 value they stand for.
"""

import numpy as np
import pytest
import torch

from multimodal_transformer_robustness_tpu_torch.ops import attention_cuda, bert_attn_cuda

MAX_SMEM = 232448   # what one block may take
SM_SMEM = 233472    # an SM's shared memory; each resident block reserves 1 KB more
SMS = 132
LD = 72             # a staged row: 72 bf16


def _slot_bytes(Lq, Lk):
    """A ring slot: q [Lq up to 32][72], k and v [Lk up to 16][72] bf16, the
    key bias row [64] float32."""
    qp, kp = -(-Lq // 32) * 32, -(-Lk // 16) * 16
    return (qp + 2 * kp) * LD * 2 + 64 * 4


def _deal(plan):
    """The units each warp of the grid walks, in the kernel's order."""
    warps = plan["threads"] // 32
    step = plan["blocks"] * warps
    return [list(range(w, plan["units"], step)) for w in range(step)]


@pytest.mark.parametrize("B,L,heads", [(1, 8, 12), (3, 13, 2), (300, 31, 12), (5, 64, 12),
                                       (4096, 32, 12)])
def test_walk_covers_every_unit_once(B, L, heads):
    """Every (item, head) unit walked by exactly one warp, once; no block
    whose first warp has no unit; the warps' rings within the card's
    shared memory at the blocks an SM the plan's grid assumes resident."""
    units = B * heads
    p = bert_attn_cuda._plan_walk(units, L, L, SMS)
    warps = p["threads"] // 32
    assert p["path"] == 3 and p["units"] == units and p["qtiles"] == 1
    assert 1 <= warps <= 4 and warps == min(4, units)
    walked = sorted(u for units_of_warp in _deal(p) for u in units_of_warp)
    assert walked == list(range(units))
    assert all(b * warps < units for b in range(p["blocks"]))
    assert p["smem"] == warps * 2 * _slot_bytes(L, L) <= MAX_SMEM
    per_sm = min(2, SM_SMEM // (p["smem"] + 1024))
    assert per_sm >= 1 and per_sm * (p["smem"] + 1024) <= SM_SMEM
    assert p["blocks"] <= per_sm * SMS
    if units >= per_sm * SMS * warps:
        assert p["blocks"] == per_sm * SMS     # the whole card, one persistent wave


def test_walk_at_the_training_shape():
    """B=4096 L=32, 12 heads of 64 (bench.py's step): 49,152 units over 264
    blocks of 4 warps, two an SM at 112,640 bytes, 46 or 47 units a warp;
    K6a.bf16's and K2.bf16's plan takes it, and K8.bf16's at the same
    shape; at L = 64 one block an SM (223,232 bytes)."""
    p = bert_attn_cuda._plan_attention_bf16(4096, 32, 12, 64, SMS)
    assert p == {"path": 3, "units": 49152, "qtiles": 1, "threads": 128, "smem": 112640,
                 "blocks": 264}
    assert {len(w) for w in _deal(p)} == {46, 47}
    assert bert_attn_cuda._plan_attention_masked_bf16(4096, 32, 32, 12, 64, True, SMS) == p
    assert bert_attn_cuda._plan_attn_block_bf16(4096, 32, 768, 12, SMS)["attention"] == p
    p64 = bert_attn_cuda._plan_attention_bf16(4096, 64, 12, 64, SMS)
    assert p64["smem"] == 223232 and p64["blocks"] == SMS


@pytest.mark.parametrize("B", [1, 16, 63, 64, 300, 4096])
@pytest.mark.parametrize("L", [1, 8, 32, 64])
def test_bf16_attention_takes_the_walk_where_the_units_fill_the_card(B, L):
    """At L <= 64 the walk (path 3) from ``_WALK_MIN_UNITS`` units on, the
    block-a-unit kernel (path 0) below: serving (B=1) and evaluation
    batches (B=16) keep the first port's kernel; at 12 heads the edge lies
    between B=63 and B=64."""
    p = bert_attn_cuda._plan_attention_bf16(B, L, 12, 64, SMS)
    walk = 12 * B >= bert_attn_cuda._WALK_MIN_UNITS
    assert p["path"] == (3 if walk else 0)
    if not walk:
        assert p == {"path": 0, "units": 12 * B, "qtiles": 1, "threads": 128, "smem": 0,
                     "blocks": 12 * B}


@pytest.mark.parametrize("tq,tk,D,aligned,walk", [
    (32, 32, 64, True, True), (50, 32, 64, True, True), (64, 64, 64, True, True),
    (1, 1, 8, True, True), (9, 40, 24, True, True), (33, 17, 64, True, True),
    (32, 32, 64, False, False),            # an operand off a 16-byte boundary
    (32, 32, 25, True, False),             # D not a multiple of 8 (the MOSEI heads)
    (50, 32, 25, True, False), (32, 32, 12, True, False),
    (65, 32, 64, True, False), (32, 65, 64, True, False), (512, 512, 64, True, False),
    (32, 32, 72, True, False), (32, 32, 128, True, False)])
def test_masked_bf16_plan_takes_the_walk_only_where_it_fits(tq, tk, D, aligned, walk):
    """K8.bf16 takes the walk only at Tq, Tk <= 64 with D a multiple of 8
    up to 64 and 16-byte aligned operands; elsewhere no walk plan, and the
    float32 plan (``_plan_attention`` with ``Lk=Tk``) that the float32 HARD
    kernels take the bf16 rows by."""
    p = bert_attn_cuda._plan_attention_masked_bf16(3, tq, tk, 12, D, aligned, SMS)
    assert (p is not None) == walk
    if walk:
        assert p == bert_attn_cuda._plan_walk(36, tq, tk, SMS)
        assert p["smem"] == min(4, 36) * 2 * _slot_bytes(tq, tk) <= MAX_SMEM
        ints, _ = bert_attn_cuda._cached_plan_masked_bf16(3, tq, tk, 12, D, aligned, SMS)
        assert list(ints) == [p[k] for k in bert_attn_cuda._AB_PLAN_KEYS]
    else:
        assert bert_attn_cuda._cached_plan_masked_bf16(3, tq, tk, 12, D, aligned, SMS) is None
        if D <= 128:
            f = bert_attn_cuda._plan_attention(3, tq, 12, D, SMS, aligned, Lk=tk)
            assert f["path"] == (0 if max(tq, tk) <= 64 else 1)


def _exact_sum(parts):
    return sum(t.double() for t in parts)


def test_three_term_split_reconstructs_p():
    """10^6 float32 values in (0, 1] (numpy seed 0): hi + mid + lo, summed
    exactly, is each value, and every term is a bf16 value; the kernel's
    products of these terms with bf16 v are exact in float32."""
    rng = np.random.default_rng(0)
    p = torch.from_numpy((1.0 - rng.random(10 ** 6)).astype(np.float32))
    assert float(p.min()) > 0 and float(p.max()) <= 1
    hi, mid, lo = attention_cuda.split_bf16_3(p)
    assert all(t.dtype == torch.bfloat16 for t in (hi, mid, lo))
    assert torch.equal(_exact_sum((hi, mid, lo)), p.double())
    assert torch.equal(hi.float(), p.to(torch.bfloat16).float())


def test_three_term_split_bound_near_the_subnormals():
    """Exact from 2^-110 up; below it within 2^-134 (half of bf16's smallest
    subnormal step), over every binade down to float32's smallest
    subnormal and the softmax's extremes 1 and the masked 0."""
    rng = np.random.default_rng(1)
    bits = rng.integers(1, 0x3F800001, size=2 * 10 ** 5, dtype=np.int64).astype(np.uint32)
    p = torch.from_numpy(np.concatenate([bits.view(np.float32),
                                         np.array([0.0, 1.0, 2.0 ** -110, 2.0 ** -149],
                                                  np.float32)]))
    err = (_exact_sum(attention_cuda.split_bf16_3(p)) - p.double()).abs()
    exact = p >= 2.0 ** -110
    assert int(exact.sum()) > 10 ** 5 and float(err[exact].max()) == 0.0
    assert float(err.max()) <= 2.0 ** -134
