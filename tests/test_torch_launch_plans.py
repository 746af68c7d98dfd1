"""Launch plans of the port's K1f and attention kernels, on the CPU.

The CUDA kernels run only on the card, but their launch plans are computed
in Python (``ops.bigru_cuda._plan_gru_fwd``, ``ops.bert_attn_cuda.
_plan_attention``) and handed to ``csrc/bigru.cu`` / ``csrc/bert_attn.cu``
as given.  These tests hold every plan the model's shapes can produce to
what an H100 takes: at most 232,448 bytes of shared memory and 1,024
threads a block (256 for the tiled GRU recurrence, its launch bound), the
shared-memory carve-up the kernels make, and the grids the design asks for:
the B=4096 recurrence in one wave of 132 SMs, a persistent attention grid
no larger than the card holds at once.
"""

import pytest

from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda, bigru_cuda

MAX_SMEM = 232448
SM_SMEM = 233472   # an SM's shared memory; each resident block reserves 1 KB more
SMS = 132


def _gru_rec_smem(plan, H):
    """csrc/bigru.cu's carve-up, in bytes: the small form's hs [2][hp]
    (W_hh^T and the gate values in registers), or the tiled form's W_hh^T
    [3][H][hp], hT [2][hp][R+4] and gs [2][12][threads] float4s."""
    hp, R = plan["hp"], plan["rec_rows"]
    if plan["rec_small"]:
        return 4 * 2 * hp
    return 4 * (3 * H * hp + 2 * hp * (R + 4) + 2 * 12 * 4 * plan["rec_threads"])


@pytest.mark.parametrize("in_dim,H", [(768, 100), (512, 100), (200, 100), (7, 12), (20, 13)])
def test_gru_fwd_plans_fit_the_card(in_dim, H):
    for T in (1, 8, 32, 50, 64):
        for B in (1, 2, 8, 31, 33, 131, 132, 133, 264, 528, 529, 600, 1000, 4095, 4096,
                  5000):
            p = bigru_cuda._plan_gru_fwd(T, B, in_dim, H)
            assert p["hp"] % 4 == 0 and H <= p["hp"] < H + 4
            assert p["rec_smem"] == _gru_rec_smem(p, H) <= MAX_SMEM
            # gemm_tc.cuh: the wgmma GEMM (a 4-stage ring of A [128][32] and two
            # B planes [152][32], + 1 KB to align the swizzle atoms; B's TF32
            # planes in scratch) or TcSmall (a 3-stage ring of A [64][36] and
            # B [32][72])
            if p["gemm_wgmma"]:
                assert p["gemm_vec"] == 1 and p["gemm_splits"] == 1
                assert p["gemm_smem"] == 4 * 4 * (128 * 32 + 2 * 152 * 32) + 1024 <= MAX_SMEM
                assert p["gemm_scratch"] == 2 * 3 * H * in_dim
            else:
                assert p["gemm_smem"] == 4 * 3 * (64 * 36 + 32 * 72) <= MAX_SMEM
                # k ranges of >= 3 tiles of 32, no more blocks than two an SM
                splits, ktiles = p["gemm_splits"], -(-in_dim // 32)
                blocks = -(-T * B // 64) * -(-3 * H // 64)
                assert 1 <= splits <= 8
                assert splits == 1 or (ktiles // splits >= 3 and blocks * splits <= 2 * SMS)
                assert p["gemm_scratch"] == (splits * T * B * 3 * H if splits > 1 else 0)
            assert p["gemm_vec"] == int(in_dim % 4 == 0 and H % 4 == 0)
            assert p["rec_blocks"] * p["rec_rows"] >= B > (p["rec_blocks"] - 1) * p["rec_rows"]
            if p["rec_small"]:
                # a block a row; 8 lanes a column, each holding <= 13 W terms
                assert p["rec_rows"] == 1 and p["rec_ks"] == 8 and B <= SMS
                assert -(-H // p["rec_ks"]) <= 13
                assert p["rec_threads"] % 32 == 0
                assert H * p["rec_ks"] <= p["rec_threads"] <= 832
            else:
                assert p["rec_rows"] % 4 == 0     # 4 x 4 thread tiles
                assert p["rec_threads"] == (p["rec_rows"] // 4) * (p["hp"] // 4) <= 256
                assert p["rec_vec"] == int(H % 4 == 0)
            if B == 4096 and H == 100:
                assert p["rec_blocks"] <= SMS and p["rec_rows"] == 32   # one wave
            if T * B >= 50 * 4096:      # the training shape: wgmma where it can copy 16 bytes
                assert p["gemm_wgmma"] == p["gemm_vec"]
            if T * B <= 64 * 8:         # serving: 64 x 64 mma.sync tiles, more blocks
                assert p["gemm_wgmma"] == 0
            if T * B <= 64 and in_dim == 768:   # B=1: 8 splits of 3 k tiles
                assert p["gemm_splits"] == 8


def test_gru_fwd_plan_unaligned_inputs_take_4_byte_copies():
    assert bigru_cuda._plan_gru_fwd(50, 8, 768, 100, aligned=False)["gemm_vec"] == 0
    assert bigru_cuda._plan_gru_fwd(50, 8, 768, 100)["gemm_vec"] == 1
    assert bigru_cuda._plan_gru_fwd(50, 4096, 768, 100, aligned=False)["gemm_wgmma"] == 0
    assert bigru_cuda._plan_gru_fwd(50, 4096, 768, 100)["gemm_wgmma"] == 1


def test_gru_fwd_plan_refuses_what_shared_memory_cannot_hold():
    with pytest.raises(ValueError, match="shared memory"):
        bigru_cuda._plan_gru_fwd(50, 4096, 768, 200)


def _attention_smem(p):
    """csrc/bert_attn.cu's carve-up, in bytes: the unit path's two (q, k, v,
    mask) buffers and [4][8][krows] probabilities, or the tiled path's q
    tile, two (k, v, mask) buffers and [4][8][64] probabilities."""
    ldk, qrows, krows = p["ldk"], p["qrows"], p["krows"]
    if p["path"] == 0:
        return 4 * (2 * ((qrows + 2 * krows) * ldk + krows) + 4 * 8 * krows)
    return 4 * (32 * ldk + 2 * (2 * 64 * ldk + 64) + 4 * 8 * 64)


@pytest.mark.parametrize("dh", [8, 12, 25, 32, 63, 64, 100, 128])
def test_attention_plans_fit_the_card(dh):
    for B in (1, 3, 8, 4096):
        for L in range(1, 513):
            p = bert_attn_cuda._plan_attention(B, L, 12, dh)
            units = B * 12
            assert p["smem"] == _attention_smem(p) <= MAX_SMEM
            assert p["dp"] % 4 == 0 and dh <= p["dp"] < dh + 4
            assert p["ldk"] >= p["dp"] and (p["ldk"] // 4) % 2 == 1   # conflict-free rows
            assert p["nc"] in (1, 2, 4) and 32 * p["nc"] >= p["dp"]
            assert p["vec"] == int(dh % 4 == 0)
            if L <= 64:
                assert p["path"] == 0
                assert p["qrows"] >= L and p["qrows"] % 8 == 0
                assert p["krows"] == (32 if L <= 32 else 64)
                # a persistent grid that is resident at once
                per_sm = -(-p["blocks"] // SMS)
                assert 1 <= p["blocks"] <= units and per_sm <= 4
                assert per_sm * (p["smem"] + 1024) <= SM_SMEM
            else:
                assert p["path"] == 1 and p["blocks"] == units * -(-L // 32)


def test_attention_plan_at_the_training_shape():
    p = bert_attn_cuda._plan_attention(4096, 32, 12, 64)
    assert p["path"] == 0 and p["vec"] == 1 and p["blocks"] == 4 * SMS
    assert p["ldk"] == 68 and p["nc"] == 2


def test_attention_plan_refuses_wide_heads():
    with pytest.raises(ValueError, match="head_dim"):
        bert_attn_cuda._plan_attention(1, 8, 6, 129)
