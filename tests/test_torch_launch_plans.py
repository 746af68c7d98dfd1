"""Launch plans of the port's K1f, K1b, K3, K6b, K7f, K7b, K9f / K9b,
attention (K6a, K2, K8) and flash (K5f, K5dkv, K5dq, K5b) kernels, on the CPU.

The CUDA kernels run only on the card, but their launch plans are computed
in Python (``ops.bigru_cuda._plan_gru_fwd``, ``_plan_gru_bwd``,
``_plan_rec_bwd`` and ``_plan_recurrence``, ``ops.gru_cuda.
_plan_gru_rec_bwd``, ``ops.bert_ffn_cuda._plan_ffn`` and ``_plan_proj_ln``,
``ops.bert_attn_cuda._plan_attention``, ``ops.attention_cuda.
_plan_flash_fwd``, ``_plan_flash_dkv``, ``_plan_flash_dq`` and
``_plan_flash_bwd``,
``ops.trunk_block_cuda._plan_block``) and handed to
``csrc/bigru.cu`` / ``csrc/bigru_bwd.cu`` / ``csrc/bert_ffn.cu`` /
``csrc/gru_recurrence.cu`` / ``csrc/bert_attn.cu`` / ``csrc/flash_attn.cu``
/ ``csrc/trunk_block.cu`` as given.  These tests hold every plan the model's shapes can produce to
what an H100 takes: at most 232,448 bytes of shared memory and 1,024
threads a block (256 for the tiled GRU recurrence, its launch bound), the
shared-memory carve-up the kernels make, and the grids the design asks for:
the B=4096 recurrences (K1f's and K1b's) in one wave of 132 SMs and
K7f's and K7b's G=2 N=4096 in two, the BERT FFN's and the o-projection's
(K2's and K6b's, one plan) products on the wgmma tiles at the training rows
and split over K at the serving rows,
persistent attention, flash-forward and flash-backward grids no larger than
the card holds at once, K8's and K5f's unit path at Tq, Tk <= 64 and tiled
path beyond, the flash backward's choice between its fused kernel (Tq, Tk
<= 64) and the pair, and K9's products split over K across the card at the serving rows,
its backward recomputing the hidden activation by the forward's plan.
The bf16 instances' plans (``ops.gemm_tc.plan_bf16`` under
``_plan_gru_fwd_bf16``, ``_plan_gru_bwd_bf16``, ``_plan_attn_block_bf16``
and ``_plan_ffn_bf16``) are held to ``csrc/gemm_bf16.cuh``'s tile: k steps
of 16-deep MMAs, two blocks an SM within its shared memory, k ranges that
cover every k tile; the bf16 attention's paths (``_plan_attention_bf16``:
the row path's grid, threads and shared memory) and K1f.bf16's recurrence
forms (``_plan_recurrence_bf16``: small, mma or tiled; row groups that
cover B) to what ``csrc/bert_attn.cu`` and ``csrc/gru_rec.cuh`` take.
"""

import ctypes

import pytest
import torch

from multimodal_transformer_robustness_tpu_torch import _build
from multimodal_transformer_robustness_tpu_torch.ops import (attention_cuda, bert_attn_cuda,
                                                              bert_ffn_cuda, bigru_cuda,
                                                              gemm_tc, gru_cuda,
                                                              trunk_block_cuda)

MAX_SMEM = 232448
SM_SMEM = 233472   # an SM's shared memory; each resident block reserves 1 KB more
SMS = 132


def _gru_rec_smem(plan, H):
    """csrc/gru_rec.cuh's carve-up, in bytes: the small form's hs [2][hp]
    and b_hr, b_hz [2][hp] (W_hh^T and the gate values in registers), or the
    tiled form's W_hh^T [3][H][hp], hT [2][hp][R+4] and gs [2][12][threads]
    float4s."""
    hp, R = plan["hp"], plan["rec_rows"]
    if plan["rec_small"]:
        return 4 * 4 * hp
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


@pytest.mark.parametrize("G,N,H", [(2, 4096, 100), (2, 1, 100), (3, 300, 13), (2, 66, 100),
                                   (2, 67, 100), (1, 5000, 100), (3, 7, 12), (2, 4096, 104)])
def test_gru_rec_plans_fit_the_card(G, N, H):
    """K7f's plan (K1f's recurrence over G groups): the small form while G*N
    fits one block an SM and H <= 104, else the tiled form, whose W_hh^T
    allows one block an SM, in the fewest waves and the fewest rows that
    give them."""
    p = bigru_cuda._plan_recurrence(G, N, H)
    assert p["rec_smem"] == _gru_rec_smem(p, H) <= MAX_SMEM
    assert p["rec_blocks"] * p["rec_rows"] >= N > (p["rec_blocks"] - 1) * p["rec_rows"]
    blocks = G * p["rec_blocks"]
    if p["rec_small"]:
        assert G * N <= SMS and H <= 104 and blocks == G * N
        assert H * p["rec_ks"] <= p["rec_threads"] <= 832
    else:
        assert G * N > SMS or H > 104
        assert p["rec_rows"] % 4 == 0 and p["rec_threads"] <= 256
        if H >= 100:   # W_hh^T alone leaves room for one block an SM
            assert p["rec_smem"] + 1024 > SM_SMEM // 2
        waves = -(-blocks // SMS)
        if p["rec_rows"] > 4:   # fewer rows would take another wave
            assert G * -(-N // (p["rec_rows"] - 4)) > waves * SMS


def test_gru_rec_plan_at_the_mosei_header_level():
    """G=2 directions of N=4096 rows, H=100: 32-row blocks, 256 of them,
    two full waves of the card's 132 SMs (64-row blocks, one wave, need
    328,000 bytes of shared memory and 400 threads); the serving shape
    N=1 takes the small form; H > 104 never does."""
    p = bigru_cuda._plan_recurrence(2, 4096, 100)
    assert (p["rec_small"], p["rec_rows"], p["rec_blocks"]) == (0, 32, 128)
    assert 2 * p["rec_blocks"] > SMS and -(-2 * p["rec_blocks"] // SMS) == 2
    assert p["rec_smem"] == 225600 and p["rec_vec"] == 1
    assert 4 * (3 * 100 * 100 + 8 * 64 * 100 + 8 * 100) > MAX_SMEM
    assert bigru_cuda._plan_recurrence(2, 1, 100)["rec_small"] == 1
    for H in (105, 112, 128):
        assert bigru_cuda._plan_recurrence(2, 1, H)["rec_small"] == 0
    assert bigru_cuda._plan_recurrence(2, 4096, 100, aligned=False)["rec_vec"] == 0


def test_gru_fwd_plan_refuses_what_shared_memory_cannot_hold():
    with pytest.raises(ValueError, match="shared memory"):
        bigru_cuda._plan_gru_fwd(50, 4096, 768, 200)


def _check_product(p, M, N, K):
    """A gemm_tc.cuh product plan: the wgmma tiles (a 4-stage ring of A
    [128][32] and B's two TF32 planes [bn][32], + 1 KB; B's planes in
    scratch) only with 16-byte copies and two blocks an SM, else the 64 x
    64 mma.sync tiles over k ranges of >= 3 tiles of 32, none empty, no
    more blocks than two an SM; every block within the card's shared
    memory."""
    assert p["bn"] in gemm_tc.WG_WIDTHS and p["bn"] % 8 == 0
    if p["wgmma"]:
        assert p["vec"] == 1 and p["splits"] == 1
        assert -(-M // 128) * -(-N // p["bn"]) >= 2 * SMS
        assert p["smem"] == 4 * 4 * (128 * 32 + 2 * p["bn"] * 32) + 1024 <= MAX_SMEM
        assert p["scratch"] == 2 * N * K
    else:
        assert p["smem"] == 4 * 3 * (64 * 36 + 32 * 72) <= MAX_SMEM
        ktiles, blocks = -(-K // 32), -(-M // 64) * -(-N // 64)
        kps = -(-ktiles // p["splits"])
        assert 1 <= p["splits"] and (p["splits"] - 1) * kps < ktiles   # no empty range
        assert p["splits"] == 1 or (ktiles // p["splits"] >= 3
                                    and blocks * p["splits"] <= 2 * SMS)
        assert p["scratch"] == (p["splits"] * M * N if p["splits"] > 1 else 0)


@pytest.mark.parametrize("h,ffn", [(768, 3072), (32, 128), (36, 100), (30, 70), (76, 300)])
def test_ffn_plans_fit_the_card(h, ffn):
    for rows in (1, 7, 8, 32, 64, 128, 512, 513, 1000, 4096, 9001, 131072):
        p = bert_ffn_cuda._plan_ffn(rows, h, ffn)
        _check_product(p["fc1"], rows, ffn, h)
        _check_product(p["fc2"], rows, h, ffn)
        # the promoted wgmma instances exist at 104 and 128 only (152 spills)
        assert p["fc1"]["bn"] in (104, 128) and p["fc2"]["bn"] in (104, 128)
        assert p["fc1"]["vec"] == p["fc2"]["vec"] == int(h % 4 == 0 and ffn % 4 == 0)
        assert p["fused_ln"] == int(not p["fc2"]["wgmma"] and p["fc2"]["splits"] > 1)
        assert p["scratch"] == max(p["fc1"]["scratch"], p["fc2"]["scratch"])


def test_ffn_plan_at_the_bert_shapes():
    """BERT-base width: at the training rows (B=4096, L=32) both products
    take the wgmma tiles, 128 wide (no column tile more than half empty:
    none is empty at all); at the serving rows (B=1, L=8) the mma.sync tiles
    split over K, fc2's 96 k tiles into 20 ranges of 5 (240 blocks, not
    12), its planes summed by the LayerNorm's launch."""
    p = bert_ffn_cuda._plan_ffn(131072, 768, 3072)
    for fc, n in (("fc1", 3072), ("fc2", 768)):
        assert p[fc]["wgmma"] == 1 and p[fc]["bn"] == 128
        assert -(-n // p[fc]["bn"]) * p[fc]["bn"] - n < p[fc]["bn"] // 2
    assert p["fused_ln"] == 0 and p["scratch"] == 2 * 768 * 3072
    p = bert_ffn_cuda._plan_ffn(8, 768, 3072)
    assert p["fc1"]["wgmma"] == p["fc2"]["wgmma"] == 0
    assert p["fc2"]["splits"] == 20 and p["fc2"]["splits"] * 12 >= SMS
    assert p["fc1"]["splits"] * 48 >= SMS
    assert p["fused_ln"] == 1
    assert bert_ffn_cuda._plan_ffn(9001, 768, 3072)["fc2"]["wgmma"] == 1   # a ragged row tile


def test_ffn_plan_unaligned_operands_take_4_byte_copies():
    for rows in (8, 131072):
        p = bert_ffn_cuda._plan_ffn(rows, 768, 3072, aligned=False)
        for fc in ("fc1", "fc2"):
            assert p[fc]["vec"] == 0 and p[fc]["wgmma"] == 0


@pytest.mark.parametrize("n,bn", [(300, 152), (3072, 128), (768, 128), (200, 104), (400, 104)])
def test_wgmma_width_wastes_less_than_half_a_tile(n, bn):
    assert gemm_tc.wgmma_width(n) == bn
    assert -(-n // bn) * bn - n < bn // 2


def _gru_bwd_smem(p, H):
    """csrc/gru_rec.cuh's backward carve-up, in bytes: W_hh^T [3][4 js][wp],
    h_prev [2][4 js][rows + 4] and da [3][4 js][rows + 4]."""
    hk = 4 * p["js"]
    return 4 * (3 * hk * p["wp"] + 5 * hk * (p["rows"] + 4))


@pytest.mark.parametrize("in_dim,H", [(768, 100), (512, 100), (200, 100), (7, 12), (20, 13),
                                      (20, 16)])
def test_gru_bwd_plans_fit_the_card(in_dim, H):
    for T in (1, 5, 8, 50):
        for B in (1, 3, 64, 67, 132, 528, 529, 4095, 4096, 5000):
            for need_dx in (True, False):
                p = bigru_cuda._plan_gru_bwd(T, B, in_dim, H, need_dx)
                # 4 rows by 4 strided columns a thread; an odd W pitch
                assert p["js"] == -(-H // 4) and p["wp"] % 2 == 1 and p["wp"] >= 4 * p["js"]
                assert p["rows"] % 4 == 0 and p["threads"] == p["rows"] // 4 * p["js"] <= 256
                assert p["smem"] == _gru_bwd_smem(p, H) <= MAX_SMEM
                assert p["blocks"] * p["rows"] >= B > (p["blocks"] - 1) * p["rows"]
                if p["rows"] > 4:   # fewer rows would take another wave
                    assert -(-B // (p["rows"] - 4)) > -(-p["blocks"] // SMS) * SMS
                assert p["tn_vec"] == int(in_dim % 4 == 0 and H % 4 == 0)
                # the reductions: no empty k range, one wave of two blocks an SM
                for name, m, n in (("dwp", in_dim, 3 * H), ("dwt", H + 1, 4 * H)):
                    splits, kps, ktiles = p[f"{name}_splits"], p[f"{name}_kps"], -(-T * B // 32)
                    assert (splits - 1) * kps < ktiles <= splits * kps
                    assert splits == 1 or splits * -(-m // 128) * -(-n // 80) <= 2 * SMS
                assert p["partial"] == (p["dwp_splits"] * in_dim * 3 * H
                                        + p["dwt_splits"] * (H + 1) * 4 * H)
                if need_dx:
                    _check_product({k: p[f"dx_{k}"] for k in ("wgmma", "vec", "splits", "bn",
                                                              "smem", "scratch")},
                                   T * B, in_dim, 3 * H)
                else:
                    assert all(p[f"dx_{k}"] == 0 for k in ("wgmma", "vec", "splits", "bn",
                                                          "smem", "scratch"))


def test_gru_bwd_plan_at_the_training_shapes():
    """B=4096 H=100: 32-row blocks, 128 of them, one wave of the card's
    132 SMs (28-row blocks would need 147); dx only at the header's second
    level (in=200), on the wgmma tiles 104 wide (two tiles over 200); the
    small batches take 4-row blocks, one wave."""
    for in_dim, need_dx in ((768, False), (512, False), (200, True)):
        p = bigru_cuda._plan_gru_bwd(50, 4096, in_dim, 100, need_dx)
        assert (p["rows"], p["threads"], p["blocks"], p["js"], p["wp"]) == (32, 200, 128, 25,
                                                                            101)
        assert p["smem"] == 193200 and p["tn_vec"] == 1
        assert p["dx_wgmma"] == int(need_dx) and p["dx_bn"] == (104 if need_dx else 0)
    for B in (1, 64, 67):
        p = bigru_cuda._plan_gru_bwd(8, B, 768, 100, True)
        assert p["rows"] == 4 and p["blocks"] == -(-B // 4) <= SMS
    assert bigru_cuda._plan_gru_bwd(50, 4096, 768, 100, False, aligned=False)["tn_vec"] == 0
    # the reductions' plan counts on two of their blocks an SM
    assert gemm_tc.TN_BLOCKS_PER_SM * (gemm_tc.TN_SMEM + 1024) <= SM_SMEM


def test_gru_bwd_plan_refuses_what_shared_memory_cannot_hold():
    with pytest.raises(ValueError, match="shared memory"):
        bigru_cuda._plan_gru_bwd(50, 4096, 768, 200, False)


# K1b's plan ints (BWD_PLAN_KEYS, then partial and dx_scratch) before its
# recurrence plan took a group axis: at the training shapes and a few
# small ones, and a sha256 over every shape test_gru_bwd_plans_fit_the_card
# walks
_K1B_PLAN_INTS = {
    (50, 4096, 768, 100, False): (32, 200, 193200, 25, 101, 1, 11, 582, 52, 124, 0, 0, 0, 0,
                                  4635200, 0),
    (50, 4096, 512, 100, False): (32, 200, 193200, 25, 101, 1, 16, 400, 52, 124, 0, 0, 0, 0,
                                  4558400, 0),
    (50, 4096, 200, 100, True): (32, 200, 193200, 25, 101, 1, 33, 194, 52, 124, 1, 1, 1, 104,
                                 4080800, 120000),
    (8, 1, 768, 100, True): (4, 25, 137200, 25, 101, 1, 1, 1, 1, 1, 0, 1, 3, 128, 270800,
                             18432),
    (5, 67, 20, 13, True): (4, 4, 5824, 4, 17, 0, 11, 1, 11, 1, 0, 0, 1, 104, 16588, 0),
    (1, 529, 7, 12, False): (8, 6, 4752, 3, 13, 0, 17, 1, 17, 1, 0, 0, 0, 0, 14892, 0),
}
_K1B_PLAN_SHA256 = "573410004a378068128f240b18f6cea84b87588f2f71d204b675c0757cb6510a"


def test_gru_bwd_plan_ints_stay_as_they_were():
    """K1b's plan through the G-group recurrence plan (G = 1) gives the same
    ints as before, so K1b launches as it did."""
    import hashlib

    keys = bigru_cuda.BWD_PLAN_KEYS + ("partial", "dx_scratch")

    def ints(*args):
        p = bigru_cuda._plan_gru_bwd(*args)
        return [p[k] for k in keys]

    for args, want in _K1B_PLAN_INTS.items():
        assert tuple(ints(*args)) == want, args
    digest = hashlib.sha256()
    for in_dim, H in ((768, 100), (512, 100), (200, 100), (7, 12), (20, 13), (20, 16)):
        for T in (1, 5, 8, 50):
            for B in (1, 3, 64, 67, 132, 528, 529, 4095, 4096, 5000):
                for need_dx in (True, False):
                    digest.update(repr(ints(T, B, in_dim, H, need_dx)).encode())
    assert digest.hexdigest() == _K1B_PLAN_SHA256


@pytest.mark.parametrize("G,N,H", [(2, 4096, 100), (1, 4096, 100), (2, 1, 100), (3, 300, 13),
                                   (3, 40, 13), (2, 264, 100), (2, 265, 100), (3, 7, 12),
                                   (2, 5000, 101), (4, 133, 100), (3, 176, 99)])
def test_gru_rec_bwd_plans_fit_the_card(G, N, H):
    """K7b's plan: a block a (row, group) while G*N fills at most four waves
    of one block an SM, its weights, biases and row state within a block's
    shared memory; else
    the tiled backward recurrence over G groups (bigru_cuda._plan_rec_bwd,
    K1b's form): 4 rows by 4 strided columns a thread, within the launch
    bound and the carve-up, in the fewest waves of one block an SM and the
    fewest rows that give them."""
    p = gru_cuda._plan_gru_rec_bwd(G, N, H)
    if p["row"]:
        assert G * N <= 4 * SMS and p["rows"] == 1 and p["blocks"] == G * N
        assert p["smem"] == 4 * (3 * H * (H + 1) + 3 * H + 8 * H) <= MAX_SMEM
        assert 3 * H <= p["threads"] <= 1024 and p["threads"] % 32 == 0
    else:
        assert G * N > 4 * SMS
        assert p == {"row": 0, **bigru_cuda._plan_rec_bwd(G, N, H)}
        assert p["js"] == -(-H // 4) and p["wp"] % 2 == 1 and p["wp"] >= 4 * p["js"]
        assert p["rows"] % 4 == 0 and p["threads"] == p["rows"] // 4 * p["js"] <= 256
        assert p["smem"] == _gru_bwd_smem(p, H) <= MAX_SMEM
        per_group = -(-N // p["rows"])
        assert p["blocks"] == G * per_group and per_group * p["rows"] >= N
        if p["rows"] > 4:   # fewer rows would take another wave
            assert G * -(-N // (p["rows"] - 4)) > -(-p["blocks"] // SMS) * SMS


def test_gru_rec_bwd_plan_at_the_mosei_header_level():
    """G=2 directions of N=4096 rows, H=100: 40-row blocks fit the 256-thread
    bound (shared memory would allow 48), but give 206 blocks, already two
    waves, so 32 rows: 256 blocks, two waves of one block an SM.  G=1
    B=4096 is K1b's one wave of 128 32-row blocks."""
    p = bigru_cuda._plan_rec_bwd(2, 4096, 100)
    assert (p["rows"], p["threads"], p["blocks"], p["js"], p["wp"]) == (32, 200, 256, 25, 101)
    assert -(-p["blocks"] // SMS) == 2 and -(-2 * -(-4096 // 40) // SMS) == 2
    assert 40 // 4 * 25 <= 256 < 44 // 4 * 25
    assert _gru_bwd_smem(dict(p, rows=48), 100) <= MAX_SMEM < _gru_bwd_smem(dict(p, rows=52), 100)
    p = bigru_cuda._plan_rec_bwd(1, 4096, 100)
    assert (p["rows"], p["blocks"]) == (32, 128) and p["blocks"] <= SMS
    assert gru_cuda._plan_gru_rec_bwd(2, 4096, 100)["row"] == 0
    assert gru_cuda._plan_gru_rec_bwd(2, 1, 100)["row"] == 1
    # the row form up to four waves (2 * 264 = 4 * 132 rows), one block an SM
    p = gru_cuda._plan_gru_rec_bwd(2, 264, 100)
    assert (p["row"], p["threads"], p["smem"]) == (1, 320, 125600)
    assert p["smem"] + 1024 > SM_SMEM // 2
    assert gru_cuda._plan_gru_rec_bwd(2, 265, 100)["row"] == 0
    p = bigru_cuda._plan_rec_bwd(3, 300, 13)
    assert (p["js"], p["wp"]) == (4, 17) and p["smem"] <= MAX_SMEM


def test_gru_rec_bwd_plan_refuses_what_shared_memory_cannot_hold():
    for G in (1, 2):
        with pytest.raises(ValueError, match="4-row tile"):
            bigru_cuda._plan_rec_bwd(G, 4096, 140)
        with pytest.raises(ValueError, match="shared memory"):
            gru_cuda._plan_gru_rec_bwd(G, 4096, 140)
    with pytest.raises(ValueError, match="shared memory"):
        gru_cuda._plan_gru_rec_bwd(2, 1, 300)


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


@pytest.mark.parametrize("D", [8, 25, 64, 128])
def test_masked_plans_take_the_unit_path_up_to_64(D):
    """K8 at Tq, Tk <= 64: K6a's unit path over [B, H, T, D] slices
    (``_plan_attention`` with ``Lk``), a persistent grid resident at once,
    shared memory within the card's."""
    for B, H in ((1, 12), (3, 2), (4096, 12)):
        units = B * H
        for tq in range(1, 65):
            for tk in (1, 7, 8, 31, 32, 33, 50, 63, 64):
                p = bert_attn_cuda._plan_attention(B, tq, H, D, Lk=tk)
                assert p["path"] == 0
                assert p["smem"] == _attention_smem(p) <= MAX_SMEM
                assert p["qrows"] >= tq and p["qrows"] % 8 == 0
                assert p["krows"] == (32 if tk <= 32 else 64)
                assert p["vec"] == int(D % 4 == 0)
                per_sm = -(-p["blocks"] // SMS)
                assert 1 <= p["blocks"] <= units and per_sm <= 4
                assert per_sm * (p["smem"] + 1024) <= SM_SMEM


def test_masked_plan_at_the_bert_shapes():
    """The training bucket (B=4096, L=32, 12 heads of 64): K6a's own plan,
    four blocks an SM; the trunk's D=25 heads take the 4-byte copy form, as
    do q, k, v that are not 16-byte aligned."""
    p = bert_attn_cuda._plan_attention(4096, 32, 12, 64, Lk=32)
    assert p == bert_attn_cuda._plan_attention(4096, 32, 12, 64)
    assert p["path"] == 0 and p["vec"] == 1 and p["blocks"] == 4 * SMS
    for tq, tk in ((9, 17), (50, 32), (64, 64)):
        p = bert_attn_cuda._plan_attention(2, tq, 3, 25, Lk=tk)
        assert p["path"] == 0 and p["vec"] == 0 and (p["dp"], p["ldk"]) == (28, 28)
    assert bert_attn_cuda._plan_attention(8, 32, 12, 64, aligned=False, Lk=32)["vec"] == 0


@pytest.mark.parametrize("tq,tk", [(65, 65), (64, 65), (65, 64), (1, 512), (512, 512)])
def test_masked_plan_takes_the_tiled_path_past_64(tq, tk):
    """Tq or Tk > 64: the tiled path, a block per (unit, 32 queries), over
    64-key tiles (K6a's L > 64 branch, faster than K5f's kernel at L=512)."""
    for D in (25, 64):
        p = bert_attn_cuda._plan_attention(1, tq, 12, D, Lk=tk)
        assert p["path"] == 1 and p["blocks"] == 12 * -(-tq // 32)
        assert p["smem"] == _attention_smem(p) <= MAX_SMEM
    with pytest.raises(ValueError, match="head_dim"):
        bert_attn_cuda._plan_attention(1, tq, 12, 129, Lk=tk)


def _flash_bwd_smem(p):
    """csrc/flash_attn.cu's K5b carve-up, in bytes: one slot of q, dO, O
    [qp8][ld], k, v [kp8][ld], lse [qp8] and (seed, rate) padded to 4; the
    M*p tile [qp8][ldp] and the dS tile [16 mq][ldp]."""
    ld, qp8, kp8 = p["ld"], p["qp8"], p["kp8"]
    return 4 * (ld * (3 * qp8 + 2 * kp8) + qp8 + 4 + (qp8 + 16 * p["mq"]) * p["ldp"])


@pytest.mark.parametrize("tq,tk,path", [(1, 1, 0), (1, 64, 0), (64, 1, 0), (50, 32, 0),
                                        (50, 50, 0), (64, 64, 0), (64, 65, 1), (65, 64, 1),
                                        (1, 65, 1), (2048, 2048, 1)])
def test_flash_bwd_plan_picks_the_path_by_shape(tq, tk, path):
    for D in (8, 25, 64, 128):
        assert attention_cuda._plan_flash_bwd(4096 * 8, tq, tk, D)["path"] == path


@pytest.mark.parametrize("D", [8, 25, 64, 128])
def test_flash_bwd_plans_fit_the_card(D):
    for tq in range(1, 65):
        for tk in (1, 7, 8, 9, 20, 32, 33, 50, 63, 64):
            for bh in (1, 6, 264, 32768):
                p = attention_cuda._plan_flash_bwd(bh, tq, tk, D)
                assert p["path"] == 0
                assert p["smem"] == _flash_bwd_smem(p) <= MAX_SMEM
                # k steps / column tiles of 8, rows to 8, 16-row tiles
                assert 4 * p["dp4"] % 8 == 0 and D <= 4 * p["dp4"] < D + 8
                assert p["qp8"] % 8 == 0 and tq <= p["qp8"] < tq + 8
                assert p["kp8"] % 8 == 0 and tk <= p["kp8"] < tk + 8
                assert p["mq"] == -(-tq // 16) and p["mk"] == -(-tk // 16)
                assert p["nk"] * 8 == p["kp8"]
                # the fragments of a 16-row tile read at most 8 rows past qp8,
                # into the next operand of the slot (k holds at least 8 rows)
                assert 16 * p["mq"] <= p["qp8"] + 8 and p["kp8"] >= 8
                # fragment loads free of bank conflicts: ld 4 mod 8 words (g *
                # ld + t distinct banks), ldp 8 mod 32 (8 t + g distinct), the
                # dV / dK fragments' 16 * mk keys inside a tile row
                assert p["ld"] >= 4 * p["dp4"] and p["ld"] % 8 == 4
                assert p["ldp"] % 32 == 8 and p["ldp"] >= max(p["kp8"], 16 * p["mk"])
                # phase 1: a warp a (16-row tile, ng1 key tiles), at most 8 such
                # items where 4 key tiles a warp get there
                assert p["ng1"] in (2, 4)
                assert p["mq"] * -(-p["nk"] // p["ng1"]) <= 8 or p["ng1"] == 4
                # a persistent grid resident at once (the kernel's launch bound:
                # 3 blocks an SM), never more blocks than slices, and as many
                # as fit where the slices are many
                per_sm = -(-p["blocks"] // SMS)
                assert 1 <= p["blocks"] <= bh and per_sm <= 3
                assert per_sm * (p["smem"] + 1024) <= SM_SMEM
                if bh >= 3 * SMS:
                    assert p["blocks"] == min(3, SM_SMEM // (p["smem"] + 1024)) * SMS


def test_flash_bwd_plan_at_the_mosei_shapes():
    cross = attention_cuda._plan_flash_bwd(4096 * 8, 50, 32, 25)
    self_ = attention_cuda._plan_flash_bwd(4096 * 8, 50, 50, 25)
    for p in (cross, self_):
        # D = 25: columns padded to 32 in rows of 36 floats; three blocks an SM
        assert p["ld"] == 36 and p["blocks"] == 3 * SMS
    assert (cross["smem"], cross["ldp"], cross["ng1"]) == (52848, 40, 2)
    assert (self_["smem"], self_["ldp"], self_["ng1"]) == (75120, 72, 4)


def test_flash_bwd_plan_refuses_wide_heads():
    with pytest.raises(ValueError, match="head_dim"):
        attention_cuda._plan_flash_bwd(8, 50, 32, 129)


def _flash_fwd_smem(p):
    """csrc/flash_attn.cu's K5f carve-up, in bytes.  Path 0: two slots of q
    [qp][ld], k and v [kp][ld], then seed and rate padded to 4.  Path 1:
    the ring of 2 stages of 64-key k and v tiles [2][64][ld], then q's hi
    and lo planes [bq][ld]."""
    if p["path"] == 0:
        return 4 * 2 * (p["ld"] * (p["qp"] + 2 * p["kp"]) + 4)
    return 4 * p["ld"] * (2 * 2 * 64 + 2 * p["bq"])


def _flash_dkv_smem(p):
    """csrc/flash_attn.cu's K5dkv carve-up, in bytes: k and v [64][ld], then
    2 stages of query tiles of q and dO [64][ld], lse and delta [64]."""
    return 4 * (2 * 64 * p["ld"] + 2 * (2 * 64 * p["ld"] + 128))


_FLASH_WIDTHS = (1, 8, 25, 64, 128)


@pytest.mark.parametrize("tq,tk,path", [(1, 1, 0), (1, 64, 0), (64, 1, 0), (50, 32, 0),
                                        (50, 50, 0), (64, 64, 0), (65, 65, 1), (1, 130, 1),
                                        (130, 1, 1), (64, 65, 1), (2048, 2048, 1)])
def test_flash_fwd_plan_picks_the_path_by_shape(tq, tk, path):
    """K5f's unit path holds a whole slice (Tq, Tk <= 64); past 64 on
    either side the tiled path walks 64-key tiles."""
    for D in _FLASH_WIDTHS:
        assert attention_cuda._plan_flash_fwd(4096 * 8, tq, tk, D)["path"] == path


@pytest.mark.parametrize("D", _FLASH_WIDTHS)
def test_flash_fwd_plans_fit_the_card(D):
    """Every K5f plan: the padding the tensor-core tiles need, shared memory
    equal to the kernel's carve-up and within the card, the unit path's
    persistent grid resident at once (its launch bound: 4 blocks an SM),
    the tiled path's block a (slice, bq query rows) pair of bq / 16 warps."""
    dt = {1: 1, 8: 1, 25: 4, 64: 8, 128: 16}[D]   # ceil(D / 8) up to a power of two
    for tq in (1, 2, 15, 16, 17, 33, 50, 63, 64, 65, 96, 128, 129, 300, 2048):
        for tk in (1, 7, 8, 9, 32, 50, 64, 65, 130, 2048):
            for bh in (1, 6, 264, 32768):
                p = attention_cuda._plan_flash_fwd(bh, tq, tk, D)
                assert p["smem"] == _flash_fwd_smem(p) <= MAX_SMEM
                # 8-column tiles over D; rows 4 mod 8 floats (conflict-free fragments)
                assert p["dt"] == dt and p["ld"] == 8 * dt + 4 and p["ld"] % 8 == 4
                if p["path"] == 0:
                    # a warp's 16 rows each for 4 warps; 4 or 8 key tiles of 8
                    assert p["threads"] == 128 and p["qp"] == 64 and p["bq"] == 0
                    assert p["kp"] == (32 if tk <= 32 else 64)
                    per_sm = -(-p["blocks"] // SMS)
                    assert 1 <= p["blocks"] <= bh and per_sm <= _build.FU_BLOCKS_PER_SM
                    assert per_sm * (p["smem"] + 1024) <= SM_SMEM
                    if bh >= 4 * SMS:
                        assert p["blocks"] == min(4, SM_SMEM // (p["smem"] + 1024)) * SMS
                else:
                    assert p["bq"] == (128 if D <= 64 else 64)
                    assert p["threads"] == 2 * p["bq"] and p["qp"] == p["kp"] == 0
                    assert p["blocks"] == -(-tq // p["bq"]) * bh


@pytest.mark.parametrize("D", _FLASH_WIDTHS)
def test_flash_fwd_tiled_rows_by_width(D):
    """The tiled path takes 128 query rows a block wherever their carve-up
    fits the card's shared memory, else 64, whose carve-up always fits."""
    ld = attention_cuda._flash_widths(D)[1]
    p = attention_cuda._plan_flash_fwd(128, 2048, 2048, D)
    fits_128 = _flash_fwd_smem(dict(path=1, ld=ld, bq=128)) <= MAX_SMEM
    assert p["bq"] == (128 if fits_128 else 64)
    assert _flash_fwd_smem(dict(path=1, ld=ld, bq=64)) <= MAX_SMEM
    assert p["smem"] == _flash_fwd_smem(p) and p["threads"] == 2 * p["bq"]


def test_flash_fwd_plan_at_the_mosei_and_long_shapes():
    """The plans the flash stacks run: MOSEI self (T=50) and cross (Tq=50,
    Tk=32) at B=4096 x 8 heads of 25, and the long eval at B=16 T=2048."""
    self_ = attention_cuda._plan_flash_fwd(4096 * 8, 50, 50, 25)
    cross = attention_cuda._plan_flash_fwd(4096 * 8, 50, 32, 25)
    long_ = attention_cuda._plan_flash_fwd(16 * 8, 2048, 2048, 25)
    assert self_ == dict(path=0, blocks=4 * SMS, threads=128, smem=55328, dt=4, ld=36, qp=64,
                         kp=64, bq=0)
    assert cross == dict(self_, smem=36896, kp=32)
    assert long_ == dict(path=1, blocks=16 * 128, threads=256, smem=73728, dt=4, ld=36, qp=0,
                         kp=0, bq=128)


@pytest.mark.parametrize("D", _FLASH_WIDTHS)
def test_flash_dkv_plans_fit_the_card(D):
    """K5dkv: a block of 4 warps a (slice, 64 keys) pair; shared memory equal
    to the kernel's carve-up and within the card at every shape."""
    for tq in (1, 50, 64, 65, 96, 300, 2048):
        for tk in (1, 32, 50, 64, 65, 130, 2048):
            p = attention_cuda._plan_flash_dkv(4096 * 8, tq, tk, D)
            assert p["smem"] == _flash_dkv_smem(p) <= MAX_SMEM
            assert p["threads"] == 128 and p["blocks"] == -(-tk // 64) * 4096 * 8
            assert p["dt"] == 1 << (-(-D // 8) - 1).bit_length()
            assert p["ld"] == 8 * p["dt"] + 4


def test_flash_dkv_plan_at_the_long_and_mosei_shapes():
    long_ = attention_cuda._plan_flash_dkv(16 * 8, 2048, 2048, 25)
    assert long_ == dict(blocks=32 * 128, threads=128, smem=56320, dt=4, ld=36)
    for tk in (50, 32):
        assert attention_cuda._plan_flash_dkv(4096 * 8, 50, tk, 25) == dict(
            long_, blocks=4096 * 8)


def _flash_dq_smem(p):
    """csrc/flash_attn.cu's K5dq carve-up, in bytes: the ring of ``stages``
    stages of 64-key k and v tiles [2][64][ld], then the hi and lo planes
    of q and of dO [bq][ld]."""
    return 4 * p["ld"] * (p["stages"] * 2 * 64 + 4 * p["bq"])


@pytest.mark.parametrize("D", _FLASH_WIDTHS)
def test_flash_dq_plans_fit_the_card(D):
    """K5dq: a block of bq / 16 warps a (slice, bq query rows) pair; shared
    memory equal to the kernel's carve-up and within the card; the ring one
    stage where Tk has one key tile, else two; bq the largest power of two
    from 16 to 64 that fits and is no larger than Tq rounded up to one."""
    for tq in (1, 16, 17, 50, 64, 65, 96, 300, 2048):
        for tk in (1, 32, 50, 64, 65, 130, 2048):
            p = attention_cuda._plan_flash_dq(4096 * 8, tq, tk, D)
            assert p["smem"] == _flash_dq_smem(p) <= MAX_SMEM
            assert p["threads"] == 2 * p["bq"] and p["blocks"] == -(-tq // p["bq"]) * 4096 * 8
            assert p["stages"] == (1 if tk <= 64 else 2)
            assert p["dt"] == 1 << (-(-D // 8) - 1).bit_length()
            assert p["ld"] == 8 * p["dt"] + 4
            rows = max(16, 1 << (tq - 1).bit_length())
            fits = [b for b in (64, 32, 16)
                    if b <= rows and _flash_dq_smem(dict(p, bq=b)) <= MAX_SMEM]
            assert p["bq"] == fits[0]


def test_flash_dq_plan_at_the_long_and_mosei_shapes():
    """The plans of the timed shapes: B=16 T=2048 and the MOSEI self (T=50)
    and cross (Tq=50, Tk=32) shapes at B=4096, 8 heads of 25, and one
    query row against 130 keys."""
    long_ = attention_cuda._plan_flash_dq(16 * 8, 2048, 2048, 25)
    assert long_ == dict(blocks=32 * 128, threads=128, smem=73728, dt=4, ld=36, bq=64,
                         stages=2)
    for tk in (50, 32):
        assert attention_cuda._plan_flash_dq(4096 * 8, 50, tk, 25) == dict(
            blocks=4096 * 8, threads=128, smem=55296, dt=4, ld=36, bq=64, stages=1)
    assert attention_cuda._plan_flash_dq(2, 1, 130, 25) == dict(
        blocks=2, threads=32, smem=46080, dt=4, ld=36, bq=16, stages=2)


def test_flash_fwd_and_dkv_plans_refuse_wide_heads():
    for fn in (attention_cuda._plan_flash_fwd, attention_cuda._plan_flash_dkv,
               attention_cuda._plan_flash_dq):
        for tq, tk in ((50, 32), (2048, 2048)):
            with pytest.raises(ValueError, match="head_dim"):
                fn(8, tq, tk, 129)


@pytest.mark.parametrize("h,heads", [(768, 12), (16, 2), (32, 4), (36, 4), (1024, 16)])
def test_attn_block_plans_fit_the_card(h, heads):
    """K2's plan: both products as gemm_tc.cuh plans (q/k/v over N = 3h, the
    o-projection over N = h, both h deep), the attention stage as
    _plan_attention's, within the card's shared memory at every shape."""
    for B, L in ((1, 1), (1, 8), (1, 33), (1, 128), (1, 512), (8, 32), (300, 31),
                 (4096, 32)):
        rows = B * L
        p = bert_attn_cuda._plan_attn_block(B, L, h, heads)
        _check_product(p["qkv"], rows, 3 * h, h)
        _check_product(p["o"], rows, h, h)
        assert p["attention"] == bert_attn_cuda._plan_attention(B, L, heads, h // heads,
                                                                aligned=h % 4 == 0)
        assert p["attention"]["smem"] <= MAX_SMEM
        assert p["fused_ln"] == int(not p["o"]["wgmma"] and p["o"]["splits"] > 1)
        assert p["scratch"] == max(p["qkv"]["scratch"], p["o"]["scratch"])


def test_attn_block_plan_at_the_bert_shapes():
    """BERT-base width: at the training rows (B=4096, L=32) both products
    take the wgmma tiles, 128 wide, over 1,024 row tiles (18 column tiles
    for q/k/v, 6 for o); at the serving rows (B=1, L=8) the mma.sync tiles
    split over K, the o-projection's planes summed by the LayerNorm's
    launch; 9,300 rows (B=300, L=31) take the wgmma tiles with a ragged row
    tile."""
    p = bert_attn_cuda._plan_attn_block(4096, 32, 768, 12)
    for name, n in (("qkv", 2304), ("o", 768)):
        assert p[name]["wgmma"] == 1 and p[name]["bn"] == 128
        assert -(-131072 // 128) == 1024 and -(-n // p[name]["bn"]) == n // 128
    assert p["fused_ln"] == 0 and p["scratch"] == 2 * 2304 * 768
    assert p["attention"]["path"] == 0
    p = bert_attn_cuda._plan_attn_block(1, 8, 768, 12)
    assert p["qkv"]["wgmma"] == p["o"]["wgmma"] == 0
    assert p["qkv"]["splits"] > 1 and p["o"]["splits"] > 1 and p["fused_ln"] == 1
    assert p["qkv"]["splits"] * 36 <= 2 * SMS and p["o"]["splits"] * 12 <= 2 * SMS
    p = bert_attn_cuda._plan_attn_block(300, 31, 768, 12)
    assert p["qkv"]["wgmma"] == p["o"]["wgmma"] == 1 and 9300 % 128


@pytest.mark.parametrize("rows", [1, 8, 512, 9300, 131072])
def test_attn_block_qkv_tiles_cover_3h(rows):
    """The q/k/v product's column tiles cover N = 2304 with no tile more
    than half empty, on either tile (wgmma 128 wide, mma.sync 64)."""
    p = bert_attn_cuda._plan_attn_block(1, rows, 768, 12)["qkv"]
    width = p["bn"] if p["wgmma"] else gemm_tc.SMALL_BN
    assert -(-2304 // width) * width - 2304 < width // 2


@pytest.mark.parametrize("h", [768, 13, 16, 1024])
def test_proj_ln_plans_fit_the_card(h):
    """K6b's plan: one gemm_tc.cuh product over N = K = h, its split planes
    added by the LayerNorm's launch exactly where it splits on the mma.sync
    tiles; 16-byte copies only where h is a multiple of 4."""
    for rows in (1, 8, 9, 32, 128, 512, 4096, 9001, 131072):
        p = bert_ffn_cuda._plan_proj_ln(rows, h)
        _check_product(p, rows, h, h)
        assert p["vec"] == int(h % 4 == 0)
        assert p["fused_ln"] == int(not p["wgmma"] and p["splits"] > 1)


def test_proj_ln_plan_at_the_bert_shapes():
    """BERT-base width: at the training rows (B=4096, L=32) the wgmma tiles,
    128 wide (6 column tiles); at the serving rows (B=1, L=8) the mma.sync
    tiles split over K into 8 ranges of 3 k tiles, summed by the LayerNorm's
    launch; a ragged 9,001 rows on the wgmma tiles; 4,096 rows on unsplit
    mma.sync tiles; h = 13 on 4-byte copies."""
    p = bert_ffn_cuda._plan_proj_ln(131072, 768)
    assert (p["wgmma"], p["bn"], p["fused_ln"], p["scratch"]) == (1, 128, 0, 2 * 768 * 768)
    p = bert_ffn_cuda._plan_proj_ln(8, 768)
    assert (p["wgmma"], p["splits"], p["fused_ln"], p["scratch"]) == (0, 8, 1, 8 * 8 * 768)
    p = bert_ffn_cuda._plan_proj_ln(9001, 768)
    assert p["wgmma"] == 1 and 9001 % 128
    p = bert_ffn_cuda._plan_proj_ln(4096, 768)
    assert (p["wgmma"], p["splits"], p["fused_ln"]) == (0, 1, 0)
    for rows in (8, 9001, 131072):
        p = bert_ffn_cuda._plan_proj_ln(rows, 13)
        assert p["vec"] == p["wgmma"] == 0
        p = bert_ffn_cuda._plan_proj_ln(rows, 768, aligned=False)
        assert p["vec"] == p["wgmma"] == 0


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("h,heads", [(768, 12), (16, 2), (36, 4), (30, 3)])
def test_attn_block_o_plan_is_proj_ln(h, heads, aligned):
    """K2's o-projection + LN and K6b take one plan at the same rows."""
    for B, L in ((1, 1), (1, 8), (1, 512), (300, 31), (4096, 32)):
        p = bert_attn_cuda._plan_attn_block(B, L, h, heads, aligned=aligned)
        assert p["o"] == bert_ffn_cuda._plan_proj_ln(B * L, h, aligned=aligned)
        assert p["fused_ln"] == p["o"]["fused_ln"]


def test_attn_block_plan_unaligned_operands_take_4_byte_copies():
    for B, L in ((1, 8), (4096, 32)):
        p = bert_attn_cuda._plan_attn_block(B, L, 768, 12, aligned=False)
        for name in ("qkv", "o"):
            assert p[name]["vec"] == 0 and p[name]["wgmma"] == 0
        # the attention stage reads the fresh q/k/v scratch, aligned at h = 768
        assert p["attention"]["vec"] == 1
    p = bert_attn_cuda._plan_attn_block(4096, 32, 36, 4)   # h a multiple of 4, dh = 9 is not
    assert p["qkv"]["vec"] == 1 and p["attention"]["vec"] == 0
    p = bert_attn_cuda._plan_attn_block(4096, 32, 30, 3)   # h not a multiple of 4
    assert p["qkv"]["vec"] == p["o"]["vec"] == 0 and p["qkv"]["wgmma"] == 0


def _check_qgemm(p, M, N, K):
    """A csrc/bert_ffn_q.cu product plan: the persistent wgmma kernel (a
    4-stage ring of A and B [128][128 bytes] and the staged int32 tile
    [128][136], + 1 KB; one block an SM, no more blocks than tiles) only
    with 16-byte copies and two waves of 128 x 128 tiles, else the 64 x 64
    mma.sync tiles; the tiles cover the product."""
    if p["wgmma"]:
        assert p["vec"] == 1 and K % 16 == 0
        assert p["smem"] == 4 * 2 * 128 * 128 + 4 * 128 * 136 + 1024 <= MAX_SMEM
        assert p["smem"] + 1024 <= SM_SMEM
        assert p["tiles"] == (-(-N // 128), -(-M // 128))
        assert p["tiles"][0] * p["tiles"][1] >= 2 * SMS and p["grid"] == SMS
    else:
        assert p["smem"] == 2 * 64 * 80 <= 48 * 1024        # static shared memory
        assert p["tiles"] == (-(-N // 64), -(-M // 64)) and p["grid"] == 0
    assert p["vec"] == int(K % 16 == 0)


@pytest.mark.parametrize("h,ffn", [(768, 3072), (32, 128), (40, 100), (64, 256)])
def test_ffn_q_plans_fit_the_card(h, ffn):
    for rows in (1, 7, 8, 32, 300, 512, 513, 4096, 9001, 131072):
        p = bert_ffn_cuda._plan_ffn_q(rows, h, ffn)
        _check_qgemm(p["gemm1"], rows, ffn, h)
        _check_qgemm(p["gemm2"], rows, h, ffn)


@pytest.mark.parametrize("rows,wgmma", [(1, 0), (8, 0), (32, 0), (128, 0), (512, 0),
                                        (4096, 1), (9001, 1), (131072, 1)])
def test_ffn_q_plan_picks_the_path_by_rows(rows, wgmma):
    """BERT-base width: the serving rows (B=1, L=8-512) stay on the mma.sync
    tiles; from a few thousand rows GEMM1 takes the wgmma tiles, and from
    9,001 both (B=4096 L=32 trains at 131,072)."""
    p = bert_ffn_cuda._plan_ffn_q(rows, 768, 3072)
    assert p["gemm1"]["wgmma"] == wgmma
    if rows >= 9001:
        assert p["gemm2"]["wgmma"] == 1
    if not wgmma:
        assert p["gemm2"]["wgmma"] == 0


@pytest.mark.parametrize("n", [3072, 768])
def test_ffn_q_tiles_cover_the_columns(n):
    """GEMM1's N = 3072 and GEMM2's 768 divide into whole tiles on either
    path: 24 and 6 wgmma tiles of 128, 48 and 12 mma.sync tiles of 64."""
    for rows in (8, 131072):
        p = bert_ffn_cuda._plan_ffn_q(rows, 768, 3072)["gemm1" if n == 3072 else "gemm2"]
        assert p["tiles"][0] * p["bn"] == n
    assert bert_ffn_cuda._plan_ffn_q(131072, 768, 3072)["gemm1"]["tiles"] == (24, 1024)


def test_ffn_q_plan_unaligned_weights_take_the_mma_sync_tiles():
    p = bert_ffn_cuda._plan_ffn_q(131072, 768, 3072, aligned=False)
    for g in ("gemm1", "gemm2"):
        assert p[g]["wgmma"] == 0 and p[g]["vec"] == 0


# the MOSEI model's four T==1 residual blocks (E, F1) and one odd shape
# (E, F1 not multiples of 4: 4-byte copies)
K9_BLOCKS = [(200, 200), (200, 800), (1000, 200), (1000, 800), (30, 50)]


def _k9_rows(e):
    return (13,) if e == 30 else (1, 8, 4096)


@pytest.mark.parametrize("E,F1", K9_BLOCKS)
def test_trunk_block_plans_fit_the_card(E, F1):
    """Each of K9's four products is a gemm_tc.cuh plan with promoted sums
    (wgmma widths 104 or 128: K9_PROMOTE); ``u`` and ``dp`` are [R, E] x
    [E, F1], ``y`` and ``ds`` [R, F1] x [F1, E]; 16-byte copies exactly
    where E and F1 are multiples of 4; scratch the largest product's."""
    for R in _k9_rows(E):
        p = trunk_block_cuda._plan_block(R, E, F1)
        for name, n, k in (("u", F1, E), ("y", E, F1), ("dp", F1, E), ("ds", E, F1)):
            _check_product(p[name], R, n, k)
            assert p[name]["bn"] in gemm_tc.PROMOTED_WIDTHS
            assert p[name]["vec"] == p["tn_vec"] == int(E % 4 == 0 and F1 % 4 == 0)
        assert p["u"] == p["dp"] and p["y"] == p["ds"]
        assert p["scratch"] == max(p[k]["scratch"] for k in trunk_block_cuda.PRODUCTS)
        assert p["ln_tiles"] == -(-R // 32)
        assert 4 * 16 * 2 * E <= MAX_SMEM   # the LN backward's per-warp column sums


@pytest.mark.parametrize("E,F1", K9_BLOCKS)
def test_trunk_block_reduction_splits(E, F1):
    """dW1^T [E + 1, F1] and dW2^T [F1 + 1, E] (a ones row each for the
    bias sums) on the transposed-A tiles, split over the R rows into k
    ranges that fill one wave of two blocks an SM, none empty; partial
    holds both products' planes."""
    for R in _k9_rows(E):
        p = trunk_block_cuda._plan_block(R, E, F1)
        ktiles = -(-R // 32)
        for name, m, n in (("dw1", E + 1, F1), ("dw2", F1 + 1, E)):
            splits, kps = p[f"{name}_splits"], p[f"{name}_kps"]
            assert (splits - 1) * kps < ktiles <= splits * kps
            assert splits == 1 or splits * -(-m // 128) * -(-n // 80) <= 2 * SMS
            assert (splits, kps) == tuple(gemm_tc.plan_tn(m, n, R)[k] for k in ("splits", "kps"))
        assert p["partial"] == p["dw1_splits"] * (E + 1) * F1 + p["dw2_splits"] * (F1 + 1) * E


# (R, E, F1) -> each product's (wgmma, splits, bn) in PRODUCTS order u, y,
# dp, ds, then the reductions' (splits, kps)
_K9_PLANS = {
    (4096, 1000, 800): ([(0, 1, 104), (0, 1, 128), (0, 1, 104), (0, 1, 128)], (3, 43, 2, 64)),
    (4096, 200, 200): ([(0, 1, 104)] * 4, (43, 3, 43, 3)),
    (1, 1000, 800): ([(0, 8, 104), (0, 7, 128), (0, 8, 104), (0, 7, 128)], (1, 1, 1, 1)),
    (1, 200, 200): ([(0, 2, 104)] * 4, (1, 1, 1, 1)),
    (8, 200, 800): ([(0, 2, 104), (0, 7, 104), (0, 2, 104), (0, 7, 104)], (1, 1, 1, 1)),
    (13, 30, 50): ([(0, 1, 104)] * 4, (1, 1, 1, 1)),
}


@pytest.mark.parametrize("shape", list(_K9_PLANS))
def test_trunk_block_plan_paths(shape):
    """At R=4096 the MOSEI blocks' products stay on the mma.sync tiles (256
    wgmma tiles at N = 800 or 1000, under two an SM) unsplit; at the serving
    rows (R=1) and R=8 they split over K across the card rather than run in
    one block; the odd shape takes one 4-byte-copy tile a product."""
    p = trunk_block_cuda._plan_block(*shape)
    products, tn = _K9_PLANS[shape]
    assert [tuple(p[k][f] for f in ("wgmma", "splits", "bn"))
            for k in trunk_block_cuda.PRODUCTS] == products
    assert (p["dw1_splits"], p["dw1_kps"], p["dw2_splits"], p["dw2_kps"]) == tn
    if shape[0] == 1:
        assert all(p[k]["splits"] > 1 for k in trunk_block_cuda.PRODUCTS)


def test_trunk_block_plan_takes_wgmma_tiles_where_rows_fill_the_card():
    """From 8,448 rows (66 row tiles: 528 wgmma tiles at N = 800) the top
    FFN's products take the wgmma tiles, B's TF32 planes in scratch;
    unaligned weights keep the mma.sync tiles and 4-byte copies."""
    p = trunk_block_cuda._plan_block(8448, 1000, 800)
    assert all(p[k]["wgmma"] == 1 for k in trunk_block_cuda.PRODUCTS)
    assert p["scratch"] == 2 * 1000 * 800
    p = trunk_block_cuda._plan_block(8448, 1000, 800, aligned=False)
    assert all(p[k]["wgmma"] == 0 and p[k]["vec"] == 0 for k in trunk_block_cuda.PRODUCTS)
    assert p["tn_vec"] == 0


class _FakeLib:
    """Records what the trunk-block entries are handed (the plan ints read
    from the host array, as the C side reads them)."""

    def __init__(self):
        self.calls = {}

    def _record(self, name, args):
        ints = (ctypes.c_int * 21).from_address(args[-2])
        self.calls[name] = {"plan": list(ints), "args": args}
        return 0

    def mmtr_trunk_block_fwd(self, *args):
        return self._record("fwd", args)

    def mmtr_trunk_block_bwd(self, *args):
        return self._record("bwd", args)


@pytest.mark.parametrize("R,E,F1", [(13, 30, 50), (8, 200, 800), (5, 1000, 200)])
def test_trunk_block_wrapper_allocates_what_the_plan_says(monkeypatch, R, E, F1):
    """Through the wrappers' launch paths with the C entries replaced: both
    entries get the same 21 plan ints (so the backward's recompute of u runs
    the forward's product-1 plan), and each scratch view is as many floats
    as the plan asks for, on a 256-byte boundary."""
    lib = _FakeLib()
    sizes = []
    real_workspace = trunk_block_cuda._workspace

    def workspace(dev, wanted):
        views = real_workspace(dev, wanted)
        sizes.append([v.numel() for v in views])
        assert all((v.data_ptr() - views[0].data_ptr()) % 256 == 0 for v in views if v.numel())
        return views

    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(_build, "num_sms", lambda dev: SMS)
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(trunk_block_cuda, "_workspace", workspace)
    g = torch.Generator().manual_seed(0)
    x, src, dout = (torch.randn(R, E, generator=g) for _ in range(3))
    params = [torch.randn(F1, E, generator=g), torch.randn(F1, generator=g),
              torch.randn(E, F1, generator=g), torch.randn(E, generator=g),
              torch.ones(E), torch.zeros(E)]
    masks = [torch.ones(E), torch.ones(F1), torch.ones(E)]
    cfg = trunk_block_cuda.BlockConfig("relu", 1, 0.1, 0.3, 1, 2, True, True)
    dev = torch.device("cpu")
    out = trunk_block_cuda._launch_fwd(dev, x, src, *params, *masks, cfg)
    grads = trunk_block_cuda._launch_bwd(dev, x, src, dout, *params, *masks, cfg)
    plan = trunk_block_cuda._plan_block(R, E, F1)
    ints = trunk_block_cuda.plan_ints(plan)
    assert lib.calls["fwd"]["plan"] == lib.calls["bwd"]["plan"] == ints
    assert ints[:4] == [plan["u"][k] for k in gemm_tc.PLAN_KEYS]
    assert sizes == [trunk_block_cuda.fwd_workspace(plan, R, E, F1),
                     trunk_block_cuda.bwd_workspace(plan, R, E, F1)]
    assert sizes[1][-2:] == [plan["partial"], plan["scratch"]]
    assert out.shape == (R, E)
    assert [tuple(a.shape) for a in grads] == [(R, E), (F1, E), (F1,), (E, F1), (E,), (E,),
                                               (E,)]
    # the rows, the dimensions and the dropout flags follow the pointers
    for name, npt in (("fwd", 15), ("bwd", 21)):
        assert lib.calls[name]["args"][npt:npt + 9] == (R, E, F1, 1, 1, 1, 1, 1, 2)


# ---------------------------------------------------------------- bf16
# csrc/gemm_bf16.cuh: the mma.sync kernel's 128 x 128 tiles (eight warps of
# 64 x 32, m16n8k16 MMAs), 32-deep k steps in a 4-stage cp.async ring, A
# staged [m][k] in 80-byte rows or [k][m] in 272-byte rows, B [k][n] in
# 272-byte rows; the wgmma kernel's 128 x 128 tiles, 64-deep k steps in
# 128-byte swizzled rows, one block an SM


def test_bf16_tile_constants_fit_the_card():
    """k steps of whole MMAs (16 deep), warp tiles of whole MMAs, rows an
    odd number of 16-byte words (ldmatrix's eight row addresses land on
    distinct bank groups), every ring slot 16-byte aligned, two blocks an
    SM within its shared memory."""
    assert gemm_tc.BF_BK % gemm_tc.BF_MMA_K == 0
    assert gemm_tc.BF_BM % (2 * 16) == 0 and gemm_tc.BF_BN % (4 * 8 * 2) == 0
    for ld in (gemm_tc.BF_LDK, gemm_tc.BF_LDM, gemm_tc.BF_LDN):
        assert (2 * ld) % 16 == 0 and (2 * ld // 16) % 2 == 1
    a_elems = max(gemm_tc.BF_BM * gemm_tc.BF_LDK, gemm_tc.BF_BK * gemm_tc.BF_LDM)
    assert (2 * a_elems) % 16 == 0 and (2 * gemm_tc.BF_BK * gemm_tc.BF_LDN) % 16 == 0
    assert gemm_tc.BF_SMEM == 75776 <= MAX_SMEM
    assert gemm_tc.BF_BLOCKS_PER_SM * (gemm_tc.BF_SMEM + 1024) <= SM_SMEM
    # the wgmma stages: 128 rows of 128 bytes (a whole number of 1024-byte
    # swizzle atoms), 4 deep, for A and B^T, + 1 KB to align the atoms
    assert 2 * gemm_tc.BW_BK == 128 and (128 * 2 * gemm_tc.BW_BK) % 1024 == 0
    assert gemm_tc.BW_SMEM == 132096 <= MAX_SMEM


@pytest.mark.parametrize("counts,addrs,cw", [((768,), (0,), 8), ((100,), (0,), 4),
                                              ((400,), (8,), 4), ((7,), (0,), 1),
                                              ((26,), (4,), 2), ((768, 100), (0, 0), 4),
                                              ((768,), (2,), 1)])
def test_bf16_copy_width(counts, addrs, cw):
    assert gemm_tc.bf16_copy_width(counts, addrs) == cw


@pytest.mark.parametrize("M,N,K", [(204800, 300, 768), (800, 300, 768), (1, 300, 7),
                                   (131072, 3072, 768), (131072, 768, 3072), (8, 2304, 768),
                                   (768, 300, 204800), (101, 400, 204800), (5, 13, 3)])
def test_bf16_plans_cover_k_and_fit_the_card(M, N, K):
    """The wgmma kernel where the tiles give every SM two and K takes
    16-byte copies (B^T's N * K bf16 in the scratch); else the k ranges
    cover every k tile, none empty, one split where the tiles give two
    blocks an SM, and the split planes hold every range."""
    for max_splits in (16, None):
        p = gemm_tc.plan_bf16(M, N, K, 8, 8, SMS, max_splits=max_splits)
        ktiles = -(-K // gemm_tc.BF_BK)
        tiles = -(-M // 128) * -(-N // 128)
        assert p["wgmma"] == int(tiles >= 2 * SMS and K % 8 == 0)
        if p["wgmma"]:
            assert p["splits"] == 1 and p["kps"] == -(-K // gemm_tc.BW_BK)
            assert 2 * p["partial"] >= N * K
            continue
        assert (p["splits"] - 1) * p["kps"] < ktiles <= p["splits"] * p["kps"]
        assert p["splits"] * tiles <= max(tiles, 2 * SMS)
        if tiles >= 2 * SMS:
            assert p["splits"] == 1 and p["partial"] == 0
        assert p["partial"] == (p["splits"] * M * N if p["splits"] > 1 else 0)
        if max_splits is not None:
            assert p["splits"] <= max_splits


def test_bf16_plans_at_the_training_shapes():
    """bench.py's shapes: K1f's projection on its own 128 x 304 wgmma tile
    (gemm_wgmma 2), K2's and K3's products on the persistent kernel (wgmma
    2, one block an SM, the weights read as stored: no scratch), K1f's and K1b's recurrences on
    their mma forms, 32 rows a block; K1b's reductions
    over T*B rows on the mma.sync tiles, split to fill one wave, dwt's
    copies of h dividing H (where its ones row starts), and its dx (K = 3H
    = 300: 8-byte copies) on them unsplit."""
    fwd = bigru_cuda._plan_gru_fwd_bf16(50, 4096, 768, 100)
    assert (fwd["gemm_wgmma"], fwd["gemm_splits"], fwd["gemm_acw"]) == (2, 1, 8)
    assert 2 * fwd["gemm_partial"] == 300 * 768
    assert fwd["rec_rows"] == 32 and fwd["rec_small"] == 0 and fwd["rec_mma"] == 1
    for in_dim, need_dx in ((768, False), (512, False), (200, True)):
        bwd = bigru_cuda._plan_gru_bwd_bf16(50, 4096, in_dim, 100, need_dx)
        assert bwd["rows"] == 32 and bwd["rec_mma"] == 1 and bwd["blocks"] == 128
        # dwp on the wgmma reduction, one block an SM: 64-deep k tiles
        tiles, ktiles = -(-in_dim // 128) * 3, -(-50 * 4096 // 64)
        assert bwd["dwp_wgmma"] == 3 and bwd["dwp_partial"] == bwd["dwp_splits"] * in_dim * 300
        assert tiles * bwd["dwp_splits"] <= SMS < tiles * (bwd["dwp_splits"] + 1)
        assert (bwd["dwp_splits"] - 1) * bwd["dwp_kps"] < ktiles <= \
            bwd["dwp_splits"] * bwd["dwp_kps"]
        # dwt (its ones row) on it too, from the recurrence's [h_prev | 1]
        # scratch of 104 columns (16-byte rows)
        tiles = -(-101 // 128) * -(-400 // 128)
        assert bwd["dwt_wgmma"] == 3 and bwd["hp"] == 104 and bwd["dwt_acw"] == 8
        assert tiles * bwd["dwt_splits"] <= SMS < tiles * (bwd["dwt_splits"] + 1)
        assert bwd["dwt_partial"] == bwd["dwt_splits"] * 101 * 400
        assert bwd["dx_wgmma"] == 0
        assert (bwd["dx_splits"] == 1) == need_dx and bwd["dx_partial"] == 0
    blk = bert_attn_cuda._plan_attn_block_bf16(4096, 32, 768, 12)
    assert blk["qkv"]["wgmma"] == blk["o"]["wgmma"] == 2
    assert blk["qkv"]["grid"] == blk["o"]["grid"] == SMS
    assert blk["qkv"]["tiles"] == 1024 * 12 and blk["o"]["tiles"] == 1024 * 4
    assert blk["qkv"]["partial"] == blk["o"]["partial"] == blk["partial"] == 0
    ffn = bert_ffn_cuda._plan_ffn_bf16(131072, 768, 3072)
    assert all(ffn[fc]["wgmma"] == 2 and ffn[fc]["grid"] == SMS for fc in ("fc1", "fc2"))
    assert ffn["fc1"]["tiles"] == 1024 * 16 and ffn["fc2"]["tiles"] == 1024 * 4
    assert ffn["partial"] == 0


def test_bf16_plans_at_the_eval_and_serving_rows():
    """Few rows split K over the card (K1f at the eval batch of 16: 12
    ranges of 2 k tiles; K3's fc2 at 8 rows: 16 ranges of 6)."""
    fwd = bigru_cuda._plan_gru_fwd_bf16(50, 16, 768, 100)
    assert (fwd["gemm_wgmma"], fwd["gemm_splits"], fwd["gemm_kps"]) == (0, 12, 2)
    assert fwd["rec_small"] == 1
    ffn = bert_ffn_cuda._plan_ffn_bf16(8, 768, 3072)
    assert ffn["fc1"]["wgmma"] == ffn["fc2"]["wgmma"] == 0
    assert (ffn["fc2"]["splits"], ffn["fc2"]["kps"]) == (16, 6)
    assert ffn["partial"] == max(ffn[fc]["splits"] * 8 * n for fc, n in
                                 (("fc1", 3072), ("fc2", 768)))


# csrc/gemm_bf16.cuh's persistent kernel (K3.bf16's products): 128 x 192
# tiles, 64-deep k tiles in a TMA ring of 4 (A [128][64], B [64][192], bf16),
# a bf16 staging tile [128][200], the ring's full / empty mbarriers, + 1 KB
# to align the 128-byte swizzle atoms; 480 threads (two MMA warpgroups, six
# epilogue warps, a producer warp), one block an SM
@pytest.mark.parametrize("M,N,K", [(131072, 3072, 768), (131072, 768, 3072), (16511, 3072, 768),
                                   (16511, 768, 3072), (5505, 768, 3072), (1281, 3072, 768),
                                   (70000, 104, 48)])
def test_bf16_persistent_plan_covers_k_and_the_columns(M, N, K):
    """Where the 128 x 128 wgmma tiles would run (two tiles an SM, 16-byte
    copies of A and B), a persistent plan: k tiles of 64 that cover K, 128 x
    192 tiles that cover every row and column, a grid of min(tiles, SMs),
    the shared memory within a block's; the same shapes without
    ``persistent`` keep the 128 x 128 wgmma tiles and B^T's scratch."""
    p = gemm_tc.plan_bf16(M, N, K, 8, 8, SMS, persistent=True)
    q = gemm_tc.plan_bf16(M, N, K, 8, 8, SMS)
    assert q["wgmma"] == 1 and 2 * q["partial"] >= N * K
    assert p["wgmma"] == 2 and p["splits"] == 1 and p["partial"] == 0
    assert (p["kps"] - 1) * gemm_tc.BP_BK < K <= p["kps"] * gemm_tc.BP_BK
    rows, cols = -(-M // gemm_tc.BP_BM), -(-N // gemm_tc.BP_BN)
    assert p["tiles"] == rows * cols and (cols - 1) * gemm_tc.BP_BN < N <= cols * gemm_tc.BP_BN
    assert p["grid"] == min(p["tiles"], SMS)
    assert p["smem"] == gemm_tc.BP_SMEM == 216128 <= MAX_SMEM
    # 480 threads leave 136 registers a thread: an MMA thread's 96 sums
    # (m64n192) and its addresses
    assert gemm_tc.BP_THREADS == 480 and 65536 // gemm_tc.BP_THREADS // 8 * 8 == 136
    assert gemm_tc.BP_BN % 64 == 0 and gemm_tc.BP_BN // 2 + 32 <= 136
    # 128-byte rows: the swizzle atoms (1024 bytes) tile every stage
    assert (gemm_tc.BP_BM * gemm_tc.BP_BK * 2) % 1024 == 0
    assert (gemm_tc.BP_BK * 64 * 2) % 1024 == 0 and (2 * gemm_tc.BP_LDS) % 16 == 0


@pytest.mark.parametrize("acw,bcw", [(4, 8), (8, 4), (2, 2)])
def test_bf16_persistent_plan_needs_16_byte_operands(acw, bcw):
    """The persistent kernel reads A and B by TMA and stores in 16-byte
    pieces: where either takes narrower copies, the first port's tiles."""
    p = gemm_tc.plan_bf16(131072, 3072, 768, acw, bcw, SMS, persistent=True)
    assert p["wgmma"] == (1 if acw == 8 else 0) and "grid" not in p


@pytest.mark.parametrize("rows,fc1,fc2", [(8, 0, 0), (300, 0, 0), (1280, 0, 0), (1281, 2, 0),
                                          (5504, 2, 0), (5505, 2, 2), (16511, 2, 2),
                                          (131072, 2, 2)])
def test_ffn_bf16_plan_takes_the_persistent_kernel_by_rows(rows, fc1, fc2):
    """K3.bf16: each product on the persistent kernel where the rows fill
    the card (fc1's 24 column tiles of 128 from 1,281 rows, fc2's 6 from
    5,505: the edge where the 128 x 128 wgmma tiles took over before), on
    the mma.sync tiles split over K below it (the serving and eval rows
    keep their plans); the plan hands both grids to csrc/bert_ffn.cu after
    the two BfPlans."""
    p = bert_ffn_cuda._plan_ffn_bf16(rows, 768, 3072)
    assert (p["fc1"]["wgmma"], p["fc2"]["wgmma"]) == (fc1, fc2)
    for fc, (m, n, k) in (("fc1", (rows, 3072, 768)), ("fc2", (rows, 768, 3072))):
        parent = gemm_tc.plan_bf16(m, n, k, 8, 8, SMS)
        if p[fc]["wgmma"] == 2:
            assert parent["wgmma"] == 1
        else:
            assert p[fc] == parent
    ints, _, partial = bert_ffn_cuda._cached_ffn_plan_bf16(rows, 768, 3072, SMS, 0, 0, 0)
    assert len(ints) == 2 * len(gemm_tc.BF_PLAN_KEYS) + 2
    assert list(ints)[10:] == [p[fc].get("grid", 0) for fc in ("fc1", "fc2")]
    assert partial == max(p["fc1"]["partial"], p["fc2"]["partial"])


def test_ffn_bf16_plan_unaligned_residual_keeps_fc2_off_the_persistent_kernel():
    """fc2's epilogue reads x (the residual) in 16-byte pieces: x off a
    16-byte boundary sends fc1 to the mma.sync tiles (its A) and fc2 to
    the 128 x 128 wgmma tiles."""
    p = bert_ffn_cuda._plan_ffn_bf16(131072, 768, 3072, x_addr=8)
    assert (p["fc1"]["wgmma"], p["fc2"]["wgmma"]) == (0, 1)


def test_bf16_plans_of_the_other_products_keep_their_kernels():
    """Only K3.bf16 and K2.bf16 (and K6b.bf16, K2's tail) ask for the
    persistent kernel and K1b.bf16's dwp and dwt for the wgmma reduction:
    K2.bf16's products at the serving rows, K1f.bf16's projection,
    K1b.bf16's dx and K9.bf16's products keep the plans they had."""
    for B, L in ((1, 8), (1, 512), (4096, 32)):
        blk = bert_attn_cuda._plan_attn_block_bf16(B, L, 768, 12)
        assert blk["qkv"]["wgmma"] == blk["o"]["wgmma"] == 2 * int(B > 1)
        assert blk["o"] == bert_ffn_cuda._plan_proj_ln_bf16(B * L, 768)
    assert bigru_cuda._plan_gru_fwd_bf16(50, 4096, 768, 100)["gemm_wgmma"] == 2
    bwd = bigru_cuda._plan_gru_bwd_bf16(50, 4096, 200, 100, True)
    assert bwd["dx_wgmma"] == 0 and bwd["dwp_wgmma"] == bwd["dwt_wgmma"] == 3
    for E, F1 in K9_BLOCKS:
        for R in _k9_rows(E):
            p = trunk_block_cuda._plan_block_bf16(R, E, F1)
            assert all(p[k]["wgmma"] in (0, 1) for k in ("u", "y", "dp", "ds", "dw1", "dw2"))


@pytest.mark.parametrize("M,N,K", [(768, 300, 204800), (512, 300, 204800), (200, 300, 204800),
                                   (768, 300, 4096 * 8), (768, 300, 100), (40, 24, 70)])
def test_bf16_reduction_plan_covers_k_and_fills_one_wave(M, N, K):
    """The wgmma reduction (gemm_bf16_tn_kernel) over K rows: 64-deep k
    ranges that cover every k tile, none empty, tiles x ranges within one
    block an SM (the most ranges that allow it), planes for every range;
    its shared memory within a block's; narrower copies of A or B (x with
    ``in`` off a multiple of 8, dg with 4H off one) keep the mma.sync
    tiles."""
    p = gemm_tc.plan_bf16(M, N, K, 8, 8, SMS, max_splits=None, transposed_a=True,
                          reduction=True)
    ktiles, tiles = -(-K // 64), -(-M // 128) * -(-N // 128)
    assert p["wgmma"] == 3 and p["partial"] == p["splits"] * M * N
    assert (p["splits"] - 1) * p["kps"] < ktiles <= p["splits"] * p["kps"]
    assert tiles * p["splits"] <= max(tiles, SMS)
    assert p["splits"] == ktiles or tiles * (p["splits"] + 1) > SMS or \
        -(-ktiles // -(-ktiles // (p["splits"] + 1))) == p["splits"]
    assert p["smem"] == gemm_tc.BT_SMEM == 6 * (2 * 16384 + 16) + 1024 <= MAX_SMEM
    for acw, bcw in ((4, 8), (8, 4)):
        q = gemm_tc.plan_bf16(M, N, K, acw, bcw, SMS, max_splits=None, transposed_a=True,
                              reduction=True)
        assert q["wgmma"] == 0


# csrc/gru_rec.cuh's backward mma form: W_hh^T [3][112][120] bf16, b_hn [104]
# float32, per row group h_prev [2][16][120] and da [2][3][16][120] bf16,
# per warp the gate slots [3][4][2][32] float2 and dh_in's [4][2][32] pairs
@pytest.mark.parametrize("B", [1, 16, 132, 133, 600, 2112, 2113, 4095, 4096, 8192])
@pytest.mark.parametrize("H", [12, 13, 100, 104, 105])
def test_bf16_rec_bwd_plan_forms(B, H):
    """K1b.bf16's recurrence: the mma form where B passes the SM count and
    H <= 104, else the tiled form by the float plan (B <= 132, H = 105);
    row groups of 16 that cover B, 16 rows a block while ceil(B / 16) fits
    the SMs and 32 beyond (B=4096: one wave of 128 blocks), four warps a
    row group, the shared memory within a block's, 8-byte copies at H a
    multiple of 4; the float plan (_plan_rec_bwd) is unchanged."""
    p = bigru_cuda._plan_rec_bwd_bf16(B, H)
    mma = B > SMS and H <= 104
    assert p["rec_mma"] == int(mma)
    if not mma:
        assert p == {"rec_mma": 0, **bigru_cuda._plan_rec_bwd(1, B, H), "rec_vec": 0}
        return
    rows, groups = p["rows"], p["rows"] // 16
    assert rows == (16 if -(-B // 16) <= SMS else 32)
    assert (p["blocks"] - 1) * rows < B <= p["blocks"] * rows
    assert p["threads"] == 128 * groups <= 256 and p["js"] == p["wp"] == 0
    assert p["smem"] == (2 * 3 * 112 * 120 + 4 * 104 + groups * 2 * (2 + 6) * 16 * 120
                         + 4 * groups * (8 * 3 * 4 * 2 * 32 + 4 * 4 * 2 * 32)) <= MAX_SMEM
    assert p["rec_vec"] == int(H % 4 == 0)
    if B in (4095, 4096):
        assert p["blocks"] == 128 <= SMS and p["smem"] == 199840


def test_bf16_gru_bwd_plan_layout():
    """K1b.bf16's plan as csrc/bigru_bwd.cu reads it: the recurrence's
    seven ints (REC_BWD_BF16_PLAN_KEYS: rec_mma, the tiled form's five,
    rec_vec), then the three BfPlans; a tiled recurrence keeps the float
    plan's five."""
    assert bigru_cuda.REC_BWD_BF16_PLAN_KEYS == (("rec_mma",) + bigru_cuda.REC_BWD_PLAN_KEYS
                                                 + ("rec_vec",))
    for B, H, mma in ((4096, 100, 1), (100, 100, 0), (4096, 13, 1)):
        ints, _, partial, _, hp = bigru_cuda._cached_bwd_plan_bf16(50, B, 768, H, False, SMS, 0, 0)
        p = bigru_cuda._plan_gru_bwd_bf16(50, B, 768, H, False)
        assert len(ints) == 7 + 3 * len(gemm_tc.BF_PLAN_KEYS) == 22
        assert list(ints) == [p[k] for k in bigru_cuda.BWD_BF16_PLAN_KEYS]
        assert ints[0] == mma and partial == p["dwp_partial"] + p["dwt_partial"]
        # dwt's wgmma reduction (and hp, [h_prev | 1] rounded up to 8
        # columns) needs the mma form and dg's 16-byte rows (H even)
        assert hp == (8 * -(-(H + 1) // 8) if mma and H % 2 == 0 else 0)
        assert (p["dwt_wgmma"] == 3) == bool(hp)
        if not mma:
            tiled = bigru_cuda._plan_rec_bwd(1, B, H)
            assert list(ints)[1:6] == [tiled[k] for k in bigru_cuda.REC_BWD_PLAN_KEYS]


def test_bf16_attn_block_plan_refuses_long_units():
    """The bf16 attention stage reads heads in 16-byte copies and holds 64
    rows of a head's columns: dh > 64, or dh or h not a multiple of 8
    raise; every L runs, L <= 64 on few units a unit a block (path 0; the
    unit walk, path 3, takes the training rows), 64 < L <= 512 in
    query tiles of 32 with the row's logits in registers (path 2; L = 65
    three tiles, the B=1 L=512 serving bucket 16 a head, 256 threads),
    longer units in query tiles of 64 over three passes (path 1);
    K6a.bf16 shares the plan.  The static shared memory of paths 0 and 1
    (q, k, v rows of 72 bf16 on path 0; q and a ring of two k and v tiles
    on path 1) stays within a block's 48 KB."""
    assert bert_attn_cuda._plan_attn_block_bf16(1, 64, 768, 12)["attention"] == {
        "path": 0, "units": 12, "qtiles": 1, "threads": 128, "smem": 0, "blocks": 12}
    bert_attn_cuda._plan_attn_block_bf16(3, 13, 16, 2)
    assert bert_attn_cuda._plan_attn_block_bf16(1, 65, 768, 12)["attention"] == {
        "path": 2, "units": 12, "qtiles": 3, "threads": 64, "smem": 16896, "blocks": 36}
    assert bert_attn_cuda._plan_attention_bf16(1, 512, 12, 64) == {
        "path": 2, "units": 12, "qtiles": 16, "threads": 256, "smem": 81408, "blocks": 192}
    assert bert_attn_cuda._plan_attention_bf16(1, 513, 12, 64) == {
        "path": 1, "units": 12, "qtiles": 9, "threads": 128, "smem": 0, "blocks": 108}
    assert bert_attn_cuda._plan_attention_bf16(4096, 32, 12, 64)["units"] == 4096 * 12
    for B, L, h, heads in ((1, 8, 768, 6), (1, 8, 60, 5), (1, 8, 36, 3), (1, 100, 36, 3)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            bert_attn_cuda._plan_attn_block_bf16(B, L, h, heads)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bert_attn_cuda._plan_attention_bf16(2, 80, 4, 12)
    assert 3 * 64 * 72 * 2 <= 48 * 1024 and 5 * 64 * 72 * 2 <= 48 * 1024


# csrc/bert_attn.cu's bf16 row path (attention_bf16_row_kernel): 32 query
# rows a block, 128 keys a warp, at most 4 key groups (L <= 512); q [32][72]
# and K / V [kp][72] bf16, the max / sum exchange [2][KW][32] and the key
# bias [KW * 128] float32, the KW - 1 partial outputs [32][dh rounded to
# 16] float32 in K / V's buffer.
AB_LD, AR_QROWS, AR_KEYS = 72, 32, 128


@pytest.mark.parametrize("L", [1, 8, 32, 64, 65, 100, 127, 128, 129, 256, 257, 300, 384, 385,
                               511, 512, 513, 600, 1024])
@pytest.mark.parametrize("dh", [8, 16, 64])
def test_bf16_attention_plan_paths_and_shared_memory(L, dh):
    """The bf16 attention's path by L at 24 units (0 at L <= 64, the
    block-a-unit kernel below the unit walk's units, 2 to L = 512, the
    logits' reach in a block's registers, 1 past it), a grid of (units,
    query tiles) whose tiles cover every query row once, path 2's 64 threads
    a key group of 128 keys, and its dynamic shared memory within a block's
    232,448 bytes, two blocks an SM, with the partial outputs fitting K / V's
    buffer."""
    heads = 12
    p = bert_attn_cuda._plan_attention_bf16(2, L, heads, dh)
    assert p["path"] == (0 if L <= 64 else 2 if L <= 512 else 1)
    assert p["units"] == 2 * heads
    rows = {0: 64, 1: 64, 2: AR_QROWS}[p["path"]]
    assert (p["qtiles"] - 1) * rows < L <= p["qtiles"] * rows
    assert p["blocks"] == p["units"] * p["qtiles"]
    if p["path"] != 2:
        assert p["threads"] == 128 and p["smem"] == 0
        return
    kw, kp, dp = -(-L // AR_KEYS), -(-L // 16) * 16, -(-dh // 16) * 16
    assert 1 <= kw <= 4 and p["threads"] == 64 * kw <= 256
    kv = 2 * kp * AB_LD
    assert p["smem"] == 2 * AR_QROWS * AB_LD + kv + 4 * 2 * kw * AR_QROWS + 4 * kw * AR_KEYS
    assert 4 * (kw - 1) * AR_QROWS * dp <= kv
    assert 2 * (p["smem"] + 1024) <= SM_SMEM


def test_bf16_attention_fills_the_card_at_the_longest_bucket():
    """B=1 L=512, 12 heads of 64 (the serving bucket where the three-pass
    kernel ran 96 blocks of 4 warps): at least 132 blocks, all resident at
    once at two blocks an SM; K2.bf16's plan hands the same six ints to
    its attention stage after the two products' ten (the two persistent
    grids follow them)."""
    p = bert_attn_cuda._plan_attention_bf16(1, 512, 12, 64)
    blocks = p["units"] * p["qtiles"]
    assert blocks >= SMS and blocks <= 2 * SMS
    ints, _, _ = bert_attn_cuda._cached_block_plan_bf16(1, 512, 768, 12, SMS, 0, 0, 0)
    assert len(ints) == 2 * len(gemm_tc.BF_PLAN_KEYS) + len(bert_attn_cuda._AB_PLAN_KEYS) + 2
    assert list(ints)[10:16] == [p[k] for k in bert_attn_cuda._AB_PLAN_KEYS]


# csrc/gru_rec.cuh's mma form: W_hh [3][8 nt][120] bf16, b_hn [8 nt] float32,
# hm [groups][2][16][120] bf16, per warp [2][3][4][2][32] float2 gates
@pytest.mark.parametrize("B", [1, 16, 132, 133, 600, 2112, 2113, 4095, 4096, 8192])
@pytest.mark.parametrize("H", [12, 13, 100, 104, 105])
def test_bf16_recurrence_plan_forms(B, H):
    """K1f.bf16's recurrence: the small form at B <= 132 (H <= 104), the
    mma form past it (H <= 104), the tiled form beyond H = 104; the mma
    form's row groups of 16 cover B, a block 16 rows while ceil(B / 16)
    fits the SMs and 32 beyond (B=4096: one wave of 128 blocks), four warps
    a row group, its shared memory within a block's and 8-byte gate copies
    only at even H; the float32 plan (_plan_recurrence) is unchanged."""
    p = bigru_cuda._plan_recurrence_bf16(B, H)
    small = B <= SMS and H <= 104
    assert p["rec_small"] == int(small)
    assert p["rec_mma"] == int(not small and H <= 104)
    if not p["rec_mma"]:
        assert p == {"rec_mma": 0, **bigru_cuda._plan_recurrence(1, B, H)}
        return
    rows, groups = p["rec_rows"], p["rec_rows"] // 16
    assert rows == (16 if -(-B // 16) <= SMS else 32)
    assert (p["rec_blocks"] - 1) * rows < B <= p["rec_blocks"] * rows
    assert p["rec_threads"] == 128 * groups <= 256
    np_ = 8 * -(-H // 8)
    assert p["rec_smem"] == (2 * 3 * np_ * 120 + 4 * np_ + groups * 2 * 2 * 16 * 120
                             + 4 * groups * 8 * 2 * 3 * 4 * 2 * 32) <= MAX_SMEM
    assert p["rec_vec"] == int(H % 2 == 0)
    if B in (4095, 4096):
        assert p["rec_blocks"] == 128 <= SMS


def test_bf16_gru_fwd_plan_layout():
    """K1f.bf16's plan as csrc/bigru.cu reads it: the projection's five
    BfPlan ints (gemm_wgmma 2 where gemm_tc.plan_bf16 takes wgmma and 3H <=
    304, 1 where 3H is wider), then the recurrence's eight
    (REC_BF16_PLAN_KEYS: rec_mma, then the float plan's seven)."""
    assert bigru_cuda.REC_BF16_PLAN_KEYS == ("rec_mma",) + bigru_cuda.REC_PLAN_KEYS
    ints, _, partial = bigru_cuda._cached_plan_bf16(50, 4096, 768, 100, SMS, 0, 0)
    p = bigru_cuda._plan_gru_fwd_bf16(50, 4096, 768, 100)
    assert list(ints) == [p[k] for k in bigru_cuda.BF_GEMM_PLAN_KEYS
                          + bigru_cuda.REC_BF16_PLAN_KEYS]
    assert len(ints) == 13 and partial == p["gemm_partial"]
    assert bigru_cuda._plan_gru_fwd_bf16(50, 4096, 768, 105)["gemm_wgmma"] == 1
    assert bigru_cuda._plan_gru_fwd_bf16(50, 16, 768, 100)["gemm_wgmma"] == 0


def test_bf16_proj_ln_plan_is_k2s_tail():
    """K6b.bf16's plan is K2.bf16's o-projection plan at the same rows (the
    o-projection's A, the fresh attention output, aligned); copies narrow
    with the operands' alignment."""
    for B, L in ((1, 8), (1, 512), (4096, 32)):
        blk = bert_attn_cuda._plan_attn_block_bf16(B, L, 768, 12)
        assert blk["o"] == bert_ffn_cuda._plan_proj_ln_bf16(B * L, 768)
    assert bert_ffn_cuda._plan_proj_ln_bf16(131072, 768)["wgmma"] == 2
    p = bert_ffn_cuda._plan_proj_ln_bf16(8, 768, a_addr=4)
    assert (p["wgmma"], p["acw"], p["bcw"]) == (0, 2, 8)


def _first_port_bf16(M, N, K):
    """A bf16 product's plan before the persistent kernel took K2.bf16's
    and K6b.bf16's products: plan_bf16 without ``persistent``."""
    return gemm_tc.plan_bf16(M, N, K, 8, 8, SMS)


@pytest.mark.parametrize("B,L,h,heads", [(1, 8, 768, 12), (1, 512, 768, 12), (16, 32, 768, 12),
                                         (56, 32, 768, 12), (4096, 32, 640, 10),
                                         (300, 31, 640, 10)])
def test_bf16_attn_block_plan_keeps_the_first_port_off_the_training_rows(B, L, h, heads):
    """The serving rows (B=1, L 8 and 512), the eval header pass (16 x 32
    rows) and anything under 15 row tiles of 128 keep the mma.sync split-K
    plans, and h = 640 (a multiple of 64, not of 192: a 192-wide column
    tile would straddle two of the q/k/v planes) keeps the 128 x 128 wgmma
    tiles at every row count; K6b.bf16's plan is the o-projection's there
    too, and the LayerNorm stays a block a row (no plan says wgmma 2)."""
    rows = B * L
    blk = bert_attn_cuda._plan_attn_block_bf16(B, L, h, heads)
    assert blk["qkv"] == _first_port_bf16(rows, 3 * h, h)
    assert blk["o"] == _first_port_bf16(rows, h, h) == bert_ffn_cuda._plan_proj_ln_bf16(rows, h)
    assert blk["partial"] == max(blk["qkv"]["partial"], blk["o"]["partial"])
    ints, _, partial = bert_attn_cuda._cached_block_plan_bf16(B, L, h, heads, SMS, 0, 0, 0)
    assert list(ints)[16:] == [0, 0] and partial == blk["partial"]
    ints, _, _ = bert_ffn_cuda._cached_proj_ln_plan_bf16(rows, h, SMS, 0, 0, 0)
    assert list(ints) == [blk["o"][k] for k in gemm_tc.BF_PLAN_KEYS] + [0]


@pytest.mark.parametrize("B,L", [(4096, 32), (4095, 32), (57, 32), (172, 32), (173, 32),
                                 (2048, 8), (2048, 64)])
def test_bf16_attn_block_plan_takes_the_persistent_kernel_by_rows(B, L):
    """K2.bf16 at BERT-base width: its q/k/v product on the persistent
    kernel from 1,793 rows (where the 128 x 128 wgmma tiles took over
    before: 15 row tiles of 18 column tiles), its o-projection, and
    K6b.bf16 by the same plan, from 5,505 (6 column tiles, as K3.bf16's
    fc2); below each edge the first port's plan.  The plan hands both grids
    to csrc/bert_attn.cu after the attention plan, and K6b.bf16's grid to
    csrc/bert_ffn.cu after its BfPlan."""
    rows, h = B * L, 768
    blk = bert_attn_cuda._plan_attn_block_bf16(B, L, h, 12)
    assert blk["qkv"]["wgmma"] == (2 if rows >= 1793 else 0)
    assert blk["o"]["wgmma"] == (2 if rows >= 5505 else 0)
    for name, n in (("qkv", 3 * h), ("o", h)):
        p = blk[name]
        if p["wgmma"] == 2:
            assert _first_port_bf16(rows, n, h)["wgmma"] == 1
            assert p["partial"] == 0 and p["grid"] == min(p["tiles"], SMS)
            assert p["tiles"] == -(-rows // gemm_tc.BP_BM) * (n // gemm_tc.BP_BN)
        else:
            assert p == _first_port_bf16(rows, n, h)
    ints, _, _ = bert_attn_cuda._cached_block_plan_bf16(B, L, h, 12, SMS, 0, 0, 0)
    assert len(ints) == 18
    assert list(ints)[16:] == [blk[k].get("grid", 0) for k in ("qkv", "o")]
    ints, _, partial = bert_ffn_cuda._cached_proj_ln_plan_bf16(rows, h, SMS, 0, 0, 0)
    assert list(ints) == [blk["o"][k] for k in gemm_tc.BF_PLAN_KEYS] + [blk["o"].get("grid", 0)]
    assert partial == blk["o"]["partial"]


@pytest.mark.parametrize("h", [192, 384, 768, 1152])
def test_bf16_qkv_persistent_tiles_stay_in_one_plane(h):
    """The persistent q/k/v product reads the gated weights [3, h, h] through
    one tensor map over their 3h rows: each 192-wide column tile lies in one
    plane (its columns col0 .. col0 + 191 in plane col0 // h), its k boxes
    of 64 rows in that plane's h rows, and the tiles cover the 3h columns
    once; the block's shared memory fits a block's 227 KB."""
    p = gemm_tc.plan_bf16(131072, 3 * h, h, 8, 8, SMS, persistent=True, gate=h)
    assert p["wgmma"] == 2 and p["smem"] <= MAX_SMEM
    bn, bk = gemm_tc.BP_BN, gemm_tc.BP_BK
    cols = [c * bn for c in range(3 * h // bn)]
    assert len(cols) * bn == 3 * h
    for col0 in cols:
        plane = col0 // h
        assert (col0 + bn - 1) // h == plane
        assert all(plane * h <= plane * h + k0 and k0 + bk <= h
                   for k0 in range(0, p["kps"] * bk, bk))
    assert p["kps"] * bk == h


@pytest.mark.parametrize("h", [640, 704, 896, 200])
def test_bf16_qkv_plan_refuses_gates_that_straddle_tiles(h):
    """A gate width that 192 does not divide (640, 704, 896), or a K that 64
    does not (200, wgmma needs K a multiple of 8 as well), keeps the gated
    q/k/v product off the persistent kernel; the same product ungated
    (gate None: one plane) would take it."""
    gated = gemm_tc.plan_bf16(131072, 3 * h, h, 8, 8, SMS, persistent=True, gate=h)
    plain = gemm_tc.plan_bf16(131072, 3 * h, h, 8, 8, SMS, persistent=True)
    assert gated == _first_port_bf16(131072, 3 * h, h) and gated["wgmma"] == 1
    assert plain["wgmma"] == 2


def test_bf16_proj_ln_plan_needs_an_aligned_residual():
    """The persistent epilogue reads the residual in 16-byte pieces: a
    residual off a 16-byte boundary keeps K6b.bf16's product, and K2.bf16's
    o-projection (x, the residual, then also sends the q/k/v product's A to
    narrower copies), on the first port's tiles."""
    p = bert_ffn_cuda._plan_proj_ln_bf16(131072, 768, resid_addr=8)
    assert p == _first_port_bf16(131072, 768, 768)
    blk = bert_attn_cuda._plan_attn_block_bf16(4096, 32, 768, 12, x_addr=8)
    assert blk["o"]["wgmma"] == 1 and blk["qkv"]["wgmma"] == 0


def test_ffn_bf16_plan_is_unchanged_at_the_training_and_serving_rows():
    """K3.bf16's plans, which the gated persistent path must leave alone:
    at 131,072 rows both products on the persistent kernel with these
    exact plans, at 8 rows both on the mma.sync tiles split over K."""
    p = bert_ffn_cuda._plan_ffn_bf16(131072, 768, 3072)
    common = {"wgmma": 2, "splits": 1, "acw": 8, "bcw": 8, "partial": 0, "grid": SMS,
              "smem": 216128}
    assert p["fc1"] == {**common, "kps": 12, "tiles": 1024 * 16}
    assert p["fc2"] == {**common, "kps": 48, "tiles": 1024 * 4}
    ints, _, partial = bert_ffn_cuda._cached_ffn_plan_bf16(131072, 768, 3072, SMS, 0, 0, 0)
    assert list(ints) == [2, 1, 12, 8, 8, 2, 1, 48, 8, 8, SMS, SMS] and partial == 0
    q = bert_ffn_cuda._plan_ffn_bf16(8, 768, 3072)
    assert q["fc1"] == {"wgmma": 0, "splits": 8, "kps": 3, "acw": 8, "bcw": 8,
                        "partial": 8 * 8 * 3072}
    assert q["fc2"] == {"wgmma": 0, "splits": 16, "kps": 6, "acw": 8, "bcw": 8,
                        "partial": 16 * 8 * 768}


# The bf16 instances of K5f, K5b, K5dq and K5dkv convert their bf16
# operands to float32 as they stage them (through registers: a bf16 row
# of D = 25 starts on a 2-byte boundary), into the float32 carve-up, so
# they run by the float32 plans.  These cases check the plans at the shapes
# chip_smoke.py gives the bf16 instances: the MOSEI self and cross stacks
# (B=4096, 8 heads of 25), the long causal shape (B=16 T=2048), the T=96
# stack at B=8, and odd T at D = 25 (B=3).
_BF16_FLASH_SHAPES = [(4096 * 8, 50, 50, 25), (4096 * 8, 50, 32, 25), (16 * 8, 2048, 2048, 25),
                      (8 * 8, 96, 96, 25), (3 * 8, 7, 7, 25), (3 * 8, 9, 7, 25),
                      (3 * 8, 9, 9, 25)]


@pytest.mark.parametrize("bh,tq,tk,D", _BF16_FLASH_SHAPES)
def test_flash_plans_at_the_bf16_shapes(bh, tq, tk, D):
    unit = tq <= 64 and tk <= 64
    fwd = attention_cuda._plan_flash_fwd(bh, tq, tk, D)
    bwd = attention_cuda._plan_flash_bwd(bh, tq, tk, D)
    assert fwd["path"] == bwd["path"] == (0 if unit else 1)
    # a staged row: 25 floats padded to 32, a stride of 36 (4 mod 8)
    assert fwd["ld"] == 36 and fwd["smem"] == _flash_fwd_smem(fwd) <= MAX_SMEM
    if unit:
        assert bwd["ld"] == 36 and bwd["smem"] == _flash_bwd_smem(bwd) <= MAX_SMEM
        assert bwd["qp8"] == 8 * -(-tq // 8) and bwd["kp8"] == 8 * -(-tk // 8)
        return
    dq = attention_cuda._plan_flash_dq(bh, tq, tk, D)
    dkv = attention_cuda._plan_flash_dkv(bh, tq, tk, D)
    assert dq["smem"] == _flash_dq_smem(dq) <= MAX_SMEM and dq["bq"] == 64
    assert dkv["smem"] == _flash_dkv_smem(dkv) <= MAX_SMEM
    assert dkv["blocks"] == -(-tk // 64) * bh and dq["blocks"] == -(-tq // 64) * bh


# The bf16 instances of K8, K7f and K7b stage or upcast their bf16 operands
# into the float32 kernels' carve-up, so they run by the float32 plans
# (``_plan_attention``, ``_plan_recurrence``, ``_plan_gru_rec_bwd``), held
# above.  K9's bf16 instance runs its products on csrc/gemm_bf16.cuh by a
# plan of its own.
@pytest.mark.parametrize("E,F1", K9_BLOCKS)
def test_trunk_block_bf16_plans_fit_the_card(E, F1):
    """Each of K9.bf16's products is a ``gemm_tc.plan_bf16`` plan: ``u``
    and ``dp`` [R, E] x [E, F1], ``y`` and ``ds`` [R, F1] x [F1, E]; the
    reductions dW1 [F1, E] and dW2 [E, F1] over the R rows with A read
    transposed (the mma.sync kernel), split to fill two blocks an SM;
    copies as wide as E and F1 allow; ``partial`` the largest need."""
    for R in _k9_rows(E):
        p = trunk_block_cuda._plan_block_bf16(R, E, F1)
        shapes = {"u": (R, F1, E), "y": (R, E, F1), "dp": (R, F1, E), "ds": (R, E, F1),
                  "dw1": (F1, E, R), "dw2": (E, F1, R)}
        for name, (m, n, k) in shapes.items():
            q = p[name]
            ktiles = -(-k // gemm_tc.BF_BK)
            if q["wgmma"]:
                assert name not in ("dw1", "dw2") and q["acw"] == 8 and k % 8 == 0
            else:
                assert (q["splits"] - 1) * q["kps"] < ktiles <= q["splits"] * q["kps"]
            assert k % q["acw"] == 0 if name not in ("dw1", "dw2") else m % q["acw"] == 0
            assert n % q["bcw"] == 0
        assert p["u"] == p["dp"] and p["y"] == p["ds"]
        assert p["partial"] == max(p[k]["partial"] for k in trunk_block_cuda.BF16_PRODUCTS)
        assert p["ln_tiles"] == -(-R // 32)
        assert len(trunk_block_cuda.plan_ints_bf16(p)) == 30


def test_trunk_block_bf16_plan_paths():
    """At R=4096 the top FFN's products stay on the mma.sync tiles (224 or
    256 tiles of 128 x 128, under two an SM) unsplit and the stream
    blocks' 64 tiles split in four; the reductions split over the rows;
    at R=1 every product splits over K across the card."""
    p = trunk_block_cuda._plan_block_bf16(4096, 1000, 800)
    assert [(p[k]["wgmma"], p[k]["splits"]) for k in ("u", "y", "dp", "ds")] == [(0, 1)] * 4
    assert p["dw1"]["splits"] == p["dw2"]["splits"] == 4
    p = trunk_block_cuda._plan_block_bf16(4096, 200, 200)
    assert all(p[k]["splits"] == 4 for k in ("u", "y", "dp", "ds"))
    p = trunk_block_cuda._plan_block_bf16(1, 1000, 800)
    assert all(p[k]["splits"] > 1 for k in ("u", "y", "dp", "ds"))
    assert all(p[k]["acw"] == p[k]["bcw"] == 8 for k in trunk_block_cuda.BF16_PRODUCTS)
    assert trunk_block_cuda._plan_block_bf16(13, 30, 50)["u"]["bcw"] == 2


class _FakeLibBf16:
    """Records what the bf16 trunk-block entries are handed."""

    def __init__(self):
        self.calls = {}

    def _record(self, name, args):
        ints = (ctypes.c_int * 30).from_address(args[-2])
        self.calls[name] = {"plan": list(ints), "args": args}
        return 0

    def mmtr_trunk_block_fwd_bf16(self, *args):
        return self._record("fwd", args)

    def mmtr_trunk_block_bwd_bf16(self, *args):
        return self._record("bwd", args)


@pytest.mark.parametrize("R,E,F1", [(13, 30, 50), (8, 200, 800)])
@pytest.mark.parametrize("params_bf16", [False, True])
def test_trunk_block_bf16_wrapper_allocates_what_the_plan_says(monkeypatch, R, E, F1,
                                                                params_bf16):
    """Through the bf16 launch paths with the C entries replaced: both get
    the same 30 plan ints, every scratch view is the plan's size and dtype
    on a 256-byte boundary, the weights reach the kernels in bf16 (as
    stored and transposed) and the vectors in float32, and each gradient
    comes back in its parameter's dtype."""
    lib = _FakeLibBf16()
    views = []
    real_workspace = trunk_block_cuda._workspace

    def workspace(dev, wanted):
        got = real_workspace(dev, wanted)
        views.append([(v.numel(), v.dtype) for v in got])
        assert all((v.data_ptr() - got[0].data_ptr()) % 256 == 0 for v in got if v.numel())
        return got

    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(_build, "num_sms", lambda dev: SMS)
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(trunk_block_cuda, "_workspace", workspace)
    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    x, src, dout = (torch.randn(R, E, generator=g).to(bf) for _ in range(3))
    params = [torch.randn(F1, E, generator=g), torch.randn(F1, generator=g),
              torch.randn(E, F1, generator=g), torch.randn(E, generator=g),
              torch.ones(E), torch.zeros(E)]
    if params_bf16:
        params = [p.to(bf) for p in params]
    masks = [torch.ones(E), torch.ones(F1), torch.ones(E)]
    cfg = trunk_block_cuda.BlockConfig("relu", 1, 0.1, 0.3, 1, 2, True, True)
    dev = torch.device("cpu")
    out = trunk_block_cuda._launch_fwd_bf16(dev, x, src, *params, *masks, cfg)
    grads = trunk_block_cuda._launch_bwd_bf16(dev, x, src, dout, *params, *masks, cfg)
    plan = trunk_block_cuda._plan_block_bf16(R, E, F1)
    ints = trunk_block_cuda.plan_ints_bf16(plan)
    assert lib.calls["fwd"]["plan"] == lib.calls["bwd"]["plan"] == ints
    assert views == [trunk_block_cuda.fwd_workspace_bf16(plan, R, E, F1),
                     trunk_block_cuda.bwd_workspace_bf16(plan, R, E, F1)]
    assert out.shape == (R, E) and out.dtype == bf
    assert [(tuple(a.shape), a.dtype) for a in grads] == [((R, E), bf)] + [
        (tuple(p.shape), p.dtype) for p in params]
    for name, npt in (("fwd", 15), ("bwd", 23)):
        assert lib.calls[name]["args"][npt:npt + 9] == (R, E, F1, 1, 1, 1, 1, 1, 2)
