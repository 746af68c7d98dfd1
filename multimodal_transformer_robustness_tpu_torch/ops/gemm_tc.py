"""Launch plans of ``csrc/gemm_tc.cuh``'s 3xTF32 tensor-core products and
of ``csrc/gemm_bf16.cuh``'s bf16 ones.

The products run only on the card, but their plans are computed here, on
the host, so that the CPU tests can hold them to what an H100 takes
(``tests/test_torch_launch_plans.py``).  The constants mirror the headers'.
"""

from __future__ import annotations

from .. import _build

BK, STAGES, LDA = 32, 3, 36                # k step, mma.sync ring, A's padded row
WG_BM, WG_STAGES = 128, 4                  # the wgmma tile's rows and ring
WG_WIDTHS = (104, 128, 152)                # the wgmma column tiles the header instantiates
PROMOTED_WIDTHS = (104, 128)               # with promoted sums (BN / 2 more registers)
SMALL_BM = SMALL_BN = 64                   # the mma.sync tile
TN_BM, TN_BN, TN_LDA, TN_LDB = 128, 80, 136, 88   # the transposed-A reduction tile
TN_BLOCKS_PER_SM = 2
SMALL_SMEM = 4 * STAGES * (SMALL_BM * LDA + BK * (SMALL_BN + 8))
TN_SMEM = 4 * STAGES * BK * (TN_LDA + TN_LDB)
PLAN_KEYS = ("wgmma", "vec", "splits", "bn")


def wgmma_width(n: int, widths=WG_WIDTHS) -> int:
    """The wgmma column tile for ``n`` columns, one of ``widths``: the
    fewest padded columns, the wider tile on a tie (152 at the GRU's 300,
    128 at the BERT FFN's 3072 and 768, 104 at K1b's dx over 200)."""
    return min(widths, key=lambda w: (-(-n // w) * w, -w))


def wgmma_smem(bn: int) -> int:
    """A wgmma block's shared memory: a 4-stage ring of A [128][32] and
    B's two TF32 planes [bn][32], + 1 KB to align the swizzle atoms."""
    return 4 * WG_STAGES * (WG_BM + 2 * bn) * BK + 1024


def plan_product(M: int, N: int, K: int, vec: bool, num_sms: int = _build.NUM_SMS,
                 max_splits: int = 8, widths=WG_WIDTHS) -> dict:
    """One ``[M, K] x [K, N]`` product: the wgmma tiles (128 rows by
    :func:`wgmma_width` of ``widths``: :data:`PROMOTED_WIDTHS` for a
    product that promotes its sums) where they give every SM at least two blocks and
    the copies can be 16 bytes wide (``vec``), else the 64 x 64 mma.sync
    tiles split over K into up to ``max_splits`` ranges of at least 3 k
    tiles while that still leaves two blocks an SM or fewer, and no range
    empty.  ``scratch``: the floats either needs (B's TF32 planes, or the
    split planes)."""
    bn = wgmma_width(N, widths)
    wgmma = int(vec and -(-M // WG_BM) * -(-N // bn) >= 2 * num_sms)
    splits = 1
    if not wgmma:
        ktiles = -(-K // BK)
        tiles = -(-M // SMALL_BM) * -(-N // SMALL_BN)
        splits = max(1, min(max_splits, 2 * num_sms // tiles, ktiles // 3))
        splits = -(-ktiles // -(-ktiles // splits))
    return {"wgmma": wgmma, "vec": int(vec), "splits": splits, "bn": bn,
            "smem": wgmma_smem(bn) if wgmma else SMALL_SMEM,
            "scratch": 2 * N * K if wgmma else (splits * M * N if splits > 1 else 0)}


def plan_tn(M: int, N: int, K: int, num_sms: int = _build.NUM_SMS) -> dict:
    """A reduction over very long K with A stored transposed
    (``gemm_tc_tn_kernel``, 128 x 80 tiles, two blocks an SM): split over K
    into the k ranges that fill one wave of the card, no range empty.
    ``partial``: the floats of its planes."""
    ktiles = -(-K // BK)
    tiles = -(-M // TN_BM) * -(-N // TN_BN)
    splits = max(1, min(ktiles, TN_BLOCKS_PER_SM * num_sms // tiles))
    kps = -(-ktiles // splits)
    splits = -(-ktiles // kps)
    return {"splits": splits, "kps": kps, "partial": splits * M * N}


# csrc/gemm_bf16.cuh: the mma.sync kernel's 128 x 128 tiles, 32-deep k
# steps (two m16n8k16 MMAs) in a 4-stage ring, rows padded by 8 elements,
# two blocks an SM; the wgmma kernel's 128 x 128 tiles (m64n128k16), 64-deep
# k steps (128 bytes a row, as the TF32 tile's) in a 4-stage ring, one block
# an SM
BF_BM = BF_BN = 128
BF_BK, BF_STAGES, BF_MMA_K = 32, 4, 16
BF_LDK, BF_LDM, BF_LDN = BF_BK + 8, BF_BM + 8, BF_BN + 8
BF_SMEM = 2 * BF_STAGES * (max(BF_BM * BF_LDK, BF_BK * BF_LDM) + BF_BK * BF_LDN)
BF_BLOCKS_PER_SM = 2
BW_BK = 64
BW_SMEM = 2 * WG_STAGES * 2 * WG_BM * BW_BK + 1024
BF_PLAN_KEYS = ("wgmma", "splits", "kps", "acw", "bcw")
# the persistent kernel (gemm_bf16_persistent_kernel, K3.bf16's and K2.bf16's
# products, and K6b.bf16's):
# 128 x 192 tiles, 64-deep k tiles in a ring of 4 (A [128][64] and B
# [64][192], 128-byte rows), a bf16 staging tile of 128 rows of 200, the
# ring's mbarriers, + 1 KB to align the swizzle atoms; two MMA warpgroups,
# six epilogue warps and a producer warp, one block an SM
BP_BM, BP_BN, BP_BK, BP_STAGES, BP_LDS = 128, 192, 64, 4, 192 + 8
BP_THREADS = 2 * 128 + 6 * 32 + 32
BP_SMEM = (BP_STAGES * 2 * (BP_BM * BP_BK + BP_BK * BP_BN) + 2 * BP_BM * BP_LDS
           + 2 * BP_STAGES * 8 + 1024)
# the wgmma reduction (gemm_bf16_tn_kernel, K1b.bf16's dwp and dwt): 128 x 128 tiles,
# 64-deep k tiles of A and B ([64 k][128] each) in a TMA ring of 6, the
# ring's mbarriers, + 1 KB for the atoms; two MMA warpgroups and a producer
# warp, one block an SM
BT_BM, BT_BN, BT_BK, BT_STAGES = 128, 128, 64, 6
BT_SMEM = BT_STAGES * (2 * 2 * BT_BK * 128 + 16) + 1024


def bf16_copy_width(counts=(), addrs=()) -> int:
    """The widest copy, in bf16 elements (8, 4, 2 by cp.async; 1 through a
    register), that divides every element count in ``counts`` (row strides,
    a gated operand's gate width, a ones row's offset) and keeps every
    address in ``addrs`` (the operand's data pointer, or its residue mod 16)
    aligned to the copy."""
    return next(cw for cw in (8, 4, 2, 1)
                if all(c % cw == 0 for c in counts) and all(a % (2 * cw) == 0 for a in addrs))


def plan_bf16(M: int, N: int, K: int, acw: int, bcw: int, num_sms: int = _build.NUM_SMS,
              max_splits: int | None = 16, transposed_a: bool = False,
              persistent: bool = False, reduction: bool = False,
              gate: int | None = None) -> dict:
    """One ``[M, K] x [K, N]`` bf16 product on 128 x 128 tiles: the wgmma
    kernel where the tiles give every SM at least two and A takes 16-byte
    copies with K a multiple of 8 (``partial``: B^T's N * K bf16, in
    floats); else the mma.sync kernel, one split where the tiles give the
    card two blocks an SM, else K split into up to ``max_splits`` ranges
    (None: any number) while the tiles times the ranges fill no more than
    two blocks an SM, no range empty (``partial``: the floats of the split
    planes).  ``transposed_a``: A stored [K, M] (the reductions over T*B
    rows), which only the mma.sync kernel reads.  ``persistent`` (K2's
    and K3's products, K6b's): where the wgmma kernel would run and B takes
    16-byte copies too, the persistent kernel instead (``wgmma`` 2: 128 x
    192 tiles, B read as stored, no ``partial``; ``grid``: one block an SM,
    at most one a tile); a gated B (``gate``: its gate width and C's plane
    width, K2's q/k/v product over [3, h, h]) only where ``gate`` is a
    multiple of :data:`BP_BN` and ``K`` of :data:`BP_BK`, so that no column
    tile straddles two planes and no k tile reads into the next plane's
    rows.  ``reduction`` (K1b.bf16's dwp and dwt, A transposed): where A
    and B take 16-byte copies, the wgmma reduction instead (``wgmma`` 3: 128 x 128
    tiles, both operands read as stored, K split into ``splits`` ranges of
    ``kps`` 64-deep k tiles so that tiles x ranges fill one wave;
    ``partial``: its planes, even one)."""
    if transposed_a and reduction and acw == 8 and bcw == 8:
        ktiles = -(-K // BT_BK)
        tiles = -(-M // BT_BM) * -(-N // BT_BN)
        splits = max(1, min(ktiles, num_sms // tiles))
        kps = -(-ktiles // splits)
        splits = -(-ktiles // kps)
        return {"wgmma": 3, "splits": splits, "kps": kps, "acw": acw, "bcw": bcw,
                "partial": splits * M * N, "smem": BT_SMEM}
    tiles = -(-M // BF_BM) * -(-N // BF_BN)
    if not transposed_a and acw == 8 and K % 8 == 0 and tiles >= 2 * num_sms:
        gated_ok = gate in (None, N) or (gate % BP_BN == 0 and K % BP_BK == 0)
        if persistent and bcw == 8 and gated_ok:
            ptiles = -(-M // BP_BM) * -(-N // BP_BN)
            return {"wgmma": 2, "splits": 1, "kps": -(-K // BP_BK), "acw": acw, "bcw": bcw,
                    "partial": 0, "tiles": ptiles, "grid": min(ptiles, num_sms),
                    "smem": BP_SMEM}
        return {"wgmma": 1, "splits": 1, "kps": -(-K // BW_BK), "acw": acw, "bcw": bcw,
                "partial": -(-N * K // 2)}
    ktiles = -(-K // BF_BK)
    cap = ktiles if max_splits is None else min(max_splits, ktiles)
    splits = max(1, min(cap, BF_BLOCKS_PER_SM * num_sms // tiles))
    kps = -(-ktiles // splits)
    splits = -(-ktiles // kps)
    return {"wgmma": 0, "splits": splits, "kps": kps, "acw": acw, "bcw": bcw,
            "partial": splits * M * N if splits > 1 else 0}
