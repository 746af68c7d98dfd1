"""Launch plans of ``csrc/gemm_tc.cuh``'s 3xTF32 tensor-core products.

The products run only on the card, but their plans are computed here, on
the host, so that the CPU tests can hold them to what an H100 takes
(``tests/test_torch_launch_plans.py``).  The constants mirror the header's.
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
