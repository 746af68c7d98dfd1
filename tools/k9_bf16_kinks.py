"""How far K9b's bf16 plain version stands from other correct answers at
relu's kink, on the CPU, at the MOSEI FFN blocks' widths (R=4096, two
seeds).

Two comparisons, each gradient leaf apart:
  * against the float32 plain version on the same bf16-valued x, src and
    dout, with the float32 weights as given and with them at their bf16
    values (the bf16 instance casts them): the cosine per leaf;
  * against itself with the LayerNorm's moments summed in float64 (another
    order, as the kernel's row pass sums them): the largest difference per
    leaf, raw and beyond ``trunk_block_cuda.relu_kink_bound``'s allowance,
    as a share of the leaf's max |ref|.

    PYTHONPATH=. python3 tools/k9_bf16_kinks.py
"""

from __future__ import annotations

import os
import sys
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from multimodal_transformer_robustness_tpu_torch.ops import trunk_block_cuda as tb  # noqa: E402

LEAVES = "dsrc dw1 db1 dw2 db2 dln_g dln_b".split()


def ln_float64(src, ln_g, ln_b, m_in):
    """``trunk_block_cuda._masked_ln`` with its moments summed in float64."""
    s, g, b, m = (a.double() for a in (src, ln_g, ln_b, m_in))
    n = torch.clamp(m.sum(), min=1.0)
    mu = (s * m).sum(-1, keepdim=True) / n
    diff = (s - mu) * m
    inv = torch.rsqrt((diff * diff).sum(-1, keepdim=True) / n + tb._EPS)
    t = (s - mu) * inv
    return ((t * g + b) * m).float(), t.float(), inv.float(), n.float()


def main() -> None:
    bf = torch.bfloat16
    for seed in (20, 21):
        rng = np.random.default_rng(seed)
        for name, E, F1, act, rep, cross, masked in chip_smoke.TRUNK_BLOCKS:
            if act != "relu":   # no kink
                continue
            x, src, dout, params, masks = chip_smoke.trunk_block_operands(rng, 4096, E, F1,
                                                                          masked, "cpu")
            x, src, dout = (a.to(bf) for a in (x, src, dout))
            src = src if cross else x
            cfg = tb.BlockConfig(act, rep, 0.1, 0.3, int(rng.integers(-2**31, 2**31 - 1)),
                                 int(rng.integers(-2**31, 2**31 - 1)), True, True)
            args = (x, src, dout, *params, *masks, cfg)
            got = tb.trunk_block_bwd_plain(*args)
            f32 = [a.float() for a in (x, src, dout)]
            rounded = [p.to(bf).float() if p.dim() == 2 else p for p in params]
            for label, ps in (("float32 weights", params), ("weights at bf16", rounded)):
                ref = tb.trunk_block_bwd_plain(*f32, *ps, *masks, cfg)
                cos = [chip_smoke.cosine(a.float(), r) for a, r in zip(got, ref)]
                print(f"seed {seed} {name}: cosine vs float32, {label}: "
                      + ", ".join(f"{n} {c:.7f}" for n, c in zip(LEAVES, cos)))
            with mock.patch.object(tb, "_masked_ln", ln_float64):
                other = tb.trunk_block_bwd_plain(*args)
            near, slack = tb.relu_kink_bound(*args)
            parts = []
            for n, a, r, s in zip(LEAVES, other, got, slack):
                d, scale = (a.float() - r.float()).abs(), max(r.float().abs().max().item(), 1e-30)
                parts.append(f"{n} {d.max().item() / scale:.2e} / "
                             f"{(d - s).clamp(min=0).max().item() / scale:.2e}")
            print(f"seed {seed} {name}: LN moments in float64, raw / beyond the allowance "
                  f"({near} entries of u in the band): " + ", ".join(parts))


if __name__ == "__main__":
    main()
