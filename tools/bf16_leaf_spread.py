"""How the bf16 policy's card-vs-CPU gradient gap spreads over the leaves of
an encoder stack, flash attention beside the dense ("xla") attention: the
stacks of ``chip_smoke.py``'s flash-stack-bf16 phase (MOSEI widths, 8 heads
of 25, FFN 800; cross 4 layers Tq=50 Tk=32, self 3 layers T=50, self 3
layers T=96), B=8, train mode with every dropout 0, the weights from seed
0, the float32 gradients of ``mean(y * ct)`` on the card and on the CPU,
for four input seeds.  For each leaf (the stacked q / k / v projections
split into their parts, as ``chip_smoke.qkv_apart``) and attention route:
the largest error of max |ref|, the relative L2 error and the cosine, card
against CPU.
Prints the leaves whose flash / xla ratio of each measure is largest, the
lowest cosines, and a last JSON line of the extremes.

Run from the repository root on a card:

    python3 tools/bf16_leaf_spread.py
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402
from multimodal_transformer_robustness_tpu_torch import _build  # noqa: E402
from multimodal_transformer_robustness_tpu_torch.models.mult import (  # noqa: E402
    cast_tree, to_device)
from multimodal_transformer_robustness_tpu_torch.ops.encoder import (  # noqa: E402
    EncoderHParams, EncoderMasks, encoder_forward, init_encoder)
from multimodal_transformer_robustness_tpu_torch.train.loop import tree_leaves  # noqa: E402

STACKS = (("cross", 4, 50, 32), ("self", 3, 50, None), ("self T=96", 3, 96, None))
B, SEEDS = 8, 4


def gradients(params, hp, x, kv, ct, device, dt=torch.bfloat16):
    """The float32 gradients of a bf16 stack's ``mean(y * ct)``, as float64
    on the CPU."""
    p = to_device(params, device)
    leaves = [a.requires_grad_(True) for a in tree_leaves(p)]
    m = EncoderMasks(*(torch.ones(n, device=device, dtype=dt)
                       for n in (hp.layers, hp.num_heads, hp.head_dim,
                                 4 * hp.num_heads * hp.head_dim)))
    y = encoder_forward(cast_tree(p, dt), x.to(device, dt),
                        None if kv is None else kv.to(device, dt), hp=hp, masks=m,
                        attn_rate=0.0, train=True,
                        generator=torch.Generator(device=device).manual_seed(0))
    g = torch.autograd.grad((y.float() * ct.to(device)).mean(), leaves)
    return [a.detach().double().cpu() for a in g]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script compares the card with the CPU")
    _build.load_library()
    dev = torch.device("cuda", 0)
    spec, _ = smoke.mosei()
    rows = []
    for stack, layers, tq, tk in STACKS:
        hp = EncoderHParams(embed_dim_in=spec.dimension, num_heads=spec.num_heads,
                            head_dim=spec.head_dim, layers=layers, attn_mask=True,
                            attn_impl="flash")
        params = init_encoder(torch.Generator().manual_seed(0), hp)
        names = smoke.leaf_names(params)
        leaf_names = smoke.qkv_apart(names, tree_leaves(params))[0]
        for seed in range(SEEDS):
            rng = np.random.default_rng(100 + seed)
            x, ct = (torch.from_numpy(rng.standard_normal((B, tq, spec.dimension),
                                                          dtype=np.float32)) for _ in range(2))
            kv = (torch.from_numpy(rng.standard_normal((B, tk, spec.dimension), dtype=np.float32))
                  if tk else None)
            got = {}
            for impl in ("flash", "xla"):
                h = dataclasses.replace(hp, attn_impl=impl)
                got[impl] = [smoke.qkv_apart(names, gradients(params, h, x, kv, ct, d))[1]
                             for d in (dev, "cpu")]
            for i, name in enumerate(leaf_names):
                row = {"stack": stack, "seed": seed, "leaf": name}
                for impl, (card, cpu) in got.items():
                    a, b = card[i], cpu[i]
                    row[impl] = {"max_rel": smoke.errors(a, b)[1],
                                 "l2_rel": ((a - b).norm() / b.norm().clamp_min(1e-300)).item(),
                                 "cos": smoke.cosine(a, b)}
                rows.append(row)
        print(f"{stack}: {SEEDS} seeds, {len(leaf_names)} leaves", flush=True)

    for measure in ("max_rel", "l2_rel"):
        print(f"largest flash / xla ratios of {measure}:")
        for r in sorted(rows, key=lambda r: -r["flash"][measure]
                        / max(r["xla"][measure], 1e-30))[:6]:
            print(f"  {r['stack']} seed {r['seed']} {r['leaf']}: flash "
                  f"{r['flash'][measure]:.3e}, xla {r['xla'][measure]:.3e}")
    print("lowest flash cosines:")
    for r in sorted(rows, key=lambda r: r["flash"]["cos"])[:6]:
        print(f"  {r['stack']} seed {r['seed']} {r['leaf']}: flash {r['flash']['cos']:.7f}, "
              f"xla {r['xla']['cos']:.7f}")
    summary = {f"{impl}_{k}": (min if k == "cos" else max)(r[impl][k] for r in rows)
               for impl in ("flash", "xla") for k in ("max_rel", "l2_rel", "cos")}
    summary["max_rel_ratio_flash_over_xla"] = max(
        r["flash"]["max_rel"] / max(r["xla"]["max_rel"], 1e-30) for r in rows)
    summary["leaves_compared"] = len(rows)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
