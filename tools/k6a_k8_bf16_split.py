"""The device split of K6a.bf16 and K8.bf16 (and K2.bf16, whose attention
stage is K6a.bf16's kernel) at bench.py's training shape, under this tree's
launch plans and under the parent commit's (``chip_smoke.parent_plans``),
beside a plain copy that moves the same bytes.

K6a.bf16 (``dense_attention_blockdiag`` on bf16 q / k / v [B, L, 12, 64],
a ragged float key mask) and K8.bf16 (``flash_attention_masked`` on bf16
[B, 12, L, 64], a ragged int32 key mask with one all-zero row) at B=4096
L=32; K2.bf16 (``attention_block_fused``, h = 768, float32 softmax) at the
same rows: torch.profiler's device ms by kernel and the CUDA-event ms of a
call.  ``--small`` adds K6a.bf16 and K8.bf16 at B = 1, 16, 32, 44, 64, 300 (L=32)
and B=1 L=8, where the tree's unit walk is forced at every unit count
(``bert_attn_cuda._WALK_MIN_UNITS`` set to 1), so the parent's block-a-unit
kernel and the walk are timed side by side where the grid is small.  The
yardstick: ``dst.copy_(src)`` of a bf16 [2, B*L, 768] tensor, which reads
two planes and writes two, the bytes K6a.bf16 and K8.bf16 must move (q, k,
v read, out written): the byte rate the card reaches on a plain stream.
Prints the card's name and power limit, one line per case and plan set,
and a last JSON line with every number.

    PYTHONPATH=. python3 tools/k6a_k8_bf16_split.py [--parent] [--small]

``--parent`` also measures every case under the parent's plans, in turns
(parent, tree, tree, parent).  Needs one card and nvcc.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
from multimodal_transformer_robustness_tpu_torch import _build
from multimodal_transformer_robustness_tpu_torch.ops import attention_cuda, bert_attn_cuda


def attention_cases(dev, rng, B, L, heads=12, dh=64):
    """[(name, fn, iters)]: K6a.bf16 and K8.bf16 at (B, L) on bf16 operands
    from ``rng``."""
    bf = torch.bfloat16
    iters = 5 if B >= 1024 else 20

    def t(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(
            dev, bf)

    q, k, v = (t((B, L, heads, dh)) for _ in range(3))
    mask = np.zeros((B, L), np.float32)
    mask[0, : L // 2] = 1.0
    for i in range(1, B):
        mask[i, : rng.integers(1, L + 1)] = 1.0
    mask = torch.from_numpy(mask).to(dev)
    qh, kh, vh = (t((B, heads, L, dh), s) for s in (dh ** -0.5, 1.0, 1.0))
    km = cs.ragged_key_mask(rng, B, L, dev)
    return [(f"K6a.bf16 B={B} L={L} {heads}x{dh}",
             lambda: bert_attn_cuda.dense_attention_blockdiag(q, k, v, mask), iters),
            (f"K8.bf16 B={B} L={L} {heads}x{dh}",
             lambda: attention_cuda.flash_attention_masked(qh, kh, vh, km), iters)]


def block_case(dev, rng, B=4096, L=32, h=768, heads=12):
    """K2.bf16 at (B, L), q/k/v weights stacked as ``models.bert.prepare_bert``
    makes them."""
    bf = torch.bfloat16

    def t(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(
            dev, bf)

    wqkv, bqkv = t((3, h, h), 0.02), t((3 * h,), 0.02)
    wo, bo = t((h, h), 0.02), t((h,), 0.02)
    g, b = (1.0 + t((h,), 0.1).float()).to(bf), t((h,), 0.1)
    x = t((B, L, h))
    mask = np.zeros((B, L), np.float32)
    for i in range(B):
        mask[i, : rng.integers(1, L + 1)] = 1.0
    mask = torch.from_numpy(mask).to(dev)
    args = (x, mask, wqkv[0], bqkv[:h], wqkv[1], bqkv[h:2 * h], wqkv[2], bqkv[2 * h:],
            wo, bo, g, b)
    return (f"K2.bf16 B={B} L={L} h={h}",
            lambda: bert_attn_cuda.attention_block_fused(*args, n_heads=heads, eps=1e-12), 5)


@contextlib.contextmanager
def walk_everywhere():
    """The tree's plans with the unit walk at every unit count."""
    old = bert_attn_cuda._WALK_MIN_UNITS
    bert_attn_cuda._WALK_MIN_UNITS = 1
    bert_attn_cuda._cached_plan_bf16.cache_clear()
    try:
        yield
    finally:
        bert_attn_cuda._WALK_MIN_UNITS = old
        bert_attn_cuda._cached_plan_bf16.cache_clear()


def measure(case_list, parent: bool, small: bool) -> dict:
    res = {}
    plans = cs.parent_plans() if parent else (walk_everywhere() if small
                                              else contextlib.nullcontext())
    with plans:
        for name, fn, iters in case_list:
            fn()
            torch.cuda.synchronize()
            per = cs.profile_ms(fn, iters)
            event = cs.cuda_ms(fn, iters)
            res[name] = {"event_ms": event, "device_ms": sum(per.values()), "kernels_ms": per}
            split = ", ".join(f"{k} {v:.4f}" for k, v in per.items()) or "no device time"
            print(f"{'parent' if parent else 'tree'} {name}: CUDA-event {event:.4f} ms, "
                  f"device {sum(per.values()):.4f}: {split}", flush=True)
    return res


def copy_yardstick(dev, rows=131072, h=768) -> dict:
    """CUDA-event ms of a bf16 [2, rows, h] copy (two planes read, two
    written), and its byte rate."""
    src = torch.randn(2, rows, h, device=dev).to(torch.bfloat16)
    dst = torch.empty_like(src)
    ms = cs.cuda_ms(lambda: dst.copy_(src), 20)
    nbytes = 2 * src.numel() * src.element_size()
    out = {"ms": ms, "bytes": nbytes, "tb_per_s": nbytes / ms / 1e9}
    print(f"copy bf16 [2, {rows}, {h}] -> same: {ms:.4f} ms, {nbytes / 1e9:.4f} GB moved, "
          f"{out['tb_per_s']:.3f} TB/s", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", action="store_true",
                    help="also measure under the parent's plans, in turns")
    ap.add_argument("--small", action="store_true",
                    help="also the small grids, the walk forced at every unit count")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    _build.load_library()
    print(f"build {_build.BuildInfo.seconds:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(5)
    case_list = attention_cases(dev, rng, 4096, 32) + [block_case(dev, rng)]
    small = []
    if args.small:
        for B, L in ((1, 8), (1, 32), (16, 32), (32, 32), (44, 32), (64, 32), (300, 32)):
            small += attention_cases(dev, rng, B, L)
    order = (True, False, False, True) if args.parent else (False,)
    runs = [{"plans": "parent" if p else "tree", "cases": measure(case_list, p, False)}
            for p in order]
    if small:
        runs += [{"plans": ("parent" if p else "tree") + " small",
                  "cases": measure(small, p, True)} for p in order]
    result = {"card": card.strip(), "runs": runs, "copy": copy_yardstick(dev)}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
