"""The device split of K2.bf16 and K6b.bf16 at bench.py's training shape,
under this tree's launch plans and under the parent commit's
(``chip_smoke.parent_plans``), beside cuBLAS's bf16 products alone.

K2.bf16 (the frozen BERT's attention block) at B=4096 L=32, h=768, 12
heads, under both softmax rules (float32, and the bf16 tail of
``ATTN_SOFTMAX="bfloat16"``): torch.profiler's device ms by kernel (the
weights' transposes where a plan makes them, the q/k/v product, the
attention stage, the o-projection, the LayerNorm) and the CUDA-event ms of
a call.  K6b.bf16 (K2.bf16's tail alone: the o-projection and the
LayerNorm) at the same rows.  The yardstick: ``torch.matmul`` of bf16
[131072, 768] x [768, 2304] and [131072, 768] x [768, 768] (cuBLAS, the two
products alone; not a call that computes K2's or K6b's function).  Prints
the card's name and power limit, one line per case and plan set, and a last
JSON line with every number.

    PYTHONPATH=. python3 tools/k2_k6b_bf16_split.py [--parent]

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
from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda, bert_ffn_cuda


def cases(dev, rng, B=4096, L=32, h=768, heads=12):
    """[(name, fn, iters)] on bf16 inputs from ``rng`` (q/k/v weights stacked
    as ``models.bert.prepare_bert`` makes them)."""
    bf = torch.bfloat16

    def t(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(
            dev, bf)

    wqkv, bqkv = t((3, h, h), 0.02), t((3 * h,), 0.02)
    wo, bo = t((h, h), 0.02), t((h,), 0.02)
    g, b = (1.0 + t((h,), 0.1).float()).to(bf), t((h,), 0.1)
    x = t((B, L, h))
    mask = np.zeros((B, L), np.float32)
    mask[0, : L // 2] = 1.0
    for i in range(1, B):
        mask[i, : rng.integers(1, L + 1)] = 1.0
    mask = torch.from_numpy(mask).to(dev)
    a_args = (x, mask, wqkv[0], bqkv[:h], wqkv[1], bqkv[h:2 * h], wqkv[2], bqkv[2 * h:],
              wo, bo, g, b)
    out = []
    for softmax in ("float32", "bfloat16"):
        out.append((f"K2.bf16 B={B} L={L} h={h} softmax={softmax}",
                    lambda s=softmax: bert_attn_cuda.attention_block_fused(
                        *a_args, n_heads=heads, eps=1e-12, softmax_dtype=s), 5))
    p_args = (x, t((B, L, h)), wo, bo, g, b)
    out.append((f"K6b.bf16 B={B} L={L} h={h}",
                lambda: bert_ffn_cuda.proj_ln_block(*p_args, eps=1e-12), 5))
    return out


def measure(case_list, parent: bool) -> dict:
    res = {}
    with cs.parent_plans() if parent else contextlib.nullcontext():
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


def cublas(dev, rng, M=131072, h=768) -> dict:
    """CUDA-event ms of torch.matmul at K2's two products, bf16."""
    a = torch.from_numpy(rng.standard_normal((M, h)).astype(np.float32)).to(dev, torch.bfloat16)
    out = {}
    for name, n in (("qkv", 3 * h), ("o", h)):
        w = torch.from_numpy(rng.standard_normal((h, n)).astype(np.float32) * 0.02).to(
            dev, torch.bfloat16)
        out[name] = cs.cuda_ms(lambda w=w: torch.matmul(a, w), 5)
        print(f"cuBLAS bf16 {name} [{M}, {h}] x [{h}, {n}]: {out[name]:.4f} ms", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", action="store_true",
                    help="also measure under the parent's plans, in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    _build.load_library()
    print(f"build {_build.BuildInfo.seconds:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    case_list = cases(dev, np.random.default_rng(5))
    order = (True, False, False, True) if args.parent else (False,)
    runs = [{"plans": "parent" if p else "tree", "cases": measure(case_list, p)} for p in order]
    result = {"card": card.strip(), "runs": runs,
              "cublas_ms": cublas(dev, np.random.default_rng(6))}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
