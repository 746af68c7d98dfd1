"""The device split of K3.bf16 and K1b.bf16 at bench.py's training shapes,
under this tree's launch plans and under the parent commit's
(``chip_smoke.parent_plans``), beside cuBLAS's bf16 products alone.

K3.bf16 (the frozen BERT's FFN block) at B=4096 L=32, h=768, ffn=3072:
torch.profiler's device ms by kernel (the weights' transposes where a plan
makes them, fc1, fc2, the LayerNorm) and the CUDA-event ms of a call.
K1b.bf16 (a GRU direction's backward) at in = 768 and 512 without dx and
in = 200 with it, H=100, T=50, B=4096: the recurrence, dx, the dwp and dwt
reductions and their sums.  The yardstick: ``torch.matmul`` of bf16
[131072, 768] x [768, 3072] and [131072, 3072] x [3072, 768] (cuBLAS, the
two products alone; not a call that computes K3's function).  Prints the
card's name and power limit, one line per case and plan set, and a last
JSON line with every number.

    PYTHONPATH=. python3 tools/k3_k1b_bf16_split.py [--parent]

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
from multimodal_transformer_robustness_tpu_torch.ops import bert_ffn_cuda, bigru_cuda


def cases(dev, rng, B=4096, L=32, h=768, ffn=3072, T=50, H=100):
    """[(name, fn, iters)] on bf16 inputs from ``rng``."""
    bf = torch.bfloat16

    def t(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(
            dev, bf)

    out = []
    f_args = (t((B, L, h)), t((h, ffn), 0.02), t((ffn,), 0.02), t((ffn, h), 0.02),
              t((h,), 0.02), (1.0 + t((h,), 0.1).float()).to(bf), t((h,), 0.1))
    out.append((f"K3.bf16 B={B} L={L} h={h} ffn={ffn}",
                lambda: bert_ffn_cuda.ffn_ln_block(*f_args, eps=1e-12), 5))
    for in_dim, need_dx in ((768, False), (512, False), (200, True)):
        w = {k: v.to(bf) for k, v in cs.gru_weights(rng, in_dim, H, dev).items()}
        ops = bigru_cuda.dir_operands(w)
        args = tuple(ops[k] for k in ("wp", "wt", "bc", "bhn"))
        x, dhs = t((T, B, in_dim)), t((T, B, H))
        hs, gates = bigru_cuda._launch_fwd(x, *args, False)
        out.append((f"K1b.bf16 in={in_dim} H={H} T={T} B={B} need_dx={need_dx}",
                    lambda x=x, a=args, hs=hs, g=gates, d=dhs, n=need_dx:
                    bigru_cuda.gru_dir_bwd(x, *a, hs, g, d, False, n), 5))
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


def cublas(dev, rng, M=131072, h=768, ffn=3072) -> dict:
    """CUDA-event ms of torch.matmul at K3's two products, bf16."""
    def t(shape):
        a = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(a).to(dev, torch.bfloat16)

    out = {}
    for name, (a, b) in (("fc1", (t((M, h)), t((h, ffn)) * 0.02)),
                         ("fc2", (t((M, ffn)), t((ffn, h)) * 0.02))):
        out[name] = cs.cuda_ms(lambda a=a, b=b: torch.matmul(a, b), 5)
        print(f"cuBLAS bf16 {name} [{a.shape[0]}, {a.shape[1]}] x [{b.shape[0]}, "
              f"{b.shape[1]}]: {out[name]:.4f} ms", flush=True)
        del a, b
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
