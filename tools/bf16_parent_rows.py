"""Kernel rows of two trees' port packages in one call: the kernels a change
redesigned and those it must leave as they were, each timed by CUDA events
(median of 20 warm calls, 5 at 4096 rows) and its output digested (sha256
of the bytes), on the same inputs from fixed seeds.

    PYTHONPATH=. python3 tools/bf16_parent_rows.py --trees build/parent,.

builds both trees' kernels at once (one process each), then measures the
trees in turns, first, second, second, first, each in a process of its own
whose ``multimodal_transformer_robustness_tpu_torch`` is that tree's, and
prints one JSON line per tree and turn: {row: {"ms": ..., "sha256": ...}}.
A row whose kernel is unchanged gives the same digest in both trees; its
times show the spread between turns.  ``--tree DIR`` measures one tree
once.  Rows: K2.bf16 and K6b.bf16 at B=4096 L=32, K3.bf16 at B=4096 L=32,
K1b.bf16 at in = 768 and 512 without dx and 200 with it, B=4096, K1f.bf16
at in=768 T=50 B=4096, K2.bf16 and K6a.bf16 at B=1 L=512 (the redesigned
bf16 kernels); K2.bf16 and K6b.bf16 at the serving and eval rows (B=1 L=8,
B=16 L=32), K6a.bf16 at B=4096 L=32, K8.bf16 at B=4096 L=32 and B=1 L=512,
K7f.bf16 at G=2 T=50 N=4096, and float32 K1f, K1b, K2, K3, K6a, K6b, K8 and
K7f at the same shapes.  Needs one card and nvcc.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _cuda_ms(fn, iters):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _digest(out):
    import torch

    outs = out if isinstance(out, (tuple, list)) else (out,)
    h = hashlib.sha256()
    for o in outs:
        if o is not None:
            h.update(o.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def rows(dev):
    """{name: (callable, iters)} on inputs drawn from fixed seeds."""
    import numpy as np
    import torch

    from multimodal_transformer_robustness_tpu_torch.ops import (attention_cuda, bert_attn_cuda,
                                                                  bert_ffn_cuda, bigru_cuda,
                                                                  gru_cuda)

    def t(rng, shape, scale=1.0, dtype=torch.float32):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(
            dev, dtype)

    out = {}
    for dtype, tag in ((torch.bfloat16, ".bf16"), (torch.float32, "")):
        rng = np.random.default_rng(7)
        H, T, B, in_dim = 100, 50, 4096, 768
        k = 1.0 / np.sqrt(H)
        wp, wt = t(rng, (3, in_dim, H), k, dtype), t(rng, (3, H, H), k, dtype)
        bc, bhn = t(rng, (3, H), k, dtype), t(rng, (H,), k, dtype)
        x = t(rng, (T, B, in_dim), 1.0, dtype)
        out[f"K1f{tag} in=768 T=50 B=4096"] = (
            lambda x=x, a=(wp, wt, bc, bhn): bigru_cuda.gru_dir(x, *a, False), 5)
        hs, dhs = t(rng, (T, B, H), 0.5, dtype), t(rng, (T, B, H), 1.0, dtype)
        gates = t(rng, (3, T * B, H))
        out[f"K1b{tag} in=768 T=50 B=4096 no dx"] = (
            lambda x=x, a=(wp, wt, bc, bhn), hs=hs, g=gates, d=dhs:
            bigru_cuda.gru_dir_bwd(x, *a, hs, g, d, False, False), 5)
        for i2, need_dx in ((512, False), (200, True)):
            x2, wp2 = t(rng, (T, B, i2), 1.0, dtype), t(rng, (3, i2, H), k, dtype)
            out[f"K1b{tag} in={i2} T=50 B=4096 {'dx' if need_dx else 'no dx'}"] = (
                lambda x=x2, a=(wp2, wt, bc, bhn), hs=hs, g=gates, d=dhs, n=need_dx:
                bigru_cuda.gru_dir_bwd(x, *a, hs, g, d, False, n), 5)
        h, heads = 768, 12
        aw = [t(rng, (h, h), 0.02, dtype) for _ in range(4)]
        ab = [t(rng, (h,), 0.02, dtype) for _ in range(4)]
        aw[:3], ab[:3] = torch.stack(aw[:3]).unbind(0), torch.cat(ab[:3]).split(h)
        g, b = (1.0 + t(rng, (h,), 0.1)).to(dtype), t(rng, (h,), 0.1, dtype)
        # the serving and eval rows of K2 and K6b, from a seed of their own so
        # that the other rows' inputs stay the draws they were
        rng_s = np.random.default_rng(8)
        for Bb, L in ((4096, 32), (1, 8), (16, 32)):
            r = rng_s if Bb < 4096 else np.random.default_rng(9)
            xb, a = t(r, (Bb, L, h), 1.0, dtype), t(r, (Bb, L, h), 1.0, dtype)
            out[f"K6b{tag} B={Bb} L={L}"] = (
                lambda p=(xb, a, aw[3], ab[3], g, b): bert_ffn_cuda.proj_ln_block(
                    *p, eps=1e-12), 5 if Bb > 1 else 20)
            if Bb < 4096:
                mask = np.ones((Bb, L), np.float32)
                mask[0, L // 2:] = 0.0
                mask = torch.from_numpy(mask).to(dev)
                out[f"K2{tag} B={Bb} L={L}"] = (
                    lambda a=(xb, mask, aw[0], ab[0], aw[1], ab[1], aw[2], ab[2], aw[3], ab[3],
                              g, b): bert_attn_cuda.attention_block_fused(
                        *a, n_heads=heads, eps=1e-12), 20)
        for Bb, L in ((4096, 32), (1, 512)):
            xb = t(rng, (Bb, L, h), 1.0, dtype)
            mask = np.zeros((Bb, L), np.float32)
            mask[0, : L // 2] = 1.0
            for i in range(1, Bb):
                mask[i, : rng.integers(1, L + 1)] = 1.0
            mask = torch.from_numpy(mask).to(dev)
            a_args = (xb, mask, aw[0], ab[0], aw[1], ab[1], aw[2], ab[2], aw[3], ab[3], g, b)
            it = 5 if Bb > 1 else 20
            if tag or Bb > 1:
                out[f"K2{tag} B={Bb} L={L}"] = (
                    lambda a=a_args: bert_attn_cuda.attention_block_fused(
                        *a, n_heads=heads, eps=1e-12), it)
            q, kk, v = (t(rng, (Bb, L, heads, h // heads), 1.0, dtype) for _ in range(3))
            if tag or Bb > 1:
                out[f"K6a{tag} B={Bb} L={L}"] = (
                    lambda q=q, k=kk, v=v, m=mask: bert_attn_cuda.dense_attention_blockdiag(
                        q, k, v, m), it)
            km = (mask > 0).to(torch.int32)
            hf = [z.transpose(1, 2).contiguous() for z in (q, kk, v)]
            out[f"K8{tag} B={Bb} L={L}"] = (
                lambda hf=hf, km=km: attention_cuda.flash_attention_masked(*hf, km), it)
            if Bb > 1:
                w1t, w2t = t(rng, (h, 3072), 0.02, dtype), t(rng, (3072, h), 0.02, dtype)
                b1, b2 = t(rng, (3072,), 0.02, dtype), t(rng, (h,), 0.02, dtype)
                out[f"K3{tag} B={Bb} L={L}"] = (
                    lambda a=(xb, w1t, b1, w2t, b2, g, b): bert_ffn_cuda.ffn_ln_block(
                        *a, eps=1e-12), it)
        G, N = 2, 4096
        rec = ([t(rng, (G, T, N, H), 1.0, dtype) for _ in range(3)]
               + [t(rng, (G, H, H), 0.1, dtype) for _ in range(3)]
               + [t(rng, (G, H), 0.1, dtype) for _ in range(3)])
        out[f"K7f{tag} G=2 T=50 N=4096"] = (lambda r=rec: gru_cuda.gru_recurrence_cuda(*r), 5)
    return out


def measure(tree: str) -> dict:
    import torch

    from multimodal_transformer_robustness_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load_library()
    dev = torch.device("cuda", 0)
    res = {}
    for name, (fn, iters) in rows(dev).items():
        res[name] = {"ms": _cuda_ms(fn, iters), "sha256": _digest(fn())}
        torch.cuda.synchronize()
    return res


def _run(tree: str, mode: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(Path(tree).resolve()))
    return subprocess.Popen([sys.executable, __file__, mode, tree], env=env,
                            stdout=subprocess.PIPE, text=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", help="two trees, comma-separated: first,second")
    ap.add_argument("--tree", help="measure one tree once")
    ap.add_argument("--build", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.build:
        from multimodal_transformer_robustness_tpu_torch import _build

        _build.load_library()
        return 0
    if args.tree:
        print(json.dumps({"tree": args.tree, "rows": measure(args.tree)}), flush=True)
        return 0
    first, second = args.trees.split(",")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    builds = [_run(tree, "--build") for tree in (first, second)]
    if any(p.wait() != 0 for p in builds):
        raise SystemExit("a build failed")
    for tree in (first, second, second, first):
        p = _run(tree, "--tree")
        out = p.communicate()[0]
        if p.returncode != 0:
            raise SystemExit(f"{tree}: measure failed")
        print(out.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
