"""K1b's, K2's, K4's, K6b's and K9's device time by kernel (torch.profiler)
at their path shapes, beside their CUDA-event time, digests of their outputs
and of K1f's, K3's, K5dq's, K5b's, K6a's, K8's, K7f's and K7b's, and warm
serving ms (float, int8 and flash requests), for the port package of any
tree.

Run from the repository root on a card:

    PYTHONPATH=. python3 tools/tree_probe.py [--tree DIR]

``--tree`` (default: this checkout) names the directory whose
``multimodal_transformer_robustness_tpu_torch`` is measured, so that a
parent commit unpacked with ``git archive`` under ``build/`` is measured by
the same cases (``chip_smoke.k1b_split_cases``, ``bert_split_cases``,
``profile_ms``, ``cuda_ms``) in the same call, and two trees' outputs can
be held bit for bit (sha256 of ``gru_dir``'s output, of
``ffn_ln_block``'s, of ``ffn_ln_block_q``'s output, hidden codes and
scales, at the training and serving shapes, of K5dq's and K5b's gradients
at the MOSEI cross and self shapes from the plain forward's out and lse,
of K6a's and K8's outputs at B=4096 L=32 and K7f's and K7b's at G=2 T=50
N=4096, and of every split case's outputs: K1b's gradients, K2's, K4's,
K6b's and K9's outputs; inputs from fixed seeds;
``chip_smoke.k9_split_cases``), and both trees serve the
same synthetic requests (``chip_smoke.synthetic_requests``, ``_timed``: the
median host ms of 5 warm calls).  Prints one JSON line per shape.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(ROOT))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script measures the port on a card")
    sys.path.insert(0, str(Path(args.tree).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from multimodal_transformer_robustness_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    dev = torch.device("cuda", 0)
    from multimodal_transformer_robustness_tpu_torch.ops import bigru_cuda

    rng = np.random.default_rng(2)
    for in_dim, T, B in ((768, 50, 4096), (768, 64, 1), (512, 64, 1), (200, 50, 4096)):
        ops = bigru_cuda.dir_operands(cs.gru_weights(rng, in_dim, 100, dev))
        x = torch.from_numpy(rng.standard_normal((T, B, in_dim)).astype(np.float32)).to(dev)
        for rev in (False, True):
            out = bigru_cuda.gru_dir(x, ops["wp"], ops["wt"], ops["bc"], ops["bhn"], rev)
            digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
            print(json.dumps({"tree": args.tree, "shape": f"K1f in={in_dim} T={T} B={B} "
                              f"{'bwd' if rev else 'fwd'}", "sha256": digest}), flush=True)
    from multimodal_transformer_robustness_tpu_torch.models.bert import _quantize
    from multimodal_transformer_robustness_tpu_torch.ops import bert_ffn_cuda

    rng = np.random.default_rng(3)
    h, ffn = 768, 3072

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    r3 = np.random.default_rng(6)   # K3's own draws: K4's stay what they were
    w1t, w2t = t(r3.standard_normal((h, ffn)) * 0.02), t(r3.standard_normal((ffn, h)) * 0.02)
    fb1, fb2 = t(r3.standard_normal(ffn) * 0.02), t(r3.standard_normal(h) * 0.02)
    fg, fb = t(1.0 + 0.1 * r3.standard_normal(h)), t(0.1 * r3.standard_normal(h))
    for B, L in ((1, 8), (4096, 32)):
        x = t(r3.standard_normal((B, L, h)))
        out = bert_ffn_cuda.ffn_ln_block(x, w1t, fb1, w2t, fb2, fg, fb, eps=1e-12)
        digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
        print(json.dumps({"tree": args.tree, "shape": f"K3 B={B} L={L} h={h} ffn={ffn}",
                          "sha256": digest}), flush=True)
        del out, x
    w1q, w2q = (_quantize(t(rng.standard_normal(s) * 0.02)) for s in ((ffn, h), (h, ffn)))
    b1, b2 = t(rng.standard_normal(ffn) * 0.02), t(rng.standard_normal(h) * 0.02)
    g, b = t(1.0 + 0.1 * rng.standard_normal(h)), t(0.1 * rng.standard_normal(h))
    for B, L in ((1, 8), (1, 512), (4096, 32)):
        x = t(rng.standard_normal((B, L, h)))
        got = bert_ffn_cuda.ffn_ln_block_q(x, w1q, b1, w2q, b2, g, b, eps=1e-12,
                                           return_codes=True)
        digests = [hashlib.sha256(a.cpu().numpy().tobytes()).hexdigest()[:16] for a in got]
        print(json.dumps({"tree": args.tree, "shape": f"K4 B={B} L={L} h={h} ffn={ffn}",
                          "sha256_out_codes_scales": digests}), flush=True)
        del got, x
    # the kernels that share csrc/flash_attn.cu with K5f and K5dkv (K5dq, K5b),
    # from the plain forward's out and lse, and K6a, K8, K7f, K7b: digests
    from multimodal_transformer_robustness_tpu_torch.ops import attention_cuda as ac
    from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda, gru_cuda

    rng = np.random.default_rng(8)
    digest_cases = []
    for name, tq, tk in (("cross", 50, 32), ("self", 50, 50)):
        B, heads, d, offset = 4096, 8, 25, 1 + abs(tk - tq)
        q = t(rng.standard_normal((B, heads, tq, d)) / np.sqrt(d))
        k, v, dout = (t(rng.standard_normal((B, heads, n, d))) for n in (tk, tk, tq))
        seeds = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, B * heads)
                                 .astype(np.int32)).to(dev)
        rates = torch.full((B * heads,), 0.1, device=dev)
        out, lse = ac.flash_attention_plain(q, k, v, True, offset, seeds, rates)
        delta = (dout * out).sum(-1).reshape(B * heads, tq)
        bwd = (q, k, v, dout, lse, delta, seeds, rates, True, offset)
        fused = (q, k, v, dout, out, lse, seeds, rates, True, offset)
        digest_cases += [(f"K5dq {name} B={B} rate=0.1", lambda a=bwd: ac.flash_bwd_dq(*a)),
                         (f"K5b {name} B={B} rate=0.1", lambda a=fused: ac.flash_bwd(*a))]
    qkv = [t(rng.standard_normal((4096, 32, 12, 64))) for _ in range(3)]
    mask = t((np.arange(32)[None, :] < rng.integers(1, 33, (4096, 1))).astype(np.float32))
    hf = [a.transpose(1, 2).contiguous() for a in qkv]
    km = cs.ragged_key_mask(rng, 4096, 32, dev)
    rec = ([t(rng.standard_normal((2, 50, 4096, 100))) for _ in range(3)]
           + [t(rng.uniform(-0.1, 0.1, (2, 100, 100))) for _ in range(3)]
           + [t(rng.uniform(-0.1, 0.1, (2, 100))) for _ in range(3)])
    dh = t(rng.standard_normal((2, 50, 4096, 100)))
    digest_cases += [
        ("K6a B=4096 L=32", lambda: bert_attn_cuda.dense_attention_blockdiag(*qkv, mask)),
        ("K8 B=4096 L=32", lambda: ac.flash_attention_masked(*hf, km)),
        ("K7f G=2 T=50 N=4096", lambda: gru_cuda.gru_recurrence_cuda(*rec)),
        ("K7b G=2 T=50 N=4096", lambda: gru_cuda.gru_recurrence_bwd_cuda(
            *rec[:3], gru_cuda.gru_recurrence_cuda(*rec), dh, *rec[3:]))]
    for name, fn in digest_cases:
        got = fn()
        digests = [hashlib.sha256(a.cpu().numpy().tobytes()).hexdigest()[:16]
                   for a in (got if isinstance(got, tuple) else (got,)) if a is not None]
        print(json.dumps({"tree": args.tree, "shape": name, "sha256": digests}), flush=True)
        del got
    del qkv, hf, rec, dh, digest_cases
    torch.cuda.empty_cache()
    cases = (cs.k1b_split_cases(dev, np.random.default_rng(1))
             + cs.bert_split_cases(dev, np.random.default_rng(4))
             + cs.k9_split_cases(dev, np.random.default_rng(5)))
    from multimodal_transformer_robustness_tpu_torch.cli.realtime import StreamingPredictor

    for label, options in (("float", {}), ("int8", {"bert_int8": True}),
                           ("flash", {"attn_impl": "flash"})):
        pred = StreamingPredictor(seed=0, device=dev, **options)
        requests = cs.synthetic_requests(pred)
        warm = [1000 * cs._timed(lambda r=r: pred.forward(*r)) for r in requests]
        print(json.dumps({"tree": args.tree, "shape": f"serving {label}",
                          "warm_request_ms": warm}), flush=True)
        del pred
    for name, fn, iters in cases:
        out = fn()
        digests = [hashlib.sha256(a.cpu().numpy().tobytes()).hexdigest()[:16]
                   for a in (out if isinstance(out, tuple) else (out,)) if a is not None]
        per = cs.profile_ms(fn, iters)
        print(json.dumps({"tree": args.tree, "package": _build.__file__, "shape": name,
                          "event_ms": cs.cuda_ms(fn, iters), "device_ms": sum(per.values()),
                          "kernels_ms": per, "sha256": digests}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
