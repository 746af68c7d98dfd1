"""Drive the PyTorch port's serving path once on an NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Needs one CUDA card and the CUDA toolkit (``nvcc``); it exits non-zero
without them, and without the port package beside it.

Phases, each fatal on failure:
  1. device   - the card's name and power limit (nvidia-smi);
  2. build    - compile the hand-written kernels from csrc/ (nvcc, sm_90a);
  3. kernels  - each kernel against its plain PyTorch version on the card at
                the serving path's shapes; max abs / rel error against the
                stated tolerance; median CUDA-event ms of both over 20 warm runs;
  4. serving  - StreamingPredictor at the reference's MOSEI serving
                configuration (d=200, 8x25 heads, layers 3/4/2, 4-layer
                BERT-base-width text encoder, random weights from seed 0)
                answers synthetic requests whose lengths cross bucket
                boundaries; launch counters must show every kernel ran the
                expected number of times; the same parameters on the CPU
                (plain path) must agree;
  5. batched  - one forward at B=8, T=50, L=32, against the CPU.
Then one JSON line with the kernels' results, and the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np
import torch

# Tolerances, card against plain PyTorch on the same inputs, float32, TF32
# off.  K1 and K3 differ only in summation order (atol 1e-4 on outputs of
# order 1).  K2 gets 1e-3: the HF key bias is an additive -10000, where
# float32 steps are 2**-10 apart, so a last-bit difference in a masked logit
# can move it by one such step.
TOL = {"K1": 1e-4, "K2": 1e-3, "K3": 1e-4}
SERVE_TOL = 1e-3   # end-to-end sentiment, card against CPU


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event milliseconds of ``fn`` over ``iters`` warm runs."""
    for _ in range(warmup):
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


def errors(out: torch.Tensor, ref: torch.Tensor):
    if not torch.isfinite(out).all():
        return float("inf"), float("inf")
    diff = (out - ref).abs().max().item()
    return diff, diff / max(ref.abs().max().item(), 1e-30)


def check_kernels(dev, rng):
    from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda, bert_ffn_cuda
    from multimodal_transformer_robustness_tpu_torch.ops import bigru_cuda

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    rows, failures = [], []

    def record(kid, shape, out, ref, kernel_fn, plain_fn):
        abs_err, rel_err = errors(out, ref)
        ms, plain_ms = cuda_ms(kernel_fn), cuda_ms(plain_fn)
        ok = abs_err <= TOL[kid]
        print(f"{kid} {shape}: max_abs {abs_err:.3e} max_rel {rel_err:.3e} "
              f"(tol {TOL[kid]:g}) {'ok' if ok else 'FAIL'}  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms", flush=True)
        rows.append(dict(kid=kid, shape=shape, abs=abs_err, rel=rel_err, ms=ms,
                         plain_ms=plain_ms))
        if not ok:
            failures.append(f"{kid} {shape}")

    # K1: every header input width, H=100, both directions
    H = 100
    for in_dim in (768, 512, 200):
        bound = 1.0 / np.sqrt(H)
        w = {"w_ih": t(rng.uniform(-bound, bound, (3 * H, in_dim))),
             "w_hh": t(rng.uniform(-bound, bound, (3 * H, H))),
             "b_ih": t(rng.uniform(-bound, bound, 3 * H)),
             "b_hh": t(rng.uniform(-bound, bound, 3 * H))}
        ops = bigru_cuda.dir_operands(w)
        args = (ops["wp"], ops["wt"], ops["bc"], ops["bhn"])
        for T in (8, 32, 64):
            for B in (1, 8):
                x = t(rng.standard_normal((T, B, in_dim)))
                for rev in (False, True):
                    out = bigru_cuda.gru_dir(x, *args, rev)
                    torch.cuda.synchronize()
                    ref = bigru_cuda.gru_dir_plain(x, *args, rev)
                    record("K1", f"in={in_dim} H={H} T={T} B={B} "
                           f"{'bwd' if rev else 'fwd'}", out, ref,
                           lambda: bigru_cuda.gru_dir(x, *args, rev),
                           lambda: bigru_cuda.gru_dir_plain(x, *args, rev))

    # K2 and K3 at BERT-base width (weights at HF's init scale)
    h, ffn, heads, eps = 768, 3072, 12, 1e-12
    aw = [t(rng.standard_normal((h, h)) * 0.02) for _ in range(4)]
    ab = [t(rng.standard_normal(h) * 0.02) for _ in range(4)]
    w1t, w2t = t(rng.standard_normal((h, ffn)) * 0.02), t(rng.standard_normal((ffn, h)) * 0.02)
    b1, b2 = t(rng.standard_normal(ffn) * 0.02), t(rng.standard_normal(h) * 0.02)
    g, b = t(1.0 + 0.1 * rng.standard_normal(h)), t(0.1 * rng.standard_normal(h))
    for B in (1, 8):
        for L in (8, 32, 128, 512):
            x = t(rng.standard_normal((B, L, h)))
            # B=1: all keys masked, as the serving path's mask/type-id swap
            # makes them; B=8: ragged masks with item 0 fully masked
            mask = np.zeros((B, L), np.float32)
            for i in range(1, B):
                mask[i, : rng.integers(1, L + 1)] = 1.0
            mask = t(mask)
            a_args = (x, mask, aw[0], ab[0], aw[1], ab[1], aw[2], ab[2], aw[3], ab[3], g, b)
            out = bert_attn_cuda.attention_block_fused(*a_args, n_heads=heads, eps=eps)
            torch.cuda.synchronize()
            ref = bert_attn_cuda.attention_block_plain(*a_args, n_heads=heads, eps=eps)
            record("K2", f"B={B} L={L} h={h}", out, ref,
                   lambda: bert_attn_cuda.attention_block_fused(*a_args, n_heads=heads, eps=eps),
                   lambda: bert_attn_cuda.attention_block_plain(*a_args, n_heads=heads, eps=eps))
            f_args = (x, w1t, b1, w2t, b2, g, b)
            out = bert_ffn_cuda.ffn_ln_block(*f_args, eps=eps)
            torch.cuda.synchronize()
            ref = bert_ffn_cuda.ffn_ln_block_plain(*f_args, eps=eps)
            record("K3", f"B={B} L={L} h={h} ffn={ffn}", out, ref,
                   lambda: bert_ffn_cuda.ffn_ln_block(*f_args, eps=eps),
                   lambda: bert_ffn_cuda.ffn_ln_block_plain(*f_args, eps=eps))
    if failures:
        raise RuntimeError(f"kernels disagree with their plain versions: {failures}")
    return rows


@contextmanager
def plain_kernels():
    """Route the serving path through the kernels' plain versions on the card
    (for the plain-path latency only); the counters do not move."""
    from multimodal_transformer_robustness_tpu_torch.models import bert as bert_mod
    from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda, bert_ffn_cuda
    from multimodal_transformer_robustness_tpu_torch.ops import bigru_cuda

    saved = (bigru_cuda.gru_dir, bert_mod.attention_block_fused, bert_mod.ffn_ln_block)
    bigru_cuda.gru_dir = bigru_cuda.gru_dir_plain
    bert_mod.attention_block_fused = bert_attn_cuda.attention_block_plain
    bert_mod.ffn_ln_block = bert_ffn_cuda.ffn_ln_block_plain
    try:
        yield
    finally:
        bigru_cuda.gru_dir, bert_mod.attention_block_fused, bert_mod.ffn_ln_block = saved


def serve(dev):
    from multimodal_transformer_robustness_tpu_torch.cli.realtime import StreamingPredictor
    from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda, bert_ffn_cuda
    from multimodal_transformer_robustness_tpu_torch.ops import bigru_cuda

    counters = {"K1": bigru_cuda.gru_dir, "K2": bert_attn_cuda.attention_block_fused,
                "K3": bert_ffn_cuda.ffn_ln_block}
    t0 = time.perf_counter()
    pred = StreamingPredictor(seed=0, device=dev)
    print(f"predictor on {dev} built in {time.perf_counter() - t0:.1f} s "
          f"(spec d={pred.spec.dimension} heads={pred.spec.num_heads}x{pred.spec.head_dim} "
          f"layers={pred.spec.layers_single_attn}/{pred.spec.layers_cross_attn}/"
          f"{pred.spec.layers_self_attn}, BERT h={pred.bert_cfg.hidden_size} "
          f"layers={pred.bert_cfg.num_layers})", flush=True)
    rng = np.random.default_rng(1)
    # (words, audio steps, face steps) -> text / audio / vision buckets
    clips = [(4, 40, 24), (30, 70, 9), (100, 20, 50), (300, 64, 33)]
    requests = []
    for words, ta, tv in clips:
        transcript = [f"w{int(i)}" for i in rng.integers(0, 5000, words)]
        requests.append(pred.prepare(transcript,
                                     rng.standard_normal((1, ta, 768)).astype(np.float32),
                                     rng.standard_normal((1, tv, 512)).astype(np.float32)))

    for c in counters.values():
        c.launches = 0
    card, card_ms = [], []
    for text, audio, vision in requests:
        t0 = time.perf_counter()
        card.append(pred.forward(text, audio, vision))
        card_ms.append(1000 * (time.perf_counter() - t0))
    launches = {k: c.launches for k, c in counters.items()}

    for (text, audio, vision), s, ms in zip(requests, card, card_ms):
        print(f"request text L={text.shape[2]} audio T={audio.shape[1]} "
              f"vision T={vision.shape[1]}: sentiment {s:+.6f}  model {ms:.2f} ms",
              flush=True)
    expected = {"K1": 12 * len(requests), "K2": 4 * len(requests), "K3": 4 * len(requests)}
    print(f"launches {launches} expected {expected}", flush=True)
    if launches != expected:
        raise RuntimeError(f"launch counts {launches} != {expected}")
    if not all(np.isfinite(card)):
        raise RuntimeError(f"non-finite sentiment {card}")

    warm_ms = [1000 * _timed(lambda r=r: pred.forward(*r)) for r in requests]
    with plain_kernels():
        plain_ms = [1000 * _timed(lambda r=r: pred.forward(*r)) for r in requests]
    for (text, audio, vision), k_ms, p_ms in zip(requests, warm_ms, plain_ms):
        print(f"warm request L={text.shape[2]} Ta={audio.shape[1]} Tv={vision.shape[1]}: "
              f"kernels {k_ms:.2f} ms, plain PyTorch on the card {p_ms:.2f} ms", flush=True)

    cpu = StreamingPredictor(seed=0, device="cpu")
    cpu_out = [cpu.forward(*r) for r in requests]
    diff = max(abs(a - b) for a, b in zip(card, cpu_out))
    print(f"card vs CPU plain path: max abs diff {diff:.3e} (tol {SERVE_TOL:g})", flush=True)
    if not diff <= SERVE_TOL:
        raise RuntimeError(f"card and CPU disagree: {card} vs {cpu_out}")
    return pred, cpu, launches, warm_ms, plain_ms


def _timed(fn, repeats: int = 5) -> float:
    """Median host seconds of ``fn`` (which ends in a host readback)."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def batched(pred, cpu, dev):
    """__graft_entry__.entry()'s shapes: B=8, T=50, L=32."""
    from multimodal_transformer_robustness_tpu_torch.models import supernet_apply

    B, T, L = 8, 50, 32
    rng = np.random.default_rng(0)
    text = np.stack([rng.integers(0, pred.bert_cfg.vocab_size, (B, L)),
                     np.zeros((B, L), np.int64), np.ones((B, L), np.int64)])
    audio = rng.standard_normal((B, T, 768)).astype(np.float32)
    vision = rng.standard_normal((B, T, 512)).astype(np.float32)
    outs = []
    for p in (pred, cpu):
        inputs = [torch.as_tensor(a, device=p.device) for a in (text, audio, vision)]
        with torch.inference_mode():
            y = supernet_apply(p.spec, p.params, p.masks, inputs, frozen=p.frozen,
                               bert_cfg=p.bert_cfg)
        outs.append(y.cpu())
    card, ref = outs
    diff = (card - ref).abs().max().item()
    print(f"batched B={B} T={T} L={L}: out {tuple(card.shape)} finite "
          f"{bool(torch.isfinite(card).all())}, card vs CPU max abs diff {diff:.3e}",
          flush=True)
    if card.shape != (B, 1) or not torch.isfinite(card).all() or not diff <= SERVE_TOL:
        raise RuntimeError("batched forward failed")


def main() -> int:
    phase("device")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script measures the port on a card")
    from multimodal_transformer_robustness_tpu_torch import _build  # the port must be here

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; TF32 off for "
          "matmul and cuDNN", flush=True)
    dev = torch.device("cuda", 0)

    phase("build")
    _build.load_library()
    print(f"built {_build.BuildInfo.path} in {_build.BuildInfo.seconds:.1f} s", flush=True)
    for line in _build.BuildInfo.log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  " + line.strip())

    phase("kernels")
    rows = check_kernels(dev, np.random.default_rng(0))

    phase("serving")
    pred, cpu, launches, warm_ms, plain_ms = serve(dev)

    phase("batched")
    batched(pred, cpu, dev)

    # one entry per kernel: worst error over every checked shape; times at
    # the serving path's most frequent shape for that kernel
    main_shape = {"K1": "in=768 H=100 T=64 B=1 fwd", "K2": "B=1 L=8 h=768",
                  "K3": "B=1 L=8 h=768 ffn=3072"}
    meta = {
        "K1": ("gru_dir", "multimodal_transformer_robustness_tpu_torch/csrc/bigru.cu",
               "multimodal_transformer_robustness_tpu/ops/bigru_pallas.py:127"),
        "K2": ("attention_block_fused",
               "multimodal_transformer_robustness_tpu_torch/csrc/bert_attn.cu",
               "multimodal_transformer_robustness_tpu/ops/bert_attn_pallas.py:223"),
        "K3": ("ffn_ln_block", "multimodal_transformer_robustness_tpu_torch/csrc/bert_ffn.cu",
               "multimodal_transformer_robustness_tpu/ops/bert_ffn_pallas.py:150"),
    }
    kernels = []
    for kid, (name, source, replaces) in meta.items():
        mine = [r for r in rows if r["kid"] == kid]
        at = next(r for r in mine if r["shape"] == main_shape[kid])
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[kid],
                        "max_abs_err": max(r["abs"] for r in mine),
                        "ms": at["ms"], "plain_ms": at["plain_ms"],
                        "shape": main_shape[kid]})
    print(f"serving warm request ms, kernels {warm_ms}, plain {plain_ms}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
