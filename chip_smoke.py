"""Drive the PyTorch port's serving and training paths once on an NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Needs one CUDA card and the CUDA toolkit (``nvcc``); it exits non-zero
without them, and without the port package beside it.

Phases, each fatal on failure:
  1. device   - the card's name and power limit (nvidia-smi);
  2. build    - compile the hand-written kernels from csrc/ (nvcc, sm_90a,
                one process per source, all started together);
  3. kernels  - each kernel against its plain PyTorch version on the card at
                the serving and training paths' shapes; max abs error against
                the stated tolerance; median CUDA-event ms of the kernel, of
                the plain version and, where one PyTorch call computes the
                same function (cuDNN's GRU for K1 / K1b), of that call; K1b
                is also run twice to show bit-identical gradients;
  4. serving  - StreamingPredictor at the reference's MOSEI serving
                configuration (d=200, 8x25 heads, layers 3/4/2, 4-layer
                BERT-base-width text encoder, random weights from seed 0)
                answers synthetic requests whose lengths cross bucket
                boundaries; launch counters must show every kernel ran the
                expected number of times; the same parameters on the CPU
                (plain path) must agree;
  5. batched  - one forward at B=8, T=50, L=32, against the CPU;
  6. train    - Trainer.train_epoch at the same MOSEI configuration on
                synthetic batches at B=4096, T=50, L=32 (Adam, lr 1e-4, L1
                loss, random_sample over the 7 modality subsets): 2 warm-up
                steps, then 5 timed steps with launch counters per step, the
                step time broken down by CUDA events;
  7. train-vs-cpu - one step's loss and every gradient at B=8, card against
                CPU, dropout off.
Then one JSON line with the kernels' results, and the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from unittest import mock

import numpy as np
import torch

# Tolerances, card against plain PyTorch on the same inputs, float32, TF32
# off.  K1 and K3 differ only in summation order (atol 1e-4 on outputs of
# order 1).  K2 gets 1e-3: the HF key bias is an additive -10000, where
# float32 steps are 2**-10 apart, so a last-bit difference in a masked logit
# can move it by one such step.  K1b's error is normalised by max |ref| of
# each gradient: its weight gradients are sums over up to T*B = 204,800 rows,
# added in another order than the plain version's (split-K partials against
# cuBLAS), and dx and the dh carry chain 50 steps back.
TOL = {"K1": 1e-4, "K1b": 1e-4, "K2": 1e-3, "K3": 1e-4}
SERVE_TOL = 1e-3   # end-to-end sentiment, card against CPU
# one training step, card against CPU: the loss relative, each gradient
# normalised by its max |ref| (plus 1e-6 absolute for all-but-zero ones);
# both float32, summed in other orders through a 4-layer BERT, two GRU
# levels over 50 steps and eleven encoder stacks
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-4, 1e-3

# H100 SXM peaks (NVIDIA data sheet): float32 on the CUDA cores, not the
# tensor cores, since every kernel here is a float32 FMA kernel; HBM3 rate
PEAK_F32_FLOPS, PEAK_BYTES = 67e12, 3.35e12
# the 7 non-empty modality subsets (bench.py's training pool)
POOL = [[0], [1], [2], [0, 1], [0, 2], [1, 2], [0, 1, 2]]
PKG = "multimodal_transformer_robustness_tpu_torch"


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


def bound(flops: float, nbytes: float):
    """The least time the card could take: (ms, what bounds it)."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# work each kernel's function must do: matrix-product FLOPs; bytes with each
# input read once and each output written once
def k1f_work(T, B, i, H):
    return 2 * T * B * 3 * H * (i + H), 4 * (T * B * i + 3 * H * (i + H) + 4 * H + T * B * H)


def k1b_work(T, B, i, H, need_dx):
    flops = 2 * T * B * 3 * H * (i + 2 * H) + (2 * T * B * 3 * H * i if need_dx else 0)
    ins = T * B * i + 5 * T * B * H + 3 * H * H + H + (3 * H * i if need_dx else 0)
    outs = 3 * H * (i + H) + 4 * H + (T * B * i if need_dx else 0)
    return flops, 4 * (ins + outs)


def k2_work(B, L, h):
    return 8 * B * L * h * h + 4 * B * L * L * h, 4 * (2 * B * L * h + B * L + 4 * h * h + 6 * h)


def k3_work(B, L, h, f):
    return 4 * B * L * h * f, 4 * (2 * B * L * h + 2 * h * f + f + 3 * h)


def gru_weights(rng, in_dim, H, dev):
    k = 1.0 / np.sqrt(H)
    shapes = {"w_ih": (3 * H, in_dim), "w_hh": (3 * H, H), "b_ih": (3 * H,), "b_hh": (3 * H,)}
    return {n: torch.from_numpy(rng.uniform(-k, k, s).astype(np.float32)).to(dev)
            for n, s in shapes.items()}


def cudnn_gru(w, in_dim, H, dev):
    """One-direction ``nn.GRU`` (cuDNN) holding the same weights."""
    gru = torch.nn.GRU(in_dim, H).to(dev)
    with torch.no_grad():
        for n, p in (("weight_ih_l0", "w_ih"), ("weight_hh_l0", "w_hh"),
                     ("bias_ih_l0", "b_ih"), ("bias_hh_l0", "b_hh")):
            getattr(gru, n).copy_(w[p])
    gru.flatten_parameters()
    return gru


def check_kernels(dev, rng):
    from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda, bert_ffn_cuda
    from multimodal_transformer_robustness_tpu_torch.ops import bigru_cuda

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    rows, failures = [], []

    def record(kid, shape, out, ref, kernel_fn, plain_fn, work=None, library_fn=None,
               iters=20):
        abs_err, rel_err = errors(out, ref)
        ok = abs_err <= TOL[kid]
        row = dict(kid=kid, shape=shape, abs=abs_err, rel=rel_err)
        msg = (f"{kid} {shape}: max_abs {abs_err:.3e} max_rel {rel_err:.3e} "
               f"(tol {TOL[kid]:g}) {'ok' if ok else 'FAIL'}")
        if work is not None:
            row.update(ms=cuda_ms(kernel_fn, iters), plain_ms=cuda_ms(plain_fn, iters),
                       library_ms=cuda_ms(library_fn, iters) if library_fn else None)
            row["bound_ms"], row["bound_by"] = bound(*work)
            lib = f"{row['library_ms']:.4f}" if library_fn else "none"
            msg += (f"  kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  "
                    f"library {lib} ms  bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        print(msg, flush=True)
        rows.append(row)
        if not ok:
            failures.append(f"{kid} {shape}")

    # K1: every header input width, H=100, both directions; timed at the
    # serving shapes and at the training shape (T=50, B=4096)
    H = 100
    for in_dim in (768, 512, 200):
        w = gru_weights(rng, in_dim, H, dev)
        ops = bigru_cuda.dir_operands(w)
        args = (ops["wp"], ops["wt"], ops["bc"], ops["bhn"])
        gru = cudnn_gru(w, in_dim, H, dev)
        for T, B in ((8, 1), (8, 8), (32, 1), (32, 8), (64, 1), (64, 8), (50, 4096)):
            x = t(rng.standard_normal((T, B, in_dim)))
            for rev in (False, True):
                out = bigru_cuda.gru_dir(x, *args, rev)
                torch.cuda.synchronize()
                ref = bigru_cuda.gru_dir_plain(x, *args, rev)
                timed = not rev and (B == 1 or B == 4096)

                def library(x=x):
                    with torch.no_grad():
                        return gru(x)

                record("K1", f"in={in_dim} H={H} T={T} B={B} {'bwd' if rev else 'fwd'}",
                       out, ref, lambda: bigru_cuda.gru_dir(x, *args, rev),
                       lambda: bigru_cuda.gru_dir_plain(x, *args, rev),
                       work=k1f_work(T, B, in_dim, H) if timed else None,
                       library_fn=library, iters=5 if B == 4096 else 20)
    rows += check_k1b(dev, rng, t, failures)

    # K2 and K3 at BERT-base width (weights at HF's init scale), at the
    # serving shapes and the training shape (B=4096, L=32)
    h, ffn, heads, eps = 768, 3072, 12, 1e-12
    aw = [t(rng.standard_normal((h, h)) * 0.02) for _ in range(4)]
    ab = [t(rng.standard_normal(h) * 0.02) for _ in range(4)]
    w1t, w2t = t(rng.standard_normal((h, ffn)) * 0.02), t(rng.standard_normal((ffn, h)) * 0.02)
    b1, b2 = t(rng.standard_normal(ffn) * 0.02), t(rng.standard_normal(h) * 0.02)
    g, b = t(1.0 + 0.1 * rng.standard_normal(h)), t(0.1 * rng.standard_normal(h))
    for B, L in [(1, 8), (1, 32), (1, 128), (1, 512), (8, 8), (8, 32), (8, 128), (8, 512),
                 (4096, 32)]:
        x = t(rng.standard_normal((B, L, h)))
        # B=1: all keys masked, as the serving path's mask/type-id swap
        # makes them; B>1: ragged masks with item 0 fully masked
        mask = np.zeros((B, L), np.float32)
        for i in range(1, B):
            mask[i, : rng.integers(1, L + 1)] = 1.0
        mask = t(mask)
        timed = (B, L) in ((1, 8), (4096, 32))
        iters = 5 if B == 4096 else 20
        a_args = (x, mask, aw[0], ab[0], aw[1], ab[1], aw[2], ab[2], aw[3], ab[3], g, b)
        out = bert_attn_cuda.attention_block_fused(*a_args, n_heads=heads, eps=eps)
        torch.cuda.synchronize()
        ref = bert_attn_cuda.attention_block_plain(*a_args, n_heads=heads, eps=eps)
        record("K2", f"B={B} L={L} h={h}", out, ref,
               lambda: bert_attn_cuda.attention_block_fused(*a_args, n_heads=heads, eps=eps),
               lambda: bert_attn_cuda.attention_block_plain(*a_args, n_heads=heads, eps=eps),
               work=k2_work(B, L, h) if timed else None, iters=iters)
        del out, ref
        f_args = (x, w1t, b1, w2t, b2, g, b)
        out = bert_ffn_cuda.ffn_ln_block(*f_args, eps=eps)
        torch.cuda.synchronize()
        ref = bert_ffn_cuda.ffn_ln_block_plain(*f_args, eps=eps)
        record("K3", f"B={B} L={L} h={h} ffn={ffn}", out, ref,
               lambda: bert_ffn_cuda.ffn_ln_block(*f_args, eps=eps),
               lambda: bert_ffn_cuda.ffn_ln_block_plain(*f_args, eps=eps),
               work=k3_work(B, L, h, ffn) if timed else None, iters=iters)
        del out, ref, x
    if failures:
        raise RuntimeError(f"kernels disagree with their plain versions: {failures}")
    return rows


def check_k1b(dev, rng, t, failures):
    """K1b against ``torch.autograd.grad`` through the plain time loop, at
    every header width, T in {8, 50}, B in {1, 64, 4096}, both directions,
    ``need_dx`` both ways; timed (kernel, plain, cuDNN's GRU backward) at
    the training shapes the main path gives it; one bit-identical rerun."""
    from multimodal_transformer_robustness_tpu_torch.ops import bigru_cuda

    rows, H = [], 100
    names = ("dx", "dwp", "dwt", "dbc", "dbhn")
    # (in, need_dx) as the training path runs them: level 1 of the text and
    # audio (768) and vision (512) headers without dx, level 2 (200) with it
    path_cases = {(768, False), (512, False), (200, True)}
    for in_dim in (768, 512, 200):
        w = gru_weights(rng, in_dim, H, dev)
        ops = bigru_cuda.dir_operands(w)
        args = (ops["wp"], ops["wt"], ops["bc"], ops["bhn"])
        gru = cudnn_gru(w, in_dim, H, dev)
        for T in (8, 50):
            for B in (1, 64, 4096):
                x = t(rng.standard_normal((T, B, in_dim)))
                dhs = t(rng.standard_normal((T, B, H)))
                for rev in (False, True):
                    hs, gates = bigru_cuda._launch_fwd(x, *args, rev)
                    for need_dx in (True, False):
                        got = bigru_cuda.gru_dir_bwd(x, *args, hs, gates, dhs, rev, need_dx)
                        torch.cuda.synchronize()
                        ref = bigru_cuda.gru_dir_bwd_plain(x, *args, hs, gates, dhs, rev,
                                                           need_dx)
                        if (got[0] is None) != (not need_dx):
                            failures.append(f"K1b dx presence need_dx={need_dx}")
                        errs = {n: errors(a, r) for n, a, r in zip(names, got, ref)
                                if r is not None}
                        worst = max(e[1] for e in errs.values())
                        ok = worst <= TOL["K1b"]
                        shape = (f"in={in_dim} H={H} T={T} B={B} "
                                 f"{'bwd' if rev else 'fwd'} need_dx={need_dx}")
                        row = dict(kid="K1b", shape=shape, rel=worst,
                                   abs=max(e[0] for e in errs.values()))
                        msg = (f"K1b {shape}: max_abs/max|ref| "
                               + " ".join(f"{n} {e[1]:.2e}" for n, e in errs.items())
                               + f" (tol {TOL['K1b']:g}) {'ok' if ok else 'FAIL'}")
                        if T == 50 and B == 4096 and not rev and (in_dim, need_dx) in path_cases:
                            xg = x.clone().requires_grad_(need_dx)
                            y, _ = gru(xg)
                            wrt = ([xg] if need_dx else []) + list(gru.parameters())
                            row.update(
                                ms=cuda_ms(lambda: bigru_cuda.gru_dir_bwd(
                                    x, *args, hs, gates, dhs, rev, need_dx), 5),
                                plain_ms=cuda_ms(lambda: bigru_cuda.gru_dir_bwd_plain(
                                    x, *args, hs, gates, dhs, rev, need_dx), 5),
                                library_ms=cuda_ms(lambda: torch.autograd.grad(
                                    y, wrt, dhs, retain_graph=True), 5))
                            row["bound_ms"], row["bound_by"] = bound(
                                *k1b_work(T, B, in_dim, H, need_dx))
                            msg += (f"  kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f}"
                                    f" ms  cuDNN {row['library_ms']:.4f} ms  bound "
                                    f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
                            del y, xg
                            if in_dim == 768:
                                again = bigru_cuda.gru_dir_bwd(x, *args, hs, gates, dhs, rev,
                                                               need_dx)
                                same = all(torch.equal(a, b) for a, b in zip(got, again)
                                           if a is not None)
                                msg += f"  rerun bit-identical {same}"
                                if not same:
                                    failures.append(f"K1b {shape} not deterministic")
                        print(msg, flush=True)
                        rows.append(row)
                        if not ok:
                            failures.append(f"K1b {shape}")
                    del hs, gates
    return rows


def counters():
    from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda, bert_ffn_cuda
    from multimodal_transformer_robustness_tpu_torch.ops import bigru_cuda

    return {"K1": bigru_cuda.gru_dir, "K1b": bigru_cuda.gru_dir_bwd,
            "K2": bert_attn_cuda.attention_block_fused, "K3": bert_ffn_cuda.ffn_ln_block}


def reset_counters():
    for c in counters().values():
        c.launches = 0
    counters()["K1b"].launches_no_dx = 0


def read_counters():
    return {k: c.launches for k, c in counters().items()}


@contextmanager
def plain_kernels():
    """Route the serving path through the kernels' plain versions on the card
    (for the plain-path latency only); the counters do not move."""
    from multimodal_transformer_robustness_tpu_torch.models import bert as bert_mod
    from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda, bert_ffn_cuda
    from multimodal_transformer_robustness_tpu_torch.ops import bigru_cuda

    saved = (bigru_cuda._launch_fwd, bert_mod.attention_block_fused, bert_mod.ffn_ln_block)
    bigru_cuda._launch_fwd = lambda x, wp, wt, bc, bhn, rev: (
        bigru_cuda.gru_dir_plain(x, wp, wt, bc, bhn, rev), None)
    bert_mod.attention_block_fused = bert_attn_cuda.attention_block_plain
    bert_mod.ffn_ln_block = bert_ffn_cuda.ffn_ln_block_plain
    try:
        yield
    finally:
        bigru_cuda._launch_fwd, bert_mod.attention_block_fused, bert_mod.ffn_ln_block = saved


def serve(dev):
    from multimodal_transformer_robustness_tpu_torch.cli.realtime import StreamingPredictor

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

    reset_counters()
    card, card_ms = [], []
    for text, audio, vision in requests:
        t0 = time.perf_counter()
        card.append(pred.forward(text, audio, vision))
        card_ms.append(1000 * (time.perf_counter() - t0))
    launches = read_counters()

    for (text, audio, vision), s, ms in zip(requests, card, card_ms):
        print(f"request text L={text.shape[2]} audio T={audio.shape[1]} "
              f"vision T={vision.shape[1]}: sentiment {s:+.6f}  model {ms:.2f} ms",
              flush=True)
    n = len(requests)
    expected = {"K1": 12 * n, "K1b": 0, "K2": 4 * n, "K3": 4 * n}
    print(f"serving launches {launches} expected {expected}", flush=True)
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


def synthetic_batch(rng, B, T, L, vocab, dims=(768, 512)):
    """bench.py's synthetic batch: random token ids with all-zero type ids
    and an all-ones mask, standard-normal audio / vision, normal labels."""
    from multimodal_transformer_robustness_tpu_torch.data.loaders import Batch

    text = np.stack([rng.integers(0, vocab, (B, L)), np.zeros((B, L), np.int64),
                     np.ones((B, L), np.int64)])
    audio = rng.standard_normal((B, T, dims[0]), dtype=np.float32)
    vision = rng.standard_normal((B, T, dims[1]), dtype=np.float32)
    labels = rng.standard_normal((B, 1), dtype=np.float32)
    return Batch(inputs=[text, audio, vision], labels=labels,
                 valid=np.ones((B,), np.float32))


def mosei():
    """``__graft_entry__._mosei_spec()`` and its 4-layer BERT-base-width
    text encoder, in the port's types."""
    from multimodal_transformer_robustness_tpu_torch import ModelSpec
    from multimodal_transformer_robustness_tpu_torch.models.bert import BertConfig

    spec = ModelSpec(
        modality_set=("t", "a", "v"), orig_dimensions=(768, 768, 512),
        dimension=200, num_heads=8, head_dim=25, layers_single_attn=3,
        layers_cross_attn=4, layers_self_attn=2,
        attn_dropout=(0.1, 0.1, 0.0, 0.0), relu_dropout=0.1, res_dropout=0.3,
        out_dropout=0.1, embed_dropout=0.3, attn_mask=True, output_dim=1)
    return spec, BertConfig(num_layers=4)


def train(dev, spec, bert_cfg, B=4096, T=50, L=32, warmup=2, steps=5):
    """Trainer.train_epoch at the training shapes; returns the per-step
    launch counts and the step numbers."""
    from multimodal_transformer_robustness_tpu_torch import build_masks, full_active_config
    from multimodal_transformer_robustness_tpu_torch.models import init_supernet
    from multimodal_transformer_robustness_tpu_torch.train import TrainHParams, Trainer

    params, frozen = init_supernet(torch.Generator().manual_seed(0), spec, bert_cfg)
    hp = TrainHParams(batch_size=B, lr=1e-4, optim="Adam", criterion="L1Loss",
                      experiment_type="random_sample", modality_pool=POOL)
    trainer = Trainer(spec, params, frozen, hp, bert_cfg=bert_cfg, device=dev)
    del params, frozen
    batch = synthetic_batch(np.random.default_rng(0), B, T, L, bert_cfg.vocab_size,
                            spec.orig_dimensions[1:])
    masks = build_masks(spec, full_active_config(spec), device=trainer.device)

    t0 = time.perf_counter()
    _, masks = trainer.train_epoch([batch] * warmup, masks, epoch=0)
    print(f"train warm-up: {warmup} steps in {time.perf_counter() - t0:.2f} s, losses "
          f"{trainer.last_epoch_losses.tolist()}", flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    loss, masks = trainer.train_epoch([batch] * steps, masks, epoch=1)   # ends in a readback
    elapsed = time.perf_counter() - t0
    launches = read_counters()
    no_dx = counters()["K1b"].launches_no_dx
    peak = torch.cuda.max_memory_allocated()
    losses = trainer.last_epoch_losses
    step_ms = 1e3 * elapsed / steps
    print(f"train B={B} T={T} L={L}: {steps} steps in {elapsed:.3f} s: step {step_ms:.1f} ms, "
          f"{steps * B / elapsed:.1f} samples/s (host clock around train_epoch); "
          f"losses {losses.tolist()}, epoch loss {loss:.6f}; peak allocated "
          f"{peak / 2**30:.2f} GiB", flush=True)
    per_step = {k: v / steps for k, v in launches.items()}
    expected = {"K1": 12, "K1b": 12, "K2": 4, "K3": 4}
    print(f"train launches per step {per_step} (K1b without dx {no_dx / steps}) "
          f"expected {expected} (K1b without dx 6)", flush=True)
    if per_step != expected or no_dx != 6 * steps:
        raise RuntimeError(f"train launch counts {launches} (no dx {no_dx}) over {steps} steps")
    if not np.isfinite(losses).all() or len(losses) != steps:
        raise RuntimeError(f"non-finite training losses {losses}")
    breakdown = train_breakdown(trainer, batch, masks)
    return launches, dict(step_ms=step_ms, samples_per_s=steps * B / elapsed,
                          peak_gib=peak / 2**30, losses=losses.tolist(), **breakdown)


def train_breakdown(trainer, batch, masks, repeats=3):
    """Where one step's time goes, by CUDA events over separate runs of its
    parts: the frozen BERT (K2 + K3), the headers forward and backward (K1 +
    K1b, BERT excluded), the optimizer (clip + Adam) and the rest (the
    trunk forward and backward, the loss)."""
    from multimodal_transformer_robustness_tpu_torch.models import supernet_headers
    from multimodal_transformer_robustness_tpu_torch.models.headers import bert_text_features
    from multimodal_transformer_robustness_tpu_torch.train.loop import tree_leaves

    dev = trainer.device
    inputs = [torch.as_tensor(x, device=dev) for x in batch.inputs]
    labels = torch.as_tensor(batch.labels, device=dev)
    valid = torch.as_tensor(batch.valid, device=dev)
    spec, params = trainer.spec, trainer.params

    def bert():
        bert_text_features(trainer.frozen, trainer.bert_cfg, inputs[0])

    def headers():
        base = supernet_headers(spec, params, inputs, frozen=trainer.frozen,
                                bert_cfg=trainer.bert_cfg)
        base.sum().backward()

    def step():
        trainer.train_step(params, trainer.opt_state, masks, inputs, labels, valid,
                           trainer.generator)

    def optimizer():
        torch.nn.utils.clip_grad_norm_(tree_leaves(params), trainer.hp.clip)
        trainer.opt_state.step()

    ms = {name: cuda_ms(fn, repeats, 1) for name, fn in
          (("step", step), ("bert", bert), ("headers_incl_bert", headers),
           ("optimizer", optimizer))}
    out = {"step_cuda_ms": ms["step"], "bert_ms": ms["bert"],
           "headers_fwd_bwd_ms": ms["headers_incl_bert"] - ms["bert"],
           "optimizer_ms": ms["optimizer"]}
    out["trunk_and_loss_ms"] = (ms["step"] - ms["headers_incl_bert"] - ms["optimizer"])
    print("train step breakdown (CUDA events, ms): " + json.dumps(out), flush=True)
    return out


def train_card_vs_cpu(dev, spec, bert_cfg, B=8, T=50, L=32):
    """One step's loss and gradients on the card and on the CPU from the
    same parameters, masks and batch, every dropout rate 0.  The reference's
    0.1 for the later cross stacks is patched to 0 for this check only: the
    card's and the CPU's generators draw different streams."""
    from multimodal_transformer_robustness_tpu_torch import ModelSpec, build_masks
    from multimodal_transformer_robustness_tpu_torch.models import init_supernet
    from multimodal_transformer_robustness_tpu_torch.train import (
        TrainHParams, Trainer, sample_train_config)
    from multimodal_transformer_robustness_tpu_torch.weights import export_reference_state_dict

    spec = dataclasses.replace(spec, attn_dropout=(0.0,) * 4, relu_dropout=0.0,
                               res_dropout=0.0, out_dropout=0.0, embed_dropout=0.0)
    cfg = sample_train_config(spec, "random_sample", POOL, np.random.default_rng(3))
    batch = synthetic_batch(np.random.default_rng(4), B, T, L, bert_cfg.vocab_size,
                            spec.orig_dimensions[1:])
    batch.valid[-1] = 0.0                     # a padded tail row
    hp = TrainHParams(batch_size=B, lr=1e-4, optim="Adam", criterion="L1Loss")
    out = {}
    with mock.patch.object(ModelSpec, "attn_dropout_for_cross", lambda self, idx: 0.0):
        for key, d in (("card", dev), ("cpu", "cpu")):
            params, frozen = init_supernet(torch.Generator().manual_seed(0), spec, bert_cfg)
            tr = Trainer(spec, params, frozen, hp, bert_cfg=bert_cfg, device=d)
            inputs = [torch.as_tensor(x, device=tr.device) for x in batch.inputs]
            loss, grads = tr.loss_and_grads(
                tr.params, build_masks(spec, cfg, device=tr.device), inputs,
                torch.as_tensor(batch.labels, device=tr.device),
                torch.as_tensor(batch.valid, device=tr.device), tr.generator)
            out[key] = (float(loss), export_reference_state_dict(spec, grads))
    (l_card, g_card), (l_cpu, g_cpu) = out["card"], out["cpu"]
    loss_err = abs(l_card - l_cpu) / max(abs(l_cpu), 1e-30)
    worst, worst_name = 0.0, None
    for name, ref in g_cpu.items():
        err = float(np.abs(g_card[name] - ref).max()) / (float(np.abs(ref).max()) + 1e-6 / TRAIN_GRAD_TOL)
        if err > worst:
            worst, worst_name = err, name
    print(f"train step B={B} card vs CPU: loss {l_card:.7f} vs {l_cpu:.7f} (rel {loss_err:.2e}, "
          f"tol {TRAIN_LOSS_TOL:g}); {len(g_cpu)} gradients, worst normalised error "
          f"{worst:.2e} at {worst_name} (tol {TRAIN_GRAD_TOL:g})", flush=True)
    if not (loss_err <= TRAIN_LOSS_TOL and worst <= TRAIN_GRAD_TOL):
        raise RuntimeError("training step: card and CPU disagree")
    return loss_err, worst


def kernel_entries(rows, launches):
    """One entry per kernel: worst error over every checked shape, times at
    the main path's most frequent shape, and the same at the training shape."""
    main_shape = {"K1": "in=768 H=100 T=64 B=1 fwd", "K2": "B=1 L=8 h=768",
                  "K3": "B=1 L=8 h=768 ffn=3072",
                  "K1b": "in=768 H=100 T=50 B=4096 fwd need_dx=False"}
    train_shape = {"K1": "in=768 H=100 T=50 B=4096 fwd", "K2": "B=4096 L=32 h=768",
                   "K3": "B=4096 L=32 h=768 ffn=3072",
                   "K1b": "in=200 H=100 T=50 B=4096 fwd need_dx=True"}
    meta = {
        "K1": ("gru_dir", "csrc/bigru.cu", "ops/bigru_pallas.py:127"),
        "K1b": ("gru_dir_bwd", "csrc/bigru_bwd.cu", "ops/bigru_pallas.py:284"),
        "K2": ("attention_block_fused", "csrc/bert_attn.cu", "ops/bert_attn_pallas.py:223"),
        "K3": ("ffn_ln_block", "csrc/bert_ffn.cu", "ops/bert_ffn_pallas.py:150"),
    }
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for kid, (name, source, replaces) in meta.items():
        mine = [r for r in rows if r["kid"] == kid]
        at = next(r for r in mine if r["shape"] == main_shape[kid])
        tr = next(r for r in mine if r["shape"] == train_shape[kid])
        kernels.append({"name": name, "route": "cuda", "source": f"{PKG}/{source}",
                        "replaces": f"multimodal_transformer_robustness_tpu/{replaces}",
                        "launches": sum(l[kid] for l in launches.values()),
                        "max_abs_err": max(r["abs"] for r in mine),
                        "max_err_over_max_ref": max(r["rel"] for r in mine),
                        **{k: at[k] for k in timed}, "shape": main_shape[kid],
                        "launches_by_path": {p: l[kid] for p, l in launches.items()},
                        "train_shape": train_shape[kid],
                        "at_train_shape": {k: tr[k] for k in timed}})
    return kernels


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
    t_start = time.perf_counter()

    phase("build")
    _build.load_library()
    print(f"built {_build.BuildInfo.path} in {_build.BuildInfo.seconds:.1f} s", flush=True)
    for line in _build.BuildInfo.log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  " + line.strip())

    phase("kernels")
    rows = check_kernels(dev, np.random.default_rng(0))
    torch.cuda.empty_cache()

    phase("serving")
    pred, cpu, serve_launches, warm_ms, plain_ms = serve(dev)

    phase("batched")
    batched(pred, cpu, dev)
    del pred, cpu
    torch.cuda.empty_cache()

    phase("train")
    spec, bert_cfg = mosei()
    train_launches, train_stats = train(dev, spec, bert_cfg)
    torch.cuda.empty_cache()

    phase("train-vs-cpu")
    train_card_vs_cpu(dev, spec, bert_cfg)

    kernels = kernel_entries(rows, {"serving": serve_launches, "train": train_launches})
    print(f"serving warm request ms, kernels {warm_ms}, plain {plain_ms}", flush=True)
    print("train " + json.dumps(train_stats), flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
