"""Drive the PyTorch port's serving, training and evaluation paths once on an
NVIDIA card.

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
                same function (cuDNN's GRU for K1 / K1b, scaled_dot_product_
                attention for K6a, K5 and K8), of that call; K1b, K5dq,
                K5dkv and K5b are also run twice to show bit-identical
                gradients, K3 and K5f to show a bit-identical output;
                K4's int32 products are checked exact and its flipped hidden
                codes counted; the int8 GEMM (qdot) exact at M=8 and
                M=131,072; the flash kernels (K5f, K5dq, K5dkv) at the MOSEI
                stack shapes (self T=50, cross Tq=50 Tk=32) and a long causal
                shape (T=2048), each without dropout and at rate 0.1 with the
                same seeds on both sides, K5b (the fused backward) at the
                MOSEI shapes beside the pair + delta op it replaces, and K8
                at the BERT's shapes (K6a's unit kernel up to 64 keys, its
                tiled kernel at L=512); K7f /
                K7b (the GRU recurrence) at G=2 T=50 N=4096 H=100 and T=64
                N=1 beside cuDNN's bidirectional GRU, K7b rerun for the same
                bits; K9f / K9b (the T==1 residual block) at the four MOSEI
                blocks, R=4096 train (K9b rerun for the same bits) and R=1
                eval; K1f and K6a at the edges of their launch plans (rerun
                for the same bits); K2 rerun for the same bits at every
                shape and timed also at B=1 L=512; K6b timed at every
                shape (split-K at B=1, wgmma at B=4096); then the device
                split: torch.profiler's device ms by kernel of K1f
                (projection, recurrence), K3 (fc1, fc2, LayerNorm), K2
                (q/k/v product, attention, o-projection, LayerNorm), K4
                (quantize x, GEMM1, quantize g1, GEMM2, LayerNorm), K6b
                (product, LayerNorm), K6a, K8, K7f and K7b at their two
                timed shapes, of K1b (recurrence, products, sums) at its three
                training-path shapes, of the flash backward's calls (the
                delta op, K5dq, K5dkv, K5b) at the MOSEI shapes, of K5f's
                unit path (MOSEI self and cross) and tiled path (B=16
                T=2048) and K5dkv and K5dq at T=2048, and of K9f
                (LN rows, its two products) and K9b (rows, the recompute,
                dp, ds, LN backward, weight reductions, sums) at the top
                FFN block, R=4096 train and R=1, and K9f at R=1 at the
                other three blocks, beside their CUDA-event ms; and the
                bf16 instances of K1f, K1b, K2 and K3 at the training
                path's shapes, K1f also at the serving (T=64 B=1) and eval
                (T=50 B=16) shapes and at the edges of its plan, K2 also at
                B=1 L=512 (its attention stage's device ms beside SDPA), K4
                and K6b at B=4096 L=32 and B=1 L=8, K6a at B=4096 L=32 and
                B=1 L=512 and at the edges of its plan (L = 1 .. 513), K1f,
                K1b, K3, K2 and K6b at B=4096 and K2 and K6a at B=1 L=512
                also timed under the parent commit's plans (parent_plans;
                K2 and K6b at B=4096 held to the persistent kernel's plan,
                K2 beside cuBLAS's two products alone; K2 and K6a at
                B=4096 held to the unit walk and to the block-a-unit
                kernel's bits, walk_off), against
                their bf16 plain versions (2e-2 of max |ref|) and the
                float32 kernels (cosine), rerun for the same bits, timed
                beside cuDNN's GRU in bf16 (K1f, K1b) and SDPA in bf16
                (K6a); K4's flipped hidden codes counted; qdot's bf16
                dequant at M=8 and 131,072 the plain version's bits; the
                bf16 instances of K5f, K5dq and K5dkv (self, cross, long;
                at self and cross K5dq and K5dkv called directly, the
                backward's path 1 forced) and K5b (self, cross), each at
                rates 0 and 0.1, and all four at odd T with D = 25
                (check_flash at bf16), against their bf16 plain versions
                (FLASH_BF16_TOL) and the float32 kernels (FLASH_BF16_COS),
                rerun for the same bits, timed beside SDPA in bf16, bound
                by the bf16 x bf16 products at PEAK_BF16_FLOPS and the
                rest at PEAK_BF16_F32_FLOPS; the bf16 instances of K8 (B=1
                L=8 and 512, B=4096 L=32 on the unit walk with the
                parent's plan timed beside it, held as the flash rows,
                beside SDPA in bf16 with the boolean mask), K7f / K7b (G=2 T=50
                N=4096 and T=64 N=1, beside cuDNN's bidirectional GRU in
                bf16; products with a float32 operand bound at
                PEAK_BF16_F32_FLOPS) and K9f / K9b (the four MOSEI blocks,
                R=4096 train and R=1 eval, float32 parameters), against
                their bf16 plain versions (BF16_TOL, K8 FLASH_BF16_TOL) and
                the float32 kernels (cosine), rerun for the same bits;
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
                CPU, dropout off;
  8. serving-int8 - phase 4 with StreamingPredictor(bert_int8=True): int8
                fc1 / fc2 through K4, float attention through K2;
  9. serving-dense - phase 4 with models.bert.ATTN_IMPL = "dense": plain
                q/k/v projections, K6a, K6b, K3;
 10. bert-int8-full - one frozen-BERT forward with every projection int8
                (quantize_bert_params(attn=True)) at B=8, L=32, card vs CPU;
 11. train-int8 - phase 6 with the int8 frozen BERT (K2 + K4);
 12. train-cached - the frozen-BERT features precomputed once
                (train/features.py), then phase 6 on them: no BERT kernel;
 13. cached-vs-online - one step on features and one on tokens at B=8,
                dropout off: equal losses and gradients;
 14. flash-stack - encoder_forward(attn_impl="flash") over the MOSEI cross
                stack (4 layers, Tq=50 Tk=32) and a mems0 self stack (3
                layers, T=50) at B=4096 in train mode with attention dropout
                0.1 through the kernels, then the backward of a scalar loss:
                K5f and K5b (the fused backward) once per layer; fwd+bwd ms
                beside the same stack with attn_impl="xla", eval-forward ms
                at B=16 T=2048; card vs CPU at B=8, dropout off, eval and
                train; then a T=96 self stack at B=8, train, dropout 0: K5f,
                K5dq and K5dkv once per layer (the backward's T > 64 path),
                card vs CPU;
 15. serving-flash - StreamingPredictor(attn_impl="flash"), 2 requests: the
                T==1 rule keeps K5f at 0 launches (K1 12, K2 4, K3 4 per
                request), predictions bit-identical to attn_impl="xla";
 16. flash-masked - K8's path, the library call flash_attention_masked at
                the BERT's width (B=8, L=32, 12x64, ragged masks and an
                all-zero row), against K6a and the CPU;
 17. gru-recurrence - K7's path, ops.gru.bigru_forward at the MOSEI
                header's second level (x [4096, 50, 200], H=100), forward
                and backward: K7f 1, K7b 1; fwd+bwd ms beside the header's
                route (K1 / K1b) and cuDNN; card vs CPU at N=8;
 18. trunk-block - K9's path, the library op fused_residual_block at the
                four MOSEI T==1 blocks (stream / top, attention / FFN),
                R=4096, train, dropout on: K9f 1, K9b 1 a call; fwd+bwd ms
                beside the eager composition of the same half-layer in the
                encoder's ops; card vs CPU at R=8 with the same hash masks;
 19. fit      - Trainer.fit at the MOSEI configuration, 2 epochs: the
                train split (2 batches of B=4096, T=50, L=32) resident on the
                card through DeviceBatchIterator, first held to the host
                BatchIterator bit for bit (shuffled; padded on the valid
                split), valid and test 64 rows at the eval batch of 16; per
                epoch K1 12 / K1b 12 / K2 4 / K3 4 a training step and K1 12
                / K2 4 / K3 4 a header pass of one validation and one test
                eval; epoch seconds and the curve; the same fit at B=4,
                dropout off, card vs CPU (curve, per-epoch losses);
 20. sweep    - missing_modality_sweep at the MOSEI configuration over the
                full 860-configuration grid (random_sample, cfg_chunk 64,
                valid and test 64 rows at batch 16): the headers hoisted, K1
                12 / K2 4 / K3 4 once per (subset, valid batch) and (subset,
                test batch) whatever the configuration count, the trunk one
                vmap pass a chunk; seconds, configurations/s, each subset's
                best configuration; card vs CPU on 4 rows of one valid
                batch, every configuration's predictions;
 21. train-bf16 - phase 6 under ModelSpec(compute_dtype="bfloat16"),
                bench.py's headline, the batch stored on the card in bf16
                (DeviceBatchIterator(store_dtype="bfloat16")): K1 12 /
                K1b 12 / K2 4 / K3 4 a step, every one a bf16 instance;
 22. train-bf16-cached - the features precomputed by the bf16 BERT, then
                phase 21's steps on them: K1 12 / K1b 12, all bf16;
 23. train-bf16-vs-cpu - one bf16 step (loss, float32 gradients) and one
                Trainer.evaluate at B=8, card against the CPU's plain
                versions;
 24. train-bf16-int8 - phase 21 with bench.py's --bert_int8 (fc1 / fc2
                quantized from the float32 weights, then cast): K1 12 /
                K1b 12 / K2 4 / K4 4 a step, all bf16;
 25. serving-bf16 - phase 4 under the MOSEI spec at compute_dtype
                "bfloat16" (text buckets 8, 32, 128, 512: K2's bf16 attention
                on both its paths): K1 12 / K2 4 / K3 4 a request, all bf16,
                card vs CPU within BF16_PRED_TOL of the predictions' scale;
 26. serving-bf16-int8 - phase 25 with bert_int8=True: K1 12 / K2 4 / K4 4;
 27. serving-bf16-dense - phase 25 under ATTN_IMPL="dense": K1 12 / K6a 4 /
                K6b 4 / K3 4;
 28. bert-int8-full-bf16 - phase 10 in bf16: qrows 8 / qdot 16 / K4 4, all
                bf16, card vs CPU by int8_agree.
 29. flash-stack-bf16 - phase 14 under the bf16 policy (the stack's
                parameters, masks and inputs cast as compute_cast casts
                them): K5f.bf16 and K5b.bf16 once per layer, ms beside the
                bf16 xla stack, the eval forward at B=16 T=2048, card vs CPU
                at B=8 (outputs within BF16_PRED_TOL, every gradient leaf
                a cosine of BF16_COS, the xla stack's beside them); then
                the T=96 stack, held so: K5f.bf16, K5dq.bf16 and
                K5dkv.bf16 once per layer;
 30. train-bf16-flash - one Trainer step at B=4096 under
                ModelSpec(compute_dtype="bfloat16", attn_impl="flash"): K1
                12 / K1b 12 / K2 4 / K3 4 (bf16) and no K5 (the T==1 rule);
                loss and gradients bit-identical to the xla spec's step;
 31. serving-bf16-flash - phase 15 under the bf16 spec: K1 12 / K2 4 / K3
                4 a request (bf16), K5f 0, predictions bit-identical to xla;
 32. flash-masked-bf16 - phase 16's call on bf16 q / k / v: K8 1 (bf16)
                on the unit walk, against the CPU (FLASH_BF16_TOL) and the
                float32 kernel (cosine FLASH_BF16_COS), the parent's plan
                held and timed beside it; D = 25 on the float32 plan;
 33. gru-recurrence-bf16 - phase 17 with bf16 weights and x: K7f 1 / K7b 1
                (bf16); fwd+bwd ms beside cuDNN in bf16; card vs CPU at N=8
                (outputs BF16_TOL, each gradient leaf a cosine of BF16_COS);
 34. trunk-block-bf16 - phase 18's four blocks at bf16 x and src with
                float32 parameters, R=4096 train and R=1 eval, forward and
                backward: K9f 1 / K9b 1 (bf16) a call; fwd+bwd ms; card vs
                CPU at R=8 with dropout on, held as phase 33.
Every phase sets the launch counters to 0 just before it drives its path
and fails unless each kernel of the path ran the expected number of times
(the bf16 instances counted apart: ``K1.bf16`` ... ``K9b.bf16``).
Then the int8 projections' and the device split's lines, one JSON line with
the kernels' results, and the last line ``{"ok": true, "device": {...}}``.
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

T0 = time.perf_counter()  # the script's start, for the phase headings

# Tolerances, card against plain PyTorch on the same inputs, float32, TF32
# off.  K1 and K3 differ only in summation order (atol 1e-4 on outputs of
# order 1).  K2 gets 1e-3: the HF key bias is an additive -10000, where
# float32 steps are 2**-10 apart, so a last-bit difference in a masked logit
# can move it by one such step.  K1b's error is normalised by max |ref| of
# each gradient: its weight gradients are sums over up to T*B = 204,800 rows,
# added in another order than the plain version's (split-K partials against
# cuBLAS), and dx and the dh carry chain 50 steps back.
# K6a as K2 (the same attention stage and -10000 bias), K6b as K3 (a GEMM
# and the row LayerNorm).  K4: its int32 products must be exact, and its
# dequant and gelu epilogues are the plain version's operations in the same
# order, so its hidden int8 codes should match; a code one float32 step from
# a rounding edge may still flip, so the share of flipped codes is held to
# 1e-3, and each output row to 1e-4 (the LayerNorm, summed in another order)
# plus, per flipped code in the row, twice the largest move one code can make
# (sg * max|w2| through the LayerNorm: * max|ln_g| / the row's std); see
# k4_row_bound.
# K5f and K8 (flash forward) are held to 1e-4 absolute on outputs of order
# 1 (and K5f's log-sum-exp); K5dq / K5dkv and K5b (the fused backward) to
# 1e-4 of each gradient's max |ref|, sums over up to Tk or Tq score entries
# in another order.
# K7f (the GRU recurrence) and K9f (the T==1 residual block) are held to
# 1e-4 absolute on outputs of order 1, summation order only (the hash
# dropout is integer math, the same bits on both sides); K7b and K9b to 1e-4
# of each output's max |ref|: K7b's carry chains back 50 steps, K9b's
# parameter gradients are sums over R rows in another order.  In relu
# blocks an entry of the hidden pre-activation a few float32 steps from 0
# may take the other side of the kink on the card than in cuBLAS, and
# either derivative is valid: K9b may use, per element, the most that
# flipping the entries within 1e-4 of the kink can move each gradient
# (relu_kink_bound) before the tolerance applies.
# The bf16 instances of K1f, K1b, K2 and K3 (the bf16 compute policy)
# against their bf16 plain versions, at the same rounding points: max |out -
# ref| within 2e-2 of max |ref| (a result one bf16 step apart where a float32
# sum in another order lands across a rounding edge, and what that step
# moves downstream); their cosine against the float32 kernel on the same
# (bf16-valued) inputs is printed and held to 0.999.
BF16_TOL, BF16_COS = 2e-2, 0.999
# The bf16 instances of the flash kernels (K5f, K5b, K5dq, K5dkv) compute the
# JAX kernels' function: float32 between bf16 operands, one rounding of each
# output.  Against their bf16 plain versions: within 1e-2 of max |ref|
# (about one bf16 step at the top); against the float32 kernel on the same
# bf16-valued operands: a cosine of at least 0.99999 (the outputs' one
# rounding), lse (float32) within 1e-5 of max |ref| of both.
FLASH_BF16_TOL, FLASH_BF16_COS, FLASH_BF16_LSE_TOL = 1e-2, 0.99999, 1e-5
# K8's bf16 instance computes the same function (p float32 through P V, the
# output rounded once) and is held as they are.
FLASH_BF16_KERNELS = ("K5f.bf16", "K5b.bf16", "K5dq.bf16", "K5dkv.bf16", "K8.bf16")
# K7's and K9's bf16 instances as K1f's ... K6b's: 2e-2 of max |ref|
# against their bf16 plain versions, a cosine of BF16_COS against the
# float32 kernels; their library-op phases hold the card against the CPU
# so (outputs) and leaf by leaf by cosine (gradients)
BF16_KERNELS = ("K1f.bf16", "K1b.bf16", "K2.bf16", "K3.bf16", "K4.bf16", "K6a.bf16",
                "K6b.bf16", "K7f.bf16", "K7b.bf16", "K9f.bf16", "K9b.bf16")
TOL = {"K1": 1e-4, "K1b": 1e-4, "K2": 1e-3, "K3": 1e-4, "K4": 1e-4, "K6a": 1e-3,
       "K6b": 1e-4, "K5f": 1e-4, "K5dq": 1e-4, "K5dkv": 1e-4, "K5b": 1e-4, "K8": 1e-4,
       "K7f": 1e-4, "K7b": 1e-4, "K9f": 1e-4, "K9b": 1e-4,
       **{k: BF16_TOL for k in BF16_KERNELS}, **{k: FLASH_BF16_TOL for k in FLASH_BF16_KERNELS}}
# the kernels held to TOL as a share of max |ref| rather than absolutely
NORMALISED = {"K5dq", "K5dkv", "K5b", "K7b", "K9b", *BF16_KERNELS, *FLASH_BF16_KERNELS}
K4_MAX_FLIP_SHARE = 1e-3
SERVE_TOL = 1e-3   # end-to-end sentiment, card against CPU
# one training step, card against CPU: the loss relative, each gradient
# normalised by its max |ref| (plus 1e-6 absolute for all-but-zero ones);
# both float32, summed in other orders through a 4-layer BERT, two GRU
# levels over 50 steps and eleven encoder stacks
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-4, 1e-3
# the bf16 policy, card against CPU (the same rounding points, float32 sums
# in other orders): the loss within 1e-2 relative, the gradients (float32)
# as one vector with a cosine of 0.999; evaluate's predictions within 2e-2
# of their scale, max |ref| over the rows.  bf16 rounds every layer's
# output, so a float32 sum in another order flips a step here and there,
# and the flips compound through the BERT's layers and the GRU's 50 steps:
# at MOSEI width a quarter of the headers' outputs differ from the CPU's,
# as many on the card's cuBLAS route through the plain versions as through
# the kernels, and a prediction, a sum of terms of the activations' scale,
# moves by up to a bf16 step of the largest prediction, of the scale and
# not of its own value (tools/bf16_gap.py; PERF.md)
BF16_LOSS_TOL, BF16_PRED_TOL = 1e-2, 2e-2
# A bf16 flash stack's float32 gradients, card against CPU, are held leaf
# by leaf to a cosine of BF16_COS, the q, k and v parts of each stacked
# in-projection apart (qkv_apart): what dq and dk feed is a small share of
# the whole vector's norm.  Not by
# max |error|: one bf16 flip moves a leaf's largest element by up to 9e-2
# of its max |ref|, by several times more on one stack than on the other
# from leaf to leaf (tools/bf16_leaf_spread.py).

# H100 SXM peaks (NVIDIA data sheet).  Float32 products at the rate the card
# can do them to float32 accuracy: on the tensor cores in 3xTF32 (three TF32
# MMAs a product, as csrc/gemm_tc.cuh), 495 / 3 = 165 TFLOP/s, above the CUDA
# cores' 67, so every float32 row shares one yardstick that no kernel can
# beat; the int8 tensor cores for K4's products; HBM3 rate
PEAK_F32_FLOPS, PEAK_INT8_OPS, PEAK_BYTES = 495e12 / 3, 1979e12, 3.35e12
# the bf16 tensor cores (dense), the bf16 instances' yardstick
PEAK_BF16_FLOPS = 989e12
# products of a bf16 and a float32 operand to float32 accuracy (the bf16
# flash instances' P V, dS K, P^T dO, dS^T Q): the float32 operand split
# into three bf16 planes, three bf16 MMAs a product (989 / 3 = 330
# TFLOP/s), above two TF32 MMAs (495 / 2 = 247)
PEAK_BF16_F32_FLOPS = PEAK_BF16_FLOPS / 3
# the 7 non-empty modality subsets (bench.py's training pool)
POOL = [[0], [1], [2], [0, 1], [0, 2], [1, 2], [0, 1, 2]]
PKG = "multimodal_transformer_robustness_tpu_torch"


def phase(name: str) -> None:
    """A phase's heading, with the host seconds since the script started
    (a phase's time is the difference to the next heading's)."""
    print(f"== {name} (at {time.perf_counter() - T0:.1f} s)", flush=True)


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


def beyond_allowance(pairs, slack):
    """Over (out, ref) pairs, the largest error left after each element's
    allowance in ``slack``: (absolute, relative to each ref's max |ref|).
    A NaN stays NaN and fails."""
    beyond = [(torch.clamp((o - r).abs() - s, min=0.0).max().item(),
               max(r.abs().max().item(), 1e-30)) for (o, r), s in zip(pairs, slack)]
    return max(b for b, _ in beyond), max(b / m for b, m in beyond)


def bound(flops, nbytes: float, peak: float = PEAK_F32_FLOPS):
    """The least time the card could take: (ms, what bounds it).  The bf16
    rows pass (flops, bytes, PEAK_BF16_FLOPS).  ``flops``: a count at
    ``peak``, or ((count, rate), ...) for work whose products run at
    several rates (the bf16 flash rows, :func:`flash_work`)."""
    t_ops = (sum(f / r for f, r in flops) if isinstance(flops, tuple) else flops / peak)
    t_bytes = nbytes / PEAK_BYTES
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


def k4_work(R, h, f):
    """int8 operations of the two products; float32 rows in and out, int8
    weights, float32 scales, biases and LN parameters."""
    return 4 * R * h * f, 4 * 2 * R * h + 2 * h * f + 4 * (2 * f + 4 * h)


def k1f_bf16_work(T, B, i, H):
    """bf16 x, weights and h; the float32 gate pre-activations K1b reads
    back are the kernel's scratch, as in k1f_work."""
    return 2 * T * B * 3 * H * (i + H), 2 * (T * B * i + 3 * H * (i + H) + 4 * H + T * B * H)


def k1b_bf16_work(T, B, i, H, need_dx):
    """bf16 x, h, dh, weights and gradients; the float32 saved gates."""
    flops = k1b_work(T, B, i, H, need_dx)[0]
    ins = T * B * i + 2 * T * B * H + 3 * H * H + H + (3 * H * i if need_dx else 0)
    outs = 3 * H * (i + H) + 4 * H + (T * B * i if need_dx else 0)
    return flops, 2 * (ins + outs) + 4 * 3 * T * B * H


def k2_bf16_work(B, L, h):
    return k2_work(B, L, h)[0], 2 * (2 * B * L * h + 4 * h * h + 6 * h) + 4 * B * L


def k3_bf16_work(B, L, h, f):
    return k3_work(B, L, h, f)[0], 2 * (2 * B * L * h + 2 * h * f + f + 3 * h)


def k6a_work(B, L, h):
    return 4 * B * L * L * h, 4 * (4 * B * L * h + B * L)


def k6b_work(R, h):
    return 2 * R * h * h, 4 * (3 * R * h + h * h + 3 * h)


def k4_bf16_work(R, h, f):
    """As k4_work, the rows, scales, biases and LN parameters bf16."""
    return 4 * R * h * f, 2 * 2 * R * h + 2 * h * f + 2 * (2 * f + 4 * h)


def k6a_bf16_work(B, L, h):
    """bf16 q, k, v and out; the float32 mask."""
    return 4 * B * L * L * h, 2 * 4 * B * L * h + 4 * B * L


def k6b_bf16_work(R, h):
    return 2 * R * h * h, 2 * (3 * R * h + h * h + 3 * h)


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


@contextmanager
def parent_plans():
    """The bf16 launch plans of the commits before the redesigns of the
    bf16 rows, for the parent kernels' times in the same call: K6a.bf16's
    and K2.bf16's attention at L <= 64 on the block-a-unit kernel (path 0,
    which still serves fewer units) and past L = 64 on the three-pass tiled
    kernel (path 1, which still serves L > 512); K8.bf16 on the float32
    HARD kernels by the float32 plan (which still serve D = 25 and longer
    units); K1f.bf16's recurrence on the
    tiled form (which still serves H > 104) and its projection on
    gemm_bf16.cuh's 128-wide wgmma tiles (which still serve 3H > 304);
    K3.bf16's, K2.bf16's and K6b.bf16's products on those 128 x 128 wgmma
    tiles with the weights' transposes (bf_transpose_b, which the 3H > 304
    projections of K1f.bf16 still run) and their LayerNorms a block a row;
    K1b.bf16's recurrence on the tiled form (the float plan's, which K7b
    and wider H still run) and its reductions on the transposed-A mma.sync
    tiles.  Their sources are unchanged, so these are the parent's kernels,
    launched as it launched them."""
    from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda as ba
    from multimodal_transformer_robustness_tpu_torch.ops import bert_ffn_cuda as bf
    from multimodal_transformer_robustness_tpu_torch import _build
    from multimodal_transformer_robustness_tpu_torch.ops import bigru_cuda as bg
    from multimodal_transformer_robustness_tpu_torch.ops import gemm_tc

    attn, fwd, ffn, bwd = (ba._plan_attention_bf16, bg._plan_gru_fwd_bf16, bf._plan_ffn_bf16,
                           bg._plan_gru_bwd_bf16)
    block, proj = ba._plan_attn_block_bf16, bf._plan_proj_ln_bf16
    masked = ba._plan_attention_masked_bf16

    def first_port(p, m, n, k, num_sms):
        """A product's plan off the persistent kernel: the 128 x 128 wgmma
        tiles with B^T made per call."""
        return gemm_tc.plan_bf16(m, n, k, p["acw"], p["bcw"], num_sms) if p["wgmma"] == 2 else p

    def block_parent(B, L, h, n_heads, num_sms=_build.NUM_SMS, *addrs):
        p = block(B, L, h, n_heads, num_sms, *addrs)
        p["qkv"] = first_port(p["qkv"], B * L, 3 * h, h, num_sms)
        p["o"] = first_port(p["o"], B * L, h, h, num_sms)
        p["partial"] = max(p["qkv"]["partial"], p["o"]["partial"])
        return p

    def proj_parent(rows, h, num_sms=_build.NUM_SMS, *addrs):
        return first_port(proj(rows, h, num_sms, *addrs), rows, h, h, num_sms)

    def attn_parent(B, L, n_heads, dh, num_sms=_build.NUM_SMS):
        p = attn(B, L, n_heads, dh, num_sms)
        if p["path"] == 3:
            p = {"path": 0, "units": p["units"], "qtiles": 1, "threads": 128, "smem": 0,
                 "blocks": p["units"]}
        if p["path"] == 2:
            qtiles = -(-L // ba._AB_ROWS)
            p = {"path": 1, "units": p["units"], "qtiles": qtiles, "threads": 128, "smem": 0,
                 "blocks": p["units"] * qtiles}
        return p

    def masked_parent(*args):
        return None

    def fwd_parent(T, B, in_dim, H, *args):
        p = fwd(T, B, in_dim, H, *args)
        if p["rec_mma"]:
            p.update(rec_mma=0, **bg._plan_recurrence(1, B, H, *args[:1]))
        p["gemm_wgmma"] = min(p["gemm_wgmma"], 1)
        return p

    def ffn_parent(rows, h, f, num_sms=_build.NUM_SMS, *addrs):
        p = ffn(rows, h, f, num_sms, *addrs)
        for fc, (m, n, k) in (("fc1", (rows, f, h)), ("fc2", (rows, h, f))):
            if p[fc]["wgmma"] == 2:
                p[fc] = gemm_tc.plan_bf16(m, n, k, 8, 8, num_sms)
        p["partial"] = max(p["fc1"]["partial"], p["fc2"]["partial"])
        return p

    def bwd_parent(T, B, in_dim, H, need_dx, num_sms=_build.NUM_SMS, x_addr=0, hs_addr=0):
        p = bwd(T, B, in_dim, H, need_dx, num_sms, x_addr, hs_addr)
        if p["rec_mma"]:
            p.update(rec_mma=0, rec_vec=0, hp=0, **bg._plan_rec_bwd(1, B, H, num_sms))
        bcw = gemm_tc.bf16_copy_width((4 * H,))
        for name, m, n, acw in (("dwp", in_dim, 3 * H, p["dwp_acw"]),
                                ("dwt", H + 1, 4 * H, gemm_tc.bf16_copy_width((H,), (hs_addr,)))):
            q = gemm_tc.plan_bf16(m, n, T * B, acw, bcw, num_sms, max_splits=None,
                                  transposed_a=True)
            p.update({f"{name}_{k}": q[k] for k in gemm_tc.BF_PLAN_KEYS + ("partial",)})
        return p

    caches = (ba._cached_plan_bf16, ba._cached_block_plan_bf16, bg._cached_plan_bf16,
              bf._cached_ffn_plan_bf16, bg._cached_bwd_plan_bf16, bf._cached_proj_ln_plan_bf16,
              ba._cached_plan_masked_bf16)
    (ba._plan_attention_bf16, bg._plan_gru_fwd_bf16, bf._plan_ffn_bf16,
     bg._plan_gru_bwd_bf16, ba._plan_attn_block_bf16, bf._plan_proj_ln_bf16,
     ba._plan_attention_masked_bf16) = (
        attn_parent, fwd_parent, ffn_parent, bwd_parent, block_parent, proj_parent,
        masked_parent)
    for cache in caches:
        cache.cache_clear()
    try:
        yield
    finally:
        (ba._plan_attention_bf16, bg._plan_gru_fwd_bf16, bf._plan_ffn_bf16,
         bg._plan_gru_bwd_bf16, ba._plan_attn_block_bf16, bf._plan_proj_ln_bf16,
         ba._plan_attention_masked_bf16) = (attn, fwd, ffn, bwd, block, proj, masked)
        for cache in caches:
            cache.cache_clear()


@contextmanager
def walk_off():
    """The bf16 attention plans with the unit walk at no unit count:
    K6a.bf16's and K2.bf16's attention at L <= 64 on the block-a-unit
    kernel, the parent's path 0, and every other plan as it is."""
    from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda as ba

    old = ba._WALK_MIN_UNITS
    ba._WALK_MIN_UNITS = 1 << 62
    ba._cached_plan_bf16.cache_clear()
    ba._cached_block_plan_bf16.cache_clear()
    try:
        yield
    finally:
        ba._WALK_MIN_UNITS = old
        ba._cached_plan_bf16.cache_clear()
        ba._cached_block_plan_bf16.cache_clear()


def device_ms_of(split: dict, prefix: str) -> float:
    """The device ms of a split's kernels whose names start with ``prefix``."""
    return sum(v for k, v in split.items() if k.startswith(prefix))


def parent_ms(fn, iters):
    """CUDA-event ms of ``fn`` under :func:`parent_plans`."""
    with parent_plans():
        fn()
        torch.cuda.synchronize()
        return cuda_ms(fn, iters)


def parent_and_splits(kid, shape, fn, iters=5):
    """A redesigned row's parent time (under :func:`parent_plans`) and both
    device splits by kernel (torch.profiler), printed and returned as the
    row's extra fields."""
    with parent_plans():
        fn()
        torch.cuda.synchronize()
        parent_split = profile_ms(fn, iters)
    extra = {"parent_ms": parent_ms(fn, iters), "split_ms": profile_ms(fn, iters),
             "parent_split_ms": parent_split}
    print(f"  {kid} {shape}: device split {extra['split_ms']}, parent "
          f"{extra['parent_ms']:.4f} ms, its split {parent_split}", flush=True)
    return extra


def check_kernels(dev, rng):
    from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda, bert_ffn_cuda
    from multimodal_transformer_robustness_tpu_torch.ops import bigru_cuda

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    rows, failures = [], []

    def record(kid, shape, out, ref, kernel_fn, plain_fn, work=None, library_fn=None,
               iters=20, slack=None, extra=None, peak=None):
        """``out`` / ``ref``: a tensor, or a tuple of tensors each held to the
        tolerance on its own (relative to its own max |ref| in NORMALISED).
        ``slack``: per output, an elementwise allowance the error may use
        before the tolerance applies (K9b's relu kink, relu_kink_bound).
        ``extra``: more fields for the row (K5b: the pair's time).  ``peak``:
        the bound's rate (default: bf16 for a bf16 instance, else float32)."""
        pairs = list(zip(out, ref) if isinstance(out, tuple) else [(out, ref)])
        errs = [errors(o, r) for o, r in pairs]
        abs_err, rel_err = max(e[0] for e in errs), max(e[1] for e in errs)
        judged = (abs_err, rel_err) if slack is None else beyond_allowance(pairs, slack)
        normalised = kid in NORMALISED
        ok = (judged[1] if normalised else judged[0]) <= TOL[kid]
        row = dict(kid=kid, shape=shape, abs=abs_err, rel=rel_err, **(extra or {}))
        if slack is not None:
            row["rel_beyond_allowance"] = judged[1]
        msg = (f"{kid} {shape}: max_abs {abs_err:.3e} max_rel {rel_err:.3e}"
               + (f" (beyond the kink allowance: {judged[1]:.3e})" if slack is not None else "")
               + f" (tol {TOL[kid]:g}{' of max|ref|' if normalised else ''}) "
               f"{'ok' if ok else 'FAIL'}")
        if work is not None:
            row.update(ms=cuda_ms(kernel_fn, iters),
                       plain_ms=cuda_ms(plain_fn, iters),
                       library_ms=cuda_ms(library_fn, iters) if library_fn else None)
            row["bound_ms"], row["bound_by"] = bound(
                *work, peak or (PEAK_BF16_FLOPS if kid.endswith(".bf16") else PEAK_F32_FLOPS))
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
    check_k1f_k6a_edges(dev, rng, t, record, failures)
    rows += check_k1b(dev, rng, t, failures)

    # K2 and K3 at BERT-base width (weights at HF's init scale), at the
    # serving shapes and the training shape (B=4096, L=32)
    h, ffn, heads, eps = 768, 3072, 12, 1e-12
    aw = [t(rng.standard_normal((h, h)) * 0.02) for _ in range(4)]
    ab = [t(rng.standard_normal(h) * 0.02) for _ in range(4)]
    # q/k/v as views of one stacked weight and bias, as models/bert.prepare_bert
    # lays them out for K2's one q/k/v product
    aw[:3], ab[:3] = torch.stack(aw[:3]).unbind(0), torch.cat(ab[:3]).split(h)
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
        again = bert_attn_cuda.attention_block_fused(*a_args, n_heads=heads, eps=eps)
        torch.cuda.synchronize()
        ref = bert_attn_cuda.attention_block_plain(*a_args, n_heads=heads, eps=eps)
        same = torch.equal(out, again)
        # K2 is also timed at the longest text bucket, B=1 L=512
        record("K2", f"B={B} L={L} h={h}", out, ref,
               lambda: bert_attn_cuda.attention_block_fused(*a_args, n_heads=heads, eps=eps),
               lambda: bert_attn_cuda.attention_block_plain(*a_args, n_heads=heads, eps=eps),
               work=k2_work(B, L, h) if timed or (B, L) == (1, 512) else None, iters=iters,
               extra={"rerun_bit_identical": same})
        if not same:
            failures.append(f"K2 B={B} L={L}: rerun differs")
        del out, again, ref
        f_args = (x, w1t, b1, w2t, b2, g, b)
        out = bert_ffn_cuda.ffn_ln_block(*f_args, eps=eps)
        again = bert_ffn_cuda.ffn_ln_block(*f_args, eps=eps)
        torch.cuda.synchronize()
        ref = bert_ffn_cuda.ffn_ln_block_plain(*f_args, eps=eps)
        same = torch.equal(out, again)
        record("K3", f"B={B} L={L} h={h} ffn={ffn}", out, ref,
               lambda: bert_ffn_cuda.ffn_ln_block(*f_args, eps=eps),
               lambda: bert_ffn_cuda.ffn_ln_block_plain(*f_args, eps=eps),
               work=k3_work(B, L, h, ffn) if timed else None, iters=iters,
               extra={"rerun_bit_identical": same})
        if not same:
            failures.append(f"K3 B={B} L={L}: rerun differs")
        del out, again, ref, x
    rows += check_bert_variants(dev, rng, t, record, failures)
    check_flash(dev, rng, t, record, failures)
    check_k7(dev, rng, t, record, failures)
    check_k9(dev, rng, t, record, failures)
    rows += check_bf16(dev, rng, t, record, failures)
    # its own seed, so that the rows above keep their inputs
    check_flash(dev, np.random.default_rng(18), t, record, failures, torch.bfloat16,
                odd=((3, 7, 7), (3, 9, 7), (3, 9, 9)))
    check_k7(dev, np.random.default_rng(19), t, record, failures, torch.bfloat16)
    check_k9(dev, np.random.default_rng(20), t, record, failures, torch.bfloat16)
    if failures:
        raise RuntimeError(f"kernels disagree with their plain versions: {failures}")
    return rows


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))


def check_bf16(dev, rng, t, record, failures):
    """The bf16 instances of K1f, K1b, K2 and K3 at the training path's
    shapes (K1f in=768 T=50 B=4096; K1b in=768 and 512 without dx, 200 with
    it; K2 and K3 at B=4096 L=32): against their bf16 plain versions
    (BF16_TOL of max |ref|), their cosine against the float32 kernel on the
    same bf16-valued inputs (BF16_COS), a rerun for the same bits; CUDA-event
    ms of the kernel, the plain version and, for K1f / K1b, cuDNN's GRU in
    bf16 (forward; backward by autograd), the bound at the bf16 tensor
    cores' 989 TFLOP/s."""
    from multimodal_transformer_robustness_tpu_torch import _build
    from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda, bert_ffn_cuda
    from multimodal_transformer_robustness_tpu_torch.ops import bigru_cuda

    bf = torch.bfloat16

    def judge(kid, shape, outs, refs, f32s, again, fail=False, **timing):
        """Per output (None where the kernel gives none: dx without it);
        ``fail``: a check of the caller's own failed (K4's flipped codes)."""
        kept = [q for q in zip(outs, refs, f32s, again) if q[0] is not None]
        outs, refs, f32s, again = zip(*kept)
        cos = min(cosine(o.float(), f) for o, f in zip(outs, f32s))
        same = all(torch.equal(a, b) for a, b in zip(outs, again))
        differ = max(float((o != r).float().mean()) for o, r in zip(outs, refs))
        record(kid, shape, tuple(o.float() for o in outs), tuple(r.float() for r in refs),
               extra={"cos_vs_float32": cos, "rerun_bit_identical": same,
                      "share_differing": differ, **timing.pop("extra", {})}, **timing)
        print(f"  {kid} {shape}: cosine vs the float32 kernel {cos:.6f} (min {BF16_COS}), "
              f"rerun bit-identical {same}, {differ:.2%} of elements differ from the plain "
              "version", flush=True)
        if cos < BF16_COS or not same or fail:
            failures.append(f"{kid} {shape}: cosine {cos} / rerun {same} / own check {fail}")

    H, T, B = 100, 50, 4096
    x768 = t(rng.standard_normal((T, B, 768))).to(bf)
    for in_dim, need_dx in ((768, False), (512, False), (200, True)):
        w = {k: v.to(bf) for k, v in gru_weights(rng, in_dim, H, dev).items()}
        ops = bigru_cuda.dir_operands(w)
        args = tuple(ops[k] for k in ("wp", "wt", "bc", "bhn"))
        args32 = tuple(a.float() for a in args)
        x = x768 if in_dim == 768 else t(rng.standard_normal((T, B, in_dim))).to(bf)
        dhs = t(rng.standard_normal((T, B, H))).to(bf)
        gru = torch.nn.GRU(in_dim, H).to(dev)
        with torch.no_grad():
            for n, p in (("weight_ih_l0", "w_ih"), ("weight_hh_l0", "w_hh"),
                         ("bias_ih_l0", "b_ih"), ("bias_hh_l0", "b_hh")):
                getattr(gru, n).copy_(w[p].float())
        gru = gru.to(bf)
        gru.flatten_parameters()
        try:   # cuDNN's GRU in bf16, the library yardstick, where this build has it
            gru(x[:1])
        except RuntimeError as e:
            print(f"  cuDNN's GRU takes no bf16 here ({str(e).splitlines()[0]}): "
                  "library_ms none", flush=True)
            gru = None
        if in_dim == 768:
            out = bigru_cuda.gru_dir(x, *args, False)
            again = bigru_cuda.gru_dir(x, *args, False)
            torch.cuda.synchronize()
            fn = lambda: bigru_cuda.gru_dir(x, *args, False)   # noqa: E731
            with parent_plans():
                parent_split = profile_ms(fn, 5)
            extra = {"parent_ms": parent_ms(fn, 5), "split_ms": profile_ms(fn, 5),
                     "parent_split_ms": parent_split}
            print(f"  K1f.bf16 B={B}: device split {extra['split_ms']}, parent "
                  f"{extra['parent_ms']:.4f} ms, its split {parent_split}", flush=True)
            judge("K1f.bf16", f"in={in_dim} H={H} T={T} B={B} fwd", (out,),
                  (bigru_cuda.gru_dir_plain(x, *args, False),),
                  (bigru_cuda.gru_dir(x.float(), *args32, False),), (again,),
                  kernel_fn=fn, plain_fn=lambda: bigru_cuda.gru_dir_plain(x, *args, False),
                  work=k1f_bf16_work(T, B, in_dim, H),
                  library_fn=(lambda: gru(x)) if gru is not None else None, iters=5,
                  extra=extra)
            del out, again
            # the serving batch of 1 (T=64, the longest audio bucket) and the
            # eval batch of 16: the small recurrence form, split projections
            for Ts, Bs in ((64, 1), (50, 16)):
                xs = t(rng.standard_normal((Ts, Bs, in_dim))).to(bf)
                out = bigru_cuda.gru_dir(xs, *args, False)
                again = bigru_cuda.gru_dir(xs, *args, False)
                torch.cuda.synchronize()
                judge("K1f.bf16", f"in={in_dim} H={H} T={Ts} B={Bs} fwd", (out,),
                      (bigru_cuda.gru_dir_plain(xs, *args, False),),
                      (bigru_cuda.gru_dir(xs.float(), *args32, False),), (again,),
                      kernel_fn=lambda xs=xs: bigru_cuda.gru_dir(xs, *args, False),
                      plain_fn=lambda xs=xs: bigru_cuda.gru_dir_plain(xs, *args, False),
                      work=k1f_bf16_work(Ts, Bs, in_dim, H),
                      library_fn=(lambda xs=xs: gru(xs)) if gru is not None else None)
                del out, again, xs
        hs, gates = bigru_cuda._launch_fwd(x, *args, False)
        got = bigru_cuda.gru_dir_bwd(x, *args, hs, gates, dhs, False, need_dx)
        again = bigru_cuda.gru_dir_bwd(x, *args, hs, gates, dhs, False, need_dx)
        torch.cuda.synchronize()
        ref = bigru_cuda.gru_dir_bwd_plain(x, *args, hs, gates, dhs, False, need_dx)
        hs32, gates32 = bigru_cuda._launch_fwd(x.float(), *args32, False)
        f32 = bigru_cuda.gru_dir_bwd(x.float(), *args32, hs32, gates32, dhs.float(), False,
                                     need_dx)
        del hs32, gates32
        library = None
        if gru is not None:
            xg = x.clone().requires_grad_(need_dx)
            y, _ = gru(xg)
            wrt = ([xg] if need_dx else []) + list(gru.parameters())

            def library():
                return torch.autograd.grad(y, wrt, dhs, retain_graph=True)

        def fn():
            return bigru_cuda.gru_dir_bwd(x, *args, hs, gates, dhs, False, need_dx)

        extra = parent_and_splits("K1b.bf16", f"in={in_dim}", fn)
        judge("K1b.bf16", f"in={in_dim} H={H} T={T} B={B} fwd need_dx={need_dx}", got, ref,
              f32, again, kernel_fn=fn,
              plain_fn=lambda: bigru_cuda.gru_dir_bwd_plain(x, *args, hs, gates, dhs, False,
                                                            need_dx),
              work=k1b_bf16_work(T, B, in_dim, H, need_dx), library_fn=library, iters=5,
              extra=extra)
        del got, again, ref, f32, hs, gates, library
    del x768
    torch.cuda.empty_cache()

    h, ffn, heads, eps, B, L = 768, 3072, 12, 1e-12, 4096, 32
    aw = [t(rng.standard_normal((h, h)) * 0.02).to(bf) for _ in range(4)]
    ab = [t(rng.standard_normal(h) * 0.02).to(bf) for _ in range(4)]
    aw[:3], ab[:3] = torch.stack(aw[:3]).unbind(0), torch.cat(ab[:3]).split(h)
    g, b = t(1.0 + 0.1 * rng.standard_normal(h)).to(bf), t(0.1 * rng.standard_normal(h)).to(bf)
    x = t(rng.standard_normal((B, L, h))).to(bf)
    mask = np.zeros((B, L), np.float32)
    for i in range(1, B):
        mask[i, : rng.integers(1, L + 1)] = 1.0
    mask = t(mask)
    a_args = (x, mask, aw[0], ab[0], aw[1], ab[1], aw[2], ab[2], aw[3], ab[3], g, b)
    a32 = tuple(a.float() for a in a_args)
    kw = dict(n_heads=heads, eps=eps)
    out = bert_attn_cuda.attention_block_fused(*a_args, **kw)
    again = bert_attn_cuda.attention_block_fused(*a_args, **kw)
    torch.cuda.synchronize()
    extra = parent_and_splits("K2.bf16", f"B={B} L={L}",
                              lambda: bert_attn_cuda.attention_block_fused(*a_args, **kw))
    w3 = torch.cat(aw[:3], dim=1)   # [h, 3h]: cuBLAS, the two products alone, a yardstick
    extra["cublas_products_ms"] = {"qkv": cuda_ms(lambda: torch.matmul(x, w3), 5),
                                   "o": cuda_ms(lambda: torch.matmul(x, aw[3]), 5)}
    print(f"  cuBLAS bf16, the two products alone: {extra['cublas_products_ms']}", flush=True)
    del w3
    # the attention stage on the unit walk, bit-identical to the block-a-unit
    # kernel (the parent's plan) under both softmax rules
    same = []
    for softmax in ("float32", "bfloat16"):
        kws = dict(kw, softmax_dtype=softmax)
        walk = out if softmax == "float32" else bert_attn_cuda.attention_block_fused(
            *a_args, **kws)
        with walk_off():
            same.append(torch.equal(walk, bert_attn_cuda.attention_block_fused(*a_args, **kws)))
        del walk
    extra.update(attention_ms=device_ms_of(extra["split_ms"], "attention_bf16"),
                 attention_parent_ms=device_ms_of(extra["parent_split_ms"], "attention_bf16"),
                 attention_bit_identical_to_parent=all(same))
    print(f"  K2.bf16 B={B} L={L}: attention stage {extra['attention_ms']:.4f} ms of device "
          f"time (parent {extra['attention_parent_ms']:.4f}); bit-identical to the "
          f"block-a-unit kernel under the float32 / bf16 softmax {same}", flush=True)
    # both products on the persistent kernel, no weight transposed per call;
    # the attention on the unit walk
    plan = bert_attn_cuda._plan_attn_block_bf16(B, L, h, heads, _build.num_sms(dev),
                                                x.data_ptr() % 16, aw[0].data_ptr() % 16,
                                                aw[3].data_ptr() % 16)
    off_path = (plan["qkv"]["wgmma"], plan["o"]["wgmma"], plan["attention"]["path"]) != (
        2, 2, 3) or any(k.startswith("bf_transpose_b") for k in extra["split_ms"]) or not all(
        same) or not device_ms_of(extra["split_ms"], "attention_bf16_walk")
    judge("K2.bf16", f"B={B} L={L} h={h}", (out,),
          (bert_attn_cuda.attention_block_plain(*a_args, **kw),),
          (bert_attn_cuda.attention_block_fused(*a32, **kw),), (again,), fail=off_path,
          kernel_fn=lambda: bert_attn_cuda.attention_block_fused(*a_args, **kw),
          plain_fn=lambda: bert_attn_cuda.attention_block_plain(*a_args, **kw),
          work=k2_bf16_work(B, L, h), iters=5, extra=extra)
    del out, again, a32
    w1t = t(rng.standard_normal((h, ffn)) * 0.02).to(bf)
    w2t = t(rng.standard_normal((ffn, h)) * 0.02).to(bf)
    b1, b2 = t(rng.standard_normal(ffn) * 0.02).to(bf), t(rng.standard_normal(h) * 0.02).to(bf)
    f_args = (x, w1t, b1, w2t, b2, g, b)
    out = bert_ffn_cuda.ffn_ln_block(*f_args, eps=eps)
    again = bert_ffn_cuda.ffn_ln_block(*f_args, eps=eps)
    torch.cuda.synchronize()
    extra = parent_and_splits("K3.bf16", f"B={B} L={L}",
                              lambda: bert_ffn_cuda.ffn_ln_block(*f_args, eps=eps))
    extra["cublas_products_ms"] = {   # cuBLAS, the two products alone: a yardstick
        "fc1": cuda_ms(lambda: torch.matmul(x, w1t), 5),
        "fc2": cuda_ms(lambda: torch.matmul(x.new_empty(B, L, ffn), w2t), 5)}
    print(f"  cuBLAS bf16, the two products alone: {extra['cublas_products_ms']}", flush=True)
    judge("K3.bf16", f"B={B} L={L} h={h} ffn={ffn}", (out,),
          (bert_ffn_cuda.ffn_ln_block_plain(*f_args, eps=eps),),
          (bert_ffn_cuda.ffn_ln_block(*(a.float() for a in f_args), eps=eps),), (again,),
          kernel_fn=lambda: bert_ffn_cuda.ffn_ln_block(*f_args, eps=eps),
          plain_fn=lambda: bert_ffn_cuda.ffn_ln_block_plain(*f_args, eps=eps),
          work=k3_bf16_work(B, L, h, ffn), iters=5, extra=extra)
    del out, again, x, a_args, f_args
    torch.cuda.empty_cache()
    check_k1f_k6a_edges_bf16(dev, np.random.default_rng(24), t, judge)
    return check_bf16_bert_variants(dev, rng, t, judge, aw, ab, g, b)


def check_bf16_bert_variants(dev, rng, t, judge, aw, ab, g, b, h=768, ffn=3072, heads=12,
                             eps=1e-12):
    """The bf16 instances of the frozen BERT's other paths, by ``judge``
    (check_bf16's: BF16_TOL of max |ref| vs the bf16 plain version, BF16_COS
    vs the float32 kernel, a rerun for the same bits, CUDA-event ms): K2 at
    the longest serving bucket (B=1 L=512, its tiled attention); K4 (int8
    weights quantized in float32, the scales rounded to bf16) at the
    training shape and B=1 L=8, its flipped hidden codes counted against the
    plain version's and held to K4_MAX_FLIP_SHARE, bound at the int8
    peak; K6a at B=4096 L=32 (unit path) and B=1 L=512 (tiled path) beside
    SDPA in bf16; K6b at B=4096 L=32 and B=1 L=8; the int8 GEMM's bf16
    dequant (qdot) at M=8 and M=131,072, the plain version's bits."""
    import torch.nn.functional as F

    from multimodal_transformer_robustness_tpu_torch import _build
    from multimodal_transformer_robustness_tpu_torch.models.bert import _quantize
    from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda, bert_ffn_cuda

    bf = torch.bfloat16
    kw = dict(n_heads=heads, eps=eps)
    x = t(rng.standard_normal((1, 512, h))).to(bf)
    mask = np.zeros((1, 512), np.float32)
    mask[0, :300] = 1.0                       # keys masked across the tiles
    mask = t(mask)
    a_args = (x, mask, aw[0], ab[0], aw[1], ab[1], aw[2], ab[2], aw[3], ab[3], g, b)
    again = bert_attn_cuda.attention_block_fused(*a_args, **kw)
    fn = lambda: bert_attn_cuda.attention_block_fused(*a_args, **kw)   # noqa: E731
    # the attention stage's device ms inside K2.bf16, beside SDPA in bf16 on
    # q / k / v of its shape and mask (12 heads of 64), and the parent's
    qs, ks, vs = (t(rng.standard_normal((1, heads, 512, h // heads))).to(bf) for _ in range(3))
    bias = ((1.0 - mask) * -10000.0)[:, None, None, :].to(bf)
    split = profile_ms(fn)
    with parent_plans():
        parent_split = profile_ms(fn)
    extra = {"parent_ms": parent_ms(fn, 20), "split_ms": split, "parent_split_ms": parent_split,
             "attention_ms": sum(v for k, v in split.items() if k.startswith("attention_bf16")),
             "attention_parent_ms": sum(v for k, v in parent_split.items()
                                        if k.startswith("attention_bf16")),
             "attention_sdpa_ms": sum(profile_ms(lambda: F.scaled_dot_product_attention(
                 qs, ks, vs, attn_mask=bias)).values())}
    print(f"  K2.bf16 B=1 L=512: attention stage {extra['attention_ms']:.4f} ms of device time "
          f"(parent {extra['attention_parent_ms']:.4f}), SDPA in bf16 on its shape "
          f"{extra['attention_sdpa_ms']:.4f} ms of device time; the whole block's parent "
          f"{extra['parent_ms']:.4f} ms", flush=True)
    judge("K2.bf16", f"B=1 L=512 h={h}", (bert_attn_cuda.attention_block_fused(*a_args, **kw),),
          (bert_attn_cuda.attention_block_plain(*a_args, **kw),),
          (bert_attn_cuda.attention_block_fused(*(a.float() for a in a_args), **kw),), (again,),
          kernel_fn=fn, plain_fn=lambda: bert_attn_cuda.attention_block_plain(*a_args, **kw),
          work=k2_bf16_work(1, 512, h), extra=extra)
    del qs, ks, vs

    def int8(w):
        q = _quantize(w)
        return {"q": q["q"], "s": q["s"].to(bf)}, {"q": q["q"], "s": q["s"].to(bf).float()}

    (w1q, w1f), (w2q, w2f) = (int8(t(rng.standard_normal(shape) * 0.02))
                              for shape in ((ffn, h), (h, ffn)))
    b1, b2 = t(rng.standard_normal(ffn) * 0.02).to(bf), t(rng.standard_normal(h) * 0.02).to(bf)
    wo_t, bo = t(rng.standard_normal((h, h)) * 0.02).to(bf), t(rng.standard_normal(h) * 0.02).to(bf)
    for B, L in ((4096, 32), (1, 8), (1, 512)):
        shape, iters = f"B={B} L={L} h={h}", 5 if B == 4096 else 20
        x = t(rng.standard_normal((B, L, h))).to(bf)
        if L != 512:
            k_args = (x, w1q, b1, w2q, b2, g, b)
            out, codes, _ = bert_ffn_cuda.ffn_ln_block_q(*k_args, eps=eps, return_codes=True)
            again = bert_ffn_cuda.ffn_ln_block_q(*k_args, eps=eps)
            torch.cuda.synchronize()
            ref, ref_codes, _ = bert_ffn_cuda.ffn_ln_block_q_plain(*k_args, eps=eps,
                                                                   return_codes=True)
            share = (codes != ref_codes).float().mean().item()
            print(f"  K4.bf16 {shape}: flipped hidden codes vs the plain version {share:.2e} "
                  f"(limit {K4_MAX_FLIP_SHARE:g})", flush=True)
            judge("K4.bf16", f"{shape} ffn={ffn}", (out,), (ref,),
                  (bert_ffn_cuda.ffn_ln_block_q(x.float(), w1f, b1.float(), w2f, b2.float(),
                                                g.float(), b.float(), eps=eps),), (again,),
                  kernel_fn=lambda: bert_ffn_cuda.ffn_ln_block_q(*k_args, eps=eps),
                  plain_fn=lambda: bert_ffn_cuda.ffn_ln_block_q_plain(*k_args, eps=eps),
                  work=k4_bf16_work(B * L, h, ffn), iters=iters, peak=PEAK_INT8_OPS,
                  extra={"flipped_share": share},
                  fail=share > K4_MAX_FLIP_SHARE)
            del out, again, ref, codes, ref_codes
            a = t(rng.standard_normal((B, L, h))).to(bf)
            p_args = (x, a, wo_t, bo, g, b)
            again = bert_ffn_cuda.proj_ln_block(*p_args, eps=eps)
            torch.cuda.synchronize()
            fn = lambda: bert_ffn_cuda.proj_ln_block(*p_args, eps=eps)   # noqa: E731
            extra = parent_and_splits("K6b.bf16", f"B={B} L={L}", fn) if B > 1 else {}
            # the training rows on the persistent kernel, the serving row off it
            wgmma = bert_ffn_cuda._plan_proj_ln_bf16(
                B * L, h, _build.num_sms(dev), a.data_ptr() % 16, wo_t.data_ptr() % 16,
                x.data_ptr() % 16)["wgmma"]
            judge("K6b.bf16", shape, (bert_ffn_cuda.proj_ln_block(*p_args, eps=eps),),
                  (bert_ffn_cuda.proj_ln_block_plain(*p_args, eps=eps),),
                  (bert_ffn_cuda.proj_ln_block(*(v.float() for v in p_args), eps=eps),),
                  (again,), kernel_fn=fn, fail=(wgmma == 2) != (B > 1),
                  plain_fn=lambda: bert_ffn_cuda.proj_ln_block_plain(*p_args, eps=eps),
                  work=k6b_bf16_work(B * L, h), iters=iters, extra=extra)
            del a, p_args, again
        if L != 8:
            q, k, v = (t(rng.standard_normal((B, L, heads, h // heads))).to(bf)
                       for _ in range(3))
            mask = np.zeros((B, L), np.float32)
            mask[0, : L // 2 + 44] = 1.0
            for i in range(1, B):
                mask[i, : rng.integers(1, L + 1)] = 1.0
            mask = t(mask)
            key_bias = ((1.0 - mask) * -10000.0)[:, None, None, :].to(bf)
            qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
            again = bert_attn_cuda.dense_attention_blockdiag(q, k, v, mask)
            fn = lambda q=q, k=k, v=v, mask=mask: (   # noqa: E731
                bert_attn_cuda.dense_attention_blockdiag(q, k, v, mask))
            extra, fail = {"parent_ms": parent_ms(fn, iters)} if L == 512 else {}, False
            if B == 4096:   # the unit walk, bit-identical to the parent's block-a-unit kernel
                extra = parent_and_splits("K6a.bf16", shape, fn)
                with walk_off():
                    same = torch.equal(again, fn())
                path = bert_attn_cuda._plan_attention_bf16(B, L, heads, h // heads,
                                                           _build.num_sms(dev))["path"]
                extra["bit_identical_to_parent"] = same
                print(f"  K6a.bf16 {shape}: plan path {path} (3: the unit walk), bit-identical "
                      f"to the block-a-unit kernel {same}", flush=True)
                fail = path != 3 or not same
            judge("K6a.bf16", shape, (bert_attn_cuda.dense_attention_blockdiag(q, k, v, mask),),
                  (bert_attn_cuda.dense_attention_plain(q, k, v, mask),),
                  (bert_attn_cuda.dense_attention_blockdiag(q.float(), k.float(), v.float(),
                                                            mask),), (again,),
                  kernel_fn=lambda: bert_attn_cuda.dense_attention_blockdiag(q, k, v, mask),
                  plain_fn=lambda: bert_attn_cuda.dense_attention_plain(q, k, v, mask),
                  library_fn=lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                    attn_mask=key_bias),
                  work=k6a_bf16_work(B, L, h), iters=iters, extra=extra, fail=fail)
            del q, k, v, qt, kt, vt, again
        del x
    rows = []
    wq = int8(t(rng.standard_normal((h, h)) * 0.02))[0]
    bias = t(rng.standard_normal(h) * 0.02).to(bf)
    for M in (8, 131072):
        row, ok = qdot_row(rng, t, wq, bias, M, h)
        rows.append(row)
        if not ok:
            raise RuntimeError(f"qdot {row['shape']} disagrees with its plain version")
    torch.cuda.empty_cache()
    return rows


def check_k1f_k6a_edges(dev, rng, t, record, failures):
    """K1f and K6a at the edges of their launch plans, both held to TOL and
    rerun for the same bits: K1f at B = 1, 31, 33, 4095 (small and tiled
    recurrence forms, a ragged last block), T = 1, in=7 H=12 (4-byte
    projection copies) and in=20 H=13 (4-byte gate copies, padded columns),
    both directions; K6a at L = 1, 31, 33, 64, 65,
    512 (unit and tiled paths) and head_dim 8 and 64, item 0 fully masked."""
    from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda, bigru_cuda

    for in_dim, H, T, B in ((768, 100, 50, 1), (768, 100, 50, 31), (768, 100, 50, 33),
                            (768, 100, 50, 4095), (768, 100, 1, 1), (768, 100, 1, 4096),
                            (7, 12, 5, 3), (7, 12, 9, 600), (20, 13, 6, 5),
                            (20, 13, 6, 700)):
        ops = bigru_cuda.dir_operands(gru_weights(rng, in_dim, H, dev))
        args = (ops["wp"], ops["wt"], ops["bc"], ops["bhn"])
        x = t(rng.standard_normal((T, B, in_dim)))
        for rev in (False, True):
            out = bigru_cuda.gru_dir(x, *args, rev)
            again = bigru_cuda.gru_dir(x, *args, rev)
            torch.cuda.synchronize()
            ref = bigru_cuda.gru_dir_plain(x, *args, rev)
            shape = f"edge in={in_dim} H={H} T={T} B={B} {'bwd' if rev else 'fwd'}"
            record("K1", shape, out, ref, None, None)
            if not torch.equal(out, again):
                failures.append(f"K1 {shape}: rerun differs")
    for L in (1, 31, 33, 64, 65, 512):
        for heads, dh in ((12, 64), (2, 8)):
            B = 3
            q, k, v = (t(rng.standard_normal((B, L, heads, dh))) for _ in range(3))
            mask = np.zeros((B, L), np.float32)
            for i in range(1, B):
                mask[i, : rng.integers(1, L + 1)] = 1.0
            mask = t(mask)
            out = bert_attn_cuda.dense_attention_blockdiag(q, k, v, mask)
            again = bert_attn_cuda.dense_attention_blockdiag(q, k, v, mask)
            torch.cuda.synchronize()
            ref = bert_attn_cuda.dense_attention_plain(q, k, v, mask)
            shape = f"edge B={B} L={L} heads={heads} dh={dh}"
            record("K6a", shape, out, ref, None, None)
            if not torch.equal(out, again):
                failures.append(f"K6a {shape}: rerun differs")


def check_k1f_k6a_edges_bf16(dev, rng, t, judge):
    """The bf16 twins of check_k1f_k6a_edges, by ``judge`` (BF16_TOL of max
    |ref| against the bf16 plain version, BF16_COS against the float32
    kernel on the same bf16 values, a rerun for the same bits): K1f.bf16 at
    B = 1, 31, 33 (the small recurrence form), 133, 600, 700, 4095 (the mma
    form: 16- and 32-row blocks, a ragged last row group), T = 1, in=7 H=12
    (4-byte projection copies) and in=20 H=13 (odd H: 4-byte gate copies,
    2-byte stores, padded tiles), both directions; K6a.bf16 at L = 1, 31,
    33, 64 (unit path), 65, 127, 128, 129, 300, 511, 512 (row path, one to
    four key groups) and 513 (three-pass tiled path), head_dim 64 and 8,
    item 0 fully masked."""
    from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda, bigru_cuda

    bf = torch.bfloat16
    for in_dim, H, T, B in ((768, 100, 50, 1), (768, 100, 50, 31), (768, 100, 50, 33),
                            (768, 100, 50, 133), (768, 100, 50, 4095), (768, 100, 1, 4096),
                            (7, 12, 5, 3), (7, 12, 9, 600), (20, 13, 6, 5), (20, 13, 6, 700)):
        w = {k: v.to(bf) for k, v in gru_weights(rng, in_dim, H, dev).items()}
        ops = bigru_cuda.dir_operands(w)
        args = tuple(ops[k] for k in ("wp", "wt", "bc", "bhn"))
        args32 = tuple(a.float() for a in args)
        x = t(rng.standard_normal((T, B, in_dim))).to(bf)
        for rev in (False, True):
            out = bigru_cuda.gru_dir(x, *args, rev)
            again = bigru_cuda.gru_dir(x, *args, rev)
            torch.cuda.synchronize()
            judge("K1f.bf16", f"edge in={in_dim} H={H} T={T} B={B} {'bwd' if rev else 'fwd'}",
                  (out,), (bigru_cuda.gru_dir_plain(x, *args, rev),),
                  (bigru_cuda.gru_dir(x.float(), *args32, rev),), (again,),
                  kernel_fn=None, plain_fn=None)
    for L in (1, 31, 33, 64, 65, 127, 128, 129, 300, 511, 512, 513):
        for heads, dh in ((12, 64), (2, 8)):
            B = 3
            q, k, v = (t(rng.standard_normal((B, L, heads, dh))).to(bf) for _ in range(3))
            mask = np.zeros((B, L), np.float32)
            for i in range(1, B):
                mask[i, : rng.integers(1, L + 1)] = 1.0
            mask = t(mask)
            out = bert_attn_cuda.dense_attention_blockdiag(q, k, v, mask)
            again = bert_attn_cuda.dense_attention_blockdiag(q, k, v, mask)
            torch.cuda.synchronize()
            judge("K6a.bf16", f"edge B={B} L={L} heads={heads} dh={dh}", (out,),
                  (bert_attn_cuda.dense_attention_plain(q, k, v, mask),),
                  (bert_attn_cuda.dense_attention_blockdiag(q.float(), k.float(), v.float(),
                                                            mask),), (again,),
                  kernel_fn=None, plain_fn=None)


def profile_ms(fn, iters: int = 10, warmup: int = 3) -> dict:
    """Device milliseconds per call of ``fn`` by kernel name, from
    ``torch.profiler`` over ``iters`` warm calls (empty if the profiler saw
    no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA and evt.self_device_time_total > 0:
            name = evt.key.replace("(anonymous namespace)::", "").removeprefix("void ")
            name = name.split("(")[0]
            per[name] = per.get(name, 0.0) + evt.self_device_time_total / iters / 1e3
    return per


def flash_bwd_cases(dev, rng, t, B=4096, heads=8, d=25, rate=0.1):
    """The flash backward's calls at the MOSEI stack shapes (cross Tq=50
    Tk=32 offset 19, self T=50 offset 1, dropout 0.1), each alone for the
    device split: the delta op, K5dq and K5dkv (the pair K5b replaces
    there), and K5b."""
    from multimodal_transformer_robustness_tpu_torch.ops import attention_cuda as ac

    cases = []
    for name, tq, tk in (("cross", 50, 32), ("self", 50, 50)):
        offset, bh = 1 + abs(tk - tq), B * heads
        q = t(rng.standard_normal((B, heads, tq, d)) / np.sqrt(d))
        k, v = (t(rng.standard_normal((B, heads, tk, d))) for _ in range(2))
        dout = t(rng.standard_normal((B, heads, tq, d)))
        seeds = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, bh).astype(np.int32)).to(dev)
        rates = torch.full((bh,), rate, device=dev)
        out, lse = ac.flash_fwd(q, k, v, seeds, rates, True, offset)
        delta = (dout * out).sum(-1).reshape(bh, tq)
        args = (q, k, v, dout, lse, delta, seeds, rates, True, offset)
        shape = f"{name} B={B} H={heads} Tq={tq} Tk={tk} D={d} rate={rate}"
        cases += [(f"delta op {shape}",
                   lambda dout=dout, out=out, bh=bh, tq=tq: (dout * out).sum(-1).reshape(bh, tq),
                   5),
                  (f"K5dq {shape}", lambda args=args: ac.flash_bwd_dq(*args), 5),
                  (f"K5dkv {shape}", lambda args=args: ac.flash_bwd_dkv(*args), 5),
                  (f"K5b {shape}", lambda args=args[:4] + (out,) + args[4:5] + args[6:]:
                   ac.flash_bwd(*args), 5)]
    return cases


def flash_kernel_cases(dev, rng, t, heads=8, d=25):
    """K5f, K5dkv and K5dq alone, for the device split: K5f's unit path at
    the MOSEI self (B=4096 T=50, offset 1) and cross (Tq=50 Tk=32, offset
    19) shapes at rate 0.1, its tiled path at B=16 T=2048 (causal, rate 0),
    and K5dkv and K5dq at B=16 T=2048 from the plain forward's out and
    lse."""
    from multimodal_transformer_robustness_tpu_torch.ops import attention_cuda as ac

    cases = []
    for name, B, tq, tk, rate in (("self", 4096, 50, 50, 0.1), ("cross", 4096, 50, 32, 0.1),
                                  ("long", 16, 2048, 2048, 0.0)):
        offset, bh = 1 + abs(tk - tq), B * heads
        q = t(rng.standard_normal((B, heads, tq, d)) / np.sqrt(d))
        k, v = (t(rng.standard_normal((B, heads, tk, d))) for _ in range(2))
        seeds = rates = None
        if rate:
            seeds = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, bh).astype(np.int32)).to(dev)
            rates = torch.full((bh,), rate, device=dev)
        path = "unit" if max(tq, tk) <= 64 else "tiled"
        shape = f"{name} B={B} H={heads} Tq={tq} Tk={tk} D={d} rate={rate}"
        fwd = (q, k, v, seeds, rates, True, offset)
        cases.append((f"K5f {path} {shape}", lambda fwd=fwd: ac.flash_fwd(*fwd), 5))
        if name == "long":
            dout = t(rng.standard_normal((B, heads, tq, d)))
            out, lse = ac.flash_attention_plain(q, k, v, True, offset)
            delta = (dout * out).sum(-1).reshape(bh, tq)
            args = (q, k, v, dout, lse.contiguous(), delta, None, None, True, offset)
            del out
            cases.append((f"K5dkv {shape}", lambda args=args: ac.flash_bwd_dkv(*args), 5))
            cases.append((f"K5dq {shape}", lambda args=args: ac.flash_bwd_dq(*args), 5))
    return cases


def k1b_split_cases(dev, rng, B=4096, T=50, H=100):
    """K1b at the training path's three shapes (in=768 and 512 without dx,
    in=200 with it), each alone, for the device split by kernel: the
    recurrence, the weight products, their sums (and dx).  Only the public
    ``gru_dir_bwd`` / ``_launch_fwd`` are used, so tools/k1b_split.py runs
    the same cases against another tree's package."""
    from multimodal_transformer_robustness_tpu_torch.ops import bigru_cuda

    cases = []
    for in_dim, need_dx in ((768, False), (512, False), (200, True)):
        ops = bigru_cuda.dir_operands(gru_weights(rng, in_dim, H, dev))
        args = (ops["wp"], ops["wt"], ops["bc"], ops["bhn"])
        x = torch.from_numpy(rng.standard_normal((T, B, in_dim)).astype(np.float32)).to(dev)
        dhs = torch.from_numpy(rng.standard_normal((T, B, H)).astype(np.float32)).to(dev)
        hs, gates = bigru_cuda._launch_fwd(x, *args, False)
        cases.append((f"K1b in={in_dim} H={H} T={T} B={B} fwd need_dx={need_dx}",
                      lambda x=x, args=args, hs=hs, gates=gates, dhs=dhs, d=need_dx:
                      bigru_cuda.gru_dir_bwd(x, *args, hs, gates, dhs, False, d), 5))
    return cases


def bert_split_cases(dev, rng, h=768, ffn=3072, heads=12):
    """K2, K4 and K6b at B=1 L=8, B=1 L=512 (the longest text bucket) and
    B=4096 L=32, BERT-base width, HF-scale weights (K2's q/k/v stacked as
    prepare_bert makes them), for the device split by kernel: K2's q/k/v
    product, attention, o-projection and LN, K4's quantize of x, GEMM1,
    quantize of g1, GEMM2 and LN, K6b's product and LN.  Only the public
    wrappers are called, so tools/tree_probe.py runs the same cases against
    another tree's package.  K6b's attention input comes from its own seed,
    so K2's and K4's inputs are the draws they were."""
    from multimodal_transformer_robustness_tpu_torch.models.bert import _quantize
    from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda, bert_ffn_cuda

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    wqkv, bqkv = t(rng.standard_normal((3, h, h)) * 0.02), t(rng.standard_normal(3 * h) * 0.02)
    wo, bo = t(rng.standard_normal((h, h)) * 0.02), t(rng.standard_normal(h) * 0.02)
    g, b = t(1.0 + 0.1 * rng.standard_normal(h)), t(0.1 * rng.standard_normal(h))
    w1q, w2q = (_quantize(t(rng.standard_normal(s) * 0.02)) for s in ((ffn, h), (h, ffn)))
    b1, b2 = t(rng.standard_normal(ffn) * 0.02), t(rng.standard_normal(h) * 0.02)
    cases = []
    for B, L in ((1, 8), (1, 512), (4096, 32)):
        x = t(rng.standard_normal((B, L, h)))
        mask = np.zeros((B, L), np.float32)
        for i in range(1, B):
            mask[i, : rng.integers(1, L + 1)] = 1.0
        a_args = (x, t(mask), wqkv[0], bqkv[:h], wqkv[1], bqkv[h:2 * h], wqkv[2],
                  bqkv[2 * h:], wo, bo, g, b)
        k_args = (x, w1q, b1, w2q, b2, g, b)
        p_args = (x, t(np.random.default_rng(L).standard_normal((B, L, h))), wo, bo, g, b)
        it = 5 if B > 1 else 20
        cases += [(f"K2 B={B} L={L} h={h}", lambda a_args=a_args: bert_attn_cuda
                   .attention_block_fused(*a_args, n_heads=heads, eps=1e-12), it),
                  (f"K4 B={B} L={L} h={h} ffn={ffn}", lambda k_args=k_args: bert_ffn_cuda
                   .ffn_ln_block_q(*k_args, eps=1e-12), it),
                  (f"K6b B={B} L={L} h={h}", lambda p_args=p_args: bert_ffn_cuda
                   .proj_ln_block(*p_args, eps=1e-12), it)]
    return cases


def bert_bf16_split_cases(dev, rng, h=768, ffn=3072, heads=12):
    """The bf16 instances of K2 (B=4096 L=32; B=1 L=512, its tiled
    attention), K4 and K6b (B=4096 L=32), for the device split by kernel
    (K4's quantize of x, GEMM1, quantize of g1, GEMM2 and LN; K2's and
    K6b's products, attention and LN)."""
    from multimodal_transformer_robustness_tpu_torch.models.bert import _quantize
    from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda, bert_ffn_cuda

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(
            dev, torch.bfloat16)

    wqkv, bqkv = t(rng.standard_normal((3, h, h)) * 0.02), t(rng.standard_normal(3 * h) * 0.02)
    wo, bo = t(rng.standard_normal((h, h)) * 0.02), t(rng.standard_normal(h) * 0.02)
    g, b = t(1.0 + 0.1 * rng.standard_normal(h)), t(0.1 * rng.standard_normal(h))
    w1q, w2q = ({"q": w["q"], "s": w["s"].to(torch.bfloat16)} for w in (
        _quantize(torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.02).to(dev))
        for s in ((ffn, h), (h, ffn))))
    b1, b2 = t(rng.standard_normal(ffn) * 0.02), t(rng.standard_normal(h) * 0.02)
    cases = []
    for B, L in ((4096, 32), (1, 512)):
        x = t(rng.standard_normal((B, L, h)))
        mask = np.zeros((B, L), np.float32)
        mask[0, : L // 2] = 1.0
        for i in range(1, B):
            mask[i, : rng.integers(1, L + 1)] = 1.0
        a_args = (x, torch.from_numpy(mask).to(dev), wqkv[0], bqkv[:h], wqkv[1],
                  bqkv[h:2 * h], wqkv[2], bqkv[2 * h:], wo, bo, g, b)
        it = 5 if B > 1 else 20
        cases.append((f"K2.bf16 B={B} L={L} h={h}", lambda a_args=a_args: bert_attn_cuda
                      .attention_block_fused(*a_args, n_heads=heads, eps=1e-12), it))
        if B > 1:
            k_args = (x, w1q, b1, w2q, b2, g, b)
            p_args = (x, t(rng.standard_normal((B, L, h))), wo, bo, g, b)
            cases += [(f"K4.bf16 B={B} L={L} h={h} ffn={ffn}", lambda: bert_ffn_cuda
                       .ffn_ln_block_q(*k_args, eps=1e-12), it),
                      (f"K6b.bf16 B={B} L={L} h={h}", lambda: bert_ffn_cuda
                       .proj_ln_block(*p_args, eps=1e-12), it)]
    return cases


def k9_split_cases(dev, rng):
    """K9f and K9b at the top FFN block (E=1000, F1=800, relu, channel
    mask) at R=4096 in train mode (d_mid 0.1, d_res 0.3) and R=1 in eval,
    and K9f at R=1 in eval at the other three MOSEI blocks, for the device
    split by kernel: K9f's LN rows and two products, K9b's rows, recompute,
    dp and ds products, LN backward, weight reductions and sums.  Only the
    public wrappers are called, so tools/tree_probe.py runs the same cases
    against another tree's package."""
    from multimodal_transformer_robustness_tpu_torch.ops import trunk_block_cuda as tb

    cases = []
    for name, E, F1, act, rep, _, masked in TRUNK_BLOCKS[::-1]:
        top_ffn = name == "top-ffn"
        for R, train in ((4096, True), (1, False)) if top_ffn else ((1, False),):
            x, _, dout, params, masks = trunk_block_operands(rng, R, E, F1, masked, dev)
            cfg = tb.BlockConfig(act, rep, 0.1, 0.3, 5, 6, train, train)
            shape = f"{name} E={E} F1={F1} R={R} {'train' if train else 'eval'}"
            it = 5 if R > 1 else 20
            fargs, bargs = (x, x, *params, *masks, cfg), (x, x, dout, *params, *masks, cfg)
            cases.append((f"K9f {shape}", lambda a=fargs: tb.trunk_block_fwd(*a), it))
            if top_ffn:
                cases.append((f"K9b {shape}", lambda a=bargs: tb.trunk_block_bwd(*a), it))
    return cases


def device_split(dev, rng):
    """K1f's device time split between its kernels (input projection,
    recurrence), K1b's (recurrence, products, sums: k1b_split_cases), K3's
    (fc1, fc2, LayerNorm), K2's, K4's and K6b's (bert_split_cases, also at
    B=1 L=512), K9f's and K9b's (k9_split_cases) and, for K1f, K3, K6a, K8,
    K7f, K7b, K2, K4 and K6b at their timed shapes, K1b at its three path
    shapes, the flash backward's calls (flash_bwd_cases), K5f's two paths,
    K5dkv and K5dq (flash_kernel_cases), K9 at the top FFN block and the bf16
    BERT kernels (bert_bf16_split_cases), the device
    time of a call (torch.profiler) beside its CUDA-event time: the gap is
    host time the card waits for.
    Returns one dict per shape."""
    from multimodal_transformer_robustness_tpu_torch.ops import attention_cuda as ac
    from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda, bigru_cuda
    from multimodal_transformer_robustness_tpu_torch.ops import bert_ffn_cuda, gru_cuda

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    out = []
    H, in_dim = 100, 768
    ops = bigru_cuda.dir_operands(gru_weights(rng, in_dim, H, dev))
    args = (ops["wp"], ops["wt"], ops["bc"], ops["bhn"])
    cases = []
    for T, B in ((64, 1), (50, 4096)):
        x = t(rng.standard_normal((T, B, in_dim)))
        cases.append((f"K1f in={in_dim} H={H} T={T} B={B} fwd",
                      lambda x=x: bigru_cuda.gru_dir(x, *args, False), 5 if B > 1 else 20))
    cases += k1b_split_cases(dev, rng)
    h, ffn = 768, 3072
    w1t, w2t = t(rng.standard_normal((h, ffn)) * 0.02), t(rng.standard_normal((ffn, h)) * 0.02)
    b1, b2 = t(rng.standard_normal(ffn) * 0.02), t(rng.standard_normal(h) * 0.02)
    g, b = t(1.0 + 0.1 * rng.standard_normal(h)), t(0.1 * rng.standard_normal(h))
    for B, L in ((1, 8), (4096, 32)):
        f_args = (t(rng.standard_normal((B, L, h))), w1t, b1, w2t, b2, g, b)
        cases.append((f"K3 B={B} L={L} h={h} ffn={ffn}",
                      lambda f_args=f_args: bert_ffn_cuda.ffn_ln_block(*f_args, eps=1e-12),
                      5 if B > 1 else 20))
    heads, dh = 12, 64
    for B, L in ((1, 8), (4096, 32)):
        q, k, v = (t(rng.standard_normal((B, L, heads, dh))) for _ in range(3))
        mask = np.zeros((B, L), np.float32)
        for i in range(1, B):
            mask[i, : rng.integers(1, L + 1)] = 1.0
        mask = t(mask)
        cases.append((f"K6a B={B} L={L} h={heads * dh}",
                      lambda q=q, k=k, v=v, m=mask: bert_attn_cuda.dense_attention_blockdiag(
                          q, k, v, m), 5 if B > 1 else 20))
        hf = [a.transpose(1, 2).contiguous() for a in (q, k, v)]
        km = ragged_key_mask(rng, B, L, dev)
        cases.append((f"K8 B={B} L={L} H={heads} D={dh}",
                      lambda hf=hf, km=km: ac.flash_attention_masked(*hf, km),
                      5 if B > 1 else 20))
    for G, T, N in ((2, 50, 4096), (2, 64, 1)):
        rec = ([t(rng.standard_normal((G, T, N, H))) for _ in range(3)]
               + [t(rng.uniform(-0.1, 0.1, (G, H, H))) for _ in range(3)]
               + [t(rng.uniform(-0.1, 0.1, (G, H))) for _ in range(3)])
        cases.append((f"K7f G={G} T={T} N={N} H={H}",
                      lambda rec=rec: gru_cuda.gru_recurrence_cuda(*rec), 5 if N > 1 else 20))
        bwd = (*rec[:3], gru_cuda.gru_recurrence_cuda(*rec), t(rng.standard_normal((G, T, N, H))),
               *rec[3:])
        cases.append((f"K7b G={G} T={T} N={N} H={H}",
                      lambda bwd=bwd: gru_cuda.gru_recurrence_bwd_cuda(*bwd), 5 if N > 1 else 20))
    cases += flash_bwd_cases(dev, rng, t)
    cases += flash_kernel_cases(dev, rng, t)
    cases += bert_split_cases(dev, rng)
    cases += k9_split_cases(dev, rng)
    cases += bert_bf16_split_cases(dev, rng)
    for name, fn, iters in cases:
        per = profile_ms(fn, iters)
        event = cuda_ms(fn, iters)
        device = sum(per.values())
        out.append({"shape": name, "event_ms": event, "device_ms": device, "kernels_ms": per})
        split = ", ".join(f"{k} {v:.4f}" for k, v in per.items()) or "no device time seen"
        print(f"split {name}: CUDA-event {event:.4f} ms, device {device:.4f} ms "
              f"(host gap {event - device:.4f}): {split}", flush=True)
    return out


def k4_row_bound(x, codes, scales, w2, b2, ln_g, flips_per_row):
    """Per row, the most K4's output may differ from its plain version's:
    TOL["K4"] plus, for each flipped hidden code, twice the largest move of
    one code (its step sg * max|w2| in y, through the LayerNorm: * max|ln_g|
    / the row's std)."""
    from multimodal_transformer_robustness_tpu_torch.ops import bert_ffn_cuda

    rows = x.reshape(-1, x.shape[-1])
    s = rows + bert_ffn_cuda.qdot_plain(codes, scales, w2, b2)
    w2max = (w2["q"].float() * w2["s"][:, None]).abs().max()
    step = scales[:, 0] * w2max * ln_g.abs().max() / s.std(dim=-1, unbiased=False)
    return TOL["K4"] + 2.0 * flips_per_row * step


def check_bert_variants(dev, rng, t, record, failures,
                        shapes=((1, 8), (1, 32), (1, 128), (1, 512), (4096, 32)),
                        qdot_rows=(8, 131072)):
    """K4, K6a and K6b against their plain versions at the serving rows
    (B=1, L in {8, 32, 128, 512}) and the training shape (B=4096, L=32), at
    BERT-base width; K4's int32 products and row quantization exact, its
    flipped hidden codes counted.  Then the int8 GEMM (qdot) exact at M=8
    and M=131,072."""
    import torch.nn.functional as F

    from multimodal_transformer_robustness_tpu_torch.models.bert import _quantize
    from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda, bert_ffn_cuda

    rows = []
    h, ffn, heads, eps = 768, 3072, 12, 1e-12
    w1q = _quantize(t(rng.standard_normal((ffn, h)) * 0.02))
    w2q = _quantize(t(rng.standard_normal((h, ffn)) * 0.02))
    b1, b2 = t(rng.standard_normal(ffn) * 0.02), t(rng.standard_normal(h) * 0.02)
    wo_t, bo = t(rng.standard_normal((h, h)) * 0.02), t(rng.standard_normal(h) * 0.02)
    g, b = t(1.0 + 0.1 * rng.standard_normal(h)), t(0.1 * rng.standard_normal(h))
    for B, L in shapes:
        R = B * L
        x = t(rng.standard_normal((B, L, h)))
        timed = (B, L) in ((1, 8), (4096, 32))
        iters = 5 if B == 4096 else 20
        shape = f"B={B} L={L} h={h}"

        # K4: int32 products exact, row quantization bit-identical, flipped codes
        k_args = (x, w1q, b1, w2q, b2, g, b)
        out, codes, scales = bert_ffn_cuda.ffn_ln_block_q(*k_args, eps=eps, return_codes=True)
        torch.cuda.synchronize()
        ref, ref_codes, ref_scales = bert_ffn_cuda.ffn_ln_block_q_plain(*k_args, eps=eps,
                                                                        return_codes=True)
        xq, sx = bert_ffn_cuda.qrows(x)
        pxq, psx = bert_ffn_cuda.qrows_plain(x)
        exact = (torch.equal(xq, pxq) and torch.equal(sx, psx)
                 and torch.equal(bert_ffn_cuda.int8_matmul(xq, w1q["q"]),
                                 bert_ffn_cuda.int8_matmul_plain(pxq, w1q["q"]).to(torch.int32))
                 and torch.equal(bert_ffn_cuda.int8_matmul(ref_codes, w2q["q"]),
                                 bert_ffn_cuda.int8_matmul_plain(ref_codes, w2q["q"])
                                 .to(torch.int32)))
        flipped = codes != ref_codes
        share = flipped.float().mean().item()
        limit = k4_row_bound(x, ref_codes, ref_scales, w2q, b2, g, flipped.sum(-1))
        row_err = (out - ref).reshape(R, h).abs().amax(-1)
        within = bool((row_err <= limit).all()) and bool(torch.isfinite(out).all())
        abs_err, rel_err = errors(out, ref)
        ok = exact and share <= K4_MAX_FLIP_SHARE and within
        row = dict(kid="K4", shape=f"{shape} ffn={ffn}", abs=abs_err, rel=rel_err,
                   int32_exact=exact, flipped_share=share, bound_abs=limit.max().item())
        msg = (f"K4 {row['shape']}: int32 products and row codes exact {exact}; flipped "
               f"hidden codes {int(flipped.sum())} of {flipped.numel()} (share {share:.2e}, "
               f"limit {K4_MAX_FLIP_SHARE:g}); max_abs {abs_err:.3e} (limit per row "
               f"<= {row['bound_abs']:.3e}) {'ok' if ok else 'FAIL'}")
        if timed:
            row.update(ms=cuda_ms(lambda: bert_ffn_cuda.ffn_ln_block_q(*k_args, eps=eps), iters),
                       plain_ms=cuda_ms(lambda: bert_ffn_cuda.ffn_ln_block_q_plain(
                           *k_args, eps=eps), iters), library_ms=None)
            row["bound_ms"], row["bound_by"] = bound(*k4_work(R, h, ffn), peak=PEAK_INT8_OPS)
            msg += (f"  kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  "
                    f"library none  bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        print(msg, flush=True)
        rows.append(row)
        if not ok:
            failures.append(f"K4 {row['shape']}")
        del out, ref, codes, ref_codes, xq, pxq

        # K6a: projected q/k/v; B=1 all keys masked (the serving path's
        # mask/type-id swap), B>1 ragged with item 0 fully masked
        q, k, v = (t(rng.standard_normal((B, L, heads, h // heads))) for _ in range(3))
        mask = np.zeros((B, L), np.float32)
        for i in range(1, B):
            mask[i, : rng.integers(1, L + 1)] = 1.0
        mask = t(mask)
        key_bias = ((1.0 - mask) * -10000.0)[:, None, None, :]
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=key_bias)

        out = bert_attn_cuda.dense_attention_blockdiag(q, k, v, mask)
        torch.cuda.synchronize()
        ref = bert_attn_cuda.dense_attention_plain(q, k, v, mask)
        lib_err = (library().transpose(1, 2).reshape(B, L, h) - ref).abs().max().item()
        print(f"  scaled_dot_product_attention vs plain at {shape}: max_abs {lib_err:.3e}",
              flush=True)
        record("K6a", shape, out, ref,
               lambda: bert_attn_cuda.dense_attention_blockdiag(q, k, v, mask),
               lambda: bert_attn_cuda.dense_attention_plain(q, k, v, mask),
               work=k6a_work(B, L, h) if timed else None, library_fn=library, iters=iters)
        del out, ref, q, k, v, qt, kt, vt

        # K6b: o-proj + residual + LN1, timed at every shape: its plan
        # (K2's o-projection's) splits over K at B=1 (8 planes up to L=128,
        # 2 at L=512) and takes the wgmma tiles at B=4096
        a = t(rng.standard_normal((B, L, h)))
        p_args = (x, a, wo_t, bo, g, b)
        out = bert_ffn_cuda.proj_ln_block(*p_args, eps=eps)
        torch.cuda.synchronize()
        ref = bert_ffn_cuda.proj_ln_block_plain(*p_args, eps=eps)
        record("K6b", shape, out, ref, lambda: bert_ffn_cuda.proj_ln_block(*p_args, eps=eps),
               lambda: bert_ffn_cuda.proj_ln_block_plain(*p_args, eps=eps),
               work=k6b_work(R, h), iters=iters)
        del out, ref, a, x

    # the int8 GEMM of the fully quantized BERT's projections: exact int32
    # products, and the dequant + bias epilogue as the plain version's
    wq = _quantize(t(rng.standard_normal((h, h)) * 0.02))
    bias = t(rng.standard_normal(h) * 0.02)
    for M in qdot_rows:
        row, ok = qdot_row(rng, t, wq, bias, M, h)
        rows.append(row)
        if not ok:
            failures.append(f"qdot {row['shape']}")
    return rows


def qdot_row(rng, t, wq, bias, M, h):
    """The int8 GEMM of the fully quantized BERT's projections at M rows of
    ``bias``'s dtype (bf16: its bf16 instance, the dequant rounded to bf16):
    exact int32 products, and the dequant + bias epilogue the plain
    version's bits (the same operations in the same order); CUDA-event ms
    beside the bound.  Returns (row, ok)."""
    from multimodal_transformer_robustness_tpu_torch.ops import bert_ffn_cuda

    bf16 = bias.dtype == torch.bfloat16
    xq, sx = bert_ffn_cuda.qrows(t(rng.standard_normal((M, h))).to(bias.dtype))
    acc = bert_ffn_cuda.int8_matmul(xq, wq["q"])
    out = bert_ffn_cuda.qdot(xq, sx, wq, bias)
    torch.cuda.synchronize()
    exact = torch.equal(acc, bert_ffn_cuda.int8_matmul_plain(xq, wq["q"]).to(torch.int32))
    err = (out.float() - bert_ffn_cuda.qdot_plain(xq, sx, wq, bias).float()).abs().max().item()
    row = dict(kid="qdot", shape=f"M={M} K={h} N={h}{' bf16' if bf16 else ''}", abs=err, rel=0.0,
               int32_exact=exact)
    it = 5 if M > 8 else 20
    row.update(ms=cuda_ms(lambda: bert_ffn_cuda.qdot(xq, sx, wq, bias), it),
               plain_ms=cuda_ms(lambda: bert_ffn_cuda.qdot_plain(xq, sx, wq, bias), it),
               library_ms=None)
    nb = 2 if bf16 else 4   # bytes of an output, scale or bias element
    row["bound_ms"], row["bound_by"] = bound(2 * M * h * h,
                                             M * h + h * h + 4 * M + nb * (2 * h + M * h),
                                             peak=PEAK_INT8_OPS)
    ok = exact and err == 0.0 and out.dtype == bias.dtype
    print(f"qdot {row['shape']}: int32 products exact {exact}; max_abs vs plain {err:.3e} "
          f"(limit 0: the same operations in the same order) {'ok' if ok else 'FAIL'}  "
          f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
    return row, ok


def flash_work(kind, bh, tq, tk, d, offset, dropout, width=4):
    """(FLOPs, bytes) of K5f ("fwd"), K5dq ("dq"), K5dkv ("dkv") or K5b
    ("bwd", the whole backward in one pass) over ``bh`` slices: 4, 6, 8 or
    10 FLOPs a score pair and head column, counting only the pairs the
    causal rule leaves visible; q, k, v (and dout, lse, delta for K5dq /
    K5dkv, dout, out and lse for K5b) read once, the outputs written once,
    8 bytes of seed and rate a slice with dropout.  ``width``: the bytes of
    an element of q, k, v, dout, out and the gradients (2 for the bf16
    instances); lse and delta are float32 at either width.  At width 2 the
    FLOPs come as ((count, rate), ...): S = Q K^T and dP = dO V^T (2 FLOPs
    each) have two bf16 operands, exact on the bf16 tensor cores
    (PEAK_BF16_FLOPS); P V, dS K, P^T dO and dS^T Q have a float32 operand
    (PEAK_BF16_F32_FLOPS)."""
    pairs = sum(min(tk, r + offset) for r in range(tq))
    ins = width * bh * d * (tq + 2 * tk) + (8 * bh if dropout else 0)
    per_pair, two_bf16 = {"fwd": (4, 2), "dq": (6, 4), "dkv": (8, 4), "bwd": (10, 4)}[kind]
    unit = bh * pairs * d
    flops = (per_pair * unit if width == 4 else
             ((two_bf16 * unit, PEAK_BF16_FLOPS), ((per_pair - two_bf16) * unit, PEAK_BF16_F32_FLOPS)))
    if kind == "fwd":
        return flops, ins + width * bh * tq * d + 4 * bh * tq
    if kind == "bwd":
        return flops, ins + width * bh * tq * 2 * d + 4 * bh * tq + width * bh * d * (tq + 2 * tk)
    ins += width * bh * tq * d + 8 * bh * tq
    if kind == "dq":
        return flops, ins + width * bh * tq * d
    return flops, ins + 2 * width * bh * tk * d


def k8_work(key_mask, heads, L, d, width=4):
    """K8: 4 FLOPs per attended (query, key) pair and head column, the
    pairs this run's masks leave; q, k, v, the output (``width`` bytes an
    element: 2 at bf16) and the int32 mask.  At bf16 the FLOPs come as
    ((count, rate), ...): Q K^T (two bf16 operands) at PEAK_BF16_FLOPS, P V
    (p float32) at PEAK_BF16_F32_FLOPS."""
    b = key_mask.shape[0]
    half = 2 * heads * L * d * key_mask.sum().item()
    nbytes = width * 4 * b * heads * L * d + 4 * b * L
    if width == 4:
        return 2 * half, nbytes
    return ((half, PEAK_BF16_FLOPS), (half, PEAK_BF16_F32_FLOPS)), nbytes


def ragged_key_mask(rng, B, L, dev):
    """int32 ``[B, L]`` key mask: row 0 all masked, every other row keeps a
    random prefix of one to L keys."""
    mask = np.ones((B, L), np.int32)
    for i in range(1, B):
        mask[i, rng.integers(1, L + 1):] = 0
    mask[0] = 0
    return torch.from_numpy(mask).to(dev)


def check_flash(dev, rng, t, record, failures, dtype=torch.float32,
                k5_shapes=(("self", 4096, 50, 50), ("cross", 4096, 50, 32), ("long", 16, 2048, 2048)),
                k8_shapes=((1, 8), (1, 512), (4096, 32)), odd=()):
    """K5f, K5dq and K5dkv at the MOSEI stack widths (8 heads of 25): self
    at B=4096 T=50 (offset 1), cross at B=4096 Tq=50 Tk=32 (offset 19, text
    keys under audio queries), long at B=16 T=2048 (causal); each without
    dropout and at rate 0.1, the kernel and the plain version given the same
    seeds.  The backward reads the kernel forward's out and lse (delta
    summed in float32 from that out) and is held against
    ``flash_attention_bwd_plain``; at self and cross also K5b, the fused
    backward that FlashAttention.backward runs at T <= 64, timed beside the
    pair it replaces (K5dq + K5dkv + the delta op) and SDPA's backward.
    Every kernel is rerun for identical bits.  K8 at the BERT's shapes (12
    heads of 64): B=1 at L=8 and 512, all keys masked (the serving path's
    mask swap, rewritten to all ones), and B=4096 at L=32 with ragged masks
    and one all-zero row.  Yardstick: scaled_dot_product_attention with the
    same boolean mask and scale 1, forward, and its autograd backward for
    dq + dk + dv together, the backend it picked named.

    ``dtype=torch.bfloat16``: the bf16 instances (rows ``<kid>.bf16``, held
    to FLASH_BF16_TOL of max |ref|) on bf16 operands, each output also held
    against the float32 kernel on the same bf16-valued operands (cosine
    FLASH_BF16_COS) and lse within FLASH_BF16_LSE_TOL of max |ref| of the
    plain version's and the float32 kernel's; ``odd`` shapes (B, Tq, Tk)
    untimed (bf16 rows of D = 25 on 2-byte boundaries)."""
    import torch.nn.functional as F

    from multimodal_transformer_robustness_tpu_torch.ops import attention_cuda as ac
    from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda

    bf16 = dtype == torch.bfloat16
    width, sfx = (2, ".bf16") if bf16 else (4, "")

    def hold(kid, shape, outs, refs, again, timing, f32s=None, extra=None):
        """Record ``outs`` against ``refs``, check the rerun's bits and, at
        bf16, the cosine against the float32 kernel's ``f32s``."""
        same = all(torch.equal(a, b) for a, b in zip(outs, again))
        extra = {"rerun_bit_identical": same, **(extra or {})}
        cos = 1.0
        if bf16:
            cos = min(cosine(o.float(), f.float()) for o, f in zip(outs, f32s))
            extra.update(cos_vs_float32=cos, share_differing=max(
                float((o != r).float().mean()) for o, r in zip(outs, refs)))
        record(kid + sfx, shape, tuple(o.float() for o in outs), tuple(r.float() for r in refs),
               timing.get("kernel_fn"), timing.get("plain_fn"), work=timing.get("work"),
               library_fn=timing.get("library_fn"), iters=5, extra=extra)
        print(f"  {kid}{sfx} {shape}: rerun bit-identical {same}" + (
            f", cosine vs the float32 kernel {cos:.7f} (min {FLASH_BF16_COS}), "
            f"{extra['share_differing']:.2%} of elements differ from the plain version"
            if bf16 else ""), flush=True)
        if not same or cos < FLASH_BF16_COS:
            failures.append(f"{kid}{sfx} {shape}: rerun bit-identical {same}, cosine {cos}")

    heads, d = 8, 25
    shapes = ([(name, B, tq, tk, True) for name, B, tq, tk in k5_shapes]
              + [("odd", B, tq, tk, False) for B, tq, tk in odd])
    for name, B, tq, tk, timed in shapes:
        offset = 1 + abs(tk - tq)
        bh = B * heads
        q = t(rng.standard_normal((B, heads, tq, d)) / np.sqrt(d)).to(dtype)   # pre-scaled
        k, v = (t(rng.standard_normal((B, heads, tk, d))).to(dtype) for _ in range(2))
        dout = t(rng.standard_normal((B, heads, tq, d))).to(dtype)
        q32, k32, v32, dout32 = (a.float() for a in (q, k, v, dout))
        visible = (torch.arange(tk, device=dev)[None, :]
                   - torch.arange(tq, device=dev)[:, None]) < offset
        for rate in (0.0, 0.1):
            shape = f"{name} B={B} H={heads} Tq={tq} Tk={tk} D={d} offset={offset} rate={rate}"
            seeds = rates = None
            if rate:
                seeds = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, bh).astype(np.int32)).to(dev)
                rates = torch.full((bh,), rate, device=dev)
            fwd_args = (q, k, v, seeds, rates, True, offset)
            plain_args = (q, k, v, True, offset, seeds, rates)
            out, lse = ac.flash_fwd(*fwd_args)
            torch.cuda.synchronize()
            again = ac.flash_fwd(*fwd_args)
            ref, ref_lse = ac.flash_attention_plain(*plain_args)
            backend = sdpa_backend(q, k, v, visible, rate) if timed else None
            timing = dict(
                kernel_fn=lambda: ac.flash_fwd(*fwd_args),
                plain_fn=lambda: ac.flash_attention_plain(*plain_args),
                work=flash_work("fwd", bh, tq, tk, d, offset, bool(rate), width),
                library_fn=lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=visible, dropout_p=rate, scale=1.0)) if timed else {}
            if bf16:
                f32, f32_lse = ac.flash_fwd(q32, k32, v32, seeds, rates, True, offset)
                lse_err = max(errors(lse, r)[1] for r in (ref_lse, f32_lse))
                hold("K5f", shape, (out,), (ref,), again[:1], timing, (f32,),
                     extra={"lse_err_over_max_ref": lse_err, "sdpa_backend": backend})
                print(f"  K5f.bf16 {shape}: lse {lse_err:.3e} of max|ref| from the plain "
                      f"version's and the float32 kernel's (tol {FLASH_BF16_LSE_TOL:g}); "
                      f"lse rerun bit-identical {torch.equal(lse, again[1])}", flush=True)
                if not lse_err <= FLASH_BF16_LSE_TOL or not torch.equal(lse, again[1]):
                    failures.append(f"K5f.bf16 {shape}: lse {lse_err}")
                del f32, f32_lse
            else:
                hold("K5f", shape, (torch.cat([out.flatten(), lse.flatten()]),),
                     (torch.cat([ref.flatten(), ref_lse.flatten()]),),
                     (torch.cat([a.flatten() for a in again]),), timing,
                     extra={"sdpa_backend": backend})
            del again, ref, ref_lse

            delta = ac._delta(dout, out)
            bwd_args = (q, k, v, dout, lse, delta, seeds, rates, True, offset)
            bwd32 = (q32, k32, v32, dout32) + bwd_args[4:]
            dq = ac.flash_bwd_dq(*bwd_args)
            dk, dv = ac.flash_bwd_dkv(*bwd_args)
            torch.cuda.synchronize()
            rdq, rdk, rdv = ac.flash_attention_bwd_plain(q, k, v, dout, *plain_args[3:])

            def sdpa_bwd(rate=rate, dout=dout, visible=visible):
                leaves = [a.detach().requires_grad_(True) for a in (q, k, v)]
                y = F.scaled_dot_product_attention(*leaves, attn_mask=visible, dropout_p=rate,
                                                   scale=1.0)
                return lambda: torch.autograd.grad(y, leaves, dout, retain_graph=True)

            library = sdpa_bwd() if timed else None
            def plain_bwd(args=(q, k, v, dout) + plain_args[3:]):
                return ac.flash_attention_bwd_plain(*args)

            def bwd_timing(kind, kernel_fn):
                return dict(kernel_fn=kernel_fn, plain_fn=plain_bwd, library_fn=library,
                            work=flash_work(kind, bh, tq, tk, d, offset, bool(rate), width)
                            ) if timed else {}

            f32s = (ac.flash_bwd_dq(*bwd32),) + ac.flash_bwd_dkv(*bwd32) if bf16 else (None,) * 3
            named = {"sdpa_backend": backend}
            hold("K5dq", shape, (dq,), (rdq,), (ac.flash_bwd_dq(*bwd_args),),
                 bwd_timing("dq", lambda: ac.flash_bwd_dq(*bwd_args)), f32s[:1], named)
            hold("K5dkv", shape, (dk, dv), (rdk, rdv), ac.flash_bwd_dkv(*bwd_args),
                 bwd_timing("dkv", lambda: ac.flash_bwd_dkv(*bwd_args)), f32s[1:], named)
            if max(tq, tk) <= 64:
                # K5b: what FlashAttention.backward runs here, delta inside,
                # beside the pair it replaces (with the delta op)
                fused_args = (q, k, v, dout, out, lse, seeds, rates, True, offset)
                got = ac.flash_bwd(*fused_args)
                f32s = (ac.flash_bwd(q32, k32, v32, dout32, out.float(), *fused_args[5:])
                        if bf16 else None)

                def pair(args=bwd_args, out=out):
                    a = args[:5] + (ac._delta(dout, out),) + args[6:]
                    return ac.flash_bwd_dq(*a), ac.flash_bwd_dkv(*a)

                pair_ms = cuda_ms(pair, 5) if timed else None
                hold("K5b", shape, got, (rdq, rdk, rdv), ac.flash_bwd(*fused_args),
                     bwd_timing("bwd", lambda: ac.flash_bwd(*fused_args)), f32s,
                     {**named, "pair_with_delta_ms": pair_ms})
                if timed:
                    print(f"  K5b{sfx} {shape}: the pair it replaces, K5dq + K5dkv + the delta "
                          f"op, {pair_ms:.4f} ms", flush=True)
                del got
            del out, lse, delta, dq, dk, dv, rdq, rdk, rdv, f32s, library
        del q, k, v, dout, q32, k32, v32, dout32
        torch.cuda.empty_cache()

    heads, d = 12, 64
    for B, L in k8_shapes:
        q = t(rng.standard_normal((B, heads, L, d)) / np.sqrt(d)).to(dtype)
        k, v = (t(rng.standard_normal((B, heads, L, d))).to(dtype) for _ in range(2))
        mask = ragged_key_mask(rng, B, L, dev)
        eff = ac._effective_key_mask(mask)
        out = ac.flash_attention_masked(q, k, v, mask)
        torch.cuda.synchronize()
        ref = ac.flash_attention_masked_plain(q, k, v, mask)
        shape = f"B={B} L={L} H={heads} D={d}"
        timing = dict(kernel_fn=lambda: ac.flash_attention_masked(q, k, v, mask),
                      plain_fn=lambda: ac.flash_attention_masked_plain(q, k, v, mask),
                      work=k8_work(eff, heads, L, d, width),
                      library_fn=lambda: F.scaled_dot_product_attention(
                          q, k, v, attn_mask=eff[:, None, None, :] > 0, scale=1.0))
        if bf16:
            f32 = ac.flash_attention_masked(q.float(), k.float(), v.float(), mask)
            walk = bert_attn_cuda._plan_attention_masked_bf16(B, L, L, heads, d, True) is not None
            extra = {"unit_walk": walk}
            if B == 4096:   # the parent's plan: the float32 HARD kernels on bf16 rows
                extra["parent_ms"] = parent_ms(timing["kernel_fn"], 5)
                print(f"  K8.bf16 {shape}: unit walk {walk}, parent "
                      f"{extra['parent_ms']:.4f} ms", flush=True)
                if not walk:
                    failures.append(f"K8.bf16 {shape}: not on the unit walk")
            hold("K8", shape, (out,), (ref,), (ac.flash_attention_masked(q, k, v, mask),),
                 timing, (f32,), extra)
            del f32
        else:
            record("K8", shape, out, ref, timing["kernel_fn"], timing["plain_fn"],
                   work=timing["work"], library_fn=timing["library_fn"],
                   iters=5 if B == 4096 else 20)
        del q, k, v, out, ref


def sdpa_backend(q, k, v, mask, rate) -> str:
    """The backend scaled_dot_product_attention picks for these operands
    (its own dispatcher's choice), by name."""
    from torch.nn.attention import SDPBackend

    try:
        return SDPBackend(torch._fused_sdp_choice(q, k, v, mask, rate, False,
                                                  scale=1.0)).name
    except (AttributeError, RuntimeError, TypeError, ValueError) as e:
        return f"unknown ({type(e).__name__})"


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


def k7_work(kind, G, T, N, H, width=4):
    """(FLOPs, bytes) of K7f ("fwd") or K7b ("bwd"): the recurrent products,
    three [N, H] x [H, H] a step and group forward, twice that backward (the
    recompute and the dh carry); the gates (and hs, dhs backward) read once,
    the outputs written once, the weights and biases once, ``width`` bytes
    an element.  At bf16 (width 2) the products take a float32 operand (h,
    da), so they count at PEAK_BF16_F32_FLOPS, as ((count, rate),)."""
    per = G * T * N * H
    params = 3 * G * H * H + 3 * G * H
    flops, elems = ((2 * per * 3 * H, 3 * per + params + per) if kind == "fwd" else
                    (4 * per * 3 * H, 5 * per + params + 4 * per))
    return (flops if width == 4 else ((flops, PEAK_BF16_F32_FLOPS),)), width * elems


def k9_work(kind, R, E, F1, width=4):
    """(FLOPs, bytes) of K9f ("fwd") or K9b ("bwd"): 4*R*E*F1 for the two
    products forward, 10*R*E*F1 backward (the recompute of s W1^T, dz W2,
    dp W1, dW1 and dW2); x and src (src and dout backward) read once, the
    output (dsrc and the parameter gradients) written once, the weights,
    vectors and masks once.  The hash is integer work and is not counted.
    ``width``: the bytes of an element of x, src, dout, out and dsrc (2 at
    bf16, whose products all take two bf16 operands: PEAK_BF16_FLOPS; the
    float32 parameters and their gradients stay 4 bytes)."""
    vec = 4 * E + 2 * F1 + 2 * E * F1
    if kind == "fwd":
        return 4 * R * E * F1, width * 3 * R * E + 4 * vec
    return 10 * R * E * F1, width * 3 * R * E + 4 * (vec + 2 * E * F1 + F1 + 3 * E)


def cudnn_bigru(params, in_dim, H, dev):
    """Bidirectional ``nn.GRU`` (cuDNN) holding ``params``' two directions."""
    gru = torch.nn.GRU(in_dim, H, bidirectional=True).to(dev)
    with torch.no_grad():
        for sfx, d in (("", "fwd"), ("_reverse", "bwd")):
            for n, p in (("weight_ih_l0", "w_ih"), ("weight_hh_l0", "w_hh"),
                         ("bias_ih_l0", "b_ih"), ("bias_hh_l0", "b_hh")):
                getattr(gru, n + sfx).copy_(params[d][p])
    gru.flatten_parameters()
    return gru


def bf16_judge(kid, shape, outs, f32s, again, failures):
    """The bf16 rows' own checks beside the tolerance: each output's cosine
    against the float32 kernel on the same bf16-valued operands (BF16_COS)
    and a bit-identical rerun -> the row's extra fields."""
    cos = min(cosine(o.float(), f.float()) for o, f in zip(outs, f32s))
    same = all(torch.equal(a, b) for a, b in zip(outs, again))
    print(f"  {kid} {shape}: cosine vs the float32 kernel {cos:.7f} (min {BF16_COS}), rerun "
          f"bit-identical {same}", flush=True)
    if cos < BF16_COS or not same:
        failures.append(f"{kid} {shape}: cosine {cos} / rerun {same}")
    return {"cos_vs_float32": cos, "rerun_bit_identical": same}


def check_k7(dev, rng, t, record, failures, dtype=torch.float32,
             shapes=((2, 50, 4096, 100), (2, 64, 1, 100))):
    """K7f and K7b against their plain versions at the MOSEI header level
    (G=2 directions, T=50, N=4096, H=100) and at the serving shape (T=64,
    N=1); K7b run twice for identical bits.  Yardstick: cuDNN's
    bidirectional GRU at in=200 over the same T and N (it also projects
    the inputs), forward, and its autograd backward.  ``dtype=bfloat16``:
    the bf16 instances (rows ``K7f.bf16`` / ``K7b.bf16``) on bf16 operands,
    each output also held against the float32 kernel (bf16_judge), K7f
    rerun too, cuDNN's GRU in bf16."""
    from multimodal_transformer_robustness_tpu_torch.ops import gru_cuda

    bf16 = dtype == torch.bfloat16
    width, sfx = (2, ".bf16") if bf16 else (4, "")
    in_dim = 200
    for G, T, N, H in shapes:
        k = 1.0 / np.sqrt(H)
        gates = [t(rng.standard_normal((G, T, N, H))).to(dtype) for _ in range(3)]
        weights = [t(rng.uniform(-k, k, (G, H, H))).to(dtype) for _ in range(3)]
        biases = [t(rng.uniform(-k, k, (G, H))).to(dtype) for _ in range(3)]
        dhs = t(rng.standard_normal((G, T, N, H))).to(dtype)
        args = (*gates, *weights, *biases)
        shape = f"G={G} T={T} N={N} H={H}"
        iters = 5 if N > 1 else 20
        gru = cudnn_bigru({d: gru_weights(rng, in_dim, H, dev) for d in ("fwd", "bwd")},
                          in_dim, H, dev).to(dtype)
        gru.flatten_parameters()
        x = t(rng.standard_normal((T, N, in_dim))).to(dtype).requires_grad_(True)
        y, _ = gru(x)
        dy = t(rng.standard_normal((T, N, 2 * H))).to(dtype)

        def library_fwd():
            with torch.no_grad():
                return gru(x)

        hs = gru_cuda.gru_recurrence_cuda(*args)
        torch.cuda.synchronize()
        extra = (bf16_judge("K7f.bf16", shape, (hs,), (gru_cuda.gru_recurrence_cuda(
            *(a.float() for a in args)),), (gru_cuda.gru_recurrence_cuda(*args),), failures)
                 if bf16 else None)
        record("K7f" + sfx, shape, hs.float(), gru_cuda.gru_recurrence_plain(*args).float(),
               lambda: gru_cuda.gru_recurrence_cuda(*args),
               lambda: gru_cuda.gru_recurrence_plain(*args),
               work=k7_work("fwd", G, T, N, H, width), library_fn=library_fwd, iters=iters,
               extra=extra)
        bwd_args = (*gates, hs, dhs, *weights, *biases)
        got = gru_cuda.gru_recurrence_bwd_cuda(*bwd_args)
        torch.cuda.synchronize()
        again = gru_cuda.gru_recurrence_bwd_cuda(*bwd_args)
        if bf16:
            extra = bf16_judge("K7b.bf16", shape, got, gru_cuda.gru_recurrence_bwd_cuda(
                *(a.float() for a in bwd_args)), again, failures)
        else:
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            print(f"  K7b {shape}: rerun bit-identical {same}", flush=True)
            if not same:
                failures.append(f"K7b {shape} not deterministic")
        record("K7b" + sfx, shape, tuple(a.float() for a in got),
               tuple(a.float() for a in gru_cuda.gru_recurrence_bwd_plain(*bwd_args)),
               lambda: gru_cuda.gru_recurrence_bwd_cuda(*bwd_args),
               lambda: gru_cuda.gru_recurrence_bwd_plain(*bwd_args),
               work=k7_work("bwd", G, T, N, H, width),
               library_fn=lambda: torch.autograd.grad(y, [x, *gru.parameters()], dy,
                                                      retain_graph=True), iters=iters,
               extra=extra)
        del gates, dhs, hs, got, again, x, y, dy, gru
        torch.cuda.empty_cache()


# the MOSEI model's four T==1 residual blocks: (name, E, F1, act, mid_rep,
# cross, channel-masked); attention: 8 heads of 25 (F1 = 200, d_mid per
# head), FFN: 4 * 200 = 800 wide; stream stacks at d=200, top stacks at
# spec.top_dim = 1000 with a channel mask
TRUNK_BLOCKS = (("stream-attn", 200, 200, "id", 25, True, False),
                ("stream-ffn", 200, 800, "relu", 1, False, False),
                ("top-attn", 1000, 200, "id", 25, False, True),
                ("top-ffn", 1000, 800, "relu", 1, False, True))


def trunk_block_operands(rng, R, E, F1, masked, dev):
    """x, src, dout [R, E], the six parameters at the encoder's init scale,
    and masks: a channel mask keeping 4 of 5 slabs of 200 where ``masked``
    (m_in = m_out), a d_mid mask keeping 7 of 8 heads for attention widths."""
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    bound = np.sqrt(6.0 / (E + F1))
    x, src, dout = (t(rng.standard_normal((R, E))) for _ in range(3))
    params = [t(rng.uniform(-bound, bound, (F1, E))), t(0.02 * rng.standard_normal(F1)),
              t(rng.uniform(-bound, bound, (E, F1))), t(0.02 * rng.standard_normal(E)),
              t(1 + 0.1 * rng.standard_normal(E)), t(0.1 * rng.standard_normal(E))]
    cm = t(np.arange(E) < (E * 4) // 5) if masked else t(np.ones(E))
    mm = t(np.arange(F1) < 175) if F1 == 200 else t(np.ones(F1))
    return x, src, dout, params, [cm, mm, cm]


def check_k9(dev, rng, t, record, failures, dtype=torch.float32):
    """K9f and K9b against their plain versions at the four MOSEI T==1
    blocks: R=4096 in train mode (d_mid 0.1, d_res 0.3, the same seeds on
    both sides) with the backward, run twice for identical bits; K9f again
    at R=1 in eval (no dropout), the serving rows.  No PyTorch call
    computes the block, so no library time.  ``dtype=bfloat16``: the bf16
    instances (rows ``K9f.bf16`` / ``K9b.bf16``) at bf16 x, src and dout
    with float32 parameters (the masters a bf16 step keeps), each output
    also held against the float32 kernel (bf16_judge) on the operands the
    bf16 instance multiplies: x, src, dout and the weights (which it casts)
    at their bf16 values, the vectors float32 as it keeps them; K9b also at
    R=1, beyond the same relu-kink allowance as the float32 rows
    (relu_kink_bound from the bf16 operands).  (Given the unrounded
    weights, a relu block's gradients part further from the float32
    kernel's: entries of u near the kink change sides.)"""
    from multimodal_transformer_robustness_tpu_torch.ops import trunk_block_cuda as tb

    bf16 = dtype == torch.bfloat16
    width, sfx = (2, ".bf16") if bf16 else (4, "")
    for name, E, F1, act, rep, cross, masked in TRUNK_BLOCKS:
        for R, train in ((4096, True), (1, False)):
            x, src, dout, params, masks = trunk_block_operands(rng, R, E, F1, masked, dev)
            x, src, dout = (a.to(dtype) for a in (x, src, dout))
            if not cross:
                src = x
            cfg = tb.BlockConfig(act, rep, 0.1, 0.3, int(rng.integers(-2**31, 2**31 - 1)),
                                 int(rng.integers(-2**31, 2**31 - 1)), train, train)
            shape = f"{name} E={E} F1={F1} R={R} {'train' if train else 'eval'}"
            fargs = (x, src, *params, *masks, cfg)
            out = tb.trunk_block_fwd(*fargs)
            torch.cuda.synchronize()
            iters = 5 if R > 1 else 20
            extra = None
            # the float32 kernel's operands: the bf16 instance's, upcast
            p32 = [p.to(dtype).float() if p.dim() == 2 else p for p in params]
            if bf16:
                f32 = (x.float(), src.float(), *p32, *masks, cfg)
                extra = bf16_judge("K9f.bf16", shape, (out,), (tb.trunk_block_fwd(*f32),),
                                   (tb.trunk_block_fwd(*fargs),), failures)
            record("K9f" + sfx, shape, out.float(),
                   tb.fused_residual_block_reference(*fargs).float(),
                   lambda: tb.trunk_block_fwd(*fargs),
                   lambda: tb.fused_residual_block_reference(*fargs),
                   work=k9_work("fwd", R, E, F1, width), iters=iters, extra=extra)
            if not train and not bf16:
                continue
            bargs = (x, src, dout, *params, *masks, cfg)
            got = tb.trunk_block_bwd(*bargs)
            torch.cuda.synchronize()
            again = tb.trunk_block_bwd(*bargs)
            if bf16:
                extra = bf16_judge("K9b.bf16", shape, got, tb.trunk_block_bwd(
                    x.float(), src.float(), dout.float(), *p32, *masks, cfg), again, failures)
            else:
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                print(f"  K9b {shape}: rerun bit-identical {same}", flush=True)
                if not same:
                    failures.append(f"K9b {shape} not deterministic")
            near, slack = tb.relu_kink_bound(*bargs)
            if act == "relu":
                print(f"  K9b{sfx} {shape}: {near} entries of u within 1e-4 of relu's kink",
                      flush=True)
            record("K9b" + sfx, shape, tuple(a.float() for a in got),
                   tuple(a.float() for a in tb.trunk_block_bwd_plain(*bargs)),
                   lambda: tb.trunk_block_bwd(*bargs), lambda: tb.trunk_block_bwd_plain(*bargs),
                   work=k9_work("bwd", R, E, F1, width), iters=iters, slack=slack, extra=extra)
            del x, src, dout, params, masks, out, got, again


class Bf16Count:
    """A wrapper's bf16 launches (its ``launches_bf16``, a part of its
    ``launches``) as a counter of their own."""

    def __init__(self, fn):
        self.fn = fn

    @property
    def launches(self):
        return self.fn.launches_bf16

    @launches.setter
    def launches(self, value):
        self.fn.launches_bf16 = value


def counters():
    """The launch counters: every kernel's, then the bf16 instances' of K1f,
    K1b, K2, K3, K4, K6a, K6b, the int8 projections, the flash kernels, K8,
    K7 and K9 (``K1.bf16`` ... ``K9b.bf16``), which count within K1 ...
    K9b: a phase where they equal K1 ... K9b launched no float32 instance."""
    from multimodal_transformer_robustness_tpu_torch.ops import attention_cuda as ac
    from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda, bert_ffn_cuda
    from multimodal_transformer_robustness_tpu_torch.ops import bigru_cuda, gru_cuda
    from multimodal_transformer_robustness_tpu_torch.ops import trunk_block_cuda as tb

    return {"K1": bigru_cuda.gru_dir, "K1b": bigru_cuda.gru_dir_bwd,
            "K2": bert_attn_cuda.attention_block_fused, "K3": bert_ffn_cuda.ffn_ln_block,
            "K4": bert_ffn_cuda.ffn_ln_block_q,
            "K6a": bert_attn_cuda.dense_attention_blockdiag,
            "K6b": bert_ffn_cuda.proj_ln_block,
            "qrows": bert_ffn_cuda.qrows, "qdot": bert_ffn_cuda.qdot,
            "K5f": ac.flash_fwd, "K5dq": ac.flash_bwd_dq, "K5dkv": ac.flash_bwd_dkv,
            "K5b": ac.flash_bwd,
            "K8": ac.flash_attention_masked, "K7f": gru_cuda.gru_recurrence_cuda,
            "K7b": gru_cuda.gru_recurrence_bwd_cuda, "K9f": tb.trunk_block_fwd,
            "K9b": tb.trunk_block_bwd, "K1.bf16": Bf16Count(bigru_cuda.gru_dir),
            "K1b.bf16": Bf16Count(bigru_cuda.gru_dir_bwd),
            "K2.bf16": Bf16Count(bert_attn_cuda.attention_block_fused),
            "K3.bf16": Bf16Count(bert_ffn_cuda.ffn_ln_block),
            "K4.bf16": Bf16Count(bert_ffn_cuda.ffn_ln_block_q),
            "K6a.bf16": Bf16Count(bert_attn_cuda.dense_attention_blockdiag),
            "K6b.bf16": Bf16Count(bert_ffn_cuda.proj_ln_block),
            "qrows.bf16": Bf16Count(bert_ffn_cuda.qrows),
            "qdot.bf16": Bf16Count(bert_ffn_cuda.qdot),
            "K5f.bf16": Bf16Count(ac.flash_fwd), "K5b.bf16": Bf16Count(ac.flash_bwd),
            "K5dq.bf16": Bf16Count(ac.flash_bwd_dq),
            "K5dkv.bf16": Bf16Count(ac.flash_bwd_dkv),
            "K8.bf16": Bf16Count(ac.flash_attention_masked),
            "K7f.bf16": Bf16Count(gru_cuda.gru_recurrence_cuda),
            "K7b.bf16": Bf16Count(gru_cuda.gru_recurrence_bwd_cuda),
            "K9f.bf16": Bf16Count(tb.trunk_block_fwd), "K9b.bf16": Bf16Count(tb.trunk_block_bwd)}


def expect(**counts):
    """Expected launch counts: the given ones, 0 for every other kernel."""
    return {k: counts.get(k, 0) for k in counters()}


def expect_bf16(**counts):
    """Expected launch counts of a bf16 path: the given kernels' launches,
    every one of them their bf16 instance's."""
    return expect(**counts, **{f"{k}.bf16": v for k, v in counts.items()})


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

    plain = {"attention_block_fused": bert_attn_cuda.attention_block_plain,
             "ffn_ln_block": bert_ffn_cuda.ffn_ln_block_plain,
             "ffn_ln_block_q": bert_ffn_cuda.ffn_ln_block_q_plain,
             "dense_attention_blockdiag": bert_attn_cuda.dense_attention_plain,
             "proj_ln_block": bert_ffn_cuda.proj_ln_block_plain,
             "qrows": bert_ffn_cuda.qrows_plain, "qdot": bert_ffn_cuda.qdot_plain}
    saved = {name: getattr(bert_mod, name) for name in plain}
    saved_fwd = bigru_cuda._launch_fwd
    bigru_cuda._launch_fwd = lambda x, wp, wt, bc, bhn, rev: (
        bigru_cuda.gru_dir_plain(x, wp, wt, bc, bhn, rev), None)
    for name, fn in plain.items():
        setattr(bert_mod, name, fn)
    try:
        yield
    finally:
        bigru_cuda._launch_fwd = saved_fwd
        for name, fn in saved.items():
            setattr(bert_mod, name, fn)


@contextmanager
def attn_impl(value: str):
    """Run the frozen BERT under ``models.bert.ATTN_IMPL = value``."""
    from multimodal_transformer_robustness_tpu_torch.models import bert as bert_mod

    saved, bert_mod.ATTN_IMPL = bert_mod.ATTN_IMPL, value
    try:
        yield
    finally:
        bert_mod.ATTN_IMPL = saved


def synthetic_requests(pred, n=4):
    """The first ``n`` of four synthetic clips whose (words, audio steps,
    face steps) cross the text / audio / vision buckets, prepared."""
    rng = np.random.default_rng(1)
    clips = [(4, 40, 24), (30, 70, 9), (100, 20, 50), (300, 64, 33)]
    requests = []
    for words, ta, tv in clips:
        transcript = [f"w{int(i)}" for i in rng.integers(0, 5000, words)]
        requests.append(pred.prepare(transcript,
                                     rng.standard_normal((1, ta, 768)).astype(np.float32),
                                     rng.standard_normal((1, tv, 512)).astype(np.float32)))
    return requests[:n]


def serve(dev, label="serving", per_request=None, **options):
    """StreamingPredictor(**options) at the MOSEI serving configuration:
    ``per_request`` launches each (default: K1 12, K2 4, K3 4), card vs the
    CPU plain path (float32: SERVE_TOL, int8 in two parts; under a bf16
    ``spec``: BF16_PRED_TOL of the predictions' scale), warm ms through the
    kernels and through the plain versions on the card."""
    from multimodal_transformer_robustness_tpu_torch.cli.realtime import StreamingPredictor

    t0 = time.perf_counter()
    pred = StreamingPredictor(seed=0, device=dev, **options)
    print(f"{label}: predictor on {dev} built in {time.perf_counter() - t0:.1f} s "
          f"(spec d={pred.spec.dimension} heads={pred.spec.num_heads}x{pred.spec.head_dim} "
          f"layers={pred.spec.layers_single_attn}/{pred.spec.layers_cross_attn}/"
          f"{pred.spec.layers_self_attn}, BERT h={pred.bert_cfg.hidden_size} "
          f"layers={pred.bert_cfg.num_layers})", flush=True)
    requests = synthetic_requests(pred)

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
    expected = {k: v * n for k, v in (per_request or expect(K1=12, K2=4, K3=4)).items()}
    print(f"{label} launches {launches} expected {expected}", flush=True)
    if launches != expected:
        raise RuntimeError(f"launch counts {launches} != {expected}")
    if not all(np.isfinite(card)):
        raise RuntimeError(f"non-finite sentiment {card}")

    warm_ms = [1000 * _timed(lambda r=r: pred.forward(*r)) for r in requests]
    with plain_kernels():
        plain_ms = [1000 * _timed(lambda r=r: pred.forward(*r)) for r in requests]
    for (text, audio, vision), k_ms, p_ms in zip(requests, warm_ms, plain_ms):
        print(f"{label} warm request L={text.shape[2]} Ta={audio.shape[1]} Tv={vision.shape[1]}: "
              f"kernels {k_ms:.2f} ms, plain PyTorch on the card {p_ms:.2f} ms", flush=True)

    cpu = StreamingPredictor(seed=0, device="cpu", **options)
    cpu_out = [cpu.forward(*r) for r in requests]
    diff = max(abs(a - b) for a, b in zip(card, cpu_out))
    if pred.spec.compute_dtype == "bfloat16":
        # bf16 flips from float32 sums in another order compound through the
        # BERT and the GRU: held to BF16_PRED_TOL of the predictions' scale
        tol = BF16_PRED_TOL * max(abs(b) for b in cpu_out)
        print(f"{label} card vs CPU plain path: sentiment {card} vs {cpu_out}, max abs diff "
              f"{diff:.3e} (tol {tol:.3e}, {BF16_PRED_TOL:g} of max |CPU|)", flush=True)
        if not diff <= tol:
            raise RuntimeError(f"{label}: card and CPU disagree: {card} vs {cpu_out}")
        return pred, cpu, launches, warm_ms, plain_ms
    print(f"{label} card vs CPU plain path: max abs diff {diff:.3e} (tol {SERVE_TOL:g}"
          f"{'; int8: checked in two parts below' if options.get('bert_int8') else ''})",
          flush=True)
    if options.get("bert_int8"):
        int8_serving_check(label, pred, cpu, requests, card)
    elif not diff <= SERVE_TOL:
        raise RuntimeError(f"card and CPU disagree: {card} vs {cpu_out}")
    return pred, cpu, launches, warm_ms, plain_ms


def int8_agree(out, ref, ref_float):
    """(ok, relative error, the quantization's own relative error) of a
    frozen BERT's int8 output on the card (``out``) against the CPU's
    (``ref``), ``ref_float`` the CPU's output with the float weights.

    The two sides' float32 activations differ in their last bits before each
    row quantization (other summation orders), so now and then a code lands
    one step apart.  One flipped activation code moves ~F/30 hidden codes of
    its row across their rounding edges, and where the attention spreads a
    row over the others (the serving path's mask/type-id swap puts the same
    bias on every key), the next layer's codes flip in every row: the two
    sides part like two draws of the quantization noise.  A kernel that
    quantizes or accumulates wrongly is caught at the kernel phase, whose
    codes and int32 products are exact; here the card's int8 output must
    stay within the quantization's own error: ||out - ref|| <= ||ref -
    ref_float||, relative to ||ref||."""
    err = ((out - ref).norm() / ref.norm()).item()
    qerr = ((ref - ref_float).norm() / ref_float.norm()).item()
    return bool(torch.isfinite(out).all()) and err <= qerr, err, qerr


def int8_serving_check(label, pred, cpu, requests, card):
    """int8 serving, card vs CPU in two parts: the frozen BERT's features by
    :func:`int8_agree` (against the same predictor's float weights); and the
    rest of the model (GRU headers, trunk) from the card's features on both
    sides, held to SERVE_TOL like the float path."""
    from multimodal_transformer_robustness_tpu_torch.cli.realtime import StreamingPredictor
    from multimodal_transformer_robustness_tpu_torch.models import supernet_apply
    from multimodal_transformer_robustness_tpu_torch.models.headers import bert_text_features

    cpu_float = StreamingPredictor(seed=0, device="cpu")
    for (text, audio, vision), s_card in zip(requests, card):
        with torch.inference_mode():
            f_card = bert_text_features(pred.frozen, pred.bert_cfg,
                                        torch.as_tensor(text, device=pred.device)).cpu()
            f_cpu = bert_text_features(cpu.frozen, cpu.bert_cfg, torch.as_tensor(text))
            f_float = bert_text_features(cpu_float.frozen, cpu.bert_cfg, torch.as_tensor(text))
            rest = float(supernet_apply(cpu.spec, cpu.params, cpu.masks,
                                        [f_card, torch.as_tensor(audio), torch.as_tensor(vision)],
                                        frozen=cpu.frozen, bert_cfg=cpu.bert_cfg)[0, 0])
        ok, err, qerr = int8_agree(f_card, f_cpu, f_float)
        rest_diff = abs(s_card - rest)
        print(f"{label} L={text.shape[2]}: BERT features card vs CPU relative error {err:.3e} "
              f"(max abs {(f_card - f_cpu).abs().max():.3e}; limit: the int8 weights' own "
              f"error vs float, {qerr:.3e}); the rest of the model from the card's features, "
              f"CPU vs card: {rest_diff:.3e} (tol {SERVE_TOL:g})", flush=True)
        if not (ok and rest_diff <= SERVE_TOL):
            raise RuntimeError(f"{label}: card and CPU disagree at L={text.shape[2]}")


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


def train(dev, spec, bert_cfg, label="train", per_step=None, bert_int8=False,
          cached=False, store_dtype=None, B=4096, T=50, L=32, warmup=2, steps=5):
    """Trainer.train_epoch at the training shapes: the frozen BERT in float
    (default), int8 (``bert_int8``: fc1 / fc2 through K4, quantized from the
    float32 weights by ``init_supernet(bert_int8="ffn")``) or run once ahead
    on the batch (``cached``: train/features.py, the step gets features, in
    ``spec.compute_dtype``); ``store_dtype``: the batch stored on the card
    by ``DeviceBatchIterator(store_dtype=...)`` (bench.py's bf16 feed).
    Returns the launch counts and the step numbers."""
    from multimodal_transformer_robustness_tpu_torch import build_masks, full_active_config
    from multimodal_transformer_robustness_tpu_torch.data.loaders import Batch
    from multimodal_transformer_robustness_tpu_torch.models import init_supernet
    from multimodal_transformer_robustness_tpu_torch.train import TrainHParams, Trainer
    from multimodal_transformer_robustness_tpu_torch.train.features import (
        precompute_text_features)

    # int8: fc1 / fc2 quantized from the float32 weights, then cast to the
    # compute dtype (the JAX package's order)
    params, frozen = init_supernet(torch.Generator().manual_seed(0), spec, bert_cfg,
                                   bert_int8="ffn" if bert_int8 else None)
    hp = TrainHParams(batch_size=B, lr=1e-4, optim="Adam", criterion="L1Loss",
                      experiment_type="random_sample", modality_pool=POOL)
    trainer = Trainer(spec, params, frozen, hp, bert_cfg=bert_cfg, device=dev)
    del params, frozen
    batch = synthetic_batch(np.random.default_rng(0), B, T, L, bert_cfg.vocab_size,
                            spec.orig_dimensions[1:])
    stats = {}
    if cached:
        # once per dataset: here the whole B=4096 batch, in chunks of 512
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = precompute_text_features(trainer.frozen, bert_cfg, batch.inputs[0],
                                         batch_size=512, compute_dtype=spec.compute_dtype,
                                         device=dev)
        stats["precompute_s"] = time.perf_counter() - t0
        print(f"{label}: precompute_text_features over {B} rows (L={L}) in "
              f"{stats['precompute_s']:.3f} s, features {feats.shape} float32 "
              f"({feats.nbytes / 2**20:.1f} MiB); it runs once per dataset", flush=True)
        batch = Batch(inputs=[feats] + batch.inputs[1:], labels=batch.labels,
                      valid=batch.valid)
    # the host feed: the batch's pageable upload, as train_epoch makes it
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    uploaded = [torch.as_tensor(x, device=trainer.device) for x in batch.inputs]
    torch.cuda.synchronize()
    stats["upload_ms"] = 1e3 * (time.perf_counter() - t0)
    stats["upload_mib"] = sum(x.nbytes for x in batch.inputs) / 2**20
    del uploaded
    if store_dtype:
        from multimodal_transformer_robustness_tpu_torch.data import DeviceBatchIterator

        batch = next(iter(DeviceBatchIterator(split_of(batch), B, store_dtype=store_dtype,
                                              device=trainer.device)))
        print(f"{label}: the batch stored on the card by DeviceBatchIterator(store_dtype="
              f"{store_dtype!r}): {[str(x.dtype) for x in batch.inputs]}, "
              f"{sum(x.nbytes for x in batch.inputs) / 2**20:.0f} MiB", flush=True)
    masks = build_masks(spec, full_active_config(spec), device=trainer.device)

    t0 = time.perf_counter()
    _, masks = trainer.train_epoch([batch] * warmup, masks, epoch=0)
    print(f"{label} warm-up: {warmup} steps in {time.perf_counter() - t0:.2f} s, losses "
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
    print(f"{label} B={B} T={T} L={L}: {steps} steps in {elapsed:.3f} s: step {step_ms:.1f} ms, "
          f"{steps * B / elapsed:.1f} samples/s (host clock around train_epoch); "
          f"losses {losses.tolist()}, epoch loss {loss:.6f}; peak allocated "
          f"{peak / 2**30:.2f} GiB; batch upload {stats['upload_ms']:.1f} ms for "
          f"{stats['upload_mib']:.0f} MiB", flush=True)
    got = {k: v / steps for k, v in launches.items()}
    expected = per_step or expect(K1=12, K1b=12, K2=4, K3=4)
    print(f"{label} launches per step {got} (K1b without dx {no_dx / steps}) "
          f"expected {expected} (K1b without dx 6)", flush=True)
    if got != expected or no_dx != 6 * steps:
        raise RuntimeError(f"{label} launch counts {launches} (no dx {no_dx}) over "
                           f"{steps} steps")
    if not np.isfinite(losses).all() or len(losses) != steps:
        raise RuntimeError(f"non-finite training losses {losses}")
    breakdown = train_breakdown(trainer, batch, masks, label)
    return launches, dict(step_ms=step_ms, samples_per_s=steps * B / elapsed,
                          peak_gib=peak / 2**30, losses=losses.tolist(), **stats,
                          **breakdown)


def train_breakdown(trainer, batch, masks, label="train", repeats=3):
    """Where one step's time goes, by CUDA events over separate runs of its
    parts: the frozen BERT (K2 + K3 or K4; none on features), the headers
    forward and backward (K1 + K1b, BERT excluded), the optimizer (the
    global-norm clip + Adam) and the rest (the trunk forward and backward, the loss)."""
    from multimodal_transformer_robustness_tpu_torch.models import supernet_headers
    from multimodal_transformer_robustness_tpu_torch.models.headers import bert_text_features
    from multimodal_transformer_robustness_tpu_torch.train.loop import tree_leaves
    from multimodal_transformer_robustness_tpu_torch.train.optim import clip_by_global_norm_

    dev = trainer.device
    inputs = [torch.as_tensor(x, device=dev) for x in batch.inputs]
    labels = torch.as_tensor(batch.labels, device=dev)
    valid = torch.as_tensor(batch.valid, device=dev)
    spec, params = trainer.spec, trainer.params
    online = not torch.is_floating_point(inputs[0])

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
        clip_by_global_norm_([p.grad for p in tree_leaves(params) if p.grad is not None],
                             trainer.hp.clip)
        trainer.opt_state.step()

    parts = [("step", step), ("headers_incl_bert", headers), ("optimizer", optimizer)]
    ms = {name: cuda_ms(fn, repeats, 1) for name, fn in
          parts + ([("bert", bert)] if online else [])}
    ms.setdefault("bert", 0.0)
    out = {"step_cuda_ms": ms["step"], "bert_ms": ms["bert"],
           "headers_fwd_bwd_ms": ms["headers_incl_bert"] - ms["bert"],
           "optimizer_ms": ms["optimizer"]}
    out["trunk_and_loss_ms"] = (ms["step"] - ms["headers_incl_bert"] - ms["optimizer"])
    print(f"{label} step breakdown (CUDA events, ms): " + json.dumps(out), flush=True)
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


def train_bf16_card_vs_cpu(dev, spec, bert_cfg, B=8, T=50, L=32):
    """The bf16 policy on the card against the CPU's plain versions, from
    the same parameters, masks and batch, every dropout rate 0 (the
    reference's 0.1 for the later cross stacks patched to 0): one step's
    loss (BF16_LOSS_TOL) and its float32 gradients as one vector (cosine
    BF16_COS); one ``Trainer.evaluate`` over two batches of B / 2 rows,
    the predictions within BF16_PRED_TOL of their scale."""
    from multimodal_transformer_robustness_tpu_torch import (ModelSpec, build_masks,
                                                             full_active_config)
    from multimodal_transformer_robustness_tpu_torch.data import BatchIterator
    from multimodal_transformer_robustness_tpu_torch.models import init_supernet
    from multimodal_transformer_robustness_tpu_torch.train import (
        TrainHParams, Trainer, sample_train_config)
    from multimodal_transformer_robustness_tpu_torch.train.loop import tree_leaves
    from multimodal_transformer_robustness_tpu_torch.weights import export_reference_state_dict

    spec = dataclasses.replace(spec, attn_dropout=(0.0,) * 4, relu_dropout=0.0,
                               res_dropout=0.0, out_dropout=0.0, embed_dropout=0.0)
    cfg = sample_train_config(spec, "random_sample", POOL, np.random.default_rng(3))
    batch = synthetic_batch(np.random.default_rng(4), B, T, L, bert_cfg.vocab_size,
                            spec.orig_dimensions[1:])
    batch.valid[-1] = 0.0                     # a padded tail row
    hp = TrainHParams(batch_size=B, lr=1e-4, optim="Adam", criterion="L1Loss",
                      dataset="mosei_senti")
    out = {}
    reset_counters()
    with mock.patch.object(ModelSpec, "attn_dropout_for_cross", lambda self, idx: 0.0):
        for key, d in (("card", dev), ("cpu", "cpu")):
            params, frozen = init_supernet(torch.Generator().manual_seed(0), spec, bert_cfg)
            tr = Trainer(spec, params, frozen, hp, bert_cfg=bert_cfg, device=d)
            inputs = [torch.as_tensor(x, device=tr.device) for x in batch.inputs]
            loss, grads = tr.loss_and_grads(
                tr.params, build_masks(spec, cfg, device=tr.device), inputs,
                torch.as_tensor(batch.labels, device=tr.device),
                torch.as_tensor(batch.valid, device=tr.device), tr.generator)
            dtypes = {str(g.dtype) for g in tree_leaves(grads)}
            metric, preds, _ = tr.evaluate(BatchIterator(split_of(batch), B // 2),
                                           build_masks(spec, full_active_config(spec)),
                                           [0, 1, 2])
            out[key] = (float(loss), export_reference_state_dict(spec, grads), dtypes,
                        metric, preds)
    launches = read_counters()
    (l_card, g_card, dt_card, m_card, p_card), (l_cpu, g_cpu, _, m_cpu, p_cpu) = (
        out["card"], out["cpu"])
    loss_err = abs(l_card - l_cpu) / max(abs(l_cpu), 1e-30)
    names = sorted(g_cpu)
    a = np.concatenate([g_card[n].ravel() for n in names]).astype(np.float64)
    r = np.concatenate([g_cpu[n].ravel() for n in names]).astype(np.float64)
    cos = float(a @ r / (np.linalg.norm(a) * np.linalg.norm(r)))
    pred_err = float(np.max(np.abs(p_card - p_cpu)) / max(float(np.max(np.abs(p_cpu))), 1e-30))
    print(f"train-bf16 step B={B} card vs CPU: loss {l_card:.7f} vs {l_cpu:.7f} (rel "
          f"{loss_err:.2e}, tol {BF16_LOSS_TOL:g}); {len(names)} gradients {sorted(dt_card)}, "
          f"cosine {cos:.6f} (min {BF16_COS}); evaluate over {len(p_cpu)} rows: predictions "
          f"{np.ravel(p_card).tolist()} vs {np.ravel(p_cpu).tolist()}, {pred_err:.2e} of max "
          f"|ref| (tol {BF16_PRED_TOL:g}), metric {m_card} vs {m_cpu}; card launches "
          f"{launches}", flush=True)
    bf16_only = all(launches[k] == launches[f"{k}.bf16"] for k in ("K1", "K1b", "K2", "K3"))
    if not (loss_err <= BF16_LOSS_TOL and cos >= BF16_COS and dt_card == {"torch.float32"}
            and pred_err <= BF16_PRED_TOL and bf16_only and launches["K1"] > 0):
        raise RuntimeError("the bf16 step or evaluate: card and CPU disagree")
    return dict(loss_rel=loss_err, grad_cos=cos, pred_rel=pred_err, metric=(m_card, m_cpu))


def train_bf16_flash(dev, spec, bert_cfg, B=4096, T=50, L=32):
    """One Trainer step (``Trainer.train_step``: forward, loss, backward,
    the clip, Adam) at the training shapes under ``spec`` (bf16) with
    ``attn_impl="flash"``, the batch stored on the card in bf16: K1 12 /
    K1b 12 / K2 4 / K3 4, all bf16, and no K5 launch (every trunk stack is
    T==1); then the same step under ``attn_impl="xla"`` (train-bf16's spec)
    from the same weights, batch and generator seed: the loss and every
    gradient (as the step leaves them, clipped) bit-identical."""
    from multimodal_transformer_robustness_tpu_torch import build_masks, full_active_config
    from multimodal_transformer_robustness_tpu_torch.data import DeviceBatchIterator
    from multimodal_transformer_robustness_tpu_torch.models import init_supernet
    from multimodal_transformer_robustness_tpu_torch.train import TrainHParams, Trainer
    from multimodal_transformer_robustness_tpu_torch.train.loop import tree_leaves

    batch = synthetic_batch(np.random.default_rng(0), B, T, L, bert_cfg.vocab_size,
                            spec.orig_dimensions[1:])
    hp = TrainHParams(batch_size=B, lr=1e-4, optim="Adam", criterion="L1Loss",
                      experiment_type="random_sample", modality_pool=POOL)
    res = {}
    for impl in ("flash", "xla"):
        s = dataclasses.replace(spec, attn_impl=impl)
        params, frozen = init_supernet(torch.Generator().manual_seed(0), s, bert_cfg)
        trainer = Trainer(s, params, frozen, hp, bert_cfg=bert_cfg, device=dev)
        del params, frozen
        db = next(iter(DeviceBatchIterator(split_of(batch), B, store_dtype="bfloat16",
                                           device=trainer.device)))
        masks = build_masks(s, full_active_config(s), device=trainer.device)
        valid = torch.as_tensor(db.valid, dtype=torch.float32, device=trainer.device)
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        _, _, loss = trainer.train_step(trainer.params, trainer.opt_state, masks,
                                        list(db.inputs), db.labels, valid, trainer.generator)
        torch.cuda.synchronize()
        res[impl] = (read_counters(), loss.item(), 1e3 * (time.perf_counter() - t0),
                     [None if a.grad is None else a.grad.clone()
                      for a in tree_leaves(trainer.params)])
        del trainer, db
        torch.cuda.empty_cache()
    (launches, loss, ms, grads), (_, ref_loss, _, ref_grads) = res["flash"], res["xla"]
    expected = expect_bf16(K1=12, K1b=12, K2=4, K3=4)
    same = len(grads) == len(ref_grads) and all(
        (a is None and b is None) or (a is not None and b is not None and torch.equal(a, b))
        for a, b in zip(grads, ref_grads))
    print(f"train-bf16-flash B={B} T={T} L={L}: one step in {ms:.1f} ms (host clock, the "
          f"first step), loss {loss!r}, attn_impl='xla' {ref_loss!r}; loss and {len(grads)} "
          f"gradients bit-identical {loss == ref_loss and same}; launches {launches} "
          f"expected {expected}", flush=True)
    if launches != expected or loss != ref_loss or not same or not np.isfinite(loss):
        raise RuntimeError("train-bf16-flash: launch counts, or the step differs from xla's")
    return launches


def bert_int8_full(dev, bert_cfg, B=8, L=32, dtype=torch.float32, label="bert-int8-full"):
    """One frozen-BERT forward with every projection int8
    (``quantize_bert_params(attn=True)``), card vs CPU.  Per layer: one row
    quantization shared by q/k/v and one for the o-proj input (qrows 2), the
    four int8 GEMMs q/k/v/o (qdot 4), the plain attention (the JAX package's
    "auto" for quantized attention layers) and K4.  ``dtype`` bf16: the
    weights quantized in float32, then cast (the scales and biases rounded),
    every kernel its bf16 instance.  Card vs CPU by :func:`int8_agree`, the
    yardstick the float BERT in the same dtype."""
    from multimodal_transformer_robustness_tpu_torch.models import bert as bert_mod
    from multimodal_transformer_robustness_tpu_torch.models.mult import cast_tree, to_device

    float_params = bert_mod.prepare_bert(
        bert_mod.init_bert(torch.Generator().manual_seed(2), bert_cfg))
    params = cast_tree(bert_mod.quantize_bert_params(float_params, attn=True), dtype)
    float_params = cast_tree(float_params, dtype)
    rng = np.random.default_rng(9)
    ids = torch.as_tensor(rng.integers(0, bert_cfg.vocab_size, (B, L)))
    mask = torch.ones(B, L)
    for i in range(1, B):
        mask[i, rng.integers(1, L + 1):] = 0.0
    types = torch.zeros(B, L, dtype=torch.long)
    on_card = cast_tree(to_device(params, dev), dtype)
    reset_counters()
    with torch.inference_mode():
        out = bert_mod.bert_apply(on_card, ids.to(dev), mask.to(dev), types.to(dev), bert_cfg)
    torch.cuda.synchronize()
    launches = read_counters()
    n = bert_cfg.num_layers
    bf16 = dtype == torch.bfloat16
    expected = (expect_bf16 if bf16 else expect)(qrows=2 * n, qdot=4 * n, K4=n)
    print(f"{label} launches {launches} expected {expected} (per layer qrows 2, "
          f"qdot 4, K4 1{', every one a bf16 instance' if bf16 else ''})", flush=True)
    if launches != expected:
        raise RuntimeError(f"{label} launch counts {launches} != {expected}")
    with torch.inference_mode():
        ref = bert_mod.bert_apply(params, ids, mask, types, bert_cfg).float()
        ref_float = bert_mod.bert_apply(float_params, ids, mask, types, bert_cfg).float()
    out = out.cpu()
    ok, err, qerr = int8_agree(out.float(), ref, ref_float)
    print(f"{label} B={B} L={L}: out {tuple(out.shape)} {out.dtype} finite "
          f"{bool(torch.isfinite(out).all())}; card vs CPU relative error {err:.3e} (max abs "
          f"{(out.float() - ref).abs().max():.3e}; limit: the int8 weights' own error vs "
          f"float, {qerr:.3e})", flush=True)
    if not ok or out.dtype != dtype:
        raise RuntimeError(f"{label}: card and CPU disagree")
    return launches


def cached_vs_online(dev, spec, bert_cfg, B=8, T=50, L=32):
    """One step on precomputed features and one on tokens, on the card, from
    the same parameters, masks and batch, every dropout rate 0: the frozen
    BERT is deterministic, so the losses are equal and the gradients agree to
    1e-6 of their max |ref| (the trunk's index backward adds with atomics, in
    no fixed order)."""
    from multimodal_transformer_robustness_tpu_torch import ModelSpec, build_masks
    from multimodal_transformer_robustness_tpu_torch.models import init_supernet
    from multimodal_transformer_robustness_tpu_torch.train import (
        TrainHParams, Trainer, sample_train_config)
    from multimodal_transformer_robustness_tpu_torch.train.features import (
        precompute_text_features)
    from multimodal_transformer_robustness_tpu_torch.weights import export_reference_state_dict

    spec = dataclasses.replace(spec, attn_dropout=(0.0,) * 4, relu_dropout=0.0,
                               res_dropout=0.0, out_dropout=0.0, embed_dropout=0.0)
    cfg = sample_train_config(spec, "random_sample", POOL, np.random.default_rng(5))
    batch = synthetic_batch(np.random.default_rng(6), B, T, L, bert_cfg.vocab_size,
                            spec.orig_dimensions[1:])
    hp = TrainHParams(batch_size=B, lr=1e-4, optim="Adam", criterion="L1Loss")
    out = {}
    with mock.patch.object(ModelSpec, "attn_dropout_for_cross", lambda self, idx: 0.0):
        for key in ("online", "cached"):
            params, frozen = init_supernet(torch.Generator().manual_seed(0), spec, bert_cfg)
            tr = Trainer(spec, params, frozen, hp, bert_cfg=bert_cfg, device=dev)
            inputs = list(batch.inputs)
            if key == "cached":
                inputs[0] = precompute_text_features(tr.frozen, bert_cfg, inputs[0],
                                                     device=dev)
            loss, grads = tr.loss_and_grads(
                tr.params, build_masks(spec, cfg, device=dev),
                [torch.as_tensor(x, device=dev) for x in inputs],
                torch.as_tensor(batch.labels, device=dev),
                torch.as_tensor(batch.valid, device=dev), tr.generator)
            out[key] = (float(loss), export_reference_state_dict(spec, grads))
    (l_on, g_on), (l_off, g_off) = out["online"], out["cached"]
    worst, worst_name = 0.0, None
    for name, ref in g_on.items():
        err = float(np.abs(g_off[name] - ref).max()) / max(float(np.abs(ref).max()), 1e-30)
        if err > worst:
            worst, worst_name = err, name
    print(f"cached-vs-online B={B}: loss {l_off!r} vs {l_on!r} (equal {l_off == l_on}); "
          f"{len(g_on)} gradients, worst normalised difference {worst:.2e} at {worst_name} "
          f"(limit 1e-6)", flush=True)
    if not (l_off == l_on and worst <= 1e-6):
        raise RuntimeError("cached and online training steps disagree")
    return worst


def leaf_names(tree, prefix=""):
    """The names of a parameter tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in leaf_names(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def qkv_apart(names, grads):
    """``(names, grads)`` with each attention's stacked q / k / v projection
    (``in_proj_w`` [3, H, Dh, E], ``in_proj_b`` [3, H, Dh]) split into its
    three parts, so that what dq and dk feed is held apart from dv's.  The
    k bias is left out: a softmax row does not change when q . b_k is added
    to each of its scores, so its gradient is 0 but for rounding."""
    out = []
    for n, g in zip(names, grads):
        if n.endswith(("in_proj_w", "in_proj_b")):
            out += [(f"{n}[{c}]", part) for c, part in zip("qkv", g.unbind(0))
                    if not (c == "k" and n.endswith("in_proj_b"))]
        else:
            out.append((n, g))
    return [n for n, _ in out], [g for _, g in out]


def worst_leaf(cosines):
    """(the lowest of the per-leaf gradient cosines, its leaf index)."""
    i = min(range(len(cosines)), key=cosines.__getitem__)
    return cosines[i], i


def flash_stack(dev, spec, B=4096, long=(16, 2048), iters=3):
    """The flash path at full width (under ``spec.compute_dtype``: at bf16
    the parameters, masks and inputs cast as ``compute_cast`` casts them,
    the float32 masters taking the gradients, every K5 launch a bf16
    instance, card vs CPU within BF16_PRED_TOL of each output's max |ref|
    and every float32 gradient leaf to a cosine of BF16_COS, the xla
    stack's figures on the same card and CPU beside them, labels
    ``flash-stack-bf16-*``): ``encoder_forward(attn_impl="flash")``
    over the MOSEI cross stack (``layers_cross_attn`` layers, Tq=50 Tk=32)
    and a mems0 self stack (``layers_single_attn``, T=50), E=200, 8x25
    heads, FFN 800, the future-mask rule, in train mode at B=4096 with
    attention dropout 0.1 inside the kernels and the spec's other dropouts,
    then the gradient of a scalar loss.  Launches: K5f and K5b (the fused
    backward, T <= 64) once per layer.  Times (CUDA events): fwd+bwd against the same stack with
    attn_impl="xla" (the port's dense attention with the additive future
    mask), and the eval forward of both at B=16 T=2048.  Then the card
    against the CPU at B=8 on the same weights, dropout off (the kernels'
    dropout path at rate 0), in eval and in train mode.  Last, a small T=96
    stack (:func:`flash_stack_long`) for the backward's other path."""
    from multimodal_transformer_robustness_tpu_torch.models.mult import cast_tree, to_device
    from multimodal_transformer_robustness_tpu_torch.ops.encoder import (
        EncoderHParams, EncoderMasks, encoder_forward, init_encoder)
    from multimodal_transformer_robustness_tpu_torch.train.loop import tree_leaves

    E, H, Dh = spec.dimension, spec.num_heads, spec.head_dim
    bf16 = spec.compute_dtype == "bfloat16"
    dt, tag = (torch.bfloat16, "flash-stack-bf16") if bf16 else (torch.float32, "flash-stack")
    count, tol = (expect_bf16, BF16_PRED_TOL) if bf16 else (expect, 1e-4)
    rng = np.random.default_rng(11)
    launches, stats = {}, {}

    def inputs(b, tq, tk, device):
        """x, kv (in the compute dtype) and the loss's fixed float32
        cotangent ct: the loss is mean(y * ct) (the final LayerNorm would
        make mean(y**2) a constant)."""
        x, ct = (torch.from_numpy(rng.standard_normal((b, tq, E), dtype=np.float32)).to(device)
                 for _ in range(2))
        kv = (torch.from_numpy(rng.standard_normal((b, tk, E), dtype=np.float32)).to(device)
              if tk else None)
        return x.to(dt), None if kv is None else kv.to(dt), ct

    for name, layers, tq, tk in (("cross", spec.layers_cross_attn, 50, 32),
                                 ("self", spec.layers_single_attn, 50, None)):
        hp = EncoderHParams(embed_dim_in=E, num_heads=H, head_dim=Dh, layers=layers,
                            attn_mask=True, relu_dropout=spec.relu_dropout,
                            res_dropout=spec.res_dropout, embed_dropout=spec.embed_dropout,
                            attn_impl="flash")
        hp_xla = dataclasses.replace(hp, attn_impl="xla")
        params = init_encoder(torch.Generator().manual_seed(0), hp)

        def on(device):
            p = to_device(params, device)
            leaves = [a.requires_grad_(True) for a in tree_leaves(p)]
            m = EncoderMasks(*(torch.ones(n, device=device, dtype=dt)
                               for n in (layers, H, Dh, 4 * H * Dh)))
            return p, leaves, m

        p, leaves, m = on(dev)
        x, kv, ct = inputs(B, tq, tk, dev)
        gen = torch.Generator(device=dev).manual_seed(0)

        def step(h, rate=spec.attn_dropout[0]):
            y = encoder_forward(cast_tree(p, dt), x, kv, hp=h, masks=m, attn_rate=rate,
                                train=True, generator=gen)
            loss = (y.float() * ct).mean()
            return loss.detach(), torch.autograd.grad(loss, leaves)

        label = f"{tag}-{name}"
        reset_counters()
        loss, grads = step(hp)
        torch.cuda.synchronize()
        got = read_counters()
        expected = count(K5f=layers, K5b=layers)
        finite = bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all()) for g in grads)
        print(f"{label} B={B} Tq={tq} Tk={tk or tq} layers={layers}: loss {loss.item():.6f}, "
              f"{len(grads)} gradients finite {finite}; launches {got} expected {expected}",
              flush=True)
        if got != expected or not finite:
            raise RuntimeError(f"{label}: launch counts {got} or non-finite values")
        launches[label] = got
        del loss, grads
        ms = {"fwd_bwd_flash_ms": cuda_ms(lambda: step(hp), iters, 1),
              "fwd_bwd_xla_ms": cuda_ms(lambda: step(hp_xla), iters, 1)}
        del x, kv, ct
        xl, kvl, _ = inputs(long[0], long[1], long[1] if tk else None, dev)
        with torch.inference_mode():
            pc = cast_tree(p, dt)
            ms["long_eval_flash_ms"] = cuda_ms(
                lambda: encoder_forward(pc, xl, kvl, hp=hp, masks=m), iters, 1)
            ms["long_eval_xla_ms"] = cuda_ms(
                lambda: encoder_forward(pc, xl, kvl, hp=hp_xla, masks=m), iters, 1)
            del pc
        del xl, kvl, p, leaves
        torch.cuda.empty_cache()

        # card against CPU, B=8, every dropout off
        hp0 = dataclasses.replace(hp, relu_dropout=0.0, res_dropout=0.0, embed_dropout=0.0)
        xs, kvs, cts = inputs(8, tq, tk, "cpu")

        def card_and_cpu(h):
            res = {}
            for key, device in (("card", dev), ("cpu", torch.device("cpu"))):
                pd, lv, md = on(device)
                xd, kd = xs.to(device), None if kvs is None else kvs.to(device)
                with torch.inference_mode():
                    y_eval = encoder_forward(cast_tree(pd, dt), xd, kd, hp=h, masks=md)
                y = encoder_forward(cast_tree(pd, dt), xd, kd, hp=h, masks=md, attn_rate=0.0,
                                    train=True,
                                    generator=torch.Generator(device=device).manual_seed(0))
                g = torch.autograd.grad((y.float() * cts.to(device)).mean(), lv)
                res[key] = [y_eval.float().cpu(), y.detach().float().cpu()] + [a.cpu() for a in g]
            card, cpu = res["card"], res["cpu"]
            _, g_card = qkv_apart(names, card[2:])
            _, g_cpu = qkv_apart(names, cpu[2:])
            # float32: the outputs absolute (order 1); bf16: each relative to
            # max |ref|; the gradients leaf by leaf (q, k, v apart), error
            # and cosine
            return ([errors(card[i], cpu[i])[int(bf16)] for i in (0, 1)],
                    [errors(a, b)[1] for a, b in zip(g_card, g_cpu)],
                    [cosine(a, b) for a, b in zip(g_card, g_cpu)])

        names = qkv_apart(leaf_names(params), tree_leaves(params))[0]
        (eval_err, train_err), leaf_errs, leaf_cos = card_and_cpu(hp0)
        grad_err = max(leaf_errs)
        kind = "of max|ref|" if bf16 else "max_abs"
        ms.update({f"card_vs_cpu_eval_{'rel' if bf16 else 'abs'}": eval_err,
                   f"card_vs_cpu_train_{'rel' if bf16 else 'abs'}": train_err,
                   "card_vs_cpu_grad_rel": grad_err})
        if bf16:
            # each float32 gradient leaf's cosine (bf16 flips from sums in
            # another order compound through the layers), the xla stack on
            # the same card and CPU beside it
            (x_eval, x_train), x_errs, x_cos = card_and_cpu(
                dataclasses.replace(hp0, attn_impl="xla"))
            (cos, leaf), (x_min, x_leaf) = worst_leaf(leaf_cos), worst_leaf(x_cos)
            ok = max(eval_err, train_err) <= tol and cos >= BF16_COS
            ms.update(card_vs_cpu_grad_min_leaf_cos=cos, xla_card_vs_cpu_eval_rel=x_eval,
                      xla_card_vs_cpu_train_rel=x_train, xla_card_vs_cpu_grad_rel=max(x_errs),
                      xla_card_vs_cpu_grad_min_leaf_cos=x_min)
            held = (f"eval {kind} {eval_err:.3e}, train {kind} {train_err:.3e} (tol {tol:g}), "
                    f"every gradient leaf's cosine >= {cos:.7f} (min {BF16_COS}; "
                    f"{names[leaf]}), worst leaf {grad_err:.3e} of its max|ref|; the xla stack: "
                    f"outputs {x_eval:.3e} / {x_train:.3e}, leaf cosines >= {x_min:.7f} "
                    f"({names[x_leaf]}), worst leaf {max(x_errs):.3e}")
        else:
            ok = max(eval_err, train_err, grad_err) <= tol
            held = (f"eval {kind} {eval_err:.3e}, train {kind} {train_err:.3e}, gradients "
                    f"{grad_err:.3e} of max|ref| (tol {tol:g})")
        print(f"{label}: fwd+bwd ms flash {ms['fwd_bwd_flash_ms']:.3f} xla "
              f"{ms['fwd_bwd_xla_ms']:.3f}; eval B={long[0]} T={long[1]} ms flash "
              f"{ms['long_eval_flash_ms']:.3f} xla {ms['long_eval_xla_ms']:.3f}; card vs CPU at "
              f"B=8: {held} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise RuntimeError(f"{label}: card and CPU disagree")
        stats[label] = ms
    launches[f"{tag}-long"], stats[f"{tag}-long"] = flash_stack_long(dev, spec)
    return launches, stats


def flash_stack_long(dev, spec, B=8, T=96):
    """The flash backward's second path on a stack: a self stack
    (``layers_single_attn`` layers, MOSEI widths) at T=96 > 64 in train
    mode, every dropout 0, the gradient of a scalar loss: K5f, K5dq and
    K5dkv once per layer (and no K5b); output and every gradient on the card
    against the CPU (1e-4; under a bf16 ``spec`` the bf16 instances, the
    stack cast as :func:`flash_stack` casts it, the output within
    BF16_PRED_TOL of max |ref|, every gradient leaf to a cosine of
    BF16_COS, the xla stack's figures beside them)."""
    from multimodal_transformer_robustness_tpu_torch.models.mult import cast_tree, to_device
    from multimodal_transformer_robustness_tpu_torch.ops.encoder import (
        EncoderHParams, EncoderMasks, encoder_forward, init_encoder)
    from multimodal_transformer_robustness_tpu_torch.train.loop import tree_leaves

    E, H, Dh, layers = spec.dimension, spec.num_heads, spec.head_dim, spec.layers_single_attn
    bf16 = spec.compute_dtype == "bfloat16"
    dt, label = (torch.bfloat16, "flash-stack-bf16-long") if bf16 else (torch.float32,
                                                                        "flash-stack-long")
    hp = EncoderHParams(embed_dim_in=E, num_heads=H, head_dim=Dh, layers=layers,
                        attn_mask=True, attn_impl="flash")
    params = init_encoder(torch.Generator().manual_seed(0), hp)
    rng = np.random.default_rng(12)
    x, ct = (torch.from_numpy(rng.standard_normal((B, T, E), dtype=np.float32))
             for _ in range(2))

    def card_and_cpu(h):
        """(launches on the card, output error, per-leaf gradient errors and
        cosines), card against CPU."""
        res = {}
        for key, device in (("card", dev), ("cpu", torch.device("cpu"))):
            p = to_device(params, device)
            leaves = [a.requires_grad_(True) for a in tree_leaves(p)]
            m = EncoderMasks(*(torch.ones(n, device=device, dtype=dt)
                               for n in (layers, H, Dh, 4 * H * Dh)))
            reset_counters()
            y = encoder_forward(cast_tree(p, dt), x.to(device, dt), None, hp=h, masks=m,
                                attn_rate=0.0, train=True,
                                generator=torch.Generator(device=device).manual_seed(0))
            g = torch.autograd.grad((y.float() * ct.to(device)).mean(), leaves)
            if key == "card":
                torch.cuda.synchronize()
                got = read_counters()
            res[key] = [y.detach().float().cpu()] + [a.cpu() for a in g]
        card, cpu = res["card"], res["cpu"]
        _, g_card = qkv_apart(names, card[1:])
        _, g_cpu = qkv_apart(names, cpu[1:])
        return (got, errors(card[0], cpu[0])[int(bf16)],
                [errors(a, b)[1] for a, b in zip(g_card, g_cpu)],
                [cosine(a, b) for a, b in zip(g_card, g_cpu)])

    names = qkv_apart(leaf_names(params), tree_leaves(params))[0]

    got, out_err, leaf_errs, leaf_cos = card_and_cpu(hp)
    expected = (expect_bf16 if bf16 else expect)(K5f=layers, K5dq=layers, K5dkv=layers)
    grad_err = max(leaf_errs)
    stats = {f"card_vs_cpu_train_{'rel' if bf16 else 'abs'}": out_err,
             "card_vs_cpu_grad_rel": grad_err}
    if bf16:   # every gradient leaf's cosine, the xla stack's beside, as flash_stack
        _, x_out, x_errs, x_cos = card_and_cpu(dataclasses.replace(hp, attn_impl="xla"))
        (cos, leaf), (x_min, x_leaf) = worst_leaf(leaf_cos), worst_leaf(x_cos)
        stats.update(card_vs_cpu_grad_min_leaf_cos=cos, xla_card_vs_cpu_train_rel=x_out,
                     xla_card_vs_cpu_grad_rel=max(x_errs), xla_card_vs_cpu_grad_min_leaf_cos=x_min)
        ok = got == expected and out_err <= BF16_PRED_TOL and cos >= BF16_COS
        held = (f"of max|ref| {out_err:.3e} (tol {BF16_PRED_TOL:g}), every gradient leaf's "
                f"cosine >= {cos:.7f} (min {BF16_COS}; {names[leaf]}), worst leaf "
                f"{grad_err:.3e} of its max|ref|; the xla stack: output {x_out:.3e}, leaf "
                f"cosines >= {x_min:.7f} ({names[x_leaf]}), worst leaf {max(x_errs):.3e}")
    else:
        ok = got == expected and max(out_err, grad_err) <= 1e-4
        held = f"max_abs {out_err:.3e}, gradients {grad_err:.3e} of max|ref| (tol 1e-4)"
    print(f"{label} B={B} T={T} layers={layers}, train, dropout 0: launches {got} "
          f"expected {expected}; card vs CPU {held} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError(f"{label}: launch counts, or card and CPU disagree")
    return got, stats


def serving_flash(dev, n=2, spec=None, label="serving-flash"):
    """StreamingPredictor(attn_impl="flash") at the MOSEI serving
    configuration (``spec``: that configuration under another compute
    dtype, its ``attn_impl`` set instead): every trunk stack is T==1, so the
    flash option takes the T==1 rule and launches no K5f; K1 12, K2 4, K3 4
    per request (under bf16 every one a bf16 instance), and the same
    predictions, bit for bit, as attn_impl="xla" on the same weights; then
    warm ms a request."""
    from multimodal_transformer_robustness_tpu_torch.cli.realtime import StreamingPredictor

    def build(impl):
        if spec is None:
            return StreamingPredictor(seed=0, device=dev, attn_impl=impl)
        return StreamingPredictor(seed=0, device=dev,
                                  spec=dataclasses.replace(spec, attn_impl=impl))

    preds = {impl: build(impl) for impl in ("flash", "xla")}
    requests = synthetic_requests(preds["flash"], n)
    reset_counters()
    got = [preds["flash"].forward(*r) for r in requests]
    launches = read_counters()
    count = expect_bf16 if preds["flash"].spec.compute_dtype == "bfloat16" else expect
    expected = count(K1=12 * n, K2=4 * n, K3=4 * n)
    ref = [preds["xla"].forward(*r) for r in requests]
    print(f"{label}: {n} requests, sentiments {got}; attn_impl='xla' {ref} "
          f"(bit-identical {got == ref}); launches {launches} expected {expected}", flush=True)
    if launches != expected or got != ref or not all(np.isfinite(got)):
        raise RuntimeError(f"{label}: launch counts or predictions differ")
    warm_ms = [1000 * _timed(lambda r=r: preds["flash"].forward(*r)) for r in requests]
    print(f"{label} warm request ms, kernels {warm_ms}", flush=True)
    return launches


def flash_masked_call(dev, B=8, L=32, heads=12, dh=64):
    """K8's path: the JAX package retired flash_attention_masked from the
    BERT's dispatch and keeps it as a library op, so its path is that call,
    here at the BERT's width on q / k / v laid out as the BERT's
    projections give them (ragged masks, one all-zero row).  Against K6a on
    the same inputs (HF's additive -10000 bias; 1e-4 on rows with keys,
    1e-3 on the all-masked row, where the bias rounds the logits) and
    against the CPU (1e-4)."""
    from multimodal_transformer_robustness_tpu_torch.ops import attention_cuda as ac
    from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda

    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, L, heads, dh), dtype=np.float32)).to(dev)
               for _ in range(3))
    mask = ragged_key_mask(rng, B, L, dev)

    def heads_first(a, scale=1.0):
        return (a * scale).transpose(1, 2).contiguous()

    args = (heads_first(q, dh ** -0.5), heads_first(k), heads_first(v), mask)
    reset_counters()
    with torch.inference_mode():
        out = ac.flash_attention_masked(*args)
    torch.cuda.synchronize()
    launches = read_counters()
    expected = expect(K8=1)
    flat = out.transpose(1, 2).reshape(B, L, heads * dh)
    dense = bert_attn_cuda.dense_attention_blockdiag(q, k, v, mask.float())
    cpu = ac.flash_attention_masked(*(a.cpu() for a in args))
    vs_dense = (flat - dense).abs().amax(dim=(1, 2))
    vs_cpu = errors(out.cpu(), cpu)[0]
    ok = (launches == expected and vs_dense[1:].max().item() <= 1e-4
          and vs_dense[0].item() <= 1e-3 and vs_cpu <= 1e-4)
    print(f"flash-masked B={B} L={L} {heads}x{dh}: launches {launches} expected {expected}; "
          f"vs K6a max_abs {vs_dense[1:].max().item():.3e} on rows with keys, "
          f"{vs_dense[0].item():.3e} on the all-masked row; vs CPU {vs_cpu:.3e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError("flash-masked: launch counts or values disagree")
    return launches


def gru_recurrence_phase(dev, B=4096, T=50, in_dim=200, H=100, iters=3):
    """K7's path: the public ``ops.gru.bigru_forward`` at the MOSEI header's
    second level (x [4096, 50, 200], 100 a direction), forward and the
    gradient of a scalar loss in x and every weight: one K7f and one K7b
    (both directions in one G=2 call).  fwd+bwd ms beside the same function
    by the header's route (K1 / K1b, ``bigru_level_tmajor``) and beside
    cuDNN's bidirectional GRU; then the card against the CPU at N=8."""
    from multimodal_transformer_robustness_tpu_torch.ops import bigru_cuda, gru_cuda
    from multimodal_transformer_robustness_tpu_torch.ops.gru import bigru_forward

    rng = np.random.default_rng(13)
    weights = {d: {k: v.cpu() for k, v in gru_weights(rng, in_dim, H, "cpu").items()}
               for d in ("fwd", "bwd")}

    def inputs(n, device):
        p = {d: {k: v.to(device, copy=True).requires_grad_(True) for k, v in w.items()}
             for d, w in weights.items()}
        x = torch.from_numpy(rng.standard_normal((n, T, in_dim), dtype=np.float32))
        cts = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(device)
               for s in ((n, T, 2 * H), (n, 2 * H))]
        return p, x.to(device).requires_grad_(True), cts

    def leaves(p, x):
        return [x] + [v for d in ("fwd", "bwd") for v in p[d].values()]

    def step(p, x, cts):
        out, fin = bigru_forward(p, x)
        loss = (out * cts[0]).sum() + (fin * cts[1]).sum()
        return [out.detach(), fin.detach()] + list(torch.autograd.grad(loss, leaves(p, x)))

    p, x, cts = inputs(B, dev)
    reset_counters()
    res = step(p, x, cts)
    torch.cuda.synchronize()
    launches = read_counters()
    expected = expect(K7f=1, K7b=1)
    finite = all(bool(torch.isfinite(a).all()) for a in res)
    print(f"gru-recurrence bigru_forward B={B} T={T} in={in_dim} H={H}: out "
          f"{tuple(res[0].shape)}, {len(res) - 2} gradients, finite {finite}; launches "
          f"{launches} expected {expected}", flush=True)
    if launches != expected or not finite:
        raise RuntimeError("gru-recurrence: launch counts or non-finite values")
    del res

    def k1_route():
        hs = bigru_cuda.bigru_level_tmajor(p, x.transpose(0, 1).contiguous())
        out = hs.transpose(0, 1)
        loss = (out * cts[0]).sum() + (bigru_cuda.bigru_finals_tmajor(hs) * cts[1]).sum()
        return torch.autograd.grad(loss, leaves(p, x))

    gru = cudnn_bigru({d: {k: v.detach() for k, v in w.items()} for d, w in p.items()},
                      in_dim, H, dev)
    gru_leaves = [x] + list(gru.parameters())

    def cudnn():
        out, h_n = gru(x.transpose(0, 1))
        fin = torch.cat([h_n[0], h_n[1]], dim=-1)
        loss = (out.transpose(0, 1) * cts[0]).sum() + (fin * cts[1]).sum()
        return torch.autograd.grad(loss, gru_leaves)

    ms = {"fwd_bwd_k7_ms": cuda_ms(lambda: step(p, x, cts), iters, 1),
          "fwd_bwd_k1_route_ms": cuda_ms(k1_route, iters, 1),
          "fwd_bwd_cudnn_ms": cuda_ms(cudnn, iters, 1)}
    # the backward's reductions outside K7b, on tensors of the path's shape
    hs, *das = (torch.randn(2, T, B, H, device=dev) for _ in range(4))
    ms["weight_reductions_ms"] = cuda_ms(lambda: gru_cuda.weight_grads(hs, *das), iters, 1)
    del p, x, cts, gru, gru_leaves, hs, das
    torch.cuda.empty_cache()

    got = {}
    for key, device in (("card", dev), ("cpu", torch.device("cpu"))):
        rng = np.random.default_rng(14)
        got[key] = [a.cpu() for a in step(*inputs(8, device))]
    err = max(errors(a, b)[1] for a, b in zip(got["card"], got["cpu"]))
    ms["card_vs_cpu_rel"] = err
    print(f"gru-recurrence: fwd+bwd ms through K7 {ms['fwd_bwd_k7_ms']:.3f}, by the "
          f"header's route (K1 + K1b) {ms['fwd_bwd_k1_route_ms']:.3f}, cuDNN "
          f"{ms['fwd_bwd_cudnn_ms']:.3f}; of it, the weight reductions outside K7b "
          f"{ms['weight_reductions_ms']:.3f}; card vs CPU at N=8, outputs and {len(got['cpu']) - 2} "
          f"gradients: {err:.3e} of max|ref| (tol 1e-4)", flush=True)
    if not err <= 1e-4:
        raise RuntimeError("gru-recurrence: card and CPU disagree")
    return launches, ms


def trunk_block_phase(dev, R=4096, iters=5):
    """K9's path: the library op ``fused_residual_block`` at the four MOSEI
    T==1 blocks (TRUNK_BLOCKS), R=4096, train mode (attention: d_mid 0.1 per
    head; FFN: relu, d_mid 0.1; d_res 0.3; top blocks channel-masked),
    forward and the gradient of a scalar loss in x, src and the six
    parameters: one K9f and one K9b a call.  fwd+bwd ms beside the eager
    composition of the same half-layer in the port's encoder ops (what
    ``ops/encoder._layer_forward`` runs: masked_layer_norm, the T==1
    attention or masked_linear, dropout, residual).  Then the card against
    the CPU at R=8 with the dropout on: the hash gives both the same masks."""
    from multimodal_transformer_robustness_tpu_torch.ops import (
        dropout, init_mha, masked_layer_norm, masked_linear, multihead_attention)
    from multimodal_transformer_robustness_tpu_torch.ops.trunk_block_cuda import (
        fused_residual_block)

    H, Dh, rate_mid, rate_res = 8, 25, 0.1, 0.3
    rng = np.random.default_rng(15)
    launches, stats = expect(), {}
    for name, E, F1, act, rep, cross, masked in TRUNK_BLOCKS:
        x, src, ct, params, (cm, mm, _) = trunk_block_operands(rng, R, E, F1, masked, dev)
        if act == "id":   # the attention half: w1 / w2 from the packed projections
            attn = {k: v.to(dev) for k, v in
                    init_mha(torch.Generator().manual_seed(0), E, H, Dh).items()}
            params[:4] = [attn["in_proj_w"][2].reshape(F1, E), attn["in_proj_b"][2].reshape(F1),
                          attn["out_w"].reshape(E, F1), attn["out_b"]]
            hm, dm = (mm.reshape(H, Dh)[:, 0].contiguous(), torch.ones(Dh, device=dev))
        leaves = [a.requires_grad_(True) for a in [x, src] + params]
        x, src, w1, b1, w2, b2, g, lb = leaves
        src_in = src if cross else x
        cm_or_none = cm if masked else None
        seeds = [int(s) for s in rng.integers(-2**31, 2**31 - 1, 2)]
        kw = dict(act=act, mid_rep=rep, rate_mid=rate_mid, rate_res=rate_res,
                  seed_mid=seeds[0], seed_res=seeds[1], use_drop_mid=True, use_drop_res=True)

        def fused():
            y = fused_residual_block(x, src_in, w1, b1, w2, b2, g, lb, cm_or_none, mm,
                                     cm_or_none, **kw)
            return torch.autograd.grad((y * ct).sum(), leaves if cross else
                                       [x] + leaves[2:])

        gen = torch.Generator(device=dev).manual_seed(0)

        def eager():
            x3, s3 = x[:, None], src_in[:, None]
            h = masked_layer_norm(s3 if cross else x3, g, lb, cm_or_none)
            if act == "id":
                    # q and k never enter the T==1 path; v is w1 / b1
                p_attn = dict(in_proj_w=torch.stack([*attn["in_proj_w"][:2],
                                                     w1.reshape(H, Dh, E)]),
                              in_proj_b=torch.stack([*attn["in_proj_b"][:2],
                                                     b1.reshape(H, Dh)]),
                              out_w=w2.reshape(E, H, Dh), out_b=b2)
                hq = masked_layer_norm(x3, g, lb, None) if cross else h
                y = multihead_attention(p_attn, hq, h, h, head_mask=hm, head_dim_mask=dm,
                                        channel_mask=cm_or_none, attn_dropout=rate_mid,
                                        train=True, generator=gen)
            else:
                y = masked_linear(h, w1, b1, mask_out=mm)
                y = dropout(torch.relu(y), rate_mid, True, gen)
                y = masked_linear(y, w2, b2, mask_out=cm_or_none)
            y = x3 + dropout(y, rate_res, True, gen)
            return torch.autograd.grad((y[:, 0] * ct).sum(), leaves if cross else
                                       [x] + leaves[2:])

        reset_counters()
        grads = fused()
        torch.cuda.synchronize()
        got = read_counters()
        finite = all(bool(torch.isfinite(a).all()) for a in grads)
        if got != expect(K9f=1, K9b=1) or not finite:
            raise RuntimeError(f"trunk-block {name}: launches {got} or non-finite gradients")
        launches = {k: launches[k] + got[k] for k in launches}
        ms = {"fused_fwd_bwd_ms": cuda_ms(fused, iters, 1),
              "eager_fwd_bwd_ms": cuda_ms(eager, iters, 1)}
        del grads, leaves, x, src, src_in, w1, b1, w2, b2, g, lb, ct, params

        # card against CPU, R=8, dropout on
        res = {}
        for key, device in (("card", dev), ("cpu", torch.device("cpu"))):
            r8 = np.random.default_rng(16)
            xs, ss, cts, ps, (c8, m8, _) = trunk_block_operands(r8, 8, E, F1, masked, device)
            lv = [a.requires_grad_(True) for a in [xs, ss] + ps]
            y = fused_residual_block(lv[0], lv[1] if cross else lv[0], *lv[2:],
                                     c8 if masked else None, m8, c8 if masked else None, **kw)
            gr = torch.autograd.grad((y * cts).sum(), lv if cross else [lv[0]] + lv[2:])
            res[key] = [y.detach().cpu()] + [a.cpu() for a in gr]
        err = max(errors(a, b)[1] for a, b in zip(res["card"], res["cpu"]))
        ms["card_vs_cpu_rel"] = err
        print(f"trunk-block {name} E={E} F1={F1} R={R} train: launches K9f {got['K9f']} "
              f"K9b {got['K9b']}, every other kernel 0; fwd+bwd ms "
              f"fused (K9f + K9b) {ms['fused_fwd_bwd_ms']:.4f}, eager half-layer "
              f"{ms['eager_fwd_bwd_ms']:.4f}; card vs CPU at R=8, dropout on: {err:.3e} of "
              f"max|ref| (tol 1e-4)", flush=True)
        if not err <= 1e-4:
            raise RuntimeError(f"trunk-block {name}: card and CPU disagree")
        stats[name] = ms
        torch.cuda.empty_cache()
    return launches, stats


def flash_masked_bf16(dev, B=8, L=32, heads=12, dh=64):
    """K8's path at bf16: flash_masked_call's library call on the same
    operands (its seed: ragged masks, one all-zero row) rounded to bf16,
    one K8.bf16 launch, on the unit walk; against the CPU's bf16 plain
    version (FLASH_BF16_TOL of max |ref|) and the float32 kernel on the
    same bf16-valued operands (a cosine of FLASH_BF16_COS).  Beside it the
    parent's plan (the float32 HARD kernels on bf16 rows), held the same
    way and timed in turns, and a D = 25 cross shape (Tq=50, Tk=32, 8
    heads: rows on 2-byte boundaries), which keeps that plan."""
    from multimodal_transformer_robustness_tpu_torch.ops import attention_cuda as ac
    from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda

    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, L, heads, dh), dtype=np.float32)).to(dev)
               for _ in range(3))
    mask = ragged_key_mask(rng, B, L, dev)
    args = tuple((a * scale).transpose(1, 2).contiguous().to(torch.bfloat16)
                 for a, scale in ((q, dh ** -0.5), (k, 1.0), (v, 1.0))) + (mask,)
    reset_counters()
    with torch.inference_mode():
        out = ac.flash_attention_masked(*args)
    torch.cuda.synchronize()
    launches = read_counters()
    expected = expect_bf16(K8=1)
    cpu = ac.flash_attention_masked(*(a.cpu() for a in args))
    f32 = ac.flash_attention_masked(*(a.float() for a in args[:3]), mask)
    rel = errors(out.float().cpu(), cpu.float())[1]
    cos = cosine(out.float(), f32)
    walk = bert_attn_cuda._plan_attention_masked_bf16(B, L, L, heads, dh, True) is not None
    ok = (launches == expected and out.dtype == torch.bfloat16 and rel <= FLASH_BF16_TOL
          and cos >= FLASH_BF16_COS and walk)
    print(f"flash-masked-bf16 B={B} L={L} {heads}x{dh}: launches {launches} expected "
          f"{expected}; unit walk {walk}; vs CPU {rel:.3e} of max|ref| (tol "
          f"{FLASH_BF16_TOL:g}); cosine vs the float32 kernel {cos:.7f} (min "
          f"{FLASH_BF16_COS}) {'ok' if ok else 'FAIL'}", flush=True)
    with parent_plans():
        par = ac.flash_attention_masked(*args)
    p_rel, p_cos = errors(par.float().cpu(), cpu.float())[1], cosine(par.float(), f32)
    fn = lambda: ac.flash_attention_masked(*args)   # noqa: E731
    turns = [parent_ms(fn, 20), cuda_ms(fn, 20), cuda_ms(fn, 20), parent_ms(fn, 20)]
    print(f"  the parent's plan: vs CPU {p_rel:.3e}, cosine {p_cos:.7f}; ms in turns (parent, "
          f"walk, walk, parent) {', '.join(f'{v:.4f}' for v in turns)}", flush=True)
    ok = ok and p_rel <= FLASH_BF16_TOL and p_cos >= FLASH_BF16_COS
    # D = 25 (the MOSEI heads' width): no walk, the float32 plan's kernels
    q25 = torch.from_numpy(rng.standard_normal((B, 8, 50, 25), dtype=np.float32) / 5.0)
    k25, v25 = (torch.from_numpy(rng.standard_normal((B, 8, 32, 25), dtype=np.float32))
                for _ in range(2))
    m25 = ragged_key_mask(rng, B, 32, dev)
    a25 = tuple(a.to(dev, torch.bfloat16) for a in (q25, k25, v25))
    o25 = ac.flash_attention_masked(*a25, m25)
    rel25 = errors(o25.float().cpu(), ac.flash_attention_masked(
        *(a.cpu() for a in a25), m25.cpu()).float())[1]
    cos25 = cosine(o25.float(), ac.flash_attention_masked(*(a.float() for a in a25), m25))
    walk25 = bert_attn_cuda._plan_attention_masked_bf16(B, 50, 32, 8, 25, True) is not None
    ok25 = not walk25 and rel25 <= FLASH_BF16_TOL and cos25 >= FLASH_BF16_COS
    print(f"  D=25 Tq=50 Tk=32 8 heads: unit walk {walk25} (the float32 plan's kernels); vs "
          f"CPU {rel25:.3e}, cosine {cos25:.7f} {'ok' if ok25 else 'FAIL'}", flush=True)
    if not (ok and ok25):
        raise RuntimeError("flash-masked-bf16: launch counts, plans or values disagree")
    return launches


def leaf_cosines(card, cpu):
    """Per leaf, the cosine of the card's tensor against the CPU's."""
    return [cosine(a.float().cpu(), b.float()) for a, b in zip(card, cpu)]


def gru_recurrence_bf16(dev, B=4096, T=50, in_dim=200, H=100, iters=3):
    """K7's path at bf16: ``ops.gru.bigru_forward`` with bf16 weights and x
    [4096, 50, 200], forward and the gradient of a scalar loss in x and
    every weight: one K7f.bf16 and one K7b.bf16; fwd+bwd ms beside cuDNN's
    bidirectional GRU in bf16; then the card against the CPU at N=8, the
    outputs within BF16_TOL of max |ref|, each gradient leaf a cosine of
    BF16_COS."""
    from multimodal_transformer_robustness_tpu_torch.ops.gru import bigru_forward

    bf = torch.bfloat16
    rng = np.random.default_rng(13)
    weights = {d: {k: v.cpu() for k, v in gru_weights(rng, in_dim, H, "cpu").items()}
               for d in ("fwd", "bwd")}

    def inputs(n, device):
        p = {d: {k: v.to(device, bf).requires_grad_(True) for k, v in w.items()}
             for d, w in weights.items()}
        x = torch.from_numpy(rng.standard_normal((n, T, in_dim), dtype=np.float32))
        cts = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(device, bf)
               for s in ((n, T, 2 * H), (n, 2 * H))]
        return p, x.to(device, bf).requires_grad_(True), cts

    def leaves(p, x):
        return [x] + [v for d in ("fwd", "bwd") for v in p[d].values()]

    def step(p, x, cts):
        out, fin = bigru_forward(p, x)
        loss = (out.float() * cts[0].float()).sum() + (fin.float() * cts[1].float()).sum()
        return [out.detach(), fin.detach()] + list(torch.autograd.grad(loss, leaves(p, x)))

    p, x, cts = inputs(B, dev)
    reset_counters()
    res = step(p, x, cts)
    torch.cuda.synchronize()
    launches = read_counters()
    expected = expect_bf16(K7f=1, K7b=1)
    finite = all(bool(torch.isfinite(a).all()) for a in res)
    bf16_out = all(a.dtype == bf for a in res)
    print(f"gru-recurrence-bf16 bigru_forward B={B} T={T} in={in_dim} H={H}: out "
          f"{tuple(res[0].shape)} {res[0].dtype}, {len(res) - 2} gradients, finite {finite}; "
          f"launches {launches} expected {expected}", flush=True)
    if launches != expected or not finite or not bf16_out:
        raise RuntimeError("gru-recurrence-bf16: launch counts, dtypes or non-finite values")
    del res
    gru = cudnn_bigru({d: {k: v.detach().float() for k, v in w.items()} for d, w in p.items()},
                      in_dim, H, dev).to(bf)
    gru.flatten_parameters()
    gru_leaves = [x] + list(gru.parameters())

    def cudnn():
        out, h_n = gru(x.transpose(0, 1))
        fin = torch.cat([h_n[0], h_n[1]], dim=-1)
        loss = ((out.transpose(0, 1).float() * cts[0].float()).sum()
                + (fin.float() * cts[1].float()).sum())
        return torch.autograd.grad(loss, gru_leaves)

    ms = {"fwd_bwd_k7_ms": cuda_ms(lambda: step(p, x, cts), iters, 1),
          "fwd_bwd_cudnn_ms": cuda_ms(cudnn, iters, 1)}
    del p, x, cts, gru, gru_leaves
    torch.cuda.empty_cache()

    got = {}
    for key, device in (("card", dev), ("cpu", torch.device("cpu"))):
        rng = np.random.default_rng(14)
        got[key] = [a.cpu() for a in step(*inputs(8, device))]
    out_err = max(errors(a.float(), b.float())[1] for a, b in zip(got["card"][:2],
                                                                   got["cpu"][:2]))
    cos = min(leaf_cosines(got["card"][2:], got["cpu"][2:]))
    ms.update(card_vs_cpu_out_rel=out_err, card_vs_cpu_min_leaf_cos=cos)
    print(f"gru-recurrence-bf16: fwd+bwd ms through K7 (bf16) {ms['fwd_bwd_k7_ms']:.3f}, "
          f"cuDNN in bf16 {ms['fwd_bwd_cudnn_ms']:.3f}; card vs CPU at N=8: outputs "
          f"{out_err:.3e} of max|ref| (tol {BF16_TOL:g}), lowest of {len(got['cpu']) - 2} "
          f"gradient leaves' cosines {cos:.7f} (min {BF16_COS})", flush=True)
    if not (out_err <= BF16_TOL and cos >= BF16_COS):
        raise RuntimeError("gru-recurrence-bf16: card and CPU disagree")
    return launches, ms


def trunk_block_bf16(dev, R=4096, iters=5):
    """K9's path at bf16: ``fused_residual_block`` at the four MOSEI T==1
    blocks (TRUNK_BLOCKS) on bf16 x and src with float32 parameters (the
    masters of a bf16 step): R=4096 in train mode (trunk_block_phase's
    dropout) and R=1 in eval, forward and the gradient of a scalar loss in
    x, src and the six parameters: one K9f.bf16 and one K9b.bf16 a call;
    fwd+bwd ms.  Then the card against the CPU at R=8, train: the output
    within BF16_TOL of max |ref|, each gradient leaf a cosine of BF16_COS."""
    from multimodal_transformer_robustness_tpu_torch.ops.trunk_block_cuda import (
        fused_residual_block)

    bf = torch.bfloat16
    rng = np.random.default_rng(15)
    launches, stats = expect(), {}
    for name, E, F1, act, rep, cross, masked in TRUNK_BLOCKS:
        seeds = [int(s) for s in rng.integers(-2**31, 2**31 - 1, 2)]

        def call(rows, train, device, r):
            x, src, ct, params, (cm, mm, _) = trunk_block_operands(r, rows, E, F1, masked,
                                                                   device)
            x, src, ct = (a.to(bf) for a in (x, src, ct))
            leaves = [a.requires_grad_(True) for a in [x, src] + params]
            wrt = leaves if cross else [leaves[0]] + leaves[2:]
            kw = dict(act=act, mid_rep=rep, rate_mid=0.1, rate_res=0.3, seed_mid=seeds[0],
                      seed_res=seeds[1], use_drop_mid=train, use_drop_res=train)

            def fused():
                y = fused_residual_block(leaves[0], leaves[1] if cross else leaves[0],
                                         *leaves[2:], cm if masked else None, mm,
                                         cm if masked else None, **kw)
                return [y.detach()] + list(torch.autograd.grad((y.float() * ct.float()).sum(),
                                                               wrt))
            return fused

        for rows, train in ((R, True), (1, False)):
            fused = call(rows, train, dev, rng)
            reset_counters()
            res = fused()
            torch.cuda.synchronize()
            got = read_counters()
            finite = all(bool(torch.isfinite(a).all()) for a in res)
            if got != expect_bf16(K9f=1, K9b=1) or not finite or res[0].dtype != bf:
                raise RuntimeError(f"trunk-block-bf16 {name} R={rows}: launches {got}, "
                                   f"dtype {res[0].dtype} or non-finite values")
            launches = {k: launches[k] + got[k] for k in launches}
            stats[f"{name} R={rows} {'train' if train else 'eval'}"] = {
                "fused_fwd_bwd_ms": cuda_ms(fused, iters if rows > 1 else 20, 1)}
            del res, fused
        res = {}
        for key, device in (("card", dev), ("cpu", torch.device("cpu"))):
            res[key] = [a.cpu() for a in call(8, True, device, np.random.default_rng(16))()]
        out_err = errors(res["card"][0].float(), res["cpu"][0].float())[1]
        cos = min(leaf_cosines(res["card"][1:], res["cpu"][1:]))
        key = f"{name} R={R} train"
        stats[key].update(card_vs_cpu_out_rel=out_err, card_vs_cpu_min_leaf_cos=cos)
        print(f"trunk-block-bf16 {name} E={E} F1={F1}: K9f.bf16 / K9b.bf16 1 / 1 a call, "
              f"every other kernel 0; fwd+bwd ms R={R} train "
              f"{stats[key]['fused_fwd_bwd_ms']:.4f}, R=1 eval "
              f"{stats[f'{name} R=1 eval']['fused_fwd_bwd_ms']:.4f}; card vs CPU at R=8, "
              f"dropout on: output {out_err:.3e} of max|ref| (tol {BF16_TOL:g}), lowest "
              f"gradient leaf cosine {cos:.7f} (min {BF16_COS})", flush=True)
        if not (out_err <= BF16_TOL and cos >= BF16_COS):
            raise RuntimeError(f"trunk-block-bf16 {name}: card and CPU disagree")
        torch.cuda.empty_cache()
    return launches, stats


def split_of(batch):
    """A gather-style dataset over one batch's arrays (the text a [3, N, L]
    token stack), as the MOSEI loader serves them.  It is an
    ``ArrayDataset`` (whose own constructor wants one row per label in
    every input, which the token stack's axis 0 is not) so that
    ``materialize`` takes its arrays as they are, without a copy."""
    from multimodal_transformer_robustness_tpu_torch.data import ArrayDataset

    class SyntheticSplit(ArrayDataset):
        def __init__(self, batch):
            self.inputs, self.labels = batch.inputs, batch.labels

        def __len__(self):
            return len(self.labels)

        def gather(self, idx):
            text, *rest = self.inputs
            return [text[:, idx]] + [x[idx] for x in rest], self.labels[idx]

    return SyntheticSplit(batch)


def synthetic_split(seed, n, spec, bert_cfg, T=50, L=32, tile=None):
    """:func:`split_of` one synthetic batch of ``n`` rows.  With ``tile``,
    the audio and vision arrays repeat one draw of ``tile`` rows (drawing a
    large split's normals on the host takes seconds); the token ids and
    labels are drawn for every row, so a gather of the wrong row still
    shows."""
    rng = np.random.default_rng(seed)
    batch = synthetic_batch(rng, tile or n, T, L, bert_cfg.vocab_size, spec.orig_dimensions[1:])
    if tile:
        full = synthetic_batch(rng, n, 1, L, bert_cfg.vocab_size, (1, 1))
        reps = -(-n // tile)
        batch.inputs[0], batch.labels = full.inputs[0], full.labels
        batch.inputs[1:] = [np.tile(x, (reps, 1, 1))[:n] for x in batch.inputs[1:]]
    return split_of(batch)


def same_batches(host, device_iter, label):
    """The device iterator's batches equal the host iterator's bit for bit
    (one epoch each); returns the number of batches."""
    n = 0
    for b_h, b_d in zip(host, device_iter, strict=True):
        same = all(torch.equal(x_d.cpu(), torch.as_tensor(np.asarray(x_h)))
                   for x_h, x_d in zip(b_h.inputs + [b_h.labels], b_d.inputs + [b_d.labels]))
        if not same or not np.array_equal(b_h.valid, b_d.valid):
            raise RuntimeError(f"{label}: DeviceBatchIterator batch {n} differs from "
                               "BatchIterator's")
        n += 1
    return n


def fit_phase(dev, spec, bert_cfg, B=4096, n_train=8192, n_eval=64, eval_bs=16, epochs=2):
    """``Trainer.fit`` at the MOSEI configuration: the train split (2 batches
    of B=4096) resident on the card through ``DeviceBatchIterator`` (first
    held to the host ``BatchIterator`` bit for bit, shuffled, and padded on
    the valid split), valid and test 64 rows at the MOSEI eval batch of 16,
    Adam, random_sample over the 7 subsets, 2 epochs.  Per epoch the
    counters must show K1 12 / K1b 12 (6 without dx) / K2 4 / K3 4 a
    training step and K1 12 / K2 4 / K3 4 a header pass of the validation
    (one pass, not M+1) and test evals.  Then the same fit at B=4, dropout
    off, card against CPU: the curve within SERVE_TOL, each epoch's losses
    within TRAIN_LOSS_TOL (relative)."""
    from multimodal_transformer_robustness_tpu_torch.data import BatchIterator, DeviceBatchIterator
    from multimodal_transformer_robustness_tpu_torch.models import init_supernet
    from multimodal_transformer_robustness_tpu_torch.train import TrainHParams, Trainer

    t0 = time.perf_counter()
    train_ds = synthetic_split(10, n_train, spec, bert_cfg, tile=512)
    valid_ds, test_ds = (synthetic_split(s, n_eval, spec, bert_cfg) for s in (11, 12))
    train_it = DeviceBatchIterator(train_ds, B, shuffle=True, seed=0, device=dev)
    torch.cuda.synchronize()
    made_s = time.perf_counter() - t0
    n_same = same_batches(BatchIterator(train_ds, B, shuffle=True, seed=0), train_it, "fit")
    train_it.set_epoch(0)
    n_same += same_batches(BatchIterator(valid_ds, 24, shuffle=True, seed=1),
                           DeviceBatchIterator(valid_ds, 24, shuffle=True, seed=1, device=dev),
                           "fit")
    resident = sum(x.nbytes for x in train_it.inputs) / 2**30
    print(f"fit: train split {n_train} rows ({resident:.2f} GiB; audio and vision tile 512 "
          f"rows) made and resident on the "
          f"card in {made_s:.2f} s; {n_same} DeviceBatchIterator batches bit-equal to "
          f"BatchIterator's (train B={B} shuffled; valid B=24 shuffled, tail padded)",
          flush=True)

    params, frozen = init_supernet(torch.Generator().manual_seed(0), spec, bert_cfg)
    hp = TrainHParams(batch_size=B, lr=1e-4, optim="Adam", criterion="L1Loss",
                      experiment_type="random_sample", modality_pool=POOL, num_epochs=epochs,
                      dataset="mosei_senti")
    trainer = Trainer(spec, params, frozen, hp, bert_cfg=bert_cfg, device=dev)
    del params, frozen
    valid_it, test_it = (DeviceBatchIterator(d, eval_bs, device=dev) for d in (valid_ds, test_ds))
    per_epoch, marks = [], [time.perf_counter(), read_counters()]

    def epoch_end(tr, epoch):
        now, counts = time.perf_counter(), read_counters()
        per_epoch.append(dict(seconds=now - marks[0],
                              launches={k: counts[k] - marks[1][k] for k in counts},
                              losses=tr.last_epoch_losses.tolist()))
        marks[:] = [now, counts]

    torch.cuda.synchronize()
    reset_counters()
    marks[:] = [time.perf_counter(), read_counters()]
    curve = trainer.fit(train_it, valid_it, test_it, epoch_fn=epoch_end)
    launches = read_counters()
    steps, evals = n_train // B, 2 * (n_eval // eval_bs)
    expected = expect(K1=12 * (steps + evals), K1b=12 * steps, K2=4 * (steps + evals),
                      K3=4 * (steps + evals))
    for e, rec in enumerate(per_epoch, 1):
        print(f"fit epoch {e}: {rec['seconds']:.3f} s (host clock, epoch_fn to epoch_fn: "
              f"{steps} steps at B={B}, {evals} eval batches at B={eval_bs}); losses "
              f"{rec['losses']}; launches {rec['launches']}", flush=True)
    print(f"fit curve [[valid, test], ...] {curve}; launches per epoch expected {expected} "
          f"(K1b without dx 6 a step)", flush=True)
    if len(per_epoch) != epochs or any(r["launches"] != expected for r in per_epoch) \
            or counters()["K1b"].launches_no_dx != 6 * steps * epochs:
        raise RuntimeError(f"fit launch counts per epoch {[r['launches'] for r in per_epoch]}")
    if not np.isfinite(curve).all() or not all(np.isfinite(r["losses"]).all() and
                                               len(r["losses"]) == steps for r in per_epoch):
        raise RuntimeError("fit: non-finite curve or losses")
    stats = dict(epoch_s=[r["seconds"] for r in per_epoch], curve=curve,
                 losses=[r["losses"] for r in per_epoch], data_s=made_s, resident_gib=resident)
    del trainer, train_it
    torch.cuda.empty_cache()
    stats.update(fit_card_vs_cpu(dev, spec, bert_cfg))
    return launches, stats


def fit_card_vs_cpu(dev, spec, bert_cfg, B=4, n_train=8, n_eval=6, epochs=2):
    """The same fit at B=4 (train 8 rows, valid and test 6 rows with a
    padded tail), dropout off and the 0.1 cross quirk patched to 0, on the
    card and on the CPU from the same parameters and seeds."""
    from multimodal_transformer_robustness_tpu_torch import ModelSpec
    from multimodal_transformer_robustness_tpu_torch.data import BatchIterator
    from multimodal_transformer_robustness_tpu_torch.models import init_supernet
    from multimodal_transformer_robustness_tpu_torch.train import TrainHParams, Trainer

    spec = dataclasses.replace(spec, attn_dropout=(0.0,) * 4, relu_dropout=0.0,
                               res_dropout=0.0, out_dropout=0.0, embed_dropout=0.0)
    train_ds = synthetic_split(20, n_train, spec, bert_cfg)
    valid_ds, test_ds = (synthetic_split(s, n_eval, spec, bert_cfg) for s in (21, 22))
    hp = TrainHParams(batch_size=B, lr=1e-4, optim="Adam", criterion="L1Loss",
                      experiment_type="random_sample", modality_pool=POOL, num_epochs=epochs)
    out = {}
    with mock.patch.object(ModelSpec, "attn_dropout_for_cross", lambda self, idx: 0.0):
        for key, d in (("card", dev), ("cpu", "cpu")):
            params, frozen = init_supernet(torch.Generator().manual_seed(0), spec, bert_cfg)
            tr = Trainer(spec, params, frozen, hp, bert_cfg=bert_cfg, device=d)
            losses = []
            t0 = time.perf_counter()
            curve = tr.fit(BatchIterator(train_ds, B, shuffle=True, seed=0),
                           BatchIterator(valid_ds, B), BatchIterator(test_ds, B),
                           epoch_fn=lambda t, e: losses.append(t.last_epoch_losses.tolist()))
            out[key] = (np.asarray(curve), np.asarray(losses), time.perf_counter() - t0)
    (c_card, l_card, s_card), (c_cpu, l_cpu, s_cpu) = out["card"], out["cpu"]
    curve_err = float(np.abs(c_card - c_cpu).max())
    loss_err = float((np.abs(l_card - l_cpu) / np.abs(l_cpu)).max())
    print(f"fit B={B} card vs CPU, {epochs} epochs ({s_card:.1f} s / {s_cpu:.1f} s): curve "
          f"{c_card.tolist()} vs {c_cpu.tolist()} (max abs diff {curve_err:.2e}, tol "
          f"{SERVE_TOL:g}); losses {l_card.tolist()} vs {l_cpu.tolist()} (max rel "
          f"{loss_err:.2e}, tol {TRAIN_LOSS_TOL:g})", flush=True)
    if not (c_card.shape == (epochs, 2) and curve_err <= SERVE_TOL
            and l_card.shape == l_cpu.shape and loss_err <= TRAIN_LOSS_TOL):
        raise RuntimeError("fit: card and CPU disagree")
    return dict(cpu_curve_err=curve_err, cpu_loss_rel_err=loss_err)


def sweep_phase(dev, spec, bert_cfg, n_eval=64, eval_bs=16, chunk=64):
    """``missing_modality_sweep`` at the MOSEI configuration (seed-0
    weights) over the full grid (7 subsets, 860 configurations),
    random_sample, ``cfg_chunk`` 64, valid and test 64 rows at batch 16.  The
    counters prove the hoist: the headers run once per (subset, valid
    batch) and once per (subset, test batch) of the best configuration's
    re-evaluation, K1 12 / K2 4 / K3 4 each, whatever the configuration
    count.  Then, on the first 4 rows of the first valid batch, every
    configuration's predictions [n_cfg, 4] on the card against the CPU
    within SERVE_TOL,
    and each configuration's accuracy equal once the rows whose prediction
    lies within SERVE_TOL of 0 (a sign either side may take) are left out;
    those rows are counted, and the best configurations compared (near-ties
    between distinct configurations may flip the argmax)."""
    from multimodal_transformer_robustness_tpu_torch import build_masks, stack_masks
    from multimodal_transformer_robustness_tpu_torch.data import BatchIterator
    from multimodal_transformer_robustness_tpu_torch.metrics import binary_acc
    from multimodal_transformer_robustness_tpu_torch.models import init_supernet
    from multimodal_transformer_robustness_tpu_torch.train import (
        TrainHParams, Trainer, missing_modality_sweep)
    from multimodal_transformer_robustness_tpu_torch.train.sweep import (
        subset_choices, subset_configs)

    hp = TrainHParams(batch_size=eval_bs, experiment_type="random_sample", dataset="mosei_senti")
    trainers = {}
    for key, d in (("card", dev), ("cpu", "cpu")):
        params, frozen = init_supernet(torch.Generator().manual_seed(0), spec, bert_cfg)
        trainers[key] = Trainer(spec, params, frozen, hp, bert_cfg=bert_cfg, device=d)
    valid_ds, test_ds = (synthetic_split(s, n_eval, spec, bert_cfg) for s in (31, 32))
    subsets = subset_choices(spec, hp.experiment_type)
    grids = {s: subset_configs(spec, hp.experiment_type, s) for s in subsets}
    n_cfg = sum(len(g) for g in grids.values())
    n_valid, n_test = n_eval // eval_bs, n_eval // eval_bs

    tr = trainers["card"]
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    results = missing_modality_sweep(tr, BatchIterator(valid_ds, eval_bs),
                                     BatchIterator(test_ds, eval_bs), max_cfg_chunk=chunk)
    seconds = time.perf_counter() - t0          # the sweep ends in readbacks
    launches = read_counters()
    passes = len(subsets) * (n_valid + n_test)
    expected = expect(K1=12 * passes, K2=4 * passes, K3=4 * passes)
    print(f"sweep: {n_cfg} configurations over {len(subsets)} subsets, {n_valid} valid + "
          f"{n_test} test batches of {eval_bs}, cfg_chunk {chunk}: {seconds:.3f} s (host "
          f"clock, valid and test uploads included), {n_cfg / seconds:.1f} configurations/s "
          f"on the whole valid split; launches {launches} expected {expected} (header passes "
          f"{passes} = subsets x (valid + test batches))", flush=True)
    for s, entry in results.items():
        c = entry["best_cfg"]
        print(f"sweep best {[spec.modality_set[j] for j in s]}: depths "
              f"{c.active_single_attn_layer_num} outputs {c.active_cross_output}; valid "
              f"{entry['valid_acc']:.4f} test {entry['test_acc']:.4f}", flush=True)
    if launches != expected:
        raise RuntimeError(f"sweep launch counts {launches} != {expected}")
    if len(results) != len(subsets) or not all(np.isfinite(e["valid_acc"]) and
                                               np.isfinite(e["test_acc"])
                                               for e in results.values()):
        raise RuntimeError("sweep: missing subsets or non-finite accuracies")

    # card vs CPU on the first rows of the first valid batch, every
    # configuration (the CPU's trunk over 860 configurations sets the cost)
    rows = 4
    batch = next(iter(BatchIterator(valid_ds, rows)))
    truth = np.asarray(batch.labels)
    worst, near_rows, best_same, t_cpu = 0.0, 0, 0, 0.0
    for s in subsets:
        cfgs = grids[s]
        n = len(cfgs)
        stacked = stack_masks([build_masks(spec, c) for c in cfgs])
        preds = {}
        for key, t in trainers.items():
            t1 = time.perf_counter()
            inputs = [torch.as_tensor(x, device=t.device) for x in batch.inputs]
            flags = torch.ones(spec.modality_num, device=t.device)
            preds[key] = t.eval_step_sweep(t.params, stacked, inputs, flags,
                                           chunk=chunk).cpu().numpy()
            if key == "cpu":
                t_cpu += time.perf_counter() - t1
        card, cpu = preds["card"], preds["cpu"]
        if card.shape != (n, rows, 1) or not np.isfinite(card).all():
            raise RuntimeError(f"sweep {s}: predictions {card.shape}")
        worst = max(worst, float(np.abs(card - cpu).max()))
        near = (np.abs(cpu[..., 0]) <= SERVE_TOL) | (np.abs(card[..., 0]) <= SERVE_TOL)
        near_rows += int(near.sum())
        acc = {k: [binary_acc(p[k_][~near[k_]], truth[~near[k_]]) if (~near[k_]).any()
                   else None for k_ in range(n)] for k, p in preds.items()}
        if acc["card"] != acc["cpu"]:
            raise RuntimeError(f"sweep {s}: per-configuration accuracies differ beyond the "
                               "rows near 0")
        score = {k: [-1.0 if a is None else a for a in v] for k, v in acc.items()}
        best_same += int(np.argmax(score["card"]) == np.argmax(score["cpu"]))
    print(f"sweep card vs CPU on one valid batch: {n_cfg} configurations x {rows} rows, max "
          f"abs diff {worst:.3e} (tol {SERVE_TOL:g}); rows within {SERVE_TOL:g} of 0 left out "
          f"of the accuracies: {near_rows}; per-configuration accuracies equal; best "
          f"configuration equal in {best_same} of {len(subsets)} subsets (CPU {t_cpu:.1f} s)",
          flush=True)
    if not worst <= SERVE_TOL:
        raise RuntimeError("sweep: card and CPU disagree")
    return launches, dict(seconds=seconds, configs=n_cfg, configs_per_s=n_cfg / seconds,
                          header_passes=passes, cpu_max_abs_diff=worst, near_zero_rows=near_rows,
                          best_equal_subsets=best_same)


# the flash-stack phase's shapes: the mems0 self stack and the cross stack
FLASH_MAIN = "self B=4096 H=8 Tq=50 Tk=50 D=25 offset=1 rate=0.1"
FLASH_CROSS = "cross B=4096 H=8 Tq=50 Tk=32 D=25 offset=19 rate=0.1"
FLASH_LONG = "long B=16 H=8 Tq=2048 Tk=2048 D=25 offset=1 rate=0.0"
# the gru-recurrence phase's shape (and the serving-length one), the
# trunk-block phase's widest block (and its narrowest)
K7_MAIN, K7_SERVE = "G=2 T=50 N=4096 H=100", "G=2 T=64 N=1 H=100"
K9_MAIN = "top-ffn E=1000 F1=800 R=4096 train"
K9_STREAM = "stream-attn E=200 F1=200 R=4096 train"


def kernel_entries(rows, launches):
    """One entry per kernel: worst error over every checked shape, times at
    the main path's most frequent shape, and the same at the training shape."""
    main_shape = {"K1": "in=768 H=100 T=64 B=1 fwd", "K2": "B=1 L=8 h=768",
                  "K3": "B=1 L=8 h=768 ffn=3072",
                  "K1b": "in=768 H=100 T=50 B=4096 fwd need_dx=False",
                  "K4": "B=1 L=8 h=768 ffn=3072", "K6a": "B=1 L=8 h=768",
                  "K6b": "B=1 L=8 h=768",
                  "K5f": FLASH_MAIN, "K5dq": FLASH_MAIN, "K5dkv": FLASH_MAIN,
                  "K5b": FLASH_MAIN, "K8": "B=1 L=8 H=12 D=64", "K7f": K7_MAIN, "K7b": K7_MAIN,
                  "K9f": K9_MAIN, "K9b": K9_MAIN}
    train_shape = {"K1": "in=768 H=100 T=50 B=4096 fwd", "K2": "B=4096 L=32 h=768",
                   "K3": "B=4096 L=32 h=768 ffn=3072",
                   "K1b": "in=200 H=100 T=50 B=4096 fwd need_dx=True",
                   "K4": "B=4096 L=32 h=768 ffn=3072", "K6a": "B=4096 L=32 h=768",
                   "K6b": "B=4096 L=32 h=768",
                   "K5f": FLASH_CROSS, "K5dq": FLASH_CROSS, "K5dkv": FLASH_CROSS,
                   "K5b": FLASH_CROSS,
                   "K8": "B=4096 L=32 H=12 D=64", "K7f": K7_SERVE, "K7b": K7_SERVE,
                   "K9f": K9_STREAM, "K9b": K9_STREAM}
    meta = {
        "K1": ("gru_dir", "csrc/bigru.cu", "ops/bigru_pallas.py:127"),
        "K1b": ("gru_dir_bwd", "csrc/bigru_bwd.cu", "ops/bigru_pallas.py:284"),
        "K2": ("attention_block_fused", "csrc/bert_attn.cu", "ops/bert_attn_pallas.py:223"),
        "K3": ("ffn_ln_block", "csrc/bert_ffn.cu", "ops/bert_ffn_pallas.py:150"),
        "K4": ("ffn_ln_block_q", "csrc/bert_ffn_q.cu", "ops/bert_ffn_pallas.py:222"),
        "K6a": ("dense_attention_blockdiag", "csrc/bert_attn.cu",
                "ops/bert_attn_pallas.py:114"),
        "K6b": ("proj_ln_block", "csrc/bert_ffn.cu", "ops/bert_ffn_pallas.py:183"),
        "K5f": ("flash_fwd", "csrc/flash_attn.cu", "ops/attention_pallas.py:197"),
        "K5dq": ("flash_bwd_dq", "csrc/flash_attn.cu", "ops/attention_pallas_bwd.py:77"),
        "K5dkv": ("flash_bwd_dkv", "csrc/flash_attn.cu", "ops/attention_pallas_bwd.py:120"),
        "K5b": ("flash_bwd", "csrc/flash_attn.cu", "ops/attention_pallas_bwd.py:178"),
        "K8": ("flash_attention_masked", "csrc/bert_attn.cu", "ops/attention_pallas.py:383"),
        "K7f": ("gru_recurrence_cuda", "csrc/gru_recurrence.cu", "ops/gru_pallas.py:113"),
        "K7b": ("gru_recurrence_bwd_cuda", "csrc/gru_recurrence.cu", "ops/gru_pallas.py:187"),
        "K9f": ("trunk_block_fwd", "csrc/trunk_block.cu", "ops/trunk_block_pallas.py:270"),
        "K9b": ("trunk_block_bwd", "csrc/trunk_block.cu", "ops/trunk_block_pallas.py:309"),
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
        if kid == "K4":
            kernels[-1].update(int32_exact=all(r["int32_exact"] for r in mine),
                               max_flipped_share=max(r["flipped_share"] for r in mine))
        if kid == "K5b":   # the pair K5b replaces at T <= 64, with the delta op
            kernels[-1]["pair_with_delta_ms"] = at["pair_with_delta_ms"]
            kernels[-1]["at_train_shape"]["pair_with_delta_ms"] = tr["pair_with_delta_ms"]
        if kid == "K9b":   # the errors above include relu-kink flips; this is what is held
            kernels[-1]["max_err_over_max_ref_beyond_kink_allowance"] = max(
                r["rel_beyond_allowance"] for r in mine)
    return kernels


def bf16_kernel_entries(rows, launches):
    """The bf16 instances of K1f, K1b, K2, K3, K4, K6a, K6b, K5f, K5b, K5dq,
    K5dkv, K8, K7f, K7b, K9f and K9b: worst error over their checked shapes
    (each held to BF16_TOL, the flash kernels and K8 to FLASH_BF16_TOL, of
    max |ref|), their cosine against the float32 kernel, and the times at
    the training path's shape (K1b: in=768 without dx, the most frequent;
    K5dq / K5dkv: B=16 T=2048; K8 B=4096 L=32; K7 and K9 their library-op
    phases' shapes; every shape in ``by_shape``, SDPA's backend beside the
    flash rows); launches from the bf16 phases' counters."""
    bf16_gemm, bf16_ln = "csrc/gemm_bf16.cuh", "csrc/layernorm_bf16.cuh"
    meta = {
        "K1f.bf16": ("gru_dir", "K1.bf16", ("csrc/bigru.cu", bf16_gemm),
                     "ops/bigru_pallas.py:127", "in=768 H=100 T=50 B=4096 fwd"),
        "K1b.bf16": ("gru_dir_bwd", "K1b.bf16", ("csrc/bigru_bwd.cu", bf16_gemm),
                     "ops/bigru_pallas.py:284", "in=768 H=100 T=50 B=4096 fwd need_dx=False"),
        "K2.bf16": ("attention_block_fused", "K2.bf16",
                    ("csrc/bert_attn.cu", bf16_gemm, bf16_ln),
                    "ops/bert_attn_pallas.py:223", "B=4096 L=32 h=768"),
        "K3.bf16": ("ffn_ln_block", "K3.bf16", ("csrc/bert_ffn.cu", bf16_gemm, bf16_ln),
                    "ops/bert_ffn_pallas.py:150", "B=4096 L=32 h=768 ffn=3072"),
        "K4.bf16": ("ffn_ln_block_q", "K4.bf16", ("csrc/bert_ffn_q.cu",),
                    "ops/bert_ffn_pallas.py:222", "B=4096 L=32 h=768 ffn=3072"),
        "K6a.bf16": ("dense_attention_blockdiag", "K6a.bf16", ("csrc/bert_attn.cu",),
                     "ops/bert_attn_pallas.py:114", "B=4096 L=32 h=768"),
        "K6b.bf16": ("proj_ln_block", "K6b.bf16", ("csrc/bert_ffn.cu", bf16_gemm, bf16_ln),
                     "ops/bert_ffn_pallas.py:183", "B=4096 L=32 h=768"),
        "K5f.bf16": ("flash_fwd", "K5f.bf16", ("csrc/flash_attn.cu",),
                     "ops/attention_pallas.py:197", FLASH_MAIN),
        "K5b.bf16": ("flash_bwd", "K5b.bf16", ("csrc/flash_attn.cu",),
                     "ops/attention_pallas_bwd.py:178", FLASH_MAIN),
        "K5dq.bf16": ("flash_bwd_dq", "K5dq.bf16", ("csrc/flash_attn.cu",),
                      "ops/attention_pallas_bwd.py:77", FLASH_LONG),
        "K5dkv.bf16": ("flash_bwd_dkv", "K5dkv.bf16", ("csrc/flash_attn.cu",),
                       "ops/attention_pallas_bwd.py:120", FLASH_LONG),
        "K8.bf16": ("flash_attention_masked", "K8.bf16", ("csrc/bert_attn.cu",),
                    "ops/attention_pallas.py:383", "B=4096 L=32 H=12 D=64"),
        "K7f.bf16": ("gru_recurrence_cuda", "K7f.bf16", ("csrc/gru_recurrence.cu",),
                     "ops/gru_pallas.py:113", K7_MAIN),
        "K7b.bf16": ("gru_recurrence_bwd_cuda", "K7b.bf16", ("csrc/gru_recurrence.cu",),
                     "ops/gru_pallas.py:187", K7_MAIN),
        "K9f.bf16": ("trunk_block_fwd", "K9f.bf16", ("csrc/trunk_block.cu", bf16_gemm),
                     "ops/trunk_block_pallas.py:270", K9_MAIN),
        "K9b.bf16": ("trunk_block_bwd", "K9b.bf16", ("csrc/trunk_block.cu", bf16_gemm),
                     "ops/trunk_block_pallas.py:309", K9_MAIN),
    }
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for kid, (name, counter, sources, replaces, shape) in meta.items():
        mine = [r for r in rows if r["kid"] == kid]
        at = next(r for r in mine if r["shape"] == shape)
        kernels.append({"name": f"{name} (bf16)", "route": "cuda",
                        "source": " + ".join(f"{PKG}/{src}" for src in sources),
                        "replaces": f"multimodal_transformer_robustness_tpu/{replaces} "
                                    "(at bf16 operands)",
                        "launches": sum(l[counter] for l in launches.values()),
                        "max_abs_err": max(r["abs"] for r in mine),
                        "max_err_over_max_ref": max(r["rel"] for r in mine),
                        "min_cos_vs_float32": min(r["cos_vs_float32"] for r in mine),
                        **{k: at[k] for k in timed}, "shape": shape,
                        "launches_by_path": {p: l[counter] for p, l in launches.items()},
                        "by_shape": {r["shape"]: {k: r.get(k) for k in timed + (
                            "parent_ms", "attention_ms", "attention_parent_ms",
                            "attention_sdpa_ms") if k in timed or k in r} for r in mine}})
        if "sdpa_backend" in at:   # the flash rows: SDPA's pick at D = 25
            kernels[-1]["library_backend"] = at["sdpa_backend"]
        if kid == "K9b.bf16":   # as K9b's: the errors include relu-kink flips
            kernels[-1]["max_err_over_max_ref_beyond_kink_allowance"] = max(
                r["rel_beyond_allowance"] for r in mine)
    return kernels


def int8_projection_entries(rows, launches):
    """The int8 projections of a fully quantized BERT (qrows + qdot): the
    JAX package runs them as XLA ops (models/bert.py _qrows / _qdot), not as
    a Pallas kernel, so they stand apart from the kernel table."""
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return [{"name": "qdot", "route": "cuda", "source": f"{PKG}/csrc/bert_ffn_q.cu",
             "replaces": "multimodal_transformer_robustness_tpu/models/bert.py:252 "
                         "(_qdot, an XLA int8 dot)", "shape": r["shape"],
             "int32_exact": r["int32_exact"], "max_abs_err": r["abs"],
             "launches": {p: l["qdot"] for p, l in launches.items()},
             **{k: r[k] for k in timed}} for r in rows if r["kid"] == "qdot"]


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
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("  " + line.strip())

    phase("kernels")
    rows = check_kernels(dev, np.random.default_rng(0))
    torch.cuda.empty_cache()
    splits = device_split(dev, np.random.default_rng(1))

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

    phase("serving-int8")
    pred, cpu, int8_launches, int8_warm, int8_plain = serve(
        dev, "serving-int8", expect(K1=12, K2=4, K4=4), bert_int8=True)
    del pred, cpu

    phase("serving-dense")
    with attn_impl("dense"):
        pred, cpu, dense_launches, dense_warm, dense_plain = serve(
            dev, "serving-dense", expect(K1=12, K6a=4, K6b=4, K3=4))
    del pred, cpu
    torch.cuda.empty_cache()

    phase("bert-int8-full")
    full_launches = bert_int8_full(dev, bert_cfg)

    phase("train-int8")
    int8_train_launches, int8_train_stats = train(
        dev, spec, bert_cfg, "train-int8", expect(K1=12, K1b=12, K2=4, K4=4), bert_int8=True)
    torch.cuda.empty_cache()

    phase("train-cached")
    cached_launches, cached_stats = train(
        dev, spec, bert_cfg, "train-cached", expect(K1=12, K1b=12), cached=True)
    torch.cuda.empty_cache()

    phase("cached-vs-online")
    cached_vs_online(dev, spec, bert_cfg)
    torch.cuda.empty_cache()

    phase("flash-stack")
    flash_launches, flash_stats = flash_stack(dev, spec)
    torch.cuda.empty_cache()

    phase("serving-flash")
    serving_flash_launches = serving_flash(dev)

    phase("flash-masked")
    masked_launches = flash_masked_call(dev)

    phase("gru-recurrence")
    rec_launches, rec_stats = gru_recurrence_phase(dev)
    torch.cuda.empty_cache()

    phase("trunk-block")
    block_launches, block_stats = trunk_block_phase(dev)
    torch.cuda.empty_cache()

    phase("fit")
    fit_launches, fit_stats = fit_phase(dev, spec, bert_cfg)
    torch.cuda.empty_cache()

    spec16 = dataclasses.replace(spec, compute_dtype="bfloat16")
    phase("train-bf16")
    bf16_launches, bf16_stats = train(
        dev, spec16, bert_cfg, "train-bf16", expect_bf16(K1=12, K1b=12, K2=4, K3=4),
        store_dtype="bfloat16", warmup=2, steps=3)
    # the last records of the same breakdown on this card before the
    # persistent K2.bf16 and K6b.bf16 (PERF.md §5), printed beside this
    # run's
    print(f"train-bf16 BERT {bf16_stats['bert_ms']:.2f} ms (before: 37.82), "
          f"headers fwd+bwd {bf16_stats['headers_fwd_bwd_ms']:.2f} ms "
          "(before: 32.15)", flush=True)
    torch.cuda.empty_cache()

    phase("train-bf16-cached")
    bf16_cached_launches, bf16_cached_stats = train(
        dev, spec16, bert_cfg, "train-bf16-cached", expect_bf16(K1=12, K1b=12), cached=True,
        store_dtype="bfloat16", warmup=2, steps=3)
    torch.cuda.empty_cache()

    phase("train-bf16-vs-cpu")
    bf16_agree = train_bf16_card_vs_cpu(dev, spec16, bert_cfg)
    torch.cuda.empty_cache()

    phase("train-bf16-int8")
    bf16_int8_launches, bf16_int8_stats = train(
        dev, spec16, bert_cfg, "train-bf16-int8", expect_bf16(K1=12, K1b=12, K2=4, K4=4),
        bert_int8=True, store_dtype="bfloat16", warmup=2, steps=3)
    # its last record before the persistent K2.bf16 (PERF.md §5)
    print(f"train-bf16-int8 BERT {bf16_int8_stats['bert_ms']:.2f} ms (before: 41.6-41.8)",
          flush=True)
    torch.cuda.empty_cache()

    phase("serving-bf16")
    pred, cpu, s16_launches, s16_warm, s16_plain = serve(
        dev, "serving-bf16", expect_bf16(K1=12, K2=4, K3=4), spec=spec16)
    del pred, cpu

    phase("serving-bf16-int8")
    pred, cpu, s16_int8_launches, s16_int8_warm, s16_int8_plain = serve(
        dev, "serving-bf16-int8", expect_bf16(K1=12, K2=4, K4=4), spec=spec16, bert_int8=True)
    del pred, cpu

    phase("serving-bf16-dense")
    with attn_impl("dense"):
        pred, cpu, s16_dense_launches, s16_dense_warm, s16_dense_plain = serve(
            dev, "serving-bf16-dense", expect_bf16(K1=12, K6a=4, K6b=4, K3=4), spec=spec16)
    del pred, cpu
    torch.cuda.empty_cache()

    phase("bert-int8-full-bf16")
    full16_launches = bert_int8_full(dev, bert_cfg, dtype=torch.bfloat16,
                                     label="bert-int8-full-bf16")

    phase("flash-stack-bf16")
    flash16_launches, flash16_stats = flash_stack(dev, spec16)
    torch.cuda.empty_cache()

    phase("train-bf16-flash")
    train16_flash_launches = train_bf16_flash(dev, spec16, bert_cfg)
    torch.cuda.empty_cache()

    phase("serving-bf16-flash")
    s16_flash_launches = serving_flash(dev, spec=spec16, label="serving-bf16-flash")
    torch.cuda.empty_cache()

    phase("flash-masked-bf16")
    masked16_launches = flash_masked_bf16(dev)

    phase("gru-recurrence-bf16")
    rec16_launches, rec16_stats = gru_recurrence_bf16(dev)
    torch.cuda.empty_cache()

    phase("trunk-block-bf16")
    block16_launches, block16_stats = trunk_block_bf16(dev)
    torch.cuda.empty_cache()

    phase("sweep")
    sweep_launches, sweep_stats = sweep_phase(dev, spec, bert_cfg)

    launches = {"serving": serve_launches, "train": train_launches,
                "serving-int8": int8_launches, "serving-dense": dense_launches,
                "bert-int8-full": full_launches, "train-int8": int8_train_launches,
                "train-cached": cached_launches, **flash_launches,
                "serving-flash": serving_flash_launches, "flash-masked": masked_launches,
                "gru-recurrence": rec_launches, "trunk-block": block_launches,
                "fit": fit_launches, "sweep": sweep_launches, "train-bf16": bf16_launches,
                "train-bf16-cached": bf16_cached_launches, "train-bf16-int8": bf16_int8_launches,
                "serving-bf16": s16_launches, "serving-bf16-int8": s16_int8_launches,
                "serving-bf16-dense": s16_dense_launches, "bert-int8-full-bf16": full16_launches,
                **flash16_launches, "train-bf16-flash": train16_flash_launches,
                "serving-bf16-flash": s16_flash_launches, "flash-masked-bf16": masked16_launches,
                "gru-recurrence-bf16": rec16_launches, "trunk-block-bf16": block16_launches}
    kernels = kernel_entries(rows, launches) + bf16_kernel_entries(rows, launches)
    print(f"serving warm request ms, kernels {warm_ms}, plain {plain_ms}", flush=True)
    print(f"serving-int8 warm request ms, kernels {int8_warm}, plain {int8_plain}", flush=True)
    print(f"serving-dense warm request ms, kernels {dense_warm}, plain {dense_plain}",
          flush=True)
    for label, warm, plain in (("serving-bf16", s16_warm, s16_plain),
                               ("serving-bf16-int8", s16_int8_warm, s16_int8_plain),
                               ("serving-bf16-dense", s16_dense_warm, s16_dense_plain)):
        print(f"{label} warm request ms, kernels {warm}, plain {plain}", flush=True)
    print("train " + json.dumps(train_stats), flush=True)
    print("train-int8 " + json.dumps(int8_train_stats), flush=True)
    print("train-cached " + json.dumps(cached_stats), flush=True)
    print("flash-stack " + json.dumps(flash_stats), flush=True)
    print("flash-stack-bf16 " + json.dumps(flash16_stats), flush=True)
    print("gru-recurrence " + json.dumps(rec_stats), flush=True)
    print("trunk-block " + json.dumps(block_stats), flush=True)
    print("gru-recurrence-bf16 " + json.dumps(rec16_stats), flush=True)
    print("trunk-block-bf16 " + json.dumps(block16_stats), flush=True)
    print("fit " + json.dumps(fit_stats), flush=True)
    print("sweep " + json.dumps(sweep_stats), flush=True)
    print("train-bf16 " + json.dumps(bf16_stats), flush=True)
    print("train-bf16-cached " + json.dumps(bf16_cached_stats), flush=True)
    print("train-bf16-vs-cpu " + json.dumps(bf16_agree), flush=True)
    print("train-bf16-int8 " + json.dumps(bf16_int8_stats), flush=True)
    print("int8 projections " + json.dumps(int8_projection_entries(rows, launches)),
          flush=True)
    print("device split " + json.dumps(splits), flush=True)
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
