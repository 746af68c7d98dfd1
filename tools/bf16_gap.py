"""Where the bf16 policy's card and CPU predictions part: the MOSEI model of
``chip_smoke.py``'s train-bf16-vs-cpu phase (full width, the 4-layer BERT,
random weights from seed 0, every dropout off), one eval forward over a
synthetic batch of 64 rows, split into the headers (``supernet_headers``:
the frozen BERT, K2 and K3, and the GRU headers, K1f) and the trunk
(``supernet_trunk``: plain PyTorch at bf16), on three routes:

  * ``card``: the kernels, as the port runs on the card;
  * ``card-plain``: the card with the bf16 plain versions of K1f, K2 and K3
    in place of the kernels (cuBLAS float32 products of the upcast
    operands, the same rounding points);
  * ``cpu``: the CPU's plain versions, the reference of the phase.

The trunk then runs on each route's headers and on the CPU's headers, so
the headers' share of a gap is read apart from the trunk's.  Prints, for
each pair, the headers' elements that differ and by how many bf16 steps,
and the predictions' largest difference absolute, of max |ref| and of
max(|ref|, 1e-2) elementwise; then a last JSON line of those numbers.

Run from the repository root on a card:

    python3 tools/bf16_gap.py
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from contextlib import ExitStack
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402
from multimodal_transformer_robustness_tpu_torch import _build  # noqa: E402

ROWS = 64


def plain_on_card():
    """The card's K1f, K2 and K3 entries replaced by their bf16 plain
    versions (the plain versions run on any device)."""
    from multimodal_transformer_robustness_tpu_torch.ops import (bert_attn_cuda, bert_ffn_cuda,
                                                                 bigru_cuda)
    stack = ExitStack()
    stack.enter_context(mock.patch.object(
        bigru_cuda, "_launch_fwd",
        lambda x, wp, wt, bc, bhn, reverse: (bigru_cuda.gru_dir_plain(x, wp, wt, bc, bhn,
                                                                      reverse), None)))
    stack.enter_context(mock.patch.object(bert_attn_cuda, "_attention_block_bf16",
                                          bert_attn_cuda._attention_block_plain_bf16))
    stack.enter_context(mock.patch.object(
        bert_ffn_cuda, "_ffn_ln_block_bf16",
        lambda x, w1t, b1, w2t, b2, g, b, eps: bert_ffn_cuda.ffn_ln_block_plain(
            x, w1t, b1, w2t, b2, g, b, eps=eps)))
    return stack


def steps(a: np.ndarray, r: np.ndarray) -> np.ndarray:
    """|a - r| in bf16 steps at r's magnitude (8 significant bits)."""
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(r), 1e-30))) - 7)
    return np.abs(a - r) / ulp


def gaps(dev, spec, bert_cfg, rows: int = ROWS, T: int = 50, L: int = 32) -> dict:
    """The readings above, ``dev`` the card (or the CPU, to try the script)."""
    from multimodal_transformer_robustness_tpu_torch import build_masks, full_active_config
    from multimodal_transformer_robustness_tpu_torch.models import init_supernet
    from multimodal_transformer_robustness_tpu_torch.models import mult
    from multimodal_transformer_robustness_tpu_torch.train import TrainHParams, Trainer

    spec = dataclasses.replace(spec, compute_dtype="bfloat16", attn_dropout=(0.0,) * 4,
                               relu_dropout=0.0, res_dropout=0.0, out_dropout=0.0,
                               embed_dropout=0.0)
    batch = smoke.synthetic_batch(np.random.default_rng(4), rows, T, L, bert_cfg.vocab_size,
                                  spec.orig_dimensions[1:])
    hp = TrainHParams(batch_size=rows, dataset="mosei_senti")
    trainers = {}
    for key, d in (("card", dev), ("cpu", "cpu")):
        params, frozen = init_supernet(torch.Generator().manual_seed(0), spec, bert_cfg)
        trainers[key] = Trainer(spec, params, frozen, hp, bert_cfg=bert_cfg, device=d)

    def headers(key):
        tr = trainers[key]
        inputs = [torch.as_tensor(x, device=tr.device) for x in batch.inputs]
        with torch.no_grad():
            return mult.supernet_headers(spec, tr.params, inputs, frozen=tr.frozen,
                                         bert_cfg=bert_cfg)

    def trunk(key, base):
        tr = trainers[key]
        masks = build_masks(spec, full_active_config(spec), device=tr.device)
        with torch.no_grad():
            out = mult.supernet_trunk(spec, tr.params, masks, base.to(tr.device))
        return out.float().cpu().numpy().ravel()

    smoke.reset_counters()
    base = {"card": headers("card")}
    card_launches = smoke.read_counters()
    smoke.reset_counters()
    with plain_on_card():
        base["card-plain"] = headers("card")
    plain_launches = smoke.read_counters()
    base["cpu"] = headers("cpu")
    print(f"header launches: card {card_launches}; card-plain {plain_launches}", flush=True)
    preds = {key: trunk("cpu" if key == "cpu" else "card", b) for key, b in base.items()}
    mixed = {f"{key} headers, cpu trunk": trunk("cpu", b) for key, b in base.items()
             if key != "cpu"}
    mixed["cpu headers, card trunk"] = trunk("card", base["cpu"])

    report = {}
    ref = base["cpu"].float().cpu().numpy()
    for key in ("card", "card-plain"):
        a = base[key].float().cpu().numpy()
        s = steps(a, ref)
        report[f"headers {key} vs cpu"] = dict(
            differ=float(np.mean(a != ref)), max_steps=float(s.max()),
            over_one_step=float(np.mean(s > 1.0)))
    a, r = base["card"].float().cpu().numpy(), base["card-plain"].float().cpu().numpy()
    report["headers card vs card-plain"] = dict(differ=float(np.mean(a != r)),
                                               max_steps=float(steps(a, r).max()))

    def pred_gap(a, r):
        d = np.abs(a - r)
        elem = d / np.maximum(np.abs(r), 1e-2)
        return dict(max_abs=float(d.max()), of_max_ref=float(d.max() / np.abs(r).max()),
                    elementwise=float(elem.max()), rows_over_2e2=int((elem > 2e-2).sum()))

    p_cpu = preds["cpu"]
    report["preds card vs cpu"] = pred_gap(preds["card"], p_cpu)
    report["preds card-plain vs cpu"] = pred_gap(preds["card-plain"], p_cpu)
    report["preds card vs card-plain"] = pred_gap(preds["card"], preds["card-plain"])
    for key, p in mixed.items():
        report[f"preds {key} vs cpu"] = pred_gap(p, p_cpu)
    report["preds scale"] = {"max_abs_ref": float(np.abs(p_cpu).max()),
                             "rows_below_0.05": int((np.abs(p_cpu) < 0.05).sum()),
                             "rows": int(p_cpu.size)}
    return report


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script measures the port on a card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    report = gaps(torch.device("cuda", 0), *smoke.mosei())
    for k, v in report.items():
        print(f"{k}: {v}", flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
