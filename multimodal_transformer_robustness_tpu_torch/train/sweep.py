"""The missing-modality robustness sweep, the reference's headline
evaluation (``test_missing_modality``, src/train.py:250-405), over a batched
configuration grid.

Counterpart of ``multimodal_transformer_robustness_tpu/train/sweep.py``.
The reference runs, for every modality subset, a nested serial grid of
full validation passes.  Here every (depth, topology) candidate is a mask
set; the candidates stack along a leading configuration axis, and each data
batch runs the headers once and the trunk over chunks of the stack
(``Trainer.eval_step_sweep``).

The candidate enumeration is the reference's (train.py:270-358), the 13
hand-listed two-modality topology variants and their duplicates included,
with the per-experiment depth rules.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import ActiveConfig, ModalityStr, ModelSpec, full_active_config
from ..masks import build_masks, stack_masks
from ..metrics import eval_mosei_senti


def two_modality_candidates(m0: str, m1: str) -> List[Dict[str, List[str]]]:
    """The 13 hand-listed active_cross_output variants for a 2-modality
    subset under random_sample (train.py:283-344), in order, as
    modality-char -> output-stream lists."""
    a, b = m0, m1
    return [
        {a: [a], b: [b]},                     # 1
        {a: [a, a + b]},                      # 2
        {b: [b, b + a]},                      # 3
        {a: [a + b], b: [b]},                 # 4
        {a: [a], b: [b + a]},                 # 5
        {a: [a + b]},                         # 6
        {b: [b + a]},                         # 7
        {a: [a + b], b: [b + a]},             # 8
        {a: [a, a + b], b: [b + a]},          # 9
        {a: [a + b], b: [b, b + a]},          # 10
        {a: [a, a + b], b: [b, b + a]},       # 11
        {b: [b + a]},                         # 12 (7 again, as listed)
        {a: [a + b]},                         # 13 (6 again, as listed)
    ]


def enumerate_subset_candidates(
    spec: ModelSpec,
    experiment_type: str,
    active_modality: Tuple[int, ...],
    specific=None,
) -> Tuple[List[List[str]], List[List[List[str]]]]:
    """(canonical active_cross, candidate active_cross_output list) for one
    subset (train.py:270-350)."""
    M = spec.modality_num
    chars = [spec.modality_set[j] for j in active_modality]
    m = ModalityStr(chars)
    active_cross: List[List[str]] = [[] for _ in range(M)]
    canonical: List[List[str]] = [[] for _ in range(M)]
    for k, j in enumerate(active_modality):
        r = m.gen_modality_str(chars[k])
        active_cross[j] = list(r)
        canonical[j] = list(r) if r else [chars[k]]

    candidates: List[List[List[str]]] = []
    if len(active_modality) == 2 and experiment_type == "random_sample":
        char_map = {chars[0]: active_modality[0], chars[1]: active_modality[1]}
        for combo in two_modality_candidates(chars[0], chars[1]):
            a = [[] for _ in range(M)]
            for ch, streams in combo.items():
                a[char_map[ch]] = streams
            candidates.append(a)
    elif len(active_modality) > 1 and experiment_type == "test_single":
        if specific is not None:
            candidates.append(specific[1])
    else:
        candidates.append(canonical)
    return active_cross, candidates


def depth_combos(spec: ModelSpec, experiment_type: str) -> List[List[int]]:
    """train.py:279,352-358."""
    M = spec.modality_num
    if experiment_type in ("baseline_ic", "test_single"):
        return [[spec.layers_single_attn] * M]
    if experiment_type in ("baseline_ia", "baseline_ib"):
        return [[0] * M]
    return [list(c) for c in itertools.combinations_with_replacement(
        range(spec.layers_single_attn + 1), M)]


def subset_choices(spec: ModelSpec, experiment_type: str) -> List[Tuple[int, ...]]:
    """train.py:253-262: every subset of size >= 1 (>= 2 for baseline_ib)."""
    M = spec.modality_num
    lo = 2 if experiment_type == "baseline_ib" else 1
    out: List[Tuple[int, ...]] = []
    for i in range(lo, M + 1):
        out.extend(itertools.combinations(range(M), i))
    return out


def subset_configs(spec: ModelSpec, experiment_type: str, subset: Tuple[int, ...],
                   specific=None, quiet: bool = True) -> List[ActiveConfig]:
    """One subset's grid, depth combination major, topology minor: the
    configurations the sweep stacks (printing the candidates unless
    ``quiet``)."""
    active_cross, candidates = enumerate_subset_candidates(
        spec, experiment_type, subset, specific)
    if not quiet:
        print("Possible Active Cross: ", candidates)
    return [ActiveConfig(
        active_modality=list(subset),
        active_cross=[list(x) for x in active_cross],
        active_cross_output=[list(x) for x in a],
        active_single_attn_layer_num=list(l),
        active_self_attn_layer_num=spec.layers_self_attn,
        active_hybrid_attn_layer_num=spec.layers_cross_attn,
        active_dimension=spec.dimension,
        active_head_num=spec.num_heads,
        active_head_dim=spec.head_dim)
        for l in depth_combos(spec, experiment_type) for a in candidates]


def upload_eval_batches(loader, device) -> list:
    """A loader's batches on ``device`` once, for reuse across the sweep's
    subsets: ``(inputs, keep, labels)`` per batch, ``keep`` the host mask of
    real rows and ``labels`` their host labels."""
    out = []
    for b in loader:
        keep = np.asarray(b.valid) > 0
        labels = b.labels.cpu().numpy() if isinstance(b.labels, torch.Tensor) \
            else np.asarray(b.labels)
        out.append(([torch.as_tensor(x, device=device) for x in b.inputs], keep,
                    labels[keep]))
    return out


def missing_modality_sweep(
    trainer,
    valid_loader,
    test_loader,
    *,
    specific=None,
    max_cfg_chunk: int = 64,
    quiet: bool = False,
) -> Dict[Tuple[int, ...], Dict]:
    """Run the full sweep.  ``trainer`` is a :class:`..train.loop.Trainer`.

    For each modality subset: build the (depth x topology) candidate masks,
    stack them, evaluate all of them on every validation batch (the headers
    once a batch, the trunk over chunks of ``max_cfg_chunk``), pick the
    best on valid (the first of equals), re-evaluate it on test, and print
    the reference's per-subset block (train.py:376-404)."""
    spec = trainer.spec
    hp = trainer.hp
    dev = trainer.device
    M = spec.modality_num
    results: Dict[Tuple[int, ...], Dict] = {}

    # both splits go to the card once: every (subset, chunk) re-reads them
    device_batches = upload_eval_batches(valid_loader, dev)
    device_test = upload_eval_batches(test_loader, dev)
    full_flags = torch.ones(M, dtype=torch.float32, device=dev)

    def eval_single(masks, batches):
        dev_masks = masks.to(dev)
        preds = [trainer.eval_step(trainer.params, dev_masks, inputs, full_flags)
                 for inputs, _, _ in batches]
        keep = np.concatenate([k for _, k, _ in batches])
        return (torch.cat(preds).cpu().numpy()[keep],          # one readback
                np.concatenate([lab for _, _, lab in batches]))

    for subset in subset_choices(spec, hp.experiment_type):
        if not quiet:
            print([spec.modality_set[j] for j in subset], ": { ")
        cfgs = subset_configs(spec, hp.experiment_type, subset, specific, quiet)
        mask_list = [build_masks(spec, c) for c in cfgs]
        # pad the list to a chunk multiple by repeating the last
        # configuration, so every trunk pass has one shape
        n_real = len(mask_list)
        chunk = max_cfg_chunk
        if n_real % chunk and n_real > chunk:
            mask_list = mask_list + [mask_list[-1]] * (chunk - n_real % chunk)

        # every candidate on valid with full-modality flags: the reference
        # zero-fills nothing here (activate_modality covers all, train.py:370);
        # the masks do the work
        stacked = stack_masks(mask_list).to(dev)                  # one upload
        per_batch = [trainer.eval_step_sweep(trainer.params, stacked, inputs, full_flags,
                                             chunk=chunk)
                     for inputs, _, _ in device_batches]          # [n_cfg, B, ...]
        truth = np.concatenate([lab for _, _, lab in device_batches])
        keep = np.concatenate([k for _, k, _ in device_batches])
        all_preds = torch.cat(per_batch, dim=1).cpu().numpy()[:, keep]   # one readback
        accs = np.array([trainer._metric(all_preds[k], truth) for k in range(n_real)],
                        np.float64)

        best = int(np.argmax(accs))
        best_cfg = cfgs[best]
        if not quiet:
            print("best self atten layer number: ",
                  best_cfg.active_single_attn_layer_num,
                  best_cfg.active_cross_output,
                  "best validation accuracy: ", accs[best])

        test_preds, test_truths = eval_single(mask_list[best], device_test)
        test_acc = trainer._metric(test_preds, test_truths)
        entry = {"best_cfg": best_cfg, "valid_acc": float(accs[best]),
                 "test_acc": float(test_acc)}
        if hp.dataset == "mosei_senti":
            entry["metrics"] = eval_mosei_senti(test_preds, test_truths, True, quiet=quiet)
        elif hp.dataset == "mojupush":
            if not quiet:
                print("MSE: ", -test_acc)
        else:
            if not quiet:
                print("acc: ", test_acc)
        if not quiet:
            print("},")
        results[subset] = entry
    if not quiet:
        print("}")
    return results


def masking_inputs_sweep(trainer, test_loader, quiet: bool = False) -> Dict:
    """The baseline_ia alternative: keep the full network and zero-fill the
    inputs per subset, the empty set included (train.py:407-434)."""
    spec = trainer.spec
    M = spec.modality_num
    full_masks = build_masks(spec, full_active_config(spec))
    choices: List[Tuple[int, ...]] = [()]
    for i in range(1, M + 1):
        choices.extend(itertools.combinations(range(M), i))
    results = {}
    for subset in choices:
        if not quiet:
            print([spec.modality_set[j] for j in subset], ": { ")
        acc, preds, truths = trainer.evaluate(test_loader, full_masks, list(subset))
        if trainer.hp.dataset == "mosei_senti":
            results[subset] = eval_mosei_senti(preds, truths, True, quiet=quiet)
        else:
            results[subset] = {"acc": acc}
            if not quiet:
                print("acc: ", acc)
        if not quiet:
            print("},")
    if not quiet:
        print("}")
    return results
