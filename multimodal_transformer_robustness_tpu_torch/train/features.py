"""Frozen-BERT text-feature precomputation (the cached-text pipeline).

Counterpart of ``multimodal_transformer_robustness_tpu/train/features.py``.
The frozen BERT has no train-mode dropout, so its output is a pure function
of the tokens: this module runs it once per dataset and feeds the model
float features ``[N, L, h]`` in the token stack's slot.
``models/headers.header_apply`` dispatches on the input dtype (an integer
stack runs the BERT online, float input is taken as its features), so the
same model serves both pipelines, and a training step on features equals
the step on tokens.

The extractor runs on the card through the port's kernels (K2 + K3, or K2 +
K4 when the frozen weights are int8-quantized) unless the caller asks for
``device="cpu"``; ``cuda`` without a card raises.

Missing-modality parity: the reference's evaluate zero-fills the raw token
tensor and BERT still runs on the zeros, giving a non-zero feature row; the
cached pipeline keeps ``BERT(zero tokens)`` as :attr:`CachedTextDataset.zero_row`
(``zero_fill_rows``) for ``Trainer.evaluate`` to substitute.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import _build
from ..data.loaders import BatchIterator, is_float_array
from ..models import bert as bert_mod
from ..models.headers import bert_text_features
from ..models.mult import COMPUTE_DTYPES, cast_tree, to_device


def find_text_slot(inputs: List[np.ndarray]) -> Optional[int]:
    """Index of the stacked-token text input ([3, B, L] integer array), or
    None if the batch carries no tokenized text modality."""
    for i, x in enumerate(inputs):
        if getattr(x, "ndim", 0) == 3 and x.shape[0] == 3 and not is_float_array(x):
            return i
    return None


def _extractor(frozen: dict, bert_cfg: Optional[bert_mod.BertConfig],
               compute_dtype: str, device):
    """``[3, B, L]`` token stack (numpy) -> ``[B, L, h]`` float32 features
    (numpy), the frozen BERT on ``device`` in ``compute_dtype``, which must
    be the model spec's: the online pipeline runs the BERT on the
    boundary-cast weights, so bf16 features are computed from the bf16
    weights, and their float32 storage is lossless (the boundary cast
    gives the online activations back exactly)."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise NotImplementedError(f"compute_dtype {compute_dtype!r} is not ported "
                                  "(float32 and bfloat16 are): ROADMAP Queue 2, 'bf16'")
    dev = _build.resolve_device(device)
    if frozen["bert"]["word_emb"].device != dev:
        frozen = to_device(frozen, dev)
    frozen = cast_tree(frozen, COMPUTE_DTYPES[compute_dtype])

    def run(text: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            feats = bert_text_features(frozen, bert_cfg,
                                       torch.as_tensor(np.asarray(text), device=dev))
        return feats.float().cpu().numpy()

    return run


def precompute_text_features(frozen: dict,
                             bert_cfg: Optional[bert_mod.BertConfig],
                             text: np.ndarray, batch_size: int = 256,
                             compute_dtype: str = "float32",
                             device="cuda") -> np.ndarray:
    """[3, N, L] int token stack -> [N, L, h] float32 frozen-BERT features.

    Chunked, so a dataset of any size fits on the card; when N exceeds the
    chunk, the tail chunk is padded to ``batch_size`` by repeating its last
    row (one shape for every chunk) and the pad rows are dropped."""
    run = _extractor(frozen, bert_cfg, compute_dtype, device)
    n = text.shape[1]
    out = []
    for start in range(0, n, batch_size):
        chunk = text[:, start:start + batch_size]
        pad = batch_size - chunk.shape[1]
        if pad and n > batch_size:
            chunk = np.concatenate([chunk, np.repeat(chunk[:, -1:], pad, axis=1)], axis=1)
        feats = run(chunk)
        out.append(feats[:chunk.shape[1] - pad] if pad and n > batch_size else feats)
    return np.concatenate(out, axis=0)


def zero_token_features(frozen: dict, bert_cfg: Optional[bert_mod.BertConfig],
                        seq_len: int, compute_dtype: str = "float32",
                        device="cuda") -> np.ndarray:
    """[L, h] features of an all-zero token stack: what a zero-filled text
    modality gives in the online pipeline."""
    run = _extractor(frozen, bert_cfg, compute_dtype, device)
    return run(np.zeros((3, 1, seq_len), np.int64))[0]


class CachedTextDataset:
    """Wraps a dataset whose batches hold a [3, ·, L] token stack and serves
    precomputed [·, L, h] frozen-BERT features in that slot instead.

    Works for ``gather``-style datasets and for ``ArrayDataset``; the rest of
    the dataset's surface (``get_dim`` / ``get_seq_len`` / ...) delegates to
    the base."""

    def __init__(self, base, frozen: dict,
                 bert_cfg: Optional[bert_mod.BertConfig] = None,
                 batch_size: int = 256, compute_dtype: str = "float32",
                 device="cuda"):
        self.base = base
        self.text_slot: Optional[int] = None
        run = _extractor(frozen, bert_cfg, compute_dtype, device)
        feats: List[np.ndarray] = []
        L = None
        # deterministic order, one batch shape; the pad rows are dropped
        for batch in BatchIterator(base, batch_size, shuffle=False):
            if self.text_slot is None:
                self.text_slot = find_text_slot(batch.inputs)
                if self.text_slot is None:
                    raise ValueError("CachedTextDataset: no [3, B, L] integer text "
                                     "input found")
            text = np.asarray(batch.inputs[self.text_slot])
            L = text.shape[-1]
            feats.append(run(text)[batch.valid > 0])
        self.features = np.concatenate(feats, axis=0)  # [N, L, h]
        # [L, h], as zero_token_features computes it
        self.zero_row = run(np.zeros((3, 1, L), np.int64))[0]

    def __len__(self) -> int:
        return len(self.base)

    def __getattr__(self, name):
        if name == "base":  # no recursion before __init__ sets it
            raise AttributeError(name)
        return getattr(self.base, name)

    def gather(self, idx: np.ndarray) -> Tuple[List[np.ndarray], np.ndarray]:
        if hasattr(self.base, "gather"):
            inputs, labels = self.base.gather(idx)
        else:
            inputs = [x[idx] for x in self.base.inputs]
            labels = self.base.labels[idx]
        inputs = list(inputs)
        inputs[self.text_slot] = self.features[idx]
        return inputs, labels

    def zero_fill_rows(self) -> dict:
        """``{text slot: zero_row}``, for ``Trainer.evaluate`` to substitute
        where the text modality is dropped."""
        return {self.text_slot: self.zero_row}
