"""Device-resident input pipeline: the whole dataset in the card's memory.

Counterpart of ``multimodal_transformer_robustness_tpu/data/device.py``.
The host ``BatchIterator`` gathers every batch with numpy fancy indexing
and the Trainer uploads it from pageable memory, a step's largest host cost
at the training shapes (PERF.md §5).  :class:`DeviceBatchIterator` uploads
the dataset once and gathers each batch on the card; the host contributes
one [B] index vector a step.  It is a drop-in for
:class:`.loaders.BatchIterator`: the same ``Batch`` contract, the same
seeded epoch order and the same tail padding, so ``Trainer.train_epoch``,
``evaluate`` and ``fit`` take it unchanged (``torch.as_tensor`` of a tensor
already on the card is a no-op).

One device by design; ``store_dtype="bfloat16"`` waits for the port's
bf16 compute policy (ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .. import _build
from .loaders import ArrayDataset, Batch, BatchIterator


def _is_text_stack(x) -> bool:
    """A [3, N, L] stacked integer token array (the MOSEI text layout):
    gathered on axis 1; every other input on axis 0."""
    return (getattr(x, "ndim", 0) == 3 and x.shape[0] == 3
            and np.issubdtype(np.asarray(x).dtype, np.integer))


def materialize(dataset, chunk: int = 512):
    """Any gather-style dataset as whole per-modality host arrays, in
    order: ``(inputs, labels)``."""
    if isinstance(dataset, ArrayDataset):
        return [np.asarray(x) for x in dataset.inputs], np.asarray(dataset.labels)
    parts: List[List[np.ndarray]] = []
    labels = []
    for b in BatchIterator(dataset, chunk, shuffle=False):
        keep = b.valid > 0
        row = []
        for x in b.inputs:
            x = np.asarray(x)
            row.append(x[:, keep] if _is_text_stack(x) else x[keep])
        parts.append(row)
        labels.append(np.asarray(b.labels)[keep])
    inputs = []
    for i in range(len(parts[0])):
        axis = 1 if _is_text_stack(parts[0][i]) else 0
        inputs.append(np.concatenate([p[i] for p in parts], axis=axis))
    return inputs, np.concatenate(labels)


class DeviceBatchIterator:
    """Seeded, tail-padded batching with the dataset resident on ``device``
    and each batch gathered there.  Yields :class:`Batch` whose ``inputs``
    and ``labels`` are tensors on the device; ``valid`` stays numpy (the
    host epoch loop reduces it)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_tail: bool = False,
                 store_dtype: Optional[str] = None, device="cuda"):
        if store_dtype not in (None, "float32"):
            raise NotImplementedError("store_dtype other than float32 is not ported "
                                      "yet: ROADMAP Queue 1, 'the bf16 compute policy'")
        self.device = _build.resolve_device(device)
        inputs, labels = materialize(dataset)
        self._text = [_is_text_stack(x) for x in inputs]
        self.inputs = [torch.as_tensor(x, device=self.device) for x in inputs]
        self.labels = torch.as_tensor(labels, device=self.device)
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_tail = drop_tail
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_tail:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        """The same exact-resume contract as ``BatchIterator.set_epoch``."""
        self._epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        self._epoch += 1
        bs = self.batch_size
        stop = (n // bs) * bs if self.drop_tail else n
        for start in range(0, stop, bs):
            idx = order[start:start + bs]
            valid = np.ones((bs,), np.float32)
            if len(idx) < bs:
                valid[len(idx):] = 0.0
                idx = np.concatenate([idx, np.repeat(idx[-1:], bs - len(idx))])
            idx = torch.as_tensor(idx, device=self.device)
            inputs = [x.index_select(1 if text else 0, idx)
                      for x, text in zip(self.inputs, self._text)]
            yield Batch(inputs=inputs, labels=self.labels.index_select(0, idx), valid=valid)
