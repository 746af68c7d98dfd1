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

One device by design.  ``store_dtype="bfloat16"`` stores the float
modalities in bf16 on the card, half the bytes: under the bf16 compute
policy the model's boundary cast makes it give the same bits as a float32
store.  A dataset already stored in bf16 (``loaders.cast_float_inputs``)
is uploaded as it is.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .. import _build
from .loaders import ArrayDataset, Batch, BatchIterator, is_float_array


def _is_text_stack(x) -> bool:
    """A [3, N, L] stacked integer token array (the MOSEI text layout):
    gathered on axis 1; every other input on axis 0."""
    return getattr(x, "ndim", 0) == 3 and x.shape[0] == 3 and not is_float_array(x)


def _host(x):
    """A host array as numpy, or as the CPU tensor it is (bf16)."""
    return x if isinstance(x, torch.Tensor) else np.asarray(x)


def materialize(dataset, chunk: int = 512):
    """Any gather-style dataset as whole per-modality host arrays, in
    order: ``(inputs, labels)``."""
    if isinstance(dataset, ArrayDataset):
        return [_host(x) for x in dataset.inputs], np.asarray(dataset.labels)
    parts: List[List[np.ndarray]] = []
    labels = []
    for b in BatchIterator(dataset, chunk, shuffle=False):
        keep = b.valid > 0
        row = []
        for x in b.inputs:
            x = _host(x)
            row.append(x[:, keep] if _is_text_stack(x) else x[keep])
        parts.append(row)
        labels.append(np.asarray(b.labels)[keep])
    inputs = []
    for i in range(len(parts[0])):
        axis = 1 if _is_text_stack(parts[0][i]) else 0
        cat = torch.cat if isinstance(parts[0][i], torch.Tensor) else np.concatenate
        inputs.append(cat([p[i] for p in parts], axis))
    return inputs, np.concatenate(labels)


class DeviceBatchIterator:
    """Seeded, tail-padded batching with the dataset resident on ``device``
    and each batch gathered there.  Yields :class:`Batch` whose ``inputs``
    and ``labels`` are tensors on the device; ``valid`` stays numpy (the
    host epoch loop reduces it)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_tail: bool = False,
                 store_dtype: Optional[str] = None, device="cuda"):
        stores = {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16}
        if store_dtype not in stores:
            raise NotImplementedError(f"store_dtype {store_dtype!r} is not ported (float32 "
                                      "and bfloat16 are): ROADMAP Queue 2, 'bf16'")
        self.device = _build.resolve_device(device)
        inputs, labels = materialize(dataset)
        self._text = [_is_text_stack(x) for x in inputs]
        sd = stores[store_dtype]
        self.inputs = [torch.as_tensor(x, device=self.device) for x in inputs]
        if sd is not None:
            self.inputs = [x.to(sd) if x.is_floating_point() else x for x in self.inputs]
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
