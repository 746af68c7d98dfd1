"""Host-side input pipeline: fixed-shape numpy batches.

Counterpart of ``multimodal_transformer_robustness_tpu/data/loaders.py``
(without multi-host ``process_shard``, which waits for the ``parallel``
port): every batch of a split has the same array shapes, the last short
batch padded up to ``batch_size`` with a validity mask.  Numpy arrays
(or, after :func:`cast_float_inputs` to bf16, which numpy has no type for,
CPU torch tensors); the Trainer moves each batch to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class Batch:
    inputs: List[np.ndarray]       # one array per modality, fixed shapes
    labels: np.ndarray
    valid: np.ndarray              # [B] 1.0 for real rows, 0.0 for padding


class ArrayDataset:
    """A dataset fully materialized as per-modality arrays (first axis N)."""

    def __init__(self, inputs: Sequence[np.ndarray], labels: np.ndarray,
                 dims: Sequence[int], seq_len: int):
        self.inputs = [np.asarray(x) for x in inputs]
        self.labels = np.asarray(labels)
        self._dims = list(dims)
        self._seq_len = seq_len
        if not all(len(x) == len(self.labels) for x in self.inputs):
            raise ValueError("every modality needs one row per label")

    def __len__(self) -> int:
        return len(self.labels)

    def get_dim(self) -> List[int]:
        return list(self._dims)

    def get_seq_len(self) -> int:
        return self._seq_len

    def get_n_modalities(self) -> int:
        return len(self.inputs)


def is_float_array(x) -> bool:
    """A float modality array: a numpy float array or a float tensor."""
    if isinstance(x, torch.Tensor):
        return x.is_floating_point()
    return np.issubdtype(np.asarray(x).dtype, np.floating)


def cast_float_inputs(dataset, dtype) -> None:
    """Store a dataset's float modality arrays in ``dtype`` (in place), as
    the JAX package's ``cast_float_inputs``: under the bf16 compute policy
    the model's boundary cast is the first op to touch float inputs, so a
    feed stored in bf16 gives the same bits as a float32 one, at half the
    bytes to upload.  bf16 (``"bfloat16"`` or ``torch.bfloat16``) is stored
    as CPU torch tensors (numpy has no bf16); ``"float32"`` as numpy.
    Integer inputs (token stacks) and labels are untouched.  Takes
    ``ArrayDataset``s and ``CachedTextDataset`` wrappers (the wrapper's
    feature store and its base's float arrays)."""
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}.get(dtype, dtype)

    def cast(x):
        if not is_float_array(x):
            return x
        if dt == torch.float32:
            return np.asarray(x, np.float32)
        return torch.as_tensor(np.asarray(x, np.float32) if not isinstance(x, torch.Tensor)
                               else x).to(dt)

    feats = getattr(dataset, "features", None)
    if feats is not None:
        dataset.features = cast(feats)
    base = getattr(dataset, "base", dataset)
    if hasattr(base, "inputs"):
        base.inputs = [cast(x) for x in base.inputs]


class BatchIterator:
    """Deterministic, seeded batching with tail padding to a fixed size."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_tail: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_tail = drop_tail
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """The per-epoch order is a function of ``seed + epoch``, so a fresh
        iterator continues a run's data order exactly."""
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_tail:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Batch]:
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
            yield self._gather(idx, valid)

    def _gather(self, idx: np.ndarray, valid: np.ndarray) -> Batch:
        ds = self.dataset
        if hasattr(ds, "gather"):
            inputs, labels = ds.gather(idx)
        elif (len(idx) > 1 and idx[0] + len(idx) - 1 == idx[-1]
              and (np.diff(idx) == 1).all()):
            # a contiguous range (unshuffled): views, not fancy-index copies
            sl = slice(int(idx[0]), int(idx[0]) + len(idx))
            inputs = [x[sl] for x in ds.inputs]
            labels = ds.labels[sl]
        else:
            inputs = [x[idx] for x in ds.inputs]
            labels = ds.labels[idx]
        return Batch(inputs=inputs, labels=labels, valid=valid)
