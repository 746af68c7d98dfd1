"""Input pipelines: host batches (``loaders``), device-resident batches
(``device``) and the tokenizers."""

from .device import DeviceBatchIterator, materialize
from .loaders import ArrayDataset, Batch, BatchIterator

__all__ = ["ArrayDataset", "Batch", "BatchIterator", "DeviceBatchIterator", "materialize"]
