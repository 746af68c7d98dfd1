"""Input pipelines: host batches (``loaders``), device-resident batches
(``device``) and the tokenizers."""

from .device import DeviceBatchIterator, materialize
from .loaders import ArrayDataset, Batch, BatchIterator, cast_float_inputs

__all__ = ["ArrayDataset", "Batch", "BatchIterator", "DeviceBatchIterator", "cast_float_inputs",
           "materialize"]
