"""PyTorch + CUDA port of the elastic multimodal-transformer framework.

The JAX package ``multimodal_transformer_robustness_tpu`` beside it is the
reference; this package mirrors its layout and names (``ops/``, ``models/``,
``train/``, ``data/``, ``cli/``) and never imports JAX.  It serves
(``cli/realtime.py``), trains and evaluates (``train/loop.Trainer``: ``fit``)
the supernet, and runs the missing-modality sweep (``train/sweep.py``).
Every Pallas kernel on those paths is a hand-written CUDA kernel under
``csrc/``, built at first use by :mod:`._build`; on CPU tensors each kernel
wrapper runs its plain PyTorch version instead.  Entry points run on the
card unless the caller asks for ``device="cpu"``.
"""

from .config import (ActiveConfig, ModalityStr, ModelSpec, full_active_config,
                     gen_active_cross, gen_subnet)
from .masks import SupernetMasks, build_masks, stack_masks

__all__ = [
    "ActiveConfig",
    "ModalityStr",
    "ModelSpec",
    "full_active_config",
    "gen_active_cross",
    "gen_subnet",
    "SupernetMasks",
    "build_masks",
    "stack_masks",
]
