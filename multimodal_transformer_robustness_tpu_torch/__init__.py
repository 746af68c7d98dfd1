"""PyTorch + CUDA port of the elastic multimodal-transformer framework.

The JAX package ``multimodal_transformer_robustness_tpu`` beside it is the
reference; this package mirrors its layout and names (``ops/``, ``models/``,
``cli/``) and never imports JAX.  Every Pallas kernel on the ported path is a
hand-written CUDA kernel under ``csrc/``, built at first use by
:mod:`._build`; on CPU tensors each kernel wrapper runs its plain PyTorch
version instead.
"""

from .config import ActiveConfig, ModalityStr, ModelSpec, full_active_config
from .masks import SupernetMasks, build_masks

__all__ = [
    "ActiveConfig",
    "ModalityStr",
    "ModelSpec",
    "full_active_config",
    "SupernetMasks",
    "build_masks",
]
