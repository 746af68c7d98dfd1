"""The reference's optimizers: ``getattr(torch.optim, name)(params, lr=lr)``.

Counterpart of ``multimodal_transformer_robustness_tpu/train/optim.py``,
whose optax factories pin every hyperparameter beyond the learning rate to
torch's defaults.  Here the same names map to the ``torch.optim`` classes
themselves, constructed with the learning rate alone, so every other
hyperparameter is torch's default by construction (NAdam is torch's NAdam).
"""

from __future__ import annotations

import torch

TORCH_DEFAULT_OPTIMIZERS = {
    name: getattr(torch.optim, name)
    for name in ("Adam", "AdamW", "SGD", "RMSprop", "Adagrad", "Adadelta",
                 "Adamax", "NAdam", "RAdam")
}


def make_optimizer(name: str, params, lr: float) -> torch.optim.Optimizer:
    if name not in TORCH_DEFAULT_OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; known: "
                         f"{sorted(TORCH_DEFAULT_OPTIMIZERS)}")
    return TORCH_DEFAULT_OPTIMIZERS[name](params, lr=lr)
