"""The reference's optimizers: ``getattr(torch.optim, name)(params, lr=lr)``.

Counterpart of ``multimodal_transformer_robustness_tpu/train/optim.py``,
whose optax factories pin every hyperparameter beyond the learning rate to
torch's defaults.  Here the same names map to the ``torch.optim`` classes
themselves, constructed with the learning rate alone, so every other
hyperparameter is torch's default by construction (NAdam is torch's NAdam).
:func:`clip_by_global_norm_` is optax's ``clip_by_global_norm``, the clip
the JAX package chains before its optimizer.
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


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm(max_norm)``, in place on ``grads`` (a
    list of tensors): the global norm ``sqrt(sum |g|^2)`` in float32; no
    change when ``norm < max_norm``, else every ``g = (g / norm) * max_norm``.
    torch's ``clip_grad_norm_`` scales by ``max_norm / (norm + 1e-6)``
    instead, 5e-4 relative apart at ``norm = 2e-3``, ``max_norm = 1e-3``.
    No host readback: where the norm is below the limit both factors are 1.
    Returns the norm (a device scalar)."""
    if not grads:
        return torch.zeros(())
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, torch.full_like(norm, max_norm)))
    return norm
