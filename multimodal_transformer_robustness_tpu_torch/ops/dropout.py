"""Dropout with inverted scaling, ``torch.nn.functional.dropout`` semantics.

Counterpart of ``multimodal_transformer_robustness_tpu/ops/dropout.py``:
zero with probability ``rate``, scale survivors by ``1 / (1 - rate)``, the
identity in eval mode or at rate 0.  Draws come from an explicit
``torch.Generator`` on the tensor's device; they differ from ``jax.random``'s
for the same seed, so the two packages agree in distribution, not in draws.
"""

from __future__ import annotations

from typing import Optional

import torch


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    if not train or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("training-mode dropout needs a generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                            device=x.device))
