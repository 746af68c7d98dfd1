"""Masked linear: static-shape replacement of the reference's DynamicLinear.

Counterpart of ``multimodal_transformer_robustness_tpu/ops/linear.py``.  The
weight stays full size in torch's ``[out_features, in_features]`` layout; a
0/1 ``mask_in`` zeroes input columns and ``mask_out`` zeroes output units
(bias included), which equals slicing the weight.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def init_linear(gen: torch.Generator, dim_in: int, dim_out: int,
                init: str = "torch") -> dict:
    """``init='torch'``: nn.Linear's default, U(-1/sqrt(in), 1/sqrt(in)) for
    weight and bias.  ``init='xavier_zero'``: xavier-uniform weight, zero
    bias, as the reference's transformer layers use."""
    if init == "xavier_zero":
        bound = math.sqrt(6.0 / (dim_in + dim_out))
        w = torch.empty(dim_out, dim_in).uniform_(-bound, bound, generator=gen)
        b = torch.zeros(dim_out)
    else:
        bound = math.sqrt(1.0 / dim_in)
        w = torch.empty(dim_out, dim_in).uniform_(-bound, bound, generator=gen)
        b = torch.empty(dim_out).uniform_(-bound, bound, generator=gen)
    return {"w": w, "b": b}


def masked_linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                  mask_in: Optional[torch.Tensor] = None,
                  mask_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y = (x * mask_in) @ w.T + b``, then ``y * mask_out``."""
    if mask_in is not None:
        x = x * mask_in
    y = torch.matmul(x, w.t())
    if b is not None:
        y = y + b
    if mask_out is not None:
        y = y * mask_out
    return y
