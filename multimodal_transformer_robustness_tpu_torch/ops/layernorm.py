"""Mask-aware LayerNorm.

Counterpart of ``multimodal_transformer_robustness_tpu/ops/layernorm.py``.
Moments are taken in float32 over the active channels only (centered
two-pass variance, biased, as torch), and the output is zero at inactive
channels.
"""

from __future__ import annotations

from typing import Optional

import torch

_EPS = 1e-5  # torch nn.LayerNorm default


def masked_layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                      mask: Optional[torch.Tensor] = None,
                      eps: float = _EPS) -> torch.Tensor:
    """LayerNorm over the last axis; with ``mask``, statistics cover only
    channels where it is 1.  An all-zero mask gives zeros, not NaN."""
    x32 = x.float()
    if mask is None:
        mu = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mu).square().mean(dim=-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + eps) * gamma + beta
        return y.to(x.dtype)
    m = mask.float()
    n = torch.clamp(m.sum(dim=-1, keepdim=True), min=1.0)
    mu = (x32 * m).sum(dim=-1, keepdim=True) / n
    diff = (x32 - mu) * m
    var = diff.square().sum(dim=-1, keepdim=True) / n
    y = (x32 - mu) * torch.rsqrt(var + eps) * gamma + beta
    return (y * m).to(x.dtype)
