"""Sinusoidal positional embedding with the reference's padding rule,
generalized to channel masks.

Counterpart of ``multimodal_transformer_robustness_tpu/ops/positional.py``.
Column t gets position t+1 unless the "token" there equals the padding index
0, in which case position 0 and an all-zero row.  The callers pass feature 0
of the activation as the token proxy.  Under a channel mask each active
channel's entry is computed from its rank among the active channels, which
equals building the table for the compacted width.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def make_positions(feat0: torch.Tensor, padding_idx: int = 0) -> torch.Tensor:
    """``feat0`` [B, T] proxy token values -> int32 positions: t+1, or 0
    where ``feat0 == padding_idx``."""
    t = feat0.shape[-1]
    pos = torch.arange(1, t + 1, dtype=torch.int32, device=feat0.device)
    return torch.where(feat0 != padding_idx, pos, torch.zeros_like(pos))


def sinusoidal_pe(positions: torch.Tensor, n_channels: int,
                  channel_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Embedding [B, T, n_channels] for integer ``positions`` [B, T]."""
    dev = positions.device
    if channel_mask is None:
        rank = torch.arange(n_channels, dtype=torch.float32, device=dev)
        n_act = torch.tensor(float(n_channels), device=dev)
        mask = None
    else:
        m = channel_mask.float()
        rank = torch.cumsum(m, dim=0) - 1.0
        n_act = torch.clamp(m.sum(), min=2.0)
        mask = m
    half_dim = torch.floor(n_act / 2.0)
    denom = torch.clamp(half_dim - 1.0, min=1.0)
    inv_freq = torch.exp(torch.floor(rank / 2.0) * (-math.log(10000.0) / denom))
    angle = positions.float()[..., None] * inv_freq
    even = torch.remainder(torch.floor(rank), 2.0) == 0.0
    pe = torch.where(even, torch.sin(angle), torch.cos(angle))
    pe = pe * (positions != 0).float()[..., None]
    if mask is not None:
        pe = pe * mask
    return pe
