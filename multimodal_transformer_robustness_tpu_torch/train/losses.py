"""Auxiliary losses.

Counterpart of ``multimodal_transformer_robustness_tpu/train/losses.py``.
``cmd``: the Central Moment Discrepancy domain regularizer of the
reference's ``src/utils.py:21-49`` (the reference builds it in
``train.py:54`` but never applies it; kept for training recipes).
"""

from __future__ import annotations

import torch


def _matchnorm(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.square(x1 - x2)))


def _scm(sx1: torch.Tensor, sx2: torch.Tensor, k: int) -> torch.Tensor:
    ss1 = torch.mean(torch.pow(sx1, k), dim=0)
    ss2 = torch.mean(torch.pow(sx2, k), dim=0)
    return _matchnorm(ss1, ss2)


def cmd(x1: torch.Tensor, x2: torch.Tensor, n_moments: int) -> torch.Tensor:
    """Central moment discrepancy between two batches of features [N, D]."""
    mx1 = torch.mean(x1, dim=0)
    mx2 = torch.mean(x2, dim=0)
    sx1 = x1 - mx1
    sx2 = x2 - mx2
    scms = _matchnorm(mx1, mx2)
    for i in range(n_moments - 1):
        scms = scms + _scm(sx1, sx2, i + 2)
    return scms
