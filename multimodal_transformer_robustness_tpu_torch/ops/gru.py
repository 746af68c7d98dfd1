"""GRU with ``torch.nn.GRU`` semantics, in torch-layout weights.

Counterpart of ``multimodal_transformer_robustness_tpu/ops/gru.py``: the
straightforward time loop that kernel K1 (:mod:`.bigru_cuda`) is held
against.  Gate order (r, z, n) and equations follow torch exactly:

    r = sigmoid(x W_ir + b_ir + h W_hr + b_hr)
    z = sigmoid(x W_iz + b_iz + h W_hz + b_hz)
    n = tanh(  x W_in + b_in + r * (h W_hn + b_hn))
    h' = (1 - z) * n + z * h
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def init_gru(gen: torch.Generator, input_dim: int, hidden_dim: int) -> dict:
    """torch's default U(-1/sqrt(H), 1/sqrt(H)) for every tensor."""
    k = math.sqrt(1.0 / hidden_dim)

    def u(*shape):
        return torch.empty(*shape).uniform_(-k, k, generator=gen)

    return {"w_ih": u(3 * hidden_dim, input_dim), "w_hh": u(3 * hidden_dim, hidden_dim),
            "b_ih": u(3 * hidden_dim), "b_hh": u(3 * hidden_dim)}


def gru_forward(params: dict, x: torch.Tensor,
                reverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, in] -> (outputs [B, T, H], final hidden [B, H]).
    ``reverse=True`` runs t = T-1 .. 0, torch's backward direction."""
    h_dim = params["w_hh"].shape[1]
    b, t_len = x.shape[0], x.shape[1]
    gi = torch.matmul(x, params["w_ih"].t()) + params["b_ih"]      # [B, T, 3H]
    h = torch.zeros(b, h_dim, dtype=x.dtype, device=x.device)
    outs = [None] * t_len
    for t in (range(t_len - 1, -1, -1) if reverse else range(t_len)):
        gh = torch.matmul(h, params["w_hh"].t()) + params["b_hh"]
        ir, iz, in_ = gi[:, t].split(h_dim, dim=-1)
        hr, hz, hn = gh.split(h_dim, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(in_ + r * hn)
        h = (1.0 - z) * n + z * h
        outs[t] = h
    return torch.stack(outs, dim=1), h


def init_bigru(gen: torch.Generator, input_dim: int, hidden_dim: int) -> dict:
    """Bidirectional single-layer GRU, ``hidden_dim`` per direction."""
    return {"fwd": init_gru(gen, input_dim, hidden_dim),
            "bwd": init_gru(gen, input_dim, hidden_dim)}


def bigru_forward(params: dict, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(outputs [B, T, 2H] fwd || bwd, final hidden [B, 2H]): forward final
    after t=T-1, backward final after t=0, as ``torch.cat((h[0], h[1]), 1)``."""
    out_f, h_f = gru_forward(params["fwd"], x)
    out_b, h_b = gru_forward(params["bwd"], x, reverse=True)
    return torch.cat([out_f, out_b], dim=-1), torch.cat([h_f, h_b], dim=-1)
