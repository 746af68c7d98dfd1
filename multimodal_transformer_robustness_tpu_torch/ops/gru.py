"""GRU with ``torch.nn.GRU`` semantics, in torch-layout weights.

Counterpart of ``multimodal_transformer_robustness_tpu/ops/gru.py``.  Gate
order (r, z, n) and equations follow torch exactly:

    r = sigmoid(x W_ir + b_ir + h W_hr + b_hr)
    z = sigmoid(x W_iz + b_iz + h W_hz + b_hz)
    n = tanh(  x W_in + b_in + r * (h W_hn + b_hn))
    h' = (1 - z) * n + z * h

As in the JAX package, the input-side projections of all time steps are
one product up front, and the sequential part runs behind
:func:`gru_recurrence` over pre-split gates ``[G, T, N, H]``: on CUDA
tensors kernel K7 (``ops/gru_cuda.py``, forward and backward), on CPU
tensors its plain version, the time loop :func:`gru_recurrence_plain`.
:func:`bigru_forward` runs both directions in one ``G = 2`` call.  The
models' headers do not come here: they take K1 (``ops/bigru_cuda.py``), as
the JAX package's headers do on a TPU.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .gru_cuda import GruRecurrence, gru_recurrence_plain  # noqa: F401  (K7f's plain version)


def init_gru(gen: torch.Generator, input_dim: int, hidden_dim: int) -> dict:
    """torch's default U(-1/sqrt(H), 1/sqrt(H)) for every tensor."""
    k = math.sqrt(1.0 / hidden_dim)

    def u(*shape):
        return torch.empty(*shape).uniform_(-k, k, generator=gen)

    return {"w_ih": u(3 * hidden_dim, input_dim), "w_hh": u(3 * hidden_dim, hidden_dim),
            "b_ih": u(3 * hidden_dim), "b_hh": u(3 * hidden_dim)}


def gru_recurrence(gi_r, gi_z, gi_n, wr, wz, wn, br, bz, bn) -> torch.Tensor:
    """The ``[G, T, N, H]`` recurrence of ``gru_pallas.gru_recurrence_pallas``
    (per-gate input projections, transposed recurrent weights ``[G, H, H]``,
    recurrent biases ``[G, H]``; h0 = 0) -> hidden states ``[G, T, N, H]``,
    differentiable in every argument.  The device decides: CUDA tensors
    launch K7f (backward K7b), CPU tensors run the plain versions.  All
    nine float32, or all nine bf16 (the TPU kernels at bf16 operands:
    ``ops/gru_cuda.py``)."""
    args = (gi_r, gi_z, gi_n, wr, wz, wn, br, bz, bn)
    dtypes = {a.dtype for a in args}
    if dtypes not in ({torch.float32}, {torch.bfloat16}):
        raise ValueError(f"gru_recurrence takes nine float32 or nine bfloat16 tensors, "
                         f"got {sorted(map(str, dtypes))}")
    return GruRecurrence.apply(*(a.contiguous() for a in args))


def _gate_views(w_hh: torch.Tensor, b_hh: torch.Tensor):
    """w_hh [..., 3H, H] -> per-gate transposed weights [..., H, H] (r, z, n)
    and biases [..., H]."""
    h = w_hh.shape[-1]
    wt = w_hh.reshape(*w_hh.shape[:-2], 3, h, h).transpose(-1, -2)  # h @ W^T: [in, out]
    b3 = b_hh.reshape(*b_hh.shape[:-1], 3, h)
    return (wt[..., 0, :, :], wt[..., 1, :, :], wt[..., 2, :, :],
            b3[..., 0, :], b3[..., 1, :], b3[..., 2, :])


def _gi_gates(gi: torch.Tensor, h: int):
    """gi [..., T, 3H] -> three [..., T, H] per-gate arrays."""
    g3 = gi.reshape(*gi.shape[:-1], 3, h)
    return g3[..., 0, :], g3[..., 1, :], g3[..., 2, :]


def gru_forward(params: dict, x: torch.Tensor,
                reverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, in] -> (outputs [B, T, H], final hidden [B, H]).
    ``reverse=True`` runs t = T-1 .. 0, torch's backward direction: its final
    hidden is the state after t=0, and outputs[t] the state at time t."""
    h = params["w_hh"].shape[1]
    gi = torch.matmul(x, params["w_ih"].t()) + params["b_ih"]      # [B, T, 3H]
    if reverse:
        gi = gi.flip(1)
    gates = [a.transpose(0, 1)[None] for a in _gi_gates(gi, h)]   # [1, T, B, H]
    hs = gru_recurrence(*gates, *_gate_views(params["w_hh"][None], params["b_hh"][None]))
    outs = hs[0].transpose(0, 1)                                     # [B, T, H]
    return (outs.flip(1) if reverse else outs), hs[0, -1]


def init_bigru(gen: torch.Generator, input_dim: int, hidden_dim: int) -> dict:
    """Bidirectional single-layer GRU, ``hidden_dim`` per direction."""
    return {"fwd": init_gru(gen, input_dim, hidden_dim),
            "bwd": init_gru(gen, input_dim, hidden_dim)}


def bigru_forward(params: dict, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(outputs [B, T, 2H] fwd || bwd, final hidden [B, 2H]): forward final
    after t=T-1, backward final after t=0, as ``torch.cat((h[0], h[1]), 1)``.
    Both directions run in one ``G = 2`` recurrence: the backward one is the
    forward recurrence over the time-flipped sequence."""
    h = params["fwd"]["w_hh"].shape[1]
    gi_f = torch.matmul(x, params["fwd"]["w_ih"].t()) + params["fwd"]["b_ih"]
    gi_b = torch.matmul(x.flip(1), params["bwd"]["w_ih"].t()) + params["bwd"]["b_ih"]
    gi = torch.stack([gi_f, gi_b])                                   # [2, B, T, 3H]
    gates = [a.transpose(1, 2) for a in _gi_gates(gi, h)]            # [2, T, B, H]
    w_hh = torch.stack([params["fwd"]["w_hh"], params["bwd"]["w_hh"]])
    b_hh = torch.stack([params["fwd"]["b_hh"], params["bwd"]["b_hh"]])
    hs = gru_recurrence(*gates, *_gate_views(w_hh, b_hh))           # [2, T, B, H]
    out_f = hs[0].transpose(0, 1)
    out_b = hs[1].transpose(0, 1).flip(1)                            # un-flip backward
    return torch.cat([out_f, out_b], dim=-1), torch.cat([hs[0, -1], hs[1, -1]], dim=-1)
