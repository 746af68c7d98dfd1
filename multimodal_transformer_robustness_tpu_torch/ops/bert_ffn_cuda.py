"""K3: the frozen-BERT FFN block ``LN(x + fc2(gelu(fc1 x)))`` through a
hand-written CUDA kernel.

Counterpart of ``multimodal_transformer_robustness_tpu/ops/bert_ffn_pallas.py``
(``ffn_ln_block``; forward only, BERT is frozen).  On a CUDA tensor
:func:`ffn_ln_block` launches ``csrc/bert_ffn.cu``, which replaces the TPU
kernel ``bert_ffn_pallas._ffn_ln_kernel``; on a CPU tensor it runs the plain
version :func:`ffn_ln_block_plain`.  Weights come pre-transposed
(``w1t = fc1.weight.T``, ``w2t = fc2.weight.T``), made once at load time.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build
from .layernorm import masked_layer_norm


def ffn_ln_block_plain(x, w1t, b1, w2t, b2, ln_g, ln_b, *, eps: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel; exact-erf gelu, float32 centered
    LayerNorm moments."""
    h1 = F.gelu(torch.matmul(x, w1t) + b1, approximate="none")
    y = torch.matmul(h1, w2t) + b2
    return masked_layer_norm(x + y, ln_g, ln_b, eps=eps)


def ffn_ln_block(x: torch.Tensor, w1t: torch.Tensor, b1: torch.Tensor,
                 w2t: torch.Tensor, b2: torch.Tensor, ln_g: torch.Tensor,
                 ln_b: torch.Tensor, *, eps: float) -> torch.Tensor:
    """``LN(x + (gelu(x @ w1t + b1) @ w2t + b2))`` for ``x [..., h]``,
    ``w1t [h, F]``, ``w2t [F, h]``."""
    if x.device.type == "cpu":
        return ffn_ln_block_plain(x, w1t, b1, w2t, b2, ln_g, ln_b, eps=eps)
    dev = _build.device_of(x)
    h = x.shape[-1]
    ffn = w1t.shape[-1]
    rows = x.numel() // h
    _build.require(x, "x", tuple(x.shape), dev)
    _build.require(w1t, "w1t", (h, ffn), dev)
    _build.require(b1, "b1", (ffn,), dev)
    _build.require(w2t, "w2t", (ffn, h), dev)
    for name, t in (("b2", b2), ("ln_g", ln_g), ("ln_b", ln_b)):
        _build.require(t, name, (h,), dev)
    lib = _build.load_library()
    hidden = torch.empty(rows, ffn, dtype=torch.float32, device=dev)
    resid_sum = torch.empty(rows, h, dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    err = lib.mmtr_ffn_ln_fwd(
        x.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(), b2.data_ptr(),
        ln_g.data_ptr(), ln_b.data_ptr(), hidden.data_ptr(), resid_sum.data_ptr(),
        out.data_ptr(), rows, h, ffn, eps, _build.stream_ptr(dev))
    _build.check(err, "ffn_ln_block kernel")
    ffn_ln_block.launches += 1
    return out


ffn_ln_block.launches = 0
