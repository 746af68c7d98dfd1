"""Elastic multi-head attention, static-shape and mask-parameterized.

Counterpart of ``multimodal_transformer_robustness_tpu/ops/attention.py``.
The packed in-projection weight is ``[3, H, Dh, E_in]``; the active
configuration zeroes projected q/k/v outside ``head_mask x head_dim_mask``
(bias included), which equals slicing the prefix slab.  q is scaled by
``active_head_dim ** -0.5``; the softmax is float32.  Channel masks apply in
self-attention only and re-mask the output.  Layout is batch-major
``[B, T, C]``.

After the RNN headers every stream is one step, so the trunk runs attention
at Tq == Tk == 1, where the softmax over one key is exactly 1: the T==1
path reduces to the value and out projections, with the attention dropout
drawn on the constant weights ``ones [B, H, 1, 1]`` as the JAX package
draws it.  On the T>1 path the dropout follows the softmax.

``impl="flash"`` runs the T>1 path through the flash-attention kernels
(``attention_cuda.flash_attention``: K5f forward, K5b or K5dq / K5dkv
backward), with the future mask generated from its rule (``causal_offset``)
instead of an additive bias, and, in train mode at a nonzero rate, the
in-softmax position-hash dropout seeded per (batch, head) from the call's
generator.  At bf16, q is scaled in bf16, the kernels keep their softmax
float32 and round the attention output once, and the out-projection sums
in float32, adds its bias and rounds once, as the JAX flash branch does.

bf16 activations and weights (the bf16 compute policy) round where the
JAX package rounds: each projection (and the logits) sums in float32,
adds its bias in float32 and is rounded once; the softmax is float32,
its weights rounded; ``weights @ v`` sums in float32 and is rounded.  The
products of bf16 values are taken as float32 matmuls of the upcast
operands (exact products, float32 sums); under float32 the upcasts and
casts are no-ops.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .attention_cuda import flash_attention
from .dropout import dropout


def future_mask(tq: int, tk: int, device=None) -> torch.Tensor:
    """Additive [tq, tk] mask: -inf where ``col - row >= 1 + |tk - tq|``."""
    rows = torch.arange(tq, device=device)[:, None]
    cols = torch.arange(tk, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(cols - rows >= 1 + abs(tk - tq), float("-inf"), zero)


def init_mha(gen: torch.Generator, embed_dim_in: int, num_heads: int, head_dim: int) -> dict:
    """Xavier-uniform packed in-projection and out-projection, zero biases;
    bounds from the torch 2-D shapes ``[3E, E_in]`` and ``[E_out, E]``."""
    e = num_heads * head_dim
    b_in = math.sqrt(6.0 / (3 * e + embed_dim_in))
    b_out = math.sqrt(6.0 / (embed_dim_in + e))
    return {
        "in_proj_w": torch.empty(3, num_heads, head_dim, embed_dim_in).uniform_(
            -b_in, b_in, generator=gen),
        "in_proj_b": torch.zeros(3, num_heads, head_dim),
        "out_w": torch.empty(embed_dim_in, num_heads, head_dim).uniform_(
            -b_out, b_out, generator=gen),
        "out_b": torch.zeros(embed_dim_in),
    }


def multihead_attention(params: dict, query: torch.Tensor, key: torch.Tensor,
                        value: torch.Tensor, *, head_mask: torch.Tensor,
                        head_dim_mask: torch.Tensor,
                        attn_bias: Optional[torch.Tensor] = None,
                        channel_mask: Optional[torch.Tensor] = None,
                        attn_dropout: float = 0.0, train: bool = False,
                        generator: Optional[torch.Generator] = None, impl: str = "xla",
                        causal_offset: Optional[int] = None) -> torch.Tensor:
    """``query [B, Tq, E_in]``, ``key`` / ``value`` ``[B, Tk, E_in]``,
    additive ``attn_bias [Tq, Tk]``; attention dropout in train mode.
    ``impl="flash"`` takes no bias: the future mask is ``causal_offset``'s
    rule (None: no mask), and the attention dropout runs inside the kernel."""
    if impl not in ("xla", "flash"):
        raise ValueError(f"unknown attention impl {impl!r}; valid: 'xla', 'flash'")
    w_in = params["in_proj_w"]
    b_in = params["in_proj_b"]
    hd = head_mask[:, None] * head_dim_mask[None, :]

    dt = query.dtype

    def proj(x, i):
        y = torch.einsum("btc,hdc->bthd", x.float(), w_in[i].float())
        return ((y + b_in[i]) * hd).to(dt)

    def out_proj(attn):
        out = torch.einsum("bqhd,ehd->bqe", attn.float(), params["out_w"].float())
        out = out + params["out_b"]
        return (out * channel_mask if channel_mask is not None else out).to(dt)

    if query.shape[1] == 1 and key.shape[1] == 1 and (attn_bias is None or impl == "flash"):
        v = proj(value, 2)
        if train and attn_dropout != 0.0:
            ones = torch.ones(query.shape[0], w_in.shape[1], 1, 1, dtype=dt,
                              device=query.device)
            v = dropout(ones, attn_dropout, train, generator).transpose(1, 2) * v
        return out_proj(v)

    q = proj(query, 0)
    k = proj(key, 1)
    v = proj(value, 2)
    active_dh = torch.clamp(head_dim_mask.float().sum(), min=1.0)
    q = q * torch.rsqrt(active_dh).to(dt)
    if impl == "flash":
        if attn_bias is not None:
            raise ValueError("impl='flash' takes the future mask as causal_offset, "
                             "not as an additive attn_bias")
        seeds = rates = None
        if train and attn_dropout != 0.0:
            if generator is None:
                raise ValueError("training-mode dropout needs a generator")
            bh = query.shape[0] * w_in.shape[1]
            # the JAX package's jax.random.randint(rng, (bh,), 0, 2**31 - 1)
            seeds = torch.randint(0, 2**31 - 1, (bh,), generator=generator,
                                  device=query.device, dtype=torch.int32)
            rates = torch.full((bh,), float(attn_dropout), device=query.device)
        attn = flash_attention(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), causal=causal_offset is not None,
            offset=causal_offset if causal_offset is not None else 1,
            dropout_seeds=seeds, dropout_rates=rates)
        return out_proj(attn.transpose(1, 2))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if attn_bias is not None:
        logits = logits + attn_bias
    weights = torch.softmax(logits.float(), dim=-1).to(dt)
    weights = dropout(weights, attn_dropout, train, generator)
    return out_proj(torch.einsum("bhqk,bkhd->bqhd", weights.float(), v.float()).to(dt))
