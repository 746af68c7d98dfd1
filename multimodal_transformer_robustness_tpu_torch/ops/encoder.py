"""Elastic transformer encoder stack: pre-norm layers with per-layer depth
gates, in eval and train mode.

Counterpart of ``multimodal_transformer_robustness_tpu/ops/encoder.py``.
The stack embeds with scale ``sqrt(E)`` plus the sinusoidal embedding (fed
the activation's first active channel as token proxy) and embed dropout;
in cross mode the key/value stream is embedded once, with independent
dropout draws for k and v.  Each layer: LN -> attention (optional future
mask, attention dropout) -> res dropout -> residual; LN -> fc1 (FFN-masked)
-> ReLU -> relu dropout -> fc2 -> res dropout -> residual.  All layers run;
an inactive layer is an identity through ``torch.where`` on the carry, so a
mask is never read on the host.  ``attn_impl="flash"`` routes attention
through the flash kernels (``ops/attention_cuda.py``) with the future mask
from its rule, in eval and train mode; a nonzero attention rate runs the
kernels' in-softmax dropout.  The JAX package's rematerialization knobs
(``REMAT_*``) are not carried over: they trade memory for recompute and do
not change a value.  Under bf16 the embedding rounds as the JAX package's
(the positional table cast to the activation's dtype before the add).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .attention import future_mask, init_mha, multihead_attention
from .dropout import dropout
from .layernorm import masked_layer_norm
from .linear import init_linear, masked_linear
from .positional import make_positions, sinusoidal_pe


@dataclasses.dataclass(frozen=True)
class EncoderMasks:
    layer_gates: torch.Tensor                    # [L]
    head_mask: torch.Tensor                      # [H]
    head_dim_mask: torch.Tensor                  # [Dh]
    ffn_mask: torch.Tensor                       # [4*H*Dh]
    channel_mask: Optional[torch.Tensor] = None  # [E_in], self-attention only


@dataclasses.dataclass(frozen=True)
class EncoderHParams:
    embed_dim_in: int
    num_heads: int
    head_dim: int
    layers: int
    attn_mask: bool = False
    relu_dropout: float = 0.0
    res_dropout: float = 0.0
    embed_dropout: float = 0.0
    attn_impl: str = "xla"   # "xla" or "flash"


def _init_layer(gen: torch.Generator, e_in: int, h: int, dh: int) -> dict:
    ffn = 4 * h * dh
    return {
        "attn": init_mha(gen, e_in, h, dh),
        "fc1": init_linear(gen, e_in, ffn, init="xavier_zero"),
        "fc2": init_linear(gen, ffn, e_in, init="xavier_zero"),
        "ln0": {"g": torch.ones(e_in), "b": torch.zeros(e_in)},
        "ln1": {"g": torch.ones(e_in), "b": torch.zeros(e_in)},
    }


def init_encoder(gen: torch.Generator, hp: EncoderHParams) -> dict:
    """``{"layers": [per-layer dicts], "ln": final LayerNorm}``."""
    return {
        "layers": [_init_layer(gen, hp.embed_dim_in, hp.num_heads, hp.head_dim)
                   for _ in range(hp.layers)],
        "ln": {"g": torch.ones(hp.embed_dim_in), "b": torch.zeros(hp.embed_dim_in)},
    }


def _layer_forward(lp: dict, x: torch.Tensor, x_k: Optional[torch.Tensor],
                   x_v: Optional[torch.Tensor], hp: EncoderHParams, m: EncoderMasks,
                   attn_bias: Optional[torch.Tensor], attn_rate: float, train: bool,
                   gen: Optional[torch.Generator]) -> torch.Tensor:
    cm = m.channel_mask
    att = dict(head_mask=m.head_mask, head_dim_mask=m.head_dim_mask,
               attn_bias=attn_bias, attn_dropout=attn_rate, train=train,
               generator=gen)
    if hp.attn_impl == "flash":
        tq = x.shape[1]
        tk = x_k.shape[1] if x_k is not None else tq
        att.update(impl="flash",
                   causal_offset=(1 + abs(tk - tq)) if hp.attn_mask else None)
    h = masked_layer_norm(x, lp["ln0"]["g"], lp["ln0"]["b"], cm)
    if x_k is None:
        attn = multihead_attention(lp["attn"], h, h, h, channel_mask=cm, **att)
    else:
        # cross mode: channel masks are self-attention only
        k = masked_layer_norm(x_k, lp["ln0"]["g"], lp["ln0"]["b"], None)
        v = k if x_v is x_k else masked_layer_norm(x_v, lp["ln0"]["g"],
                                                   lp["ln0"]["b"], None)
        attn = multihead_attention(lp["attn"], h, k, v, channel_mask=None, **att)
    x = x + dropout(attn, hp.res_dropout, train, gen)
    h = masked_layer_norm(x, lp["ln1"]["g"], lp["ln1"]["b"], cm)
    h = masked_linear(h, lp["fc1"]["w"], lp["fc1"]["b"], mask_out=m.ffn_mask)
    h = dropout(torch.relu(h), hp.relu_dropout, train, gen)
    h = masked_linear(h, lp["fc2"]["w"], lp["fc2"]["b"], mask_out=cm)
    return x + dropout(h, hp.res_dropout, train, gen)


def encoder_forward(params: dict, x_in: torch.Tensor,
                    x_kv: Optional[torch.Tensor] = None, *, hp: EncoderHParams,
                    masks: EncoderMasks, attn_rate: float = 0.0, train: bool = False,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stack forward: ``x_in [B, T, E_in]`` (and ``x_kv [B, Tk, E_in]`` in
    cross mode) -> ``[B, T, E_in]``, zeros kept at masked channels.  In
    train mode every dropout draws from ``generator``."""
    cm = masks.channel_mask
    scale = math.sqrt(hp.embed_dim_in)  # full width even under masks
    if cm is None:
        feat0 = x_in[:, :, 0]
    else:
        # feature 0 of the compacted tensor is the lowest active channel
        first_active = torch.argmax((cm > 0).float()).reshape(1)
        feat0 = x_in.index_select(-1, first_active).squeeze(-1)
    x = scale * x_in + sinusoidal_pe(make_positions(feat0), hp.embed_dim_in, cm).to(x_in.dtype)
    x = dropout(x, hp.embed_dropout, train, generator)

    x_k = x_v = None
    if x_kv is not None:
        pe_kv = sinusoidal_pe(make_positions(x_kv[:, :, 0]), hp.embed_dim_in,
                              None).to(x_kv.dtype)
        kv = scale * x_kv + pe_kv
        # independent draws for k and v; one tensor when there is no draw
        x_k = dropout(kv, hp.embed_dropout, train, generator)
        x_v = dropout(kv, hp.embed_dropout, train, generator)

    attn_bias = None
    tq = x.shape[1]
    tk = x_kv.shape[1] if x_kv is not None else tq
    if hp.attn_mask and not (tq == 1 and tk == 1) and hp.attn_impl != "flash":
        # future_mask(1, 1) is identically 0; leaving it out takes the T==1 path
        attn_bias = future_mask(tq, tk, device=x.device)

    for lp, gate in zip(params["layers"], masks.layer_gates):
        y = _layer_forward(lp, x, x_k, x_v, hp, masks, attn_bias, attn_rate, train,
                           generator)
        x = torch.where(gate > 0, y, x)
    return masked_layer_norm(x, params["ln"]["g"], params["ln"]["b"], cm)
