"""Elastic transformer encoder stack, eval mode: pre-norm layers with
per-layer depth gates.

Counterpart of ``multimodal_transformer_robustness_tpu/ops/encoder.py``.
The stack embeds with scale ``sqrt(E)`` plus the sinusoidal embedding (fed
the activation's first active channel as token proxy); in cross mode the
key/value stream is embedded once.  Each layer: LN -> attention (optional
future mask) -> residual; LN -> fc1 (FFN-masked) -> ReLU -> fc2 -> residual.
All layers run; an inactive layer is an identity through ``torch.where`` on
the carry, so a mask is never read on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .attention import future_mask, init_mha, multihead_attention
from .layernorm import masked_layer_norm
from .linear import init_linear, masked_linear
from .positional import make_positions, sinusoidal_pe

TRAIN_TODO = ("training mode is not ported yet: ROADMAP Queue 1, "
              "'training step' (K1 backward, dropout)")


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


def _layer_forward(lp: dict, x: torch.Tensor, kv: Optional[torch.Tensor],
                   m: EncoderMasks, attn_bias: Optional[torch.Tensor]) -> torch.Tensor:
    cm = m.channel_mask
    h = masked_layer_norm(x, lp["ln0"]["g"], lp["ln0"]["b"], cm)
    if kv is None:
        attn = multihead_attention(lp["attn"], h, h, h, head_mask=m.head_mask,
                                   head_dim_mask=m.head_dim_mask,
                                   attn_bias=attn_bias, channel_mask=cm)
    else:
        # cross mode: k and v share one embedding in eval mode; channel
        # masks are self-attention only
        k = masked_layer_norm(kv, lp["ln0"]["g"], lp["ln0"]["b"], None)
        attn = multihead_attention(lp["attn"], h, k, k, head_mask=m.head_mask,
                                   head_dim_mask=m.head_dim_mask,
                                   attn_bias=attn_bias, channel_mask=None)
    x = x + attn
    h = masked_layer_norm(x, lp["ln1"]["g"], lp["ln1"]["b"], cm)
    h = masked_linear(h, lp["fc1"]["w"], lp["fc1"]["b"], mask_out=m.ffn_mask)
    h = torch.relu(h)
    h = masked_linear(h, lp["fc2"]["w"], lp["fc2"]["b"], mask_out=cm)
    return x + h


def encoder_forward(params: dict, x_in: torch.Tensor,
                    x_kv: Optional[torch.Tensor] = None, *, hp: EncoderHParams,
                    masks: EncoderMasks, train: bool = False) -> torch.Tensor:
    """Stack forward: ``x_in [B, T, E_in]`` (and ``x_kv [B, Tk, E_in]`` in
    cross mode) -> ``[B, T, E_in]``, zeros kept at masked channels."""
    if train:
        raise NotImplementedError(TRAIN_TODO)
    cm = masks.channel_mask
    scale = math.sqrt(hp.embed_dim_in)  # full width even under masks
    if cm is None:
        feat0 = x_in[:, :, 0]
    else:
        # feature 0 of the compacted tensor is the lowest active channel
        first_active = torch.argmax((cm > 0).float()).reshape(1)
        feat0 = x_in.index_select(-1, first_active).squeeze(-1)
    x = scale * x_in + sinusoidal_pe(make_positions(feat0), hp.embed_dim_in, cm)

    kv = None
    if x_kv is not None:
        pe_kv = sinusoidal_pe(make_positions(x_kv[:, :, 0]), hp.embed_dim_in, None)
        kv = scale * x_kv + pe_kv

    attn_bias = None
    tq = x.shape[1]
    tk = x_kv.shape[1] if x_kv is not None else tq
    if hp.attn_mask and not (tq == 1 and tk == 1):
        # future_mask(1, 1) is identically 0; leaving it out takes the T==1 path
        attn_bias = future_mask(tq, tk, device=x.device)

    for lp, gate in zip(params["layers"], masks.layer_gates):
        x = torch.where(gate > 0, _layer_forward(lp, x, kv, masks, attn_bias), x)
    return masked_layer_norm(x, params["ln"]["g"], params["ln"]["b"], cm)
