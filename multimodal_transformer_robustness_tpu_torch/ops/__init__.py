"""Elastic ops: static-shape, mask-parameterized primitives, and the
wrappers of the hand-written CUDA kernels (``*_cuda`` modules)."""

from .attention import future_mask, init_mha, multihead_attention
from .dropout import dropout
from .encoder import EncoderHParams, EncoderMasks, encoder_forward, init_encoder
from .gru import bigru_forward, gru_forward, gru_recurrence, init_bigru, init_gru
from .layernorm import masked_layer_norm
from .linear import init_linear, masked_linear
from .positional import make_positions, sinusoidal_pe
from .trunk_block_cuda import fused_residual_block

__all__ = [
    "future_mask",
    "init_mha",
    "multihead_attention",
    "dropout",
    "EncoderHParams",
    "EncoderMasks",
    "encoder_forward",
    "init_encoder",
    "bigru_forward",
    "gru_forward",
    "gru_recurrence",
    "init_bigru",
    "init_gru",
    "masked_layer_norm",
    "init_linear",
    "masked_linear",
    "make_positions",
    "sinusoidal_pe",
    "fused_residual_block",
]
