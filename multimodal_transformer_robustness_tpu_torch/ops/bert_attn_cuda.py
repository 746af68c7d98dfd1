"""K2: the frozen-BERT attention block ``LN(x + o_proj(MHA(x)))`` through a
hand-written CUDA kernel.

Counterpart of ``multimodal_transformer_robustness_tpu/ops/bert_attn_pallas.py``
(``attention_block_fused``; forward only).  On a CUDA tensor
:func:`attention_block_fused` launches ``csrc/bert_attn.cu``, which replaces
the TPU kernel ``bert_attn_pallas._attn_block_kernel``; on a CPU tensor it
runs the plain version :func:`attention_block_plain`.  The key-padding bias
is HF's additive ``(1 - mask) * -10000``.  Weights come pre-transposed
(``w*_t = weight.T``), made once at load time.
"""

from __future__ import annotations

import math

import torch

from .. import _build
from .layernorm import masked_layer_norm

# the kernel keeps up to 16 query rows x head_dim outputs per block in registers
_MAX_HEAD_DIM = 128


def attention_block_plain(x, key_mask, wq_t, qb, wk_t, kb, wv_t, vb, wo_t, ob,
                          ln_g, ln_b, *, n_heads: int, eps: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel (float32 softmax)."""
    b, L, h = x.shape
    dh = h // n_heads

    def proj(w, bias):
        return (torch.matmul(x, w) + bias).reshape(b, L, n_heads, dh)

    q, k, v = proj(wq_t, qb), proj(wk_t, kb), proj(wv_t, vb)
    bias = (1.0 - key_mask.float()) * -10000.0
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh) + bias[:, None, None, :]
    w = torch.softmax(logits, dim=-1)
    attn = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, L, h)
    return masked_layer_norm(x + (torch.matmul(attn, wo_t) + ob), ln_g, ln_b, eps=eps)


def attention_block_fused(x: torch.Tensor, key_mask: torch.Tensor,
                          wq_t, qb, wk_t, kb, wv_t, vb, wo_t, ob, ln_g, ln_b,
                          *, n_heads: int, eps: float) -> torch.Tensor:
    """HF BertSelfAttention + BertSelfOutput: ``x [B, L, h]``,
    ``key_mask [B, L]`` (1 = attend), weights ``[h, h]`` in ``x @ w_t``
    orientation, biases and LN params ``[h]``."""
    if x.device.type == "cpu":
        return attention_block_plain(x, key_mask, wq_t, qb, wk_t, kb, wv_t, vb,
                                     wo_t, ob, ln_g, ln_b, n_heads=n_heads, eps=eps)
    dev = _build.device_of(x)
    b, L, h = x.shape
    if h % n_heads or h // n_heads > _MAX_HEAD_DIM:
        raise ValueError(f"width {h} with {n_heads} heads: the kernel takes "
                         f"head_dim = h / n_heads <= {_MAX_HEAD_DIM}")
    _build.require(x, "x", (b, L, h), dev)
    for name, t in (("wq_t", wq_t), ("wk_t", wk_t), ("wv_t", wv_t), ("wo_t", wo_t)):
        _build.require(t, name, (h, h), dev)
    for name, t in (("qb", qb), ("kb", kb), ("vb", vb), ("ob", ob),
                    ("ln_g", ln_g), ("ln_b", ln_b)):
        _build.require(t, name, (h,), dev)
    mask = key_mask.to(device=dev, dtype=torch.float32).contiguous()
    _build.require(mask, "key_mask", (b, L), dev)
    lib = _build.load_library()
    qkv = torch.empty(3, b * L, h, dtype=torch.float32, device=dev)
    attn = torch.empty(b * L, h, dtype=torch.float32, device=dev)
    resid_sum = torch.empty(b * L, h, dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    err = lib.mmtr_attn_block_fwd(
        x.data_ptr(), mask.data_ptr(), wq_t.data_ptr(), qb.data_ptr(),
        wk_t.data_ptr(), kb.data_ptr(), wv_t.data_ptr(), vb.data_ptr(),
        wo_t.data_ptr(), ob.data_ptr(), ln_g.data_ptr(), ln_b.data_ptr(),
        qkv.data_ptr(), attn.data_ptr(), resid_sum.data_ptr(), out.data_ptr(),
        b, L, h, n_heads, eps, _build.stream_ptr(dev))
    _build.check(err, "attention_block_fused kernel")
    attention_block_fused.launches += 1
    return out


attention_block_fused.launches = 0
