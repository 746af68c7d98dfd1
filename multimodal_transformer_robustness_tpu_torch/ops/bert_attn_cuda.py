"""The frozen-BERT attention through hand-written CUDA kernels.

Counterpart of ``multimodal_transformer_robustness_tpu/ops/bert_attn_pallas.py``
(forward only).  Both wrappers launch ``csrc/bert_attn.cu`` on a CUDA tensor
and run their plain PyTorch versions on a CPU tensor:

  * :func:`attention_block_fused` (K2): the whole block ``LN(x +
    o_proj(MHA(x)))``, replaces ``bert_attn_pallas._attn_block_kernel``;
    weights come pre-transposed (``w*_t = weight.T``), made once at load
    time;
  * :func:`dense_attention_blockdiag` (K6a): the projection-free attention
    core over q/k/v ``[B, L, H, dh]``, replaces
    ``bert_attn_pallas._dense_attn_kernel``; the same attention kernel as
    K2's attention stage.

The key-padding bias is HF's additive ``(1 - mask) * -10000``.
"""

from __future__ import annotations

import math

import torch

from .. import _build
from .layernorm import masked_layer_norm

# the kernel keeps up to 16 query rows x head_dim outputs per block in registers
_MAX_HEAD_DIM = 128


def dense_attention_plain(q, k, v, key_mask) -> torch.Tensor:
    """Plain PyTorch version of K6a: ``softmax(q k^T / sqrt(dh) + (1 - mask)
    * -10000) v`` per (item, head), float32 softmax; q/k/v ``[B, L, H, dh]``
    -> ``[B, L, H * dh]``.  This is also the JAX package's XLA attention
    composition (``models/bert.bert_apply`` under ``ATTN_IMPL="xla"``)."""
    b, L, n_heads, dh = q.shape
    bias = (1.0 - key_mask.float()) * -10000.0
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh) + bias[:, None, None, :]
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, L, n_heads * dh)


def attention_block_plain(x, key_mask, wq_t, qb, wk_t, kb, wv_t, vb, wo_t, ob,
                          ln_g, ln_b, *, n_heads: int, eps: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel (float32 softmax)."""
    b, L, h = x.shape

    def proj(w, bias):
        return (torch.matmul(x, w) + bias).reshape(b, L, n_heads, h // n_heads)

    attn = dense_attention_plain(proj(wq_t, qb), proj(wk_t, kb), proj(wv_t, vb), key_mask)
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


def dense_attention_blockdiag(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              key_mask: torch.Tensor) -> torch.Tensor:
    """Multi-head attention over projected ``q, k, v [B, L, H, dh]``
    (unscaled; the 1/sqrt(dh) happens in the kernel) with ``key_mask [B, L]``
    (1 = attend) -> ``[B, L, H * dh]``.  A fully masked item stays finite."""
    if q.device.type == "cpu":
        return dense_attention_plain(q, k, v, key_mask)
    dev = _build.device_of(q)
    b, L, n_heads, dh = q.shape
    if dh > _MAX_HEAD_DIM:
        raise ValueError(f"head_dim {dh}: the kernel takes head_dim <= {_MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t, name, (b, L, n_heads, dh), dev)
    mask = key_mask.to(device=dev, dtype=torch.float32).contiguous()
    _build.require(mask, "key_mask", (b, L), dev)
    out = torch.empty(b, L, n_heads * dh, dtype=torch.float32, device=dev)
    err = _build.load_library().mmtr_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
        b, L, n_heads * dh, n_heads, _build.stream_ptr(dev))
    _build.check(err, "dense_attention_blockdiag kernel")
    dense_attention_blockdiag.launches += 1
    return out


dense_attention_blockdiag.launches = 0
