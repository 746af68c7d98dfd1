"""Frozen BERT encoder for the text header, eval mode.

Counterpart of ``multimodal_transformer_robustness_tpu/models/bert.py``.
The forward equals HF ``BertModel``'s last_hidden_state: embeddings (word +
position + token type, LayerNorm), then per layer the attention block and
the FFN block.  The kernels take every length and width, so there is no
shape gate.

The attention block follows :data:`ATTN_IMPL`, with the JAX package's values:

  * ``"fused"``: kernel K2 (:func:`..ops.bert_attn_cuda.attention_block_fused`),
    the whole BertSelfAttention + BertSelfOutput block;
  * ``"dense"``: plain projections ``x @ w_t + b`` (``torch.matmul``, as the
    JAX package leaves them to XLA), kernel K6a
    (:func:`..ops.bert_attn_cuda.dense_attention_blockdiag`), then kernel
    K6b (:func:`..ops.bert_ffn_cuda.proj_ln_block`);
  * ``"xla"``: the plain attention composition, then K6b;
  * ``"auto"`` (the default): K2 for float layers at every L, K6a + K6b for
    widths h > 1024, and the plain attention for int8-quantized attention
    layers, as the JAX package does.  On the TPU the JAX package's ``"auto"``
    also leaves float layers with L > 128, or more than 512 packed rows, to
    XLA's attention plus K6b: that gate is the TPU kernel's VMEM budget, which
    K2 on the card does not have.  Both compute the same function.

Quantized attention layers (``quantize_bert_params(attn=True)``) project
q/k/v through one shared row quantization and the int8 GEMM
(:func:`..ops.bert_ffn_cuda.qrows` / :func:`..ops.bert_ffn_cuda.qdot`), and
their o-proj the same way, instead of K6b; a forced ``"fused"`` on them
falls back to ``"xla"``, a forced ``"dense"`` runs K6a on the int8-projected
q/k/v.  The FFN block is kernel K3 (:func:`..ops.bert_ffn_cuda.ffn_ln_block`)
for float weights and kernel K4 (:func:`..ops.bert_ffn_cuda.ffn_ln_block_q`)
for int8 ones.

Under the bf16 compute policy (bf16 weights, as ``models/mult.compute_cast``
or ``prepare_bert(..., dtype=torch.bfloat16)`` makes them) the embeddings
add in bf16, the embedding LayerNorm takes float32 moments (centered) and
rounds, and every kernel runs its bf16 instance (K2, K3, K4, K6a, K6b, the
int8 projections); :data:`ATTN_SOFTMAX` selects K2's softmax tail, as in
the JAX package.  The unfused paths round where the JAX package's XLA
composition does: a float projection ``x @ w_t`` to bf16, then its bias in
bf16; the int8 projections and the attention core as their kernels; the
int8 o-projection's residual sum, then the LN.  An int8 BERT under bf16 is
quantized from the float32 weights and then cast (the scales and biases
rounded to bf16, the codes kept), as the JAX package quantizes its float32
``init_bert`` before the boundary cast: :func:`quantize_bert_params`
refuses bf16 weights.

Parameters come in two layouts: :func:`init_bert` makes HF-layout weights
stacked ``[L, ...]`` (the JAX package's layout, float or quantized), and
:func:`prepare_bert` turns them, once, into the kernels' layout: one dict
per layer with every float weight transposed to ``x @ w_t`` orientation
(``<name>t``) and every quantized weight kept ``{"q": int8 [out, in], "s":
float32 [out]}`` under its own name.  Float q/k/v weights are views of one
``[3, h, h]`` tensor and their biases of one ``[3h]`` vector, so that K2
runs them as one product.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.bert_attn_cuda import (attention_block_fused, dense_attention_blockdiag,
                                  dense_attention_plain)
from ..ops.bert_ffn_cuda import (div127, ffn_ln_block, ffn_ln_block_q, proj_ln_block, qdot,
                                 qrows)
from ..ops.layernorm import masked_layer_norm

ATTN_IMPL = "auto"  # "auto" | "fused" | "dense" | "xla", see the docstring
# K2's softmax exp / sum / divide dtype under bf16 activations ("float32" |
# "bfloat16"; the max subtraction and the masks stay float32), as the JAX
# package's ATTN_SOFTMAX
ATTN_SOFTMAX = "float32"
_ATTN_IMPLS = ("auto", "fused", "dense", "xla")
# widths above this take the dense path under "auto", as in the JAX package
_FUSED_MAX_WIDTH = 1024

_WEIGHTS = ("q_w", "k_w", "v_w", "o_w", "fc1_w", "fc2_w")
_VECTORS = ("q_b", "k_b", "v_b", "o_b", "ln1_g", "ln1_b", "fc1_b", "fc2_b",
            "ln2_g", "ln2_b")


def _attn_resolved_impl(h: int, quantized: bool) -> str:
    """The attention path of a layer of width ``h`` under :data:`ATTN_IMPL`
    (the JAX package's ``_attn_resolved_impl``, case for case, without its
    TPU VMEM gate)."""
    if ATTN_IMPL == "auto":
        if quantized:
            return "xla"
        return "fused" if h <= _FUSED_MAX_WIDTH else "dense"
    if ATTN_IMPL == "fused" and quantized:
        return "xla"
    if ATTN_IMPL not in _ATTN_IMPLS:
        raise ValueError(f"unknown ATTN_IMPL {ATTN_IMPL!r}; valid: "
                         "'auto' | 'fused' | 'dense' | 'xla'")
    return ATTN_IMPL


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    eps: float = 1e-12


def tiny_bert_config(hidden: int = 16, layers: int = 2, heads: int = 2,
                     vocab: int = 64) -> BertConfig:
    return BertConfig(vocab_size=vocab, hidden_size=hidden, num_layers=layers,
                      num_heads=heads, intermediate_size=hidden * 4,
                      max_position=64, type_vocab_size=2)


def init_bert(gen: torch.Generator, cfg: BertConfig) -> dict:
    """Random HF-layout weights, normal(0, 0.02) as HF initializes; layers
    stacked on a leading axis."""
    h, ffn, n = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

    def norm(*shape):
        return 0.02 * torch.randn(*shape, generator=gen)

    layers = {
        "q_w": norm(n, h, h), "k_w": norm(n, h, h), "v_w": norm(n, h, h),
        "o_w": norm(n, h, h), "fc1_w": norm(n, ffn, h), "fc2_w": norm(n, h, ffn),
        "fc1_b": torch.zeros(n, ffn),
        "ln1_g": torch.ones(n, h), "ln2_g": torch.ones(n, h),
    }
    for name in ("q_b", "k_b", "v_b", "o_b", "fc2_b", "ln1_b", "ln2_b"):
        layers[name] = torch.zeros(n, h)
    return {
        "word_emb": norm(cfg.vocab_size, h),
        "pos_emb": norm(cfg.max_position, h),
        "type_emb": norm(cfg.type_vocab_size, h),
        "emb_ln_g": torch.ones(h), "emb_ln_b": torch.zeros(h),
        "layers": layers,
    }


def prepare_bert(bert: dict, device="cpu", dtype: torch.dtype = torch.float32) -> dict:
    """HF-layout stacked weights (tensors or numpy arrays; a weight may be a
    quantized ``{"q": int8 [L, out, in], "s": [L, out]}`` dict, as the JAX
    package's ``quantize_bert_params`` makes it) -> the kernels' layout on
    ``device``: per-layer dicts, float weights as ``<name>t = w.T``,
    quantized ones kept ``[out, in]``; float ``q_wt, k_wt, v_wt`` views of
    one ``[3, h, h]`` tensor, ``q_b, k_b, v_b`` of one ``[3h]``
    (:func:`..models.mult.to_device` keeps them so).  ``dtype=torch.
    bfloat16``: the float weights (not the int8 scales) made once in bf16,
    the float32 values rounded, as the compute policy's cast rounds them."""

    def dev(a, dtype=dtype):
        return torch.tensor(np.asarray(a, np.float32 if dtype != torch.int8 else None),
                            dtype=dtype, device=device)

    n = len(bert["layers"]["q_b"])
    qkv = ("q_w", "k_w", "v_w")
    layers = []
    for i in range(n):
        lp = {}
        for w in _WEIGHTS:
            a = bert["layers"][w]
            if isinstance(a, dict):
                lp[w] = {"q": dev(a["q"][i], torch.int8).contiguous(),
                         "s": dev(a["s"][i], torch.float32)}
            else:
                lp[f"{w}t"] = dev(a[i]).t().contiguous()
        lp.update({v: dev(bert["layers"][v][i]) for v in _VECTORS})
        if all(f"{w}t" in lp for w in qkv):   # K2's gated operand: views of one tensor
            stacked = torch.stack([lp[f"{w}t"] for w in qkv])
            biases = torch.cat([lp[f"{w[0]}_b"] for w in qkv]).chunk(3)
            for w, wt, b in zip(qkv, stacked, biases):
                lp[f"{w}t"], lp[f"{w[0]}_b"] = wt, b
        layers.append(lp)
    out = {k: dev(bert[k]) for k in ("word_emb", "pos_emb", "type_emb",
                                     "emb_ln_g", "emb_ln_b")}
    out["layers"] = layers
    return out


def _quantize(w: torch.Tensor) -> dict:
    """Symmetric per-output-channel int8 of ``w [out, in]``: ``s = max|w| /
    127`` (at least 1e-12), ``q = clamp(round(w / s), -127, 127)``; ``w``
    float32 (codes and scales of rounded weights would not be the JAX
    package's)."""
    if w.dtype != torch.float32:
        raise ValueError(f"quantize_bert_params takes the float32 weights, not {w.dtype}: "
                         "quantize before the compute policy's cast (models/mult."
                         "init_supernet(..., bert_int8=...))")
    s = torch.clamp(div127(w.abs().amax(dim=-1)), min=1e-12)
    q = torch.clamp(torch.round(w / s[:, None]), -127, 127).to(torch.int8)
    return {"q": q.contiguous(), "s": s.float()}


def quantize_bert_params(params: dict, attn: bool = True) -> dict:
    """int8 weights for the six projection / FFN matrices of each layer of a
    :func:`prepare_bert` BERT (``attn=False``: fc1 / fc2 only, the JAX CLIs'
    ``--bert_int8``); embeddings, LayerNorms and biases stay float.  The
    same ``q`` and ``s`` as the JAX package's ``quantize_bert_params``.  A
    weight that is quantized already is kept; bf16 weights raise ValueError
    (quantize the float32 BERT, then cast it: ``models/mult.cast_tree``
    rounds the scales and biases and keeps the codes)."""
    names = _WEIGHTS if attn else ("fc1_w", "fc2_w")
    layers = []
    for lp in params["layers"]:
        lp = dict(lp)
        for name in names:
            if f"{name}t" in lp:
                lp[name] = _quantize(lp.pop(f"{name}t").t())
        layers.append(lp)
    return dict(params, layers=layers)


def _qproj(x: torch.Tensor, wq: dict, bias: torch.Tensor) -> torch.Tensor:
    """``x @ w.T + bias`` with int8 weights and dynamic per-row int8
    activations."""
    xq, sx = qrows(x.contiguous())
    return qdot(xq, sx, wq, bias).reshape(*x.shape[:-1], -1)


def _attention_unfused(x, mask, lp: dict, impl: str, n_heads: int, eps: float):
    """The attention block under ``"dense"`` or ``"xla"``: projections, the
    attention core (K6a or the plain composition), then the o-proj +
    residual + LN1 (K6b, or the int8 o-proj).  bf16 activations round where
    the JAX composition does (the module docstring)."""
    b, L, h = x.shape
    if isinstance(lp.get("q_w"), dict):
        xq, sx = qrows(x)      # one row quantization shared by q, k and v

        def proj(w, bias):
            return qdot(xq, sx, lp[w], lp[bias]).reshape(b, L, n_heads, h // n_heads)
    else:
        def proj(w, bias):
            return (torch.matmul(x, lp[f"{w}t"]) + lp[bias]).reshape(b, L, n_heads,
                                                                      h // n_heads)

    core = dense_attention_blockdiag if impl == "dense" else dense_attention_plain
    attn = core(proj("q_w", "q_b"), proj("k_w", "k_b"), proj("v_w", "v_b"), mask)
    if isinstance(lp.get("o_w"), dict):
        return masked_layer_norm(x + _qproj(attn, lp["o_w"], lp["o_b"]), lp["ln1_g"],
                                 lp["ln1_b"], eps=eps)
    return proj_ln_block(x, attn, lp["o_wt"], lp["o_b"], lp["ln1_g"], lp["ln1_b"], eps=eps)


def bert_apply(params: dict, input_ids: torch.Tensor, attention_mask: torch.Tensor,
               token_type_ids: torch.Tensor, cfg: BertConfig) -> torch.Tensor:
    """[B, L] ids / mask / type ids -> [B, L, h] last hidden states."""
    L = input_ids.shape[1]
    pos = torch.arange(L, device=input_ids.device)
    # ids past the table are clamped to its last row, as the JAX package's
    # gather does (the hash tokenizer's ids exceed a small test vocabulary)
    ids = input_ids.clamp(0, params["word_emb"].shape[0] - 1)
    types = token_type_ids.clamp(0, params["type_emb"].shape[0] - 1)
    x = (params["word_emb"][ids] + params["pos_emb"][pos][None]
         + params["type_emb"][types])
    x = masked_layer_norm(x, params["emb_ln_g"], params["emb_ln_b"], eps=cfg.eps)
    h = x.shape[-1]
    for lp in params["layers"]:
        impl = _attn_resolved_impl(h, isinstance(lp.get("q_w"), dict))
        if impl == "fused":
            x = attention_block_fused(
                x, attention_mask, lp["q_wt"], lp["q_b"], lp["k_wt"], lp["k_b"],
                lp["v_wt"], lp["v_b"], lp["o_wt"], lp["o_b"], lp["ln1_g"], lp["ln1_b"],
                n_heads=cfg.num_heads, eps=cfg.eps,
                softmax_dtype=ATTN_SOFTMAX)
        else:
            x = _attention_unfused(x, attention_mask, lp, impl, cfg.num_heads, cfg.eps)
        if isinstance(lp.get("fc1_w"), dict):
            x = ffn_ln_block_q(x, lp["fc1_w"], lp["fc1_b"], lp["fc2_w"], lp["fc2_b"],
                               lp["ln2_g"], lp["ln2_b"], eps=cfg.eps)
        else:
            x = ffn_ln_block(x, lp["fc1_wt"], lp["fc1_b"], lp["fc2_wt"], lp["fc2_b"],
                             lp["ln2_g"], lp["ln2_b"], eps=cfg.eps)
    return x
