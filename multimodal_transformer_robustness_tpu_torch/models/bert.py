"""Frozen BERT encoder for the text header, eval mode.

Counterpart of ``multimodal_transformer_robustness_tpu/models/bert.py``.
The forward equals HF ``BertModel``'s last_hidden_state: embeddings (word +
position + token type, LayerNorm), then per layer kernel K2
(:func:`..ops.bert_attn_cuda.attention_block_fused`) and kernel K3
(:func:`..ops.bert_ffn_cuda.ffn_ln_block`).  The kernels take every length
and width, so there is no shape gate.

Parameters come in two layouts: :func:`init_bert` makes HF-layout weights
stacked ``[L, ...]`` (the JAX package's layout), and :func:`prepare_bert`
turns them, once, into the kernels' layout: one dict per layer with every
weight transposed to ``x @ w_t`` orientation.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.bert_attn_cuda import attention_block_fused
from ..ops.bert_ffn_cuda import ffn_ln_block
from ..ops.layernorm import masked_layer_norm

INT8_TODO = ("--bert_int8 is not ported yet: ROADMAP Queue 2, K4 "
             "(ffn_ln_block_q, int8 FFN kernel)")

_WEIGHTS = ("q_w", "k_w", "v_w", "o_w", "fc1_w", "fc2_w")
_VECTORS = ("q_b", "k_b", "v_b", "o_b", "ln1_g", "ln1_b", "fc1_b", "fc2_b",
            "ln2_g", "ln2_b")


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


def prepare_bert(bert: dict, device="cpu") -> dict:
    """HF-layout stacked weights (tensors or numpy arrays) -> the kernels'
    layout on ``device``: per-layer dicts, weights as ``<name>t = w.T``."""

    def dev(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)

    n = len(bert["layers"]["q_w"])
    layers = []
    for i in range(n):
        lp = {f"{w}t": dev(bert["layers"][w][i]).t().contiguous() for w in _WEIGHTS}
        lp.update({v: dev(bert["layers"][v][i]) for v in _VECTORS})
        layers.append(lp)
    out = {k: dev(bert[k]) for k in ("word_emb", "pos_emb", "type_emb",
                                     "emb_ln_g", "emb_ln_b")}
    out["layers"] = layers
    return out


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
    for lp in params["layers"]:
        x = attention_block_fused(
            x, attention_mask, lp["q_wt"], lp["q_b"], lp["k_wt"], lp["k_b"],
            lp["v_wt"], lp["v_b"], lp["o_wt"], lp["o_b"], lp["ln1_g"], lp["ln1_b"],
            n_heads=cfg.num_heads, eps=cfg.eps)
        x = ffn_ln_block(x, lp["fc1_wt"], lp["fc1_b"], lp["fc2_wt"], lp["fc2_b"],
                         lp["ln2_g"], lp["ln2_b"], eps=cfg.eps)
    return x
