"""Per-modality projection headers, eval mode.

Counterpart of ``multimodal_transformer_robustness_tpu/models/headers.py``.
The RNN header runs two bidirectional GRU levels with a non-affine
LayerNorm between them and keeps the second level's final hidden state, so
each modality collapses to one token ``[B, 1, d]``.  Both levels run T-major
through kernel K1 (:mod:`..ops.bigru_cuda`).

The text header runs the frozen BERT first, with the reference's quirk
replicated: the collate stacks ``[input_ids, token_type_ids,
attention_mask]`` but the forward reads ``[ids, attention_mask,
token_type_ids]``, so slot 1 (the all-zero type ids) is the attention mask
and every key carries the -10000 bias.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import ModelSpec
from ..ops.bigru_cuda import bigru_finals_tmajor, bigru_level_tmajor, dir_operands
from ..ops.gru import init_bigru
from ..ops.layernorm import masked_layer_norm
from . import bert as bert_mod

CNN_TODO = ("cnn_rnn headers are not ported yet: ROADMAP Queue 1, "
            "'training step' (with the cnn_rnn conv-gradient trap)")


def rnn_level_params(bigru: dict) -> dict:
    """torch-layout ``{"fwd", "bwd"}`` GRU weights -> K1 operands."""
    return {d: dir_operands(bigru[d]) for d in ("fwd", "bwd")}


def _init_rnn_header(gen: torch.Generator, input_dim: int, d: int) -> dict:
    if d % 2:
        raise ValueError("RNN header width must be even (bidirectional halves)")
    return {"gru1": rnn_level_params(init_bigru(gen, input_dim, d // 2)),
            "gru2": rnn_level_params(init_bigru(gen, d, d // 2))}


def _rnn_header_tmajor(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x [B, T, in] -> [B, 1, d] through two K1 levels."""
    x_t = x.transpose(0, 1).contiguous()                  # [T, B, in] once
    hs1 = bigru_level_tmajor(params["gru1"], x_t)         # [T, B, d]
    d = hs1.shape[-1]
    ones = torch.ones(d, dtype=hs1.dtype, device=hs1.device)
    hs1 = masked_layer_norm(hs1, ones, torch.zeros_like(ones))
    hs2 = bigru_level_tmajor(params["gru2"], hs1)
    return bigru_finals_tmajor(hs2)[:, None, :]


def init_header(gen: torch.Generator, spec: ModelSpec, i: int,
                bert_cfg: Optional[bert_mod.BertConfig] = None) -> dict:
    kind = spec.header_kind(spec.modality_set[i])
    if kind == "cnn_rnn":
        raise NotImplementedError(CNN_TODO)
    if kind == "bert_rnn":
        cfg = bert_cfg or bert_mod.BertConfig()
        return {"rnn": _init_rnn_header(gen, cfg.hidden_size, spec.dimension)}
    return {"rnn": _init_rnn_header(gen, spec.orig_dimensions[i], spec.dimension)}


def bert_text_features(frozen: dict, bert_cfg: Optional[bert_mod.BertConfig],
                       x: torch.Tensor) -> torch.Tensor:
    """[3, B, L] token stack -> [B, L, h] frozen-BERT last hidden states,
    slot 1 used as the attention mask (see the module docstring)."""
    return bert_mod.bert_apply(frozen["bert"], x[0].long(), x[1].float(), x[2].long(),
                               bert_cfg or bert_mod.BertConfig())


def header_apply(kind: str, params: dict, x: torch.Tensor,
                 frozen: Optional[dict] = None,
                 bert_cfg: Optional[bert_mod.BertConfig] = None) -> torch.Tensor:
    """Dispatch on header kind; returns [B, 1, d]."""
    if kind == "cnn_rnn":
        raise NotImplementedError(CNN_TODO)
    if kind == "bert_rnn" and not torch.is_floating_point(x):
        if frozen is None or "bert" not in frozen:
            raise ValueError("a text modality needs the frozen BERT parameters")
        x = bert_text_features(frozen, bert_cfg, x)
    # float input to a bert_rnn header is precomputed BERT features [B, L, h]
    return _rnn_header_tmajor(params["rnn"], x)
