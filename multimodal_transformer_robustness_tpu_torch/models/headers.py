"""Per-modality projection headers.

Counterpart of ``multimodal_transformer_robustness_tpu/models/headers.py``.
The RNN header runs two bidirectional GRU levels with a non-affine
LayerNorm between them and keeps the second level's final hidden state, so
each modality collapses to one token ``[B, 1, d]``.  Both levels run T-major
through kernels K1 / K1b (:mod:`..ops.bigru_cuda`), differentiably from the
reference-layout GRU weights.  Level 1 declares its input gradient dead
(``need_dx=False``) unless something trainable sits upstream of it: the
cnn_rnn header's conv (``live_input``).

The cnn_rnn header runs a 3x3 same-padding conv (one channel, no bias) and
cuts the image into 4x4 patches before its RNN header.

The text header runs the frozen BERT first, under ``torch.no_grad`` (the
JAX package's ``stop_gradient``), with the reference's quirk replicated:
the collate stacks ``[input_ids, token_type_ids, attention_mask]`` but the
forward reads ``[ids, attention_mask, token_type_ids]``, so slot 1 (the
all-zero type ids) is the attention mask and every key carries the -10000
bias.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..config import ModelSpec
from ..ops.bigru_cuda import bigru_finals_tmajor, bigru_level_tmajor
from ..ops.gru import init_bigru
from ..ops.layernorm import masked_layer_norm
from . import bert as bert_mod


def _init_rnn_header(gen: torch.Generator, input_dim: int, d: int) -> dict:
    if d % 2:
        raise ValueError("RNN header width must be even (bidirectional halves)")
    return {"gru1": init_bigru(gen, input_dim, d // 2),
            "gru2": init_bigru(gen, d, d // 2)}


def _rnn_header_tmajor(params: dict, x: torch.Tensor,
                       live_input: bool = False) -> torch.Tensor:
    """x [B, T, in] -> [B, 1, d] through two K1 levels.  ``live_input``: x
    carries gradients from trainable parameters upstream."""
    x_t = x.transpose(0, 1).contiguous()                  # [T, B, in] once
    hs1 = bigru_level_tmajor(params["gru1"], x_t, need_dx=live_input)
    d = hs1.shape[-1]
    ones = torch.ones(d, dtype=hs1.dtype, device=hs1.device)
    hs1 = masked_layer_norm(hs1, ones, torch.zeros_like(ones))
    hs2 = bigru_level_tmajor(params["gru2"], hs1)
    return bigru_finals_tmajor(hs2)[:, None, :]


def _init_cnn(gen: torch.Generator) -> dict:
    # torch Conv2d(1, 1, 3, bias=False) default: U(-sqrt(1/9), sqrt(1/9))
    bound = math.sqrt(1.0 / 9.0)
    return {"w": torch.empty(1, 1, 3, 3).uniform_(-bound, bound, generator=gen)}


def _cnn_apply(params: dict, x: torch.Tensor, n_patches: int = 4) -> torch.Tensor:
    """x [B, 1, H, W] -> [B, n_patches^2, (H/P)*(W/P)]: 3x3 same-padding
    conv, then a P x P patch grid."""
    y = F.conv2d(x, params["w"], padding=1)
    b, c, h, w = y.shape
    p = n_patches
    y = y.reshape(b, c, p, h // p, p, w // p).permute(0, 2, 4, 1, 3, 5)
    return y.reshape(b, p * p, -1)


def init_header(gen: torch.Generator, spec: ModelSpec, i: int,
                bert_cfg: Optional[bert_mod.BertConfig] = None) -> dict:
    kind = spec.header_kind(spec.modality_set[i])
    orig = spec.orig_dimensions[i]
    if kind == "cnn_rnn":
        return {"cnn": _init_cnn(gen),
                "rnn": _init_rnn_header(gen, (orig // 4) * (orig // 4), spec.dimension)}
    if kind == "bert_rnn":
        cfg = bert_cfg or bert_mod.BertConfig()
        return {"rnn": _init_rnn_header(gen, cfg.hidden_size, spec.dimension)}
    return {"rnn": _init_rnn_header(gen, orig, spec.dimension)}


def bert_text_features(frozen: dict, bert_cfg: Optional[bert_mod.BertConfig],
                       x: torch.Tensor) -> torch.Tensor:
    """[3, B, L] token stack -> [B, L, h] frozen-BERT last hidden states,
    slot 1 used as the attention mask (see the module docstring); no
    gradient flows into the BERT."""
    with torch.no_grad():
        return bert_mod.bert_apply(frozen["bert"], x[0].long(), x[1].float(),
                                   x[2].long(), bert_cfg or bert_mod.BertConfig())


def header_apply(kind: str, params: dict, x: torch.Tensor,
                 frozen: Optional[dict] = None,
                 bert_cfg: Optional[bert_mod.BertConfig] = None) -> torch.Tensor:
    """Dispatch on header kind; returns [B, 1, d]."""
    if kind == "cnn_rnn":
        # the conv is trainable, so level 1 keeps its input gradient
        return _rnn_header_tmajor(params["rnn"], _cnn_apply(params["cnn"], x),
                                  live_input=True)
    if kind == "bert_rnn" and not torch.is_floating_point(x):
        if frozen is None or "bert" not in frozen:
            raise ValueError("a text modality needs the frozen BERT parameters")
        x = bert_text_features(frozen, bert_cfg, x)
    # float input to a bert_rnn header is precomputed BERT features [B, L, h]
    return _rnn_header_tmajor(params["rnn"], x)
