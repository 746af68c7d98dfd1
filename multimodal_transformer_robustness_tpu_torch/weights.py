"""Load weights saved under the reference's parameter names.

Counterpart of the name mapping in ``multimodal_transformer_robustness_tpu/
checkpoint.py`` (``export_torch_state_dict`` / ``import_torch_state_dict``).
The kernels' operand layouts are made here, once per load: the K1 GRU
operands (``wp [3, in, H]``, ``wt [3, H, H]``, ``bc``, ``bhn``) and the
transposed BERT weights.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch

from .config import ModelSpec
from .models.bert import prepare_bert
from .models.headers import CNN_TODO, rnn_level_params
from .models.mult import as_f32, to_device


def _rnn_from_sd(sd: Mapping, prefix: str) -> dict:
    def t(name):
        return as_f32(sd[name])

    rnn = {}
    for torch_g, ours in (("lstm1", "gru1"), ("lstm2", "gru2")):
        level = {}
        for suffix, dirn in (("", "fwd"), ("_reverse", "bwd")):
            level[dirn] = {
                "w_ih": t(f"{prefix}.{torch_g}.weight_ih_l0{suffix}"),
                "w_hh": t(f"{prefix}.{torch_g}.weight_hh_l0{suffix}"),
                "b_ih": t(f"{prefix}.{torch_g}.bias_ih_l0{suffix}"),
                "b_hh": t(f"{prefix}.{torch_g}.bias_hh_l0{suffix}"),
            }
        rnn[ours] = rnn_level_params(level)
    return rnn


def _encoder_from_sd(sd: Mapping, prefix: str, spec: ModelSpec, layers: int) -> dict:
    H, Dh = spec.num_heads, spec.head_dim

    def t(name):
        return as_f32(sd[name])

    per_layer = []
    for l in range(layers):
        p = f"{prefix}.layers.{l}"
        w_in = t(f"{p}.self_attn.in_proj_weight")
        e_in = w_in.shape[1]
        per_layer.append({
            "attn": {
                "in_proj_w": w_in.reshape(3, H, Dh, e_in),
                "in_proj_b": t(f"{p}.self_attn.in_proj_bias").reshape(3, H, Dh),
                "out_w": t(f"{p}.self_attn.out_proj.weight").reshape(e_in, H, Dh),
                "out_b": t(f"{p}.self_attn.out_proj.bias"),
            },
            "fc1": {"w": t(f"{p}.fc1.l.weight"), "b": t(f"{p}.fc1.l.bias")},
            "fc2": {"w": t(f"{p}.fc2.l.weight"), "b": t(f"{p}.fc2.l.bias")},
            "ln0": {"g": t(f"{p}.layer_norms.0.ln.weight"),
                    "b": t(f"{p}.layer_norms.0.ln.bias")},
            "ln1": {"g": t(f"{p}.layer_norms.1.ln.weight"),
                    "b": t(f"{p}.layer_norms.1.ln.bias")},
        })
    return {"layers": per_layer,
            "ln": {"g": t(f"{prefix}.layer_norm.ln.weight"),
                   "b": t(f"{prefix}.layer_norm.ln.bias")}}


def load_reference_state_dict(spec: ModelSpec, sd: Mapping,
                              bert: Optional[dict] = None,
                              device="cpu") -> Tuple[dict, dict]:
    """Reference-named state dict -> the port's ``(params, frozen)`` on
    ``device``.

    ``sd`` maps reference names to arrays (numpy or tensors), as
    ``checkpoint.export_torch_state_dict`` writes them.  ``bert`` is the
    frozen BERT in HF layout, layers stacked ``[L, ...]`` (the JAX package's
    ``frozen["bert"]``), or None for a model without a text header.  The
    dead translation weights are not loaded: the forward never reads them.
    """
    proj = []
    for i, ch in enumerate(spec.modality_set):
        kind = spec.header_kind(ch)
        if kind == "cnn_rnn":
            raise NotImplementedError(CNN_TODO)
        proj.append({"rnn": _rnn_from_sd(sd, f"proj.{i}.{1 if kind == 'bert_rnn' else 0}")})
    params = {
        "proj": proj,
        "mems0": [_encoder_from_sd(sd, f"trans_mems0.mems0{ch}", spec,
                                   spec.layers_single_attn) for ch in spec.modality_set],
        "cross": [_encoder_from_sd(sd, f"trans.cross{s}", spec, spec.layers_cross_attn)
                  for s in spec.cross_strings],
        "mems": [_encoder_from_sd(sd, f"trans_mems.mems{ch}", spec, spec.layers_self_attn)
                 for ch in spec.modality_set],
    }
    for name in ("proj1", "proj2", "out_layer"):
        params[name] = {"w": sd[f"{name}.l.weight"], "b": sd[f"{name}.l.bias"]}
    frozen = {"bert": prepare_bert(bert, device)} if bert is not None else {}
    return to_device(params, device), frozen
