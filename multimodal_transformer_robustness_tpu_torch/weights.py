"""Weights under the reference's parameter names, both ways.

Counterpart of the name mapping in ``multimodal_transformer_robustness_tpu/
checkpoint.py`` (``export_torch_state_dict`` / ``import_torch_state_dict``).
The port's parameters keep the reference layout (GRU ``w_ih / w_hh / b_ih /
b_hh``, the packed attention in-projection viewed ``[3, H, Dh, E_in]``), so
the two directions are reshapes; only the frozen BERT is turned into the
kernels' layout, once per load.  The reference's dead ``translation``
linears are neither loaded nor exported: the forward never reads them.
:func:`load_encoder_stack` carries one encoder stack across on its own.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from .config import ModelSpec
from .models.bert import prepare_bert
from .models.mult import as_f32, to_device

_GRU_NAMES = (("lstm1", "gru1"), ("lstm2", "gru2"))
_DIR_NAMES = (("", "fwd"), ("_reverse", "bwd"))
_GRU_LEAVES = (("weight_ih_l0", "w_ih"), ("weight_hh_l0", "w_hh"),
               ("bias_ih_l0", "b_ih"), ("bias_hh_l0", "b_hh"))


def _header_prefixes(spec: ModelSpec, i: int) -> Tuple[Optional[str], str]:
    """(conv name prefix or None, RNN name prefix) of header ``i``: the
    reference's Sequential member indices per header kind."""
    kind = spec.header_kind(spec.modality_set[i])
    if kind == "cnn_rnn":
        return f"proj.{i}.0.cnn1", f"proj.{i}.1"
    return None, f"proj.{i}.{1 if kind == 'bert_rnn' else 0}"


def _encoder_leaves(prefix: str, layers: int):
    """(reference name, path in the port's encoder dict) for every leaf."""
    out = []
    for l in range(layers):
        p, q = f"{prefix}.layers.{l}", ("layers", l)
        out += [(f"{p}.self_attn.in_proj_weight", q + ("attn", "in_proj_w")),
                (f"{p}.self_attn.in_proj_bias", q + ("attn", "in_proj_b")),
                (f"{p}.self_attn.out_proj.weight", q + ("attn", "out_w")),
                (f"{p}.self_attn.out_proj.bias", q + ("attn", "out_b")),
                (f"{p}.fc1.l.weight", q + ("fc1", "w")), (f"{p}.fc1.l.bias", q + ("fc1", "b")),
                (f"{p}.fc2.l.weight", q + ("fc2", "w")), (f"{p}.fc2.l.bias", q + ("fc2", "b")),
                (f"{p}.layer_norms.0.ln.weight", q + ("ln0", "g")),
                (f"{p}.layer_norms.0.ln.bias", q + ("ln0", "b")),
                (f"{p}.layer_norms.1.ln.weight", q + ("ln1", "g")),
                (f"{p}.layer_norms.1.ln.bias", q + ("ln1", "b"))]
    return out + [(f"{prefix}.layer_norm.ln.weight", ("ln", "g")),
                  (f"{prefix}.layer_norm.ln.bias", ("ln", "b"))]


def _named_leaves(spec: ModelSpec):
    """Every (reference name, path into the port's params) pair, in the
    reference's module order."""
    out = []
    for i in range(spec.modality_num):
        cnn, rnn = _header_prefixes(spec, i)
        if cnn is not None:
            out.append((f"{cnn}.weight", ("proj", i, "cnn", "w")))
        for torch_g, ours in _GRU_NAMES:
            for suffix, dirn in _DIR_NAMES:
                out += [(f"{rnn}.{torch_g}.{leaf}{suffix}", ("proj", i, "rnn", ours, dirn, k))
                        for leaf, k in _GRU_LEAVES]
    stacks = ([("mems0", j, f"trans_mems0.mems0{ch}", spec.layers_single_attn)
               for j, ch in enumerate(spec.modality_set)]
              + [("cross", j, f"trans.cross{s}", spec.layers_cross_attn)
                 for j, s in enumerate(spec.cross_strings)]
              + [("mems", j, f"trans_mems.mems{ch}", spec.layers_self_attn)
                 for j, ch in enumerate(spec.modality_set)])
    for group, j, prefix, layers in stacks:
        out += [(name, (group, j) + path) for name, path in _encoder_leaves(prefix, layers)]
    for lin in ("proj1", "proj2", "out_layer"):
        out += [(f"{lin}.l.weight", (lin, "w")), (f"{lin}.l.bias", (lin, "b"))]
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _empty_tree(spec: ModelSpec) -> dict:
    def enc(layers):
        return {"layers": [{"attn": {}, "fc1": {}, "fc2": {}, "ln0": {}, "ln1": {}}
                           for _ in range(layers)], "ln": {}}

    proj = []
    for i in range(spec.modality_num):
        h = {"rnn": {g: {d: {} for _, d in _DIR_NAMES} for _, g in _GRU_NAMES}}
        if _header_prefixes(spec, i)[0] is not None:
            h["cnn"] = {}
        proj.append(h)
    return {"proj": proj,
            "mems0": [enc(spec.layers_single_attn) for _ in spec.modality_set],
            "cross": [enc(spec.layers_cross_attn) for _ in spec.cross_strings],
            "mems": [enc(spec.layers_self_attn) for _ in spec.modality_set],
            "proj1": {}, "proj2": {}, "out_layer": {}}


def load_reference_state_dict(spec: ModelSpec, sd: Mapping,
                              bert: Optional[dict] = None,
                              device="cpu") -> Tuple[dict, dict]:
    """Reference-named state dict -> the port's ``(params, frozen)`` on
    ``device``.

    ``sd`` maps reference names to arrays (numpy or tensors), as
    ``checkpoint.export_torch_state_dict`` writes them.  ``bert`` is the
    frozen BERT in HF layout, layers stacked ``[L, ...]`` (the JAX package's
    ``frozen["bert"]``), float or already quantized (its ``{"q": int8, "s":
    float32}`` weight dicts, from ``quantize_bert_params``), or None for a
    model without a text header.
    """
    H, Dh = spec.num_heads, spec.head_dim
    params = _empty_tree(spec)
    for name, path in _named_leaves(spec):
        a = as_f32(sd[name])
        if path[-1] == "in_proj_w":
            a = a.reshape(3, H, Dh, -1)
        elif path[-1] == "in_proj_b":
            a = a.reshape(3, H, Dh)
        elif path[-1] == "out_w":
            a = a.reshape(-1, H, Dh)
        _get(params, path[:-1])[path[-1]] = a
    frozen = {"bert": prepare_bert(bert, device)} if bert is not None else {}
    return to_device(params, device), frozen


def export_reference_state_dict(spec: ModelSpec, params: dict) -> Dict[str, np.ndarray]:
    """The port's parameters (or a tree of the same shape, e.g. their
    gradients) -> numpy arrays under the reference's names, the inverse of
    :func:`load_reference_state_dict`."""
    e = spec.embed_dim
    out = {}
    for name, path in _named_leaves(spec):
        a = _get(params, path).detach().cpu().numpy()
        if path[-1] == "in_proj_w":
            a = a.reshape(3 * e, -1)
        elif path[-1] == "in_proj_b":
            a = a.reshape(3 * e)
        elif path[-1] == "out_w":
            a = a.reshape(-1, e)
        out[name] = a
    return out


def load_encoder_stack(stacked: Mapping, device="cpu") -> dict:
    """One encoder stack as the JAX package's ``init_encoder`` builds it
    (nested dicts of arrays, the layers' leaves stacked on axis 0, plus the
    final ``ln``) -> the port's ``{"layers": [one dict per layer], "ln"}``
    on ``device``.  Takes numpy arrays or anything ``np.asarray`` reads."""
    def layer(tree, i):
        if isinstance(tree, Mapping):
            return {k: layer(v, i) for k, v in tree.items()}
        return np.array(np.asarray(tree)[i])   # a writable copy

    n = np.asarray(stacked["layers"]["ln0"]["g"]).shape[0]
    return to_device({"layers": [layer(stacked["layers"], i) for i in range(n)],
                      "ln": {k: np.array(v) for k, v in stacked["ln"].items()}}, device)
