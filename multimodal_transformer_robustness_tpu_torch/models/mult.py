"""The elastic multimodal-transformer supernet ("dynamic MulT").

Counterpart of ``multimodal_transformer_robustness_tpu/models/mult.py``:

    inputs (one per modality)
      -> projection headers (each collapses its sequence to [B, 1, d])
      -> per-modality self-attention stacks  (``mems0``)
      -> crossmodal stacks, one per combination string (``cross``)
      -> per-branch fused concat + channel-masked top stacks (``mems``)
      -> masked head MLP (proj1 -> ReLU -> dropout -> proj2 + residual
         -> out_layer)

One static plan: every stack runs on every call and the configuration's
masks gate what reaches the fused output, so no branch depends on a mask
value.  The stacks run as a plain Python loop; batching them is later work.

Train mode draws every dropout from one ``torch.Generator`` on the card,
at the JAX package's draw points and per-stack rates: ``attn_dropout[:M]``
for the mems0 stacks, ``spec.attn_dropout_for_cross(j)`` for the cross
stacks (the reference's 0.1 quirk included), ``attn_dropout[-1]`` for the
top stacks, ``out_dropout`` after ``relu(proj1)``.  ``spec.attn_impl =
"flash"`` runs each stack's attention through the flash kernels; every
stack is T==1 after the headers, so that takes the T==1 path, as in the JAX
package, and computes what ``"xla"`` computes, under either compute dtype.

``spec.compute_dtype = "bfloat16"`` is the JAX package's bf16 compute
policy: :func:`compute_cast` casts, at the model's boundary, every float32
tensor the forward reads (the header parameters, float inputs and the
frozen BERT in :func:`supernet_headers`; the trunk's parameters, masks
and base in :func:`supernet_trunk`) to bf16, differentiably, so the
float32 master parameters get float32 gradients; integer token ids keep
their dtype.  The kernels take their bf16 instances, the trunk rounds at
the JAX rounding points (``ops/attention.py``, ``ops/encoder.py``), and
the predictions come back in float32.

Parameters are nested dicts of tensors: ``proj`` (one header dict per
modality, GRU weights in the reference's torch layout), ``mems0`` /
``cross`` / ``mems`` (one encoder dict per stack), ``proj1`` / ``proj2`` /
``out_layer`` (``{"w", "b"}``).  ``frozen`` holds the BERT weights in the
kernels' layout.  The reference's dead ``translation`` linears are not
kept: the forward never reads them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ModelSpec
from ..masks import SupernetMasks
from ..ops.dropout import dropout
from ..ops.encoder import EncoderHParams, EncoderMasks, encoder_forward, init_encoder
from ..ops.linear import init_linear, masked_linear
from . import bert as bert_mod
from .headers import header_apply, init_header

def as_f32(a) -> torch.Tensor:
    """A float32 tensor holding a copy of ``a`` (tensor or numpy array)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32, copy=True)
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def to_device(tree, device, _bases=None):
    """Nested dicts / lists of arrays -> tensors on ``device``: float32, but
    integer arrays (the int8 weights of a quantized BERT) keep their dtype.
    Float tensors that are views of one contiguous tensor (``prepare_bert``'s
    q/k/v weights) stay views of one moved copy."""
    bases = {} if _bases is None else _bases
    if isinstance(tree, dict):
        return {k: to_device(v, device, bases) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device, bases) for v in tree)
    t = tree if isinstance(tree, torch.Tensor) else torch.as_tensor(np.asarray(tree))
    if not t.is_floating_point():
        return t.detach().to(device, copy=True).contiguous()
    base = t._base
    if base is not None and base.is_contiguous() and base.dtype == t.dtype:
        # keyed by id, with the base kept alive so that the id is not reused
        moved = bases.setdefault(id(base), (base, as_f32(base).to(device)))[1]
        return moved.as_strided(t.shape, t.stride(), t.storage_offset() - base.storage_offset())
    return as_f32(t).to(device).contiguous()


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cast_tree(tree, dtype: torch.dtype, _bases: Optional[dict] = None):
    """``tree`` with every float32 tensor cast to ``dtype`` (see
    :func:`compute_cast`)."""
    if dtype == torch.float32:
        return tree
    bases = {} if _bases is None else _bases
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype, bases) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(v, dtype, bases) for v in tree)
    if isinstance(tree, SupernetMasks):
        return tree.to(dtype)
    if not isinstance(tree, torch.Tensor) or tree.dtype != torch.float32:
        return tree
    base = tree._base
    if (base is not None and not tree.requires_grad and base.is_contiguous()
            and base.dtype == torch.float32):
        # views of one frozen tensor (prepare_bert's q/k/v) stay views of
        # one cast copy; keyed by id, the base kept alive
        cast = bases.setdefault(id(base), (base, base.to(dtype)))[1]
        return cast.as_strided(tree.shape, tree.stride(),
                               tree.storage_offset() - base.storage_offset())
    return tree.to(dtype)


def compute_cast(spec: ModelSpec):
    """The compute policy's boundary cast (the JAX package's
    ``_compute_cast``): a function taking a tree of dicts / lists / tensors
    / :class:`SupernetMasks` to the same tree with every float32 tensor in
    ``spec.compute_dtype`` (``Tensor.to``: its backward returns float32
    gradients to a float32 leaf); integer and already-cast tensors are
    kept.  The identity under float32."""
    dtype = COMPUTE_DTYPES[spec.compute_dtype]
    return lambda tree: cast_tree(tree, dtype)


def _hp(spec: ModelSpec, embed_dim: int, layers: int) -> EncoderHParams:
    return EncoderHParams(embed_dim_in=embed_dim, num_heads=spec.num_heads,
                          head_dim=spec.head_dim, layers=layers,
                          attn_mask=spec.attn_mask, relu_dropout=spec.relu_dropout,
                          res_dropout=spec.res_dropout,
                          embed_dropout=spec.embed_dropout, attn_impl=spec.attn_impl)


def _hp_stream(spec: ModelSpec, layers: int) -> EncoderHParams:
    return _hp(spec, spec.dimension, layers)


def _hp_top(spec: ModelSpec) -> EncoderHParams:
    return _hp(spec, spec.top_dim, spec.layers_self_attn)


def _check_spec(spec: ModelSpec) -> None:
    if spec.attn_impl not in ("xla", "flash"):
        raise ValueError(f"unknown attn_impl {spec.attn_impl!r}; valid: 'xla', 'flash'")
    if spec.compute_dtype not in COMPUTE_DTYPES:
        raise NotImplementedError(f"compute_dtype {spec.compute_dtype!r} is not ported "
                                  "(float32 and bfloat16 are): ROADMAP Queue 2, 'bf16'")


def init_supernet(gen: torch.Generator, spec: ModelSpec,
                  bert_cfg: Optional[bert_mod.BertConfig] = None,
                  device="cpu", bert_int8: Optional[str] = None) -> Tuple[dict, dict]:
    """Random init with torch's distributions -> (params, frozen) on
    ``device``.  ``frozen`` holds the BERT weights when a text modality
    exists, in the spec's compute dtype; the parameters are float32.
    ``bert_int8``: ``"ffn"`` (fc1 / fc2, the CLIs' ``--bert_int8``) or
    ``"all"`` (every projection) quantizes the BERT's float32 weights
    (``models/bert.quantize_bert_params``) before the cast to the compute
    dtype, as the JAX package quantizes its float32 BERT before the
    boundary cast."""
    _check_spec(spec)
    if bert_int8 not in (None, "ffn", "all"):
        raise ValueError(f"bert_int8 {bert_int8!r}; valid: None, 'ffn', 'all'")
    M = spec.modality_num
    frozen = {}
    if any(spec.header_kind(c) == "bert_rnn" for c in spec.modality_set):
        cfg = bert_cfg or bert_mod.BertConfig()
        # in the compute dtype once: the boundary cast leaves it as it is
        dtype = COMPUTE_DTYPES[spec.compute_dtype]
        bert = bert_mod.prepare_bert(bert_mod.init_bert(gen, cfg), device,
                                     torch.float32 if bert_int8 else dtype)
        if bert_int8:
            bert = cast_tree(bert_mod.quantize_bert_params(bert, attn=bert_int8 == "all"),
                             dtype)
        frozen["bert"] = bert
    cdim = spec.combined_dim
    params = {
        "proj": [init_header(gen, spec, i, bert_cfg) for i in range(M)],
        "mems0": [init_encoder(gen, _hp_stream(spec, spec.layers_single_attn))
                  for _ in range(M)],
        "cross": [init_encoder(gen, _hp_stream(spec, spec.layers_cross_attn))
                  for _ in spec.cross_strings],
        "mems": [init_encoder(gen, _hp_top(spec)) for _ in range(M)],
        "proj1": init_linear(gen, cdim, cdim),
        "proj2": init_linear(gen, cdim, cdim),
        "out_layer": init_linear(gen, cdim, spec.output_dim),
    }
    return to_device(params, device), frozen


def supernet_headers(spec: ModelSpec, params: dict, inputs: Sequence[torch.Tensor],
                     *, frozen: Optional[dict] = None,
                     bert_cfg: Optional[bert_mod.BertConfig] = None) -> torch.Tensor:
    """Projection headers only: ``inputs`` -> stacked ``base`` [M, B, 1, d]
    in the compute dtype.  Every modality runs, active or not, as in the
    reference."""
    _check_spec(spec)
    cast = compute_cast(spec)
    proj, inputs = cast(params["proj"]), cast(list(inputs))
    if frozen is not None:
        frozen = cast(frozen)
    return torch.stack([
        header_apply(spec.header_kind(ch), proj[i], inputs[i], frozen, bert_cfg)
        for i, ch in enumerate(spec.modality_set)])


def supernet_trunk(spec: ModelSpec, params: dict, masks: SupernetMasks,
                   base: torch.Tensor, *, train: bool = False,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Mask-dependent remainder: ``base`` [M, B, T, d] -> mems0 -> cross ->
    top -> head MLP -> predictions [B, output_dim] (or [B, T, output_dim]
    when ``spec.all_steps``).  Train mode draws its dropout from
    ``generator`` (one seeded 0 on ``base``'s device when None, as the JAX
    package falls back to ``PRNGKey(0)``).  Parameters, masks and ``base``
    are cast to the compute dtype here; the predictions are float32."""
    _check_spec(spec)
    cast = compute_cast(spec)
    params = cast({k: params[k] for k in ("mems0", "cross", "mems", "proj1", "proj2",
                                          "out_layer")})
    masks, base = cast(masks), cast(base)
    M, d = spec.modality_num, spec.dimension
    if train and generator is None:
        generator = torch.Generator(device=base.device).manual_seed(0)
    run = dict(train=train, generator=generator)

    hp0 = _hp_stream(spec, spec.layers_single_attn)
    streams: List[torch.Tensor] = [
        encoder_forward(params["mems0"][i], base[i], hp=hp0, masks=EncoderMasks(
            masks.mems0_gates[i], masks.head_mask, masks.head_dim_mask,
            masks.ffn_mask), attn_rate=spec.attn_dropout[i], **run)
        for i in range(M)]

    # cross strings come level by level, so a string's prefix stream is
    # always produced before it; stream index = position in stream_order()
    pos = {s: i for i, s in enumerate(spec.stream_order())}
    hp_c = _hp_stream(spec, spec.layers_cross_attn)
    m_cross = EncoderMasks(masks.cross_gates, masks.head_mask,
                           masks.head_dim_mask, masks.ffn_mask)
    for j, s in enumerate(spec.cross_strings):
        streams.append(encoder_forward(params["cross"][j], streams[pos[s[-1]]],
                                       streams[pos[s[:-1]]], hp=hp_c, masks=m_cross,
                                       attn_rate=spec.attn_dropout_for_cross(j), **run))

    all_streams = torch.stack(streams)                               # [n, B, T, d]
    slot_idx = torch.tensor([[pos[s] for s in spec.slot_lists[i]] for i in range(M)],
                            device=base.device)
    gated_slots = masks.slot_mask * masks.branch_gate[:, None]       # [M, S]
    x_top = all_streams[slot_idx] * gated_slots[:, :, None, None, None]
    m_, s_, b_, t_, _ = x_top.shape
    x_top = x_top.permute(0, 2, 3, 1, 4).reshape(m_, b_, t_, s_ * d)

    hp_t = _hp_top(spec)
    ch_masks = masks.channel_mask(d)                                 # [M, E_top]
    h_top = torch.stack([
        encoder_forward(params["mems"][i], x_top[i], hp=hp_t, masks=EncoderMasks(
            masks.mems_gates, masks.head_mask, masks.head_dim_mask,
            masks.ffn_mask, ch_masks[i]), attn_rate=spec.attn_dropout[-1], **run)
        for i in range(M)])                                          # [M, B, T, E_top]

    if spec.all_steps:
        out = h_top.permute(1, 2, 0, 3).reshape(b_, t_, -1)
    else:
        out = h_top[:, :, -1, :].permute(1, 0, 2).reshape(b_, -1)

    ch = masks.output_channel_mask(d)
    h1 = torch.relu(masked_linear(out, params["proj1"]["w"], params["proj1"]["b"]))
    h1 = dropout(h1, spec.out_dropout, train, generator)
    h2 = masked_linear(h1, params["proj2"]["w"], params["proj2"]["b"], mask_out=ch)
    h2 = h2 + out
    return masked_linear(h2, params["out_layer"]["w"], params["out_layer"]["b"]).float()


def supernet_apply(spec: ModelSpec, params: dict, masks: SupernetMasks,
                   inputs: Sequence[torch.Tensor], *, frozen: Optional[dict] = None,
                   bert_cfg: Optional[bert_mod.BertConfig] = None,
                   train: bool = False,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Forward pass.  ``inputs``: one tensor per modality (text: [3, B, L]
    integer stack; images: [B, 1, H, W]; sequences: [B, T, feat]).  The
    headers draw nothing (the reference's header dropout is dead code), so
    ``train`` and ``generator`` reach the trunk only."""
    base = supernet_headers(spec, params, inputs, frozen=frozen, bert_cfg=bert_cfg)
    return supernet_trunk(spec, params, masks, base, train=train, generator=generator)
