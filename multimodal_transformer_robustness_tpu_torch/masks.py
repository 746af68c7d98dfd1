"""Lowering of :class:`~.config.ActiveConfig` to mask tensors on a device.

Counterpart of ``multimodal_transformer_robustness_tpu/masks.py``.  Every
structural choice of a configuration is data: float 0/1 masks of static
shape.  The forward never reads a mask on the host, so one code path serves
every (modality subset x fusion topology x depth x width) configuration.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import ActiveConfig, ModelSpec

__all__ = ["SupernetMasks", "build_masks", "stack_masks"]


def _prefix(n_active: int, n_total: int) -> np.ndarray:
    m = np.zeros((n_total,), np.float32)
    m[:n_active] = 1
    return m


@dataclasses.dataclass(frozen=True)
class SupernetMasks:
    """The device-side form of one active configuration (float32 tensors)."""

    mems0_gates: torch.Tensor     # [M, L_single]
    cross_gates: torch.Tensor     # [L_cross], shared by all cross stacks
    mems_gates: torch.Tensor      # [L_self]
    head_mask: torch.Tensor       # [H]
    head_dim_mask: torch.Tensor   # [Dh]
    ffn_mask: torch.Tensor        # [ffn_dim]
    cross_enable: torch.Tensor    # [n_cross]
    slot_mask: torch.Tensor       # [M, n_slots]
    branch_gate: torch.Tensor     # [M]

    def channel_mask(self, spec_dimension: int) -> torch.Tensor:
        """Per-branch channel mask over the top-stack width [M, n_slots * d]."""
        gated = self.slot_mask * self.branch_gate[:, None]
        return torch.repeat_interleave(gated, spec_dimension, dim=-1)

    def output_channel_mask(self, spec_dimension: int) -> torch.Tensor:
        """Global channel mask over combined_dim = M * n_slots * d."""
        return self.channel_mask(spec_dimension).reshape(-1)

    def to(self, device) -> "SupernetMasks":
        """The same masks on ``device`` (no copy where they are there)."""
        return SupernetMasks(*(getattr(self, f.name).to(device)
                               for f in dataclasses.fields(self)))


def build_masks(spec: ModelSpec, cfg: ActiveConfig, device="cpu",
                validate: bool = True) -> SupernetMasks:
    """Host-side lowering; the tensors land on ``device`` in one copy each."""
    if validate:
        cfg.validate(spec)
    M = spec.modality_num
    n_slots = spec.n_slots

    if spec.layers_single_attn:
        mems0 = np.stack([_prefix(cfg.active_single_attn_layer_num[i],
                                  spec.layers_single_attn) for i in range(M)])
    else:
        mems0 = np.zeros((M, 0), np.float32)

    enabled = set()
    for i in cfg.active_modality:
        # a branch's chain runs only when the branch emits output
        if cfg.active_cross_output[i]:
            enabled.update(cfg.active_cross[i])
    cross_en = np.array([1.0 if s in enabled else 0.0 for s in spec.cross_strings],
                        np.float32)

    slot = np.zeros((M, n_slots), np.float32)
    branch = np.zeros((M,), np.float32)
    active = set(cfg.active_modality)
    for i in range(M):
        if i in active and cfg.active_cross_output[i]:
            branch[i] = 1.0
            index = {s: k for k, s in enumerate(spec.slot_lists[i])}
            for s in cfg.active_cross_output[i]:
                slot[i, index[s]] = 1.0

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return SupernetMasks(
        mems0_gates=dev(mems0),
        cross_gates=dev(_prefix(cfg.active_hybrid_attn_layer_num, spec.layers_cross_attn)),
        mems_gates=dev(_prefix(cfg.active_self_attn_layer_num, spec.layers_self_attn)),
        head_mask=dev(_prefix(cfg.active_head_num, spec.num_heads)),
        head_dim_mask=dev(_prefix(cfg.active_head_dim, spec.head_dim)),
        ffn_mask=dev(_prefix(cfg.active_dimension, spec.ffn_dim)),
        cross_enable=dev(cross_en),
        slot_mask=dev(slot),
        branch_gate=dev(branch),
    )


def stack_masks(masks: "list[SupernetMasks]") -> SupernetMasks:
    """Stack configurations along a new leading axis: the configuration
    axis that the sweep's trunk maps over.  The stack lands where the
    masks are (``build_masks``' default: the CPU), and moves to the card in
    one copy a leaf (``SupernetMasks.to``)."""
    return SupernetMasks(*(torch.stack([getattr(m, f.name) for m in masks])
                           for f in dataclasses.fields(SupernetMasks)))
