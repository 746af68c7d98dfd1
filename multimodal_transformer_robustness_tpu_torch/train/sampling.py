"""Per-batch elastic-configuration sampling: the supernet's training
distribution.

Counterpart of ``multimodal_transformer_robustness_tpu/train/sampling.py``
(experiment types ``random_sample``, ``baseline_ic``, ``baseline_ia``,
``baseline_ib`` and ``test_single``).  Runs on the host with a numpy
``Generator`` and makes the JAX package's calls in its order, so the same
seed gives the same :class:`ActiveConfig`.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence

import numpy as np

from ..config import ActiveConfig, ModalityStr, ModelSpec, gen_active_cross


def sample_train_config(spec: ModelSpec, experiment_type: str,
                        modality_pool: Optional[Sequence[Sequence[int]]],
                        rng: np.random.Generator, all_module: bool = False,
                        specific=None) -> ActiveConfig:
    M = spec.modality_num
    full_layers = dict(
        active_self_attn_layer_num=spec.layers_self_attn,
        active_hybrid_attn_layer_num=spec.layers_cross_attn,
        active_dimension=spec.dimension,   # d of the 4*H*Dh FFN units
        active_head_num=spec.num_heads,
        active_head_dim=spec.head_dim,
    )
    m = spec.algebra

    if experiment_type == "random_sample":
        # a uniform pool pick, a random topology, a random single-attention
        # depth in [0, L_single] per modality
        pool = modality_pool if modality_pool else [list(range(M))]
        active_modality = list(pool[rng.integers(0, len(pool))])
        ac, aco = gen_active_cross(spec, active_modality, rng=rng)
        return ActiveConfig(
            active_modality=active_modality, active_cross=ac, active_cross_output=aco,
            active_single_attn_layer_num=list(
                rng.integers(0, spec.layers_single_attn + 1, size=M)),
            **full_layers)

    if experiment_type == "baseline_ic":
        if all_module:
            all_module_ic = m.gen_modality_str_all(list(spec.modality_set))
            aco = [[s for s in all_module_ic if s[0] == c] for c in spec.modality_set]
            ac = copy.deepcopy(aco)
        else:
            aco = [[c] + m.gen_modality_str(c) for c in spec.modality_set]
            ac = [m.gen_modality_str(c) for c in spec.modality_set]
        return ActiveConfig(
            active_modality=list(range(M)), active_cross=ac, active_cross_output=aco,
            active_single_attn_layer_num=[spec.layers_single_attn] * M,
            **full_layers)

    if experiment_type in ("baseline_ia", "baseline_ib"):
        # no single-attention layers, the canonical MulT topology
        return ActiveConfig(
            active_modality=list(range(M)),
            active_cross=[m.gen_modality_str(c) for c in spec.modality_set],
            active_cross_output=[m.gen_modality_str(c) for c in spec.modality_set],
            active_single_attn_layer_num=[0] * M,
            **full_layers)

    if experiment_type == "test_single":
        # one fixed subset, modality_pool[0]
        if not modality_pool:
            raise ValueError("test_single needs a modality_pool")
        subset = list(modality_pool[0])
        chars = [spec.modality_set[i] for i in subset]
        sub_m = ModalityStr(chars)
        ac: List[List[str]] = [[] for _ in range(M)]
        aco: List[List[str]] = [[] for _ in range(M)]
        if specific is not None:
            ac, aco = specific[0], specific[1]
        elif len(chars) > 1:
            for k, i in enumerate(subset):
                ac[i] = sub_m.gen_modality_str(chars[k])
                aco[i] = sub_m.gen_modality_str(chars[k])
        else:
            aco[subset[0]] = chars
        return ActiveConfig(
            active_modality=subset, active_cross=ac, active_cross_output=aco,
            active_single_attn_layer_num=[spec.layers_single_attn] * M,
            **full_layers)

    raise NotImplementedError(f"No such experiment: {experiment_type}")
