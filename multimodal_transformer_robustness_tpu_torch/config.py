"""Modality-combination algebra and elastic-configuration objects (numpy only).

Counterpart of ``multimodal_transformer_robustness_tpu/config.py``.  The JAX
package's ``__init__`` imports JAX, so even its config module cannot be
imported without it; the port carries its own copy.  The generation
*order* of the combination strings is kept exactly, because slot indices
and parameter names depend on it, and the random topology samplers
(``rand_gen_modality_str``, ``gen_subnet``, ``gen_active_cross``) make the
same numpy ``Generator`` calls in the same order, so one seed gives the
JAX package's configurations exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Amn",
    "AmnSum",
    "ModalityStr",
    "ModelSpec",
    "ActiveConfig",
    "full_active_config",
    "gen_active_cross",
    "gen_subnet",
]


def Amn(m: int, n: int) -> int:
    """Number of n-permutations of m items: m!/(m-n)!."""
    result = 1
    for i in range(m, m - n, -1):
        result *= i
    return result


def AmnSum(m: int) -> int:
    """Sum over n=1..m of Amn(m, n); sizes ``combined_dim = AmnSum(M) * d``."""
    return sum(Amn(m, n) for n in range(1, m + 1))


class ModalityStr:
    """Algebra over modality-combination strings.

    A combination string like ``"tav"`` is a chain of crossmodal attention:
    its query comes from the stream named by its last char and its
    key/value from the stream named by the prefix.
    """

    def __init__(self, modality_set: Sequence[str]):
        self.modality_set = list(modality_set)

    def gen_modality_str(self, input_str: str) -> List[str]:
        """All one-char extensions of ``input_str`` by absent modalities."""
        return [input_str + ch for ch in self.modality_set if ch not in input_str]

    def gen_modality_str_all(self, modality_set: Optional[Sequence[str]] = None) -> List[str]:
        """All combination strings of length >= 2 reachable from the seed set,
        in level order (pairs before triples, ...)."""
        modality_str: List[str] = []
        if len(self.modality_set) == 1:
            return modality_str
        frontier = list(self.modality_set if modality_set is None else modality_set)
        while len(modality_str) == 0 or len(modality_str[-1]) < len(self.modality_set):
            nxt: List[str] = []
            for s in frontier:
                s1 = self.gen_modality_str(s)
                modality_str.extend(s1)
                nxt.extend(s1)
            if not nxt and not modality_str:
                raise ValueError(
                    f"gen_modality_str_all: seed {frontier} admits no extensions")
            frontier = nxt
        return modality_str

    def rand_gen_modality_str(self, modality_set: Sequence[str], p: float = 0.5,
                              rng: Optional[np.random.Generator] = None) -> List[str]:
        """Random chain growth: per level, keep each extension w.p. ``p``."""
        rng = rng if rng is not None else np.random.default_rng()
        if len(modality_set) == len(self.modality_set) == 1:
            raise ValueError("a single modality has no chains to grow")
        modality_str: List[str] = []
        frontier = list(modality_set)
        for _ in range(len(self.modality_set)):
            nxt: List[str] = []
            for s in frontier:
                s_temp = self.gen_modality_str(s)
                probs = rng.random(len(s_temp))
                kept = [s_temp[i] for i in range(len(s_temp)) if probs[i] < p]
                modality_str.extend(kept)
                nxt.extend(kept)
            frontier = nxt
        return modality_str


def gen_subnet(parent_set: Sequence, p: float,
               rng: Optional[np.random.Generator] = None) -> List:
    """Bernoulli(p) subset of a list, order preserving."""
    rng = rng if rng is not None else np.random.default_rng()
    probs = rng.random(len(parent_set))
    return [parent_set[i] for i in range(len(parent_set)) if probs[i] < p]


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static architecture of the supernet: parameter shapes and the static
    execution plan.  Field for field the JAX package's ``ModelSpec``."""

    modality_set: Tuple[str, ...]
    orig_dimensions: Tuple[int, ...]
    dimension: int                      # d: per-stream feature width
    num_heads: int                      # H
    head_dim: int                       # Dh
    layers_single_attn: int             # depth of per-modality mems0 stacks
    layers_cross_attn: int              # depth of cross stacks
    layers_self_attn: int               # depth of per-branch top stacks
    attn_dropout: Tuple[float, ...]     # len == M + 1 (per modality + top)
    relu_dropout: float
    res_dropout: float
    out_dropout: float
    embed_dropout: float
    attn_mask: bool
    output_dim: int
    all_steps: bool = False
    attn_impl: str = "xla"
    compute_dtype: str = "float32"
    header_overrides: Optional[Dict[str, str]] = None

    def __post_init__(self):
        if len(self.attn_dropout) != len(self.orig_dimensions) + 1:
            raise ValueError("attn_dropout needs one entry per modality plus one "
                             "for the top stacks")
        if len(self.modality_set) != len(self.orig_dimensions):
            raise ValueError("modality_set and orig_dimensions differ in length")
        if len(set(self.modality_set)) != len(self.modality_set):
            raise ValueError("modality_set has repeated modalities")

    @property
    def modality_num(self) -> int:
        return len(self.modality_set)

    @property
    def embed_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def ffn_dim(self) -> int:
        return 4 * self.embed_dim

    @property
    def combined_dim(self) -> int:
        return AmnSum(self.modality_num) * self.dimension

    @property
    def top_dim(self) -> int:
        return self.combined_dim // self.modality_num

    @property
    def algebra(self) -> ModalityStr:
        return ModalityStr(self.modality_set)

    @property
    def cross_strings(self) -> Tuple[str, ...]:
        """All crossmodal combination strings, one cross stack each."""
        return tuple(self.algebra.gen_modality_str_all())

    @property
    def slot_lists(self) -> Tuple[Tuple[str, ...], ...]:
        """Per-branch ordered stream slots ``[m_i] + chains(m_i)``."""
        return tuple(
            tuple([ch] + self.algebra.gen_modality_str_all(modality_set=[ch]))
            for ch in self.modality_set)

    @property
    def n_slots(self) -> int:
        return len(self.slot_lists[0])

    def header_kind(self, ch: str) -> str:
        if self.header_overrides and ch in self.header_overrides:
            return self.header_overrides[ch]
        if ch in ("i", "A"):
            return "cnn_rnn"
        if ch == "t":
            return "bert_rnn"
        return "rnn"

    def cross_level_ranges(self) -> Tuple[Tuple[int, int], ...]:
        """Contiguous index ranges of ``cross_strings`` grouped by length."""
        ranges = []
        start = 0
        cs = self.cross_strings
        for i in range(1, len(cs) + 1):
            if i == len(cs) or len(cs[i]) != len(cs[start]):
                ranges.append((start, i))
                start = i
        return tuple(ranges)

    def stream_order(self) -> Tuple[str, ...]:
        """Base modalities first, then cross strings in generation order."""
        return tuple(self.modality_set) + self.cross_strings

    def attn_dropout_for_cross(self, idx: int) -> float:
        """Reference quirk: cross stack 0 gets ``attn_dropout[0]``, every
        later one 0.1."""
        return self.attn_dropout[0] if idx == 0 else 0.1


@dataclasses.dataclass
class ActiveConfig:
    """One runtime configuration of the elastic supernet, lowered to tensors
    by :func:`..masks.build_masks`."""

    active_modality: List[int]
    active_cross: List[List[str]]
    active_cross_output: List[List[str]]
    active_single_attn_layer_num: List[int]
    active_self_attn_layer_num: int
    active_hybrid_attn_layer_num: int
    active_dimension: int               # active FFN hidden width
    active_head_num: int
    active_head_dim: int

    def validate(self, spec: ModelSpec) -> None:
        M = spec.modality_num
        checks = [
            (len(self.active_cross) == M and len(self.active_cross_output) == M,
             "active_cross / active_cross_output need one list per modality"),
            (len(self.active_single_attn_layer_num) == M,
             "active_single_attn_layer_num needs one entry per modality"),
            (0 < self.active_head_num <= spec.num_heads, "active_head_num"),
            (0 < self.active_head_dim <= spec.head_dim, "active_head_dim"),
            (0 < self.active_dimension <= spec.ffn_dim, "active_dimension"),
            (0 <= self.active_self_attn_layer_num <= spec.layers_self_attn,
             "active_self_attn_layer_num"),
            (0 <= self.active_hybrid_attn_layer_num <= spec.layers_cross_attn,
             "active_hybrid_attn_layer_num"),
            (all(0 <= n <= spec.layers_single_attn
                 for n in self.active_single_attn_layer_num),
             "active_single_attn_layer_num"),
        ]
        for ok, what in checks:
            if not ok:
                raise ValueError(f"invalid ActiveConfig: {what}")
        cross_set = set(spec.cross_strings)
        enabled = set()
        for i in self.active_modality:
            for s in self.active_cross[i]:
                if s not in cross_set:
                    raise ValueError(f"unknown cross stream {s!r}")
                enabled.add(s)
        producible = set(spec.modality_set) | enabled
        for s in enabled:
            if s[:-1] not in producible:
                raise ValueError(f"cross stream {s!r} consumes {s[:-1]!r}, "
                                 "which is not produced")
        for i in self.active_modality:
            slots = set(spec.slot_lists[i])
            for s in self.active_cross_output[i]:
                if s not in slots or s not in producible:
                    raise ValueError(f"output stream {s!r} of branch {i} is "
                                     "not a produced slot")


def full_active_config(spec: ModelSpec, ffn_active_dim: Optional[int] = None) -> ActiveConfig:
    """The canonical full-MulT topology used for validation, test and serving.

    ``ffn_active_dim`` defaults to ``spec.dimension``: the reference keeps
    only ``d`` of the ``4*H*Dh`` FFN units active.
    """
    m = spec.algebra
    M = spec.modality_num
    if M > 1:
        cross = [m.gen_modality_str(c) for c in spec.modality_set]
        cross_out = [[c] + m.gen_modality_str(c) for c in spec.modality_set]
    else:
        cross = [[]]
        cross_out = [[spec.modality_set[0]]]
    return ActiveConfig(
        active_modality=list(range(M)),
        active_cross=cross,
        active_cross_output=cross_out,
        active_single_attn_layer_num=[spec.layers_single_attn] * M,
        active_self_attn_layer_num=spec.layers_self_attn,
        active_hybrid_attn_layer_num=spec.layers_cross_attn,
        active_dimension=ffn_active_dim if ffn_active_dim is not None else spec.dimension,
        active_head_num=spec.num_heads,
        active_head_dim=spec.head_dim,
    )


def gen_active_cross(spec: ModelSpec, active_modality: Sequence[int],
                     p_cross: float = 0.6, p_cross_output: float = 0.8,
                     rng: Optional[np.random.Generator] = None
                     ) -> Tuple[List[List[str]], List[List[str]]]:
    """Random fusion topology for the active modalities, with the single-
    modality short cut and the repair pass that makes every active
    modality reach some output."""
    rng = rng if rng is not None else np.random.default_rng()
    M = spec.modality_num
    active_cross: List[List[str]] = [[] for _ in range(M)]
    active_cross_output: List[List[str]] = [[] for _ in range(M)]
    active_modality = list(active_modality)
    if len(active_modality) == 1:
        i = active_modality[0]
        active_cross_output[i] = [spec.modality_set[i]]
        return active_cross, active_cross_output

    m = ModalityStr([spec.modality_set[i] for i in active_modality])
    for i in active_modality:
        active_cross[i] = m.rand_gen_modality_str(
            modality_set=[spec.modality_set[i]], p=p_cross, rng=rng)
        r = [spec.modality_set[i]] + list(active_cross[i])
        active_cross_output[i] = gen_subnet(r, p=p_cross_output, rng=rng)

    # repair: a branch that emits nothing, and whose modality no other
    # branch's outputs carry, gets one output
    for i in active_modality:
        if not active_cross_output[i]:
            ch = spec.modality_set[i]
            if not any(ch in a for j in active_modality for a in active_cross_output[j]):
                active_cross_output[i] = [active_cross[i][0] if active_cross[i] else ch]
    return active_cross, active_cross_output
