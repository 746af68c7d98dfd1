"""The port's missing-modality sweep against the JAX package's, on the CPU.

The enumerators (subsets, depth combinations, the 13 two-modality
candidates with their duplicates, ``specific`` for test_single) must be
equal exactly; ``missing_modality_sweep`` and ``masking_inputs_sweep`` on
``tests/_torch_pair.py``'s tiny model (one mems0 layer: 4 depth
combinations, so 172 configurations, the two-modality grids of 52 padded
to 64 in chunks of 16) must give each configuration's validation
predictions within 1e-5 and its accuracy, each subset's best configuration,
its accuracies and the printed lines exactly, and the MOSEI metrics within
1e-5.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_robustness_tpu import build_masks as j_build_masks
from multimodal_transformer_robustness_tpu import config as jcfg
from multimodal_transformer_robustness_tpu import stack_masks as j_stack_masks
from multimodal_transformer_robustness_tpu.data.loaders import BatchIterator as JIter
from multimodal_transformer_robustness_tpu.train import sweep as jsweep
from multimodal_transformer_robustness_tpu_torch import build_masks as t_build_masks
from multimodal_transformer_robustness_tpu_torch import config as tcfg
from multimodal_transformer_robustness_tpu_torch import stack_masks as t_stack_masks
from multimodal_transformer_robustness_tpu_torch.data.loaders import BatchIterator as TIter
from multimodal_transformer_robustness_tpu_torch.train import sweep as tsweep

from _torch_pair import SPEC, MoseiLike, build, trainers

PRED_TOL = dict(atol=1e-5, rtol=1e-5)
CHUNK = 16
EXPERIMENTS = ["random_sample", "baseline_ic", "baseline_ia", "baseline_ib", "test_single"]


@pytest.mark.parametrize("etype", EXPERIMENTS)
@pytest.mark.parametrize("spec_kw", [dict(), dict(layers_single_attn=3),
                                     dict(modality_set=("t", "a"), orig_dimensions=(16, 6),
                                          attn_dropout=(0.0,) * 3)])
def test_enumerators_match_jax(etype, spec_kw):
    js, ts = jcfg.ModelSpec(**{**SPEC, **spec_kw}), tcfg.ModelSpec(**{**SPEC, **spec_kw})
    assert tsweep.subset_choices(ts, etype) == jsweep.subset_choices(js, etype)
    assert tsweep.depth_combos(ts, etype) == jsweep.depth_combos(js, etype)
    assert tsweep.two_modality_candidates("a", "v") == jsweep.two_modality_candidates("a", "v")
    M = ts.modality_num
    specific = [None, [[] for _ in range(M)]]
    specific[1][M - 1] = [ts.modality_set[M - 1]]
    for subset in jsweep.subset_choices(js, etype):
        for spc in (None, specific):
            theirs = jsweep.enumerate_subset_candidates(js, etype, subset, spc)
            assert tsweep.enumerate_subset_candidates(ts, etype, subset, spc) == theirs
            # the grid the sweep stacks: depth major, topology minor
            ours = tsweep.subset_configs(ts, etype, subset, spc)
            assert [dataclasses.asdict(c) for c in ours] == [
                dataclasses.asdict(jcfg.ActiveConfig(
                    active_modality=list(subset), active_cross=[list(x) for x in theirs[0]],
                    active_cross_output=[list(x) for x in a],
                    active_single_attn_layer_num=list(l),
                    active_self_attn_layer_num=js.layers_self_attn,
                    active_hybrid_attn_layer_num=js.layers_cross_attn,
                    active_dimension=js.dimension, active_head_num=js.num_heads,
                    active_head_dim=js.head_dim))
                for l in jsweep.depth_combos(js, etype) for a in theirs[1]]
    if etype == "random_sample" and M == 3:
        n = sum(len(tsweep.subset_configs(ts, etype, s))
                for s in tsweep.subset_choices(ts, etype))
        # the MOSEI grid (three mems0 layers) has 860 configurations
        assert n == (860 if ts.layers_single_attn == 3 else 172)


@pytest.fixture(scope="module")
def pair():
    c = build(3)
    jt, tt = trainers(c, experiment_type="random_sample")
    return c, jt, tt, MoseiLike(10, seed=4), MoseiLike(9, seed=5)


_FLOAT = re.compile(r"^\"(MAE|Correlation Coefficient)\": ")


def _lines(text):
    """The printed lines, those with a float taken in another order than
    JAX's (MAE, correlation) held apart."""
    lines = text.splitlines()
    return [x for x in lines if not _FLOAT.match(x)], [x for x in lines if _FLOAT.match(x)]


def test_missing_modality_sweep_matches_jax(pair, capsys):
    c, jt, tt, valid, test = pair
    capsys.readouterr()
    theirs = jsweep.missing_modality_sweep(jt, JIter(valid, 4), JIter(test, 4),
                                           max_cfg_chunk=CHUNK)
    printed_theirs = capsys.readouterr().out
    ours = tsweep.missing_modality_sweep(tt, TIter(valid, 4), TIter(test, 4),
                                         max_cfg_chunk=CHUNK)
    printed_ours = capsys.readouterr().out
    assert list(ours) == list(theirs) and len(ours) == 7
    for subset, entry in ours.items():
        ref = theirs[subset]
        assert dataclasses.asdict(entry["best_cfg"]) == dataclasses.asdict(ref["best_cfg"])
        assert entry["valid_acc"] == ref["valid_acc"]
        assert entry["test_acc"] == ref["test_acc"]
        for k, v in entry["metrics"].items():
            np.testing.assert_allclose(v, ref["metrics"][k], err_msg=k, **PRED_TOL)
    exact_ours, float_ours = _lines(printed_ours)
    exact_theirs, float_theirs = _lines(printed_theirs)
    assert exact_ours == exact_theirs
    assert len(float_ours) == len(float_theirs) == 14

    # each configuration's validation predictions and accuracy, through the
    # same padded stacks and chunks the sweeps used
    t_batches = [b for b in TIter(valid, 4)]
    keep = np.concatenate([b.valid for b in t_batches]) > 0
    truth = valid.labels
    flags_t, flags_j = torch.ones(3), jnp.ones(3)
    for subset in tsweep.subset_choices(tt.spec, "random_sample"):
        cfgs = tsweep.subset_configs(tt.spec, "random_sample", subset)
        n = len(cfgs)
        padded = cfgs + [cfgs[-1]] * ((-n) % CHUNK if n > CHUNK else 0)
        t_stack = t_stack_masks([t_build_masks(tt.spec, x) for x in padded])
        j_stack = j_stack_masks([j_build_masks(
            jt.spec, jcfg.ActiveConfig(**dataclasses.asdict(x))) for x in padded])
        ours_p = torch.cat([tt.eval_step_sweep(tt.params, t_stack,
                                               [torch.as_tensor(x) for x in b.inputs], flags_t,
                                               chunk=CHUNK)
                            for b in t_batches], dim=1).numpy()[:n, keep]
        theirs_p = np.concatenate([np.asarray(jt.eval_step_sweep(
            jt.params, j_stack, [jnp.asarray(x) for x in b.inputs], flags_j))
            for b in t_batches], axis=1)[:n, keep]
        np.testing.assert_allclose(ours_p, theirs_p, **PRED_TOL)
        accs = [tt._metric(p, truth) for p in ours_p]
        assert accs == [jt._metric(p, truth) for p in theirs_p]
        best = int(np.argmax(accs))
        assert dataclasses.asdict(cfgs[best]) == dataclasses.asdict(ours[subset]["best_cfg"])


def test_masking_inputs_sweep_matches_jax(pair, capsys):
    c, jt, tt, valid, test = pair
    capsys.readouterr()
    theirs = jsweep.masking_inputs_sweep(jt, JIter(test, 4))
    printed_theirs = capsys.readouterr().out
    ours = tsweep.masking_inputs_sweep(tt, TIter(test, 4))
    printed_ours = capsys.readouterr().out
    assert list(ours) == list(theirs) and len(ours) == 8
    for subset, metrics in ours.items():
        for k, v in metrics.items():
            np.testing.assert_allclose(v, theirs[subset][k], err_msg=f"{subset} {k}",
                                       **PRED_TOL)
    assert _lines(printed_ours)[0] == _lines(printed_theirs)[0]
