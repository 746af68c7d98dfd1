"""The port's evaluation surface against the JAX package's, on the CPU:
``metrics`` (and sklearn, which the port does not import), ``losses.cmd``,
``masks.stack_masks``, ``Trainer._zero_fill`` / ``evaluate`` and the
sweep's hoisted, configuration-batched eval steps.

The model is ``tests/_torch_pair.py``'s tiny one (d=8, one layer a stack,
the tiny BERT; two mems0 layers where the depth masks matter), dropout off
(eval mode draws nothing), on both packages' XLA / plain paths.
Tolerances: metrics exact (the same float operations; the printed block
byte for byte); ``cmd`` and predictions 1e-5; the hoisted trunk against
the per-configuration ``eval_step`` 1e-6 in the port (the same operations,
batched) and 1e-5 against JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import accuracy_score, f1_score

from multimodal_transformer_robustness_tpu import build_masks as j_build_masks
from multimodal_transformer_robustness_tpu import config as jcfg
from multimodal_transformer_robustness_tpu import metrics as jmetrics
from multimodal_transformer_robustness_tpu import stack_masks as j_stack_masks
from multimodal_transformer_robustness_tpu.data.loaders import BatchIterator as JIter
from multimodal_transformer_robustness_tpu.train import loop as jloop
from multimodal_transformer_robustness_tpu.train.losses import cmd as j_cmd
from multimodal_transformer_robustness_tpu_torch import build_masks as t_build_masks
from multimodal_transformer_robustness_tpu_torch import config as tcfg
from multimodal_transformer_robustness_tpu_torch import metrics as tmetrics
from multimodal_transformer_robustness_tpu_torch import stack_masks as t_stack_masks
from multimodal_transformer_robustness_tpu_torch.data.loaders import BatchIterator as TIter
from multimodal_transformer_robustness_tpu_torch.models.mult import supernet_trunk
from multimodal_transformer_robustness_tpu_torch.train import loop as tloop
from multimodal_transformer_robustness_tpu_torch.train.losses import cmd as t_cmd

from _torch_pair import MoseiLike, build, trainers

PRED_TOL = dict(atol=1e-5, rtol=1e-5)


def _outcome(fn, *args, **kw):
    """What ``fn`` gives: its value, or the type of what it raised."""
    try:
        return fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e)


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and np.isnan(a):
        return np.isnan(b)
    return a == b


_r = np.random.default_rng(3)
METRIC_CASES = {
    "random": (_r.standard_normal(40), _r.standard_normal(40), True),
    # every prediction positive: the F1's False class absent
    "one_class_absent": (np.abs(_r.standard_normal(30)) + 0.1, _r.standard_normal(30), True),
    "all_zero_labels": (_r.standard_normal(12), np.zeros(12), False),
    # zero labels are excluded; the loop on an empty index raises in both
    "all_zero_labels_excluded": (_r.standard_normal(12), np.zeros(12), True),
    "ties_at_zero": (np.array([0.0, 0.0, 0.5, -0.5, 0.0, 1e-9, -1e-9, 2.0]),
                     np.array([0.0, 1.0, -1.0, 0.0, -2.0, 0.5, 0.5, 3.5]), True),
    "ties_at_zero_kept": (np.array([0.0, 0.0, 0.5, -0.5, 0.0, 1e-9, -1e-9, 2.0]),
                          np.array([0.0, 1.0, -1.0, 0.0, -2.0, 0.5, 0.5, 3.5]), False),
}


@pytest.mark.parametrize("name", list(METRIC_CASES))
def test_metrics_match_jax_and_sklearn(name, capsys):
    preds, truth, exclude_zero = METRIC_CASES[name]
    preds, truth = preds.astype(np.float32), truth.astype(np.float32)
    for fn in ("binary_acc", "multiclass_acc", "mosei_multiclass_acc", "weighted_accuracy"):
        args = (preds, truth, exclude_zero) if fn == "binary_acc" else (preds, truth)
        ours, theirs = _outcome(getattr(tmetrics, fn), *args), \
            _outcome(getattr(jmetrics, fn), *args)
        assert _same(ours, theirs), fn
    capsys.readouterr()
    ours = _outcome(tmetrics.eval_mosei_senti, preds, truth, exclude_zero)
    printed_ours = capsys.readouterr().out
    theirs = _outcome(jmetrics.eval_mosei_senti, preds, truth, exclude_zero)
    printed_theirs = capsys.readouterr().out
    assert printed_ours == printed_theirs
    if isinstance(theirs, type):
        assert ours is theirs
        return
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert _same(ours[k], theirs[k]), k
    # the numpy F1 and accuracy against sklearn, both argument orders
    keep = (truth != 0) | (not exclude_zero)
    p, t = preds[keep] > 0, truth[keep] > 0
    for a, b in ((p, t), (t, p)):
        assert tmetrics.weighted_f1_score(a, b) == f1_score(a, b, average="weighted")
        assert tmetrics.accuracy_score(a, b) == accuracy_score(a, b)


def test_cmd_matches_jax():
    r = np.random.default_rng(4)
    x1 = r.standard_normal((24, 7)).astype(np.float32)
    x2 = (0.5 * r.standard_normal((24, 7)) + 0.3).astype(np.float32)
    for n_moments in (1, 5):
        np.testing.assert_allclose(float(t_cmd(torch.from_numpy(x1), torch.from_numpy(x2),
                                                n_moments)),
                                   float(j_cmd(jnp.asarray(x1), jnp.asarray(x2), n_moments)),
                                   **PRED_TOL)


def _configs(spec_cls, cfg_cls, n=10, seed=11):
    """``n`` random configurations: subsets, topologies, depths, widths."""
    spec = spec_cls(**_SPEC2)
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        am = [[0, 1], [0, 2], [1, 2], [0, 1, 2], [1]][r.integers(0, 5)]
        ac, aco = (jcfg if spec_cls is jcfg.ModelSpec else tcfg).gen_active_cross(spec, am, rng=r)
        out.append(cfg_cls(active_modality=am, active_cross=ac, active_cross_output=aco,
                           active_single_attn_layer_num=list(r.integers(0, 3, 3)),
                           active_self_attn_layer_num=int(r.integers(0, 2)),
                           active_hybrid_attn_layer_num=1, active_dimension=int(r.integers(8, 33)),
                           active_head_num=int(r.integers(1, 3)),
                           active_head_dim=int(r.integers(2, 5))))
    return spec, out


# two mems0 layers, so the depth masks vary
_SPEC2 = dict(modality_set=("t", "a", "v"), orig_dimensions=(16, 6, 5), dimension=8,
              num_heads=2, head_dim=4, layers_single_attn=2, layers_cross_attn=1,
              layers_self_attn=1, attn_dropout=(0.0,) * 4, relu_dropout=0.0,
              res_dropout=0.0, out_dropout=0.0, embed_dropout=0.0, attn_mask=True,
              output_dim=1)


def test_stack_masks_matches_jax():
    js, jcfgs = _configs(jcfg.ModelSpec, jcfg.ActiveConfig)
    ts, tcfgs = _configs(tcfg.ModelSpec, tcfg.ActiveConfig)
    theirs = j_stack_masks([j_build_masks(js, c) for c in jcfgs])
    ours = t_stack_masks([t_build_masks(ts, c) for c in tcfgs])
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        assert a.dtype == torch.float32 and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f.name)


@pytest.mark.parametrize("fill", [False, True])
def test_zero_fill_matches_jax(fill):
    r = np.random.default_rng(5)
    text = np.stack([r.integers(1, 50, (4, 6)), np.zeros((4, 6), np.int64),
                     np.ones((4, 6), np.int64)]).astype(np.int32)
    feats = r.standard_normal((4, 6, 3)).astype(np.float32)
    audio = r.standard_normal((4, 5, 2)).astype(np.float32)
    flags = np.array([0.0, 1.0, 0.0], np.float32)
    inputs = [text, audio, feats]
    rows = {2: r.standard_normal((6, 3)).astype(np.float32)} if fill else None
    theirs = jloop._zero_fill([jnp.asarray(x) for x in inputs], jnp.asarray(flags),
                              None if rows is None else {2: jnp.asarray(rows[2])})
    ours = tloop._zero_fill([torch.from_numpy(x) for x in inputs], torch.from_numpy(flags),
                            None if rows is None else {2: torch.from_numpy(rows[2])})
    for a, b in zip(ours, theirs):
        assert a.dtype == torch.from_numpy(np.asarray(b)).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not ours[0].any()                  # token ids zeroed (pad id)
    np.testing.assert_array_equal(ours[1].numpy(), audio)
    np.testing.assert_array_equal(ours[2].numpy(),
                                  np.broadcast_to(rows[2], feats.shape) if fill else 0 * feats)


@pytest.fixture(scope="module")
def pair():
    c = build(0)
    return (c, *trainers(c))


@pytest.mark.parametrize("subset", [(0, 1, 2), (0,), (1, 2), ()])
def test_evaluate_matches_jax(pair, subset):
    """``evaluate`` (zero-filled inputs, a padded tail batch) on both
    packages: predictions 1e-5, labels and metric equal."""
    c, jt, tt = pair
    ds = MoseiLike(10, seed=1)
    masks = tcfg.full_active_config(c["ts"])
    j_metric, j_preds, j_truth = jt.evaluate(JIter(ds, 4), jax.tree.map(
        jnp.asarray, j_build_masks(c["js"], jcfg.full_active_config(c["js"]))), list(subset))
    t_metric, t_preds, t_truth = tt.evaluate(TIter(ds, 4), t_build_masks(c["ts"], masks),
                                             list(subset))
    assert t_preds.shape == (10, 1)
    np.testing.assert_allclose(t_preds, np.asarray(j_preds), **PRED_TOL)
    np.testing.assert_array_equal(t_truth, np.asarray(j_truth))
    assert t_metric == j_metric


class _Cached(MoseiLike):
    """Text already as features, with its zero-fill row (what a
    ``CachedTextDataset`` serves)."""

    def __init__(self, n, seed):
        super().__init__(n, seed)
        r = np.random.default_rng(seed + 100)
        self.feats = r.standard_normal((n, 6, 16)).astype(np.float32)
        self.row = r.standard_normal((6, 16)).astype(np.float32)

    def gather(self, idx):
        inputs, labels = super().gather(idx)
        return [self.feats[idx]] + inputs[1:], labels

    def zero_fill_rows(self):
        return {0: self.row}


def test_evaluate_takes_the_loaders_fill_rows(pair):
    """The text modality dropped on cached features: the loader's row
    stands in for it, in both packages."""
    c, jt, tt = pair
    ds = _Cached(9, seed=2)
    jm = jax.tree.map(jnp.asarray, j_build_masks(c["js"], jcfg.full_active_config(c["js"])))
    tm = t_build_masks(c["ts"], tcfg.full_active_config(c["ts"]))
    j_metric, j_preds, _ = jt.evaluate(JIter(ds, 4), jm, [1, 2])
    t_metric, t_preds, _ = tt.evaluate(TIter(ds, 4), tm, [1, 2])
    np.testing.assert_allclose(t_preds, np.asarray(j_preds), **PRED_TOL)
    assert t_metric == j_metric
    # the Trainer's own rows serve a loader without any
    tt2 = tloop.Trainer(c["ts"], tt.params, tt.frozen, tt.hp, bert_cfg=c["tb"],
                        zero_fill_rows={0: ds.row}, device="cpu")
    plain = type("Plain", (), {"__len__": ds.__len__, "gather": ds.gather})()
    np.testing.assert_array_equal(tt2.evaluate(TIter(plain, 4), tm, [1, 2])[1], t_preds)


def test_sweep_steps_match_per_config():
    """The hoisted headers plus the configuration-batched trunk equal the
    per-configuration ``eval_step`` (port, 1e-6) and JAX's
    ``eval_step_sweep`` (1e-5), with zero flags and a fill row, over 10
    configurations in chunks of 4 (the last chunk short); also in one
    pass over all ten (no chunk)."""
    js, jcfgs = _configs(jcfg.ModelSpec, jcfg.ActiveConfig)
    ts, tcfgs = _configs(tcfg.ModelSpec, tcfg.ActiveConfig)
    c2 = build(1, _SPEC2)
    jt2, tt2 = trainers(c2)
    r = np.random.default_rng(6)
    ds = MoseiLike(6, seed=3)
    inputs, _ = ds.gather(np.arange(6))
    flags = np.array([1.0, 1.0, 0.0], np.float32)
    fill = {2: r.standard_normal((4, 5)).astype(np.float32)}
    t_in = [torch.from_numpy(x) for x in inputs]
    t_flags = torch.from_numpy(flags)
    t_masks = [t_build_masks(ts, cfg) for cfg in tcfgs]
    per_config = torch.stack([tt2.eval_step(tt2.params, m, t_in, t_flags, fill)
                              for m in t_masks])
    swept = tt2.eval_step_sweep(tt2.params, t_stack_masks(t_masks), t_in, t_flags, fill,
                                chunk=4)
    batched = tt2.eval_step_sweep(tt2.params, t_stack_masks(t_masks), t_in, t_flags, fill)
    jt2.cfg_chunk = 4
    theirs = jt2.eval_step_sweep(jt2.params, j_stack_masks(
        [j_build_masks(js, cfg) for cfg in jcfgs]), [jnp.asarray(x) for x in inputs],
        jnp.asarray(flags), fill_rows={2: jnp.asarray(fill[2])})
    assert swept.shape == (10, 6, 1)
    np.testing.assert_allclose(swept.numpy(), per_config.numpy(), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(batched.numpy(), per_config.numpy(), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(swept.numpy(), np.asarray(theirs), **PRED_TOL)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_trunk_configs_route(impl):
    """``trunk_configs`` maps the trunk over the configuration axis in one
    vmap pass on the headers' T == 1 base, which no attention impl runs a
    kernel on, and equals ``supernet_trunk`` per configuration; a T > 1
    base (where flash attention would launch K5f, which vmap cannot
    carry) is refused."""
    ts, tcfgs = _configs(tcfg.ModelSpec, tcfg.ActiveConfig, n=5, seed=12)
    _, tr = trainers(build(2, _SPEC2))
    tr.spec = dataclasses.replace(ts, attn_impl=impl)
    base = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (3, 4, 3, 8)).astype(np.float32))
    masks = [t_build_masks(ts, cfg) for cfg in tcfgs]
    with torch.no_grad():
        got = tr.trunk_configs(tr.params, t_stack_masks(masks), base[:, :, :1])
        ref = torch.stack([supernet_trunk(tr.spec, tr.params, m, base[:, :, :1])
                           for m in masks])
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="T == 1"):
        tr.trunk_configs(tr.params, t_stack_masks(masks), base)
