"""The port's experiment loop (``Trainer.fit``) against the JAX package's,
on the CPU, and its exact resume.

``fit`` over 2 epochs on ``tests/_torch_pair.py``'s tiny model, SGD,
dropout off (the cross quirk patched to 0): the training curve within
1e-5, the parameters within 1e-4 (as the training-step tests hold them),
the plateau lr equal in both schedulers and set on the port's optimizer,
one validation pass an epoch summed as the reference's (M+1) passes, and
the printed epoch lines but their times.  At patience 0, test_single's
equal epoch-2 metric cuts the lr; random_sample's summed metric exceeds 1,
so ``1 - val_acc`` is negative and an equal metric counts as better under
torch's relative threshold: its lr stays, in both packages.  The resume
test holds the port to itself bit for bit: 1 epoch, ``training_state``, a new Trainer,
``load_training_state``, epoch 2, against 2 epochs straight, with dropout
on and Adam so that the generator and the optimizer's moments matter.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_robustness_tpu.data.loaders import BatchIterator as JIter
from multimodal_transformer_robustness_tpu.train import loop as jloop
from multimodal_transformer_robustness_tpu_torch import config as tcfg
from multimodal_transformer_robustness_tpu_torch.data.loaders import BatchIterator as TIter
from multimodal_transformer_robustness_tpu_torch.models import init_supernet
from multimodal_transformer_robustness_tpu_torch.models.bert import tiny_bert_config
from multimodal_transformer_robustness_tpu_torch.train import loop as tloop
from multimodal_transformer_robustness_tpu_torch.weights import export_reference_state_dict
from multimodal_transformer_robustness_tpu.checkpoint import export_torch_state_dict

from _torch_pair import SPEC, MoseiLike, build, no_cross_quirk, trainers

CURVE_TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_TOL = dict(atol=1e-4, rtol=1e-4)
TRAIN, VALID, TEST = MoseiLike(12, seed=6), MoseiLike(10, seed=7), MoseiLike(9, seed=8)
_TIME = re.compile(r"Time +[0-9.]+ sec")


def _epoch_lines(text):
    return [_TIME.sub("Time", x) for x in text.splitlines() if x.startswith(("Epoch", "-"))]


def _loaders(it, start_epoch=1):
    train = it(TRAIN, 4, shuffle=True, seed=2)
    train.set_epoch(start_epoch - 1)
    return train, it(VALID, 4), it(TEST, 4)


@pytest.fixture(scope="module")
def jax_side():
    """One JAX Trainer for both cases (its jitted steps compile once); each
    case resets its state as a new Trainer would hold it."""
    c = build(5)
    return c, trainers(c)[0]


def _fresh(jt, c, hp):
    jt.hp = hp
    jt.params = jax.tree.map(jnp.asarray, c["params_np"])
    jt.opt_state = jt.tx.init(jt.params)
    jt._set_lr(hp.lr)      # tx.init starts from the lr the Trainer was built with
    jt.scheduler = jloop.ReduceLROnPlateau(hp.lr, patience=hp.when)
    jt.rng = np.random.default_rng(hp.seed)
    jt._key = jax.random.PRNGKey(hp.seed)
    jt.training_curve, jt.best_valid, jt._carry_masks = [], -1e8, None
    return jt


@pytest.mark.parametrize("etype,pool", [("random_sample", [[0], [1, 2], [0, 1, 2]]),
                                        ("test_single", [[0, 1, 2], [1]])])
def test_fit_matches_jax(jax_side, etype, pool, capsys):
    c, jt = jax_side
    hp = dict(lr=1e-4, when=0, num_epochs=2, experiment_type=etype, modality_pool=pool)
    _, tt = trainers(c, **hp)
    jt = _fresh(jt, c, jloop.TrainHParams(**{**dataclasses.asdict(tt.hp), **hp}))
    valid_metrics = []
    evaluate = tt.evaluate

    def counted(loader, masks, active):
        out = evaluate(loader, masks, active)
        if loader is loaders[1]:
            valid_metrics.append(out[0])
        return out

    tt.evaluate = counted
    with no_cross_quirk():
        capsys.readouterr()
        j_curve = jt.fit(*_loaders(JIter))
        printed_theirs = capsys.readouterr().out
        loaders = _loaders(TIter)
        t_curve = tt.fit(*loaders)
        printed_ours = capsys.readouterr().out
    assert len(t_curve) == len(j_curve) == 2
    np.testing.assert_allclose(np.asarray(t_curve), np.asarray(j_curve), **CURVE_TOL)
    # one validation pass an epoch; random_sample sums it as M+1 passes
    assert len(valid_metrics) == 2
    for (val, _), v in zip(t_curve, valid_metrics):
        assert val == ((((0.0 + v) + v) + v) + v if etype == "random_sample" else v)
    assert tt.scheduler.lr == pytest.approx(jt.scheduler.lr, rel=1e-12)
    assert (tt.scheduler.lr < tt.hp.lr) == (etype == "test_single")
    assert all(g["lr"] == tt.scheduler.lr for g in tt.opt_state.param_groups)
    assert tt.best_valid == pytest.approx(jt.best_valid, abs=1e-5)
    ours = export_reference_state_dict(c["ts"], tt.params)
    theirs = export_torch_state_dict(c["js"], jt.params)
    for name, a in ours.items():
        np.testing.assert_allclose(a, np.asarray(theirs[name]), err_msg=name, **PARAM_TOL)
    assert _epoch_lines(printed_ours) == _epoch_lines(printed_theirs)
    assert len(_epoch_lines(printed_ours)) == 6
    # test_single trains epoch 2 under its eval masks, random_sample under
    # the full topology; fit leaves them carried
    carried = tt._carry_masks.branch_gate.tolist()
    assert carried == ([0.0, 1.0, 0.0] if etype == "test_single" else [1.0, 1.0, 1.0])


_DROP = dict(SPEC, attn_dropout=(0.1, 0.1, 0.1, 0.1), relu_dropout=0.1, res_dropout=0.1,
             out_dropout=0.1, embed_dropout=0.1)


def _port_trainer(etype, pool, epochs, seed=0):
    spec = tcfg.ModelSpec(**_DROP)
    params, frozen = init_supernet(torch.Generator().manual_seed(seed), spec,
                                   tiny_bert_config())
    hp = tloop.TrainHParams(batch_size=4, lr=1e-3, optim="Adam", num_epochs=epochs,
                            when=0, experiment_type=etype, modality_pool=pool,
                            log_interval=1000)
    return tloop.Trainer(spec, params, frozen, hp, bert_cfg=tiny_bert_config(), device="cpu")


def _leaves_equal(a, b):
    for x, y in zip(tloop.tree_leaves(a), tloop.tree_leaves(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("etype,pool", [("random_sample", [[0], [1, 2], [0, 1, 2]]),
                                        ("test_single", [[0, 1, 2], [1]])])
def test_resume_is_exact(etype, pool):
    straight = _port_trainer(etype, pool, 2)
    straight.fit(*_loaders(TIter))

    first = _port_trainer(etype, pool, 1)
    first.fit(*_loaders(TIter))
    arrays, meta = first.training_state()
    resumed = _port_trainer(etype, pool, 2, seed=9)      # other parameters
    resumed.params = tloop.tree_map(lambda p: p.detach().clone().requires_grad_(True),
                                    first.params)
    resumed.frozen = first.frozen     # the run's BERT: loaded, not resume state
    resumed.opt_state = torch.optim.Adam(tloop.tree_leaves(resumed.params), lr=1.0)
    resumed.load_training_state(arrays, meta)
    first.fit(*_loaders(TIter))   # the snapshot is not shared with ``first``
    resumed.fit(*_loaders(TIter, start_epoch=2), start_epoch=2)

    assert resumed.training_curve == straight.training_curve
    _leaves_equal(resumed.params, straight.params)
    ours, theirs = resumed.opt_state.state_dict(), straight.opt_state.state_dict()
    assert ours["param_groups"] == theirs["param_groups"]
    for k, st in theirs["state"].items():
        for name, v in st.items():
            assert torch.equal(ours["state"][k][name], v), (k, name)
    assert torch.equal(resumed.generator.get_state(), straight.generator.get_state())
    assert resumed.rng.bit_generator.state == straight.rng.bit_generator.state
    assert (resumed.scheduler.lr, resumed.scheduler.best, resumed.scheduler.num_bad) == \
        (straight.scheduler.lr, straight.scheduler.best, straight.scheduler.num_bad)
    assert resumed.best_valid == straight.best_valid
    for f in dataclasses.fields(straight._carry_masks):
        assert torch.equal(getattr(resumed._carry_masks, f.name),
                           getattr(straight._carry_masks, f.name))


def test_lr_floor_stops_and_best_validation_saves():
    """From lr 1e-15 at patience 0 (test_single, an unchanging metric),
    each epoch after the first cuts the lr tenfold, and the run stops after
    the first epoch whose lr is at most 1e-16 (1e-15 * 0.1 is a float step
    above it, so that is epoch 3); ``save_fn`` runs on epoch 1 only (no
    improvement after it) and ``epoch_fn`` every epoch."""
    tr = _port_trainer("test_single", [[0, 1, 2], [1]], 6)
    tr.scheduler.lr = 1e-15
    tr._set_lr(1e-15)
    lr, epochs = 1e-15, 1
    while lr > 1e-16:
        lr, epochs = lr * 0.1, epochs + 1
    saved, ended = [], []
    curve = tr.fit(*_loaders(TIter), save_fn=lambda p, ep, v: saved.append((ep, v)),
                   epoch_fn=lambda t, ep: ended.append(ep))
    assert epochs == 3 and len(curve) == epochs and ended == [1, 2, 3]
    assert [ep for ep, _ in saved] == [1] and saved[0][1] == curve[0][0]
    assert tr.scheduler.lr == lr
    assert all(g["lr"] == lr for g in tr.opt_state.param_groups)
