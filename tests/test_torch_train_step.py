"""The port's training step against the JAX package's, on the CPU.

JAX parameters from ``init_supernet`` cross over through
``checkpoint.export_torch_state_dict`` plus the frozen BERT as numpy, into
``weights.load_reference_state_dict``; gradients and updated parameters
come back through ``weights.export_reference_state_dict`` and are compared
name by name.  The spec is ``tests/test_torch_slice.py``'s tiny one with
every dropout rate 0, and both packages' ``attn_dropout_for_cross`` are
patched to 0.0 (the reference's 0.1 quirk for the later cross stacks would
draw, and ``jax.random`` and ``torch.Generator`` draw different streams).
The masks come from ``sample_train_config``; the batch has a padded tail,
so the ``valid`` weighting is exercised.  The JAX side runs once on its XLA
path and once through its Pallas kernels in interpret mode.

Tolerances: the loss at atol = rtol = 1e-5; gradients and parameters after
SGD steps at 1e-4 (float32, but the step chains a BERT, two GRU levels and
eleven encoder stacks forward and back, summed in different orders).
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_robustness_tpu import build_masks as j_build_masks
from multimodal_transformer_robustness_tpu import config as jcfg
from multimodal_transformer_robustness_tpu.checkpoint import export_torch_state_dict
from multimodal_transformer_robustness_tpu.data.loaders import Batch as JBatch
from multimodal_transformer_robustness_tpu.models import bert as jbert
from multimodal_transformer_robustness_tpu.models import init_supernet as j_init
from multimodal_transformer_robustness_tpu.models import supernet_apply as j_apply
from multimodal_transformer_robustness_tpu.ops import bert_attn_pallas, bert_ffn_pallas, bigru_pallas
from multimodal_transformer_robustness_tpu.ops import gru as jgru
from multimodal_transformer_robustness_tpu.train import loop as jloop
from multimodal_transformer_robustness_tpu.train.sampling import sample_train_config
from multimodal_transformer_robustness_tpu_torch import config as tcfg
from multimodal_transformer_robustness_tpu_torch.data.loaders import Batch as TBatch
from multimodal_transformer_robustness_tpu_torch.masks import build_masks as t_build_masks
from multimodal_transformer_robustness_tpu_torch.models import bert as tbert
from multimodal_transformer_robustness_tpu_torch.train import loop as tloop
from multimodal_transformer_robustness_tpu_torch.weights import (
    export_reference_state_dict, load_reference_state_dict)

LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
_SPEC = dict(modality_set=("t", "a", "v"), orig_dimensions=(128, 10, 12),
             dimension=8, num_heads=2, head_dim=4, layers_single_attn=2,
             layers_cross_attn=2, layers_self_attn=1,
             attn_dropout=(0.0, 0.0, 0.0, 0.0), relu_dropout=0.0,
             res_dropout=0.0, out_dropout=0.0, embed_dropout=0.0,
             attn_mask=True, output_dim=1)
B, L, TA, TV = 4, 8, 6, 5


@pytest.fixture(autouse=True)
def _no_cross_quirk():
    zero = lambda self, idx: 0.0  # noqa: E731
    with mock.patch.object(jcfg.ModelSpec, "attn_dropout_for_cross", zero), \
            mock.patch.object(tcfg.ModelSpec, "attn_dropout_for_cross", zero):
        yield


@pytest.fixture(scope="module")
def case():
    js, ts = jcfg.ModelSpec(**_SPEC), tcfg.ModelSpec(**_SPEC)
    jb_cfg = jbert.tiny_bert_config(hidden=128, heads=2, layers=2)
    tb_cfg = tbert.tiny_bert_config(hidden=128, heads=2, layers=2)
    params, frozen = j_init(jax.random.PRNGKey(0), js, bert_cfg=jb_cfg, use_jit=False)
    bert_np = jax.tree.map(np.asarray, frozen["bert"])
    # the JAX train step donates its parameters: every use takes a fresh copy
    params_np = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(0)

    def batch():
        attn = np.ones((B, L), np.int64)
        attn[1, 5:] = 0
        text = np.stack([rng.integers(0, jb_cfg.vocab_size, (B, L)) * attn,
                         np.zeros((B, L), np.int64), attn])
        audio = rng.standard_normal((B, TA, 10)).astype(np.float32)
        vision = rng.standard_normal((B, TV, 12)).astype(np.float32)
        labels = rng.standard_normal((B, 1)).astype(np.float32)
        valid = np.array([1, 1, 1, 0], np.float32)          # a padded tail row
        return [text, audio, vision], labels, valid

    cfg = sample_train_config(js, "random_sample", None, np.random.default_rng(5))
    return dict(js=js, ts=ts, jb_cfg=jb_cfg, tb_cfg=tb_cfg, params_np=params_np,
                frozen=frozen, bert_np=bert_np, sd=export_torch_state_dict(js, params),
                batches=[batch() for _ in range(3)], cfg=cfg)


def _use_impl(monkeypatch, impl):
    """The JAX side through its Pallas kernels in interpret mode; the spies
    record that each kernel, the GRU backward included, really ran."""
    seen = set()
    if impl == "pallas_interpret":
        monkeypatch.setattr(jgru, "RECURRENCE_IMPL", "pallas_interpret")
        monkeypatch.setattr(jbert, "FFN_INTERPRET", True)
        for mod, name in ((bigru_pallas, "_fwd_impl"), (bigru_pallas, "_bwd_impl"),
                          (bert_attn_pallas, "attention_block_fused"),
                          (bert_ffn_pallas, "ffn_ln_block")):
            def spy(*a, _orig=getattr(mod, name), _name=name, **k):
                seen.add(_name)
                return _orig(*a, **k)
            monkeypatch.setattr(mod, name, spy)
    return seen


def _jparams(c):
    return jax.tree.map(jnp.asarray, c["params_np"])


def _trainers(c, **hp_kw):
    kw = dict(batch_size=B, lr=1e-2, optim="SGD", criterion="L1Loss", seed=7)
    kw.update(hp_kw)
    jt = jloop.Trainer(c["js"], _jparams(c), c["frozen"], jloop.TrainHParams(**kw),
                       bert_cfg=c["jb_cfg"])
    tp, tf = load_reference_state_dict(c["ts"], c["sd"], c["bert_np"])
    tt = tloop.Trainer(c["ts"], tp, tf, tloop.TrainHParams(**kw), bert_cfg=c["tb_cfg"],
                       device="cpu")
    return jt, tt


def _masks(c):
    jm = jax.tree.map(jnp.asarray, j_build_masks(c["js"], c["cfg"]))
    tm = t_build_masks(c["ts"], tcfg.ActiveConfig(**dataclasses.asdict(c["cfg"])))
    return jm, tm


def _t_batch(b):
    inputs, labels, valid = b
    return [torch.from_numpy(x) for x in inputs], torch.from_numpy(labels), \
        torch.from_numpy(valid)


def _j_batch(b):
    inputs, labels, valid = b
    return [jnp.asarray(inputs[0], jnp.int32)] + [jnp.asarray(x) for x in inputs[1:]], \
        jnp.asarray(labels), jnp.asarray(valid)


def _close_named(ours: dict, theirs: dict, **tol):
    theirs = {k: v for k, v in theirs.items() if not k.startswith("translation.")}
    assert sorted(ours) == sorted(theirs)
    for name in ours:
        np.testing.assert_allclose(ours[name], np.asarray(theirs[name]), err_msg=name,
                                   **tol)


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_train_step_matches(case, impl, monkeypatch):
    """The loss and every gradient of one step on both JAX paths, then the
    parameters after ``Trainer.train_step`` (SGD)."""
    c = case
    seen = _use_impl(monkeypatch, impl)
    jt, tt = _trainers(c)
    jm, tm = _masks(c)
    j_in, j_lab, j_val = _j_batch(c["batches"][0])
    t_in, t_lab, t_val = _t_batch(c["batches"][0])

    def loss_fn(p):
        preds = j_apply(c["js"], p, jm, j_in, frozen=c["frozen"], bert_cfg=c["jb_cfg"],
                        train=True, rng=jax.random.PRNGKey(0))
        return jloop.make_criterion("L1Loss")(preds, j_lab, j_val)

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(_jparams(c))
    t_loss, t_grads = tt.loss_and_grads(tt.params, tm, t_in, t_lab, t_val, tt.generator)
    np.testing.assert_allclose(float(t_loss), float(j_loss), **LOSS_TOL)
    _close_named(export_reference_state_dict(c["ts"], t_grads),
                 export_torch_state_dict(c["js"], j_grads), **TOL)

    if impl == "pallas_interpret":
        # the Pallas kernels (forward and backward) ran above; the update
        # after them is the same XLA code on both paths
        assert seen == {"_fwd_impl", "_bwd_impl", "attention_block_fused", "ffn_ln_block"}
        return
    j_params, _, j_loss2 = jt.train_step(jt.params, jt.opt_state, jm, j_in, j_lab,
                                         j_val, jax.random.PRNGKey(1))
    t_params, _, t_loss2 = tt.train_step(tt.params, tt.opt_state, tm, t_in, t_lab, t_val,
                                         tt.generator)
    np.testing.assert_allclose(float(t_loss2), float(j_loss2), **LOSS_TOL)
    _close_named(export_reference_state_dict(c["ts"], t_params),
                 export_torch_state_dict(c["js"], j_params), **TOL)


def test_train_epoch_matches(case):
    """Three ``train_epoch`` steps (SGD, the same ``hp.seed``): the lag-one
    configuration quirk, the per-step sampling and the ``valid``-weighted
    epoch loss."""
    c = case
    jt, tt = _trainers(c, experiment_type="random_sample",
                       modality_pool=[[0], [1, 2], [0, 1, 2]])
    jm, tm = _masks(c)
    j_loss, j_next = jt.train_epoch(
        [JBatch(inputs=list(b[0]), labels=b[1], valid=b[2]) for b in c["batches"]], jm)
    t_loss, t_next = tt.train_epoch(
        [TBatch(inputs=list(b[0]), labels=b[1], valid=b[2]) for b in c["batches"]], tm)
    np.testing.assert_allclose(t_loss, j_loss, **LOSS_TOL)
    _close_named(export_reference_state_dict(c["ts"], tt.params),
                 export_torch_state_dict(c["js"], jt.params), **TOL)
    for f in dataclasses.fields(t_next):
        np.testing.assert_array_equal(getattr(t_next, f.name).numpy(),
                                      np.asarray(getattr(j_next, f.name)))


def test_adam_step_matches(case):
    """One Adam step.  Adam's first update is lr * g / (|g| + eps) with eps
    1e-8: where |g| is below ~1e-6 the two packages' gradients (equal to
    1e-4) can differ in sign or in size against eps, so such an element may
    move by up to lr either way; every other element agrees to 1e-6."""
    c = case
    lr = 1e-3
    jt, tt = _trainers(c, optim="Adam", lr=lr)
    jm, tm = _masks(c)
    j_in, j_lab, j_val = _j_batch(c["batches"][1])
    t_in, t_lab, t_val = _t_batch(c["batches"][1])
    j_params, _, _ = jt.train_step(jt.params, jt.opt_state, jm, j_in, j_lab, j_val,
                                   jax.random.PRNGKey(1))
    _, t_grads = tt.loss_and_grads(tt.params, tm, t_in, t_lab, t_val, tt.generator)
    small = {k: np.abs(v) < 1e-6
             for k, v in export_reference_state_dict(c["ts"], t_grads).items()}
    tt.train_step(tt.params, tt.opt_state, tm, t_in, t_lab, t_val, tt.generator)
    ours = export_reference_state_dict(c["ts"], tt.params)
    theirs = export_torch_state_dict(c["js"], j_params)
    for name, a in ours.items():
        ref = np.asarray(theirs[name])
        tol = np.where(small[name], 2 * lr, 1e-6)
        assert (np.abs(a - ref) <= tol).all(), name


def test_batch_chunk_matches_unchunked(case):
    """``batch_chunk=2`` gives the gradients and loss of one chunk."""
    c = case
    jm, tm = _masks(c)
    t_in, t_lab, t_val = _t_batch(c["batches"][2])
    out = []
    for chunk in (1, 2):
        _, tt = _trainers(c, batch_chunk=chunk)
        loss, grads = tt.loss_and_grads(tt.params, tm, t_in, t_lab, t_val, tt.generator)
        out.append((float(loss), export_reference_state_dict(c["ts"], grads)))
    np.testing.assert_allclose(out[1][0], out[0][0], **LOSS_TOL)
    for name in out[0][1]:
        np.testing.assert_allclose(out[1][1][name], out[0][1][name], atol=1e-6,
                                   rtol=1e-5, err_msg=name)
