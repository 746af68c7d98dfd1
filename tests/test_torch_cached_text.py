"""The port's cached-text pipeline (``train/features.py``) against the JAX
package's, and against its own online pipeline, on the CPU.

The frozen BERT is deterministic, so features computed once per dataset
give the same training step as tokens run through the BERT in every step.
Tolerances: features and the zero row at atol = rtol = 1e-5 against JAX
(float32, two tiny BERT layers summed in other orders); within the port, the
cached step and the online step run the same plain BERT on the same rows,
so their loss and updated parameters agree to 1e-6 (the BERT's matmuls see
other batch sizes); the cached loss matches the JAX cached step to 1e-5.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_robustness_tpu import build_masks as j_build_masks
from multimodal_transformer_robustness_tpu import config as jcfg
from multimodal_transformer_robustness_tpu.checkpoint import export_torch_state_dict
from multimodal_transformer_robustness_tpu.data.loaders import ArrayDataset as JArrayDataset
from multimodal_transformer_robustness_tpu.models import init_supernet as j_init
from multimodal_transformer_robustness_tpu.models.bert import tiny_bert_config as j_tiny
from multimodal_transformer_robustness_tpu.train import features as jfeat
from multimodal_transformer_robustness_tpu.train import loop as jloop
from multimodal_transformer_robustness_tpu_torch import config as tcfg
from multimodal_transformer_robustness_tpu_torch.data.loaders import ArrayDataset
from multimodal_transformer_robustness_tpu_torch.masks import build_masks as t_build_masks
from multimodal_transformer_robustness_tpu_torch.models.bert import tiny_bert_config as t_tiny
from multimodal_transformer_robustness_tpu_torch.train import features as tfeat
from multimodal_transformer_robustness_tpu_torch.train import loop as tloop
from multimodal_transformer_robustness_tpu_torch.weights import (
    export_reference_state_dict, load_reference_state_dict)

TOL = dict(atol=1e-5, rtol=1e-5)
_SPEC = dict(modality_set=("t", "a"), orig_dimensions=(6, 4), dimension=8,
             num_heads=2, head_dim=4, layers_single_attn=1, layers_cross_attn=1,
             layers_self_attn=1, attn_dropout=(0.0, 0.0, 0.0), relu_dropout=0.0,
             res_dropout=0.0, out_dropout=0.0, embed_dropout=0.0, attn_mask=True,
             output_dim=1)


class _TextDataset:
    """gather-style dataset with a [3, N, L] token stack (the MOSEI layout)."""

    def __init__(self, n=12, L=7, T=5, vocab=64, seed=0):
        rng = np.random.default_rng(seed)
        self.text = np.stack([rng.integers(1, vocab, (n, L)), np.zeros((n, L), np.int64),
                              np.ones((n, L), np.int64)])
        self.text[2, 3, 4:] = 0                      # a ragged mask row
        self.audio = rng.standard_normal((n, T, 4)).astype(np.float32)
        self.labels = rng.standard_normal((n, 1)).astype(np.float32)

    def __len__(self):
        return self.text.shape[1]

    def gather(self, idx):
        return [self.text[:, idx], self.audio[idx]], self.labels[idx]


@pytest.fixture(autouse=True)
def _no_cross_quirk():
    zero = lambda self, idx: 0.0  # noqa: E731
    with mock.patch.object(jcfg.ModelSpec, "attn_dropout_for_cross", zero), \
            mock.patch.object(tcfg.ModelSpec, "attn_dropout_for_cross", zero):
        yield


@pytest.fixture(scope="module")
def case():
    js, ts = jcfg.ModelSpec(**_SPEC), tcfg.ModelSpec(**_SPEC)
    params, frozen = j_init(jax.random.PRNGKey(0), js, bert_cfg=j_tiny(), use_jit=False)
    bert_np = jax.tree.map(np.asarray, frozen["bert"])
    t_params, t_frozen = load_reference_state_dict(ts, export_torch_state_dict(js, params),
                                                   bert_np)
    return dict(js=js, ts=ts, params_np=jax.tree.map(np.asarray, params), frozen=frozen,
                bert_np=bert_np, t_params=t_params, t_frozen=t_frozen, ds=_TextDataset())


def test_find_text_slot(case):
    inputs, _ = case["ds"].gather(np.arange(3))
    assert tfeat.find_text_slot(inputs) == jfeat.find_text_slot(inputs) == 0
    assert tfeat.find_text_slot([inputs[1]]) is None
    assert tfeat.find_text_slot([inputs[0].astype(np.float32)]) is None


@pytest.mark.parametrize("batch_size", [5, 12, 16])
def test_precompute_matches_jax(case, batch_size):
    """Chunks of 5 over 12 rows pad the tail chunk (two rows); 12 and 16 run
    one chunk, padded to nothing."""
    text = case["ds"].text
    ref = jfeat.precompute_text_features(case["frozen"], j_tiny(), text, batch_size=batch_size)
    out = tfeat.precompute_text_features(case["t_frozen"], t_tiny(), text,
                                         batch_size=batch_size, device="cpu")
    assert out.shape == ref.shape == (12, 7, 16) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, **TOL)


def test_zero_token_features_match_jax(case):
    ref = jfeat.zero_token_features(case["frozen"], j_tiny(), 7)
    out = tfeat.zero_token_features(case["t_frozen"], t_tiny(), 7, device="cpu")
    assert out.shape == (7, 16) and np.abs(out).max() > 1e-3
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("kind", ["gather", "array"])
def test_cached_dataset_matches_jax(case, kind):
    """Features, the zero row and ``gather``, for a ``gather``-style dataset
    (chunks of 5 over 12 rows, the tail padded) and for an ``ArrayDataset``,
    whose rows ``gather`` indexes itself.  An ``ArrayDataset`` indexes every
    input on its first axis, so it holds a [3, N, L] token stack only when
    N == 3: three items, one batch of three."""
    ds = case["ds"]
    if kind == "gather":
        base_t = base_j = ds
        n, batch_size = 12, 5
    else:
        n, batch_size = 3, 3
        arrays = ([ds.text[:, :n], ds.audio[:n]], ds.labels[:n], [6, 4], 5)
        base_t, base_j = ArrayDataset(*arrays), JArrayDataset(*arrays)
    ref = jfeat.CachedTextDataset(base_j, case["frozen"], j_tiny(), batch_size=batch_size)
    ours = tfeat.CachedTextDataset(base_t, case["t_frozen"], t_tiny(),
                                   batch_size=batch_size, device="cpu")
    assert ours.text_slot == ref.text_slot == 0 and len(ours) == n
    assert ours.features.shape == (n, 7, 16)
    np.testing.assert_allclose(ours.features, ref.features, **TOL)
    np.testing.assert_allclose(ours.zero_row, ref.zero_row, **TOL)
    assert set(ours.zero_fill_rows()) == {0}
    idx = np.asarray([2, 1, 2])
    (feats, audio), labels = ours.gather(idx)
    (j_feats, j_audio), j_labels = ref.gather(idx)
    np.testing.assert_array_equal(feats, ours.features[idx])
    np.testing.assert_allclose(feats, j_feats, **TOL)
    np.testing.assert_array_equal(audio, ds.audio[idx])
    np.testing.assert_array_equal(audio, j_audio)
    np.testing.assert_array_equal(labels, ds.labels[idx])
    np.testing.assert_array_equal(labels, j_labels)


def test_cached_dataset_delegates_and_rejects_textless(case):
    ds = case["ds"]
    ours = tfeat.CachedTextDataset(ds, case["t_frozen"], t_tiny(), batch_size=8,
                                   device="cpu")
    assert ours.audio is ds.audio                       # __getattr__ delegation
    textless = ArrayDataset([ds.audio], ds.labels, [4], 5)
    with pytest.raises(ValueError, match="no \\[3, B, L\\] integer text"):
        tfeat.CachedTextDataset(textless, case["t_frozen"], t_tiny(), device="cpu")


def test_unported_dtype_and_missing_card_raise(case):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfeat.precompute_text_features(case["t_frozen"], t_tiny(), case["ds"].text,
                                       compute_dtype="float16", device="cpu")
    if not torch.cuda.is_available():
        # the default device is the card; without one nothing falls back
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfeat.precompute_text_features(case["t_frozen"], t_tiny(), case["ds"].text)


def test_cached_train_step_matches_online_and_jax(case):
    """One SGD ``train_step`` on features equals the step on tokens in the
    port; the cached loss matches the JAX cached step."""
    c, idx = case, np.arange(4)
    cached = tfeat.CachedTextDataset(c["ds"], c["t_frozen"], t_tiny(), batch_size=5,
                                     device="cpu")
    hp = dict(batch_size=4, lr=1e-2, optim="SGD", criterion="L1Loss", seed=0)
    masks_t = t_build_masks(c["ts"], tcfg.full_active_config(c["ts"]))
    labels = torch.from_numpy(c["ds"].labels[idx])
    valid = torch.ones(4)
    results = []
    for inputs in (c["ds"].gather(idx)[0], cached.gather(idx)[0]):
        tp, tf = load_reference_state_dict(c["ts"], export_reference_state_dict(
            c["ts"], c["t_params"]), c["bert_np"])
        tr = tloop.Trainer(c["ts"], tp, tf, tloop.TrainHParams(**hp), bert_cfg=t_tiny(),
                           device="cpu")
        params, _, loss = tr.train_step(tr.params, tr.opt_state, masks_t,
                                        [torch.from_numpy(np.asarray(x)) for x in inputs],
                                        labels, valid, tr.generator)
        results.append((float(loss), export_reference_state_dict(c["ts"], params)))
    (l_on, p_on), (l_off, p_off) = results
    np.testing.assert_allclose(l_off, l_on, atol=1e-6, rtol=1e-6)
    for name in p_on:
        np.testing.assert_allclose(p_off[name], p_on[name], atol=1e-6, rtol=1e-6,
                                   err_msg=name)

    jcached = jfeat.CachedTextDataset(c["ds"], c["frozen"], j_tiny(), batch_size=5)
    jt = jloop.Trainer(c["js"], jax.tree.map(jnp.asarray, c["params_np"]), c["frozen"],
                       jloop.TrainHParams(**hp, dataset="mosei_senti"), bert_cfg=j_tiny())
    masks_j = jax.tree.map(jnp.asarray, j_build_masks(c["js"], jcfg.full_active_config(c["js"])))
    j_in = [jnp.asarray(x) for x in jcached.gather(idx)[0]]
    _, _, j_loss = jt.train_step(jt.params, jt.opt_state, masks_j, j_in, jnp.asarray(
        c["ds"].labels[idx]), jnp.ones((4,), jnp.float32), jax.random.PRNGKey(7))
    np.testing.assert_allclose(l_off, float(j_loss), **TOL)
