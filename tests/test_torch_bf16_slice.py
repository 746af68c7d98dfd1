"""The bf16 compute policy's slice against the JAX package's, on the CPU:
``supernet_apply`` in eval mode, ``Trainer.evaluate`` and
``precompute_text_features`` under ``ModelSpec(compute_dtype="bfloat16")``
(one training step: ``tests/test_torch_bf16_train.py``, on this file's
model).

The port draws the weights (``init_supernet``) and they cross into the JAX
package under the reference's names, the dead ``translation`` linears as
zeros; the frozen BERT is the JAX package's ``init_bert`` at
``tiny_bert_config(hidden=128, heads=2, layers=1)``, so the JAX shape
gates of both BERT kernels fire.  The JAX side runs its Pallas kernels in
interpret mode (``RECURRENCE_IMPL="pallas_interpret"``,
``FFN_INTERPRET=True``), the port its bf16 plain versions.  Dropout is
off, and both packages' ``attn_dropout_for_cross`` are patched to 0.

The JAX side is compiled with XLA's excess precision off
(``_torch_pair.exact_jit``): by default XLA keeps some fused bf16
intermediates in float32 (the BERT embedding's sum, the BERT kernels'
residual sums, the trunk's elementwise chains), which moves the
predictions by a bf16 step of the hidden activations, while the port, as
the JAX program is written, rounds every bf16 result.  Tolerances (the JAX policy's own bounds against float32 are 5%):
predictions within 2e-2 of max(|ref|, 1e-2) elementwise; features within
2e-2 of max |ref|; the evaluate metric equal.  The spec has two
modalities (text and audio), one layer a stack and short sequences, so
that the JAX Pallas kernels (interpret mode) compile quickly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_robustness_tpu import config as jcfg
from multimodal_transformer_robustness_tpu.data.loaders import BatchIterator as JIter
from multimodal_transformer_robustness_tpu.models import supernet_apply as j_apply
from multimodal_transformer_robustness_tpu.train import features as jfeat
from multimodal_transformer_robustness_tpu.train import loop as jloop
from multimodal_transformer_robustness_tpu_torch.data.loaders import BatchIterator as TIter
from multimodal_transformer_robustness_tpu_torch.models import supernet_apply as t_apply
from multimodal_transformer_robustness_tpu_torch.train import features as tfeat
from multimodal_transformer_robustness_tpu_torch.train import loop as tloop

from _torch_pair import (BF16_B, bf16_batch, bf16_build, bf16_masks, bf16_port, exact_jit,
                         no_cross_quirk, use_pallas_interpret)

PRED_TOL = 2e-2
B = BF16_B


@pytest.fixture(autouse=True)
def _kernels_and_no_quirk(monkeypatch):
    use_pallas_interpret(monkeypatch)
    with no_cross_quirk():
        yield


@pytest.fixture(scope="module")
def case():
    return bf16_build()


def _close(ours, theirs, what):
    ours, theirs = np.asarray(ours, np.float64), np.asarray(theirs, np.float64)
    assert ours.shape == theirs.shape, what
    rel = np.abs(ours - theirs) / np.maximum(np.abs(theirs), 1e-2)
    print(f"{what}: max rel {rel.max():.3e}, {np.mean(ours != theirs):.2%} differ")
    assert rel.max() <= PRED_TOL, what


def _j_apply(c, jm, inputs):
    with exact_jit():
        run = jax.jit(lambda p, m, x: j_apply(c["js"], p, m, x, frozen=c["frozen"],
                                              bert_cfg=c["jb"]))
    return run(jax.tree.map(jnp.asarray, c["params_np"]), jm,
               [jnp.asarray(inputs[0], jnp.int32)] + [jnp.asarray(x) for x in inputs[1:]])


def test_supernet_apply_bf16_matches_jax(case):
    """A sampled elastic configuration (the full one: the evaluate test)."""
    c = case
    jm, tm = bf16_masks(c, c["cfg"])
    inputs, _, _ = bf16_batch(c)
    ref = _j_apply(c, jm, inputs)
    tp, tf = bf16_port(c)
    with torch.no_grad():
        out = t_apply(c["ts"], tp, tm, [torch.from_numpy(x) for x in inputs], frozen=tf,
                      bert_cfg=c["tb"])
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    _close(out.numpy(), ref, "supernet_apply")


def test_evaluate_bf16_matches_jax(case):
    """``Trainer.evaluate`` on two batches with a padded tail, text dropped
    (its tokens zero-filled): predictions and the MOSEI metric."""
    c = case
    kw = dict(batch_size=B, dataset="mosei_senti", log_interval=1000)
    with exact_jit():
        jt = jloop.Trainer(c["js"], jax.tree.map(jnp.asarray, c["params_np"]), c["frozen"],
                           jloop.TrainHParams(**kw), bert_cfg=c["jb"])
    tp, tf = bf16_port(c)
    tt = tloop.Trainer(c["ts"], tp, tf, tloop.TrainHParams(**kw), bert_cfg=c["tb"],
                       device="cpu")
    jm, tm = bf16_masks(c, jcfg.full_active_config(c["js"]))
    j_metric, j_preds, truths = jt.evaluate(JIter(c["data"], B), jm, [1])
    t_metric, t_preds, t_truths = tt.evaluate(TIter(c["data"], B), tm, [1])
    np.testing.assert_array_equal(t_truths, truths)
    _close(t_preds, np.asarray(j_preds), "evaluate")
    print(f"metric {t_metric} vs {j_metric}")
    assert t_metric == j_metric


def test_precompute_text_features_bf16_matches_jax(case):
    """Features computed by the bf16 BERT, stored as float32 (lossless)."""
    c = case
    text = c["data"].text[:, :6]
    with exact_jit():
        ref = jfeat.precompute_text_features(c["frozen"], c["jb"], text, batch_size=4,
                                             compute_dtype="bfloat16")
    _, tf = bf16_port(c)
    ours = tfeat.precompute_text_features(tf, c["tb"], text, batch_size=4,
                                          compute_dtype="bfloat16", device="cpu")
    assert ours.dtype == np.float32
    assert np.array_equal(ours, ours.astype(jnp.bfloat16).astype(np.float32))
    scale = float(np.abs(np.asarray(ref)).max())
    err = float(np.abs(ours - np.asarray(ref)).max())
    print(f"features: max |d| {err:.3e} of max |ref| {scale:.3e}, "
          f"{np.mean(ours != np.asarray(ref)):.2%} differ")
    assert err <= PRED_TOL * scale
