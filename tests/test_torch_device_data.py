"""The port's device-resident batches (``data/device.py``) on the CPU:
``DeviceBatchIterator`` gives ``BatchIterator``'s batches bit for bit
(shuffled, over two epochs, with a padded tail, with a [3, N, L] text
stack, after ``set_epoch``, with ``drop_tail``), ``materialize`` gives the
JAX package's arrays, and the Trainer takes its batches unchanged."""

import numpy as np
import pytest
import torch

from multimodal_transformer_robustness_tpu.data.device import materialize as j_materialize
from multimodal_transformer_robustness_tpu_torch import build_masks, full_active_config
from multimodal_transformer_robustness_tpu_torch import config as tcfg
from multimodal_transformer_robustness_tpu_torch.data import (
    ArrayDataset, BatchIterator, DeviceBatchIterator, materialize)
from multimodal_transformer_robustness_tpu_torch.models import init_supernet
from multimodal_transformer_robustness_tpu_torch.models.bert import tiny_bert_config
from multimodal_transformer_robustness_tpu_torch.train import TrainHParams, Trainer

from _torch_pair import SPEC, MoseiLike


def _array_ds(n=13, seed=1):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((n, 4, d)).astype(np.float32) for d in (6, 3)]
    return ArrayDataset(xs, rng.standard_normal((n, 1)).astype(np.float32), dims=[6, 3],
                        seq_len=4)


def _same_batches(host, dev, epochs=2):
    for _ in range(epochs):
        hb, db = list(host), list(dev)
        assert len(hb) == len(db) == len(host) == len(dev)
        for b_h, b_d in zip(hb, db):
            for x_h, x_d in zip(b_h.inputs, b_d.inputs):
                assert isinstance(x_d, torch.Tensor)
                np.testing.assert_array_equal(x_d.numpy(), np.asarray(x_h))
                assert x_d.dtype == torch.as_tensor(np.asarray(x_h)).dtype
            np.testing.assert_array_equal(b_d.labels.numpy(), np.asarray(b_h.labels))
            assert isinstance(b_d.valid, np.ndarray)
            np.testing.assert_array_equal(b_d.valid, b_h.valid)


@pytest.mark.parametrize("kind", ["array", "text"])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("bs,drop_tail", [(4, False), (4, True), (5, False)])
def test_matches_host_iterator(kind, shuffle, bs, drop_tail):
    ds = _array_ds() if kind == "array" else MoseiLike(11, seed=2)
    kw = dict(shuffle=shuffle, seed=3, drop_tail=drop_tail)
    _same_batches(BatchIterator(ds, bs, **kw), DeviceBatchIterator(ds, bs, device="cpu", **kw))


def test_set_epoch_continues_the_order():
    ds = MoseiLike(11, seed=2)
    host = BatchIterator(ds, 4, shuffle=True, seed=5)
    list(host), list(host)
    dev = DeviceBatchIterator(ds, 4, shuffle=True, seed=5, device="cpu")
    dev.set_epoch(2)
    _same_batches(host, dev, epochs=1)


def test_materialize_matches_jax():
    for ds in (_array_ds(), MoseiLike(11, seed=2)):
        ours, theirs = materialize(ds, chunk=4), j_materialize(ds, chunk=4)
        for a, b in zip(ours[0] + [ours[1]], theirs[0] + [theirs[1]]):
            np.testing.assert_array_equal(a, b)


def test_refuses_what_is_not_ported_and_a_missing_card(monkeypatch):
    with pytest.raises(NotImplementedError, match="bf16"):
        DeviceBatchIterator(_array_ds(), 4, store_dtype="float16", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceBatchIterator(_array_ds(), 4)


def test_trainer_takes_device_batches():
    """``train_epoch`` and ``evaluate`` on device batches equal the same on
    host batches (bit for bit: the same tensors reach the same code)."""
    spec = tcfg.ModelSpec(**SPEC)
    ds = MoseiLike(10, seed=4)
    out = []
    for it in (BatchIterator, DeviceBatchIterator):
        kw = {} if it is BatchIterator else dict(device="cpu")
        params, frozen = init_supernet(torch.Generator().manual_seed(0), spec,
                                       tiny_bert_config())
        tr = Trainer(spec, params, frozen, TrainHParams(batch_size=4, optim="SGD",
                                                        experiment_type="random_sample"),
                     bert_cfg=tiny_bert_config(), device="cpu")
        masks = build_masks(spec, full_active_config(spec))
        loss, _ = tr.train_epoch(it(ds, 4, shuffle=True, seed=1, **kw), masks)
        metric, preds, truths = tr.evaluate(it(ds, 4, **kw), masks, [0, 2])
        out.append((loss, metric, preds, truths))
    assert out[0][0] == out[1][0] and out[0][1] == out[1][1]
    np.testing.assert_array_equal(out[0][2], out[1][2])
    np.testing.assert_array_equal(out[0][3], out[1][3])
