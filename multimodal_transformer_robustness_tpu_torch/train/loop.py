"""Training engine: the train step and the training epoch.

Counterpart of ``multimodal_transformer_robustness_tpu/train/loop.py``:

  * one ``train_step`` (train-mode forward, valid-weighted loss, backward,
    global-norm clip, torch optimizer step) serves every elastic
    configuration: the per-batch sampled configuration enters as mask
    tensors, never as new Python structure;
  * the reference's off-by-one quirk is replicated: the configuration
    sampled at batch i is applied at batch i+1;
  * ``train_epoch`` reads the losses back once, at the epoch's end.

Not here yet: ``evaluate``, ``fit``, the missing-modality sweep and the
evolutionary search (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ..config import ModelSpec
from ..masks import SupernetMasks, build_masks
from ..models.bert import BertConfig
from ..models.mult import supernet_apply, to_device
from .optim import clip_by_global_norm_, make_optimizer
from .sampling import sample_train_config


@dataclasses.dataclass
class TrainHParams:
    """The reference's hyperparameters that the training step and epoch
    read (``fit``'s epochs and plateau patience come with ``fit``)."""

    batch_size: int = 16
    lr: float = 1e-3
    optim: str = "Adam"
    clip: float = 1.0
    experiment_type: str = "random_sample"
    modality_pool: Optional[Sequence[Sequence[int]]] = None
    all_module: bool = False
    specific: Optional[list] = None
    criterion: str = "L1Loss"
    log_interval: int = 360
    seed: int = 1111
    # gradient accumulation: each batch in this many chunks, one backward
    # per chunk, one optimizer step on the valid-weighted summed gradients
    batch_chunk: int = 1


def make_criterion(name: str) -> Callable:
    """Valid-row-weighted batch loss: padded tail rows weigh 0, so the loss
    is the reference's plain mean over the real rows."""
    def weighted(per, valid):
        return torch.sum(per * valid) / torch.clamp(torch.sum(valid), min=1.0)

    if name == "L1Loss":
        return lambda preds, labels, valid: weighted(
            (preds - labels).abs().flatten(1).mean(dim=1), valid)
    if name == "MSELoss":
        return lambda preds, labels, valid: weighted(
            (preds - labels).square().flatten(1).mean(dim=1), valid)
    if name == "CrossEntropyLoss":
        return lambda preds, labels, valid: weighted(
            F.cross_entropy(preds, labels.long(), reduction="none"), valid)
    raise NotImplementedError(name)


class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau(mode='min',
    patience=when, factor=0.1) with torch defaults (threshold 1e-4 rel)."""

    def __init__(self, lr: float, patience: int, factor: float = 0.1,
                 threshold: float = 1e-4):
        self.lr = lr
        self.patience = patience
        self.factor = factor
        self.threshold = threshold
        self.best = float("inf")
        self.num_bad = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr *= self.factor
                self.num_bad = 0
        return self.lr


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict / list tree, in a fixed order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _chunk(x: torch.Tensor, n: int) -> List[torch.Tensor]:
    # a text token stack [3, B, L] splits on its batch axis 1
    if x.ndim >= 2 and x.shape[0] == 3 and not torch.is_floating_point(x):
        return list(x.chunk(n, dim=1))
    return list(x.chunk(n, dim=0))


class Trainer:
    """Owns the parameters, the optimizer and the random streams on one
    device.  ``device`` defaults to the card; asking for ``cuda`` without
    one raises (nothing falls back to the CPU)."""

    def __init__(self, spec: ModelSpec, params: dict, frozen: dict,
                 hp: TrainHParams, bert_cfg: Optional[BertConfig] = None,
                 device="cuda"):
        self.device = _build.resolve_device(device)
        # the port computes float32: no TF32 in cuDNN's conv (cnn_rnn) or
        # in matmuls
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.spec = spec
        self.hp = hp
        self.bert_cfg = bert_cfg
        self.params = to_device(params, self.device)
        for p in tree_leaves(self.params):
            p.requires_grad_(True)
        self.frozen = to_device(frozen, self.device)
        self.criterion = make_criterion(hp.criterion)
        self.opt_state = make_optimizer(hp.optim, tree_leaves(self.params), hp.lr)
        self.rng = np.random.default_rng(hp.seed)
        self.generator = torch.Generator(device=self.device).manual_seed(hp.seed)
        # the per-step losses of the last train_epoch, from its one readback
        self.last_epoch_losses = np.zeros(0)

    def _backward(self, params, masks, inputs, labels, valid, generator) -> torch.Tensor:
        """Train-mode forward and backward into each leaf's ``.grad``;
        returns the batch loss (no readback)."""
        leaves = tree_leaves(params)
        for p in leaves:
            p.grad = None

        def loss_of(inp, lab, val):
            preds = supernet_apply(self.spec, params, masks, inp, frozen=self.frozen,
                                   bert_cfg=self.bert_cfg, train=True,
                                   generator=generator)
            return self.criterion(preds, lab, val)

        nchunk = max(1, self.hp.batch_chunk)
        if nchunk == 1:
            loss = loss_of(inputs, labels, valid)
            loss.backward()
            return loss.detach()
        # per-chunk summed losses accumulate, then divide by the total valid
        # count: the same weighted mean as one chunk
        l_sum = torch.zeros((), device=valid.device)
        chunks = zip(zip(*[_chunk(x, nchunk) for x in inputs]), _chunk(labels, nchunk),
                     _chunk(valid, nchunk))
        for inp, lab, val in chunks:
            loss_c = loss_of(list(inp), lab, val) * torch.sum(val)
            loss_c.backward()
            l_sum = l_sum + loss_c.detach()
        tot = torch.clamp(torch.sum(valid), min=1.0)
        for p in leaves:
            if p.grad is not None:
                p.grad.div_(tot)
        return l_sum / tot

    def loss_and_grads(self, params, masks, inputs, labels, valid, generator):
        """(loss, gradients as a tree shaped like ``params``), unclipped."""
        loss = self._backward(params, masks, inputs, labels, valid, generator)
        return loss, tree_map(lambda p: p.grad, params)

    def train_step(self, params, opt_state, masks: SupernetMasks, inputs, labels,
                   valid, generator):
        """Forward in train mode, loss, backward, optax's global-norm clip
        (:func:`~.optim.clip_by_global_norm_`, as the JAX package chains
        ``optax.clip_by_global_norm``) and one optimizer step, in place on
        ``params`` and ``opt_state``.  Returns ``(params, opt_state, loss)``,
        the loss still on the device."""
        loss = self._backward(params, masks, inputs, labels, valid, generator)
        clip_by_global_norm_([p.grad for p in tree_leaves(params) if p.grad is not None],
                             self.hp.clip)
        opt_state.step()
        return params, opt_state, loss

    def train_epoch(self, train_iter, current_masks: SupernetMasks,
                    epoch: int = 0) -> tuple:
        """One epoch; returns ``(epoch_loss, masks_left_active)``.

        Replicates the sample-lags-one-batch quirk: each step runs with the
        masks sampled during the previous batch.  ``batch.valid`` is a host
        array; the losses stay on the device until one readback at the end
        (and at each log line)."""
        hp, spec, dev = self.hp, self.spec, self.device
        losses: List[torch.Tensor] = []
        sizes: List[int] = []
        proc_from = 0
        start = time.time()
        for i_batch, batch in enumerate(train_iter):
            inputs = [torch.as_tensor(x, device=dev) for x in batch.inputs]
            labels = torch.as_tensor(batch.labels, device=dev)
            valid = torch.as_tensor(batch.valid, dtype=torch.float32, device=dev)
            self.params, self.opt_state, loss = self.train_step(
                self.params, self.opt_state, current_masks, inputs, labels, valid,
                self.generator)
            # sample the NEXT batch's configuration
            cfg = sample_train_config(spec, hp.experiment_type, hp.modality_pool,
                                      self.rng, all_module=hp.all_module,
                                      specific=hp.specific)
            current_masks = build_masks(spec, cfg, device=dev)
            losses.append(loss)
            sizes.append(int(np.sum(batch.valid)))
            if (i_batch + 1) % hp.log_interval == 0:
                chunk = torch.stack(losses[proc_from:]).double().cpu().numpy()
                w = np.asarray(sizes[proc_from:], np.float64)
                elapsed = time.time() - start
                print("Epoch {:2d} | Batch {:3d} | Time/Batch(ms) {:5.2f} | "
                      "Train Loss {:5.4f}".format(
                          epoch, i_batch + 1, elapsed * 1000 / hp.log_interval,
                          float(chunk @ w) / max(w.sum(), 1.0)))
                proc_from = len(losses)
                start = time.time()
        if not losses:
            return 0.0, current_masks
        loss_vec = torch.stack(losses).double().cpu().numpy()   # one readback
        self.last_epoch_losses = loss_vec
        w = np.asarray(sizes, np.float64)
        return float(loss_vec @ w) / max(float(w.sum()), 1.0), current_masks
