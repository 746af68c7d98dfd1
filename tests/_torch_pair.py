"""One tiny supernet in both packages, for the CPU parity tests of the
port's experiment loop (evaluate, fit, the sweep).

The parameters are drawn by the port's ``init_supernet`` (quick: the JAX
package's eager init takes ~20 s of first dispatches) and cross into the
JAX package under the reference's names (``weights.export_reference_state_dict``
into ``checkpoint.import_torch_state_dict``, the dead ``translation``
linears as zeros); the frozen BERT is the JAX package's ``init_bert``, in
the port through ``weights.load_reference_state_dict``.
Every dropout rate is 0, and :func:`no_cross_quirk` patches both packages'
``attn_dropout_for_cross`` to 0 (the reference's 0.1 for the later cross
stacks would draw, and ``jax.random`` and ``torch.Generator`` draw
different streams).  The data are a gather-style dataset in the MOSEI
layout: a ``[3, N, L]`` token stack (with padded tokens), audio and vision
sequences and real-valued labels, made from a seed with numpy.
"""

import functools
from contextlib import contextmanager
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np

from multimodal_transformer_robustness_tpu import build_masks as j_build_masks
from multimodal_transformer_robustness_tpu import config as jcfg
import torch

from multimodal_transformer_robustness_tpu.checkpoint import import_torch_state_dict
from multimodal_transformer_robustness_tpu.models import bert as jbert
from multimodal_transformer_robustness_tpu.ops import gru as jgru
from multimodal_transformer_robustness_tpu.train import loop as jloop
from multimodal_transformer_robustness_tpu.train.sampling import sample_train_config
from multimodal_transformer_robustness_tpu_torch import config as tcfg
from multimodal_transformer_robustness_tpu_torch.masks import build_masks as t_build_masks
from multimodal_transformer_robustness_tpu_torch.models import bert as tbert
from multimodal_transformer_robustness_tpu_torch.models import init_supernet as t_init
from multimodal_transformer_robustness_tpu_torch.train import loop as tloop
from multimodal_transformer_robustness_tpu_torch.weights import (
    export_reference_state_dict, load_reference_state_dict)

SPEC = dict(modality_set=("t", "a", "v"), orig_dimensions=(16, 6, 5), dimension=8,
            num_heads=2, head_dim=4, layers_single_attn=1, layers_cross_attn=1,
            layers_self_attn=1, attn_dropout=(0.0, 0.0, 0.0, 0.0), relu_dropout=0.0,
            res_dropout=0.0, out_dropout=0.0, embed_dropout=0.0, attn_mask=True,
            output_dim=1)
L, T = 6, 4


@contextmanager
def no_cross_quirk():
    zero = lambda self, idx: 0.0  # noqa: E731
    with mock.patch.object(jcfg.ModelSpec, "attn_dropout_for_cross", zero), \
            mock.patch.object(tcfg.ModelSpec, "attn_dropout_for_cross", zero):
        yield


class MoseiLike:
    """``gather``-style dataset: a [3, N, L] token stack (ids, zero type
    ids, attention mask), audio [N, T, 6], vision [N, T, 5], labels [N, 1]
    with a few exact zeros."""

    def __init__(self, n: int, seed: int, vocab: int = 64):
        rng = np.random.default_rng(seed)
        attn = (rng.random((n, L)) > 0.2).astype(np.int64)
        attn[:, 0] = 1
        self.text = np.stack([rng.integers(1, vocab, (n, L)) * attn,
                              np.zeros((n, L), np.int64), attn])
        self.audio = rng.standard_normal((n, T, 6)).astype(np.float32)
        self.vision = rng.standard_normal((n, T, 5)).astype(np.float32)
        self.labels = rng.standard_normal((n, 1)).astype(np.float32)
        self.labels[::7] = 0.0

    def __len__(self):
        return self.text.shape[1]

    def gather(self, idx):
        return [self.text[:, idx], self.audio[idx], self.vision[idx]], self.labels[idx]


def build(seed: int = 0, spec: dict = SPEC) -> dict:
    js, ts = jcfg.ModelSpec(**spec), tcfg.ModelSpec(**spec)
    jb, tb = jbert.tiny_bert_config(), tbert.tiny_bert_config()
    params, _ = t_init(torch.Generator().manual_seed(seed), ts, tb)
    sd = export_reference_state_dict(ts, params)
    d = ts.dimension
    for s in ts.cross_strings:
        sd[f"translation.translation{s}.weight"] = np.zeros((d, d), np.float32)
        sd[f"translation.translation{s}.bias"] = np.zeros((d,), np.float32)
    frozen = {"bert": jbert.init_bert(jax.random.PRNGKey(seed), jb)}
    return dict(js=js, ts=ts, jb=jb, tb=tb,
                params_np=jax.tree.map(np.asarray, import_torch_state_dict(js, sd)),
                frozen=frozen, bert_np=jax.tree.map(np.asarray, frozen["bert"]), sd=sd)


def trainers(c: dict, **hp_kw):
    """A JAX and a port Trainer (CPU) holding the same parameters."""
    kw = dict(batch_size=4, lr=1e-2, optim="SGD", criterion="L1Loss", seed=7,
              dataset="mosei_senti", log_interval=1000)
    kw.update(hp_kw)
    jt = jloop.Trainer(c["js"], jax.tree.map(jnp.asarray, c["params_np"]), c["frozen"],
                       jloop.TrainHParams(**kw), bert_cfg=c["jb"])
    tp, tf = load_reference_state_dict(c["ts"], c["sd"], c["bert_np"])
    tt = tloop.Trainer(c["ts"], tp, tf, tloop.TrainHParams(**kw), bert_cfg=c["tb"],
                       device="cpu")
    return jt, tt


# ------------------------------------------------------------------ bf16
# The bf16 policy's parity model (tests/test_torch_bf16_slice.py and
# test_torch_bf16_train.py): text and audio, one layer a stack, short
# sequences, and a tiny BERT at width 128, so that the JAX shape gates of
# both BERT kernels fire and the JAX Pallas kernels (interpret mode)
# compile quickly.
BF16_SPEC = dict(modality_set=("t", "a"), orig_dimensions=(128, 10), dimension=8,
                 num_heads=2, head_dim=4, layers_single_attn=1, layers_cross_attn=1,
                 layers_self_attn=1, attn_dropout=(0.0, 0.0, 0.0), relu_dropout=0.0,
                 res_dropout=0.0, out_dropout=0.0, embed_dropout=0.0, attn_mask=True,
                 output_dim=1, compute_dtype="bfloat16")
BF16_B, BF16_L, BF16_TA = 4, 4, 3


class TextAudio:
    """``gather``-style dataset: a [3, N, L] token stack (with padded
    tokens), audio [N, TA, 10] and real-valued labels."""

    def __init__(self, n: int, seed: int, vocab: int):
        rng = np.random.default_rng(seed)
        attn = (rng.random((n, BF16_L)) > 0.2).astype(np.int64)
        attn[:, 0] = 1
        self.text = np.stack([rng.integers(1, vocab, (n, BF16_L)) * attn,
                              np.zeros((n, BF16_L), np.int64), attn])
        self.audio = rng.standard_normal((n, BF16_TA, 10)).astype(np.float32)
        self.labels = rng.standard_normal((n, 1)).astype(np.float32)

    def __len__(self):
        return self.text.shape[1]

    def gather(self, idx):
        return [self.text[:, idx], self.audio[idx]], self.labels[idx]


def use_pallas_interpret(monkeypatch) -> None:
    """The JAX side through its Pallas kernels in interpret mode."""
    monkeypatch.setattr(jgru, "RECURRENCE_IMPL", "pallas_interpret")
    monkeypatch.setattr(jbert, "FFN_INTERPRET", True)


@contextmanager
def exact_jit():
    """``jax.jit`` with XLA's excess precision off, so a jitted bf16 program
    rounds every result where it is written to round, as eager JAX and the
    port do (by default XLA keeps fused bf16 intermediates in float32)."""
    jit = jax.jit
    with mock.patch.object(jax, "jit", functools.partial(
            jit, compiler_options={"xla_allow_excess_precision": False})):
        yield


def bf16_build(seed: int = 0, spec: dict = BF16_SPEC, bert_cfg: dict | None = None) -> dict:
    """The bf16 parity model: the port draws the weights, which cross into
    the JAX package (``translation`` linears as zeros); the JAX package's
    ``init_bert`` at ``tiny_bert_config(hidden=128, heads=2, layers=1)``
    (``bert_cfg``: a ``BertConfig``'s fields instead); 9 rows of data and a
    sampled configuration."""
    js, ts = jcfg.ModelSpec(**spec), tcfg.ModelSpec(**spec)
    if bert_cfg is None:
        jb = jbert.tiny_bert_config(hidden=128, heads=2, layers=1)
        tb = tbert.tiny_bert_config(hidden=128, heads=2, layers=1)
    else:
        jb, tb = jbert.BertConfig(**bert_cfg), tbert.BertConfig(**bert_cfg)
    params, _ = t_init(torch.Generator().manual_seed(seed), ts, tb)
    sd = export_reference_state_dict(ts, params)
    d = ts.dimension
    for s in ts.cross_strings:
        sd[f"translation.translation{s}.weight"] = np.zeros((d, d), np.float32)
        sd[f"translation.translation{s}.bias"] = np.zeros((d,), np.float32)
    frozen = {"bert": jbert.init_bert(jax.random.PRNGKey(seed), jb)}
    cfg = sample_train_config(js, "random_sample", None, np.random.default_rng(5))
    return dict(js=js, ts=ts, jb=jb, tb=tb, sd=sd, frozen=frozen, cfg=cfg,
                data=TextAudio(9, seed=1, vocab=jb.vocab_size),
                params_np=jax.tree.map(np.asarray, import_torch_state_dict(js, sd)),
                bert_np=jax.tree.map(np.asarray, frozen["bert"]))


def bf16_port(c: dict):
    """The port's (params, frozen) of :func:`bf16_build`'s model."""
    return load_reference_state_dict(c["ts"], c["sd"], c["bert_np"])


def bf16_batch(c: dict):
    """The first four rows, the last one padding: (inputs, labels, valid)."""
    inputs, labels = c["data"].gather(np.arange(BF16_B))
    return inputs, labels, np.array([1, 1, 1, 0], np.float32)


def bf16_frozen(c: dict, int8=None):
    """:func:`bf16_build`'s frozen BERT in both packages: (JAX, port),
    float32, or (``int8`` ``"ffn"`` / ``"all"``) quantized from the float32
    weights by each package's ``quantize_bert_params``; the boundary cast
    makes it bf16."""
    _, tf = bf16_port(c)
    if int8 is None:
        return c["frozen"], tf
    attn = int8 == "all"
    return ({"bert": jbert.quantize_bert_params(c["frozen"]["bert"], attn=attn)},
            dict(tf, bert=tbert.quantize_bert_params(tf["bert"], attn=attn)))


def bf16_masks(c: dict, cfg):
    """``cfg``'s masks in both packages: (JAX, port)."""
    return (jax.tree.map(jnp.asarray, j_build_masks(c["js"], cfg)),
            t_build_masks(c["ts"], tcfg.ActiveConfig(**cfg.__dict__)))


def bf16_train_step_pair(c: dict, j_frozen: dict, t_frozen: dict):
    """One training step of :func:`bf16_build`'s model in both packages
    (a sampled configuration, L1 with a padded row, the JAX side jitted with
    XLA's excess precision off, the port's Trainer on the CPU), the frozen
    BERT given per side: (port loss, JAX loss, port gradients, JAX
    gradients), the gradients under the reference's names, the dead
    ``translation`` linears dropped.  The port's parameters must stay
    float32 masters."""
    from multimodal_transformer_robustness_tpu.checkpoint import export_torch_state_dict
    from multimodal_transformer_robustness_tpu.models import supernet_apply as j_apply
    from multimodal_transformer_robustness_tpu_torch.weights import (
        export_reference_state_dict)

    jm, tm = bf16_masks(c, c["cfg"])
    inputs, labels, valid = bf16_batch(c)
    j_in = [jnp.asarray(inputs[0], jnp.int32)] + [jnp.asarray(x) for x in inputs[1:]]

    def loss_fn(p):
        preds = j_apply(c["js"], p, jm, j_in, frozen=j_frozen,
                        bert_cfg=c["jb"], train=True, rng=jax.random.PRNGKey(0))
        return jloop.make_criterion("L1Loss")(preds, jnp.asarray(labels), jnp.asarray(valid))

    with exact_jit():
        step = jax.jit(jax.value_and_grad(loss_fn))
    j_loss, j_grads = step(jax.tree.map(jnp.asarray, c["params_np"]))
    tp, _ = bf16_port(c)
    tt = tloop.Trainer(c["ts"], tp, t_frozen, tloop.TrainHParams(batch_size=BF16_B),
                       bert_cfg=c["tb"], device="cpu")
    t_loss, t_grads = tt.loss_and_grads(
        tt.params, tm, [torch.from_numpy(x) for x in inputs], torch.from_numpy(labels),
        torch.from_numpy(valid), tt.generator)
    assert all(p.dtype == torch.float32 for p in tloop.tree_leaves(tt.params))
    theirs = {k: np.asarray(v) for k, v in export_torch_state_dict(c["js"], j_grads).items()
              if not k.startswith("translation.")}
    return t_loss, j_loss, export_reference_state_dict(c["ts"], t_grads), theirs
