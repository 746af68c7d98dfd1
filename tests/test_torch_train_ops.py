"""Train-mode pieces of the PyTorch port against the JAX package, on the CPU.

* Configuration sampling: the port makes the JAX package's numpy
  ``Generator`` calls in its order, so the same seed gives the same
  configurations exactly (and leaves the generator in the same state).
* Dropout: ``jax.random`` and ``torch.Generator`` draw different streams,
  so the port's dropout is held to its distribution: the keep fraction
  within 5 binomial standard deviations, survivors scaled by 1 / (1 - p),
  the identity in eval mode and at rate 0.
* The train-mode encoder (and the attention inside it) at every dropout
  rate 0 against JAX ``encoder_forward(train=True)``: values and gradients
  at atol = rtol = 1e-5 (float32, JAX precision "highest").
* The cnn_rnn header: the conv weight's gradient is live and equals the JAX
  package's on its Pallas path (interpret mode), 1e-5.
* The loss functions (``valid``-weighted) and the plateau scheduler, 1e-5.
* The entry points run on the card unless asked for the CPU: without one,
  asking for the default raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_robustness_tpu import config as jcfg
from multimodal_transformer_robustness_tpu.models import headers as jheaders
from multimodal_transformer_robustness_tpu.ops import encoder as jenc
from multimodal_transformer_robustness_tpu.ops import gru as jgru
from multimodal_transformer_robustness_tpu.train.sampling import (
    sample_train_config as j_sample)
from multimodal_transformer_robustness_tpu_torch import config as tcfg
from multimodal_transformer_robustness_tpu_torch.cli import realtime
from multimodal_transformer_robustness_tpu_torch.models import headers as theaders
from multimodal_transformer_robustness_tpu_torch.ops import attention as tatt
from multimodal_transformer_robustness_tpu_torch.ops import encoder as tenc
from multimodal_transformer_robustness_tpu_torch.ops.dropout import dropout
from multimodal_transformer_robustness_tpu_torch.train import TrainHParams, Trainer
from multimodal_transformer_robustness_tpu_torch.train.sampling import (
    sample_train_config as t_sample)
from multimodal_transformer_robustness_tpu_torch.weights import load_encoder_stack
from test_torch_ops import _spec

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("experiment_type,kw", [
    ("random_sample", {}),
    ("random_sample", dict(modality_pool=[[0], [1, 2], [0, 1, 2]])),
    ("baseline_ic", {}),
    ("baseline_ic", dict(all_module=True)),
    ("baseline_ia", {}),
    ("baseline_ib", {}),
    ("test_single", dict(modality_pool=[[0, 2]])),
    ("test_single", dict(modality_pool=[[1]])),
])
def test_sample_train_config_matches(experiment_type, kw):
    """50 draws per experiment type from one seed: the same configurations."""
    js, ts = _spec(jcfg), _spec(tcfg)
    pool = kw.pop("modality_pool", None)
    j_rng, t_rng = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(50):
        jc = j_sample(js, experiment_type, pool, j_rng, **kw)
        tc = t_sample(ts, experiment_type, pool, t_rng, **kw)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        tc.validate(ts)
    assert t_rng.bit_generator.state == j_rng.bit_generator.state


@pytest.mark.parametrize("mods", [("t", "a", "v"), ("t", "a", "v", "x")])
def test_topology_samplers_match(mods):
    """``gen_active_cross``, ``rand_gen_modality_str`` and ``gen_subnet``:
    50 draws each, the JAX package's results from the same seed."""
    kw = dict(modality_set=mods, orig_dimensions=tuple(range(4, 4 + len(mods))),
              attn_dropout=(0.1,) * (len(mods) + 1))
    js, ts = _spec(jcfg, **kw), _spec(tcfg, **kw)
    j_rng, t_rng = np.random.default_rng(3), np.random.default_rng(3)
    jm, tm = jcfg.ModalityStr(list(mods)), tcfg.ModalityStr(list(mods))
    subsets = [list(range(len(mods))), [0, 2], [1]]
    for i in range(50):
        active = subsets[i % len(subsets)]
        assert tcfg.gen_active_cross(ts, active, rng=t_rng) == \
            jcfg.gen_active_cross(js, active, rng=j_rng)
        assert tm.rand_gen_modality_str([mods[i % len(mods)]], p=0.6, rng=t_rng) == \
            jm.rand_gen_modality_str([mods[i % len(mods)]], p=0.6, rng=j_rng)
        assert tcfg.gen_subnet(list(mods), 0.5, rng=t_rng) == \
            jcfg.gen_subnet(list(mods), 0.5, rng=j_rng)
    assert t_rng.bit_generator.state == j_rng.bit_generator.state


@pytest.mark.parametrize("p", [0.1, 0.3])
def test_dropout_keep_fraction_and_scale(p):
    n = 200_000
    x = torch.ones(n)
    y = dropout(x, p, True, torch.Generator().manual_seed(0))
    kept = y != 0
    sigma = np.sqrt(p * (1 - p) / n)
    assert abs(kept.float().mean().item() - (1 - p)) < 5 * sigma
    assert torch.equal(y[kept], torch.full_like(y[kept], 1.0) / (1.0 - p))
    # the same seed draws the same mask; another seed another one
    assert torch.equal(y, dropout(x, p, True, torch.Generator().manual_seed(0)))
    assert not torch.equal(y, dropout(x, p, True, torch.Generator().manual_seed(1)))


def test_dropout_identity_in_eval_and_at_rate_zero():
    x = torch.randn(5, 7)
    gen = torch.Generator().manual_seed(0)
    assert dropout(x, 0.3, False, gen) is x
    assert dropout(x, 0.0, True, gen) is x
    assert dropout(x, 0.3, False, None) is x
    with pytest.raises(ValueError, match="generator"):
        dropout(x, 0.3, True, None)


def test_attention_t1_dropout_is_per_head():
    """On the T==1 fast path the dropout falls on the constant attention
    weights ``ones [B, H, 1, 1]``: each (item, head) either drops its whole
    value row or scales it by 1 / (1 - p)."""
    rng = np.random.default_rng(5)
    B, H, Dh, E, p = 6, 3, 4, 12, 0.5
    params = {"in_proj_w": torch.from_numpy(rng.standard_normal((3, H, Dh, E)).astype(np.float32)),
              "in_proj_b": torch.zeros(3, H, Dh), "out_w": torch.eye(E, H * Dh).reshape(E, H, Dh),
              "out_b": torch.zeros(E)}
    x = torch.from_numpy(rng.standard_normal((B, 1, E)).astype(np.float32))
    ones = torch.ones(H)
    out = tatt.multihead_attention(params, x, x, x, head_mask=ones, head_dim_mask=torch.ones(Dh),
                                   attn_dropout=p, train=True,
                                   generator=torch.Generator().manual_seed(2))
    keep = dropout(torch.ones(B, H, 1, 1), p, True, torch.Generator().manual_seed(2))
    v = torch.einsum("bte,hde->bthd", x, params["in_proj_w"][2])
    ref = (keep.transpose(1, 2) * v).reshape(B, 1, H * Dh)
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("mode,t,tk", [("self", 1, None), ("self", 5, None),
                                       ("cross", 1, 1), ("cross", 4, 6),
                                       ("channel", 1, None)])
def test_train_mode_encoder_matches(mode, t, tk):
    """Rates 0: values and the gradients of every parameter and input."""
    rng = np.random.default_rng(8)
    E, H, Dh, L = 12, 2, 4, 3
    jhp = jenc.EncoderHParams(embed_dim_in=E, num_heads=H, head_dim=Dh, layers=L,
                              attn_mask=True)
    params = jenc.init_encoder(jax.random.PRNGKey(4), jhp)
    params = jax.tree.map(lambda a: a + 0.05 * jnp.asarray(
        rng.standard_normal(a.shape), jnp.float32), params)
    gates = np.array([1, 0, 1], np.float32)
    head, hdim = np.array([1, 1], np.float32), np.array([1, 1, 1, 0], np.float32)
    ffn = (np.arange(4 * H * Dh) < 20).astype(np.float32)
    cm = (np.array([0, 0, 1, 1, 1, 1, 0, 1, 1, 1, 0, 0], np.float32)
          if mode == "channel" else None)
    x = rng.standard_normal((3, t, E)).astype(np.float32) * (1 if cm is None else cm)
    kv = rng.standard_normal((3, tk, E)).astype(np.float32) if mode == "cross" else None
    ct = rng.standard_normal((3, t, E)).astype(np.float32)
    jm = jenc.EncoderMasks(*[None if a is None else jnp.asarray(a)
                             for a in (gates, head, hdim, ffn, cm)])
    tm = tenc.EncoderMasks(*[None if a is None else torch.from_numpy(a)
                             for a in (gates, head, hdim, ffn, cm)])

    def j_loss(p, xx, kk):
        out = jenc.encoder_forward(p, xx, kk, hp=jhp, masks=jm, attn_rate=0.0,
                                   train=True, rng=jax.random.PRNGKey(0))
        return jnp.sum(out * ct), out

    args = (params, jnp.asarray(x), None if kv is None else jnp.asarray(kv))
    (_, ref), grads = jax.value_and_grad(j_loss, argnums=(0, 1, 2) if kv is not None
                                         else (0, 1), has_aux=True)(*args)

    thp = tenc.EncoderHParams(embed_dim_in=E, num_heads=H, head_dim=Dh, layers=L,
                              attn_mask=True)
    tp = load_encoder_stack(params)
    leaves = [a.requires_grad_(True) for a in jax.tree.leaves(tp)]
    tx = torch.from_numpy(x).requires_grad_(True)
    tk_in = None if kv is None else torch.from_numpy(kv).requires_grad_(True)
    out = tenc.encoder_forward(tp, tx, tk_in, hp=thp, masks=tm, attn_rate=0.0, train=True,
                               generator=torch.Generator().manual_seed(0))
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    j_leaves = jax.tree.leaves(load_encoder_stack(grads[0]))
    assert len(j_leaves) == len(leaves)
    for a, b in zip(leaves, j_leaves):
        np.testing.assert_allclose(a.grad.numpy(), b.numpy(), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(grads[1]), **TOL)
    if kv is not None:
        np.testing.assert_allclose(tk_in.grad.numpy(), np.asarray(grads[2]), **TOL)


def test_cnn_header_conv_grad_matches_pallas(monkeypatch):
    """The cnn_rnn header keeps gru1's input gradient (``live_input``): the
    conv weight's gradient is non-zero and equals the JAX package's on its
    Pallas path, as are the GRU weights' gradients."""
    monkeypatch.setattr(jgru, "RECURRENCE_IMPL", "pallas_interpret")
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    params = {"cnn": jheaders._init_cnn(k1), "rnn": jheaders._init_rnn_header(k2, 4, 6)}
    x = np.random.default_rng(7).standard_normal((3, 1, 8, 8)).astype(np.float32)
    ct = np.random.default_rng(8).standard_normal((3, 1, 6)).astype(np.float32)

    def loss(p):
        return jnp.sum(jheaders.header_apply("cnn_rnn", p, jnp.asarray(x)) * ct)

    g_ref = jax.grad(loss)(params)
    tp = jax.tree.map(lambda a: torch.tensor(np.asarray(a), requires_grad=True), params)
    (theaders.header_apply("cnn_rnn", tp, torch.from_numpy(x)) *
     torch.from_numpy(ct)).sum().backward()
    ref_cw = np.asarray(g_ref["cnn"]["w"])
    assert np.abs(ref_cw).max() > 0
    np.testing.assert_allclose(tp["cnn"]["w"].grad.numpy(), ref_cw, **TOL)
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(g_ref)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), **TOL)


def test_entry_points_default_to_the_card(monkeypatch):
    """``StreamingPredictor``, the realtime CLI and ``Trainer`` ask for
    ``cuda`` unless told otherwise; with no card that raises: nothing falls
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        realtime.StreamingPredictor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        realtime.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(_spec(tcfg), {}, {}, TrainHParams())


@pytest.mark.parametrize("name", ["L1Loss", "MSELoss", "CrossEntropyLoss"])
def test_criterion_matches(name):
    """The ``valid``-weighted losses, a padded tail row included."""
    from multimodal_transformer_robustness_tpu.train import loop as jloop
    from multimodal_transformer_robustness_tpu_torch.train import make_criterion

    rng = np.random.default_rng(9)
    preds = rng.standard_normal((5, 4)).astype(np.float32)
    labels = (rng.integers(0, 4, 5) if name == "CrossEntropyLoss"
              else rng.standard_normal((5, 4))).astype(np.float32)
    valid = np.array([1, 1, 1, 1, 0], np.float32)
    ref = jloop.make_criterion(name)(jnp.asarray(preds), jnp.asarray(labels),
                                     jnp.asarray(valid))
    out = make_criterion(name)(torch.from_numpy(preds), torch.from_numpy(labels),
                               torch.from_numpy(valid))
    np.testing.assert_allclose(out.item(), float(ref), **TOL)


def test_plateau_scheduler_and_optimizer_table_match():
    from multimodal_transformer_robustness_tpu.train import loop as jloop
    from multimodal_transformer_robustness_tpu.train.optim import TORCH_DEFAULT_OPTIMIZERS
    from multimodal_transformer_robustness_tpu_torch.train import (
        TORCH_DEFAULT_OPTIMIZERS as T_OPTS, ReduceLROnPlateau)

    assert sorted(T_OPTS) == sorted(TORCH_DEFAULT_OPTIMIZERS)
    metrics = [1.0, 0.9, 0.9, 0.95, 0.91, 0.89999, 0.5, 0.6, 0.6, 0.6, 0.6]
    j, t = jloop.ReduceLROnPlateau(1e-3, patience=2), ReduceLROnPlateau(1e-3, patience=2)
    assert [t.step(m) for m in metrics] == [j.step(m) for m in metrics]


@pytest.mark.parametrize("factor", [0.5, 1.0, 2.0])
def test_clip_by_global_norm_matches_optax(factor):
    """The port's clip against ``optax.clip_by_global_norm`` (the JAX
    package's) on a tree whose global norm is ``factor`` x ``max_norm``:
    untouched below the limit, ``(g / norm) * max_norm`` at and above it,
    rtol 1e-6.  (torch's ``clip_grad_norm_`` divides by norm + 1e-6 and
    misses by ~1e-3 at 1x and ~5e-4 at 2x.)"""
    import optax

    from multimodal_transformer_robustness_tpu_torch.train.optim import clip_by_global_norm_

    max_norm = 1e-3
    rng = np.random.default_rng(12)
    tree = [rng.standard_normal(s).astype(np.float32) for s in [(7,), (3, 5), (2, 2, 4)]]
    norm = np.sqrt(sum(float(np.sum(t.astype(np.float64) ** 2)) for t in tree))
    tree = [t * np.float32(factor * max_norm / norm) for t in tree]
    ref, _ = optax.clip_by_global_norm(max_norm).update(tree, optax.EmptyState())
    grads = [torch.from_numpy(t.copy()) for t in tree]
    clip_by_global_norm_(grads, max_norm)
    for got, want in zip(grads, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
