"""Parity of the PyTorch port's ops with the JAX package's, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
and its port counterpart; JAX parameters cross over as numpy arrays.  JAX's
matmul precision is pinned to "highest" by conftest.py, so both sides are
float32 throughout: tolerance atol = rtol = 1e-5 (float32 sums taken in a
different order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_robustness_tpu import config as jcfg
from multimodal_transformer_robustness_tpu import masks as jmasks
from multimodal_transformer_robustness_tpu.data import tokenizer as jtok
from multimodal_transformer_robustness_tpu.ops import attention as jatt
from multimodal_transformer_robustness_tpu.ops import encoder as jenc
from multimodal_transformer_robustness_tpu.ops import gru as jgru
from multimodal_transformer_robustness_tpu.ops import layernorm as jln
from multimodal_transformer_robustness_tpu.ops import linear as jlin
from multimodal_transformer_robustness_tpu.ops import positional as jpos
from multimodal_transformer_robustness_tpu_torch import config as tcfg
from multimodal_transformer_robustness_tpu_torch import masks as tmasks
from multimodal_transformer_robustness_tpu_torch.data import tokenizer as ttok
from multimodal_transformer_robustness_tpu_torch.ops import attention as tatt
from multimodal_transformer_robustness_tpu_torch.ops import encoder as tenc
from multimodal_transformer_robustness_tpu_torch.ops import gru as tgru
from multimodal_transformer_robustness_tpu_torch.ops import layernorm as tln
from multimodal_transformer_robustness_tpu_torch.ops import linear as tlin
from multimodal_transformer_robustness_tpu_torch.ops import positional as tpos
from multimodal_transformer_robustness_tpu_torch.weights import load_encoder_stack

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(tree):
    """JAX / numpy tree -> torch float tensors (ints stay ints)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree))


def _close(torch_out, jax_out, **tol):
    np.testing.assert_allclose(torch_out.detach().numpy(), np.asarray(jax_out),
                               **(tol or TOL))


def _spec(module, **kw):
    base = dict(modality_set=("t", "a", "v"), orig_dimensions=(6, 10, 12),
                dimension=8, num_heads=2, head_dim=4, layers_single_attn=2,
                layers_cross_attn=2, layers_self_attn=1,
                attn_dropout=(0.1, 0.1, 0.0, 0.0), relu_dropout=0.1,
                res_dropout=0.1, out_dropout=0.1, embed_dropout=0.3,
                attn_mask=True, output_dim=1)
    base.update(kw)
    return module.ModelSpec(**base)


def test_config_structure_matches():
    for mods in (("t", "a", "v"), ("a", "v"), ("t", "a", "v", "x")):
        dims = tuple(range(4, 4 + len(mods)))
        kw = dict(modality_set=mods, orig_dimensions=dims,
                  attn_dropout=(0.1,) * (len(mods) + 1))
        js, ts = _spec(jcfg, **kw), _spec(tcfg, **kw)
        assert ts.cross_strings == js.cross_strings
        assert ts.slot_lists == js.slot_lists
        assert ts.stream_order() == js.stream_order()
        assert ts.cross_level_ranges() == js.cross_level_ranges()
        assert ts.combined_dim == js.combined_dim and ts.top_dim == js.top_dim
        assert [ts.attn_dropout_for_cross(i) for i in range(len(ts.cross_strings))] == \
            [js.attn_dropout_for_cross(i) for i in range(len(js.cross_strings))]
        assert [ts.header_kind(c) for c in mods] == [js.header_kind(c) for c in mods]
        assert dataclasses.asdict(tcfg.full_active_config(ts)) == \
            dataclasses.asdict(jcfg.full_active_config(js))


def test_build_masks_match():
    from multimodal_transformer_robustness_tpu.train.sampling import sample_train_config

    js, ts = _spec(jcfg), _spec(tcfg)
    rng = np.random.default_rng(0)
    cfgs = [jcfg.full_active_config(js)] + [
        sample_train_config(js, "random_sample", None, rng) for _ in range(4)]
    for cfg in cfgs:
        jm = jmasks.build_masks(js, cfg)
        tm = tmasks.build_masks(ts, tcfg.ActiveConfig(**dataclasses.asdict(cfg)))
        for f in dataclasses.fields(jm):
            np.testing.assert_array_equal(getattr(tm, f.name).numpy(),
                                          np.asarray(getattr(jm, f.name)))
        np.testing.assert_array_equal(tm.output_channel_mask(8).numpy(),
                                      np.asarray(jm.output_channel_mask(8)))


def test_masked_linear_matches():
    rng = np.random.default_rng(0)
    p = jlin.init_linear(jax.random.PRNGKey(0), 12, 7)
    x = rng.standard_normal((3, 5, 12)).astype(np.float32)
    m_in = (rng.random(12) > 0.3).astype(np.float32)
    m_out = (rng.random(7) > 0.3).astype(np.float32)
    ref = jlin.masked_linear(jnp.asarray(x), p["w"], p["b"], jnp.asarray(m_in),
                             jnp.asarray(m_out))
    out = tlin.masked_linear(torch.from_numpy(x), _t(p["w"]), _t(p["b"]),
                             torch.from_numpy(m_in), torch.from_numpy(m_out))
    _close(out, ref)


@pytest.mark.parametrize("mask", ["none", "ragged", "zero"])
def test_masked_layer_norm_matches(mask):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 3, 16)) * 3 + 2).astype(np.float32)
    g = rng.standard_normal(16).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    m = {"none": None, "ragged": (rng.random(16) > 0.4).astype(np.float32),
         "zero": np.zeros(16, np.float32)}[mask]
    ref = jln.masked_layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                                None if m is None else jnp.asarray(m))
    out = tln.masked_layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                                torch.from_numpy(b),
                                None if m is None else torch.from_numpy(m))
    _close(out, ref)


@pytest.mark.parametrize("masked", [False, True])
def test_positional_matches(masked):
    rng = np.random.default_rng(2)
    feat0 = rng.standard_normal((3, 9)).astype(np.float32)
    feat0[:, -2:] = 0.0                              # padding columns
    m = (rng.random(24) > 0.3).astype(np.float32) if masked else None
    jp = jpos.make_positions(jnp.asarray(feat0))
    tp = tpos.make_positions(torch.from_numpy(feat0))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    ref = jpos.sinusoidal_pe(jp, 24, None if m is None else jnp.asarray(m))
    out = tpos.sinusoidal_pe(tp, 24, None if m is None else torch.from_numpy(m))
    _close(out, ref)


@pytest.mark.parametrize("tq,tk,masked", [(1, 1, False), (6, 6, True), (4, 7, True),
                                          (5, 3, False)])
def test_attention_matches(tq, tk, masked):
    rng = np.random.default_rng(3)
    H, Dh, E = 3, 4, 10
    p = jatt.init_mha(jax.random.PRNGKey(1), E, H, Dh)
    p = dict(p, in_proj_b=jnp.asarray(rng.standard_normal((3, H, Dh)), jnp.float32),
             out_b=jnp.asarray(rng.standard_normal(E), jnp.float32))
    q = rng.standard_normal((2, tq, E)).astype(np.float32)
    kv = rng.standard_normal((2, tk, E)).astype(np.float32)
    head = np.array([1, 1, 0], np.float32)
    hdim = np.array([1, 1, 1, 0], np.float32)
    cm = (rng.random(E) > 0.3).astype(np.float32) if tq == tk else None
    jb = jatt.future_mask(tq, tk) if masked else None
    tb = tatt.future_mask(tq, tk) if masked else None
    if masked:
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    ref = jatt.multihead_attention(p, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
                                   head_mask=jnp.asarray(head),
                                   head_dim_mask=jnp.asarray(hdim), attn_bias=jb,
                                   channel_mask=None if cm is None else jnp.asarray(cm))
    out = tatt.multihead_attention(_t(p), torch.from_numpy(q), torch.from_numpy(kv),
                                   torch.from_numpy(kv), head_mask=torch.from_numpy(head),
                                   head_dim_mask=torch.from_numpy(hdim), attn_bias=tb,
                                   channel_mask=None if cm is None else torch.from_numpy(cm))
    _close(out, ref)


@pytest.mark.parametrize("mode,t,tk", [("self", 1, None), ("self", 5, None),
                                       ("cross", 1, 1), ("cross", 4, 6),
                                       ("channel", 1, None)])
def test_encoder_forward_matches(mode, t, tk):
    rng = np.random.default_rng(4)
    E, H, Dh, L = 12, 2, 4, 3
    hp = jenc.EncoderHParams(embed_dim_in=E, num_heads=H, head_dim=Dh, layers=L,
                             attn_mask=True)
    params = jenc.init_encoder(jax.random.PRNGKey(2), hp)
    params = jax.tree.map(lambda a: a + 0.05 * jnp.asarray(
        rng.standard_normal(a.shape), jnp.float32), params)  # non-trivial biases / LN
    gates = np.array([1, 0, 1], np.float32)
    head = np.array([1, 1], np.float32)
    hdim = np.array([1, 1, 1, 0], np.float32)
    ffn = (np.arange(4 * H * Dh) < 20).astype(np.float32)
    cm = None
    x = rng.standard_normal((3, t, E)).astype(np.float32)
    if mode == "channel":
        cm = np.array([0, 0, 1, 1, 1, 1, 0, 1, 1, 1, 0, 0], np.float32)
        x = x * cm
    kv = rng.standard_normal((3, tk, E)).astype(np.float32) if mode == "cross" else None
    jm = jenc.EncoderMasks(jnp.asarray(gates), jnp.asarray(head), jnp.asarray(hdim),
                           jnp.asarray(ffn), None if cm is None else jnp.asarray(cm))
    tm = tenc.EncoderMasks(torch.from_numpy(gates), torch.from_numpy(head),
                           torch.from_numpy(hdim), torch.from_numpy(ffn),
                           None if cm is None else torch.from_numpy(cm))
    ref = jenc.encoder_forward(params, jnp.asarray(x),
                               None if kv is None else jnp.asarray(kv), hp=hp, masks=jm)
    thp = tenc.EncoderHParams(embed_dim_in=E, num_heads=H, head_dim=Dh, layers=L,
                              attn_mask=True)
    out = tenc.encoder_forward(load_encoder_stack(params), torch.from_numpy(x),
                               None if kv is None else torch.from_numpy(kv),
                               hp=thp, masks=tm)
    _close(out, ref)


def test_encoder_train_mode_runs():
    """Train mode with nonzero rates draws from the generator: finite,
    repeatable from its seed, different from eval mode."""
    rng = np.random.default_rng(6)
    E, H, Dh, L = 12, 2, 4, 2
    jhp = jenc.EncoderHParams(embed_dim_in=E, num_heads=H, head_dim=Dh, layers=L)
    params = load_encoder_stack(jenc.init_encoder(jax.random.PRNGKey(3), jhp))
    m = tenc.EncoderMasks(torch.ones(L), torch.ones(H), torch.ones(Dh),
                          torch.ones(4 * H * Dh))
    hp = tenc.EncoderHParams(embed_dim_in=E, num_heads=H, head_dim=Dh, layers=L,
                             attn_mask=True, relu_dropout=0.1, res_dropout=0.1,
                             embed_dropout=0.3)
    x = torch.from_numpy(rng.standard_normal((64, 1, E)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((64, 1, E)).astype(np.float32))

    def run(train):
        return tenc.encoder_forward(params, x, kv, hp=hp, masks=m, attn_rate=0.2,
                                    train=train, generator=torch.Generator().manual_seed(0))

    a = run(True)
    assert a.shape == x.shape and torch.isfinite(a).all()
    torch.testing.assert_close(a, run(True), atol=0, rtol=0)
    assert not torch.allclose(a, run(False))


def test_bigru_forward_matches():
    rng = np.random.default_rng(5)
    B, T, I, H = 3, 11, 7, 6
    p = jgru.init_bigru(jax.random.PRNGKey(3), I, H)
    x = rng.standard_normal((B, T, I)).astype(np.float32)
    ref_out, ref_fin = jgru.bigru_forward(p, jnp.asarray(x))
    out, fin = tgru.bigru_forward({d: _t(p[d]) for d in ("fwd", "bwd")},
                                  torch.from_numpy(x))
    _close(out, ref_out)
    _close(fin, ref_fin)


def test_tokenizers_match(tmp_path):
    text = "Hello, world! It's a naïve test of word-pieces"
    for n in (8, 16):
        assert ttok.HashTokenizer().encode_plus(text, n) == \
            jtok.HashTokenizer().encode_plus(text, n)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "hello", ",",
                                "world", "!", "it", "'", "s", "a", "na", "##ive",
                                "test", "of", "word", "-", "piece", "##s"]))
    for n in (6, 32):
        assert ttok.load_tokenizer(str(tmp_path)).encode_plus(text, n) == \
            jtok.WordPieceTokenizer(str(vocab)).encode_plus(text, n)
