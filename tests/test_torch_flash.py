"""The port's flash attention (K5, K8) and its ``attn_impl="flash"`` path,
against the JAX package on the CPU.

On CPU tensors every wrapper runs its plain PyTorch version; the JAX side
runs its Pallas kernels in interpret mode.  Inputs come from numpy seeds.
Tolerances: the position hash is integer math, so it is held bit for bit;
attention outputs at 1e-5 and their gradients at 5e-5 (the JAX package's
own flash tolerance, tests/test_ops.py); the encoder stack at 2e-5 in eval
and 1e-4 for its training gradients (float32 summed in other orders
through several layers); the supernet at 1e-4, as the serving slice.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_robustness_tpu import build_masks as j_build_masks
from multimodal_transformer_robustness_tpu import config as jcfg
from multimodal_transformer_robustness_tpu.checkpoint import import_torch_state_dict
from multimodal_transformer_robustness_tpu.models import supernet_apply as j_apply
from multimodal_transformer_robustness_tpu.ops import attention_pallas as jap
from multimodal_transformer_robustness_tpu.ops import encoder as jenc
from multimodal_transformer_robustness_tpu.train.sampling import sample_train_config
from multimodal_transformer_robustness_tpu_torch import config as tcfg
from multimodal_transformer_robustness_tpu_torch.masks import build_masks as t_build_masks
from multimodal_transformer_robustness_tpu_torch.models import mult as tmult
from multimodal_transformer_robustness_tpu_torch.ops import attention_cuda as tac
from multimodal_transformer_robustness_tpu_torch.ops import encoder as tenc
from multimodal_transformer_robustness_tpu_torch.train import loop as tloop
from multimodal_transformer_robustness_tpu_torch.weights import (
    export_reference_state_dict, load_encoder_stack)


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, -1, 2**31 - 1, -2**31])
def test_hash_uniform_bit_exact(seed):
    ref = np.asarray(jap.dropout_uniform(seed, 300, 700))
    out = tac.dropout_uniform(seed, 300, 700).numpy()
    assert out.dtype == np.float32 and np.array_equal(out, ref)
    # broadcast over per-slice seeds, as the kernels' plain versions draw
    seeds = torch.tensor([seed, 7], dtype=torch.int32).reshape(2, 1, 1)
    both = tac.hash_uniform(seeds, torch.arange(300)[:, None], torch.arange(700)[None, :])
    assert np.array_equal(both[0].numpy(), ref)


# (b, h, tq, tk, d, causal, rate)
_K5_CASES = {"self": (2, 2, 16, 16, 8, True, 0.0),
             "cross": (1, 2, 7, 20, 12, True, 0.0),
             "dropout": (2, 2, 12, 9, 25, True, 0.3),
             "unmasked_dropout": (1, 3, 10, 6, 8, False, 0.3)}


@pytest.mark.parametrize("case", list(_K5_CASES))
def test_flash_plain_matches_pallas(case):
    """K5's plain version against JAX ``flash_attention(interpret=True)``
    with the same seeds and rates: the output, the log-sum-exp and the
    gradients of ``sum(sin(out))``, which the CPU wrappers of K5dq and
    K5dkv, and ``flash_bwd``, give alone."""
    b, h, tq, tk, d, causal, rate = _K5_CASES[case]
    rng = np.random.default_rng(0)
    q, k, v = _np(rng, b, h, tq, d), _np(rng, b, h, tk, d), _np(rng, b, h, tk, d)
    offset = 1 + abs(tk - tq)
    seeds = rng.integers(-2**31, 2**31 - 1, b * h).astype(np.int32) if rate else None
    rates = np.full(b * h, rate, np.float32) if rate else None
    jkw = dict(dropout_seeds=jnp.asarray(seeds), dropout_rates=jnp.asarray(rates)) if rate \
        else {}

    def j_loss(q_, k_, v_):
        return jnp.sum(jnp.sin(jap.flash_attention(q_, k_, v_, causal=causal, offset=offset,
                                                   interpret=True, **jkw)))

    j_args = [jnp.asarray(a) for a in (q, k, v)]
    ref = jap.flash_attention(*j_args, causal=causal, offset=offset, interpret=True, **jkw)
    j_grads = jax.grad(j_loss, argnums=(0, 1, 2))(*j_args)
    _, j_lse = jap._flash_fwd_impl(*j_args, jkw.get("dropout_seeds", jnp.zeros(b * h, jnp.int32)),
                                   jkw.get("dropout_rates", jnp.zeros(b * h)), causal, offset,
                                   256, 512, bool(rate), True)

    t_seeds = None if seeds is None else torch.from_numpy(seeds)
    t_rates = None if rates is None else torch.from_numpy(rates)
    tq_, tk_, tv_ = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tac.flash_attention(tq_, tk_, tv_, causal, offset, t_seeds, t_rates)
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
    for a, r in zip((tq_.grad, tk_.grad, tv_.grad), j_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=5e-5)

    args = [torch.from_numpy(a) for a in (q, k, v)]
    fwd_out, lse = tac.flash_fwd(*args, t_seeds, t_rates, causal, offset)
    assert torch.equal(fwd_out, out.detach())
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[:, 0, :tq], atol=1e-5)
    dout = torch.cos(out.detach())
    delta = (dout * fwd_out).sum(-1).reshape(b * h, tq)
    dq = tac.flash_bwd_dq(*args, dout, lse, delta, t_seeds, t_rates, causal, offset)
    dk, dv = tac.flash_bwd_dkv(*args, dout, lse, delta, t_seeds, t_rates, causal, offset)
    for a, r in zip((dq, dk, dv), (tq_.grad, tk_.grad, tv_.grad)):
        torch.testing.assert_close(a, r, atol=1e-6, rtol=1e-6)
    # the entry FlashAttention.backward calls: it takes out, not delta
    grads = tac.flash_bwd(*args, dout, fwd_out, lse, t_seeds, t_rates, causal, offset)
    for a, r in zip(grads, j_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=5e-5)


def test_flash_refuses_what_it_cannot_honour():
    """A causal offset below 1 (the JAX package asserts the same) and an
    additive bias on the flash path, which takes the mask as its rule."""
    from multimodal_transformer_robustness_tpu_torch.ops.attention import (
        future_mask, init_mha, multihead_attention)

    q = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError, match="offset >= 1"):
        tac.flash_attention(q, q, q, causal=True, offset=0)
    x = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="causal_offset"):
        multihead_attention(init_mha(torch.Generator().manual_seed(0), 8, 2, 4), x, x, x,
                            head_mask=torch.ones(2), head_dim_mask=torch.ones(4),
                            attn_bias=future_mask(4, 4), impl="flash", causal_offset=1)


@pytest.mark.parametrize("b,h,t,d", [(3, 2, 32, 64), (2, 2, 48, 16), (2, 1, 9, 25),
                                     (3, 2, (9, 40), 25)])
def test_flash_masked_plain_matches_pallas(b, h, t, d):
    """K8's plain version against JAX ``flash_attention_masked(interpret=
    True)``: ragged and non-contiguous key masks and one all-zero row; ``t``
    is T or (Tq, Tk)."""
    tq, tk = t if isinstance(t, tuple) else (t, t)
    rng = np.random.default_rng(1)
    q = _np(rng, b, h, tq, d)
    k, v = (_np(rng, b, h, tk, d) for _ in range(2))
    mask = (rng.random((b, tk)) > 0.4).astype(np.int32)
    mask[0] = 0                                          # all keys masked
    mask[1, : rng.integers(1, tk)] = 1
    ref = jap.flash_attention_masked(*(jnp.asarray(a) for a in (q, k, v)),
                                     jnp.asarray(mask), interpret=True)
    out = tac.flash_attention_masked(*(torch.from_numpy(a) for a in (q, k, v)),
                                     torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def _encoder_case(rng, E=16, H=2, Dh=8, L=2):
    hp = dict(embed_dim_in=E, num_heads=H, head_dim=Dh, layers=L, attn_mask=True)
    params = jenc.init_encoder(jax.random.PRNGKey(7), jenc.EncoderHParams(**hp))
    params = jax.tree.map(lambda a: a + 0.05 * jnp.asarray(
        rng.standard_normal(a.shape), jnp.float32), params)
    masks = [np.ones(L, np.float32), np.array([1, 0], np.float32),
             (np.arange(Dh) < 5).astype(np.float32),
             (np.arange(4 * H * Dh) < 20).astype(np.float32)]
    jm = jenc.EncoderMasks(*[jnp.asarray(a) for a in masks])
    tm = tenc.EncoderMasks(*[torch.from_numpy(a) for a in masks])
    return hp, params, jm, tm


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX package's attention reaches ``flash_attention`` through its
    module attribute: run that kernel in interpret mode."""
    monkeypatch.setattr(jap, "flash_attention",
                        functools.partial(jap.flash_attention, interpret=True))


@pytest.mark.parametrize("mode", ["self", "cross"])
def test_flash_encoder_eval_matches_jax(mode, pallas_interpret):
    rng = np.random.default_rng(2)
    hp, params, jm, tm = _encoder_case(rng)
    x = _np(rng, 2, 12, 16)
    kv = _np(rng, 2, 17, 16) if mode == "cross" else None
    ref = jenc.encoder_forward(params, jnp.asarray(x), None if kv is None else jnp.asarray(kv),
                               hp=jenc.EncoderHParams(**hp, attn_impl="flash"), masks=jm)
    thp = tenc.EncoderHParams(**hp, attn_impl="flash")
    out = tenc.encoder_forward(load_encoder_stack(params), torch.from_numpy(x),
                               None if kv is None else torch.from_numpy(kv), hp=thp, masks=tm)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    # and the port's own dense path with the additive future mask
    dense = tenc.encoder_forward(load_encoder_stack(params), torch.from_numpy(x),
                                 None if kv is None else torch.from_numpy(kv),
                                 hp=dataclasses.replace(thp, attn_impl="xla"), masks=tm)
    torch.testing.assert_close(out, dense, atol=2e-5, rtol=0)


@pytest.mark.parametrize("mode", ["self", "cross"])
def test_flash_encoder_train_grads_match_jax(mode, pallas_interpret):
    """Train mode at attention rate 0, every other dropout 0 (the JAX side
    through its in-kernel dropout at rate 0, ``flash_zero_rates=False``):
    the outputs and the gradients of every parameter and input."""
    rng = np.random.default_rng(3)
    hp, params, jm, tm = _encoder_case(rng)
    x = _np(rng, 2, 10, 16)
    kv = _np(rng, 2, 6, 16) if mode == "cross" else None
    ct = _np(rng, 2, 10, 16)
    jhp = jenc.EncoderHParams(**hp, attn_impl="flash", flash_zero_rates=False)

    def j_loss(p, xx, kk):
        out = jenc.encoder_forward(p, xx, kk, hp=jhp, masks=jm, attn_rate=0.0, train=True,
                                   rng=jax.random.PRNGKey(0))
        return jnp.sum(out * ct), out

    argnums = (0, 1, 2) if kv is not None else (0, 1)
    (_, ref), grads = jax.value_and_grad(j_loss, argnums=argnums, has_aux=True)(
        params, jnp.asarray(x), None if kv is None else jnp.asarray(kv))

    tp = load_encoder_stack(params)
    leaves = [a.requires_grad_(True) for a in jax.tree.leaves(tp)]
    tx = torch.from_numpy(x).requires_grad_(True)
    tkv = None if kv is None else torch.from_numpy(kv).requires_grad_(True)
    out = tenc.encoder_forward(tp, tx, tkv, hp=tenc.EncoderHParams(
        **hp, attn_impl="flash"), masks=tm, attn_rate=0.0,
        train=True, generator=torch.Generator().manual_seed(0))
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2e-5)
    j_leaves = jax.tree.leaves(load_encoder_stack(grads[0]))
    assert len(j_leaves) == len(leaves)
    for a, b in zip(leaves, j_leaves):
        np.testing.assert_allclose(a.grad.numpy(), b.numpy(), atol=1e-4)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(grads[1]), atol=1e-4)
    if kv is not None:
        np.testing.assert_allclose(tkv.grad.numpy(), np.asarray(grads[2]), atol=1e-4)


def test_flash_encoder_dropout_trains():
    """Nonzero attention dropout inside the kernel's plain version: repeatable
    from the generator's seed, another seed draws another mask, the mean
    over draws approaches the rate-0 forward, and every gradient is finite."""
    rng = np.random.default_rng(4)
    hp, params, _, _ = _encoder_case(rng, L=1)
    tm = tenc.EncoderMasks(torch.ones(1), torch.ones(2), torch.ones(8), torch.ones(64))
    thp = tenc.EncoderHParams(**hp, attn_impl="flash")
    tp = load_encoder_stack(params)
    x = torch.from_numpy(_np(rng, 2, 10, 16))

    def fwd(seed, rate, p=tp):
        return tenc.encoder_forward(p, x, hp=thp, masks=tm, attn_rate=rate, train=True,
                                    generator=torch.Generator().manual_seed(seed))

    y1, y2, y3 = fwd(0, 0.4), fwd(0, 0.4), fwd(1, 0.4)
    assert torch.equal(y1, y2) and (y1 - y3).abs().max() > 1e-6
    y0 = fwd(0, 0.0)
    ys = torch.stack([fwd(i, 0.4) for i in range(64)])
    assert (ys.mean(0) - y0).abs().mean() < 0.35 * (ys[0] - y0).abs().mean()
    leaves = [a.requires_grad_(True) for a in jax.tree.leaves(tp)]
    fwd(2, 0.4).abs().sum().backward()
    assert all(torch.isfinite(a.grad).all() for a in leaves)


_SPEC = dict(modality_set=("t", "a", "v"), orig_dimensions=(12, 10, 8), dimension=8,
             num_heads=2, head_dim=4, layers_single_attn=1, layers_cross_attn=1,
             layers_self_attn=1, attn_dropout=(0.1, 0.1, 0.0, 0.0), relu_dropout=0.1,
             res_dropout=0.1, out_dropout=0.1, embed_dropout=0.3, attn_mask=True,
             output_dim=1, header_overrides={"t": "rnn"})


@pytest.fixture(scope="module")
def supernet_case():
    """The port's random init, carried to the JAX package through the
    reference's names (the dead ``translation`` linears as zeros)."""
    js = jcfg.ModelSpec(**_SPEC, attn_impl="flash")
    ts = {impl: tcfg.ModelSpec(**_SPEC, attn_impl=impl) for impl in ("xla", "flash")}
    t_params, _ = tmult.init_supernet(torch.Generator().manual_seed(0), ts["flash"])
    sd = export_reference_state_dict(ts["flash"], t_params)
    d = _SPEC["dimension"]
    for s in js.cross_strings:
        sd[f"translation.translation{s}.weight"] = np.zeros((d, d), np.float32)
        sd[f"translation.translation{s}.bias"] = np.zeros(d, np.float32)
    rng = np.random.default_rng(5)
    inputs = [_np(rng, 3, 5, d) for d in _SPEC["orig_dimensions"]]
    cfgs = [jcfg.full_active_config(js),
            sample_train_config(js, "random_sample", None, np.random.default_rng(6))]
    return dict(js=js, ts=ts, params=import_torch_state_dict(js, sd), t_params=t_params,
                inputs=inputs, cfgs=cfgs)


@pytest.mark.parametrize("cfg_idx", [0, 1])
def test_flash_supernet_matches_xla_and_jax(supernet_case, cfg_idx):
    """Every trunk stack is T==1 after the headers, so ``attn_impl="flash"``
    takes the T==1 path: bit for bit the ``"xla"`` model on the port, in
    eval and in train mode, and the JAX package's flash supernet to 1e-4."""
    c = supernet_case
    cfg = c["cfgs"][cfg_idx]
    t_masks = t_build_masks(c["ts"]["flash"], tcfg.ActiveConfig(**dataclasses.asdict(cfg)))
    t_in = [torch.from_numpy(a) for a in c["inputs"]]
    outs = {}
    for impl, spec in c["ts"].items():
        with torch.inference_mode():
            outs[impl] = [tmult.supernet_apply(spec, c["t_params"], t_masks, t_in),
                          tmult.supernet_apply(spec, c["t_params"], t_masks, t_in, train=True,
                                               generator=torch.Generator().manual_seed(0))]
    for a, b in zip(outs["flash"], outs["xla"]):
        assert torch.equal(a, b)
    ref = jax.jit(lambda p, m, x: j_apply(c["js"], p, m, x, train=False))(
        c["params"], j_build_masks(c["js"], cfg), [jnp.asarray(a) for a in c["inputs"]])
    np.testing.assert_allclose(outs["flash"][0].numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_flash_trainer_step_equals_xla(supernet_case):
    """``Trainer`` takes ``spec.attn_impl`` through unchanged: one step's
    loss and every gradient on the flash spec equal the xla spec's."""
    c = supernet_case
    cfg = c["cfgs"][1]
    rng = np.random.default_rng(7)
    t_in = [torch.from_numpy(a) for a in c["inputs"]]
    labels, valid = torch.from_numpy(_np(rng, 3, 1)), torch.ones(3)
    out = {}
    for impl, spec in c["ts"].items():
        tr = tloop.Trainer(spec, c["t_params"], {}, tloop.TrainHParams(
            batch_size=3, lr=1e-3, optim="Adam", criterion="L1Loss"), device="cpu")
        loss, grads = tr.loss_and_grads(
            tr.params, t_build_masks(spec, tcfg.ActiveConfig(**dataclasses.asdict(cfg))),
            t_in, labels, valid, torch.Generator().manual_seed(1))
        out[impl] = (float(loss), export_reference_state_dict(spec, grads))
    assert out["flash"][0] == out["xla"][0]
    for name, g in out["xla"][1].items():
        assert np.array_equal(out["flash"][1][name], g), name


def test_streaming_predictor_flash_serves_on_cpu():
    """``--attn_impl flash`` at the MOSEI serving configuration answers on the
    CPU and equals the ``"xla"`` predictor on the same weights bit for bit;
    a spec whose own ``attn_impl`` is flash serves too."""
    from multimodal_transformer_robustness_tpu_torch.cli.realtime import (
        StreamingPredictor, main)

    flash = main(["--features", "synthetic", "--attn_impl", "flash", "--device", "cpu"])
    assert flash.spec.attn_impl == "flash"
    xla = StreamingPredictor(device="cpu")
    rng = np.random.default_rng(8)
    request = flash.prepare("a short synthetic transcript".split(),
                            _np(rng, 1, 40, 768), _np(rng, 1, 24, 512))
    got = flash.forward(*request)
    assert np.isfinite(got) and got == xla.forward(*request)
    from multimodal_transformer_robustness_tpu_torch.models.bert import tiny_bert_config
    spec = tcfg.ModelSpec(**dict(_SPEC, orig_dimensions=(6, 10, 12), header_overrides=None),
                          attn_impl="flash")
    tiny = StreamingPredictor(spec=spec, bert_cfg=tiny_bert_config(), device="cpu")
    assert np.isfinite(tiny.predict("a tiny transcript".split(), _np(rng, 1, 5, 10),
                                    _np(rng, 1, 3, 12)))
