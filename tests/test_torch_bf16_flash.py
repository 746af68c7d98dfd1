"""The flash path at bf16 against the JAX package, on the CPU: the plain
versions of K5f, K5b, K5dq and K5dkv, the flash encoder stack and the
supernet under ``ModelSpec(compute_dtype="bfloat16", attn_impl="flash")``.

The same numpy-seeded float32 operands are rounded to bf16 on both sides
(the same bits).  The JAX side runs its Pallas kernels in interpret mode,
compiled with XLA's excess precision off (``_torch_pair.exact_jit``), so a
bf16 result is rounded where the program rounds it: the stored output that
the backward's delta reads, above all.  Tolerances: the flash outputs and
gradients are bf16, within 1e-2 of max |ref| (about one bf16 step at the
top) with at least 99% of their elements bit-equal; the log-sum-exp is
float32, within 1e-5.  The encoder stack's output and gradients within 2e-2
of max(max |ref|, 1e-2) (bf16 flips compound through the layers, as in the
bf16 slice); the supernet's predictions within 2e-2 of max(|ref|, 1e-2)
elementwise (``tests/test_torch_bf16_slice.py``'s bound).  Under the T==1
rule the port's flash supernet is the ``"xla"`` one, bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_robustness_tpu.models import supernet_apply as j_apply
from multimodal_transformer_robustness_tpu.ops import attention_pallas as jap
from multimodal_transformer_robustness_tpu.ops import encoder as jenc
from multimodal_transformer_robustness_tpu_torch.models import supernet_apply as t_apply
from multimodal_transformer_robustness_tpu_torch.models.mult import cast_tree
from multimodal_transformer_robustness_tpu_torch.ops import attention_cuda as tac
from multimodal_transformer_robustness_tpu_torch.ops import encoder as tenc
from multimodal_transformer_robustness_tpu_torch.train import loop as tloop
from multimodal_transformer_robustness_tpu_torch.weights import (
    export_reference_state_dict, load_encoder_stack)

from _torch_pair import (BF16_SPEC, bf16_batch, bf16_build, bf16_masks, bf16_port, exact_jit,
                         no_cross_quirk, use_pallas_interpret)

TOL, SAME, LSE_TOL, STACK_TOL = 1e-2, 0.99, 1e-5, 2e-2
BF = torch.bfloat16

# (b, h, tq, tk, d, causal, rate): tests/test_torch_flash.py's cases
_K5_CASES = {"self": (2, 2, 16, 16, 8, True, 0.0),
             "cross": (1, 2, 7, 20, 12, True, 0.0),
             "dropout": (2, 2, 12, 9, 25, True, 0.3),
             "unmasked_dropout": (1, 3, 10, 6, 8, False, 0.3)}


def _pair(a: np.ndarray):
    """One float32 array as bf16 in both packages (the same bits)."""
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(BF)


def _held(ours: torch.Tensor, theirs, what: str) -> None:
    """bf16 ``ours`` within TOL of max |theirs|, SAME of the elements equal."""
    assert ours.dtype == BF, what
    a, r = ours.float().numpy(), np.asarray(jnp.asarray(theirs, jnp.float32))
    assert a.shape == r.shape, what
    err, scale, same = float(np.abs(a - r).max()), float(np.abs(r).max()), float(np.mean(a == r))
    print(f"{what}: max |d| {err:.3e} of max |ref| {scale:.3e}, {same:.2%} bit-equal")
    assert err <= TOL * scale and same >= SAME, what


@pytest.mark.parametrize("case", list(_K5_CASES))
def test_flash_bf16_plain_matches_pallas(case):
    """K5's plain versions at bf16 against JAX ``flash_attention(interpret=
    True)``: out and the gradients through ``flash_attention``'s backward
    (K5b's plain version: delta from the rounded out), lse, and path 1's
    ``flash_bwd_dq`` / ``flash_bwd_dkv`` given lse and the float32 delta,
    which compute the same bits."""
    b, h, tq, tk, d, causal, rate = _K5_CASES[case]
    rng = np.random.default_rng(0)
    f32 = [rng.standard_normal(s).astype(np.float32)
           for s in ((b, h, tq, d), (b, h, tk, d), (b, h, tk, d), (b, h, tq, d))]
    (jq, q), (jk, k), (jv, v), (jdo, do) = (_pair(a) for a in f32)
    offset, bh = 1 + abs(tk - tq), b * h
    seeds = rng.integers(-2**31, 2**31 - 1, bh).astype(np.int32)
    rates = np.full(bh, rate, np.float32)
    t_seeds, t_rates = (torch.from_numpy(seeds), torch.from_numpy(rates)) if rate else (None,
                                                                                        None)

    def j_fn(q_, k_, v_, do_, s_, r_):
        kw = dict(dropout_seeds=s_, dropout_rates=r_) if rate else {}
        out, vjp = jax.vjp(lambda a, b_, c: jap.flash_attention(
            a, b_, c, causal=causal, offset=offset, interpret=True, **kw), q_, k_, v_)
        _, lse = jap._flash_fwd_impl(q_, k_, v_, s_, r_, causal, offset, 256, 512, bool(rate),
                                     True)
        return out, vjp(do_), lse

    with exact_jit():
        run = jax.jit(j_fn)
    j_out, j_grads, j_lse = run(jq, jk, jv, jdo, jnp.asarray(seeds), jnp.asarray(rates))
    assert j_out.dtype == jnp.bfloat16 and all(g.dtype == jnp.bfloat16 for g in j_grads)

    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tac.flash_attention(*leaves, causal, offset, t_seeds, t_rates)
    out.backward(do)
    _held(out.detach(), j_out, f"{case} out")
    for name, a, r in zip(("dq", "dk", "dv"), leaves, j_grads):
        _held(a.grad, r, f"{case} {name}")

    fwd_out, lse = tac.flash_fwd(q, k, v, t_seeds, t_rates, causal, offset)
    assert torch.equal(fwd_out, out.detach()) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[:, 0, :tq], atol=LSE_TOL, rtol=0)
    delta = tac._delta(do, fwd_out)
    args = (q, k, v, do, lse, delta, t_seeds, t_rates, causal, offset)
    pair = (tac.flash_bwd_dq(*args),) + tac.flash_bwd_dkv(*args)
    for a, leaf in zip(pair, leaves):
        assert a.dtype == BF and torch.equal(a, leaf.grad)


def test_delta_op_sums_in_float32():
    """The backward's delta op (``flash_bwd``'s path 1 and K5b's plain
    version) multiplies and sums bf16 dout and out in float32, as the JAX
    package does (``attention_pallas_bwd.py``: ``do.astype(f32) *
    out.astype(f32)``), not in bf16."""
    rng = np.random.default_rng(1)
    (jdo, do), (jout, out) = (_pair(rng.standard_normal((2, 3, 7, 25)).astype(np.float32))
                              for _ in range(2))
    with exact_jit():
        ref = jax.jit(lambda a, b: jnp.sum(a.astype(jnp.float32) * b.astype(jnp.float32),
                                           axis=-1))(jdo, jout)
    got = tac._delta(do, out)
    assert got.dtype == torch.float32 and got.shape == (6, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).reshape(6, 7), atol=1e-6, rtol=1e-6)
    in_bf16 = (do * out).sum(-1).float().reshape(6, 7).numpy()
    assert np.abs(in_bf16 - np.asarray(ref).reshape(6, 7)).max() > 1e-3


def _stack(rng, E=16, H=2, Dh=8, L=2):
    """A 2-layer stack: JAX ``init_encoder`` weights plus noise, elastic
    masks that gate a layer, a head dim and FFN columns."""
    hp = dict(embed_dim_in=E, num_heads=H, head_dim=Dh, layers=L, attn_mask=True)
    params = jenc.init_encoder(jax.random.PRNGKey(7), jenc.EncoderHParams(**hp))
    params = jax.tree.map(lambda a: a + 0.05 * jnp.asarray(
        rng.standard_normal(a.shape), jnp.float32), params)
    masks = [np.ones(L, np.float32), np.array([1, 0], np.float32),
             (np.arange(Dh) < 5).astype(np.float32),
             (np.arange(4 * H * Dh) < 20).astype(np.float32)]
    jm = jenc.EncoderMasks(*[jnp.asarray(a, jnp.bfloat16) for a in masks])
    tm = tenc.EncoderMasks(*[torch.from_numpy(a).to(BF) for a in masks])
    return hp, params, jm, tm


def _stack_close(ours: torch.Tensor, theirs, what: str) -> None:
    a = ours.detach().float().numpy()
    r = np.asarray(jnp.asarray(theirs, jnp.float32))
    assert a.shape == r.shape, what
    err, scale = float(np.abs(a - r).max()), max(float(np.abs(r).max()), 1e-2)
    print(f"{what}: max |d| {err:.3e} of {scale:.3e}, {np.mean(a == r):.2%} equal")
    assert err <= STACK_TOL * scale, what


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX attention reaches ``flash_attention`` through its module
    attribute: run that kernel in interpret mode."""
    monkeypatch.setattr(jap, "flash_attention",
                        functools.partial(jap.flash_attention, interpret=True))


def _j_bf16(tree):
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16), tree)


@pytest.mark.parametrize("mode", ["self", "cross"])
def test_flash_encoder_bf16_matches_jax(mode, pallas_interpret):
    """The stack under bf16 parameters, masks and inputs (the policy's
    boundary cast): the eval forward, then train mode with every rate 0
    (the JAX side through its in-kernel dropout at rate 0,
    ``flash_zero_rates=False``): the output and the float32 gradients of
    every float32 master parameter and input."""
    rng = np.random.default_rng(2)
    hp, params, jm, tm = _stack(rng)
    tq, tk = 12, (17 if mode == "cross" else None)
    x = rng.standard_normal((2, tq, 16)).astype(np.float32)
    kv = rng.standard_normal((2, tk, 16)).astype(np.float32) if tk else None
    ct = rng.standard_normal((2, tq, 16)).astype(np.float32)
    jhp = jenc.EncoderHParams(**hp, attn_impl="flash", flash_zero_rates=False)
    thp = tenc.EncoderHParams(**hp, attn_impl="flash")

    def j_loss(p, xx, kk, train):
        out = jenc.encoder_forward(_j_bf16(p), _j_bf16(xx), None if kk is None else _j_bf16(kk),
                                   hp=jhp, masks=jm, attn_rate=0.0, train=train,
                                   rng=jax.random.PRNGKey(0))
        return jnp.sum(out.astype(jnp.float32) * ct), out

    j_kv = None if kv is None else jnp.asarray(kv)
    argnums = (0, 1) if kv is None else (0, 1, 2)
    with exact_jit():
        j_eval = jax.jit(functools.partial(j_loss, train=False))
        j_step = jax.jit(jax.value_and_grad(functools.partial(j_loss, train=True),
                                            argnums=argnums, has_aux=True))
    _, ref_eval = j_eval(params, jnp.asarray(x), j_kv)
    (_, ref), grads = j_step(params, jnp.asarray(x), j_kv)
    assert ref.dtype == jnp.bfloat16

    tp = load_encoder_stack(params)
    leaves = [a.requires_grad_(True) for a in tloop.tree_leaves(tp)]
    tx = torch.from_numpy(x).requires_grad_(True)
    tkv = None if kv is None else torch.from_numpy(kv).requires_grad_(True)

    def t_fwd(train):
        return tenc.encoder_forward(cast_tree(tp, BF), tx.to(BF),
                                    None if tkv is None else tkv.to(BF), hp=thp, masks=tm,
                                    attn_rate=0.0, train=train,
                                    generator=torch.Generator().manual_seed(0))

    with torch.no_grad():
        _stack_close(t_fwd(False), ref_eval, f"{mode} eval")
    out = t_fwd(True)
    assert out.dtype == BF
    (out.float() * torch.from_numpy(ct)).sum().backward()
    _stack_close(out, ref, f"{mode} train out")
    j_leaves = tloop.tree_leaves(load_encoder_stack(grads[0]))
    assert len(j_leaves) == len(leaves)
    for i, (a, r) in enumerate(zip(leaves, j_leaves)):
        assert a.grad.dtype == torch.float32
        _stack_close(a.grad, r.numpy(), f"{mode} grad {i}")
    _stack_close(tx.grad, grads[1], f"{mode} dx")
    if tkv is not None:
        _stack_close(tkv.grad, grads[2], f"{mode} dkv")


@pytest.fixture(scope="module")
def supernet():
    return bf16_build(spec=dict(BF16_SPEC, attn_impl="flash"))


def test_supernet_bf16_flash_matches_jax_and_xla(supernet, monkeypatch):
    """``supernet_apply`` under ``compute_dtype="bfloat16", attn_impl=
    "flash"`` (no longer refused) against the JAX package's at the same
    spec, in eval mode on a sampled configuration; then the port's flash
    and xla specs bit for bit: every trunk stack is T==1 after the headers,
    so flash takes the T==1 rule (eval and train forward, one step's loss
    and float32 gradients)."""
    use_pallas_interpret(monkeypatch)
    c = supernet
    assert c["ts"].attn_impl == "flash" and c["ts"].compute_dtype == "bfloat16"
    jm, tm = bf16_masks(c, c["cfg"])
    inputs, labels, valid = bf16_batch(c)
    with exact_jit():
        run = jax.jit(lambda p, m, x: j_apply(c["js"], p, m, x, frozen=c["frozen"],
                                              bert_cfg=c["jb"]))
    with no_cross_quirk():
        ref = run(jax.tree.map(jnp.asarray, c["params_np"]), jm,
                  [jnp.asarray(inputs[0], jnp.int32)] + [jnp.asarray(x) for x in inputs[1:]])
    tp, tf = bf16_port(c)
    t_in = [torch.from_numpy(x) for x in inputs]
    outs, steps = {}, {}
    for impl in ("flash", "xla"):
        spec = dataclasses.replace(c["ts"], attn_impl=impl)
        with torch.no_grad():
            outs[impl] = [t_apply(spec, tp, tm, t_in, frozen=tf, bert_cfg=c["tb"]),
                          t_apply(spec, tp, tm, t_in, frozen=tf, bert_cfg=c["tb"], train=True,
                                  generator=torch.Generator().manual_seed(0))]
        tt = tloop.Trainer(spec, tp, tf, tloop.TrainHParams(batch_size=len(labels)),
                           bert_cfg=c["tb"], device="cpu")
        loss, grads = tt.loss_and_grads(tt.params, tm, t_in, torch.from_numpy(labels),
                                        torch.from_numpy(valid),
                                        torch.Generator().manual_seed(1))
        steps[impl] = (float(loss), export_reference_state_dict(spec, grads))
    for a, b in zip(outs["flash"], outs["xla"]):
        assert torch.equal(a, b)
    assert steps["flash"][0] == steps["xla"][0]
    for name, g in steps["xla"][1].items():
        assert np.array_equal(steps["flash"][1][name], g), name
    ours, theirs = outs["flash"][0].double().numpy(), np.asarray(ref, np.float64)
    rel = np.abs(ours - theirs) / np.maximum(np.abs(theirs), 1e-2)
    print(f"supernet bf16 flash: max rel {rel.max():.3e}")
    assert rel.max() <= STACK_TOL
