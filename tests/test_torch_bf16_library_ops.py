"""The library ops whose kernels are K7, K8 and K9 at bf16, against the JAX
package on the CPU: ``ops.gru.gru_recurrence`` / ``gru_forward`` /
``bigru_forward`` (K7f, K7b), ``attention_cuda.flash_attention_masked``
(K8) and ``trunk_block_cuda.fused_residual_block`` (K9f, K9b).

On CPU tensors the port runs the kernels' bf16 plain versions; the JAX side
runs its Pallas kernels in interpret mode at bf16 operands, compiled with
XLA's excess precision off (``_torch_pair.exact_jit``), so that a bf16
result is rounded where the program rounds it.  Both sides get the same
numpy-seeded float32 operands rounded to bf16 (the same bits).  Tolerance:
every output and gradient within 2e-2 of its max |JAX| (1e-2 for K8, about
one bf16 step at the top), as the card's bf16 rows are held; a float32 sum
in another order may land across a bf16 rounding edge, and the recurrence
carries such a step on.  The K7 tests also pin where the JAX kernel rounds:
the recurrent product takes the unrounded float32 carry, the backward
recomputes from the rounded stored hs, and dW is summed in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_robustness_tpu.ops import attention_pallas as jap
from multimodal_transformer_robustness_tpu.ops import gru as jgru
from multimodal_transformer_robustness_tpu.ops import trunk_block_pallas as jtb
from multimodal_transformer_robustness_tpu.ops.gru_pallas import (_recurrence_bwd_impl,
                                                                   gru_recurrence_pallas)
from multimodal_transformer_robustness_tpu_torch.ops import attention_cuda as tac
from multimodal_transformer_robustness_tpu_torch.ops import gru as tgru
from multimodal_transformer_robustness_tpu_torch.ops import gru_cuda
from multimodal_transformer_robustness_tpu_torch.ops import trunk_block_cuda as ttb

from _torch_pair import exact_jit

TOL, K8_TOL = 2e-2, 1e-2
BF = torch.bfloat16
NAMES = "gi_r gi_z gi_n wr wz wn br bz bn".split()


def _pair(a: np.ndarray, bf16: bool = True):
    """One float32 array in both packages, as bf16 (the same bits) or as it is."""
    if not bf16:
        return jnp.asarray(a), torch.from_numpy(a)
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(BF)


def _np(a) -> np.ndarray:
    return (a.detach().float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(jnp.asarray(a, jnp.float32)))


def _held(ours, theirs, what: str, tol: float = TOL) -> float:
    """``ours`` within ``tol`` of max |theirs|, in the same dtype; returns
    the share of elements that are bit-equal."""
    assert str(ours.dtype).split(".")[-1] == str(theirs.dtype), what
    a, r = _np(ours), _np(theirs)
    assert a.shape == r.shape, what
    err, scale, same = float(np.abs(a - r).max()), float(np.abs(r).max()), float(np.mean(a == r))
    print(f"{what}: max |d| {err:.3e} of max |ref| {scale:.3e}, {same:.2%} bit-equal")
    assert err <= tol * scale, what
    return same


# ---------------------------------------------------------------- K7


def _recurrence_inputs(rng, G, T, N, H):
    """float32 numpy gates [G, T, N, H] and gate views of [G, 3H, H]
    weights, as tests/test_torch_gru_recurrence.py builds them."""
    gi = rng.standard_normal((G, N, T, 3 * H)).astype(np.float32)
    gates = [np.ascontiguousarray(np.moveaxis(np.asarray(a), 1, 2))
             for a in jgru._gi_gates(jnp.asarray(gi), H)]
    w_hh = (rng.standard_normal((G, 3 * H, H)) * 0.3).astype(np.float32)
    b_hh = (rng.standard_normal((G, 3 * H)) * 0.1).astype(np.float32)
    views = [np.ascontiguousarray(np.asarray(a))
             for a in jgru._gate_views(jnp.asarray(w_hh), jnp.asarray(b_hh))]
    return gates + views


def _jax_recurrence(jargs, jdhs):
    """hs and the nine gradients of the JAX kernel (interpret mode) at bf16."""
    def fn(args, ct):
        hs, vjp = jax.vjp(lambda *a: gru_recurrence_pallas(*a, True), *args)
        return hs, vjp(ct)

    with exact_jit():
        run = jax.jit(fn)
    return run(tuple(jargs), jdhs)


def _rounded_h_forward(gi_r, gi_z, gi_n, wr, wz, wn, br, bz, bn):
    """K1f.bf16's rule applied to K7: h rounded to bf16 before the
    recurrent product (what K7's JAX kernel does not do)."""
    f = [a.float() for a in (gi_r, gi_z, gi_n, wr, wz, wn, br, bz, bn)]
    gi_r, gi_z, gi_n, wr, wz, wn, br, bz, bn = f
    h = torch.zeros_like(gi_r[:, 0])
    out = []
    for t in range(gi_r.shape[1]):
        hc = h.to(BF).float()
        r = torch.sigmoid(gi_r[:, t] + torch.matmul(hc, wr) + br[:, None])
        z = torch.sigmoid(gi_z[:, t] + torch.matmul(hc, wz) + bz[:, None])
        n = torch.tanh(gi_n[:, t] + r * (torch.matmul(hc, wn) + bn[:, None]))
        h = (1.0 - z) * n + z * h
        out.append(h.to(BF))
    return torch.stack(out, dim=1)


def test_k7_bf16_matches_pallas_and_pins_its_rounding():
    """K7f / K7b's bf16 plain versions under ``gru_recurrence``'s autograd
    function against ``gru_recurrence_pallas(interpret=True)`` at bf16: hs
    and the gradients of all nine arguments.  hs is nearly all bit-equal,
    and rounding h before the product (K1f.bf16's rule) is not: the product
    takes the float32 carry."""
    rng = np.random.default_rng(0)
    G, T, N, H = 2, 12, 8, 16
    pairs = [_pair(a) for a in _recurrence_inputs(rng, G, T, N, H)]
    jdhs, dhs = _pair(rng.standard_normal((G, T, N, H)).astype(np.float32))
    j_hs, j_grads = _jax_recurrence([p[0] for p in pairs], jdhs)
    assert j_hs.dtype == jnp.bfloat16

    leaves = [p[1].clone().requires_grad_(True) for p in pairs]
    n0 = gru_cuda.gru_recurrence_cuda.launches_bf16
    hs = tgru.gru_recurrence(*leaves)
    grads = torch.autograd.grad(hs, leaves, dhs)
    assert gru_cuda.gru_recurrence_cuda.launches_bf16 == n0   # the CPU launches nothing
    same = _held(hs, j_hs, "hs")
    assert same >= 0.99
    for name, a, r in zip(NAMES, grads, j_grads):
        _held(a, r, f"d{name}")

    other = _rounded_h_forward(*(p[1] for p in pairs))
    assert float((other.float() != torch.from_numpy(_np(j_hs))).float().mean()) > 0.05


def test_k7b_bf16_recomputes_from_the_rounded_hs():
    """K7b's plain version against ``_recurrence_bwd_impl(interpret=True)``
    on the same bf16 hs and dhs: da_r, da_z, da_n and dghn, nearly all
    bit-equal.  Given a hs that differs from the forward's by one bf16 step
    in places, both recompute from what they are given."""
    rng = np.random.default_rng(1)
    G, T, N, H = 2, 9, 4, 16
    pairs = [_pair(a) for a in _recurrence_inputs(rng, G, T, N, H)]
    jargs, targs = [p[0] for p in pairs], [p[1] for p in pairs]
    hs32 = rng.uniform(-0.9, 0.9, (G, T, N, H)).astype(np.float32)
    (jhs, hs), (jdhs, dhs) = _pair(hs32), _pair(rng.standard_normal((G, T, N, H)).astype(
        np.float32))
    with exact_jit():
        run = jax.jit(lambda a, h, d: _recurrence_bwd_impl(*a[:3], h, d, *a[3:],
                                                           interpret=True))
    ref = run(tuple(jargs), jhs, jdhs)
    got = gru_cuda.gru_recurrence_bwd_plain(*targs[:3], hs, dhs, *targs[3:])
    for name, a, r in zip(("da_r", "da_z", "da_n", "dghn"), got, ref):
        assert _held(a, r, name) >= 0.99


def test_k7_weight_grads_sum_in_float32():
    """dW = sum over t and n of h_{t-1}^T da from bf16 hs and da, summed in
    float32 and rounded once (the JAX VJP's float32 einsum), not the sum of
    bf16-rounded per-step products: against a float64 sum of the same bf16
    values, at most one bf16 step off."""
    rng = np.random.default_rng(2)
    G, T, N, H = 2, 40, 64, 8
    hs, da_r, da_z, dghn = (torch.from_numpy(rng.standard_normal((G, T, N, H)).astype(
        np.float32)).to(BF) for _ in range(4))
    got = gru_cuda.weight_grads(hs, da_r, da_z, dghn)
    assert all(g.dtype == BF for g in got)
    exact = torch.einsum("gtnh,gtnk->ghk", hs[:, :-1].double(), da_r[:, 1:].double())
    step = exact.abs() * 2.0 ** -8
    assert bool(((got[0].double() - exact).abs() <= step + 1e-30).all())
    per_step = torch.matmul(hs[:, :-1].transpose(-1, -2), da_r[:, 1:])   # bf16 products
    summed_in_bf16 = per_step[:, 0]
    for t in range(1, T - 1):
        summed_in_bf16 = summed_in_bf16 + per_step[:, t]
    assert float((summed_in_bf16.double() - exact).abs().max()) > float(
        (got[0].double() - exact).abs().max())
    torch.testing.assert_close(got[3].float(), da_r.float().sum(dim=(1, 2)).to(BF).float(),
                               rtol=0, atol=0)


@pytest.mark.parametrize("op", ["gru_forward", "gru_forward_reverse", "bigru_forward"])
def test_gru_ops_bf16_match_jax(monkeypatch, op):
    """``gru_forward`` (both directions) and ``bigru_forward`` at bf16
    parameters and input against the JAX package's with
    ``RECURRENCE_IMPL = "pallas_interpret"``: the outputs, the final hidden
    state and the gradients of x and every weight."""
    monkeypatch.setattr(jgru, "RECURRENCE_IMPL", "pallas_interpret")
    rng = np.random.default_rng(3)
    B, T, I, H = 3, 7, 6, 8
    k = 1.0 / np.sqrt(H)
    shapes = {"w_ih": (3 * H, I), "w_hh": (3 * H, H), "b_ih": (3 * H,), "b_hh": (3 * H,)}
    dirs = ("fwd", "bwd") if op == "bigru_forward" else ("fwd",)
    raw = {d: {n: rng.uniform(-k, k, s).astype(np.float32) for n, s in shapes.items()}
           for d in dirs}
    jx, x = _pair(rng.standard_normal((B, T, I)).astype(np.float32))
    width = H * len(dirs)
    (jc0, c0), (jc1, c1) = (_pair(rng.standard_normal(s).astype(np.float32))
                            for s in ((B, T, width), (B, width)))
    jp = {d: {n: _pair(a)[0] for n, a in w.items()} for d, w in raw.items()}
    tp = {d: {n: _pair(a)[1].requires_grad_(True) for n, a in w.items()} for d, w in raw.items()}
    reverse = op == "gru_forward_reverse"

    def j_fn(p, xx):
        return (jgru.bigru_forward(p, xx) if len(dirs) == 2
                else jgru.gru_forward(p["fwd"], xx, reverse=reverse))

    def j_grad(p, xx, a, b):
        (out, fin), vjp = jax.vjp(j_fn, p, xx)
        return out, fin, vjp((a, b))

    with exact_jit():
        run = jax.jit(j_grad)
    j_out, j_fin, (j_dp, j_dx) = run(jp, jx, jc0, jc1)

    xl = x.clone().requires_grad_(True)
    out, fin = (tgru.bigru_forward(tp, xl) if len(dirs) == 2
                else tgru.gru_forward(tp["fwd"], xl, reverse=reverse))
    leaves = [xl] + [tp[d][n] for d in dirs for n in shapes]
    grads = torch.autograd.grad(((out.float() * c0.float()).sum()
                                 + (fin.float() * c1.float()).sum()), leaves)
    _held(out, j_out, f"{op} out")
    _held(fin, j_fin, f"{op} final")
    _held(grads[0], j_dx, f"{op} dx")
    for (d, n), g in zip([(d, n) for d in dirs for n in shapes], grads[1:]):
        _held(g, j_dp[d][n], f"{op} d{d}.{n}")


# ---------------------------------------------------------------- K8


def test_k8_bf16_matches_pallas():
    """``flash_attention_masked`` at bf16 q / k / v against the JAX kernel
    in interpret mode: ragged key masks, one all-zero row (attends to every
    key), Tk = 20 not a multiple of the kernel's 8-key blocks; the output
    rounded once, p kept in float32 through P V."""
    rng = np.random.default_rng(4)
    B, H, Tq, Tk, D = 3, 2, 9, 20, 16
    (jq, q), (jk, k), (jv, v) = (_pair(rng.standard_normal(s).astype(np.float32))
                                 for s in ((B, H, Tq, D), (B, H, Tk, D), (B, H, Tk, D)))
    mask = np.ones((B, Tk), np.int32)
    mask[0] = 0
    mask[1, 13:] = 0
    mask[2, 3:] = 0
    with exact_jit():
        ref = jax.jit(lambda a, b, c, m: jap.flash_attention_masked(
            a, b, c, m, blk_q=8, blk_k=8, interpret=True))(jq, jk, jv, jnp.asarray(mask))
    out = tac.flash_attention_masked(q, k, v, torch.from_numpy(mask))
    assert out.dtype == BF
    assert _held(out, ref, "K8 out", K8_TOL) >= 0.99
    # float32 p through P V: rounding p first (K6a.bf16's rule) moves the output
    km = tac._effective_key_mask(torch.from_numpy(mask))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = torch.where(km[:, None, None, :] > 0, s, torch.full((), tac.NEG_INF))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p16 = (e / e.sum(-1, keepdim=True)).to(BF).float()
    other = torch.einsum("bhqk,bhkd->bhqd", p16, v.float()).to(BF)
    assert float((other != out).float().mean()) > 0.05


# ---------------------------------------------------------------- K9


def _block_operands(rng, R, E, F1):
    """float32 numpy x, src, dout, the six parameters and masks (a channel
    mask keeping 3 of 4 slabs, an F1 mask dropping a quarter)."""
    bound = np.sqrt(6.0 / (E + F1))
    x, src, dout = (rng.standard_normal((R, E)).astype(np.float32) for _ in range(3))
    params = [rng.uniform(-bound, bound, (F1, E)), 0.1 * rng.standard_normal(F1),
              rng.uniform(-bound, bound, (E, F1)), 0.1 * rng.standard_normal(E),
              1 + 0.1 * rng.standard_normal(E), 0.1 * rng.standard_normal(E)]
    masks = [(np.arange(E) < 3 * E // 4), (np.arange(F1) % 4 != 3), (np.arange(E) < 3 * E // 4)]
    return x, src, dout, [p.astype(np.float32) for p in params], [m.astype(np.float32)
                                                                   for m in masks]


@pytest.mark.parametrize("act,params_bf16", [("id", False), ("relu", False), ("relu", True)])
def test_k9_bf16_matches_pallas(act, params_bf16):
    """``fused_residual_block`` at bf16 x and src (cross mode, so their
    gradients stand apart), float32 or bf16 parameters, masked, both
    dropouts on, against ``trunk_block_pallas.fused_residual_block(
    interpret=True)``: the output and the gradients of x, src and all six
    parameters, each in its own dtype."""
    rng = np.random.default_rng(5)
    R, E, F1, rep = 10, 24, 32, 8 if act == "id" else 1
    x, src, dout, params, masks = _block_operands(rng, R, E, F1)
    (jx, tx), (js, ts), (jd, td) = (_pair(a) for a in (x, src, dout))
    pp = [_pair(p, params_bf16) for p in params]
    kw = dict(act=act, mid_rep=rep, rate_mid=0.2, rate_res=0.3, seed_mid=11, seed_res=-7,
              use_drop_mid=True, use_drop_res=True)

    def j_fn(xx, ss, *p):
        return jtb.fused_residual_block(xx, ss, *p, *map(jnp.asarray, masks), interpret=True,
                                        block_rows=8, **kw)

    def j_grad(xx, ss, p, ct):
        out, vjp = jax.vjp(j_fn, xx, ss, *p)
        return out, vjp(ct)

    with exact_jit():
        run = jax.jit(j_grad)
    j_out, j_grads = run(jx, js, tuple(p[0] for p in pp), jd)

    leaves = [tx.clone().requires_grad_(True), ts.clone().requires_grad_(True)] + [
        p[1].clone().requires_grad_(True) for p in pp]
    n0 = (ttb.trunk_block_fwd.launches_bf16, ttb.trunk_block_bwd.launches_bf16)
    out = ttb.fused_residual_block(*leaves, *map(torch.from_numpy, masks), **kw)
    grads = torch.autograd.grad(out, leaves, td)
    assert (ttb.trunk_block_fwd.launches_bf16, ttb.trunk_block_bwd.launches_bf16) == n0
    _held(out, j_out, f"{act} out")
    for name, a, r in zip("x src w1 b1 w2 b2 ln_g ln_b".split(), grads, j_grads):
        _held(a, r, f"{act} d{name}")


def test_k9_bf16_self_mode_sums_both_paths():
    """``src=x`` at bf16: autograd adds dout (dx) and dsrc into x's
    gradient, in bf16, as the JAX custom VJP's two cotangents are added."""
    rng = np.random.default_rng(6)
    x, _, dout, params, masks = _block_operands(rng, 6, 16, 8)
    tx, td = (torch.from_numpy(a).to(BF) for a in (x, dout))
    tp = [torch.from_numpy(p) for p in params]
    kw = dict(act="relu", rate_mid=0.1, seed_mid=3, use_drop_mid=True)
    xs = tx.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(ttb.fused_residual_block(xs, xs, *tp, *map(
        torch.from_numpy, masks), **kw), xs, td)
    xa, xb = (tx.clone().requires_grad_(True) for _ in range(2))
    ga, gb = torch.autograd.grad(ttb.fused_residual_block(xa, xb, *tp, *map(
        torch.from_numpy, masks), **kw), (xa, xb), td)
    assert g.dtype == BF and torch.equal(ga, td)
    assert torch.equal(g, ga + gb)
