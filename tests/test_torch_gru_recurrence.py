"""The port's GRU recurrence (K7) and the public GRU ops built on it, against
the JAX package on the CPU.

On CPU tensors ``gru_recurrence`` runs the plain versions of K7f and K7b
under its autograd function; the JAX side runs ``gru_recurrence_pallas`` in
interpret mode, and its ``gru_forward`` / ``bigru_forward`` with
``RECURRENCE_IMPL = "pallas_interpret"``.  Inputs come from numpy seeds.
Tolerances are the JAX package's own for its kernel against the scan
(tests/test_gru.py): outputs 1e-5, gradients rtol 2e-4 and atol 2e-5
(float32 sums over T*N rows in another order, chained back through T steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_robustness_tpu.ops import gru as jgru
from multimodal_transformer_robustness_tpu.ops.gru_pallas import (_recurrence_bwd_impl,
                                                                   gru_recurrence_pallas)
from multimodal_transformer_robustness_tpu_torch.ops import gru as tgru
from multimodal_transformer_robustness_tpu_torch.ops import gru_cuda

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
NAMES = "gi_r gi_z gi_n wr wz wn br bz bn".split()


def _recurrence_inputs(rng, G, T, N, H):
    """Per-gate gates [G, T, N, H] and the gate views of [G, 3H, H] weights,
    as numpy arrays, the way the JAX package's own test builds them."""
    gi = rng.standard_normal((G, N, T, 3 * H)).astype(np.float32)
    gates = [np.ascontiguousarray(np.moveaxis(np.asarray(a), 1, 2))
             for a in jgru._gi_gates(jnp.asarray(gi), H)]
    w_hh = (rng.standard_normal((G, 3 * H, H)) * 0.3).astype(np.float32)
    b_hh = (rng.standard_normal((G, 3 * H)) * 0.1).astype(np.float32)
    views = [np.asarray(a) for a in jgru._gate_views(jnp.asarray(w_hh), jnp.asarray(b_hh))]
    return gates + views


def _torch_leaves(arrays):
    return [torch.from_numpy(np.array(a)).requires_grad_(True) for a in arrays]


@pytest.mark.parametrize("T", [7, 12])
def test_recurrence_matches_pallas_interpret(T):
    rng = np.random.default_rng(0)
    G, N, H = 3, 5, 12
    arrays = _recurrence_inputs(rng, G, T, N, H)
    tgt = rng.standard_normal((G, T, N, H)).astype(np.float32)

    hs_j = gru_recurrence_pallas(*map(jnp.asarray, arrays), True)
    grads_j = jax.grad(
        lambda *a: jnp.sum(jnp.sin(gru_recurrence_pallas(*a, True)) * tgt),
        argnums=tuple(range(9)))(*map(jnp.asarray, arrays))

    leaves = _torch_leaves(arrays)
    n0 = (gru_cuda.gru_recurrence_cuda.launches, gru_cuda.gru_recurrence_bwd_cuda.launches)
    hs = tgru.gru_recurrence(*leaves)
    grads = torch.autograd.grad((torch.sin(hs) * torch.from_numpy(tgt)).sum(), leaves)
    # the CPU path launches nothing
    assert (gru_cuda.gru_recurrence_cuda.launches,
            gru_cuda.gru_recurrence_bwd_cuda.launches) == n0
    np.testing.assert_allclose(hs.detach().numpy(), np.asarray(hs_j), **OUT_TOL)
    for name, a, b in zip(NAMES, grads, grads_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD_TOL)


def test_recurrence_bwd_plain_matches_autograd():
    """K7b's plain version (the TPU kernel's newest-first loop, r / z / n
    recomputed) against autograd through K7f's plain time loop."""
    rng = np.random.default_rng(1)
    leaves = _torch_leaves(_recurrence_inputs(rng, 2, 9, 4, 8))
    dhs = torch.from_numpy(rng.standard_normal((2, 9, 4, 8)).astype(np.float32))
    got = torch.autograd.grad(tgru.gru_recurrence(*leaves), leaves, dhs)
    ref = torch.autograd.grad(tgru.gru_recurrence_plain(*leaves), leaves, dhs)
    for name, a, b in zip(NAMES, got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=name)


def test_recurrence_bwd_plain_matches_pallas_interpret():
    """K7b's plain version against the JAX kernel's backward itself
    (``_recurrence_bwd_impl``, interpret mode) on the four gate gradients,
    the same hs and cotangent on both sides: the same newest-first loop,
    float32 sums in another order."""
    rng = np.random.default_rng(5)
    G, T, N, H = 2, 7, 5, 12
    arrays = _recurrence_inputs(rng, G, T, N, H)
    hs = np.asarray(gru_recurrence_pallas(*map(jnp.asarray, arrays), True))
    dhs = rng.standard_normal((G, T, N, H)).astype(np.float32)
    operands = [*arrays[:3], hs, dhs, *arrays[3:]]
    want = _recurrence_bwd_impl(*map(jnp.asarray, operands), interpret=True)
    got = gru_cuda.gru_recurrence_bwd_plain(*(torch.from_numpy(np.array(a)) for a in operands))
    for name, a, b in zip(("da_r", "da_z", "da_n", "dghn"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_group_axis_is_independent():
    """Each g of the grouped call equals that recurrence run alone, values
    and gradients."""
    rng = np.random.default_rng(2)
    arrays = _recurrence_inputs(rng, 3, 6, 4, 8)
    tgt = torch.from_numpy(rng.standard_normal((3, 6, 4, 8)).astype(np.float32))
    leaves = _torch_leaves(arrays)
    hs = tgru.gru_recurrence(*leaves)
    grads = torch.autograd.grad((torch.sin(hs) * tgt).sum(), leaves)
    for g in range(3):
        one = _torch_leaves([a[g:g + 1] for a in arrays])
        hs_g = tgru.gru_recurrence(*one)
        grads_g = torch.autograd.grad((torch.sin(hs_g) * tgt[g:g + 1]).sum(), one)
        torch.testing.assert_close(hs_g[0], hs[g], rtol=0, atol=0)
        for name, a, b in zip(NAMES, grads_g, grads):
            torch.testing.assert_close(a[0], b[g], rtol=1e-6, atol=1e-7, msg=name)


def _gru_params(rng, in_dim, H):
    k = 1.0 / np.sqrt(H)
    shapes = {"w_ih": (3 * H, in_dim), "w_hh": (3 * H, H), "b_ih": (3 * H,), "b_hh": (3 * H,)}
    return {n: rng.uniform(-k, k, s).astype(np.float32) for n, s in shapes.items()}


def _op_loss_grads_jax(fn, params, x, tgt_out, tgt_fin):
    def loss(p, xx):
        out, fin = fn(p, xx)
        return jnp.sum(jnp.sin(out) * tgt_out) + jnp.sum(fin * tgt_fin)

    p = jax.tree_util.tree_map(jnp.asarray, params)
    return fn(p, jnp.asarray(x)), jax.grad(loss, argnums=(0, 1))(p, jnp.asarray(x))


def _op_loss_grads_torch(fn, params, x, tgt_out, tgt_fin):
    p = jax.tree_util.tree_map(lambda a: torch.from_numpy(a).requires_grad_(True), params)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, fin = fn(p, xt)
    loss = ((torch.sin(out) * torch.from_numpy(tgt_out)).sum()
            + (fin * torch.from_numpy(tgt_fin)).sum())
    leaves, treedef = jax.tree_util.tree_flatten(p)
    grads = torch.autograd.grad(loss, leaves + [xt])
    return (out, fin), (jax.tree_util.tree_unflatten(treedef, list(grads[:-1])), grads[-1])


def _assert_op_matches(fn_j, fn_t, params, x, out_width, rng):
    B, T = x.shape[:2]
    tgt_out = rng.standard_normal((B, T, out_width)).astype(np.float32)
    tgt_fin = rng.standard_normal((B, out_width)).astype(np.float32)
    (out_j, fin_j), (gp_j, gx_j) = _op_loss_grads_jax(fn_j, params, x, tgt_out, tgt_fin)
    (out_t, fin_t), (gp_t, gx_t) = _op_loss_grads_torch(fn_t, params, x, tgt_out, tgt_fin)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), **OUT_TOL)
    np.testing.assert_allclose(fin_t.detach().numpy(), np.asarray(fin_j), **OUT_TOL)
    np.testing.assert_allclose(gx_t.numpy(), np.asarray(gx_j), err_msg="x", **GRAD_TOL)
    for path, leaf_j in jax.tree_util.tree_leaves_with_path(gp_j):
        leaf_t = gp_t
        for key in path:
            leaf_t = leaf_t[key.key]
        np.testing.assert_allclose(leaf_t.numpy(), np.asarray(leaf_j),
                                   err_msg=jax.tree_util.keystr(path), **GRAD_TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_forward_matches_jax(monkeypatch, reverse):
    monkeypatch.setattr(jgru, "RECURRENCE_IMPL", "pallas_interpret")
    rng = np.random.default_rng(3)
    B, T, I, H = 3, 7, 5, 6
    params = _gru_params(rng, I, H)
    x = rng.standard_normal((B, T, I)).astype(np.float32)
    _assert_op_matches(lambda p, xx: jgru.gru_forward(p, xx, reverse),
                       lambda p, xx: tgru.gru_forward(p, xx, reverse), params, x, H, rng)


def test_bigru_forward_matches_jax(monkeypatch):
    monkeypatch.setattr(jgru, "RECURRENCE_IMPL", "pallas_interpret")
    rng = np.random.default_rng(4)
    B, T, I, H = 2, 9, 6, 5
    params = {d: _gru_params(rng, I, H) for d in ("fwd", "bwd")}
    x = rng.standard_normal((B, T, I)).astype(np.float32)
    _assert_op_matches(jgru.bigru_forward, tgru.bigru_forward, params, x, 2 * H, rng)
