"""The port's fused residual block (K9) against the JAX package and against
the port's own T==1 encoder ops, on the CPU.

On CPU tensors ``fused_residual_block`` runs its plain version under its
autograd function (the backward is autograd through the plain forward).
The JAX side runs ``trunk_block_pallas.fused_residual_block`` in interpret
mode.  Both draw their dropout from the same position hash, so the same
integer seeds give the same masks and the comparison runs with dropout on.
Tolerances: against JAX, outputs and all eight gradients at rtol 1e-4 and
atol 1e-5, the JAX package's own for its kernel against its reference
(tests/test_trunk_block_pallas.py); against the encoder's op chain, with
dropout off, rtol 1e-5 and atol 1e-6, as the JAX package holds its kernel
to its own op chain there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_robustness_tpu.ops import trunk_block_pallas as jtb
from multimodal_transformer_robustness_tpu_torch.ops import (
    fused_residual_block, init_mha, masked_layer_norm, masked_linear, multihead_attention)
from multimodal_transformer_robustness_tpu_torch.ops import trunk_block_cuda
from multimodal_transformer_robustness_tpu_torch.ops.linear import init_linear

TOL = dict(rtol=1e-4, atol=1e-5)
OPS_TOL = dict(rtol=1e-5, atol=1e-6)
LEAVES = "x src w1 b1 w2 b2 ln_g ln_b".split()


def _prefix(n, k):
    m = np.zeros((n,), np.float32)
    m[:k] = 1.0
    return m


def _operands(rng, B, E, F):
    return dict(
        x=rng.standard_normal((B, E)), src=rng.standard_normal((B, E)),
        w1=rng.standard_normal((F, E)) * 0.1, b1=rng.standard_normal((F,)) * 0.1,
        w2=rng.standard_normal((E, F)) * 0.1, b2=rng.standard_normal((E,)) * 0.1,
        ln_g=1 + 0.1 * rng.standard_normal((E,)), ln_b=0.1 * rng.standard_normal((E,)))


@pytest.mark.parametrize("act,mid_rep", [("relu", 1), ("id", 4)])
@pytest.mark.parametrize("masked", [False, True])
def test_block_matches_pallas_interpret_with_dropout(act, mid_rep, masked):
    rng = np.random.default_rng(0)
    B, E, F = 13, 16, 24            # B not a multiple of any tile
    ops = {k: v.astype(np.float32) for k, v in _operands(rng, B, E, F).items()}
    masks = ([_prefix(E, 12), _prefix(F, 18), _prefix(E, 12)] if masked
             else [None, None, None])
    kw = dict(act=act, mid_rep=mid_rep, rate_mid=0.3, rate_res=0.2, seed_mid=123,
              seed_res=456, use_drop_mid=True, use_drop_res=True)

    def jax_block(*a):
        return jtb.fused_residual_block(*a, *masks, block_rows=8, interpret=True, **kw)

    args_j = [jnp.asarray(ops[k]) for k in LEAVES]
    out_j = jax_block(*args_j)
    grads_j = jax.grad(lambda *a: jnp.sum(jax_block(*a) ** 2),
                       argnums=tuple(range(8)))(*args_j)

    leaves = [torch.from_numpy(ops[k]).requires_grad_(True) for k in LEAVES]
    t_masks = [None if m is None else torch.from_numpy(m) for m in masks]
    n0 = (trunk_block_cuda.trunk_block_fwd.launches, trunk_block_cuda.trunk_block_bwd.launches)
    out = fused_residual_block(*leaves, *t_masks, **kw)
    grads = torch.autograd.grad((out ** 2).sum(), leaves)
    # the CPU path launches nothing
    assert (trunk_block_cuda.trunk_block_fwd.launches,
            trunk_block_cuda.trunk_block_bwd.launches) == n0
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    for name, a, b in zip(LEAVES, grads, grads_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)


def test_block_matches_encoder_t1_halves():
    """The attention (self, with a channel mask; cross, value stream as
    src) and FFN halves of a T==1 encoder layer against the op chain that
    ``ops/encoder._layer_forward`` runs, dropout off."""
    rng = np.random.default_rng(1)
    gen = torch.Generator().manual_seed(0)
    B, E, H, Dh = 12, 16, 2, 4
    F = 4 * H * Dh
    attn = init_mha(gen, E, H, Dh)
    fc1, fc2 = init_linear(gen, E, F), init_linear(gen, F, E)
    g = torch.from_numpy((1 + 0.1 * rng.standard_normal(E)).astype(np.float32))
    lb = torch.from_numpy((0.1 * rng.standard_normal(E)).astype(np.float32))
    cm = torch.from_numpy(_prefix(E, 12))
    hm, dm = torch.from_numpy(_prefix(H, 1)), torch.from_numpy(_prefix(Dh, 3))
    ffnm = torch.from_numpy(_prefix(F, 10))
    x3 = torch.from_numpy(rng.standard_normal((B, 1, E)).astype(np.float32)) * cm
    xv = torch.from_numpy(rng.standard_normal((B, 1, E)).astype(np.float32))
    w1 = attn["in_proj_w"][2].reshape(H * Dh, E)
    b1 = attn["in_proj_b"][2].reshape(H * Dh)
    w2 = attn["out_w"].reshape(E, H * Dh)
    b2 = attn["out_b"]
    m_mid = (hm[:, None] * dm[None, :]).reshape(H * Dh)
    att = dict(head_mask=hm, head_dim_mask=dm, attn_dropout=0.0, train=False)

    h = masked_layer_norm(x3, g, lb, cm)
    ref = x3 + multihead_attention(attn, h, h, h, channel_mask=cm, **att)
    out = fused_residual_block(x3, x3, w1, b1, w2, b2, g, lb, cm, m_mid, cm, act="id",
                               mid_rep=Dh)
    torch.testing.assert_close(out, ref, **OPS_TOL)

    hq = masked_layer_norm(x3, g, lb, None)
    kv = masked_layer_norm(xv, g, lb, None)
    ref_c = x3 + multihead_attention(attn, hq, kv, kv, channel_mask=None, **att)
    out_c = fused_residual_block(x3, xv, w1, b1, w2, b2, g, lb, None, m_mid, None,
                                 act="id", mid_rep=Dh)
    torch.testing.assert_close(out_c, ref_c, **OPS_TOL)

    h2 = masked_linear(masked_layer_norm(x3, g, lb, cm), fc1["w"], fc1["b"], mask_out=ffnm)
    h2 = masked_linear(torch.relu(h2), fc2["w"], fc2["b"], mask_out=cm)
    out_f = fused_residual_block(x3, x3, fc1["w"], fc1["b"], fc2["w"], fc2["b"], g, lb, cm,
                                 ffnm, cm, act="relu")
    torch.testing.assert_close(out_f, x3 + h2, **OPS_TOL)


def test_self_mode_sums_both_paths():
    """``src is x``: x's gradient is the residual path's plus the LN path's,
    as with x and src passed apart."""
    rng = np.random.default_rng(2)
    ops = {k: torch.from_numpy(v.astype(np.float32)) for k, v in
           _operands(rng, 7, 12, 20).items()}
    params = [ops[k] for k in LEAVES[2:]]
    kw = dict(act="relu", rate_mid=0.25, rate_res=0.1, seed_mid=-5, seed_res=2**31 - 1,
              use_drop_mid=True, use_drop_res=True)
    ct = torch.from_numpy(rng.standard_normal((7, 12)).astype(np.float32))

    x = ops["x"].clone().requires_grad_(True)
    (gx,) = torch.autograd.grad((fused_residual_block(x, x, *params, **kw) * ct).sum(), x)
    xa, xb = (ops["x"].clone().requires_grad_(True) for _ in range(2))
    ga, gb = torch.autograd.grad((fused_residual_block(xa, xb, *params, **kw) * ct).sum(),
                                 (xa, xb))
    torch.testing.assert_close(ga, ct)             # dx = dout
    torch.testing.assert_close(gx, ga + gb, rtol=0, atol=0)


def test_block_refuses_other_dtypes():
    x = torch.zeros(2, 4, dtype=torch.float64)
    w = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="float32"):
        fused_residual_block(x, x, w, w[0], w, w[0], w[0], w[0])
