"""K1b: the port's GRU backward against the JAX package's Pallas VJP.

On the CPU ``GruDir``'s backward is its plain version (``torch.autograd.grad``
through the plain time loop); it is held to ``jax.vjp`` of
``bigru_level_tmajor(..., interpret=True)``, whose custom VJP runs the TPU
backward kernel in interpret mode: values, all four parameter gradients of
both directions and, when ``need_dx``, the input gradient, at
atol = rtol = 1e-5 in float32 (JAX precision "highest", pinned by
conftest.py).  The CUDA kernel is held to the plain version on the card by
tests/test_torch_kernels_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_robustness_tpu.ops import bigru_pallas
from multimodal_transformer_robustness_tpu_torch.ops import bigru_cuda
from test_torch_kernels_ref import _gru_params

TOL = dict(atol=1e-5, rtol=1e-5)


def _port_level(tp, x_t, ct, need_dx):
    """Forward and backward of one port level -> (out, x grad, param grads)."""
    params = {d: {k: v.clone().requires_grad_(True) for k, v in w.items()}
              for d, w in tp.items()}
    x = torch.from_numpy(x_t).requires_grad_(need_dx)
    out = bigru_cuda.bigru_level_tmajor(params, x, need_dx=need_dx)
    out.backward(torch.from_numpy(ct))
    return out.detach(), x.grad, {d: {k: v.grad for k, v in w.items()}
                                  for d, w in params.items()}


@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("B,T,I,H", [(3, 11, 7, 12), (1, 5, 16, 8), (5, 9, 24, 16)])
def test_gru_backward_matches_pallas_vjp(B, T, I, H, need_dx):
    """Both directions, T not a multiple of 8, odd B."""
    rng = np.random.default_rng(1)
    jp, tp = _gru_params(1, I, H)
    x_t = rng.standard_normal((T, B, I)).astype(np.float32)
    ct = rng.standard_normal((T, B, 2 * H)).astype(np.float32)
    seen = []
    orig = bigru_pallas._bwd_impl

    def spy(*a, **k):
        seen.append(k.get("need_dx"))
        return orig(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bigru_pallas, "_bwd_impl", spy)
        ref, vjp = jax.vjp(lambda p, x: bigru_pallas.bigru_level_tmajor(
            p, x, interpret=True, need_dx=need_dx), jp, jnp.asarray(x_t))
        gp, gx = vjp(jnp.asarray(ct))
    assert len(seen) == 2                  # the TPU backward kernel ran, per direction

    n0 = bigru_cuda.gru_dir_bwd.launches
    out, x_grad, grads = _port_level(tp, x_t, ct, need_dx)
    assert bigru_cuda.gru_dir_bwd.launches == n0   # the CPU path launches nothing
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    for d in ("fwd", "bwd"):
        for k in ("w_ih", "w_hh", "b_ih", "b_hh"):
            np.testing.assert_allclose(grads[d][k].numpy(), np.asarray(gp[d][k]),
                                       err_msg=f"{d}.{k}", **TOL)
    if need_dx:
        np.testing.assert_allclose(x_grad.numpy(), np.asarray(gx), **TOL)
    else:
        assert x_grad is None


def test_need_dx_false_same_param_grads_and_guard():
    """``need_dx=False`` changes nothing but the input gradient; under an
    input that requires grad it raises instead of dropping that gradient."""
    rng = np.random.default_rng(2)
    _, tp = _gru_params(2, 10, 6)
    x_t = rng.standard_normal((7, 3, 10)).astype(np.float32)
    ct = rng.standard_normal((7, 3, 12)).astype(np.float32)
    _, _, with_dx = _port_level(tp, x_t, ct, True)
    _, _, without = _port_level(tp, x_t, ct, False)
    for d in ("fwd", "bwd"):
        for k in ("w_ih", "w_hh", "b_ih", "b_hh"):
            torch.testing.assert_close(without[d][k], with_dx[d][k], atol=0, rtol=0)
    with pytest.raises(ValueError, match="need_dx=False"):
        bigru_cuda.bigru_level_tmajor(tp, torch.from_numpy(x_t).requires_grad_(True),
                                      need_dx=False)


def test_gru_dir_bwd_plain_matches_autograd_function():
    """The plain backward called directly gives what ``GruDir`` gives, and
    ``None`` for dx without ``need_dx``."""
    rng = np.random.default_rng(3)
    _, tp = _gru_params(3, 5, 4)
    ops = bigru_cuda.dir_operands(tp["fwd"])
    args = [ops[k] for k in ("wp", "wt", "bc", "bhn")]
    x = torch.from_numpy(rng.standard_normal((6, 2, 5)).astype(np.float32))
    dhs = torch.from_numpy(rng.standard_normal((6, 2, 4)).astype(np.float32))
    leaves = [x.clone().requires_grad_(True)] + [a.clone().requires_grad_(True) for a in args]
    hs = bigru_cuda.GruDir.apply(*leaves, True, True)
    hs.backward(dhs)
    got = bigru_cuda.gru_dir_bwd_plain(x, *args, hs.detach(), None, dhs, True, True)
    for a, leaf in zip(got, leaves):
        torch.testing.assert_close(a, leaf.grad, atol=0, rtol=0)
    assert bigru_cuda.gru_dir_bwd_plain(x, *args, hs.detach(), None, dhs, True, False)[0] is None
