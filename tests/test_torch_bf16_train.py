"""One training step under the bf16 compute policy against the JAX
package's, on the CPU: the loss and every gradient, on
``tests/_torch_pair.py``'s bf16 parity model (text and audio, one layer a
stack, a tiny BERT at width 128), a sampled configuration, L1 with a
padded row, dropout off.

The JAX side runs its Pallas kernels in interpret mode (the GRU backward
included) under ``jax.jit``, as its Trainer runs a step, with XLA's excess
precision off (``_torch_pair.exact_jit``: every bf16 result rounded where
the program rounds it, as the port rounds it); the port its bf16 plain
versions through autograd.  The master parameters are float32 on
both sides, so the gradients must come back float32.  Tolerances: the
loss within 1e-2 relative, and the gradients as one vector with a cosine
of at least 0.999 against JAX's (the JAX policy's own bound against
float32 is a cosine of 0.99, tests/test_bf16_policy.py).
"""

import numpy as np

from _torch_pair import bf16_build, bf16_port, bf16_train_step_pair, no_cross_quirk, \
    use_pallas_interpret

LOSS_TOL = 1e-2
GRAD_COS = 0.999


def test_train_step_bf16_matches_jax(monkeypatch):
    use_pallas_interpret(monkeypatch)
    with no_cross_quirk():
        c = bf16_build()
        t_loss, j_loss, ours, theirs = bf16_train_step_pair(c, c["frozen"], bf16_port(c)[1])
    check_step(t_loss, j_loss, ours, theirs)


def check_step(t_loss, j_loss, ours, theirs):
    """The loss within LOSS_TOL relative, every gradient float32, and the
    gradients as one vector at a cosine of GRAD_COS."""
    rel = abs(float(t_loss) - float(j_loss)) / abs(float(j_loss))
    print(f"loss {float(t_loss):.6f} vs {float(j_loss):.6f}: rel {rel:.3e}")
    assert rel <= LOSS_TOL
    assert sorted(ours) == sorted(theirs)
    assert all(v.dtype == np.float32 for v in theirs.values())
    assert all(v.dtype == np.float32 for v in ours.values())
    a = np.concatenate([ours[k].ravel() for k in sorted(ours)]).astype(np.float64)
    r = np.concatenate([theirs[k].ravel() for k in sorted(ours)]).astype(np.float64)
    cos = float(a @ r / (np.linalg.norm(a) * np.linalg.norm(r)))
    print(f"gradient cosine {cos:.6f}")
    assert cos >= GRAD_COS
