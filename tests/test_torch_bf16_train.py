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

import jax
import jax.numpy as jnp
import numpy as np
import torch

from multimodal_transformer_robustness_tpu.checkpoint import export_torch_state_dict
from multimodal_transformer_robustness_tpu.models import supernet_apply as j_apply
from multimodal_transformer_robustness_tpu.train import loop as jloop
from multimodal_transformer_robustness_tpu_torch.train import loop as tloop
from multimodal_transformer_robustness_tpu_torch.weights import export_reference_state_dict

from _torch_pair import (BF16_B, bf16_batch, bf16_build, bf16_masks, bf16_port, exact_jit,
                         no_cross_quirk, use_pallas_interpret)

LOSS_TOL = 1e-2
GRAD_COS = 0.999


def test_train_step_bf16_matches_jax(monkeypatch):
    use_pallas_interpret(monkeypatch)
    with no_cross_quirk():
        c = bf16_build()
        jm, tm = bf16_masks(c, c["cfg"])
        inputs, labels, valid = bf16_batch(c)
        j_in = [jnp.asarray(inputs[0], jnp.int32)] + [jnp.asarray(x) for x in inputs[1:]]

        def loss_fn(p):
            preds = j_apply(c["js"], p, jm, j_in, frozen=c["frozen"], bert_cfg=c["jb"],
                            train=True, rng=jax.random.PRNGKey(0))
            return jloop.make_criterion("L1Loss")(preds, jnp.asarray(labels),
                                                  jnp.asarray(valid))

        with exact_jit():
            step = jax.jit(jax.value_and_grad(loss_fn))
        j_loss, j_grads = step(
            jax.tree.map(jnp.asarray, c["params_np"]))
        tp, tf = bf16_port(c)
        tt = tloop.Trainer(c["ts"], tp, tf, tloop.TrainHParams(batch_size=BF16_B),
                           bert_cfg=c["tb"], device="cpu")
        t_loss, t_grads = tt.loss_and_grads(
            tt.params, tm, [torch.from_numpy(x) for x in inputs], torch.from_numpy(labels),
            torch.from_numpy(valid), tt.generator)
    rel = abs(float(t_loss) - float(j_loss)) / abs(float(j_loss))
    print(f"loss {float(t_loss):.6f} vs {float(j_loss):.6f}: rel {rel:.3e}")
    assert rel <= LOSS_TOL
    assert all(p.dtype == torch.float32 for p in tloop.tree_leaves(tt.params))
    assert all(g.dtype == torch.float32 for g in tloop.tree_leaves(t_grads))
    ours = export_reference_state_dict(c["ts"], t_grads)
    theirs = {k: np.asarray(v) for k, v in export_torch_state_dict(c["js"], j_grads).items()
              if not k.startswith("translation.")}
    assert sorted(ours) == sorted(theirs)
    assert all(v.dtype == np.float32 for v in theirs.values())
    a = np.concatenate([ours[k].ravel() for k in sorted(ours)]).astype(np.float64)
    r = np.concatenate([theirs[k].ravel() for k in sorted(ours)]).astype(np.float64)
    cos = float(a @ r / (np.linalg.norm(a) * np.linalg.norm(r)))
    print(f"gradient cosine {cos:.6f}")
    assert cos >= GRAD_COS
