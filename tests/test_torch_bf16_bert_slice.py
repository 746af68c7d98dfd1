"""The frozen BERT's int8, dense and long-text paths under the bf16 compute
policy against the JAX package's, on the CPU: ``supernet_apply`` with the
int8 FFN BERT (``quantize_bert_params(attn=False)``, bench.py's
``--bert_int8``), the fully int8 BERT and ``ATTN_IMPL`` "dense" and "xla";
and ``StreamingPredictor`` on a text bucket above 64 word pieces (one
training step with the int8 FFN BERT: ``tests/test_torch_bf16_bert_variants.py``).

The models are ``tests/_torch_pair.py``'s bf16 parity model (a tiny BERT at
width 128, so that the JAX shape gates of its BERT kernels fire), the int8
BERT quantized from the float32 weights on both sides and then cast by the
boundary cast.  The JAX side runs its Pallas kernels in interpret mode
with XLA's excess precision off (``_torch_pair.exact_jit``), the port its
bf16 plain versions.  Tolerances, as ``tests/test_torch_bf16_slice.py``
: predictions within 2e-2 of max(|ref|, 1e-2) elementwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_robustness_tpu import build_masks as j_build_masks
from multimodal_transformer_robustness_tpu import config as jcfg
from multimodal_transformer_robustness_tpu.models import bert as jbert
from multimodal_transformer_robustness_tpu.models import supernet_apply as j_apply
from multimodal_transformer_robustness_tpu_torch.models import bert as tbert
from multimodal_transformer_robustness_tpu_torch.models import supernet_apply as t_apply

from _torch_pair import (BF16_SPEC, bf16_batch, bf16_build, bf16_frozen, bf16_masks,
                         bf16_port, exact_jit, no_cross_quirk, use_pallas_interpret)
from test_torch_bf16_slice import _close

# (ATTN_IMPL, int8 mode): None float, "ffn" fc1 / fc2, "all" every projection
CASES = [("auto", "ffn"), ("auto", "all"), ("dense", None), ("xla", None)]


@pytest.fixture(autouse=True)
def _kernels_and_no_quirk(monkeypatch):
    use_pallas_interpret(monkeypatch)
    with no_cross_quirk():
        yield


@pytest.fixture(scope="module")
def case():
    return bf16_build()


@pytest.mark.parametrize("impl,int8", CASES)
def test_supernet_apply_bf16_bert_variants_match_jax(case, impl, int8, monkeypatch):
    c = case
    monkeypatch.setattr(jbert, "ATTN_IMPL", impl)
    monkeypatch.setattr(tbert, "ATTN_IMPL", impl)
    jf, tf = bf16_frozen(c, int8)
    jm, tm = bf16_masks(c, c["cfg"])
    inputs, _, _ = bf16_batch(c)
    with exact_jit():
        run = jax.jit(lambda p, m, f, x: j_apply(c["js"], p, m, x, frozen=f,
                                                 bert_cfg=c["jb"]))
    ref = run(jax.tree.map(jnp.asarray, c["params_np"]), jm, jf,
              [jnp.asarray(inputs[0], jnp.int32)] + [jnp.asarray(x) for x in inputs[1:]])
    tp, _ = bf16_port(c)
    with torch.no_grad():
        out = t_apply(c["ts"], tp, tm, [torch.from_numpy(x) for x in inputs], frozen=tf,
                      bert_cfg=c["tb"])
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    _close(out.numpy(), ref, f"supernet_apply ATTN_IMPL={impl} int8={int8}")


SERVE_SPEC = dict(BF16_SPEC, modality_set=("t", "a", "v"), orig_dimensions=(128, 10, 12),
                  attn_dropout=(0.0, 0.0, 0.0, 0.0))
SERVE_BERT = dict(vocab_size=64, hidden_size=128, num_layers=1, num_heads=2,
                  intermediate_size=512, max_position=128, type_vocab_size=2)


def test_streaming_predictor_bf16_long_text_matches_jax():
    """``StreamingPredictor(spec=<bf16>)`` on a request whose text fills the
    128 bucket (K2's bf16 instance past L = 64) against the JAX package's
    serving forward (its predictor's jitted ``supernet_apply``) on the same
    prepared request, parameters and BERT.  The two part by a bf16 step
    here and there: the BERT's float32 softmax sums over 128 keys run in
    another order (``test_torch_bf16_bert_variants.py``'s K2 at L = 96)."""
    from multimodal_transformer_robustness_tpu_torch.cli.realtime import StreamingPredictor

    c = bf16_build(spec=SERVE_SPEC, bert_cfg=SERVE_BERT)
    pred = StreamingPredictor(spec=c["ts"], bert_cfg=c["tb"], device="cpu")
    pred.params, pred.frozen = bf16_port(c)
    rng = np.random.default_rng(8)
    req = pred.prepare([f"w{i}" for i in range(90)],
                       rng.standard_normal((1, 13, 10)).astype(np.float32),
                       rng.standard_normal((1, 9, 12)).astype(np.float32))
    assert req[0].shape[2] == 128
    with exact_jit():
        run = jax.jit(lambda p, m, f, x: j_apply(c["js"], p, m, x, frozen=f,
                                                 bert_cfg=c["jb"]))
    ref = run(jax.tree.map(jnp.asarray, c["params_np"]),
              jax.tree.map(jnp.asarray, j_build_masks(c["js"], jcfg.full_active_config(c["js"]))),
              c["frozen"], [jnp.asarray(a) for a in req])
    _close(np.array([pred.forward(*req)]), np.asarray(ref)[:, 0], "StreamingPredictor L=128")
