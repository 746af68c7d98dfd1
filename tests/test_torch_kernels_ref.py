"""The port's three kernels' plain versions against the Pallas kernels.

On the CPU every wrapper runs its plain PyTorch version; those are held to
the JAX package's Pallas kernels run in interpret mode, at atol = rtol = 1e-5
in float32 (JAX precision "highest", pinned by conftest.py).  The CUDA
kernels themselves are held to these plain versions on the card by
tests/test_torch_kernels_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_robustness_tpu.ops import gru as jgru
from multimodal_transformer_robustness_tpu.ops.bert_attn_pallas import attention_block_fused
from multimodal_transformer_robustness_tpu.ops.bert_ffn_pallas import ffn_ln_block
from multimodal_transformer_robustness_tpu.ops.bigru_pallas import (
    bigru_finals_tmajor, bigru_level_tmajor)
from multimodal_transformer_robustness_tpu_torch.models import bert as tbert
from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda, bert_ffn_cuda
from multimodal_transformer_robustness_tpu_torch.ops import bigru_cuda
from multimodal_transformer_robustness_tpu_torch.ops import gru as tgru
from test_torch_kernels_gpu import attn_inputs, ffn_inputs

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.as_tensor(np.array(a))


def _gru_params(seed, in_dim, hidden):
    p = jgru.init_bigru(jax.random.PRNGKey(seed), in_dim, hidden)
    torch_layout = {d: {k: _t(v) for k, v in p[d].items()} for d in ("fwd", "bwd")}
    return p, torch_layout


@pytest.mark.parametrize("B,T,I,H", [(3, 11, 7, 12), (1, 5, 16, 8)])
def test_bigru_plain_matches_pallas_interpret(B, T, I, H):
    """K1: both directions, T not a multiple of 8."""
    rng = np.random.default_rng(0)
    jp, tp = _gru_params(0, I, H)
    x_t = rng.standard_normal((T, B, I)).astype(np.float32)
    ref = bigru_level_tmajor(jp, jnp.asarray(x_t), interpret=True)
    n0 = bigru_cuda.gru_dir.launches
    out = bigru_cuda.bigru_level_tmajor(tp, torch.from_numpy(x_t))
    assert bigru_cuda.gru_dir.launches == n0   # the CPU path launches nothing
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(bigru_cuda.bigru_finals_tmajor(out).numpy(),
                               np.asarray(bigru_finals_tmajor(ref)), **TOL)
    # and the level equals the torch-semantics reference op
    ref_out, ref_fin = tgru.bigru_forward(tp, torch.from_numpy(x_t).transpose(0, 1))
    np.testing.assert_allclose(out.transpose(0, 1).numpy(), ref_out.numpy(), **TOL)
    np.testing.assert_allclose(bigru_cuda.bigru_finals_tmajor(out).numpy(),
                               ref_fin.numpy(), **TOL)


def _prepared_attn_args(x, ws, bs, ln_g, ln_b, mask):
    """K2's operands as the port's model hands them over: the HF-layout
    weights (the JAX package's) through ``models.bert.prepare_bert``, whose
    q/k/v weights are views of one stacked ``[3, h, h]`` tensor and biases of
    one ``[3h]`` (the FFN and embedding entries are placeholders)."""
    h = x.shape[-1]
    layer = {f"{n}_{k}": a[None] for n, w, b in zip("qkvo", ws, bs)
             for k, a in (("w", w), ("b", b))}
    layer.update(ln1_g=ln_g[None], ln1_b=ln_b[None], ln2_g=np.ones((1, h)),
                 ln2_b=np.zeros((1, h)), fc1_w=np.zeros((1, 4, h)), fc1_b=np.zeros((1, 4)),
                 fc2_w=np.zeros((1, h, 4)), fc2_b=np.zeros((1, h)))
    bert = {k: np.zeros((1, h)) for k in ("word_emb", "pos_emb", "type_emb")}
    bert.update(emb_ln_g=np.ones(h), emb_ln_b=np.zeros(h), layers=layer)
    lp = tbert.prepare_bert(bert)["layers"][0]
    assert lp["k_wt"].data_ptr() == lp["q_wt"].data_ptr() + 4 * h * h   # one stacked operand
    return [torch.from_numpy(x), torch.from_numpy(mask)] + [
        lp[k] for k in ("q_wt", "q_b", "k_wt", "k_b", "v_wt", "v_b", "o_wt", "o_b", "ln1_g",
                        "ln1_b")]


@pytest.mark.parametrize("B,L,heads,h", [(3, 8, 2, 16), (2, 13, 4, 32), (1, 8, 12, 768)])
def test_attention_block_plain_matches_pallas_interpret(B, L, heads, h):
    """K2: ragged key mask with one fully masked item; the last case at
    BERT-base width and the serving bucket's 8 tokens.  The port's weights
    come through ``prepare_bert``, stacked as its q/k/v product reads them."""
    rng = np.random.default_rng(1)
    x, ws, bs, ln_g, ln_b, mask = attn_inputs(rng, B, L, h)
    eps = 1e-12
    jargs = [jnp.asarray(a) for a in (x, mask)]
    for w, b in zip(ws, bs):
        jargs += [jnp.asarray(w), jnp.asarray(b)]
    ref = attention_block_fused(*jargs, jnp.asarray(ln_g), jnp.asarray(ln_b),
                                n_heads=heads, eps=eps, interpret=True)
    n0 = bert_attn_cuda.attention_block_fused.launches
    out = bert_attn_cuda.attention_block_fused(
        *_prepared_attn_args(x, ws, bs, ln_g, ln_b, mask), n_heads=heads, eps=eps)
    assert bert_attn_cuda.attention_block_fused.launches == n0
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("rows,h,ffn", [(20, 128, 512), (7, 32, 128), (8, 768, 3072)])
def test_ffn_ln_plain_matches_pallas_interpret(rows, h, ffn):
    """K3: exact-erf gelu, centered float32 LN moments; the last case at
    BERT-base width and the serving bucket's 8 rows."""
    rng = np.random.default_rng(2)
    x, w1, b1, w2, b2, g, b = ffn_inputs(rng, rows, h, ffn)
    eps = 1e-12
    ref = ffn_ln_block(*[jnp.asarray(a) for a in (x, w1, b1, w2, b2, g, b)],
                       eps=eps, block_rows=8, interpret=True)
    n0 = bert_ffn_cuda.ffn_ln_block.launches
    out = bert_ffn_cuda.ffn_ln_block(
        torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w1.T)),
        torch.from_numpy(b1), torch.from_numpy(np.ascontiguousarray(w2.T)),
        torch.from_numpy(b2), torch.from_numpy(g), torch.from_numpy(b), eps=eps)
    assert bert_ffn_cuda.ffn_ln_block.launches == n0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_wrappers_raise_off_cpu_and_cuda():
    """A tensor on neither the CPU nor a card gets no fallback: it raises."""
    x = torch.empty(4, 2, 3, device="meta")
    w = torch.empty(3, 3, 5, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        bigru_cuda.gru_dir(x, w, torch.empty(3, 5, 5, device="meta"),
                           torch.empty(3, 5, device="meta"), torch.empty(5, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        bert_ffn_cuda.ffn_ln_block(x, w, w, w, w, w, w, eps=1e-12)
    with pytest.raises(ValueError, match="no kernel"):
        bert_attn_cuda.attention_block_fused(x, x, *([w] * 10), n_heads=1, eps=1e-12)
