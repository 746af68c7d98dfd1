"""The bf16 plain versions of K4, K6a, K6b and K2 past L = 64 against the
JAX package's Pallas kernels at bf16 operands (interpret mode), on the CPU,
and the int8 BERT's quantization under the bf16 policy: codes and float32
scales from the float32 weights, as the JAX package's, then rounded.

As in ``tests/test_torch_bf16_kernels.py``: the same numpy-seeded float32
operands are rounded to bf16 on both sides, and the JAX kernels are
compiled with XLA's excess precision off (``exact``), so they round every
bf16 result where they are written to round it.  Tolerance: max |port -
JAX| <= 2e-2 of max |JAX| for every output (a result one bf16 step apart
where a float32 sum in another order lands across a rounding edge, and
what that step moves downstream); the share of elements that differ is
printed.  K4's hidden int8 codes are held to the JAX kernel's (its
``_qround`` of ``_gelu_erf`` of the bf16 h1, the same operations compiled
alike): at most one code in a thousand one step apart.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_robustness_tpu.models import bert as jbert
from multimodal_transformer_robustness_tpu.ops import bert_attn_pallas, bert_ffn_pallas
from multimodal_transformer_robustness_tpu_torch import config as tcfg
from multimodal_transformer_robustness_tpu_torch.models import bert as tbert
from multimodal_transformer_robustness_tpu_torch.models import init_supernet as t_init
from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda, bert_ffn_cuda
from multimodal_transformer_robustness_tpu_torch.train import loop as tloop

from _torch_pair import (bf16_build, bf16_frozen, bf16_train_step_pair, no_cross_quirk,
                         use_pallas_interpret)
from test_torch_bf16_kernels import POLICY_SPEC, close, exact, pair
from test_torch_bf16_train import check_step

MAX_CODE_FLIPS = 1e-3


def _int8(rng, out_dim, in_dim, scale):
    """A float32 weight quantized by the JAX package, the scale then
    rounded to bf16 as its boundary cast rounds it: (JAX dict, port dict)."""
    w = jnp.asarray(rng.standard_normal((out_dim, in_dim)) * scale, jnp.float32)
    q = jbert.quantize_bert_params({"layers": {n: w for n in tbert._WEIGHTS}})["layers"]["q_w"]
    js = q["s"].astype(jnp.bfloat16)
    return ({"q": q["q"], "s": js},
            {"q": torch.from_numpy(np.array(q["q"])),
             "s": torch.from_numpy(np.array(q["s"])).to(torch.bfloat16)})


def _hidden_codes(x, w1, b1):
    """The JAX kernel's hidden codes and row scales, its operations in
    order (``bert_ffn_pallas._ffn_ln_kernel_q``)."""
    xq, sx = bert_ffn_pallas._qround(x.astype(jnp.float32))
    acc = jax.lax.dot_general(xq, w1["q"], (((1,), (1,)), ((), ())),
                              preferred_element_type=jnp.int32)
    h1 = (acc.astype(jnp.float32) * sx * w1["s"].astype(jnp.float32)[None]
          + b1.astype(jnp.float32)[None]).astype(x.dtype)
    return bert_ffn_pallas._qround(bert_ffn_pallas._gelu_erf(h1).astype(jnp.float32))


def test_ffn_ln_q_bf16_matches_jax():
    """K4's bf16 plain version: the output, and the hidden codes and their
    row scales (rows not a multiple of the JAX block)."""
    rng = np.random.default_rng(11)
    rows, h, ffn = 20, 32, 128
    jx, tx = pair(rng.standard_normal((rows, h)).astype(np.float32))
    jw1, tw1 = _int8(rng, ffn, h, 0.2)
    jw2, tw2 = _int8(rng, h, ffn, 0.1)
    vs = [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in (ffn, h)]
    g = (rng.standard_normal(h) * 0.2 + 1.0).astype(np.float32)
    b = (rng.standard_normal(h) * 0.1).astype(np.float32)
    (jb1, tb1), (jb2, tb2), (jg, tg), (jbb, tbb) = (pair(v) for v in vs + [g, b])
    ref = exact(bert_ffn_pallas.ffn_ln_block_q, jx, jw1, jb1, jw2, jb2, jg, jbb, eps=1e-12,
                interpret=True)
    ours, codes, scales = bert_ffn_cuda.ffn_ln_block_q(tx, tw1, tb1, tw2, tb2, tg, tbb,
                                                       eps=1e-12, return_codes=True)
    close(ours, ref, "K4")
    j_codes, j_scales = jax.jit(_hidden_codes).lower(jx, jw1, jb1).compile(
        compiler_options={"xla_allow_excess_precision": False})(jx, jw1, jb1)
    flips = float(np.mean(codes.numpy() != np.asarray(j_codes)))
    print(f"K4 hidden codes: {flips:.2%} differ; the scales of "
          f"{float(np.mean(scales.numpy() != np.asarray(j_scales))):.2%} of rows")
    assert flips <= MAX_CODE_FLIPS
    np.testing.assert_allclose(scales.numpy(), np.asarray(j_scales), rtol=2e-2)


@pytest.mark.parametrize("L", [32, 80])
def test_dense_attention_bf16_matches_jax(L):
    """K6a's bf16 plain version on both sides of the kernel's unit / row
    split (paths 0 and 2 of the plan), a padded and a fully masked item."""
    rng = np.random.default_rng(12)
    B, heads, dh = 3, 2, 16
    (jq, tq), (jk, tk), (jv, tv) = (
        pair(rng.standard_normal((B, L, heads, dh)).astype(np.float32)) for _ in range(3))
    mask = np.ones((B, L), np.float32)
    mask[1, L // 2:] = 0
    mask[2] = 0
    ref = exact(bert_attn_pallas.dense_attention_blockdiag, jq, jk, jv, jnp.asarray(mask),
                interpret=True)
    ours = bert_attn_cuda.dense_attention_blockdiag(tq, tk, tv, torch.from_numpy(mask))
    assert bert_attn_cuda._plan_attention_bf16(B, L, heads, dh)["path"] == (0 if L <= 64 else 2)
    close(ours, ref, f"K6a L={L}")


def test_proj_ln_bf16_matches_jax():
    """K6b's bf16 plain version; the port takes the weight transposed."""
    rng = np.random.default_rng(13)
    rows, h = 20, 32
    (jr, tr), (ja, ta) = (pair(rng.standard_normal((rows, h)).astype(np.float32))
                          for _ in range(2))
    jw, tw = pair((rng.standard_normal((h, h)) * 0.2).astype(np.float32))
    g = (rng.standard_normal(h) * 0.2 + 1.0).astype(np.float32)
    (jb, tb), (jg, tg), (jbb, tbb) = (pair(v) for v in (
        (rng.standard_normal(h) * 0.1).astype(np.float32), g,
        (rng.standard_normal(h) * 0.1).astype(np.float32)))
    ref = exact(bert_ffn_pallas.proj_ln_block, jr, ja, jw, jb, jg, jbb, eps=1e-12,
                interpret=True)
    ours = bert_ffn_cuda.proj_ln_block(tr, ta, tw.t().contiguous(), tb, tg, tbb, eps=1e-12)
    close(ours, ref, "K6b")


@pytest.mark.parametrize("softmax", ["float32", "bfloat16"])
def test_attention_block_bf16_long_matches_jax(softmax):
    """K2's bf16 plain version at L = 96 (the kernel's tiled attention),
    both softmax tails, a padded and a fully masked item."""
    rng = np.random.default_rng(14)
    B, L, h, heads = 2, 96, 32, 2
    jx, tx = pair(rng.standard_normal((B, L, h)).astype(np.float32))
    jw, tw = zip(*[pair((rng.standard_normal((h, h)) * 0.2).astype(np.float32))
                   for _ in range(4)])
    jb, tb = zip(*[pair(v) for v in [(rng.standard_normal(h) * 0.1).astype(np.float32)
                                     for _ in range(4)]
                   + [(rng.standard_normal(h) * 0.2 + 1.0).astype(np.float32),
                      (rng.standard_normal(h) * 0.1).astype(np.float32)]])
    mask = np.ones((B, L), np.float32)
    mask[0, 70:] = 0
    mask[1] = 0
    ref = exact(bert_attn_pallas.attention_block_fused, jx, jnp.asarray(mask), jw[0], jb[0],
                jw[1], jb[1], jw[2], jb[2], jw[3], jb[3], jb[4], jb[5], n_heads=heads,
                eps=1e-12, interpret=True, softmax_dtype=softmax)
    ours = bert_attn_cuda.attention_block_fused(
        tx, torch.from_numpy(mask), *(a for i in range(4) for a in (tw[i].t().contiguous(),
                                                                    tb[i])),
        tb[4], tb[5], n_heads=heads, eps=1e-12, softmax_dtype=softmax)
    close(ours, ref, f"K2 L={L} softmax={softmax}")


# ------------------------------------------------------- the quantize rule

def test_int8_bert_quantized_from_float32():
    """Under the bf16 policy the int8 BERT (``init_supernet(bert_int8=)``,
    ``StreamingPredictor(bert_int8=True)``, the Trainer's one cast) holds the
    JAX package's codes of the float32 weights and their float32 scales
    rounded to bf16; ``quantize_bert_params`` refuses bf16 weights."""
    from multimodal_transformer_robustness_tpu_torch.cli.realtime import StreamingPredictor

    spec16 = tcfg.ModelSpec(**POLICY_SPEC)
    spec32 = dataclasses.replace(spec16, compute_dtype="float32")
    cfg = tbert.tiny_bert_config()
    _, f32 = t_init(torch.Generator().manual_seed(3), spec32, cfg)
    raw = tbert.init_bert(torch.Generator().manual_seed(3), cfg)["layers"]
    for mode, names in (("ffn", ("fc1_w", "fc2_w")), ("all", tbert._WEIGHTS)):
        ref = jbert.quantize_bert_params(
            {"layers": {n: jnp.asarray(raw[n].numpy()) for n in tbert._WEIGHTS}},
            attn=mode == "all")["layers"]
        params, frozen = t_init(torch.Generator().manual_seed(3), spec16, cfg, bert_int8=mode)
        for i, lp in enumerate(frozen["bert"]["layers"]):
            assert lp["ln1_g"].dtype == torch.bfloat16
            for n in names:
                assert lp[n]["q"].dtype == torch.int8 and lp[n]["s"].dtype == torch.bfloat16
                np.testing.assert_array_equal(lp[n]["q"].numpy(), np.asarray(ref[n]["q"][i]))
                assert torch.equal(lp[n]["s"], torch.from_numpy(
                    np.array(ref[n]["s"][i])).to(torch.bfloat16))
        # quantized in float32, then moved by the Trainer: the same tree
        f32_int8 = dict(f32, bert=tbert.quantize_bert_params(f32["bert"], attn=mode == "all"))
        tr = tloop.Trainer(spec16, params, f32_int8, tloop.TrainHParams(batch_size=2),
                           bert_cfg=cfg, device="cpu")
        for a, b in zip(tloop.tree_leaves(tr.frozen), tloop.tree_leaves(frozen)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    pred = StreamingPredictor(spec=spec16, bert_cfg=cfg, bert_int8=True, device="cpu")
    lp = pred.frozen["bert"]["layers"][0]
    assert lp["fc1_w"]["q"].dtype == torch.int8 and lp["q_wt"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="float32"):
        tbert.quantize_bert_params(t_init(torch.Generator().manual_seed(3), spec16,
                                          cfg)[1]["bert"], attn=False)


# --------------------------------------------------- a bf16 int8 training step

def test_train_step_bf16_int8_bert_matches_jax(monkeypatch):
    """bench.py's ``--bert_int8`` at its headline dtype: one training step
    of ``tests/_torch_pair.py``'s bf16 parity model with the int8 FFN BERT
    (quantized from the float32 weights on both sides, cast by the
    boundary cast), K4's plain version on the port's side and the JAX int8
    Pallas kernel (interpret mode, excess precision off) on the other: the
    loss within 1e-2 relative, the gradients at a cosine of 0.999
    (``tests/test_torch_bf16_train.py``'s bounds)."""
    use_pallas_interpret(monkeypatch)
    with no_cross_quirk():
        c = bf16_build()
        check_step(*bf16_train_step_pair(c, *bf16_frozen(c, "ffn")))
