"""The bf16 plain versions of K1f, K1b, K2 and K3 against the JAX package's
Pallas kernels at bf16 operands (interpret mode), on the CPU; then the
port's bf16 policy on its own: a feed stored in bf16 gives the bits of a
float32 one, and every bf16 path without a bf16 instance raises.

The same numpy-seeded float32 operands are rounded to bf16 on both sides
(the same bits), so what the comparison sees is each side's arithmetic
at its rounding points.  The JAX kernels are compiled with XLA's excess
precision off (``exact``), so they round every bf16 result where they are
written to round it (by default XLA CPU would keep, for one, K2's and
K3's bf16 residual sum in float32 for the LN).  Tolerance: max |port - JAX| <= 2e-2 of max |JAX|
for every output (a result one bf16 step apart where a float32 sum in
another order lands across a rounding edge, and what that step moves
downstream); the share of elements that differ is printed.  The JAX bf16
policy's own bound against float32 is 5% (tests/test_bf16_policy.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_robustness_tpu.ops import bert_attn_pallas, bert_ffn_pallas
from multimodal_transformer_robustness_tpu.ops import bigru_pallas
from multimodal_transformer_robustness_tpu_torch import config as tcfg
from multimodal_transformer_robustness_tpu_torch.data import (ArrayDataset, BatchIterator,
                                                              DeviceBatchIterator,
                                                              cast_float_inputs)
from multimodal_transformer_robustness_tpu_torch.masks import build_masks
from multimodal_transformer_robustness_tpu_torch.models import bert as tbert
from multimodal_transformer_robustness_tpu_torch.models import init_supernet as t_init
from multimodal_transformer_robustness_tpu_torch.models import supernet_apply as t_apply
from multimodal_transformer_robustness_tpu_torch.models.mult import cast_tree
from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda, bert_ffn_cuda
from multimodal_transformer_robustness_tpu_torch.ops import bigru_cuda
from multimodal_transformer_robustness_tpu_torch.train import loop as tloop

from _torch_pair import MoseiLike

TOL = 2e-2


def close(ours: torch.Tensor, theirs, what: str) -> None:
    assert ours.dtype == torch.bfloat16
    a = ours.float().numpy()
    r = np.asarray(jnp.asarray(theirs, jnp.float32))
    assert a.shape == r.shape, what
    scale = float(np.abs(r).max())
    err = float(np.abs(a - r).max())
    print(f"{what}: max |d| {err:.3e} of max |ref| {scale:.3e}, "
          f"{float(np.mean(a != r)):.2%} differ")
    assert err <= TOL * scale, what


def exact(fn, *args, **static):
    """The jitted JAX ``fn`` on ``args``, compiled with XLA's excess
    precision off (``static``: its static arguments)."""
    return fn.lower(*args, **static).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def pair(a: np.ndarray):
    """One float32 array as bf16 in both packages (the same bits)."""
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def gru_operands(rng, in_dim: int, h: int):
    k = 1.0 / np.sqrt(h)
    u = lambda *s: rng.uniform(-k, k, s).astype(np.float32)  # noqa: E731
    return [u(3, in_dim, h), u(3, h, h), u(3, h), u(h)]


@pytest.mark.parametrize("T,B,I,H,reverse", [(6, 4, 24, 16, False), (5, 3, 9, 12, True)])
def test_gru_dir_bf16_matches_jax(T, B, I, H, reverse):
    """K1f's and K1b's bf16 plain versions: h, then dx, dW and db (the JAX
    VJP rounds them to bf16), need_dx on and off."""
    rng = np.random.default_rng(1)
    x_np = rng.standard_normal((T, B, I)).astype(np.float32)
    dh_np = rng.standard_normal((T, B, H)).astype(np.float32)
    (jx, tx), (jdh, tdh) = pair(x_np), pair(dh_np)
    ops = [pair(a) for a in gru_operands(rng, I, H)]
    jops, tops = [o[0] for o in ops], [o[1] for o in ops]
    hs = bigru_cuda.gru_dir_plain(tx, *tops, reverse)
    for need_dx in (True, False):
        j_hs, vjp = jax.vjp(lambda *a: bigru_pallas.gru_dir_pallas(*a, reverse, True, need_dx),
                            jx, *jops)
        if need_dx:
            close(hs, j_hs, f"K1f h T={T} reverse={reverse}")
        ours = bigru_cuda.gru_dir_bwd_plain(tx, *tops, hs, None, tdh, reverse, need_dx)
        theirs = vjp(jdh)
        for name, a, r in zip(("dx", "dwp", "dwt", "dbc", "dbhn"), ours, theirs):
            if a is None:
                assert not need_dx
                continue
            close(a, r, f"K1b {name} T={T} reverse={reverse} need_dx={need_dx}")


@pytest.mark.parametrize("softmax", ["float32", "bfloat16"])
def test_attention_block_bf16_matches_jax(softmax):
    """K2's bf16 plain version, both softmax tails (ATTN_SOFTMAX), with a
    padded and a fully masked item."""
    rng = np.random.default_rng(2)
    B, L, h, heads = 3, 8, 32, 2
    x = rng.standard_normal((B, L, h)).astype(np.float32)
    ws = [(rng.standard_normal((h, h)) * 0.2).astype(np.float32) for _ in range(4)]
    bs = [(rng.standard_normal(h) * 0.1).astype(np.float32) for _ in range(4)]
    g = (rng.standard_normal(h) * 0.2 + 1.0).astype(np.float32)
    b = (rng.standard_normal(h) * 0.1).astype(np.float32)
    mask = np.ones((B, L), np.float32)
    mask[1, 5:] = 0
    mask[2] = 0
    jx, tx = pair(x)
    jw, tw = zip(*[pair(w) for w in ws])
    jb, tb = zip(*[pair(v) for v in bs + [g, b]])
    ref = exact(bert_attn_pallas.attention_block_fused, jx, jnp.asarray(mask), jw[0], jb[0],
                jw[1], jb[1], jw[2], jb[2], jw[3], jb[3], jb[4], jb[5], n_heads=heads,
                eps=1e-12, interpret=True, softmax_dtype=softmax)
    ours = bert_attn_cuda.attention_block_fused(
        tx, torch.from_numpy(mask), tw[0].t().contiguous(), tb[0], tw[1].t().contiguous(),
        tb[1], tw[2].t().contiguous(), tb[2], tw[3].t().contiguous(), tb[3], tb[4], tb[5],
        n_heads=heads, eps=1e-12, softmax_dtype=softmax)
    close(ours, ref, f"K2 softmax={softmax}")


def test_ffn_ln_bf16_matches_jax():
    """K3's bf16 plain version (rows not a multiple of the JAX block)."""
    rng = np.random.default_rng(3)
    rows, h, ffn = 20, 32, 128
    x = rng.standard_normal((rows, h)).astype(np.float32)
    w1 = (rng.standard_normal((ffn, h)) * 0.2).astype(np.float32)
    w2 = (rng.standard_normal((h, ffn)) * 0.1).astype(np.float32)
    vs = [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in (ffn, h)]
    g = (rng.standard_normal(h) * 0.2 + 1.0).astype(np.float32)
    b = (rng.standard_normal(h) * 0.1).astype(np.float32)
    jx, tx = pair(x)
    (jw1, tw1), (jw2, tw2) = pair(w1), pair(w2)
    (jb1, tb1), (jb2, tb2), (jg, tg), (jbb, tbb) = (pair(v) for v in vs + [g, b])
    ref = exact(bert_ffn_pallas.ffn_ln_block, jx, jw1, jb1, jw2, jb2, jg, jbb, eps=1e-12,
                interpret=True)
    ours = bert_ffn_cuda.ffn_ln_block(tx, tw1.t().contiguous(), tb1, tw2.t().contiguous(),
                                      tb2, tg, tbb, eps=1e-12)
    close(ours, ref, "K3")


# ------------------------------------------------- the port's policy alone

POLICY_SPEC = dict(modality_set=("t", "a", "v"), orig_dimensions=(16, 6, 5), dimension=8,
                   num_heads=2, head_dim=4, layers_single_attn=1, layers_cross_attn=1,
                   layers_self_attn=1, attn_dropout=(0.0, 0.0, 0.0, 0.0), relu_dropout=0.0,
                   res_dropout=0.0, out_dropout=0.0, embed_dropout=0.0, attn_mask=True,
                   output_dim=1, compute_dtype="bfloat16")


@pytest.fixture(scope="module")
def policy():
    spec = tcfg.ModelSpec(**POLICY_SPEC)
    tb = tbert.tiny_bert_config()
    params, frozen = t_init(torch.Generator().manual_seed(0), spec, tb)
    ds = MoseiLike(6, seed=4, vocab=tb.vocab_size)
    masks = build_masks(spec, tcfg.full_active_config(spec))
    return dict(spec=spec, tb=tb, params=params, frozen=frozen, ds=ds, masks=masks)


def test_precast_feed_bit_identical(policy):
    """Float inputs stored in bf16 (``cast_float_inputs``) give the forward
    and the gradients of a float32 feed bit for bit: the boundary cast is
    the first op that touches them (the JAX package's
    tests/test_bf16_policy.py::test_precast_feed_bit_identical)."""
    p = policy
    inputs, labels = p["ds"].gather(np.arange(4))
    f32 = [torch.from_numpy(x) for x in inputs]
    pre = ArrayDataset([p["ds"].text.transpose(1, 0, 2), p["ds"].audio, p["ds"].vision],
                       p["ds"].labels, [16, 6, 5], 6)
    cast_float_inputs(pre, "bfloat16")
    assert [x.dtype for x in pre.inputs[1:]] == [torch.bfloat16] * 2
    assert pre.inputs[0].dtype == np.int64
    bf = [f32[0]] + [x[:4] for x in pre.inputs[1:]]
    outs, grads = [], []
    for feed in (f32, bf):
        params = {k: v for k, v in p["params"].items()}
        leaves = tloop.tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
            t.grad = None
        out = t_apply(p["spec"], params, p["masks"], feed, frozen=p["frozen"],
                      bert_cfg=p["tb"], train=True)
        (out - torch.from_numpy(labels)).abs().mean().backward()
        outs.append(out.detach())
        grads.append([t.grad.clone() for t in leaves])
    assert outs[0].dtype == torch.float32
    assert torch.equal(outs[0], outs[1])
    assert all(torch.equal(a, b) and a.dtype == torch.float32
               for a, b in zip(grads[0], grads[1]))


def test_device_store_bf16_equals_host_feed(policy):
    """``DeviceBatchIterator(store_dtype="bfloat16")`` (on the CPU here):
    the same batches as the host iterator, float modalities in bf16, and
    the same ``evaluate`` as the float32 host feed."""
    p = policy
    host = BatchIterator(p["ds"], 4)
    dev = DeviceBatchIterator(p["ds"], 4, store_dtype="bfloat16", device="cpu")
    for a, b in zip(host, dev):
        assert b.inputs[0].dtype == torch.int64 and torch.equal(b.inputs[0],
                                                                torch.from_numpy(a.inputs[0]))
        for x, y in zip(a.inputs[1:], b.inputs[1:]):
            assert y.dtype == torch.bfloat16
            assert torch.equal(y, torch.from_numpy(x).to(torch.bfloat16))
    hp = tloop.TrainHParams(batch_size=4, dataset="mosei_senti")
    tr = tloop.Trainer(p["spec"], p["params"], p["frozen"], hp, bert_cfg=p["tb"],
                       device="cpu")
    m_host, preds_host, _ = tr.evaluate(host, p["masks"], [0, 1, 2])
    m_dev, preds_dev, _ = tr.evaluate(dev, p["masks"], [0, 1, 2])
    assert m_host == m_dev and np.array_equal(preds_host, preds_dev)


def test_prepared_bf16_bert_equals_the_cast(policy):
    """``prepare_bert(..., dtype=bfloat16)`` makes the weights the boundary
    cast makes, q/k/v still views of one tensor."""
    tb = policy["tb"]
    raw = tbert.init_bert(torch.Generator().manual_seed(1), tb)
    cast = cast_tree(tbert.prepare_bert(raw), torch.bfloat16)
    once = tbert.prepare_bert(raw, dtype=torch.bfloat16)
    for a, b in zip(tloop.tree_leaves(cast), tloop.tree_leaves(once)):
        assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b)
    lp = once["layers"][0]
    assert lp["q_wt"]._base is lp["k_wt"]._base is lp["v_wt"]._base


def test_unported_bf16_paths_raise(policy):
    """Every path without an instance in the compute dtype raises
    NotImplementedError naming ROADMAP; none runs quietly in float32.
    Every kernel has a bf16 instance now (the library ops K7, K8 and K9
    included: ``tests/test_torch_bf16_library_ops.py``; the int8 BERT and
    the dense and xla attention paths: ``tests/test_torch_bf16_bert_variants.py``
    and ``test_torch_bf16_bert_slice.py``; the flash kernels K5:
    ``tests/test_torch_bf16_flash.py``), so the float16 policy is what is
    left."""
    p = policy
    inputs = [torch.from_numpy(x) for x in p["ds"].gather(np.arange(2))[0]]

    def apply(spec=p["spec"]):
        return t_apply(spec, p["params"], p["masks"], inputs, frozen=p["frozen"],
                       bert_cfg=p["tb"])

    cases = {
        "float16": lambda: apply(spec=dataclasses.replace(p["spec"], compute_dtype="float16")),
    }
    for name, fn in cases.items():
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn()
