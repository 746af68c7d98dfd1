"""The frozen-BERT variants of the port against the JAX package, on the CPU:
int8 weights (``quantize_bert_params``, kernel K4 and the int8 projections),
the unfused attention paths (``ATTN_IMPL`` "dense" and "xla", kernels K6a
and K6b) and the int8 serving predictor.

On the CPU every wrapper runs its plain PyTorch version; those are held to
the Pallas kernels in interpret mode and to the JAX package's XLA
compositions.  Tolerances (float32, JAX precision "highest", pinned by
conftest.py):

  * quantization is exact: the same int8 codes and the same float32 scales,
    half-way ties rounded to even;
  * K4, K6a, K6b: atol = rtol = 1e-5.  K6a and K6b differ from the Pallas
    kernels only in summation order.  K4's int32 products are exact; its
    dequant and gelu epilogues are the same float32 operations (XLA may fuse
    them with FMAs), so a hidden int8 code could flip where a value sits one
    float32 step from a rounding edge, which these inputs do not meet;
  * ``bert_apply`` and the int8 predictor: 1e-4, as the whole serving slice
    (``tests/test_torch_slice.py``): float32 summed in other orders through
    two layers, with the -10000 key bias.  With int8 weights the two sides'
    activations differ in their last bits before each row quantization (the
    LayerNorm means and the attention are summed in other orders), so now
    and then one int8 code lands one step apart.  Such a flip moves the rows
    it reaches by at most one quantization step, an activation scale (|a| <=
    4, so <= 4/127) times a dequantized weight (|w| <= 0.09 for N(0, 0.02)
    weights at these widths), through a LayerNorm of unit scale: QSTEP =
    3e-3.  So in the int8 modes at most one row in ten may exceed 1e-4, and
    none QSTEP.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_robustness_tpu import config as jcfg
from multimodal_transformer_robustness_tpu.checkpoint import export_torch_state_dict
from multimodal_transformer_robustness_tpu.models import bert as jbert
from multimodal_transformer_robustness_tpu.ops import bert_attn_pallas, bert_ffn_pallas
from multimodal_transformer_robustness_tpu_torch import config as tcfg
from multimodal_transformer_robustness_tpu_torch.models import bert as tbert
from multimodal_transformer_robustness_tpu_torch.models.mult import to_device
from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda, bert_ffn_cuda
from multimodal_transformer_robustness_tpu_torch.weights import load_reference_state_dict
from test_torch_kernels_gpu import attn_inputs, ffn_inputs

TOL = dict(atol=1e-5, rtol=1e-5)
APPLY_TOL = dict(atol=1e-4, rtol=1e-4)
QSTEP = 3e-3


def _assert_close_int8(out, ref):
    """APPLY_TOL but for rows a flipped int8 code reached (module docstring)."""
    out, ref = np.asarray(out), np.asarray(ref)
    diff = np.abs(out - ref)
    beyond = diff > APPLY_TOL["atol"] + APPLY_TOL["rtol"] * np.abs(ref)
    rows = beyond.reshape(-1, out.shape[-1]).any(-1)
    assert rows.mean() <= 0.1, f"{rows.sum()} of {rows.size} rows beyond {APPLY_TOL}"
    assert diff.max() <= QSTEP, f"max abs diff {diff.max():.3e} > one step {QSTEP}"


def _t(a):
    return torch.from_numpy(np.array(a))


def _float_bert(cfg):
    """JAX-initialized HF-layout weights, with nonzero biases and LN params
    so every term of every block is exercised."""
    params = jbert.init_bert(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(11)
    layers = dict(params["layers"])
    for name in ("q_b", "k_b", "v_b", "o_b", "fc1_b", "fc2_b", "ln1_b", "ln2_b"):
        layers[name] = jnp.asarray(0.02 * rng.standard_normal(layers[name].shape),
                                   jnp.float32)
    for name in ("ln1_g", "ln2_g"):
        layers[name] = jnp.asarray(1.0 + 0.1 * rng.standard_normal(layers[name].shape),
                                   jnp.float32)
    return dict(params, layers=layers)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------------ quantization

@pytest.mark.parametrize("attn", [True, False])
def test_quantize_bert_params_bit_identical(attn):
    cfg = jbert.tiny_bert_config(hidden=32, heads=2, layers=2)
    params = _float_bert(cfg)
    ref = jbert.quantize_bert_params(params, attn=attn)["layers"]
    ours = tbert.quantize_bert_params(tbert.prepare_bert(_np_tree(params)), attn=attn)
    quantized = ("q_w", "k_w", "v_w", "o_w", "fc1_w", "fc2_w") if attn else ("fc1_w", "fc2_w")
    for i, lp in enumerate(ours["layers"]):
        for name in ("q_w", "k_w", "v_w", "o_w", "fc1_w", "fc2_w"):
            if name not in quantized:
                assert f"{name}t" in lp and name not in lp
                continue
            assert lp[name]["q"].dtype == torch.int8 and lp[name]["s"].dtype == torch.float32
            np.testing.assert_array_equal(lp[name]["q"].numpy(), np.asarray(ref[name]["q"][i]))
            np.testing.assert_array_equal(lp[name]["s"].numpy(), np.asarray(ref[name]["s"][i]))
    # the JAX package's quantized weights load as they are
    loaded = tbert.prepare_bert(_np_tree(jbert.quantize_bert_params(params, attn=attn)))
    for a, b in zip(loaded["layers"], ours["layers"]):
        for name in quantized:
            assert torch.equal(a[name]["q"], b[name]["q"])
            assert torch.equal(a[name]["s"], b[name]["s"])


def test_qrows_ties_round_half_to_even():
    """Row [254, 1, 3, -5]: sx = 2, so 1, 3 and -5 quantize from 0.5, 1.5 and
    -2.5, which round to 0, 2 and -2; then random rows, bit for bit."""
    x = np.array([[254.0, 1.0, 3.0, -5.0]], np.float32)
    xq, sx = bert_ffn_cuda.qrows(_t(x))
    jq, jsx = jbert._qrows(jnp.asarray(x))
    assert sx.item() == 2.0
    assert xq.tolist() == [[127, 0, 2, -2]]
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
    x = np.random.default_rng(0).standard_normal((3, 5, 48)).astype(np.float32)
    x[1, 2] = 0.0                                 # an all-zero row: sx = 1e-8 / 127
    xq, sx = bert_ffn_cuda.qrows(_t(x))
    jq, jsx = jbert._qrows(jnp.asarray(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))


def _quantized(rng, out_dim, in_dim, scale=0.05):
    w = jnp.asarray(rng.standard_normal((out_dim, in_dim)) * scale, jnp.float32)
    wq = jbert.quantize_bert_params({"layers": {n: w for n in tbert._WEIGHTS}})["layers"]["q_w"]
    return wq, {"q": _t(wq["q"]), "s": _t(wq["s"])}


def test_qdot_plain_matches_qproj():
    """The int8 projection against the JAX package's ``_qproj``; the int32
    products equal a float64 reference exactly."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 9, 40)).astype(np.float32)
    b = (rng.standard_normal(24) * 0.1).astype(np.float32)
    jw, tw = _quantized(rng, 24, 40)
    ref = jbert._qproj(jnp.asarray(x), jw, jnp.asarray(b))
    out = tbert._qproj(_t(x), tw, _t(b))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    xq, _ = bert_ffn_cuda.qrows(_t(x))
    acc = bert_ffn_cuda.int8_matmul(xq, tw["q"])
    assert acc.dtype == torch.int32
    exact = xq.numpy().astype(np.int64) @ tw["q"].numpy().astype(np.int64).T
    np.testing.assert_array_equal(acc.numpy(), exact)


@pytest.mark.parametrize("rows,h,ffn,block", [(100, 128, 256, 64), (37, 32, 128, 16)])
def test_ffn_ln_q_plain_matches_pallas_interpret(rows, h, ffn, block):
    """K4, rows not a multiple of the Pallas row block (its padding path)."""
    rng = np.random.default_rng(3)
    x, w1, b1, w2, b2, g, b = ffn_inputs(rng, rows, h, ffn)
    jq = jbert.quantize_bert_params(
        {"layers": {"q_w": w1, "k_w": w1, "v_w": w1, "o_w": w1, "fc1_w": w1,
                    "fc2_w": w2}})["layers"]
    ref = bert_ffn_pallas.ffn_ln_block_q(
        jnp.asarray(x), jq["fc1_w"], jnp.asarray(b1), jq["fc2_w"], jnp.asarray(b2),
        jnp.asarray(g), jnp.asarray(b), eps=1e-12, block_rows=block, interpret=True)
    w1q = {k: _t(v) for k, v in jq["fc1_w"].items()}
    w2q = {k: _t(v) for k, v in jq["fc2_w"].items()}
    n0 = bert_ffn_cuda.ffn_ln_block_q.launches
    out = bert_ffn_cuda.ffn_ln_block_q(_t(x), w1q, _t(b1), w2q, _t(b2), _t(g), _t(b),
                                       eps=1e-12)
    assert bert_ffn_cuda.ffn_ln_block_q.launches == n0   # the CPU launches nothing
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_gelu_poly_matches_pallas_kernel_gelu():
    x = np.random.default_rng(4).standard_normal(4096).astype(np.float32) * 4
    np.testing.assert_allclose(bert_ffn_cuda.gelu_erf_poly(_t(x)).numpy(),
                               np.asarray(bert_ffn_pallas._gelu_erf(jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("B,L,heads,h", [(3, 8, 2, 16), (2, 13, 4, 32)])
def test_dense_attention_plain_matches_pallas_interpret(B, L, heads, h):
    """K6a: ragged key mask with one fully masked item (finite output)."""
    rng = np.random.default_rng(5)
    _, _, _, _, _, mask = attn_inputs(rng, B, L, h)
    q, k, v = (rng.standard_normal((B, L, heads, h // heads)).astype(np.float32)
               for _ in range(3))
    ref = bert_attn_pallas.dense_attention_blockdiag(
        *(jnp.asarray(a) for a in (q, k, v, mask)), interpret=True)
    n0 = bert_attn_cuda.dense_attention_blockdiag.launches
    out = bert_attn_cuda.dense_attention_blockdiag(_t(q), _t(k), _t(v), _t(mask))
    assert bert_attn_cuda.dense_attention_blockdiag.launches == n0
    assert torch.isfinite(out).all() and out.shape == (B, L, h)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("rows,h", [(100, 128), (9, 32)])
def test_proj_ln_plain_matches_pallas_interpret(rows, h):
    """K6b; the port takes the weight transposed (``w_t = w.T``), as K2's
    ``o_wt``."""
    rng = np.random.default_rng(6)
    resid, a = (rng.standard_normal((rows, h)).astype(np.float32) for _ in range(2))
    w = (rng.standard_normal((h, h)) * 0.05).astype(np.float32)
    b, bb = ((rng.standard_normal(h) * 0.05).astype(np.float32) for _ in range(2))
    g = (1.0 + 0.2 * rng.standard_normal(h)).astype(np.float32)
    ref = bert_ffn_pallas.proj_ln_block(*(jnp.asarray(t) for t in (resid, a, w, b, g, bb)),
                                        eps=1e-12, block_rows=64, interpret=True)
    n0 = bert_ffn_cuda.proj_ln_block.launches
    out = bert_ffn_cuda.proj_ln_block(_t(resid), _t(a), _t(w.T), _t(b), _t(g), _t(bb),
                                      eps=1e-12)
    assert bert_ffn_cuda.proj_ln_block.launches == n0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# ---------------------------------------------------------------- bert_apply

_IMPLS = ("auto", "fused", "dense", "xla")
_INT8 = ("float", "ffn", "full")       # none / quantize_bert_params(attn=False / True)


def _apply_cases():
    """Every ATTN_IMPL x int8 mode, the JAX side on its XLA path ("plain")
    and through its Pallas kernels in interpret mode.  On its plain path the
    JAX package runs the fused and dense attention kernels only in interpret
    mode, so those pairs exist on the interpret side alone (a forced "fused"
    on full-int8 layers falls back to XLA attention, so it runs plain too)."""
    out = []
    for impl, int8, mode in itertools.product(_IMPLS, _INT8, ("plain", "interpret")):
        needs_kernel = impl == "dense" or (impl == "fused" and int8 != "full")
        if mode == "plain" and needs_kernel:
            continue
        out.append((impl, int8, mode))
    return out


@pytest.fixture(scope="module")
def bert_case():
    jcfg_b = jbert.BertConfig(vocab_size=97, hidden_size=128, num_layers=2, num_heads=2,
                              intermediate_size=512, max_position=32, type_vocab_size=2)
    tcfg_b = tbert.BertConfig(vocab_size=97, hidden_size=128, num_layers=2, num_heads=2,
                              intermediate_size=512, max_position=32, type_vocab_size=2)
    params = _float_bert(jcfg_b)
    jparams = {"float": params, "ffn": jbert.quantize_bert_params(params, attn=False),
               "full": jbert.quantize_bert_params(params, attn=True)}
    rng = np.random.default_rng(7)
    B, L = 3, 9
    mask = np.ones((B, L), np.float32)
    mask[1, 6:] = 0
    mask[2] = 0                                      # one fully masked item
    ids = rng.integers(0, 97, (B, L))
    types = np.zeros((B, L), np.int64)
    return dict(jcfg=jcfg_b, tcfg=tcfg_b, jparams=jparams,
                tparams={k: tbert.prepare_bert(_np_tree(v)) for k, v in jparams.items()},
                ids=ids, mask=mask, types=types)


@pytest.mark.parametrize("impl,int8,mode", _apply_cases())
def test_bert_apply_matches(bert_case, impl, int8, mode, monkeypatch):
    c = bert_case
    monkeypatch.setattr(jbert, "ATTN_IMPL", impl)
    monkeypatch.setattr(tbert, "ATTN_IMPL", impl)
    if mode == "interpret":
        monkeypatch.setattr(jbert, "FFN_IMPL", "pallas")
        monkeypatch.setattr(jbert, "FFN_INTERPRET", True)
    ref = jbert.bert_apply(c["jparams"][int8], jnp.asarray(c["ids"], jnp.int32),
                           jnp.asarray(c["mask"]), jnp.asarray(c["types"], jnp.int32),
                           c["jcfg"])
    out = tbert.bert_apply(c["tparams"][int8], torch.from_numpy(c["ids"]),
                           torch.from_numpy(c["mask"]), torch.from_numpy(c["types"]),
                           c["tcfg"])
    assert torch.isfinite(out).all()
    if int8 == "float":
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **APPLY_TOL)
    else:
        _assert_close_int8(out.numpy(), ref)


def test_attn_dispatch_mirrors_jax(monkeypatch):
    """The port's resolution of each ATTN_IMPL, as documented in models/bert.py;
    an unknown value raises as in the JAX package."""
    table = {("auto", False, 768): "fused", ("auto", False, 2048): "dense",
             ("auto", True, 768): "xla", ("fused", False, 768): "fused",
             ("fused", True, 768): "xla", ("dense", True, 768): "dense",
             ("dense", False, 768): "dense", ("xla", False, 768): "xla"}
    for (impl, quantized, h), want in table.items():
        monkeypatch.setattr(tbert, "ATTN_IMPL", impl)
        assert tbert._attn_resolved_impl(h, quantized) == want
    for impl in ("fused", "dense", "xla"):      # the forced values, case for case
        monkeypatch.setattr(tbert, "ATTN_IMPL", impl)
        monkeypatch.setattr(jbert, "ATTN_IMPL", impl)
        for q in (False, True):
            assert tbert._attn_resolved_impl(768, q) == jbert._attn_resolved_impl(32, 64, q, 768)
    for mod in (tbert, jbert):
        monkeypatch.setattr(mod, "ATTN_IMPL", "pallas")
    with pytest.raises(ValueError, match="unknown ATTN_IMPL"):
        jbert._attn_resolved_impl(32, 64, False, 768)
    cfg = tbert.tiny_bert_config()
    params = tbert.prepare_bert(tbert.init_bert(torch.Generator().manual_seed(0), cfg))
    ids = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="unknown ATTN_IMPL"):
        tbert.bert_apply(params, ids, torch.ones(1, 4), ids, cfg)


# ------------------------------------------------------------ int8 serving

_TINY = dict(modality_set=("t", "a", "v"), orig_dimensions=(6, 10, 12),
             dimension=8, num_heads=2, head_dim=4, layers_single_attn=1,
             layers_cross_attn=1, layers_self_attn=1,
             attn_dropout=(0.0, 0.0, 0.0, 0.0), relu_dropout=0.0,
             res_dropout=0.0, out_dropout=0.0, embed_dropout=0.0,
             attn_mask=True, output_dim=1)


def test_streaming_predictor_int8_matches_jax():
    """``StreamingPredictor(bert_int8=True)`` quantizes fc1 / fc2 only, as
    the JAX predictor; with the JAX predictor's parameters and int8 frozen
    BERT loaded, both answer the same requests alike."""
    from multimodal_transformer_robustness_tpu.cli.realtime import \
        StreamingPredictor as JPredictor
    from multimodal_transformer_robustness_tpu_torch.cli.realtime import StreamingPredictor

    js, ts = jcfg.ModelSpec(**_TINY), tcfg.ModelSpec(**_TINY)
    jpred = JPredictor(spec=js, bert_cfg=jbert.tiny_bert_config(), bert_int8=True)
    pred = StreamingPredictor(spec=ts, bert_cfg=tbert.tiny_bert_config(), bert_int8=True,
                              device="cpu")
    for lp in pred.frozen["bert"]["layers"]:
        assert lp["fc1_w"]["q"].dtype == torch.int8 and "fc2_w" in lp
        assert "q_wt" in lp and "o_wt" in lp            # attention stays float
    pred.params, pred.frozen = load_reference_state_dict(
        ts, export_torch_state_dict(js, jpred.params), _np_tree(jpred.frozen["bert"]))
    rng = np.random.default_rng(8)
    for words, ta, tv in (("a tiny transcript", 5, 3), (" ".join(["w"] * 20), 13, 9)):
        audio = rng.standard_normal((1, ta, 10)).astype(np.float32)
        face = rng.standard_normal((1, tv, 12)).astype(np.float32)
        req = pred.prepare(words.split(), audio, face)
        _assert_close_int8(np.array([[pred.forward(*req)]]),
                           np.array([[jpred.forward(*req)]]))


def test_prepared_qkv_stay_one_operand_on_the_way_to_the_device():
    """``prepare_bert`` lays each layer's float q/k/v weights out as views
    of one ``[3, h, h]`` tensor and their biases of one ``[3h]`` (K2's one
    q/k/v product reads them in place), equal to the JAX weights
    transposed; ``to_device`` (the Trainer moves ``frozen`` with it) keeps
    them so in a copy of its own; int8 attention weights replace them."""
    cfg = jbert.tiny_bert_config(hidden=32, heads=2, layers=2)
    params = _np_tree(_float_bert(cfg))
    prepared = tbert.prepare_bert(params)
    moved = to_device(prepared, "cpu")
    for i, (lp, mp) in enumerate(zip(prepared["layers"], moved["layers"])):
        for tree in (lp, mp):
            ws = [tree[f"{n}_wt"] for n in "qkv"]
            bs = [tree[f"{n}_b"] for n in "qkv"]
            assert bert_attn_cuda._gated(ws, 32 * 32) == (ws[0].data_ptr(), None)
            assert bert_attn_cuda._gated(bs, 32) == (bs[0].data_ptr(), None)
            for n, w, b in zip("qkv", ws, bs):
                np.testing.assert_array_equal(w.numpy(), params["layers"][f"{n}_w"][i].T)
                np.testing.assert_array_equal(b.numpy(), params["layers"][f"{n}_b"][i])
        assert mp["q_wt"].data_ptr() != lp["q_wt"].data_ptr()   # moved, not aliased
    block = torch.arange(3 * 32 * 32, dtype=torch.float32).reshape(3, 32, 32)
    _, copy = bert_attn_cuda._gated([block[0], block[2], block[1]], 32 * 32)
    assert torch.equal(copy, block[[0, 2, 1]].reshape(96, 32))   # stacked per call
    quantized = tbert.quantize_bert_params(moved, attn=True)["layers"][0]
    assert "q_wt" not in quantized and quantized["q_w"]["q"].dtype == torch.int8


def test_quantized_frozen_keeps_int8_on_the_way_to_the_device():
    """``to_device`` (the Trainer moves ``frozen`` with it) and the state-dict
    loader keep int8 weights int8 and float ones float32."""
    cfg = jbert.tiny_bert_config(hidden=32, heads=2, layers=2)
    q = _np_tree(jbert.quantize_bert_params(_float_bert(cfg), attn=True))
    _, frozen = load_reference_state_dict(tcfg.ModelSpec(**_TINY), _dummy_sd(), q)
    moved = to_device(frozen, "cpu")
    for lp in moved["bert"]["layers"]:
        assert lp["fc1_w"]["q"].dtype == torch.int8 and lp["q_w"]["q"].dtype == torch.int8
        assert lp["fc1_w"]["s"].dtype == torch.float32 and lp["ln1_g"].dtype == torch.float32
        assert lp["fc1_w"]["q"].is_contiguous()
    assert torch.equal(moved["bert"]["layers"][1]["v_w"]["q"],
                       torch.from_numpy(np.array(q["layers"]["v_w"]["q"][1])))


def _dummy_sd():
    from multimodal_transformer_robustness_tpu_torch.weights import (
        export_reference_state_dict)
    from multimodal_transformer_robustness_tpu_torch.models import init_supernet

    ts = tcfg.ModelSpec(**_TINY)
    params, _ = init_supernet(torch.Generator().manual_seed(0), ts,
                              tbert.tiny_bert_config())
    return export_reference_state_dict(ts, params)


def test_new_wrappers_raise_off_cpu_and_cuda():
    """K4, K6a, K6b and the int8 projection pieces: a tensor on neither the
    CPU nor a card gets no fallback."""
    x = torch.empty(2, 4, 8, device="meta")
    w = torch.empty(8, 8, device="meta")
    v = torch.empty(8, device="meta")
    wq = {"q": torch.empty(8, 8, dtype=torch.int8, device="meta"), "s": v}
    xq = torch.empty(8, 8, dtype=torch.int8, device="meta")
    calls = [
        lambda: bert_ffn_cuda.ffn_ln_block_q(x, wq, v, wq, v, v, v, eps=1e-12),
        lambda: bert_ffn_cuda.proj_ln_block(x, x, w, v, v, v, eps=1e-12),
        lambda: bert_attn_cuda.dense_attention_blockdiag(
            x.reshape(2, 4, 2, 4), x.reshape(2, 4, 2, 4), x.reshape(2, 4, 2, 4),
            torch.empty(2, 4, device="meta")),
        lambda: bert_ffn_cuda.qrows(x),
        lambda: bert_ffn_cuda.qdot(xq, torch.empty(8, 1, device="meta"), wq, v),
        lambda: bert_ffn_cuda.int8_matmul(xq, xq),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="no kernel"):
            call()
