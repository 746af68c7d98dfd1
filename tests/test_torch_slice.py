"""The ported serving slice as a whole, against the JAX package on the CPU.

JAX parameters from ``init_supernet`` cross over through
``checkpoint.export_torch_state_dict`` (the reference's names) plus the
frozen BERT as numpy, into ``weights.load_reference_state_dict``.  Then
``supernet_apply(train=False)`` runs on both sides from the same inputs and
masks, with the JAX side once on its default XLA path and once through its
Pallas kernels in interpret mode.  The BERT is ``tiny_bert_config(hidden=128,
heads=2, layers=2)``, so the JAX shape gates of both BERT kernels fire
(h % 128 == 0, ffn % 128 == 0, head_dim % 8 == 0).

Tolerance 1e-4 (atol and rtol): float32 throughout, but the slice chains a
BERT, two GRU levels and eleven encoder stacks, and the reference's
mask/type-id swap puts the -10000 key bias on every logit, where float32 is
only 2**-10 fine, so a last-bit difference upstream can move a logit by one
such step.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_robustness_tpu import build_masks as j_build_masks
from multimodal_transformer_robustness_tpu import config as jcfg
from multimodal_transformer_robustness_tpu.checkpoint import export_torch_state_dict
from multimodal_transformer_robustness_tpu.models import bert as jbert
from multimodal_transformer_robustness_tpu.models import init_supernet as j_init
from multimodal_transformer_robustness_tpu.models import supernet_apply as j_apply
from multimodal_transformer_robustness_tpu.models import supernet_headers as j_headers
from multimodal_transformer_robustness_tpu.ops import bert_attn_pallas, bert_ffn_pallas
from multimodal_transformer_robustness_tpu.ops import bigru_pallas
from multimodal_transformer_robustness_tpu.ops import gru as jgru
from multimodal_transformer_robustness_tpu.train.sampling import sample_train_config
from multimodal_transformer_robustness_tpu_torch import config as tcfg
from multimodal_transformer_robustness_tpu_torch.masks import build_masks as t_build_masks
from multimodal_transformer_robustness_tpu_torch.models import bert as tbert
from multimodal_transformer_robustness_tpu_torch.models import supernet_apply as t_apply
from multimodal_transformer_robustness_tpu_torch.models import supernet_headers as t_headers
from multimodal_transformer_robustness_tpu_torch.weights import load_reference_state_dict

TOL = dict(atol=1e-4, rtol=1e-4)
_SPEC = dict(modality_set=("t", "a", "v"), orig_dimensions=(128, 10, 12),
             dimension=8, num_heads=2, head_dim=4, layers_single_attn=2,
             layers_cross_attn=2, layers_self_attn=1,
             attn_dropout=(0.1, 0.1, 0.0, 0.0), relu_dropout=0.1,
             res_dropout=0.1, out_dropout=0.1, embed_dropout=0.3,
             attn_mask=True, output_dim=1)
_IMPLS = ("xla", "pallas_interpret")


@pytest.fixture(scope="module")
def slice_case():
    js, ts = jcfg.ModelSpec(**_SPEC), tcfg.ModelSpec(**_SPEC)
    jb_cfg = jbert.tiny_bert_config(hidden=128, heads=2, layers=2)
    tb_cfg = tbert.tiny_bert_config(hidden=128, heads=2, layers=2)
    # eager init: at this size it is faster than compiling the init program
    params, frozen = j_init(jax.random.PRNGKey(0), js, bert_cfg=jb_cfg, use_jit=False)
    sd = export_torch_state_dict(js, params)
    bert_np = jax.tree.map(np.asarray, frozen["bert"])
    t_params, t_frozen = load_reference_state_dict(ts, sd, bert_np)

    rng = np.random.default_rng(0)
    B, L = 2, 8
    attn = np.ones((B, L), np.int64)
    attn[1, 5:] = 0
    # [input_ids, token_type_ids, attention_mask], as the collate stacks them
    text = np.stack([rng.integers(0, jb_cfg.vocab_size, (B, L)) * attn,
                     np.zeros((B, L), np.int64), attn])
    audio = rng.standard_normal((B, 6, 10)).astype(np.float32)
    vision = rng.standard_normal((B, 5, 12)).astype(np.float32)
    audio[1, 4:] = 0.0                                  # zero-padded bucket steps

    cfg_rng = np.random.default_rng(1)
    cfgs = [jcfg.full_active_config(js)] + [
        sample_train_config(js, "random_sample", None, cfg_rng) for _ in range(3)]

    def make_fwd():
        # a new function per implementation: jit caches traces per function,
        # and the implementation flags are read when it traces
        def fwd(params, masks, frozen, inputs):
            return j_apply(js, params, masks, inputs, frozen=frozen, bert_cfg=jb_cfg,
                           train=False)
        return jax.jit(fwd)

    return dict(
        js=js, ts=ts, jb_cfg=jb_cfg, tb_cfg=tb_cfg, params=params, frozen=frozen,
        sd=sd, t_params=t_params, t_frozen=t_frozen, cfgs=cfgs,
        j_inputs=[jnp.asarray(text, jnp.int32), jnp.asarray(audio), jnp.asarray(vision)],
        t_inputs=[torch.from_numpy(text), torch.from_numpy(audio), torch.from_numpy(vision)],
        fwd={impl: make_fwd() for impl in _IMPLS},
        seen=set(),
        headers={impl: jax.jit(functools.partial(j_headers, js, frozen=frozen,
                                                 bert_cfg=jb_cfg)) for impl in _IMPLS})


def _use_impl(monkeypatch, impl, seen):
    """Switch the JAX side to its Pallas kernels in interpret mode and record
    each kernel it traces, so a test can check they really ran."""
    if impl != "pallas_interpret":
        return
    monkeypatch.setattr(jgru, "RECURRENCE_IMPL", "pallas_interpret")
    monkeypatch.setattr(jbert, "FFN_INTERPRET", True)
    for mod, name in ((bigru_pallas, "_fwd_impl"), (bert_attn_pallas, "attention_block_fused"),
                      (bert_ffn_pallas, "ffn_ln_block")):
        def spy(*a, _orig=getattr(mod, name), _name=name, **k):
            seen.add(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(mod, name, spy)


def _check_kernels_ran(impl, seen):
    if impl == "pallas_interpret":
        assert seen == {"_fwd_impl", "attention_block_fused", "ffn_ln_block"}


@pytest.mark.parametrize("impl", _IMPLS)
def test_headers_match(slice_case, impl, monkeypatch):
    c = slice_case
    _use_impl(monkeypatch, impl, c["seen"])
    ref = c["headers"][impl](c["params"], c["j_inputs"])
    _check_kernels_ran(impl, c["seen"])
    with torch.inference_mode():
        out = t_headers(c["ts"], c["t_params"], c["t_inputs"], frozen=c["t_frozen"],
                        bert_cfg=c["tb_cfg"])
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("cfg_idx", range(4))
@pytest.mark.parametrize("impl", _IMPLS)
def test_supernet_apply_matches(slice_case, impl, cfg_idx, monkeypatch):
    c = slice_case
    _use_impl(monkeypatch, impl, c["seen"])
    cfg = c["cfgs"][cfg_idx]
    ref = c["fwd"][impl](c["params"], j_build_masks(c["js"], cfg), c["frozen"],
                         c["j_inputs"])
    _check_kernels_ran(impl, c["seen"])
    t_masks = t_build_masks(c["ts"], tcfg.ActiveConfig(**dataclasses.asdict(cfg)))
    with torch.inference_mode():
        out = t_apply(c["ts"], c["t_params"], t_masks, c["t_inputs"],
                      frozen=c["t_frozen"], bert_cfg=c["tb_cfg"])
    assert out.shape == ref.shape and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_train_mode_runs(slice_case):
    """Train mode with the spec's nonzero dropout rates: finite predictions
    of the eval shape, repeatable from the generator's seed."""
    c = slice_case
    masks = t_build_masks(c["ts"], tcfg.full_active_config(c["ts"]))

    def run():
        return t_apply(c["ts"], c["t_params"], masks, c["t_inputs"], frozen=c["t_frozen"],
                       bert_cfg=c["tb_cfg"], train=True,
                       generator=torch.Generator().manual_seed(0))

    out = run()
    assert out.shape == (2, 1) and torch.isfinite(out).all()
    torch.testing.assert_close(out, run(), atol=0, rtol=0)


def test_model_path_loads_reference_state_dict(slice_case, tmp_path):
    """``--model_path *.pt``: a reference-named state dict of tensors loads
    into the predictor's parameters, operand layouts included."""
    from multimodal_transformer_robustness_tpu_torch.cli.realtime import StreamingPredictor

    c = slice_case
    path = tmp_path / "model.pt"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in c["sd"].items()}, path)
    pred = StreamingPredictor(model_path=str(path), spec=c["ts"], bert_cfg=c["tb_cfg"],
                              device="cpu")

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, list):
            return [x for v in tree for x in leaves(v)]
        return [tree]

    ours, ref = leaves(pred.params), leaves(c["t_params"])
    assert len(ours) == len(ref) > 100
    for a, b in zip(ours, ref):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# ------------------------------------------------------------ serving entry

_TINY = dict(modality_set=("t", "a", "v"), orig_dimensions=(6, 10, 12),
             dimension=8, num_heads=2, head_dim=4, layers_single_attn=1,
             layers_cross_attn=1, layers_self_attn=1,
             attn_dropout=(0.0, 0.0, 0.0, 0.0), relu_dropout=0.0,
             res_dropout=0.0, out_dropout=0.0, embed_dropout=0.0,
             attn_mask=True, output_dim=1)


def test_streaming_predictor_cpu():
    """prepare() gives the JAX predictor's arrays; predict() is finite across
    bucket boundaries."""
    from multimodal_transformer_robustness_tpu.cli.realtime import \
        StreamingPredictor as JPredictor
    from multimodal_transformer_robustness_tpu_torch.cli.realtime import (
        StreamingPredictor, _bucket)

    pred = StreamingPredictor(spec=tcfg.ModelSpec(**_TINY),
                              bert_cfg=tbert.tiny_bert_config(), device="cpu")
    # prepare() is host-side only: a JAX predictor without its (jitted) model
    from multimodal_transformer_robustness_tpu.data.tokenizer import load_tokenizer

    jpred = object.__new__(JPredictor)
    jpred.spec, jpred.bert_cfg = jcfg.ModelSpec(**_TINY), jbert.tiny_bert_config()
    jpred.tokenizer = load_tokenizer(None)
    rng = np.random.default_rng(0)
    for words, ta, tv in (("a tiny transcript", 5, 3), ("x", 13, 9),
                          (" ".join(["w"] * 20), 40, 24)):
        audio = rng.standard_normal((1, ta, 10)).astype(np.float32)
        face = rng.standard_normal((1, tv, 12)).astype(np.float32)
        ours = pred.prepare(words.split(), audio, face)
        theirs = jpred.prepare(words.split(), audio, face)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
        assert ours[1].shape[1] == _bucket(ta) and ours[2].shape[1] == _bucket(tv)
        assert np.isfinite(pred.forward(*ours))


@pytest.mark.parametrize("kwargs", [dict(attn_impl="flash"), dict(bert_dir="/nonexistent")])
def test_streaming_predictor_unported_options_raise(kwargs):
    """``attn_impl`` with a caller's own spec raises, as in the JAX package
    (it feeds the default MOSEI spec only); ``--bert_dir`` waits for the
    checkpoint port."""
    from multimodal_transformer_robustness_tpu_torch.cli.realtime import StreamingPredictor

    error, match = ((ValueError, "default ModelSpec") if "attn_impl" in kwargs
                    else (NotImplementedError, "ROADMAP"))
    with pytest.raises(error, match=match):
        StreamingPredictor(spec=tcfg.ModelSpec(**_TINY),
                           bert_cfg=tbert.tiny_bert_config(), **kwargs)


def test_port_never_imports_jax():
    """Every module of the port imports in a fresh interpreter without
    pulling JAX in."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import multimodal_transformer_robustness_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert len(names) >= 20, names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m.startswith('multimodal_transformer_robustness_tpu.')\n"
        "             or m == 'multimodal_transformer_robustness_tpu')\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_realtime_helpers_match(tmp_path):
    from multimodal_transformer_robustness_tpu.cli import realtime as jrt
    from multimodal_transformer_robustness_tpu_torch.cli import realtime as trt

    assert [trt._bucket(n) for n in (1, 8, 9, 40, 300)] == \
        [jrt._bucket(n) for n in (1, 8, 9, 40, 300)]
    labels = ["-", "a", "b", "c"]
    emission = np.eye(4, dtype=np.float32)[[1, 1, 0, 2, 2, 3, 0, 3]]
    assert trt.GreedyCTCDecoder(labels)(emission) == \
        jrt.GreedyCTCDecoder(labels)(emission) == "abcc"
    np.save(tmp_path / "face.npy", np.ones((1, 3, 16), np.float32))
    np.save(tmp_path / "audio.npy", np.full((1, 5, 8), 2.0, np.float32))
    args = (str(tmp_path / "face.npy"), str(tmp_path / "audio.npy"), "hello world")
    for ours, theirs in zip(trt.precomputed_extractors(*args),
                            jrt.precomputed_extractors(*args)):
        a, b = ours("ignored"), theirs("ignored")
        if isinstance(a, tuple):
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1] == b[1]
        else:
            np.testing.assert_array_equal(a, b)


def test_realtime_cli_serves_on_cpu(capsys):
    """The CLI's default model (the MOSEI serving configuration) answers two
    synthetic clips on the CPU; unported extractors raise."""
    from multimodal_transformer_robustness_tpu_torch.cli.realtime import main

    pred = main(["--features", "synthetic", "--repeat", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("sentiment:") == 2 and pred.spec.dimension == 200
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(["--features", "torch", "--device", "cpu"])
