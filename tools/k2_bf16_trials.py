"""Timing variants of the persistent bf16 kernel's epilogue under K2.bf16
(the frozen BERT's attention block), K6b.bf16 (its tail alone) and
K3.bf16 (the FFN block) at the training path's shape (B=4096 L=32, h=768,
ffn=3072), beside the parent's plans.

K2.bf16's q/k/v product and its o-projection (K6b.bf16's) run 12 k tiles
a 128 x 192 tile, a quarter of fc2's 48, so the epilogue warps' turn at
each tile (read the staging tile, add the residual, store) is not hidden
behind the MMAs as fc2's is.  Each variant is ``csrc/`` with text edits to
``gemm_bf16.cuh`` (none for ``base`` and ``parent``; ``parent`` takes
``chip_smoke.parent_plans()``: the 128 x 128 wgmma tiles with the
weights' transposes, the LayerNorm a block a row), built from
``bert_attn.cu`` and from ``bert_ffn.cu`` by ``nvcc`` into
``build/k2_bf16_trials/<variant>/``, all builds started together, and run
through the public wrappers with those libraries: CUDA-event ms (median of
10 warm runs), device ms by kernel (torch.profiler), the largest error
against the bf16 plain version over max |ref|, and the persistent kernel's
ptxas report.  ``base`` (this tree) loads the residual half a tile's
pieces ahead of its use; ``resid_late`` loads each piece's residual as it
is stored (the first design); ``resid_all`` all of them before the
staging tile is waited for; ``release_early`` copies its pieces of the
staging tile into registers and hands the tile back before it stores;
``no_epilogue`` hands the staging tile over and writes nothing (the
products' and the handoff's time alone; it then computes something
else).  ``base`` runs first and
last, so drift shows.

    PYTHONPATH=. python3 tools/k2_bf16_trials.py [--variants base,resid_late,...]

Needs one H100 and nvcc; the edits must match the source, or the script
stops before building.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib.util
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from multimodal_transformer_robustness_tpu_torch import _build
from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda, bert_ffn_cuda

ROOT = Path(__file__).resolve().parent.parent
OUT = _build.BUILD_DIR.parent / "k2_bf16_trials"
GEMM = "gemm_bf16.cuh"
UNITS = {"bert_attn.cu": ("mmtr_attn_block_fwd_bf16",),
         "bert_ffn.cu": ("mmtr_proj_ln_fwd_bf16", "mmtr_ffn_ln_fwd_bf16")}

_AHEAD_USE = ("          xv = ahead[j % RESID_AHEAD];\n"
              "          if (j + RESID_AHEAD < PIECES) ahead[j % RESID_AHEAD] = "
              "resid_piece(j + RESID_AHEAD);\n")
_AHEAD_LOAD = "        for (int j = 0; j < RESID_AHEAD; ++j) ahead[j] = resid_piece(j);\n"
_STORE_LOOP = ("      bp_bar_sync(BP_BAR_FULL, BP_HANDOFF);\n#pragma unroll\n"
               "      for (int j = 0; j < PIECES; ++j) {\n")
_RELEASE = ("      bp_bar_sync(BP_BAR_FULL, BP_HANDOFF);\n"
            "      uint4 sv[PIECES];\n#pragma unroll\n"
            "      for (int j = 0; j < PIECES; ++j) {\n"
            "        const int p = et + j * BP_EPI_THREADS, r = p / PER_ROW, "
            "cc = 8 * (p - r * PER_ROW);\n"
            "        sv[j] = *reinterpret_cast<const uint4*>(staged + r * BP_LDS + cc);\n"
            "      }\n"
            "      if (t + (int)gridDim.x < tiles) bp_bar_arrive(BP_BAR_EMPTY, BP_HANDOFF);\n"
            "#pragma unroll\n      for (int j = 0; j < PIECES; ++j) {\n")
_ARRIVE_END = ("      if (t + (int)gridDim.x < tiles) bp_bar_arrive(BP_BAR_EMPTY, BP_HANDOFF);\n"
               "    }\n  }\n}\n")

# name -> [(file, pattern, replacement, expected matches)]; patterns are
# regular expressions (re.M), replacements literal text
VARIANTS = {
    "base": [],
    "parent": [],
    "resid_late": [(GEMM, re.escape(_AHEAD_USE), "          xv = resid_piece(j);\n", 1),
                   (GEMM, re.escape(_AHEAD_LOAD), "", 1)],
    "resid_all": [(GEMM, re.escape("constexpr int RESID_AHEAD = PIECES / 2;"),
                   "constexpr int RESID_AHEAD = PIECES;", 1)],
    "release_early": [
        (GEMM, re.escape(_STORE_LOOP), _RELEASE, 1),
        (GEMM, re.escape("        const uint4 v = *reinterpret_cast<const uint4*>"
                         "(staged + r * BP_LDS + cc);"), "        const uint4 v = sv[j];", 1),
        (GEMM, re.escape(_ARRIVE_END), "    }\n  }\n}\n", 1)],
    "no_epilogue": [(GEMM, re.escape(_STORE_LOOP),
                     _STORE_LOOP.replace("j < PIECES", "j < 0"), 1)],
}


def edited(name: str, csrc: Path = _build._CSRC) -> dict:
    """{file: text} of ``csrc``'s files with the variant's edits, each
    checked to match its stated number of times (SystemExit where not)."""
    texts = {}
    for fname, pattern, repl, count in VARIANTS[name]:
        text = texts.get(fname) or (csrc / fname).read_text()
        text, n = re.subn(pattern, lambda _m, r=repl: r, text, flags=re.M)
        if n != count:
            raise SystemExit(f"{name}: {pattern[:60]!r} matched {n} times in {fname}, "
                             f"not {count}")
        texts[fname] = text
    return texts


def _source(name: str) -> Path:
    src = OUT / name / "csrc"
    texts = edited(name)
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build._CSRC, src)
    for fname, text in texts.items():
        (src / fname).write_text(text)
    return src


def build(names):
    """Two nvcc a variant (bert_attn.cu, bert_ffn.cu), all started together:
    {name: (an object with the three entries, ptxas report)}."""
    procs = {}
    for name in names:
        src = _source(name)
        for unit in UNITS:
            so = OUT / name / f"{unit.split('.')[0]}.so"
            procs[name, unit] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(src / unit)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (name, unit), (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name} {unit}: nvcc failed\n{log}")
        lines = log.splitlines()
        report = [" ".join(x.split(":")[-1].strip() for x in lines[at + 1:at + 5]
                           if "stack frame" in x or "registers" in x)
                  for at, line in enumerate(lines)
                  if "Compiling entry" in line and "persistent" in line]
        lib = ctypes.CDLL(str(so))
        entries, reports = libs.setdefault(name, (_Lib(), []))
        for entry in UNITS[unit]:
            fn = getattr(lib, entry)
            fn.restype, fn.argtypes = _build._SIGNATURES[entry]
            setattr(entries, entry, fn)
        entries.keep.append(lib)
        reports += report
    return libs


class _Lib:
    """What the bf16 wrappers of K2, K6b and K3 read of ``_build.load_library()``."""

    def __init__(self):
        self.keep = []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    libs = build(dict.fromkeys(names + ["base"]))
    rng = np.random.default_rng(3)
    B, L, h, ffn, heads = 4096, 32, 768, 3072, 12

    def t(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(
            dev, torch.bfloat16)

    x = t((B, L, h))
    wqkv, bqkv = t((3, h, h), 0.02), t((3 * h,), 0.02)
    wo, bo = t((h, h), 0.02), t((h,), 0.02)
    g, b = (1.0 + t((h,), 0.1).float()).to(torch.bfloat16), t((h,), 0.1)
    mask = np.zeros((B, L), np.float32)
    for i in range(B):
        mask[i, : rng.integers(1, L + 1)] = 1.0
    mask = torch.from_numpy(mask).to(dev)
    a_args = (x, mask, wqkv[0], bqkv[:h], wqkv[1], bqkv[h:2 * h], wqkv[2], bqkv[2 * h:], wo, bo,
              g, b)
    p_args = (x, t((B, L, h)), wo, bo, g, b)
    f_args = (x, t((h, ffn), 0.02), t((ffn,), 0.02), t((ffn, h), 0.02), t((h,), 0.02), g, b)
    cases = {
        "K2.bf16": (lambda: bert_attn_cuda.attention_block_fused(*a_args, n_heads=heads,
                                                                 eps=1e-12),
                    bert_attn_cuda.attention_block_plain(*a_args, n_heads=heads, eps=1e-12)),
        "K6b.bf16": (lambda: bert_ffn_cuda.proj_ln_block(*p_args, eps=1e-12),
                     bert_ffn_cuda.proj_ln_block_plain(*p_args, eps=1e-12)),
        "K3.bf16": (lambda: bert_ffn_cuda.ffn_ln_block(*f_args, eps=1e-12),
                    bert_ffn_cuda.ffn_ln_block_plain(*f_args, eps=1e-12))}
    caches = (bert_attn_cuda._cached_block_plan_bf16, bert_ffn_cuda._cached_proj_ln_plan_bf16,
              bert_ffn_cuda._cached_ffn_plan_bf16)
    main_lib = _build.load_library
    for name in ["base"] + [n for n in names if n != "base"] + ["base"]:
        lib, report = libs[name]
        _build.load_library = lambda lib=lib: lib
        for cache in caches:
            cache.cache_clear()
        row = {"variant": name, "ptxas": report}
        try:
            with cs.parent_plans() if name == "parent" else contextlib.nullcontext():
                for kid, (fn, ref) in cases.items():
                    got = fn().float()
                    torch.cuda.synchronize()
                    err = ((got - ref.float()).abs().max() / ref.float().abs().max()).item()
                    row[kid] = {"ms": cs.cuda_ms(fn, 10), "max_err": err,
                                "kernels_ms": cs.profile_ms(fn, 10)}
        finally:
            _build.load_library = main_lib
            for cache in caches:
                cache.cache_clear()
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
