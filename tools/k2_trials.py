"""K2 with and without promoted tensor-core sums: its error against the plain
version and its time at ``chip_smoke.py``'s K2 shapes.

Each variant is ``csrc/`` with text edits to ``bert_attn.cu`` (none for
``base``, whose products sum unpromoted, as ``K2_PROMOTE = 0`` says), built
alone by ``nvcc`` into ``build/k2_trials/<variant>/``, all builds started
together, and run through ``ops.bert_attn_cuda.attention_block_fused`` with
that library: at B=1 and 8 with L in {8, 32, 128, 512} and at B=4096 L=32,
BERT-base width, weights at HF's init scale and the q/k/v weights as views
of one stacked tensor, ragged key masks (B=1: all keys masked, as serving
makes them), inputs from a fixed seed.  Per shape: the largest absolute
error against ``attention_block_plain`` (K2's tolerance is 1e-3), and at
B=1 L=8, B=1 L=512 and B=4096 L=32 the CUDA-event ms (median of 20, or 5
at B=4096) and device ms by kernel (torch.profiler).  ``base`` runs first
and last, so drift shows.

    PYTHONPATH=. python3 tools/k2_trials.py [--variants base,promote8]

Needs one H100 and nvcc; the edits must match the source, or the script
stops before building.
"""

from __future__ import annotations

import argparse
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
from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda, gemm_tc

ROOT = Path(__file__).resolve().parent.parent
OUT = _build.BUILD_DIR.parent / "k2_trials"
SHAPES = ((1, 8), (1, 32), (1, 128), (1, 512), (8, 8), (8, 32), (8, 128), (8, 512),
          (4096, 32))
TIMED = ((1, 8), (1, 512), (4096, 32))

# name -> ([(file, pattern, replacement, expected matches)], K2's wgmma widths)
VARIANTS = {
    "base": ([], gemm_tc.WG_WIDTHS),
    "promote8": ([("bert_attn.cu", r"constexpr int K2_PROMOTE = 0;",
                   "constexpr int K2_PROMOTE = 8;", 1)], gemm_tc.PROMOTED_WIDTHS),
}


def _source(name: str) -> Path:
    """A copy of csrc/ with the variant's edits, checked to match."""
    src = OUT / name / "csrc"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build._CSRC, src)
    for fname, pattern, repl, count in VARIANTS[name][0]:
        path = src / fname
        text, n = re.subn(pattern, repl, path.read_text(), flags=re.M)
        if n != count:
            raise SystemExit(f"{name}: {pattern!r} matched {n} times in {fname}, not {count}")
        path.write_text(text)
    return src


def build(names):
    """One nvcc a variant, all started together: {name: (library, ptxas report)}."""
    procs = {}
    for name in names:
        src = _source(name)
        so = OUT / name / "k2.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
             str(src / "bert_attn.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lines = log.splitlines()
        report = [" ".join(x.split(":")[-1].strip() for x in lines[at + 1:at + 5]
                           if "stack frame" in x or "registers" in x)
                  for at, line in enumerate(lines)
                  if "Compiling entry" in line and "gemm_wgmma_kernelILi128" in line]
        lib = ctypes.CDLL(str(so))
        fn = lib.mmtr_attn_block_fwd
        fn.restype, fn.argtypes = _build._SIGNATURES["mmtr_attn_block_fwd"]
        libs[name] = (fn, report)
    return libs


class _Lib:
    """What ``attention_block_fused`` reads of ``_build.load_library()``."""

    def __init__(self, fn):
        self.mmtr_attn_block_fwd = fn


def cases(dev, rng, h=768):
    """(B, L, operands) at SHAPES, weights as chip_smoke.check_kernels makes
    them but with q/k/v stacked as models/bert.prepare_bert stacks them."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    wqkv, bqkv = t(rng.standard_normal((3, h, h)) * 0.02), t(rng.standard_normal(3 * h) * 0.02)
    wo, bo = t(rng.standard_normal((h, h)) * 0.02), t(rng.standard_normal(h) * 0.02)
    g, b = t(1.0 + 0.1 * rng.standard_normal(h)), t(0.1 * rng.standard_normal(h))
    out = []
    for B, L in SHAPES:
        mask = np.zeros((B, L), np.float32)
        for i in range(1, B):
            mask[i, : rng.integers(1, L + 1)] = 1.0
        out.append((B, L, (t(rng.standard_normal((B, L, h))), t(mask), wqkv[0], bqkv[:h],
                           wqkv[1], bqkv[h:2 * h], wqkv[2], bqkv[2 * h:], wo, bo, g, b)))
    return out


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
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    main_lib = _build.load_library
    libs = build(dict.fromkeys(names + ["base"]))
    shapes = cases(dev, np.random.default_rng(0))
    refs = [bert_attn_cuda.attention_block_plain(*a, n_heads=12, eps=1e-12)
            for _, _, a in shapes]
    for name in ["base"] + [n for n in names if n != "base"] + ["base"]:
        fn, report = libs[name]
        bert_attn_cuda._K2_WIDTHS = VARIANTS[name][1]
        bert_attn_cuda._cached_block_plan.cache_clear()
        _build.load_library = lambda fn=fn: _Lib(fn)
        row = {"variant": name, "ptxas_wgmma128": report, "max_abs_err": {}}
        for (B, L, a), ref in zip(shapes, refs):
            def call(a=a):
                return bert_attn_cuda.attention_block_fused(*a, n_heads=12, eps=1e-12)
            out = call()
            torch.cuda.synchronize()
            row["max_abs_err"][f"B={B} L={L}"] = (out - ref).abs().max().item()
            if (B, L) in TIMED:
                it = 5 if B > 8 else 20
                row[f"B={B} L={L}"] = {"ms": cs.cuda_ms(call, it),
                                       "kernels_ms": cs.profile_ms(call, it)}
        _build.load_library = main_lib
        print(json.dumps(row), flush=True)
    bert_attn_cuda._K2_WIDTHS = VARIANTS["base"][1]
    return 0


if __name__ == "__main__":
    sys.exit(main())
