"""Timing variants of K4, the int8 FFN block, side by side (``row_blocks``:
the row quantization a block a row also for x's short rows), at the
training path's B=4096 L=32 and the serving B=1 L=8.

Each variant is ``csrc/`` with text edits to ``bert_ffn_q.cu`` (none for
``base``), built alone by ``nvcc`` into ``build/k4_trials/<variant>/``,
all builds started together, and run through
``ops.bert_ffn_cuda.ffn_ln_block_q`` with that library on inputs from a
fixed seed (BERT-base width, HF-scale weights quantized as
``models.bert._quantize`` does): CUDA-event ms (median of 5 at B=4096, 20
at B=1) and device ms by kernel (torch.profiler), and whether the output,
hidden codes and scales equal the ``base`` variant's bit for bit.  ``base``
runs first and last, so drift shows.  Then K4's two products alone, with
the main build: ``int8_matmul`` (the int32 sums, no epilogue) and ``qdot``
(+ the dequant and bias epilogue) at GEMM1's and GEMM2's shapes, beside
``torch._int_mm``, cuBLAS's int8 GEMM (a yardstick only: the port never
calls it), in CUDA-event ms and int8 TOP/s.

    PYTHONPATH=. python3 tools/k4_trials.py [--variants base,row_blocks]

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
from multimodal_transformer_robustness_tpu_torch.models.bert import _quantize
from multimodal_transformer_robustness_tpu_torch.ops import bert_ffn_cuda

ROOT = Path(__file__).resolve().parent.parent
OUT = _build.BUILD_DIR.parent / "k4_trials"
SRC = "bert_ffn_q.cu"

_ROW_BLOCKS = [(SRC, r"if \(n <= 4 \* Q_VECS \* 64\)", "if (false)", 1)]

# name -> [(file, pattern, replacement, expected matches)]
VARIANTS = {
    "base": [],
    "row_blocks": _ROW_BLOCKS,     # a block a row also for x's short rows
}


def _source(name: str) -> Path:
    """A copy of csrc/ with the variant's edits, checked to match."""
    src = OUT / name / "csrc"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build._CSRC, src)
    for fname, pattern, repl, count in VARIANTS[name]:
        path = src / fname
        text, n = re.subn(pattern, repl, path.read_text(), flags=re.M)
        if n != count:
            raise SystemExit(f"{name}: {pattern!r} matched {n} times in {fname}, not {count}")
        path.write_text(text)
    return src


def build(names):
    """One nvcc a variant, all started together: {name: entry point}."""
    procs = {}
    for name in names:
        so = OUT / name / "k4.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
             str(_source(name) / SRC)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        fn = ctypes.CDLL(str(so)).mmtr_ffn_ln_q_fwd
        fn.restype, fn.argtypes = _build._SIGNATURES["mmtr_ffn_ln_q_fwd"]
        fns[name] = fn
    return fns


class _Lib:
    """What ``ffn_ln_block_q`` reads of ``_build.load_library()``."""

    def __init__(self, fn):
        self.mmtr_ffn_ln_q_fwd = fn


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
    main_lib = _build.load_library
    fns = build(dict.fromkeys(names + ["base"]))
    rng = np.random.default_rng(5)
    h, ffn = 768, 3072

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    w1q, w2q = (_quantize(t(rng.standard_normal(s) * 0.02)) for s in ((ffn, h), (h, ffn)))
    b1, b2 = t(rng.standard_normal(ffn) * 0.02), t(rng.standard_normal(h) * 0.02)
    g, b = t(1.0 + 0.1 * rng.standard_normal(h)), t(0.1 * rng.standard_normal(h))
    shapes = [(B, L, (t(rng.standard_normal((B, L, h))), w1q, b1, w2q, b2, g, b))
              for B, L in ((4096, 32), (1, 8))]
    first = {}
    for name in ["base"] + [n for n in names if n != "base"] + ["base"]:
        _build.load_library = lambda fn=fns[name]: _Lib(fn)
        row = {"variant": name}
        for B, L, k in shapes:
            def call(k=k):
                return bert_ffn_cuda.ffn_ln_block_q(*k, eps=1e-12)
            got = bert_ffn_cuda.ffn_ln_block_q(*k, eps=1e-12, return_codes=True)
            torch.cuda.synchronize()
            first.setdefault((B, L), got)
            it = 5 if B > 1 else 20
            row[f"B={B} L={L}"] = {
                "ms": cs.cuda_ms(call, it), "kernels_ms": cs.profile_ms(call, it),
                "bits_as_base": all(torch.equal(a, r) for a, r in zip(got, first[(B, L)]))}
            del got
        _build.load_library = main_lib
        print(json.dumps(row), flush=True)
    for M, N, K in ((131072, ffn, h), (131072, h, ffn)):
        a = torch.from_numpy(rng.integers(-127, 128, (M, K)).astype(np.int8)).to(dev)
        w = torch.from_numpy(rng.integers(-127, 128, (N, K)).astype(np.int8)).to(dev)
        sx, wq = torch.rand(M, 1, device=dev), {"q": w, "s": torch.rand(N, device=dev)}
        bias = torch.rand(N, device=dev)
        times = {"int8_matmul": cs.cuda_ms(lambda: bert_ffn_cuda.int8_matmul(a, w), 5),
                 "qdot": cs.cuda_ms(lambda: bert_ffn_cuda.qdot(a, sx, wq, bias), 5),
                 "torch._int_mm": cs.cuda_ms(lambda: torch._int_mm(a, w.t()), 5)}
        print(json.dumps({"products": f"M={M} N={N} K={K}", "ms": times,
                          "tops": {k: 2 * M * N * K / v / 1e9 for k, v in times.items()}}),
              flush=True)
        del a, w
    return 0


if __name__ == "__main__":
    sys.exit(main())
