"""Timing variants of K1b, the GRU direction backward: which part holds it,
what the reductions' promotion of their tensor-core sums buys in accuracy
and costs in time, and another reduction tile, at the training path's
shapes.

Each variant is ``csrc/`` with text edits to ``gemm_tc.cuh`` or
``gru_rec.cuh`` (none for ``base``) and, where it changes a tile, the
matching constants of ``ops/gemm_tc.py`` for the launch plan.  Each is
built alone from ``bigru_bwd.cu`` by ``nvcc`` into
``build/k1b_trials/<variant>/``, all builds started together, and run
through ``ops.bigru_cuda.gru_dir_bwd`` with that library at in=768 and 512
without dx and in=200 with it (B=4096, T=50, H=100; chip_smoke's
``k1b_split_cases``): CUDA-event ms (median of 5 warm runs), device ms by
kernel (torch.profiler), and the largest error against the plain backward
over max |ref|, gradient by gradient (the ``no_*`` variants drop work, so their
errors only say that they computed something else).  ``base`` runs first
and last, so drift shows.

    PYTHONPATH=. python3 tools/k1b_trials.py [--variants base,no_promote,...]

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
from multimodal_transformer_robustness_tpu_torch.ops import bigru_cuda, gemm_tc

ROOT = Path(__file__).resolve().parent.parent
OUT = _build.BUILD_DIR.parent / "k1b_trials"
GEMM, REC = "gemm_tc.cuh", "gru_rec.cuh"

_BN64 = ([(GEMM, r"using TcTn = TcTile<128, 80, 2, 2>;",
            "using TcTn = TcTile<128, 64, 2, 2>;", 1)], {"TN_BN": 64, "TN_LDB": 72})
_NO_PROMOTE = [(GEMM, r"constexpr int TN_PROMOTE = 4;",
                "constexpr int TN_PROMOTE = 1 << 30;", 1)]

# name -> ([(file, pattern, replacement, expected matches)], {gemm_tc constant: value})
VARIANTS = {
    "base": ([], {}),
    "no_promote": (_NO_PROMOTE, {}),
    "tn_bn64": _BN64,
    "tn_bn64_no_promote": (_BN64[0] + _NO_PROMOTE, _BN64[1]),
    "no_recompute": ([(REC, r"for \(int k = 0; k < H; \+\+k\) \{(\n\s*const float4 hv)",
                       r"for (int k = 0; k < 0; ++k) {\1", 1)], {}),
    "no_carry": ([(REC, r"for \(int j = 0; j < H; \+\+j\) \{(\n\s*const float4 dv)",
                   r"for (int j = 0; j < 0; ++j) {\1", 1)], {}),
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
        so = OUT / name / "k1b.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
             str(src / "bigru_bwd.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lines = log.splitlines()
        report = []
        for at, line in enumerate(lines):
            if "Compiling entry" in line and ("gemm_tc_tn" in line or "gru_rec_bwd" in line):
                report.append(" ".join(x.split(":")[-1].strip() for x in lines[at + 1:at + 5]
                                       if "stack frame" in x or "registers" in x))
        lib = ctypes.CDLL(str(so))
        fn = lib.mmtr_gru_dir_bwd
        fn.restype, fn.argtypes = _build._SIGNATURES["mmtr_gru_dir_bwd"]
        libs[name] = (lib, report)
    return libs


class _Lib:
    """What ``gru_dir_bwd`` reads of ``_build.load_library()``."""

    def __init__(self, lib):
        self.mmtr_gru_dir_bwd = lib.mmtr_gru_dir_bwd


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
    main_lib = _build.load_library()
    libs = build(dict.fromkeys(names + ["base"]))
    cases = cs.k1b_split_cases(dev, np.random.default_rng(1))
    refs = []
    for _, fn, _ in cases:   # the plain backward, from the same inputs
        cl = fn.__defaults__
        refs.append(bigru_cuda.gru_dir_bwd_plain(cl[0], *cl[1], cl[2], cl[3], cl[4], False,
                                                 cl[5]))
    defaults = {k: getattr(gemm_tc, k) for k in ("TN_BN", "TN_LDB")}
    for name in ["base"] + [n for n in names if n != "base"] + ["base"]:
        lib, report = libs[name]
        for k, v in {**defaults, **VARIANTS[name][1]}.items():
            setattr(gemm_tc, k, v)
        bigru_cuda._cached_bwd_plan.cache_clear()
        _build.load_library = lambda lib=lib: _Lib(lib)
        row = {"variant": name, "ptxas": report}
        for (shape, fn, iters), ref in zip(cases, refs):
            got = fn()
            torch.cuda.synchronize()
            err = {n: ((a - r).abs().max() / r.abs().max()).item()
                   for n, a, r in zip(("dx", "dwp", "dwt", "dbc", "dbhn"), got, ref)
                   if r is not None}
            per = cs.profile_ms(fn, iters)
            row[shape] = {"ms": cs.cuda_ms(fn, iters), "max_err": err,
                          "kernels_ms": {k: v for k, v in per.items() if v > 0.01}}
        _build.load_library = lambda: main_lib
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
