"""Timing variants of K1f's bf16 instance, the GRU direction forward, at the
training path's shape (in=768, T=50, B=4096, H=100): which part of the
recurrence's mma form or of the projection's 128 x 304 tile holds them,
another split of a row group's tiles over warps, and the parent's tiled
recurrence and 128-wide projection tiles.

Each variant is ``csrc/`` with text edits to ``gru_rec.cuh`` or
``bigru.cu`` (none for ``base``) and, where it changes the split, the matching constants of
``ops/bigru_cuda.py`` for the launch plan, and a change to the plan itself:
``tiled`` forces the tiled recurrence (``rec_mma`` 0), ``proj128``
gemm_bf16.cuh's 128-wide wgmma tiles (``gemm_wgmma`` 1), ``parent`` both.
Each is built alone from ``bigru.cu`` by ``nvcc`` into
``build/k1f_bf16_trials/<variant>/``, all builds started together, and run
through ``ops.bigru_cuda.gru_dir`` with that library: CUDA-event ms
(median of 10 warm runs), device ms by kernel (torch.profiler: the
projection and the recurrence apart), the largest error against the bf16
plain version over max |ref|, and the ptxas report of the recurrence (the
``no_*`` variants drop work, so their errors only say that they computed
something else).  ``base`` runs first and last, so drift shows.

    PYTHONPATH=. python3 tools/k1f_bf16_trials.py [--variants base,no_mma,...]

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
from multimodal_transformer_robustness_tpu_torch.ops import bigru_cuda

ROOT = Path(__file__).resolve().parent.parent
OUT = _build.BUILD_DIR.parent / "k1f_bf16_trials"
REC, FWD = "gru_rec.cuh", "bigru.cu"

_TILED = {"rec_mma": 0, **bigru_cuda._plan_recurrence(1, 4096, 100)}
_PROJ128 = {"gemm_wgmma": 1}

# name -> ([(file, pattern, replacement, expected matches)], {bigru_cuda constant: value},
#          {plan key: value} over _plan_gru_fwd_bf16's)
VARIANTS = {
    "base": ([], {}, {}),
    "tiled": ([], {}, _TILED),
    "proj128": ([], {}, _PROJ128),
    "parent": ([], {}, {**_TILED, **_PROJ128}),
    "no_mma": ([(REC, r"mma_bf16\(acc\[gt\]", "(void)(acc[gt]", 2)], {}, {}),
    "no_math": ([(REC, r"const float r = gate_sigmoid\(xr \+ ar\);\n(.*\n){2}\s*return ok \? "
                       r"\(1\.0f - z\) \* n \+ z \* h : 0\.f;",
                  "return ok ? xr + ar + xz + az + xn + an * bn + 0.5f * h : 0.f;", 1)],
                {}, {}),
    "no_prefetch": ([(REC, r"(__device__ __forceinline__ void mma_prefetch\([^{]*\{)",
                      r"\1 return;", 1)], {}, {}),
    "no_barrier": ([(REC, r'asm volatile\("bar\.sync %0, %1;\\n" ::"r"\(1 \+ rg\), '
                          r'"r"\(32 \* RM_WPG\) : "memory"\);', "", 1)], {}, {}),
    "kp_no_epilogue": ([(FWD, r"for \(int g = 0; g < N / hg; \+\+g\) \{",
                         "for (int g = 0; g < 0; ++g) {", 1)], {}, {}),
    "kp_no_mma": ([(FWD, r"wgmma_bf16_n152\(acc[01], a\[q\], ", "(void)(a[q], ", 2)], {}, {}),
    "kp_no_load": ([(FWD, r"if \(kt \+ 2 < ktiles\) \{", "if (kt + 2 < 0) {", 1)], {}, {}),
    "wpg2": ([(REC, r"constexpr int RM_WPG = 4;", "constexpr int RM_WPG = 2;", 1),
              (REC, r"constexpr int RM_TPW = 4;", "constexpr int RM_TPW = 7;", 1)],
             {"_RM_WPG": 2, "_RM_TPW": 7}, {}),
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
        so = OUT / name / "k1f.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
             str(src / "bigru.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lines = log.splitlines()
        report = []
        for at, line in enumerate(lines):
            if "Compiling entry" in line and ("gru_rec_mma" in line or "k1f_proj" in line):
                report.append(" ".join(x.split(":")[-1].strip() for x in lines[at + 1:at + 5]
                                       if "stack frame" in x or "registers" in x))
        lib = ctypes.CDLL(str(so))
        fn = lib.mmtr_gru_dir_fwd_bf16
        fn.restype, fn.argtypes = _build._SIGNATURES["mmtr_gru_dir_fwd_bf16"]
        libs[name] = (lib, report)
    return libs


class _Lib:
    """What ``gru_dir`` reads of ``_build.load_library()`` at bf16."""

    def __init__(self, lib):
        self.mmtr_gru_dir_fwd_bf16 = lib.mmtr_gru_dir_fwd_bf16


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
    libs = build(dict.fromkeys(names + ["base"]))
    rng = np.random.default_rng(1)
    bf = torch.bfloat16
    H, T, B, in_dim = 100, 50, 4096, 768
    w = {k: v.to(bf) for k, v in cs.gru_weights(rng, in_dim, H, dev).items()}
    ops = bigru_cuda.dir_operands(w)
    wargs = tuple(ops[k] for k in ("wp", "wt", "bc", "bhn"))
    x = torch.from_numpy(rng.standard_normal((T, B, in_dim)).astype(np.float32)).to(dev, bf)
    ref = bigru_cuda.gru_dir_plain(x, *wargs, False).float()
    defaults = {k: getattr(bigru_cuda, k) for k in ("_RM_WPG", "_RM_TPW")}
    plan = bigru_cuda._plan_gru_fwd_bf16
    for name in ["base"] + [n for n in names if n != "base"] + ["base"]:
        lib, report = libs[name]
        for k, v in {**defaults, **VARIANTS[name][1]}.items():
            setattr(bigru_cuda, k, v)
        bigru_cuda._plan_gru_fwd_bf16 = lambda *a, o=VARIANTS[name][2], **kw: {
            **plan(*a, **kw), **o}
        bigru_cuda._cached_plan_bf16.cache_clear()
        _build.load_library = lambda lib=lib: _Lib(lib)
        try:
            fn = lambda: bigru_cuda.gru_dir(x, *wargs, False)   # noqa: E731
            got = fn().float()
            torch.cuda.synchronize()
            err = ((got - ref).abs().max() / ref.abs().max()).item()
            row = {"variant": name, "ptxas": report, "ms": cs.cuda_ms(fn, 10),
                   "max_err": err, "kernels_ms": cs.profile_ms(fn, 10)}
        finally:
            _build.load_library = main_lib
            bigru_cuda._plan_gru_fwd_bf16 = plan
            bigru_cuda._cached_plan_bf16.cache_clear()
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
