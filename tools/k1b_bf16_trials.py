"""Timing variants of K1b.bf16, a GRU direction's backward at bf16, at the
training path's shapes (H=100, T=50, B=4096; in = 768 without dx): which
part of the mma-form recurrence holds it (the recompute's products, the
carry's, the gate math's stores, the padded h_prev it writes for dwt), and
the parent's plans (the tiled recurrence, the mma.sync reductions).

Each variant is ``csrc/`` with text edits to ``gru_rec.cuh`` (none for
``base`` and ``parent``; ``parent`` takes ``chip_smoke.parent_plans()``),
built alone from ``bigru_bwd.cu`` by ``nvcc`` into
``build/k1b_bf16_trials/<variant>/``, all builds started together, and run
through ``ops.bigru_cuda.gru_dir_bwd`` with that library: CUDA-event ms
(median of 10 warm runs), device ms by kernel (torch.profiler), the
largest error of each gradient against the bf16 plain version over its
max |ref|, and the recurrence's ptxas report.  The ``no_*`` variants drop
work (the forward's mma form shares the edited lines and is not built
here), so their errors only say that they computed something else.
``base`` runs first and last, so drift shows.

    PYTHONPATH=. python3 tools/k1b_bf16_trials.py [--variants base,no_carry,...]

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
from multimodal_transformer_robustness_tpu_torch.ops import bigru_cuda

ROOT = Path(__file__).resolve().parent.parent
OUT = _build.BUILD_DIR.parent / "k1b_bf16_trials"
REC = "gru_rec.cuh"

# name -> [(file, pattern, replacement, expected matches)]; patterns are
# regular expressions (re.M), replacements literal text
VARIANTS = {
    "base": [],
    "parent": [],
    # the recompute's products (the forward's mma form has the same lines)
    "no_recompute": [(REC, re.escape("mma_bf16(acc[gt], a[m], r[0], r[1]);"),
                      "(void)r;", 2),
                     (REC, re.escape("if (m + 1 < ks) mma_bf16(acc[gt], a[m + 1 < RM_KS ? m + 1 "
                                     ": m], r[2], r[3]);"), "", 2)],
    "no_carry": [(REC, re.escape("mma_bf16(hc[q], ad[m], r[0], r[1]);"), "(void)r;", 1),
                 (REC, re.escape("if (m + 1 < ks) mma_bf16(hc[q], ad[m + 1 < RM_KS ? m + 1 : m], "
                                 "r[2], r[3]);"), "", 1)],
    "no_hp": [(REC, re.escape("if (hpc && row < B && col < H) {"), "if (false) {", 1),
              (REC, re.escape("i < 16 * (hpc - H); i += 32 * RM_WPG"),
               "i < 0; i += 32 * RM_WPG", 1)],
    "no_dg": [(REC, re.escape("if (row < B && col < H) {\n            bf16* o = p.dg"),
               "if (false) {\n            bf16* o = p.dg", 1)],
    "no_barrier": [(REC, re.escape('asm volatile("bar.sync %0, %1;\\n" ::"r"(bar), '
                                   '"r"(32 * RM_WPG) : "memory");\n\n    // the carry'),
                    "\n    // the carry", 1)],
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
    """One nvcc a variant, all started together: {name: (library, ptxas report)}."""
    procs = {}
    for name in names:
        so = OUT / name / "k1b.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
             str(_source(name) / "bigru_bwd.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lines = log.splitlines()
        report = [" ".join(x.split(":")[-1].strip() for x in lines[at + 1:at + 5]
                           if "stack frame" in x or "registers" in x)
                  for at, line in enumerate(lines)
                  if "Compiling entry" in line and "bwd_mma" in line]
        lib = ctypes.CDLL(str(so))
        fn = lib.mmtr_gru_dir_bwd_bf16
        fn.restype, fn.argtypes = _build._SIGNATURES["mmtr_gru_dir_bwd_bf16"]
        libs[name] = (lib, report)
    return libs


class _Lib:
    """What ``gru_dir_bwd`` reads of ``_build.load_library()`` at bf16."""

    def __init__(self, lib):
        self.mmtr_gru_dir_bwd_bf16 = lib.mmtr_gru_dir_bwd_bf16


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
    _build.load_library()   # the forward (K1f.bf16) that makes hs and the gates
    libs = build(dict.fromkeys(names + ["base"]))
    rng = np.random.default_rng(2)
    bf = torch.bfloat16
    H, T, B, in_dim = 100, 50, 4096, 768
    w = {k: v.to(bf) for k, v in cs.gru_weights(rng, in_dim, H, dev).items()}
    ops = bigru_cuda.dir_operands(w)
    wargs = tuple(ops[k] for k in ("wp", "wt", "bc", "bhn"))
    x = torch.from_numpy(rng.standard_normal((T, B, in_dim)).astype(np.float32)).to(dev, bf)
    dhs = torch.from_numpy(rng.standard_normal((T, B, H)).astype(np.float32)).to(dev, bf)
    hs, gates = bigru_cuda._launch_fwd(x, *wargs, False)
    ref = bigru_cuda.gru_dir_bwd_plain(x, *wargs, hs, gates, dhs, False, False)
    for name in ["base"] + [n for n in names if n != "base"] + ["base"]:
        lib, report = libs[name]
        _build.load_library = lambda lib=lib: _Lib(lib)
        bigru_cuda._cached_bwd_plan_bf16.cache_clear()
        try:
            with cs.parent_plans() if name == "parent" else contextlib.nullcontext():
                fn = lambda: bigru_cuda.gru_dir_bwd(x, *wargs, hs, gates, dhs,   # noqa: E731
                                                    False, False)
                got = fn()
                torch.cuda.synchronize()
                err = {k: ((g.float() - r.float()).abs().max() / r.float().abs().max()).item()
                       for k, g, r in zip(("dwp", "dwt", "dbc", "dbhn"), got[1:], ref[1:])}
                row = {"variant": name, "ptxas": report, "ms": cs.cuda_ms(fn, 10),
                       "max_err": err, "kernels_ms": cs.profile_ms(fn, 10)}
        finally:
            _build.load_library = main_lib
            bigru_cuda._cached_bwd_plan_bf16.cache_clear()
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
