"""K9f / K9b by launch plan and promotion: each candidate's error against the
plain version and its time, at the four MOSEI T==1 blocks.

Two source variants of ``csrc/trunk_block.cu``: ``promote8`` (as it
stands, ``K9_PROMOTE = 8``: the products' tensor-core sums promoted every 8
k tiles, wgmma widths 104 or 128) and ``promote0`` (unpromoted, every wgmma
width).  Each is ``csrc/`` with the text edit, built alone by ``nvcc`` into
``build/k9_trials/<variant>/``, all builds started together, and run through
``ops.trunk_block_cuda.trunk_block_fwd`` / ``trunk_block_bwd`` with that
library.  Under each, two plans: ``split-K`` (the plan as it stands: the
wgmma tiles only where they give every SM two blocks) and ``wgmma`` (the
wgmma tiles wherever the copies allow: ``gemm_tc.plan_product`` asked as
for a card of one SM, so two tiles suffice), at R in
{64, 512, 4096}, train mode (d_mid 0.1, d_res 0.3; the operands as
``chip_smoke.trunk_block_operands`` makes them).  Per case: K9f's largest
absolute error against ``fused_residual_block_reference`` (tolerance 1e-4),
K9b's largest error relative to each gradient's max |ref| beyond the relu
kink's allowance (``relu_kink_bound``; tolerance 1e-4), each product's path,
and the CUDA-event ms of K9f and K9b (median of 5).  ``promote8`` with
``split-K`` runs first and last, so drift shows.

    PYTHONPATH=. python3 tools/k9_trials.py [--variants promote8,promote0]

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
from multimodal_transformer_robustness_tpu_torch.ops import gemm_tc
from multimodal_transformer_robustness_tpu_torch.ops import trunk_block_cuda as tb

ROOT = Path(__file__).resolve().parent.parent
OUT = _build.BUILD_DIR.parent / "k9_trials"
ROWS = (64, 512, 4096)
PLANS = ("split-K", "wgmma")
ENTRIES = ("mmtr_trunk_block_fwd", "mmtr_trunk_block_bwd")

# name -> ([(file, pattern, replacement, expected matches)], K9's wgmma widths)
VARIANTS = {
    "promote8": ([], gemm_tc.PROMOTED_WIDTHS),
    "promote0": ([("trunk_block.cu", r"constexpr int K9_PROMOTE = 8;",
                   "constexpr int K9_PROMOTE = 0;", 1)], gemm_tc.WG_WIDTHS),
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


class _Lib:
    """What the trunk-block wrappers read of ``_build.load_library()``."""

    def __init__(self, lib):
        for entry in ENTRIES:
            fn = getattr(lib, entry)
            fn.restype, fn.argtypes = _build._SIGNATURES[entry]
            setattr(self, entry, fn)


def build(names):
    """One nvcc a variant, all started together: {name: library}."""
    procs = {}
    for name in names:
        src = _source(name)
        so = OUT / name / "k9.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
             str(src / "trunk_block.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        spills = [line.strip() for line in log.splitlines()
                  if re.search(r"[1-9][0-9]* bytes spill", line)]
        print(json.dumps({"variant": name, "ptxas_spills": spills}), flush=True)
        libs[name] = _Lib(ctypes.CDLL(str(so)))
    return libs


@contextlib.contextmanager
def plan(name: str):
    """K9's products planned as ``name`` says (see the module docstring)."""
    real = gemm_tc.plan_product
    if name == "wgmma":
        gemm_tc.plan_product = lambda M, N, K, vec, num_sms, **kw: real(M, N, K, vec, 1, **kw)
    tb._cached_plan.cache_clear()
    try:
        yield
    finally:
        gemm_tc.plan_product = real
        tb._cached_plan.cache_clear()


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
    libs = build(dict.fromkeys(names + ["promote8"]))
    rng = np.random.default_rng(9)
    cases = []
    for name, E, F1, act, rep, cross, masked in cs.TRUNK_BLOCKS:
        for R in ROWS:
            x, src, dout, params, masks = cs.trunk_block_operands(rng, R, E, F1, masked, dev)
            cfg = tb.BlockConfig(act, rep, 0.1, 0.3, 21, -22, True, True)
            fargs = (x, src if cross else x, *params, *masks, cfg)
            bargs = (x, src if cross else x, dout, *params, *masks, cfg)
            cases.append((f"{name} E={E} F1={F1} R={R}", fargs, bargs,
                          tb.fused_residual_block_reference(*fargs),
                          tb.trunk_block_bwd_plain(*bargs), tb.relu_kink_bound(*bargs)[1]))
    main_lib, widths = _build.load_library, tb._K9_WIDTHS
    order = [("promote8", "split-K")] + [(v, p) for v in names for p in PLANS
                                         if (v, p) != ("promote8", "split-K")]
    for variant, plan_name in order + [("promote8", "split-K")]:
        lib = libs[variant]
        _build.load_library = lambda lib=lib: lib
        tb._K9_WIDTHS = VARIANTS[variant][1]
        with plan(plan_name):
            for shape, fargs, bargs, ref, bref, slack in cases:
                out = tb.trunk_block_fwd(*fargs)
                got = tb.trunk_block_bwd(*bargs)
                torch.cuda.synchronize()
                _, _, p = tb._plan_for(dev, fargs[0].shape[0], fargs[0].shape[1],
                                       fargs[2].shape[0], fargs[2], fargs[4])
                beyond = max((torch.clamp((a - r).abs() - s, min=0.0).max()
                              / r.abs().max().clamp(min=1e-30)).item()
                             for a, r, s in zip(got, bref, slack))
                print(json.dumps({
                    "variant": variant, "plan": plan_name, "shape": shape,
                    "paths": {k: "wgmma" if p[k]["wgmma"] else f"split-K {p[k]['splits']}"
                              for k in tb.PRODUCTS},
                    "K9f_max_abs_err": (out - ref).abs().max().item(),
                    "K9b_max_rel_err_beyond_kink": beyond,
                    "K9f_ms": cs.cuda_ms(lambda a=fargs: tb.trunk_block_fwd(*a), 5),
                    "K9b_ms": cs.cuda_ms(lambda a=bargs: tb.trunk_block_bwd(*a), 5)}),
                    flush=True)
    _build.load_library, tb._K9_WIDTHS = main_lib, widths
    return 0


if __name__ == "__main__":
    sys.exit(main())
