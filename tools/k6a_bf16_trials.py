"""Timing variants of the bf16 attention past L = 64 (K6a.bf16's row path,
``attention_bf16_row_kernel``, which is also K2.bf16's attention stage) at
the longest serving bucket, B=1 L=512, 12 heads of 64: which part of the
row kernel holds it, beside the parent's three-pass tiled kernel (the plan
forced to path 1) and SDPA in bf16.

Each variant is ``csrc/`` with text edits to ``bert_attn.cu`` (none for
``base``), built alone by ``nvcc`` into ``build/k6a_bf16_trials/<variant>/``,
all builds started together, and run through ``ops.bert_attn_cuda.
dense_attention_blockdiag`` with that library: CUDA-event ms (median of
50), device ms by kernel (torch.profiler), the largest error against the
bf16 plain version over max |ref| (the ``no_*`` variants drop work, so
their errors only say that they computed something else).  ``base`` runs
first and last, so drift shows.

    PYTHONPATH=. python3 tools/k6a_bf16_trials.py [--variants base,no_v,...]

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
import torch.nn.functional as F

from multimodal_transformer_robustness_tpu_torch import _build
from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda

ROOT = Path(__file__).resolve().parent.parent
OUT = _build.BUILD_DIR.parent / "k6a_bf16_trials"
ATT = "bert_attn.cu"

# name -> ([(file, pattern, replacement, expected matches)], force path 1)
VARIANTS = {
    "base": ([], False),
    "parent": ([], True),
    "no_v": ([(ATT, r"  rows16\(kv, V \+ base, L, kp, h, dh, dp, threadIdx.x, blockDim.x\);\n",
               "", 1)], False),
    "no_scores": ([(ATT, r"  ab_scores\(s\[([01])\], qs, kv", r"  if (L < 0) ab_scores(s[\1], qs, kv",
                    2)], False),
    "no_softmax": ([(ATT, r"  ab_exp<SM>\(s\[([01])\], mx\);", r"  (void)mx;", 2)], False),
    "no_pv": ([(ATT, r"  ab_pv\(o, s\[([01])\], sum, kv", r"  if (L < 0) ab_pv(o, s[\1], sum, kv",
                2)], False),
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
        so = OUT / name / "k6a.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(src / ATT)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lines = log.splitlines()
        report = []
        for at, line in enumerate(lines):
            if "Compiling entry" in line and "attention_bf16_row" in line:
                report.append(" ".join(x.split(":")[-1].strip() for x in lines[at + 1:at + 5]
                                       if "stack frame" in x or "registers" in x))
        lib = ctypes.CDLL(str(so))
        fn = lib.mmtr_attention_fwd_bf16
        fn.restype, fn.argtypes = _build._SIGNATURES["mmtr_attention_fwd_bf16"]
        libs[name] = (lib, report)
    return libs


class _Lib:
    """What ``dense_attention_blockdiag`` reads of ``_build.load_library()``
    at bf16."""

    def __init__(self, lib):
        self.mmtr_attention_fwd_bf16 = lib.mmtr_attention_fwd_bf16


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
    L, heads, dh = 512, 12, 64
    q, k, v = (torch.from_numpy(rng.standard_normal((1, L, heads, dh)).astype(np.float32))
               .to(dev, bf) for _ in range(3))
    mask = torch.zeros(1, L, device=dev)
    mask[0, :300] = 1.0
    ref = bert_attn_cuda.dense_attention_plain(q, k, v, mask).float()
    bias = ((1.0 - mask) * -10000.0)[:, None, None, :].to(bf)
    qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
    plan = bert_attn_cuda._plan_attention_bf16
    for name in ["base"] + [n for n in names if n != "base"] + ["base"]:
        lib, report = libs[name]
        if VARIANTS[name][1]:
            bert_attn_cuda._plan_attention_bf16 = lambda B, n, hd, d, num_sms=0: {
                "path": 1, "units": B * hd, "qtiles": -(-n // 64), "threads": 128, "smem": 0,
                "blocks": B * hd * -(-n // 64)}
        bert_attn_cuda._cached_plan_bf16.cache_clear()
        _build.load_library = lambda lib=lib: _Lib(lib)
        try:
            fn = lambda: bert_attn_cuda.dense_attention_blockdiag(q, k, v, mask)   # noqa: E731
            got = fn().float()
            torch.cuda.synchronize()
            err = ((got - ref).abs().max() / ref.abs().max()).item()
            row = {"variant": name, "ptxas": report, "ms": cs.cuda_ms(fn, 50),
                   "max_err": err, "kernels_ms": cs.profile_ms(fn, 20),
                   "sdpa_ms": cs.cuda_ms(lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, attn_mask=bias), 50)}
        finally:
            _build.load_library = main_lib
            bert_attn_cuda._plan_attention_bf16 = plan
            bert_attn_cuda._cached_plan_bf16.cache_clear()
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
