"""Timing-only variants of K5b, the fused flash-attention backward: which
part of the kernel holds it above its byte bound, at the MOSEI shapes.

Each variant is ``csrc/`` with a text edit to ``flash_attn.cu`` or
``gemm_tc.cuh`` (none for ``base``), built alone by ``nvcc`` into
``build/k5b_trials/<variant>/``, all builds started together, and timed
through its ``mmtr_flash_bwd`` entry with the plan ``flash_bwd`` uses, at
cross (Tq=50, Tk=32, offset 19) and self (T=50, offset 1), B*H = 4096*8,
D = 25, dropout rate 0.1, by CUDA events (median of 20 warm runs).  Each
line gives the variant's ms at both shapes, its share of base's, and its
largest error against the plain backward over max |ref| of each gradient:
the variants that drop work compute something else, and their errors say
how far (``one_mma``'s is what a single TF32 product would cost in
accuracy).  ``base`` runs first and last, so drift shows.

    PYTHONPATH=. python3 tools/k5b_trials.py [--variants base,one_mma,...]

Needs one H100 and nvcc; the edits must match the source, or the script
stops before building.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from multimodal_transformer_robustness_tpu_torch import _build
from multimodal_transformer_robustness_tpu_torch.ops import attention_cuda as ac

OUT = _build.BUILD_DIR.parent / "k5b_trials"
FLASH, GEMM = "flash_attn.cu", "gemm_tc.cuh"

# the 3xTF32 corrections: lo*hi and hi*lo, in phase 1 (fb_mma3) and phase 2
# (fb_product): K5b's own code, which ends where K5f's constants begin
# (value_product, which K5f, K5dq and K5dkv share, has the same pair)
_K5B_END = "constexpr int FK_TILE"
_CORRECTIONS = (FLASH, r"^\s*mma_tf32\([^;]*?, (al, bh|ah, bl)\);\n", "", 6, _K5B_END)
_EXP_HASH = [(FLASH, r"__expf\((s\[j\]\[e\] - \(e < 2 \? lse0 : lse1\))\)", r"(\1)", 1),
             (FLASH, r"keep_factor\(d\.use_dropout, seed, rate, keep_scale, row, col\)",
              "1.f", 1)]
_NO_PHASE1 = (FLASH, r"w < n_items;", "w < 0;", 1)
_NO_PHASE2 = (FLASH, r"w < n_units;", "w < 0;", 1)
_NO_STAGING = (FLASH, r"\n\s*fb_stage_slice\(smem, [^;]*;", "", 1)

# name -> [(file, pattern, replacement, expected matches[, the text the edit
# stops before])]
VARIANTS = {
    "base": [],
    "one_mma": [_CORRECTIONS],
    "no_exp_hash": _EXP_HASH,
    "one_mma_no_exp_hash": [_CORRECTIONS] + _EXP_HASH,
    "rounding_split": [(GEMM, r"hi = __float_as_uint\(x\) & 0xffffe000u;",
                        "hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;", 1)],
    "phase1_only": [_NO_PHASE2],
    "phase2_only": [_NO_PHASE1],
    "staging_only": [_NO_PHASE1, _NO_PHASE2],
    "nothing": [_NO_PHASE1, _NO_PHASE2, _NO_STAGING],
}


def edited(name: str, csrc: Path = _build._CSRC) -> dict:
    """{file: text} of ``csrc``'s files with the variant's edits, each
    checked to match its stated number of times (SystemExit where not)."""
    texts = {}
    for fname, pattern, repl, count, *until in VARIANTS[name]:
        text = texts.get(fname) or (csrc / fname).read_text()
        end = text.index(until[0]) if until else len(text)
        head, n = re.subn(pattern, repl, text[:end], flags=re.M)
        if n != count:
            raise SystemExit(f"{name}: {pattern!r} matched {n} times in {fname}, not {count}")
        texts[fname] = head + text[end:]
    return texts


def _source(name: str) -> Path:
    """A copy of csrc/ with the variant's edits."""
    src = OUT / name / "csrc"
    texts = edited(name)
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build._CSRC, src)
    for fname, text in texts.items():
        (src / fname).write_text(text)
    return src


def build(names):
    """One nvcc a variant, all started together: {name: (entry, ptxas report)}."""
    procs = {}
    for name in names:
        src = _source(name)
        so = OUT / name / "k5b.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(src / FLASH)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        # ptxas names the function, then gives its stack / spill and register lines
        lines = log.splitlines()
        at = next(i for i, line in enumerate(lines)
                  if "Compiling entry" in line and "flash_bwd_fused_kernel" in line)
        report = " ".join(line.split(":")[-1].strip() for line in lines[at + 1:at + 5]
                          if "stack frame" in line or "registers" in line)
        lib = ctypes.CDLL(str(so))
        fn = lib.mmtr_flash_bwd
        fn.restype, fn.argtypes = _build._SIGNATURES["mmtr_flash_bwd"]
        libs[name] = (fn, report)
    return libs


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def cases(dev, rng, B=4096, heads=8, d=25, rate=0.1):
    """The MOSEI cross and self inputs, out and lse from the plain forward,
    the plain backward as the reference."""
    out = {}
    for name, tq, tk in (("cross", 50, 32), ("self", 50, 50)):
        offset, bh = 1 + abs(tk - tq), B * heads

        def t(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

        q = t(rng.standard_normal((B, heads, tq, d)) / np.sqrt(d))
        k, v, dout = (t(rng.standard_normal((B, heads, n, d))) for n in (tk, tk, tq))
        seeds = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, bh).astype(np.int32)).to(dev)
        rates = torch.full((bh,), rate, device=dev)
        o, lse = ac.flash_attention_plain(q, k, v, True, offset, seeds, rates)
        ref = ac.flash_attention_bwd_plain(q, k, v, dout, True, offset, seeds, rates)
        _, plan = ac._cached_bwd_plan(bh, tq, tk, d, _build.num_sms(dev))
        out[name] = dict(args=(q, k, v, dout, o.contiguous(), lse.contiguous(), seeds, rates),
                         dims=(bh, tq, tk, d, 1, offset, 1), plan=plan, ref=ref)
    return out


def run(fn, case, dev):
    q, k, v, dout, o, lse, seeds, rates = case["args"]
    grads = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    def launch():
        err = fn(*(a.data_ptr() for a in (q, k, v, dout, o, lse, seeds, rates)),
                 *(g.data_ptr() for g in grads), *case["dims"], case["plan"],
                 _build.stream_ptr(dev))
        _build.check(err, "K5b trial")

    launch()
    torch.cuda.synchronize()
    err = max(((g - r).abs().max() / r.abs().max()).item() for g, r in zip(grads, case["ref"]))
    return cuda_ms(launch), err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    libs = build(dict.fromkeys(names + ["base"]))
    data = cases(dev, np.random.default_rng(7))
    base = {}
    for name in ["base"] + [n for n in names if n != "base"] + ["base"]:
        fn, report = libs[name]
        row = {"variant": name, "ptxas": report}
        for shape, case in data.items():
            ms, err = run(fn, case, dev)
            base.setdefault(shape, ms)
            row[shape] = {"ms": ms, "of_base": ms / base[shape], "max_err": err}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
