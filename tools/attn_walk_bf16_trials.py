"""Timing variants of the bf16 unit walk (``attention_bf16_walk_kernel``:
K6a.bf16 and K2.bf16's attention stage at L <= 64, K8.bf16 at Tq, Tk <=
64) at bench.py's training shape, B=4096 L=32, 12 heads of 64, beside the
parent's plans.

Each variant is ``csrc/`` with text edits to ``bert_attn.cu`` (none for
``base`` and ``parent``; ``parent`` takes ``chip_smoke.parent_plans()``:
K6a.bf16 on the block-a-unit kernel, K8.bf16 on the float32 HARD kernels
by the float32 plan), built alone by ``nvcc`` into
``build/attn_walk_bf16_trials/<variant>/``, all builds started together,
and run through ``ops.bert_attn_cuda.dense_attention_blockdiag`` and
``ops.attention_cuda.flash_attention_masked`` with that library:
CUDA-event ms (median of 20 warm runs), device ms by kernel
(torch.profiler), the largest error against the bf16 plain version over
max |ref|, whether the output has ``base``'s bits, and the walk's ptxas
report.  ``no_compute`` stages every unit and writes its staged q rows
back (the walk's loads and stores alone; its output is q); ``no_store``
computes every unit and stores nothing; ``div_rn`` divides e by the
row's sum with div.rn, as the block-a-unit kernel does (the first design:
the same bits); ``mul_p`` multiplies e by the sum's reciprocal (what the
exact division costs beyond a product; its bits are not K6a.bf16's).
``base`` runs first and last, so drift shows.

    PYTHONPATH=. python3 tools/attn_walk_bf16_trials.py [--variants base,no_compute,...]

Needs one H100 and nvcc; the edits must match the source, or the script
stops before building.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
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
from multimodal_transformer_robustness_tpu_torch.ops import attention_cuda, bert_attn_cuda

ROOT = Path(__file__).resolve().parent.parent
OUT = _build.BUILD_DIR.parent / "attn_walk_bf16_trials"
ATT = "bert_attn.cu"
ENTRIES = ("mmtr_attention_fwd_bf16", "mmtr_attention_masked_walk_bf16",
           "mmtr_attention_masked_fwd_bf16")

_PAIRS = "    for (int r0 = 0; r0 < d.Lq; r0 += 32) {   // two m-tiles at once\n"
_STORES = "    for (int i = lane; i < d.Lq * cpr; i += 32) {\n"
_AW_PV = "          aw_pv(o[t], s[t], sum[t], vs, d.kp, dp);\n"
_AW_DIV = "        a[q] = pack_bf16(aw_div(c[0], sum[h], y[h]), aw_div(c[1], sum[h], y[h]));\n"

# name -> [(file, pattern, replacement, expected matches)]; patterns are
# regular expressions (re.M), replacements literal text
VARIANTS = {
    "base": [],
    "parent": [],
    "no_compute": [(ATT, re.escape(_PAIRS),
                    _PAIRS.replace("r0 < d.Lq;", "r0 < d.Lq && units < 0;"), 1)],
    "no_store": [(ATT, re.escape(_STORES), _STORES.replace("i < d.Lq * cpr", "i < 0"), 1)],
    "div_rn": [(ATT, re.escape(_AW_PV), _AW_PV.replace("aw_pv", "ab_pv"), 1)],
    "mul_p": [(ATT, re.escape(_AW_DIV), "        a[q] = pack_bf16(c[0] * y[h], c[1] * y[h]);\n",
               1)],
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


class _Lib:
    """What the two wrappers read of ``_build.load_library()`` at bf16."""

    def __init__(self, lib):
        for name in ENTRIES:
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = _build._SIGNATURES[name]
            setattr(self, name, fn)


def build(names):
    """One nvcc a variant, all started together: {name: (library, ptxas report)}."""
    procs = {}
    for name in names:
        src = _source(name)
        so = OUT / name / "attn.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(src / ATT)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lines = log.splitlines()
        report = [" ".join(x.split(":")[-1].strip() for x in lines[at + 1:at + 5]
                           if "stack frame" in x or "registers" in x)
                  for at, line in enumerate(lines)
                  if "Compiling entry" in line and "walk" in line]
        libs[name] = (_Lib(ctypes.CDLL(str(so))), report)
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    for name in names:
        edited(name)
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
    rng = np.random.default_rng(2)
    bf = torch.bfloat16
    B, L, heads, dh = 4096, 32, 12, 64
    q, k, v = (torch.from_numpy(rng.standard_normal((B, L, heads, dh)).astype(np.float32))
               .to(dev, bf) for _ in range(3))
    mask = np.zeros((B, L), np.float32)
    for i in range(1, B):
        mask[i, : rng.integers(1, L + 1)] = 1.0
    mask = torch.from_numpy(mask).to(dev)
    qh, kh, vh = (z.transpose(1, 2).contiguous() for z in (q * dh ** -0.5, k, v))
    km = cs.ragged_key_mask(rng, B, L, dev)
    cases = {"K6a.bf16": (lambda: bert_attn_cuda.dense_attention_blockdiag(q, k, v, mask),
                          bert_attn_cuda.dense_attention_plain(q, k, v, mask).float()),
             "K8.bf16": (lambda: attention_cuda.flash_attention_masked(qh, kh, vh, km),
                         attention_cuda.flash_attention_masked_plain(qh, kh, vh, km).float())}
    main_lib = _build.load_library
    digests = {}
    for name in ["base"] + [n for n in names if n != "base"] + ["base"]:
        lib, report = libs[name]
        _build.load_library = lambda lib=lib: lib
        row = {"variant": name, "ptxas": report}
        try:
            with cs.parent_plans() if name == "parent" else contextlib.nullcontext():
                for kid, (fn, ref) in cases.items():
                    got = fn()
                    torch.cuda.synchronize()
                    digest = hashlib.sha256(got.cpu().view(torch.int16).numpy().tobytes())
                    digests.setdefault(kid, digest.hexdigest())
                    row[kid] = {"ms": cs.cuda_ms(fn, 20), "kernels_ms": cs.profile_ms(fn, 10),
                                "max_err": ((got.float() - ref).abs().max()
                                            / ref.abs().max()).item(),
                                "base_bits": digest.hexdigest() == digests[kid]}
        finally:
            _build.load_library = main_lib
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
