"""Timing variants of K3.bf16, the frozen BERT's FFN block at bf16, at the
training path's shape (B=4096 L=32, h=768, ffn=3072): how the persistent
wgmma kernel's producer fills its ring (TMA against 16-byte cp.async), what
fc1's gelu costs in its epilogue, and the parent's plans.

Each variant is ``csrc/`` with text edits to ``gemm_bf16.cuh`` (none for
``base`` and ``parent``; ``parent`` takes ``chip_smoke.parent_plans()``:
the 128 x 128 wgmma tiles with the weights' transposes, the LayerNorm a
block a row), built alone from ``bert_ffn.cu`` by ``nvcc`` into
``build/k3_bf16_trials/<variant>/``, all builds started together, and run
through ``ops.bert_ffn_cuda.ffn_ln_block`` with that library: CUDA-event
ms (median of 10 warm runs), device ms by kernel (torch.profiler), the
largest error against the bf16 plain version over max |ref|, and the
persistent kernel's ptxas report.  ``cpasync``: a producer warp whose 32
lanes copy each stage in 16-byte pieces, swizzled by hand as the tensor
map swizzles, and complete its full barrier by
``cp.async.mbarrier.arrive.noinc`` (the consumers fence the async proxy
after the wait); ``no_gelu`` drops the gelu from fc1's epilogue (it then
computes something else); ``epi7`` gives the epilogue seven warps (512
threads, 128 registers each); ``unroll4`` the epilogue's store loop
unrolled four pieces at a time, not whole (the residual's ring of pieces
then sits in local memory); ``no_epilogue`` hands the staging tile
over and writes nothing (the products' and the handoff's time alone);
``stages3`` a ring of three (how much the look-ahead matters); ``stcs``
the epilogue's stores streaming (evict-first).  ``base``
runs first and last, so drift shows.

    PYTHONPATH=. python3 tools/k3_bf16_trials.py [--variants base,cpasync,...]

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
from multimodal_transformer_robustness_tpu_torch.ops import bert_ffn_cuda

ROOT = Path(__file__).resolve().parent.parent
OUT = _build.BUILD_DIR.parent / "k3_bf16_trials"
GEMM = "gemm_bf16.cuh"

_PRODUCER_TMA = r"""    if (lane == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int row0 = (t / tiles_n) * BP_BM, col0 = (t % tiles_n) * BP_BN;
        const int plane = col0 / hg, bx = col0 - plane * hg, by = plane * K;
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(empty + s, ph ^ 1);   // passes at once on the ring's first lap
          mbar_expect_tx(full + s, BP_A_BYTES + BP_B_BYTES);
          tma_load_2d(As + s * BP_A_BYTES, &map_a, kt * BP_BK, row0, full + s);
#pragma unroll
          for (int c = 0; c < BP_BN / 64; ++c)
            tma_load_2d(Bs + s * BP_B_BYTES + c * BP_B_CHUNK, &map_b, bx + 64 * c,
                        by + kt * BP_BK, full + s);
          if (++s == BP_STAGES) s = 0, ph ^= 1;
        }
      }
    }
"""

_PRODUCER_CPASYNC = r"""    {
      int s = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int row0 = (t / tiles_n) * BP_BM, col0 = (t % tiles_n) * BP_BN;
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(empty + s, ph ^ 1);
          const int k0 = kt * BP_BK;
          for (int i = lane; i < BP_BM * 8; i += 32) {
            const int r = i / 8, c = i % 8;
            const bool ok = row0 + r < M && k0 + 8 * c < K;
            cp_async16(As + s * BP_A_BYTES + r * 128 + ((c ^ (r & 7)) << 4),
                       ok ? gA + (long long)(row0 + r) * lda + k0 + 8 * c : gA, ok);
          }
          for (int i = lane; i < BP_BK * (BP_BN / 8); i += 32) {
            const int k = i / (BP_BN / 8), j = i % (BP_BN / 8), jj = j % 8;
            const bool ok = k0 + k < K && col0 + 8 * j < N;
            cp_async16(Bs + s * BP_B_BYTES + (j / 8) * BP_B_CHUNK + k * 128 +
                           ((jj ^ (k & 7)) << 4),
                       ok ? gB + (long long)(k0 + k) * ldb + col0 + 8 * j : gB, ok);
          }
          asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                       ::"r"(smem_addr(full + s)) : "memory");
          if (++s == BP_STAGES) s = 0, ph ^= 1;
        }
      }
    }
"""

# name -> [(file, pattern, replacement, expected matches)]; patterns are
# regular expressions (re.M), replacements literal text
VARIANTS = {
    "base": [],
    "parent": [],
    "cpasync": [
        (GEMM, re.escape("const __grid_constant__ CUtensorMap map_b, int M, int N, int K,\n"
                         "                            int hg, const bf16* __restrict__ bias,"),
         "const __grid_constant__ CUtensorMap map_b, int M, int N, int K,\n"
         "                            const bf16* __restrict__ gA, int lda,\n"
         "                            const bf16* __restrict__ gB, int ldb,\n"
         "                            int hg, const bf16* __restrict__ bias,", 1),
        (GEMM, re.escape("<<<grid, BP_THREADS, BP_SMEM, stream>>>(map_a, map_b, M, N, K,"),
         "<<<grid, BP_THREADS, BP_SMEM, stream>>>(map_a, map_b, M, N, K, A, lda, B, ldb,", 1),
        (GEMM, re.escape("      mbar_init(full + s, 1);                       // the producer's "
                         "expect_tx"), "      mbar_init(full + s, 32);", 1),
        (GEMM, re.escape(_PRODUCER_TMA), _PRODUCER_CPASYNC, 1),
        (GEMM, re.escape("        mbar_wait(full + s, ph);\n"
                         "        const uint8_t* as = As + s * BP_A_BYTES + wg * 64 * 128;"),
         "        mbar_wait(full + s, ph);\n"
         "        asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: \"memory\");\n"
         "        const uint8_t* as = As + s * BP_A_BYTES + wg * 64 * 128;", 1)],
    "no_gelu": [(GEMM, re.escape("pack_bf16(gelu_erf(bf2f(h[2 * e])), "
                                 "gelu_erf(bf2f(h[2 * e + 1])))"),
                 "pack_bf16(bf2f(h[2 * e]), bf2f(h[2 * e + 1]))", 1)],
    "epi7": [(GEMM, re.escape("constexpr int BP_MMA_THREADS = 256, BP_EPI_THREADS = 192;"),
              "constexpr int BP_MMA_THREADS = 256, BP_EPI_THREADS = 224;", 1),
             # 3,072 pieces over 224 threads: the last round partly empty
             (GEMM, re.escape("PIECES = BP_BM * PER_ROW / BP_EPI_THREADS;"),
              "PIECES = (BP_BM * PER_ROW + BP_EPI_THREADS - 1) / BP_EPI_THREADS;", 1),
             (GEMM, re.escape('    static_assert(PIECES * BP_EPI_THREADS == BP_BM * PER_ROW, '
                              '"whole pieces a thread");\n'), "", 1),
             (GEMM, re.escape("        if (row0 + r >= M || c >= N) continue;"),
              "        if (p >= BP_BM * PER_ROW || row0 + r >= M || c >= N) continue;", 1)],
    "unroll4": [(GEMM, re.escape("#pragma unroll\n      for (int j = 0; j < PIECES; ++j) {"),
                 "#pragma unroll 4\n      for (int j = 0; j < PIECES; ++j) {", 1)],
    "no_epilogue": [(GEMM, re.escape("      for (int j = 0; j < PIECES; ++j) {"),
                     "      for (int j = 0; j < 0; ++j) {", 1)],
    "stages3": [(GEMM, re.escape("BP_BK = 64, BP_STAGES = 4;"), "BP_BK = 64, BP_STAGES = 3;", 1)],
    "stcs": [(GEMM, re.escape("*reinterpret_cast<uint4*>(C + cbase + (long long)r * hg + cc) "
                              "= out;"),
              "__stcs(reinterpret_cast<uint4*>(C + cbase + (long long)r * hg + cc), out);", 1)],
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
        so = OUT / name / "k3.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
             str(_source(name) / "bert_ffn.cu")], stdout=subprocess.PIPE,
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
                  if "Compiling entry" in line and "persistent" in line]
        lib = ctypes.CDLL(str(so))
        fn = lib.mmtr_ffn_ln_fwd_bf16
        fn.restype, fn.argtypes = _build._SIGNATURES["mmtr_ffn_ln_fwd_bf16"]
        libs[name] = (lib, report)
    return libs


class _Lib:
    """What ``ffn_ln_block`` reads of ``_build.load_library()`` at bf16."""

    def __init__(self, lib):
        self.mmtr_ffn_ln_fwd_bf16 = lib.mmtr_ffn_ln_fwd_bf16


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
    B, L, h, ffn = 4096, 32, 768, 3072

    def t(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(
            dev, torch.bfloat16)

    f_args = (t((B, L, h)), t((h, ffn), 0.02), t((ffn,), 0.02), t((ffn, h), 0.02),
              t((h,), 0.02), (1.0 + t((h,), 0.1).float()).to(torch.bfloat16), t((h,), 0.1))
    ref = bert_ffn_cuda.ffn_ln_block_plain(*f_args, eps=1e-12).float()
    main_lib = _build.load_library
    for name in ["base"] + [n for n in names if n != "base"] + ["base"]:
        lib, report = libs[name]
        _build.load_library = lambda lib=lib: _Lib(lib)
        bert_ffn_cuda._cached_ffn_plan_bf16.cache_clear()
        try:
            with cs.parent_plans() if name == "parent" else contextlib.nullcontext():
                fn = lambda: bert_ffn_cuda.ffn_ln_block(*f_args, eps=1e-12)   # noqa: E731
                got = fn().float()
                torch.cuda.synchronize()
                err = ((got - ref).abs().max() / ref.abs().max()).item()
                row = {"variant": name, "ptxas": report, "ms": cs.cuda_ms(fn, 10),
                       "max_err": err, "kernels_ms": cs.profile_ms(fn, 10)}
        finally:
            _build.load_library = main_lib
            bert_ffn_cuda._cached_ffn_plan_bf16.cache_clear()
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
