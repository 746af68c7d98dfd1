"""Timing trials of K5f (the flash forward), K5dkv and K5dq (the flash
backward's dk / dv and dq): the candidates their launch plans passed over,
and variants that drop work, at the shapes the main path gives them, each
with its error against the plain version.

Each variant is a copy of ``csrc/`` under ``build/k5_trials/<variant>/``
with text edits, each of which must match a stated number of times (one
``nvcc`` a variant, all started together; a variant with no edit runs the
base build), and a change to the plans the package's wrappers would pass:
  * ``slots1``: K5f's unit path (Tq, Tk <= 64) with one shared-memory slot,
    staged after the slice is computed, against two (the next slice in
    flight), at the MOSEI self (T=50, offset 1) and cross (Tq=50, Tk=32,
    offset 19) shapes, B*H = 4096*8, D = 25, rate 0.1;
  * ``bq64``: K5f's tiled path with 64 query rows a block against 128, at
    B=16 T=2048 (causal, rate 0);
  * ``qreg``: the tiled path with the warp's q fragments split into
    registers against two shared-memory planes;
  * ``stages3``: K5f's key-tile and K5dkv's query-tile rings with 3 stages
    against 2, at T=2048 (rate 0) and, for K5dkv, the MOSEI shapes (rate
    0.1);
  * ``promote2`` / ``promote4``: K5dkv's dK / dV sums promoted into
    float32 every 2 or 4 query tiles, against the tensor cores' truncating
    accumulation over up to 2048 queries;
  * ``dkv_generic``: K5dkv without its straight-line copy for 32-query
    halves whose pairs are all visible; ``dkv_lb3``: K5dkv under a
    3-blocks-an-SM launch bound;
  * ``dq_bq128``: K5dq with 128 query rows a block against 64 at T=2048
    (2 blocks of 256 threads an SM, 128 registers); ``dq_stages3``: its
    key ring with 3 stages against 2; ``dq_promote2`` /
    ``dq_promote4``: its dQ sums promoted into float32 every 2 or 4 key
    tiles; ``dq_generic``: without its straight-line copy for key tiles
    whose pairs are all visible; ``dq_lb1`` / ``dq_lb4``: its launch bound
    without its 3 blocks an SM (170 registers) where D <= 32, or at 4 (128
    registers); ``dq_full4`` / ``dq_edge8``: its interior tiles' scores in
    runs of 4 key tiles against 8, its edge tiles' in runs of 8 against 4;
  * timing only, they compute something else: ``staging_only``,
    ``compute_only``, ``no_hash`` and ``one_mma`` (VARIANTS says what each
    drops).
``--kernels`` keeps only the named kernels' shapes; ``--csrc NAME=DIR``
adds another tree's ``csrc/`` as is, run with the package's plans.  Every
variant runs every shape; CUDA-event median ms of 20 warm runs; errors:
K5f's max |out - ref| and |lse - ref|, K5dkv's max error over max |ref|
of dk and of dv, K5dq's of dq.  ``base`` runs first and last, so drift
shows.

    PYTHONPATH=. python3 tools/k5_trials.py [--variants base,promote4] [--kernels K5dq]
        [--csrc v1=DIR]

Needs one H100 and nvcc.  Prints one JSON line a (variant, shape).
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

OUT = _build.BUILD_DIR.parent / "k5_trials"
FLASH = "flash_attn.cu"


# K5f's unit path with one slot: the next slice is staged after the
# current one is computed, behind a barrier, into the same slot
_SLOTS1 = [(FLASH, r"const float\* qs = smem \+ \(it & 1\) \* d\.slot;", "const float* qs = smem;", 1),
           (FLASH, r"^\s*if \(u \+ \(int\)gridDim\.x < units\)\n\s*fwd_stage_slice\(smem \+ "
                   r"\(\(it \+ 1\) & 1\) \* d\.slot, [^;]*;\n\s*cp_async_commit\(\);\n", "", 1),
           (FLASH, r"(LSE \+ \(long long\)u \* d\.Tq, m0, d, seed, rate, keep_scale\);\n)",
            r"\1    __syncthreads();\n    if (u + (int)gridDim.x < units)\n"
            r"      fwd_stage_slice(smem, Q, K, V, seeds, rates, u + gridDim.x, d);\n"
            r"    cp_async_commit();\n", 1),
           (FLASH, r"smem < 8 \* d\.slot", "smem < 4 * d.slot", 1)]
# K5f's tiled path with the warp's q fragments split once into registers
_QREG = [(FLASH, r"^  const uint32_t\* qhp = reinterpret_cast<const uint32_t\*>\(qs\);\n"
                 r"  const uint32_t\* qlp = qhp \+ d\.bq \* ld;\n",
          "  uint32_t qh[DT][4], ql[DT][4];\n", 1),
         (FLASH, r"frag_a_planes\(qhp, qlp, ld, m0, 8 \* kk, ah, al\);",
          "for (int i = 0; i < 4; ++i) ah[i] = qh[kk][i], al[i] = ql[kk][i];", 1),
         (FLASH, r"(?s)^      uint32_t\* hp = reinterpret_cast<uint32_t\*>\(qs\) \+ m0 \* ld;"
                 r".*?__syncwarp\(\);\n",
          "#pragma unroll\n      for (int kk = 0; kk < DT; ++kk) "
          "fb_frag_a(qs, ld, 1, m0, 8 * kk, qh[kk], ql[kk]);\n", 1),
         (FLASH, r"smem < 4 \* \(FK_STAGES \* 2 \* FK_TILE \+ 2 \* d\.bq\) \* d\.ld",
          "smem < 4 * (FK_STAGES * 2 * FK_TILE + d.bq) * d.ld", 1)]
_STAGES3 = [(FLASH, r"constexpr int FK_STAGES = 2;", "constexpr int FK_STAGES = 3;", 1)]
_DQ_STAGES3 = [(FLASH, r"constexpr int DQ_STAGES = 2;", "constexpr int DQ_STAGES = 3;", 1)]


def _promote(n, kernel="DKV"):
    return [(FLASH, rf"constexpr int {kernel}_PROMOTE = 0;",
             f"constexpr int {kernel}_PROMOTE = {n};", 1)]


# Timing-only variants that drop work (their errors say how far they are
# from the function): K5f path 0 without its products and softmax
# (staging_only) or without the next slice's staging (compute_only), every
# K5f / K5dkv / K5dq kernel without the dropout hash (no_hash) or without the two
# 3xTF32 correction MMAs of each product (one_mma: a single TF32 product).
_NO_CORRECTIONS = [(FLASH, r"^  mma_tf32\(c, al, bh\);\n  mma_tf32\(c, ah, bl\);\n", "", 1),
                   (FLASH, r"^\s*mma_tf32\(oc\[n\], (al, bh|ah, bl)\);\n", "", 2)]
_NO_HASH = [(FLASH, r"if \(!d\.use_dropout\) return;", "return;", 1),
            (FLASH, r"if \(d\.use_dropout\) mk = hash_uniform\(seed, row, (key|col)\) >= rate \? "
                    r"keep_scale : 0\.f;", "", 2)]
_STAGING_ONLY = [(FLASH, r"^    fwd_unit_rows<DT, NKT, T>\(", "    if (d.Tq < 0) fwd_unit_rows<DT, NKT, T>(",
                  1)]
_COMPUTE_ONLY = [(FLASH, r"if \(u \+ \(int\)gridDim\.x < units\)\n\s*fwd_stage_slice\([^;]*;",
                  "", 1)]
# K5dkv with every 32-query half on the tested path (no straight-line copy)
_DKV_GENERIC = [(FLASH, r"if \(qa \+ 32 <= d\.Tq && c0 \+ 16 <= d\.Tk",
                 "if (false && qa + 32 <= d.Tq && c0 + 16 <= d.Tk", 1)]
# K5dkv's launch bound at 3 blocks an SM (170 registers)
_DKV_LB3 = [(FLASH, r"__launch_bounds__\(FD_THREADS\)", "__launch_bounds__(FD_THREADS, 3)", 1)]

# K5dq with every key tile on the tested path (no straight-line copy)
_DQ_GENERIC = [(FLASH, r"if \(k0 \+ FK_TILE <= d\.Tk(.*\{\n\s*dq_key_tile<DT, true>)",
                r"if (false && k0 + FK_TILE <= d.Tk\1", 1)]

# K5dq's launch bound without its 3 blocks an SM (170 registers) where D
# <= 32, at 4 (128 registers), or at 2 blocks of 256 threads (128
# registers; the plan's bq 128, which its check then takes); its interior
# tiles in runs of 4 key tiles, its edge tiles in runs of 8
_DQ_BOUND = r"__launch_bounds__\(128, DT <= 4 \? 3 : 1\)\nflash_bwd_dq_kernel"
_DQ_LB1 = [(FLASH, _DQ_BOUND, "__launch_bounds__(128)\nflash_bwd_dq_kernel", 1)]
_DQ_LB4 = [(FLASH, _DQ_BOUND, "__launch_bounds__(128, DT <= 4 ? 4 : 1)\nflash_bwd_dq_kernel", 1)]
_DQ_BQ128 = [(FLASH, _DQ_BOUND, "__launch_bounds__(256, DT <= 4 ? 2 : 1)\nflash_bwd_dq_kernel", 1),
             (FLASH, r"\(d\.bq != 16 && d\.bq != 32 && d\.bq != 64\)",
              "(d.bq != 16 && d.bq != 32 && d.bq != 64 && d.bq != 128)", 1)]
_DQ_FULL4 = [(FLASH, r"constexpr int DQ_NK_FULL = 8,", "constexpr int DQ_NK_FULL = 4,", 1)]
_DQ_EDGE8 = [(FLASH, r"DQ_NK_EDGE = 4;", "DQ_NK_EDGE = 8;", 1)]

# name -> [(file, pattern, replacement, expected matches)]
VARIANTS = {"base": [], "slots1": _SLOTS1, "bq64": [], "qreg": _QREG, "stages3": _STAGES3,
            "promote2": _promote(2), "promote4": _promote(4), "staging_only": _STAGING_ONLY,
            "compute_only": _COMPUTE_ONLY, "no_hash": _NO_HASH, "one_mma": _NO_CORRECTIONS,
            "dkv_generic": _DKV_GENERIC, "dkv_lb3": _DKV_LB3,
            "dq_stages3": _DQ_STAGES3, "dq_promote2": _promote(2, "DQ"),
            "dq_promote4": _promote(4, "DQ"), "dq_generic": _DQ_GENERIC, "dq_lb1": _DQ_LB1,
            "dq_lb4": _DQ_LB4, "dq_bq128": _DQ_BQ128, "dq_full4": _DQ_FULL4,
            "dq_edge8": _DQ_EDGE8}


def _replan(variant: str, kernel: str, p: dict, bh: int, tq: int, num_sms: int) -> dict:
    """The package's plan ``p`` as the variant's kernels take it."""
    ld, kt = p["ld"], ac._KTILE
    if kernel == "K5f" and p["path"] == 0 and variant == "slots1":
        smem = p["smem"] // 2
        per_sm = min(_build.FU_BLOCKS_PER_SM, _build.SM_SMEM // (smem + 1024))
        return dict(p, smem=smem, blocks=min(bh, per_sm * num_sms))
    if kernel == "K5f" and p["path"] == 1:
        if variant == "bq64":
            return dict(p, bq=64, threads=128, blocks=-(-tq // 64) * bh,
                        smem=ac._fwd_tiled_smem(ld, 64))
        if variant == "qreg":   # one plane of q rows, not two
            return dict(p, smem=p["smem"] - 4 * ld * p["bq"])
        if variant == "stages3":
            return dict(p, smem=p["smem"] + 4 * ld * 2 * kt)
    if kernel == "K5dkv" and variant == "stages3":
        return dict(p, smem=p["smem"] + 4 * (2 * kt * ld + 2 * kt))
    if kernel == "K5dq" and variant == "dq_bq128" and tq > 64:
        return dict(p, bq=128, threads=256, blocks=-(-tq // 128) * bh,
                    smem=ac._dq_smem(ld, 128, p["stages"]))
    if kernel == "K5dq" and variant == "dq_stages3" and p["stages"] == 2:
        return dict(p, stages=3, smem=ac._dq_smem(ld, p["bq"], 3))
    return p


# (kernel, shape name, B, Tq, Tk, rate), 8 heads of 25
SHAPES = [("K5f", "self", 4096, 50, 50, 0.1), ("K5f", "cross", 4096, 50, 32, 0.1),
          ("K5f", "long", 16, 2048, 2048, 0.0), ("K5dkv", "long", 16, 2048, 2048, 0.0),
          ("K5dkv", "self", 4096, 50, 50, 0.1), ("K5dkv", "cross", 4096, 50, 32, 0.1),
          ("K5dq", "long", 16, 2048, 2048, 0.0), ("K5dq", "self", 4096, 50, 50, 0.1),
          ("K5dq", "cross", 4096, 50, 32, 0.1)]
HEADS, D = 8, 25


def _source(name: str, src_dir=None) -> Path:
    """A copy of csrc/ (or src_dir) with the variant's edits, checked to match."""
    src = OUT / name / "csrc"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(src_dir or _build._CSRC, src)
    for fname, pattern, repl, count in VARIANTS.get(name, []) if src_dir is None else []:
        path = src / fname
        text, n = re.subn(pattern, repl, path.read_text(), flags=re.M)
        if n != count:
            raise SystemExit(f"{name}: {pattern!r} matched {n} times in {fname}, not {count}")
        path.write_text(text)
    return src


def build(trees):
    """One nvcc a tree, all started together: {name: (fwd, dkv, dq entries)};
    a variant with no edit takes base's."""
    procs = {}
    for name, src_dir in trees.items():
        if name != "base" and src_dir is None and not VARIANTS[name]:
            continue
        src = _source(name, src_dir)
        so = OUT / name / "k5.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(src / FLASH)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        # ptxas names each kernel instance, then gives its spill and register lines
        lines = log.splitlines()
        for i, line in enumerate(lines):
            m = re.search(r"(flash_\w+?kernel)(I\w*?E)?EvPK", line)
            if "Compiling entry" in line and m:
                report = " ".join(x.split(":")[-1].strip() for x in lines[i + 1:i + 5]
                                  if "spill" in x or "registers" in x)
                print(f"{name}: {m.group(1)}{m.group(2) or ''}: {report}", flush=True)
        lib = ctypes.CDLL(str(so))
        entries = []
        for entry in ("mmtr_flash_fwd", "mmtr_flash_bwd_dkv", "mmtr_flash_bwd_dq"):
            fn = getattr(lib, entry)
            fn.restype, fn.argtypes = _build._SIGNATURES[entry]
            entries.append(fn)
        libs[name] = tuple(entries)
    return {name: libs.get(name, libs["base"]) for name in trees}


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


def cases(dev, rng, shapes):
    """Each shape's inputs, the plain forward's out and lse, the plain
    backward's dq, dk and dv (the reference of the kernels)."""
    out = {}
    for kernel, name, B, tq, tk, rate in shapes:
        if (name, rate) in out:
            continue
        offset, bh = 1 + abs(tk - tq), B * HEADS

        def t(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

        q = t(rng.standard_normal((B, HEADS, tq, D)) / np.sqrt(D))
        k, v, dout = (t(rng.standard_normal((B, HEADS, n, D))) for n in (tk, tk, tq))
        seeds = rates = None
        if rate:
            seeds = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, bh).astype(np.int32)).to(dev)
            rates = torch.full((bh,), rate, device=dev)
        o, lse = ac.flash_attention_plain(q, k, v, True, offset, seeds, rates)
        rdq, rdk, rdv = ac.flash_attention_bwd_plain(q, k, v, dout, True, offset, seeds, rates)
        delta = (dout * o).sum(-1).reshape(bh, tq)
        out[(name, rate)] = dict(q=q, k=k, v=v, dout=dout, seeds=seeds, rates=rates,
                                 out=o.contiguous(), lse=lse.contiguous(), delta=delta,
                                 dq=rdq, dk=rdk, dv=rdv, ints=(bh, tq, tk, D, 1, offset, int(bool(rate))))
        torch.cuda.empty_cache()
    return out


def _ptr(x):
    return 0 if x is None else x.data_ptr()


def run(entries, variant, kernel, c, dev):
    """(ms, max error, plan) of one kernel of a variant on one case."""
    bh, tq, tk, d = c["ints"][:4]
    num_sms = _build.num_sms(dev)
    if kernel == "K5f":
        p = _replan(variant, kernel, ac._plan_flash_fwd(bh, tq, tk, d, num_sms), bh, tq, num_sms)
        arr, addr = _build.host_ints([p[x] for x in ac._FF_PLAN_KEYS])
        o, lse = torch.empty_like(c["q"]), torch.empty(bh, tq, device=dev)

        def launch():
            _build.check(entries[0](*map(_ptr, (c["q"], c["k"], c["v"], c["seeds"], c["rates"],
                                                o, lse)), *c["ints"], addr,
                                    _build.stream_ptr(dev)), "K5f trial")

        launch()
        torch.cuda.synchronize()
        err = max((o - c["out"]).abs().max().item(), (lse - c["lse"]).abs().max().item())
    elif kernel == "K5dq":
        p = _replan(variant, kernel, ac._plan_flash_dq(bh, tq, tk, d), bh, tq, num_sms)
        arr, addr = _build.host_ints([p[x] for x in ac._FQ_PLAN_KEYS])
        dq = torch.empty_like(c["q"])

        def launch():
            _build.check(entries[2](*map(_ptr, (c["q"], c["k"], c["v"], c["dout"], c["lse"],
                                                c["delta"], c["seeds"], c["rates"], dq)),
                                    *c["ints"], addr, _build.stream_ptr(dev)), "K5dq trial")

        launch()
        torch.cuda.synchronize()
        err = ((dq - c["dq"]).abs().max() / c["dq"].abs().max()).item()
    else:
        p = _replan(variant, kernel, ac._plan_flash_dkv(bh, tq, tk, d), bh, tq, num_sms)
        arr, addr = _build.host_ints([p[x] for x in ac._FD_PLAN_KEYS])
        dk, dv = torch.empty_like(c["k"]), torch.empty_like(c["v"])

        def launch():
            _build.check(entries[1](*map(_ptr, (c["q"], c["k"], c["v"], c["dout"], c["lse"],
                                                c["delta"], c["seeds"], c["rates"], dk, dv)),
                                    *c["ints"], addr, _build.stream_ptr(dev)), "K5dkv trial")

        launch()
        torch.cuda.synchronize()
        err = max(((g - r).abs().max() / r.abs().max()).item()
                  for g, r in ((dk, c["dk"]), (dv, c["dv"])))
    return cuda_ms(launch), err, p


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--kernels", default="K5f,K5dkv,K5dq")
    ap.add_argument("--csrc", action="append", default=[],
                    help="NAME=DIR: another tree's csrc/, built and timed as is")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    trees = {name: None for name in ["base"] + args.variants.split(",")}
    trees.update(dict(item.split("=", 1) for item in args.csrc))
    libs = build(trees)
    shapes = [s for s in SHAPES if s[0] in args.kernels.split(",")]
    data = cases(dev, np.random.default_rng(7), shapes)
    order = ["base"] + [n for n in trees if n != "base"] + ["base"]
    for i, name in enumerate(order):
        for kernel, shape, B, tq, tk, rate in shapes:
            ms, err, p = run(libs[name], name if name in VARIANTS else "base", kernel,
                             data[(shape, rate)], dev)
            print(json.dumps({"variant": name, "run": i, "kernel": kernel, "shape": shape,
                              "B": B, "Tq": tq, "Tk": tk, "rate": rate, "plan": p, "ms": ms,
                              "max_err": err}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
