"""Whether the float32 kernels compile to the same machine code in two
checkouts: every ``csrc/*.cu`` of the port compiled to a cubin with the
build's own flags (``_build.NVCC_FLAGS``) in each tree, all at once, then
each kernel's SASS (``cuobjdump -sass``, addresses and encodings dropped)
compared by its demangled name and template arguments.  Kernels with a
bf16 operand exist only where the bf16 instances do and are left out; a
kernel that became a template on its storage type (``<float>``, ``,
float>``, ``, float, float>``) is matched to its old name.  Prints, per
source, the kernels compared, those identical and those that differ (with
their instruction counts, and whether their opcodes and their
floating-point operations are the same multisets, as they are where only
the order and the registers moved), and a last JSON line with the
totals.  Needs the CUDA toolkit, no card.

Run from the repository root, with the other checkout's root:

    python3 tools/float_sass_check.py path/to/other/checkout
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multimodal_transformer_robustness_tpu_torch import _build  # noqa: E402

PKG = "multimodal_transformer_robustness_tpu_torch"


def _tool(name: str) -> str:
    return str(Path(_build._nvcc()).with_name(name))


def _sass(cubin: Path) -> dict:
    """{demangled kernel name: [instructions]} of one cubin."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)], capture_output=True,
                          text=True, check=True).stdout
    kernels, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;?\s*(/\*.*\*/)?\s*$", line)
        if name and m and m.group(1):
            kernels[name].append(m.group(1))
    names = list(kernels)
    demangled = subprocess.run([_tool("cu++filt")], input="\n".join(names), capture_output=True,
                               text=True, check=True).stdout.splitlines()
    out = {}
    for mangled, full in zip(names, demangled):
        if "bfloat16" in mangled or "bfloat16" in full:
            continue
        key = (_name(full).replace(", float, float>", ">").replace(", float>", ">")
               .replace("<float>", ""))
        while key in out:
            key += "'"
        out[key] = kernels[mangled]
    return out


def _opcodes(instructions: list) -> Counter:
    """How often each opcode (with its modifiers, no predicate) occurs."""
    ops = Counter()
    for ins in instructions:
        words = ins.split()
        if words and words[0].startswith("@"):
            words = words[1:]
        if words:
            ops[words[0]] += 1
    return ops


def _float_ops(ops: Counter) -> Counter:
    """The floating-point arithmetic among ``ops``: F* and H* operations,
    MUFU and the MMAs."""
    return Counter({k: v for k, v in ops.items()
                    if k[0] in "FH" or k.startswith(("MUFU", "HMMA", "HGMMA"))})


def _name(full: str) -> str:
    """A demangled kernel's name and template arguments, without its
    return type and parameter list (a template's parameters print as T1,
    T2, ... there, its plain instance's as types)."""
    full = full.strip()
    if full.startswith("void "):
        full = full[5:]
    depth = 0
    for i in range(len(full) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(full[i], 0)
        if depth == 0:
            return full[:i]
    return full


def main() -> int:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    trees = [Path.cwd(), Path(sys.argv[1]).resolve()]
    (Path.cwd() / "build").mkdir(exist_ok=True)
    # a source that the other checkout lacks has no float kernel to compare
    # (flash_attn_bf16.cu and trunk_block_bf16.cu hold bf16 instances only)
    sources = [s for s in _build.SOURCES if (trees[1] / PKG / "csrc" / s).exists()]
    for src in sorted(set(_build.SOURCES) - set(sources)):
        print(f"{src}: only here, not compared", flush=True)
    with tempfile.TemporaryDirectory(dir=Path.cwd() / "build") as tmp:
        jobs = []
        for i, tree in enumerate(trees):
            for src in sources:
                cubin = Path(tmp) / f"{i}_{Path(src).stem}.cubin"
                cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-cubin", "-o", str(cubin),
                       str(tree / PKG / "csrc" / src)]
                jobs.append((i, src, cubin, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        for i, src, _, proc in jobs:
            log = proc.communicate()[0]
            if proc.returncode != 0:
                print(log)
                raise SystemExit(f"{src} does not compile in {trees[i]}")
        total = {"compared": 0, "identical": 0, "differ": 0, "only_here": 0, "only_there": 0}
        for src in sources:
            here, there = (_sass(Path(tmp) / f"{i}_{Path(src).stem}.cubin") for i in (0, 1))
            common = sorted(set(here) & set(there))
            same = [k for k in common if here[k] == there[k]]
            diff = [k for k in common if here[k] != there[k]]
            total["compared"] += len(common)
            total["identical"] += len(same)
            total["differ"] += len(diff)
            total["only_here"] += len(set(here) - set(there))
            total["only_there"] += len(set(there) - set(here))
            print(f"{src}: {len(common)} float kernels compared, {len(same)} identical, "
                  f"{len(diff)} differ; {len(set(here) - set(there))} only here, "
                  f"{len(set(there) - set(here))} only there", flush=True)
            for k in diff:
                a, b = _opcodes(here[k]), _opcodes(there[k])
                fa, fb = _float_ops(a), _float_ops(b)
                print(f"  differs: {k} ({len(here[k])} vs {len(there[k])} instructions; "
                      f"opcodes {'the same' if a == b else 'differ'}, floating-point "
                      f"operations {'the same' if fa == fb else 'differ'}: "
                      f"{dict((a - b) + (b - a)) if a != b else ''})")
            for k in sorted(set(here) ^ set(there)):
                print(f"  only {'here' if k in here else 'there'}: {k}")
    print(json.dumps(total), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
