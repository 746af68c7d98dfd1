"""Two ``chip_smoke.py`` outputs side by side, kernel by kernel: from the
``{"kernels": [...]}`` line of each, every kernel's largest error against
its plain version (equal to the last digit where both runs computed the
same bits on the same seeded inputs) and its CUDA-event ms.  Prints a line
a kernel and a last JSON line with the kernels whose errors are equal and
those whose errors differ.

Run with the two saved outputs:

    python3 tools/kernel_lines_diff.py before.txt after.txt
"""

from __future__ import annotations

import json
import sys


def kernels(path: str) -> dict:
    with open(path, errors="replace") as f:
        for line in f:
            if line.startswith('{"kernels"'):
                return {k["name"]: k for k in json.loads(line)["kernels"]}
    raise SystemExit(f"{path}: no kernels line")


def main() -> int:
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    a, b = kernels(sys.argv[1]), kernels(sys.argv[2])
    same, differ = [], []
    for name in a:
        if name not in b:
            continue
        ea, eb = a[name]["max_abs_err"], b[name]["max_abs_err"]
        (same if ea == eb else differ).append(name)
        print(f"{name}: max_abs_err {ea!r} / {eb!r} ({'equal' if ea == eb else 'differ'}); "
              f"ms {a[name]['ms']!r} / {b[name]['ms']!r}")
    print(json.dumps({"equal": same, "differ": differ,
                      "only_before": sorted(set(a) - set(b)),
                      "only_after": sorted(set(b) - set(a))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
