"""K1b's device time by kernel (torch.profiler) at the training path's three
shapes, beside its CUDA-event time, and a digest of K1f's outputs, for the
port package of any tree.

Run from the repository root on a card:

    PYTHONPATH=. python3 tools/tree_probe.py [--tree DIR]

``--tree`` (default: this checkout) names the directory whose
``multimodal_transformer_robustness_tpu_torch`` is measured, so that a
parent commit unpacked with ``git archive`` under ``build/`` is measured by
the same cases (``chip_smoke.k1b_split_cases``, ``profile_ms``,
``cuda_ms``) in the same call, and two trees' K1f outputs can be held
bit for bit (sha256 of ``gru_dir``'s output at the training and serving
shapes, inputs from a fixed seed).  Prints one JSON line per shape.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(ROOT))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script measures the port on a card")
    sys.path.insert(0, str(Path(args.tree).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from multimodal_transformer_robustness_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    dev = torch.device("cuda", 0)
    from multimodal_transformer_robustness_tpu_torch.ops import bigru_cuda

    rng = np.random.default_rng(2)
    for in_dim, T, B in ((768, 50, 4096), (768, 64, 1), (512, 64, 1), (200, 50, 4096)):
        ops = bigru_cuda.dir_operands(cs.gru_weights(rng, in_dim, 100, dev))
        x = torch.from_numpy(rng.standard_normal((T, B, in_dim)).astype(np.float32)).to(dev)
        for rev in (False, True):
            out = bigru_cuda.gru_dir(x, ops["wp"], ops["wt"], ops["bc"], ops["bhn"], rev)
            digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
            print(json.dumps({"tree": args.tree, "shape": f"K1f in={in_dim} T={T} B={B} "
                              f"{'bwd' if rev else 'fwd'}", "sha256": digest}), flush=True)
    for name, fn, iters in cs.k1b_split_cases(dev, np.random.default_rng(1)):
        per = cs.profile_ms(fn, iters)
        print(json.dumps({"tree": args.tree, "package": _build.__file__, "shape": name,
                          "event_ms": cs.cuda_ms(fn, iters), "device_ms": sum(per.values()),
                          "kernels_ms": per}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
