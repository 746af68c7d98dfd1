"""K7b's two forms side by side at G=2 H=100: the tiled backward recurrence
(``csrc/gru_rec.cuh``'s ``gru_rec_bwd_tiled_kernel``, K1b's, over G groups)
and the row form (``csrc/gru_recurrence.cu``'s ``gru_rec_bwd_row_kernel``, a
block a row), each forced through ``ops.gru_cuda``'s plan, over N from one
row to the MOSEI header level.  Per shape and form: the CUDA-event ms
(median of 20, or 5 at N=4096), the largest error against
``gru_recurrence_bwd_plain`` as a share of each output's max |ref| (K7b's
tolerance is 1e-4), and which form the plan picks (``_plan_gru_rec_bwd``).
Inputs from a fixed seed; the same inputs for both forms.

    PYTHONPATH=. python3 tools/k7b_trials.py

Needs one H100 and nvcc.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from multimodal_transformer_robustness_tpu_torch import _build
from multimodal_transformer_robustness_tpu_torch.ops import bigru_cuda, gru_cuda

ROOT = Path(__file__).resolve().parent.parent
SHAPES = ((2, 64, 1), (2, 50, 1), (2, 50, 16), (2, 50, 66), (2, 50, 67), (2, 50, 132),
          (2, 50, 264), (2, 50, 265), (2, 50, 400), (2, 50, 4096))
H = 100


def forms(G, N, num_sms):
    """{form: the plan ops/gru_cuda would hand the kernel for it}."""
    return {"tiled": {"row": 0, **bigru_cuda._plan_rec_bwd(G, N, H, num_sms)},
            "row": gru_cuda._plan_gru_rec_bwd(G, N, H, num_sms=G * N)}


def main() -> int:
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
    _build.load_library()
    num_sms = _build.num_sms(dev)
    rng = np.random.default_rng(21)
    chosen = gru_cuda._plan_gru_rec_bwd
    for G, T, N in SHAPES:
        k = 1.0 / np.sqrt(H)

        def t(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

        gates = [t(rng.standard_normal((G, T, N, H))) for _ in range(3)]
        weights = [t(rng.uniform(-k, k, (G, H, H))) for _ in range(3)]
        biases = [t(rng.uniform(-k, k, (G, H))) for _ in range(3)]
        hs = gru_cuda.gru_recurrence_cuda(*gates, *weights, *biases)
        args = (*gates, hs, t(rng.standard_normal((G, T, N, H))), *weights, *biases)
        refs = gru_cuda.gru_recurrence_bwd_plain(*args)
        row = {"shape": f"G={G} T={T} N={N} H={H}",
               "plan_picks": "row" if chosen(G, N, H, num_sms)["row"] else "tiled"}
        for name, plan in forms(G, N, num_sms).items():
            gru_cuda._plan_gru_rec_bwd = lambda *a, plan=plan, **kw: plan
            gru_cuda._cached_bwd_plan.cache_clear()
            try:
                got = gru_cuda.gru_recurrence_bwd_cuda(*args)
                torch.cuda.synchronize()
                err = max(((a - r).abs().max() / r.abs().max()).item()
                          for a, r in zip(got, refs))
                ms = cs.cuda_ms(lambda: gru_cuda.gru_recurrence_bwd_cuda(*args),
                                5 if N > 1000 else 20)
            finally:
                gru_cuda._plan_gru_rec_bwd = chosen
                gru_cuda._cached_bwd_plan.cache_clear()
            row[name] = {"ms": ms, "rel_err": err, "blocks": plan["blocks"],
                         "rows": plan["rows"]}
        print(json.dumps(row), flush=True)
        del gates, hs, args, refs
    return 0


if __name__ == "__main__":
    sys.exit(main())
