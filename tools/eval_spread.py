"""The spread of the evaluation phases' host seconds on one card: the
missing-modality sweep (``chip_smoke.sweep_phase``) three times and
``Trainer.fit`` (``chip_smoke.fit_phase``) twice, in one process, each
with its launch checks and its card-vs-CPU comparison.  Prints the card's
name and power limit, each run's statistics and a heading with the host
seconds since start before each run.

Run from the repository root on a card:

    python3 tools/eval_spread.py
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402
from multimodal_transformer_robustness_tpu_torch import _build  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script measures the port on a card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    dev = torch.device("cuda", 0)
    spec, bert_cfg = smoke.mosei()
    for i in range(3):
        smoke.phase(f"sweep {i}")
        print(smoke.sweep_phase(dev, spec, bert_cfg)[1], flush=True)
        torch.cuda.empty_cache()
    for i in range(2):
        smoke.phase(f"fit {i}")
        print(smoke.fit_phase(dev, spec, bert_cfg)[1]["epoch_s"], flush=True)
        torch.cuda.empty_cache()
    smoke.phase("end")


if __name__ == "__main__":
    main()
