"""Phase 23 of ``chip_smoke.py`` alone: the dry run on an NVIDIA GPU.

    python3 tools/dryrun_smoke.py

Runs ``chip_smoke.check_dryrun``: qwen2.5-14b's three cells traced on the
(16, 16) production mesh with fake 'cuda' and fake 'cpu' tensors, each in
a subprocess, which must count alike; then the 2-layer train and decode
steps run for real on a one-rank NCCL group against their one-rank
predictions. No kernel runs in it, so none is built. Exits non-zero
without a CUDA device or when a check fails.
"""
from __future__ import annotations

import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)


def main() -> int:
    if not torch.cuda.is_available():
        print("dryrun_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card()
    cs.log(card)
    cs.phase("[23/23] the dry run")
    t0 = time.perf_counter()
    out = cs.check_dryrun(card)
    cs.log(f"phase 23 in {time.perf_counter() - t0:.1f} s: {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
