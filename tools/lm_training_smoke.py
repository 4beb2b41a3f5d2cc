"""Phase 17 of ``chip_smoke.py`` alone: the LM training stack at full width
on an NVIDIA GPU.

    python3 tools/lm_training_smoke.py

Builds both kernels (17e serves through ``flash_decode``), seeds phase 10's
agent and runs ``chip_smoke.check_lm_training`` on drrl-paper in its own
rank mode 'drrl': the training CLI with a resume, a resumed
``run_training`` against a straight one, bf16-accumulated microbatches,
one step profiled, the checkpoint served, and the reduced model card vs
CPU. Exits non-zero without a CUDA device or when a check fails.
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
        print("lm_training_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card()
    cs.log(card)
    secs = cs.build.build(["decode_attn", "lowrank_flash"])
    cs.log("built " + ", ".join(f"{k} in {v:.1f} s" for k, v in secs.items()))
    paper = cs.get_config("drrl-paper")
    agent = cs.drrl.init_agent(torch.Generator(device=cs.DEV).manual_seed(7),
                               paper.rank, paper.d_model, device=cs.DEV)
    cs.phase("[17/17] the LM training stack at full width")
    t0 = time.perf_counter()
    out = cs.check_lm_training(paper, agent, card)
    cs.log(f"phase 17 in {time.perf_counter() - t0:.1f} s: {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
