"""Phase 22 of ``chip_smoke.py`` alone: the distribution layer on an NVIDIA
GPU, on a one-rank NCCL group.

    python3 tools/dist_smoke.py

Seeds phase 10's agent and runs ``chip_smoke.check_distribution`` on
drrl-paper at full width: the sharded training step against the plain one
('dp' and 'fsdp_tp' placements), the sharded checkpoint round trip, ring
attention and the pipeline at ring size 1 against ``flash_ref``, and the
training CLI. No kernel runs in it, so none is built. Exits non-zero
without a CUDA device or when a check fails.
"""
from __future__ import annotations

import os
import sys
import time

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)


def main() -> int:
    if not torch.cuda.is_available():
        print("dist_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card()
    cs.log(card)
    paper = cs.get_config("drrl-paper")
    agent = cs.drrl.init_agent(torch.Generator(device=cs.DEV).manual_seed(7),
                               paper.rank, paper.d_model, device=cs.DEV)
    cs.phase("[22/22] distribution on the card, a one-rank NCCL group")
    t0 = time.perf_counter()
    out = cs.check_distribution(paper, agent, card)
    cs.log(f"phase 22 in {time.perf_counter() - t0:.1f} s: {out}")
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
