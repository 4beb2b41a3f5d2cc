"""Phase 19 of ``chip_smoke.py`` alone: the port's invariant checker on an
NVIDIA GPU.

    python3 tools/invariants_smoke.py

Builds ``flash_decode`` (every sanitizer scenario serves through it), seeds
phase 3's full-width drrl-paper weights and runs
``chip_smoke.check_invariants``: the selftest and static pass in their own
processes, the runtime sanitizer's four scenarios at full width, the
negative control, and the sync sites of phase 3's adaptive serving run.
Exits non-zero without a CUDA device or when a check fails.
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
        print("invariants_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card()
    cs.log(card)
    secs = cs.build.build(["decode_attn"])
    cs.log("built " + ", ".join(f"{k} in {v:.1f} s" for k, v in secs.items()))
    cfg = cs.get_config("drrl-paper").with_(
        rank=cs.RankConfig(mode="adaptive", rank_grid=cs.GRID, segment_len=32))
    params = cs.get_model(cfg).init(torch.Generator(device=cs.DEV).manual_seed(0),
                                    device=cs.DEV)
    cs.phase("[19/19] the invariant checker")
    t0 = time.perf_counter()
    out = cs.check_invariants(cfg, params, card)
    cs.log(f"phase 19 in {time.perf_counter() - t0:.1f} s: {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
