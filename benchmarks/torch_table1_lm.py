"""Table 1 on the PyTorch port (``benchmarks/table1_lm.py``, small scale):
PPL + FLOPs for Full-Rank, Fixed Low-Rank, Adaptive SVD, Random Rank, and
DR-RL on the synthetic LM corpus.

Paper claims to validate (relative, at reduced scale):
  * DR-RL PPL ~ Full-Rank PPL, better than Fixed/Random/Adaptive
  * DR-RL attention FLOPs fraction < 0.6 of full rank
"""
from __future__ import annotations

import time

import torch

from benchmarks.torch_common import (attn_flops_fraction, bench_cfg, eval_ppl,
                                     save_json, train_lm, BENCH_SEQ, BENCH_BATCH)
from repro_torch.core.drrl import init_agent
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.train.rl import train_agent

METHODS = ("off", "fixed", "adaptive", "random", "drrl")
LABELS = {"off": "Full-Rank", "fixed": "Fixed Low-Rank (r=16)",
          "adaptive": "Adaptive SVD (90%)", "random": "Random Rank",
          "drrl": "DR-RL (ours)"}


def run(steps: int = 60, quick: bool = False, device="cuda") -> dict:
    if quick:
        steps = 20
    results = {}
    for mode in METHODS:
        cfg = bench_cfg(mode)
        agent = None
        t0 = time.monotonic()
        if mode == "drrl":
            # hybrid training (paper 4.5.3): BC warm start + PPO on a
            # briefly pretrained LM, then the LM continues training with the
            # greedy policy active (inference-time adaptation protocol)
            warm = train_lm(bench_cfg("off"), steps=max(steps // 3, 5),
                            device=device)
            agent = init_agent(torch.Generator(device).manual_seed(7), cfg.rank,
                               cfg.d_model, device=device)
            data = SyntheticLM(cfg.vocab_size, BENCH_SEQ, BENCH_BATCH, seed=21)
            agent, _ = train_agent(cfg, warm["params"], agent, data,
                                   bc_steps=3 if quick else 8,
                                   ppo_steps=3 if quick else 10,
                                   ppo_epochs=1)
        out = train_lm(cfg, steps=steps, agent=agent, device=device)
        ppl = eval_ppl(cfg, out["params"], out["fns"], agent=agent)
        frac = attn_flops_fraction(cfg, out["params"], agent=agent)
        results[mode] = {
            "label": LABELS[mode], "ppl": round(ppl, 3),
            "attn_flops_frac": round(frac, 4),
            "train_wall_s": round(out["wall_s"], 1),
            "final_train_loss": round(out["losses"][-1], 4),
            "setup_s": round(time.monotonic() - t0 - out["wall_s"], 1),
        }
        print(f"  {LABELS[mode]:24s} ppl={ppl:8.3f} "
              f"attn_flops={frac:.3f} ({out['wall_s']:.0f}s)")
    save_json("table1", results)
    return results


if __name__ == "__main__":
    run()
