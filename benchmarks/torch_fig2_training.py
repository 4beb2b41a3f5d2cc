"""Fig. 2 on the PyTorch port (``benchmarks/fig2_training.py``): LM loss
curve + RL reward curve during DR-RL training (loss descends; reward
stabilises)."""
from __future__ import annotations

import torch

from benchmarks.torch_common import (bench_cfg, save_json, train_lm, BENCH_BATCH,
                                     BENCH_SEQ)
from repro_torch.core.drrl import init_agent
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.train.rl import train_agent


def run(quick: bool = False, device="cuda") -> dict:
    cfg = bench_cfg("drrl")
    warm = train_lm(bench_cfg("off"), steps=5 if quick else 15, device=device)
    agent = init_agent(torch.Generator(device).manual_seed(7), cfg.rank,
                       cfg.d_model, device=device)
    data = SyntheticLM(cfg.vocab_size, BENCH_SEQ, BENCH_BATCH, seed=21)
    agent, hist = train_agent(cfg, warm["params"], agent, data,
                              bc_steps=3 if quick else 10,
                              ppo_steps=5 if quick else 15, ppo_epochs=1)
    lm = train_lm(cfg, steps=10 if quick else 40, agent=agent, device=device)
    out = {
        "lm_loss_curve": [round(x, 4) for x in lm["losses"]],
        "bc_loss_curve": [round(x, 4) for x in hist["bc_loss"]],
        "reward_curve": [round(h["reward"], 4) for h in hist["ppo"]],
        "rank_curve": [round(h["rank_mean"], 2) for h in hist["ppo"]],
        "fidelity_curve": [round(h["fidelity"], 4) for h in hist["ppo"]],
    }
    print(f"  loss {out['lm_loss_curve'][0]:.3f} -> {out['lm_loss_curve'][-1]:.3f}; "
          f"reward {out['reward_curve'][0]:.3f} -> {out['reward_curve'][-1]:.3f}")
    save_json("fig2", out)
    return out


if __name__ == "__main__":
    run()
