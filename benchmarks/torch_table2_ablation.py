"""Table 2 on the PyTorch port (``benchmarks/table2_ablation.py``): DR-RL
ablations on the synthetic corpus.

  Full DR-RL | w/o RL (fixed policy) | w/o perturbation guardrail |
  w/o reward shaping (beta = 0)
"""
from __future__ import annotations

import dataclasses

import torch

from benchmarks.torch_common import (attn_flops_fraction, bench_cfg, eval_ppl,
                                     save_json, train_lm, BENCH_SEQ, BENCH_BATCH)
from repro_torch.core.drrl import init_agent
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.train.rl import train_agent

VARIANTS = {
    "full": {},
    "wo_rl": {"mode": "fixed"},                       # fixed policy
    "wo_perturbation": {"guardrail": False},
    "wo_reward_shaping": {"beta": 0.0},
}
LABELS = {"full": "Full DR-RL", "wo_rl": "w/o RL (Fixed Policy)",
          "wo_perturbation": "w/o Perturbation",
          "wo_reward_shaping": "w/o Reward Shaping"}


def run(steps: int = 50, quick: bool = False, device="cuda") -> dict:
    if quick:
        steps = 20
    results = {}
    warm = train_lm(bench_cfg("off"), steps=max(steps // 3, 5), device=device)
    for name, delta in VARIANTS.items():
        cfg = bench_cfg("drrl")
        rank = dataclasses.replace(cfg.rank, **delta)
        cfg = cfg.with_(rank=rank)
        agent = None
        if rank.mode == "drrl":
            agent = init_agent(torch.Generator(device).manual_seed(7), rank,
                               cfg.d_model, device=device)
            data = SyntheticLM(cfg.vocab_size, BENCH_SEQ, BENCH_BATCH, seed=21)
            agent, _ = train_agent(cfg, warm["params"], agent, data,
                                   bc_steps=3 if quick else 6,
                                   ppo_steps=3 if quick else 8, ppo_epochs=1)
        out = train_lm(cfg, steps=steps, agent=agent, device=device)
        ppl = eval_ppl(cfg, out["params"], out["fns"], agent=agent)
        frac = attn_flops_fraction(cfg, out["params"], agent=agent)
        results[name] = {"label": LABELS[name], "ppl": round(ppl, 3),
                         "attn_flops_frac": round(frac, 4)}
        print(f"  {LABELS[name]:28s} ppl={ppl:8.3f} attn_flops={frac:.3f}")
    save_json("table2", results)
    return results


if __name__ == "__main__":
    run()
