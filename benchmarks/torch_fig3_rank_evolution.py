"""Fig. 3 on the PyTorch port (``benchmarks/fig3_rank_evolution.py``):
layer-wise rank allocation. The paper's Fig. 3 shows the agent allocating
different computational budgets across layers/time. We report the
per-layer mean rank selected on trained-model spectra (energy policy and
DR-RL agent)."""
from __future__ import annotations

import torch

from benchmarks.torch_common import (bench_cfg, save_json, train_lm, BENCH_BATCH,
                                     BENCH_SEQ)
from repro_torch.core import prng
from repro_torch.core.drrl import init_agent
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models import transformer as tr
from repro_torch.train.rl import train_agent


def run(quick: bool = False, device="cuda") -> dict:
    trained = train_lm(bench_cfg("off"), steps=15 if quick else 60, device=device)
    out = {}
    for mode in ("adaptive", "drrl"):
        cfg = bench_cfg(mode)
        agent = None
        if mode == "drrl":
            agent = init_agent(torch.Generator(device).manual_seed(7), cfg.rank,
                               cfg.d_model, device=device)
            data = SyntheticLM(cfg.vocab_size, BENCH_SEQ, BENCH_BATCH, seed=21)
            agent, _ = train_agent(cfg, trained["params"], agent, data,
                                   bc_steps=3 if quick else 8,
                                   ppo_steps=3 if quick else 8, ppo_epochs=1)
        data = SyntheticLM(cfg.vocab_size, BENCH_SEQ, 4, seed=9)
        extra = {"rank_rng": prng.key(0)}
        if agent is not None:
            extra["policy_params"] = agent
        with torch.no_grad():
            _, aux = tr.forward_dense(cfg, trained["params"],
                                      data.batch_at(0, device=device)["tokens"],
                                      collect_aux="ranks", **extra)
        ranks = aux["layers"]["rank"].float().cpu().numpy()
        per_layer = ranks.mean(axis=(1, 2)).round(2).tolist()
        out[mode] = {"per_layer_mean_rank": per_layer,
                     "overall": round(float(ranks.mean()), 2)}
        print(f"  {mode:9s} per-layer mean rank: {per_layer} "
              f"(grid {cfg.rank.rank_grid})")
    save_json("fig3", out)
    return out


if __name__ == "__main__":
    run()
