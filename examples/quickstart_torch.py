"""Quickstart of the PyTorch port: build a small DR-RL LM, train the rank
agent (behaviour cloning from the greedy oracle, then PPO), run a forward
with the trained agent's ranks, and inspect the decisions.

    PYTHONPATH=src python examples/quickstart_torch.py              # on the GPU
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core.drrl import init_agent
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models import transformer as tr
from repro_torch.models.api import get_model
from repro_torch.train.rl import train_agent


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = ap.parse_args().device

    # 1. model + agent (seeded random weights)
    cfg = get_config("drrl-paper", reduced=True)
    params = get_model(cfg).init(torch.Generator(dev).manual_seed(0), device=dev)
    agent = init_agent(torch.Generator(dev).manual_seed(7), cfg.rank,
                       cfg.d_model, device=dev)
    data = SyntheticLM(cfg.vocab_size, 64, 4, seed=0)

    # 2. hybrid training: behaviour cloning from the greedy oracle, then PPO
    print("training rank agent (BC warm start + PPO)...")
    agent, hist = train_agent(cfg, params, agent, data, bc_steps=5,
                              ppo_steps=8, ppo_epochs=1)
    print(f"  BC loss: {hist['bc_loss'][0]:.3f} -> {hist['bc_loss'][-1]:.3f}")
    print(f"  PPO reward: {hist['ppo'][0]['reward']:.3f} -> "
          f"{hist['ppo'][-1]['reward']:.3f}")

    # 3. forward with the trained agent's greedy ranks under the guardrail
    batch = data.batch_at(123, device=dev)
    with torch.no_grad():
        logits, aux = tr.forward_dense(cfg, params, batch["tokens"],
                                       policy_params=agent, collect_aux="ranks",
                                       compute_fidelity=True)
    ranks = aux["layers"]["rank"].float()                # (L, b, heads)
    print(f"logits: {tuple(logits.shape)}")
    print(f"per-layer mean rank: {ranks.mean(dim=(1, 2)).cpu().numpy().round(1)} "
          f"(grid {cfg.rank.rank_grid})")
    print(f"attention fidelity vs full rank: "
          f"{aux['layers']['fidelity'].mean().item():.4f}")


if __name__ == "__main__":
    main()
