"""Batched adaptive serving on the PyTorch port: the DR-RL policy re-picks
each stream's rank bucket every segment (paper section 4.5.2), the
perturbation guardrail vetoes unsafe switches per slot, and heterogeneous
ranks share one fused decode step (factor padding + rank masking; see
repro_torch.serve).

    PYTHONPATH=src python examples/serve_adaptive_torch.py --tokens 96              # on the GPU
    PYTHONPATH=src python examples/serve_adaptive_torch.py --tokens 96 --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import RankConfig
from repro_torch.core.drrl import init_agent
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch.serve import AdaptiveServer
from repro_torch.models.api import get_model
from repro_torch.train.rl import train_agent


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=96)
    ap.add_argument("--segment", type=int, default=16)
    ap.add_argument("--mode", default="drrl",
                    choices=["drrl", "adaptive", "fixed", "off"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    dev = args.device
    cfg = get_config("drrl-paper", reduced=True)
    cfg = cfg.with_(rank=RankConfig(mode=args.mode, rank_grid=(4, 8, 12, 16),
                                    fixed_rank=8, segment_len=args.segment))
    params = get_model(cfg).init(torch.Generator(dev).manual_seed(0), device=dev)

    policy = None
    if args.mode == "drrl":
        policy = init_agent(torch.Generator(dev).manual_seed(7), cfg.rank,
                            cfg.d_model, device=dev)
        data = SyntheticLM(cfg.vocab_size, 48, 2, seed=3)
        print("warm-starting policy (BC + PPO)...")
        policy, _ = train_agent(cfg, params, policy, data, bc_steps=4,
                                ppo_steps=4, ppo_epochs=1)

    server = AdaptiveServer(cfg, params, policy, use_kernel=True, device=dev,
                            max_len=args.prompt_len + args.tokens + 8)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                (args.batch, args.prompt_len))
    res = server.generate(prompts, args.tokens, segment_len=args.segment)
    print(f"decoded {res['tokens'].shape[1]} tokens x {args.batch} streams "
          f"at {res['tok_per_s']:.1f} tok/s "
          f"(compile {res['compile_s']:.2f}s, prefill {res['prefill_s']:.2f}s)")
    print(f"rank schedule (per step, per stream): {res['ranks']}")
    buckets = sorted({r for step in res['ranks'] for r in step if r >= 0})
    print(f"rank buckets exercised: {buckets} (one fused step)")


if __name__ == "__main__":
    main()
