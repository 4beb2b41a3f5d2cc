"""End-to-end driver on the PyTorch port: train the ~100M-parameter GPT-small
class LM with DR-RL dynamic-rank attention for a few hundred steps, with
checkpointing and resume, on one device.

    PYTHONPATH=src python examples/train_lm_100m_torch.py --steps 300      # on the GPU
    PYTHONPATH=src python examples/train_lm_100m_torch.py --reduced --device cpu \
        --steps 3 --batch 2 --seq 32

Run it again with the same ``--ckpt`` and more ``--steps`` and it resumes
from the latest checkpoint. ``--reduced`` trains the 2-layer test model
instead (a CPU smoke run).
"""
import argparse
import os
import tempfile

import torch

from repro_torch import tree as tu
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import RankConfig, TrainConfig
from repro_torch.core.drrl import init_agent
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models.api import get_model
from repro_torch.train.loop import run_training


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--drrl", action="store_true", default=True)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_lm100m"))
    ap.add_argument("--reduced", action="store_true",
                    help="the 2-layer test model instead of GPT-small")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    dev = args.device
    # ~100M params: GPT-small geometry (12L x 768d, 50k vocab)
    cfg = get_config("drrl-paper", reduced=args.reduced)
    if not args.drrl:
        cfg = cfg.with_(rank=RankConfig(mode="off"))
    fns = get_model(cfg)

    agent = None
    if cfg.rank.mode == "drrl":
        agent = init_agent(torch.Generator(dev).manual_seed(7), cfg.rank,
                           cfg.d_model, device=dev)

    tc = TrainConfig(global_batch=args.batch, seq_len=args.seq, lr=3e-4,
                     total_steps=args.steps,
                     warmup_steps=max(args.steps // 20, 1),
                     checkpoint_every=max(args.steps // 3, 1),
                     checkpoint_dir=args.ckpt)
    data = SyntheticLM(cfg.vocab_size, tc.seq_len, tc.global_batch, seed=0)
    ckpt = CheckpointManager(tc.checkpoint_dir)

    def loss_fn(p, b, rng):
        extra = ({"policy_params": agent, "rank_rng": rng}
                 if cfg.rank.mode == "drrl" else {})
        return fns.loss(p, b, **extra)

    def init_fn(gen, device):
        params = fns.init(gen, device=device)
        n = sum(x.numel() for x in tu.leaves(params))
        print(f"model: {cfg.name} {cfg.num_layers}L x {cfg.d_model}d, "
              f"{n / 1e6:.1f}M params, rank mode = {cfg.rank.mode}, on {device}")
        return params

    out = run_training(cfg, tc, init_fn=init_fn, loss_fn=loss_fn, data=data,
                       ckpt_manager=ckpt, device=dev)
    h = out["history"]
    if h:
        print(f"loss: {h[0]['loss']:.3f} -> {h[-1]['loss']:.3f} over steps "
              f"{h[0]['step']}..{h[-1]['step']}; checkpoints in {tc.checkpoint_dir}")


if __name__ == "__main__":
    main()
