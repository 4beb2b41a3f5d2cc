"""Training launcher of the port (``repro.launch.train``), on one device:

    PYTHONPATH=src python -m repro_torch.launch.train --arch drrl-paper   # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
        --steps 3 --batch 2 --seq 32

Trains on ``SyntheticLM`` with the reference's flags and ``TrainConfig``
derivation; ``--ckpt-dir`` checkpoints twice per run and resumes from the
latest step there. In rank mode 'drrl' the ranks come from the port's own
agent, ``init_agent`` on a generator seeded 7 (the reference draws its
agent from ``PRNGKey(7)``). The reference's host mesh and parameter
partition specs are not built: the port trains on one device, and
multi-device training is ROADMAP item 19.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models.api import get_model
from repro_torch.train.loop import run_training


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="drrl-paper")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", default="none")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = args.device
    cfg = get_config(args.arch, reduced=args.reduced)
    fns = get_model(cfg)
    tc = TrainConfig(global_batch=args.batch, seq_len=args.seq, lr=args.lr,
                     total_steps=args.steps, warmup_steps=max(args.steps // 10, 1),
                     microbatches=args.microbatches,
                     grad_compression=args.grad_compression,
                     checkpoint_every=max(args.steps // 2, 1),
                     checkpoint_dir=args.ckpt_dir or f"/tmp/repro_{args.arch}")
    data = SyntheticLM(cfg.vocab_size, tc.seq_len, tc.global_batch, tc.seed)
    ckpt = CheckpointManager(tc.checkpoint_dir) if args.ckpt_dir else None

    kw = {}
    if cfg.rank.mode == "drrl":
        from repro_torch.core.drrl import init_agent
        agent = init_agent(torch.Generator(dev).manual_seed(7), cfg.rank,
                           cfg.d_model, device=dev)
        kw = {"policy_params": agent}

    def loss_fn(p, b, rng):
        extra = {"rank_rng": rng, **kw} if cfg.rank.mode == "drrl" else {}
        return fns.loss(p, b, **extra)

    out = run_training(cfg, tc, init_fn=fns.init, loss_fn=loss_fn, data=data,
                       ckpt_manager=ckpt, device=dev)
    print(f"final loss: {out['history'][-1]['loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
