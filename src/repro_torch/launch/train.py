"""Training launcher of the port (``repro.launch.train``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch drrl-paper   # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
        --steps 3 --batch 2 --seq 32
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --reduced --device cpu --steps 3 --batch 4 --seq 32      # 4 gloo ranks

Trains on ``SyntheticLM`` with the reference's flags and ``TrainConfig``
derivation; ``--ckpt-dir`` checkpoints twice per run and resumes from the
latest step there. In rank mode 'drrl' the ranks come from the port's own
agent, ``init_agent`` on a generator seeded 7 (the reference draws its
agent from ``PRNGKey(7)``). As the reference does, it builds the host mesh
(``launch.mesh.make_host_mesh``: every rank of the process group, which it
starts unless one exists, and ends again when the run does, over
("data", "model") = (world, 1)) and the params' partition specs
(``dist.sharding.param_pspecs``), which the checkpoints store. With
more than one rank the params and AdamW state are placed by those specs
and every rank takes the sharded step on its rows of the global batch; on
one rank the params stay plain tensors and the run is the one-device run.
"""
from __future__ import annotations

import argparse

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
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

    own_group = not dist.is_initialized()
    mesh = make_host_mesh(dev)
    try:
        # the params' shapes without their values (the reference's eval_shape)
        pspecs = shd.param_pspecs(fns.init(torch.Generator().manual_seed(tc.seed),
                                           device="meta"), cfg, mesh)
        out = run_training(cfg, tc, init_fn=fns.init, loss_fn=loss_fn, data=data,
                           ckpt_manager=ckpt, param_specs=pspecs, device=dev,
                           mesh=mesh if mesh.size() > 1 else None)
    finally:
        if own_group:       # a group this run started ends with it
            dist.destroy_process_group()
    print(f"final loss: {out['history'][-1]['loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
