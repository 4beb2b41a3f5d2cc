"""Table 3 on the PyTorch port (``benchmarks/table3_downstream.py``):
downstream classification (SST-2 analogue).

Pretrain a small LM once, attach a classification head on the mean-pooled
final hidden state, fine-tune with each attention method active, report
accuracy. Adds the static baselines the paper compares against: Performer
(FAVOR+) and Nystromformer.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmarks.torch_common import (bench_cfg, rank_kwargs, save_json, train_lm,
                                     BENCH_BATCH)
from repro_torch import nn
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import prng
from repro_torch.core.drrl import init_agent
from repro_torch.data.synthetic import SyntheticClassification, SyntheticLM
from repro_torch.models import transformer as tr
from repro_torch.optim import adamw
from repro_torch.optim.schedules import make_lr_fn
from repro_torch.train.rl import train_agent, value_and_grad

METHODS = ("off", "performer", "nystrom", "fixed", "adaptive", "drrl")
LABELS = {"off": "Full-Rank", "performer": "Performer",
          "nystrom": "Nystromformer", "fixed": "Fixed Rank (r=16)",
          "adaptive": "Adaptive SVD", "drrl": "DR-RL (ours)"}
CLS_SEQ = 64


def cls_loss(cfg: ModelConfig, params, batch, *, agent=None, proj=None):
    """(mean nll, accuracy) of the classifier ``params`` {'trunk': the LM,
    'head': (d_model, 2)} on ``batch`` {'tokens', 'labels'}: the head on
    the f32 mean over positions of the LM's final hidden state. Rank key
    ``key(0)`` in rank modes 'drrl' and 'random'; ``proj`` the Performer
    feature matrices (drawn by the forward when None)."""
    _, aux = tr.forward_dense(cfg, params["trunk"], batch["tokens"],
                              return_hidden=True, proj=proj,
                              **rank_kwargs(cfg, agent, prng.key(0)))
    pooled = aux["hidden"].float().mean(dim=1)
    cls = nn.linear(pooled, params["head"].to(pooled.dtype))
    labels = batch["labels"].long()
    logp = F.log_softmax(cls, dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    acc = (cls.argmax(-1) == labels).float().mean()
    return nll.mean(), acc


def run(ft_steps: int = 60, quick: bool = False, device="cuda") -> dict:
    if quick:
        ft_steps = 25
    base = train_lm(bench_cfg("off"), steps=10 if quick else 40, device=device)
    results = {}
    for mode in METHODS:
        cfg = bench_cfg(mode)
        agent = None
        if mode == "drrl":
            agent = init_agent(torch.Generator(device).manual_seed(7), cfg.rank,
                               cfg.d_model, device=device)
            lm_data = SyntheticLM(cfg.vocab_size, CLS_SEQ, BENCH_BATCH,
                                  seed=21)
            agent, _ = train_agent(cfg, base["params"], agent, lm_data,
                                   bc_steps=3 if quick else 6,
                                   ppo_steps=3 if quick else 8, ppo_epochs=1)

        params = {"trunk": base["params"],
                  "head": nn.dense_init(torch.Generator(device).manual_seed(5),
                                        cfg.d_model, 2, device=device)}
        data = SyntheticClassification(cfg.vocab_size, CLS_SEQ, BENCH_BATCH,
                                       seed=4)
        tc = TrainConfig(lr=2e-3, total_steps=ft_steps,
                         warmup_steps=max(ft_steps // 10, 1),
                         weight_decay=0.0)
        lr_fn = make_lr_fn(tc)
        opt = adamw.init(params)
        for i in range(ft_steps):
            _, g = value_and_grad(
                lambda p, b: cls_loss(cfg, p, b, agent=agent)[0], params,
                data.batch_at(i, device=device))
            params, opt, _ = adamw.update(tc, lr_fn, opt, params, g)
        with torch.no_grad():
            accs = [float(cls_loss(cfg, params, data.batch_at(5000 + i, device=device),
                                   agent=agent)[1]) for i in range(6)]
        acc = float(np.mean(accs))
        results[mode] = {"label": LABELS[mode], "accuracy": round(acc, 4)}
        print(f"  {LABELS[mode]:20s} acc={acc:.4f}")
    save_json("table3", results)
    return results


if __name__ == "__main__":
    run()
