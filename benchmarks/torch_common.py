"""Shared harness of the paper's tables and figures on the PyTorch port
(the counterpart of ``benchmarks/common.py``, which imports JAX).

The protocol is the reference's, at its reduced scale: the paper's
datasets are unavailable offline, so the seeded synthetic corpora stand in
and results compare relatively (method orderings and reduction
percentages, not absolute perplexity). Every entry point that creates
parameters runs on ``device`` (default ``cuda``); the others run on the
device of the parameters they are given. The forward runs unchunked at
``BENCH_SEQ`` tokens, as the reference's does, so neither attention kernel
runs here.

    PYTHONPATH=src python -m benchmarks.torch_run --quick
"""
from __future__ import annotations

import json
import pathlib
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, RankConfig, TrainConfig
from repro_torch.core import prng
from repro_torch.core.rewards import flops_fraction
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models import transformer as tr
from repro_torch.models.api import get_model
from repro_torch.optim import adamw
from repro_torch.train.loop import make_train_step

ART = pathlib.Path(__file__).resolve().parent / "artifacts"

BENCH_SEQ = 128
BENCH_BATCH = 8
BENCH_STEPS = 80
BENCH_VOCAB_SEED = 11


def bench_cfg(mode: str, **rank_kw) -> ModelConfig:
    """The reduced drrl-paper model at 4 layers of d_model 128 (4 heads of
    32, d_ff 256, vocabulary 512), rank grid 8 ... 32, fixed rank 16, in
    rank mode ``mode``."""
    base = get_config("drrl-paper", reduced=True)
    # slightly larger than the smoke config so spectra are non-trivial
    base = base.with_(num_layers=4, d_model=128, num_heads=4, num_kv_heads=4,
                      head_dim=32, d_ff=256, vocab_size=512)
    grid = (8, 12, 16, 20, 24, 28, 32)
    return base.with_(rank=RankConfig(mode=mode, rank_grid=grid,
                                      fixed_rank=16, **rank_kw))


def rank_kwargs(cfg: ModelConfig, agent, rng) -> Dict:
    """The loss's rank arguments: the agent and ``rng`` in rank mode
    'drrl', ``rng`` alone in 'random', none otherwise."""
    if cfg.rank.mode == "drrl":
        return {"policy_params": agent, "rank_rng": rng}
    if cfg.rank.mode == "random":
        return {"rank_rng": rng}
    return {}


def train_lm(cfg: ModelConfig, *, steps: int = BENCH_STEPS, seed: int = 0,
             agent=None, drrl_refresh: int = 20, device="cuda") -> Dict:
    """Train the bench LM on ``device`` with the given rank mode active
    during forward (the paper's protocol: identical hyperparameters across
    methods). Parameters come from ``get_model(cfg).init`` on a generator
    seeded ``seed``; step i's rank key is ``fold_in(key(7), i)``, on the
    CPU. ``drrl_refresh`` is unused, as in the reference."""
    del drrl_refresh
    if cfg.rank.mode == "drrl" and agent is None:
        raise ValueError("rank mode 'drrl' trains with an agent: pass agent=")
    fns = get_model(cfg)
    tc = TrainConfig(global_batch=BENCH_BATCH, seq_len=BENCH_SEQ, lr=1e-3,
                     total_steps=steps, warmup_steps=steps // 10,
                     weight_decay=0.01, seed=seed)
    data = SyntheticLM(cfg.vocab_size, BENCH_SEQ, BENCH_BATCH,
                       seed=BENCH_VOCAB_SEED)

    def loss_fn(p, b, rng):
        return fns.loss(p, b, **rank_kwargs(cfg, agent, rng))

    step_fn = make_train_step(cfg, tc, loss_fn)
    params = fns.init(torch.Generator(device).manual_seed(seed), device=device)
    opt = adamw.init(params)
    losses = []
    t0 = time.monotonic()
    for i in range(steps):
        params, opt, m = step_fn(params, opt, data.batch_at(i, device=device),
                                 prng.fold_in(prng.key(7), i))
        losses.append(float(m["loss"]))
    wall = time.monotonic() - t0
    return {"params": params, "losses": losses, "wall_s": wall, "fns": fns,
            "tc": tc}


def eval_ppl(cfg: ModelConfig, params, fns, *, agent=None, n_batches: int = 8,
             seed: int = 999) -> float:
    """exp of the mean loss over batches 10_000 ... of ``SyntheticLM(seed)``
    (rank key ``key(0)``), on the parameters' device."""
    device = params["embed"].device
    data = SyntheticLM(cfg.vocab_size, BENCH_SEQ, BENCH_BATCH, seed=seed)
    extra = rank_kwargs(cfg, agent, prng.key(0))
    tot = 0.0
    with torch.no_grad():
        for i in range(n_batches):
            tot += float(fns.loss(params, data.batch_at(10_000 + i, device=device),
                                  **extra)[0])
    return float(np.exp(tot / n_batches))


def attn_flops_fraction(cfg: ModelConfig, params, *, agent=None,
                        seed: int = 3) -> float:
    """Measured mean attention-FLOPs fraction vs full rank (score+value
    terms, Eq. 8 normalisation) over one eval batch."""
    if cfg.rank.mode == "off":
        return 1.0
    if cfg.rank.mode in ("performer", "nystrom"):
        # linear methods: features/landmarks m vs seq: (m + dv) / (s + dv)
        dh = cfg.resolved_head_dim()
        m = max(2 * dh, 4 * cfg.rank.fixed_rank) if cfg.rank.mode == "performer" \
            else cfg.rank.fixed_rank
        return float((m + dh) / (BENCH_SEQ + dh))
    data = SyntheticLM(cfg.vocab_size, BENCH_SEQ, BENCH_BATCH, seed=seed)
    extra = {"collect_aux": "ranks", "rank_rng": prng.key(1)}
    if cfg.rank.mode == "drrl":
        extra["policy_params"] = agent
    with torch.no_grad():
        tokens = data.batch_at(0, device=params["embed"].device)["tokens"]
        _, aux = tr.forward_dense(cfg, params, tokens, **extra)
    dh = cfg.resolved_head_dim()
    frac = flops_fraction(aux["layers"]["rank"], dh, dh)
    return float(np.mean(frac.cpu().numpy()))


def save_json(name: str, obj) -> pathlib.Path:
    """Write ``obj`` to ``benchmarks/artifacts/torch_<name>.json`` (beside
    the reference's ``<name>.json``, never over it)."""
    ART.mkdir(parents=True, exist_ok=True)
    p = ART / f"torch_{name}.json"
    p.write_text(json.dumps(obj, indent=2))
    return p
