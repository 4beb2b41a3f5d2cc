"""Hybrid RL training of the DR-RL agent (paper 4.5.3; ``repro.train.rl``):

  stage 1 — behaviour cloning from the greedy oracle (an exhaustive sweep
            of the Eq. 13 reward over the rank grid, per layer and head),
  stage 2 — PPO on the Eq. 13 reward of live rollouts (the layer index is
            the MDP's time axis).

The LM's params stay frozen (the paper adapts ranks at inference time):
gradients flow only through the agent's policy network. Rollouts and the
oracle are forward passes under ``torch.no_grad()``, so with ``chunked``
their attentions over more than 1024 keys run the ``lowrank_flash``
kernel forward only, its backward never.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import tree as tu
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import ppo as ppo_mod
from repro_torch.core.oracle import oracle_actions
from repro_torch.core.rewards import reward
from repro_torch.models import transformer as tr
from repro_torch.optim import adamw
from repro_torch.optim.schedules import make_lr_fn


def collect_rollout(cfg: ModelConfig, params, agent, batch,
                    generator: Optional[torch.Generator] = None,
                    *, chunked: bool = False,
                    power_v0: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Tuple[ppo_mod.Trajectory, Dict]:
    """One rollout: the forward with fidelity and the agent's actions,
    sampled from ``generator`` (greedy without one, as the reference
    without an rng). Returns a Trajectory with T = num_layers and B =
    batch * kv_heads, and {'reward_mean', 'fidelity_mean', 'rank_mean'}.
    Rollouts mask at eps0: the reference's step argument never reaches the
    guardrail's annealing, so the port has none."""
    _, aux = tr.forward_dense(
        cfg, params, batch["tokens"], policy_params=agent,
        greedy=generator is None, rank_generator=generator,
        compute_fidelity=True, collect_aux="rl", chunked=chunked,
        power_v0=power_v0)
    la = aux["layers"]
    L = cfg.num_layers
    b = batch["tokens"].shape[0]
    hkv, hq = cfg.num_kv_heads, cfg.num_heads
    dh = cfg.resolved_head_dim()

    fid = la["fidelity"]                            # (L, b, hq)
    fid_kv = fid.reshape(L, b, hkv, hq // hkv).mean(-1)
    rw = reward(cfg.rank, fid_kv, la["rank"], la["delta_a_rel"], dh, dh)

    B = b * hkv
    traj = ppo_mod.Trajectory(
        feats={k: v.reshape(L, B, -1) for k, v in la["features"].items()},
        actions=la["action_idx"].reshape(L, B),
        logp_old=la["logp"].reshape(L, B),
        values_old=la["value"].reshape(L, B),
        rewards=rw.reshape(L, B),
        action_mask=la["action_mask"].reshape(L, B, -1),
    )
    metrics = {"reward_mean": rw.mean(), "fidelity_mean": fid.mean(),
               "rank_mean": la["rank"].float().mean()}
    return traj, metrics


def collect_bc_batch(cfg: ModelConfig, params, agent, batch, *,
                     chunked: bool = False,
                     power_v0: Optional[Dict[str, torch.Tensor]] = None
                     ) -> Tuple[Dict, torch.Tensor, torch.Tensor]:
    """(features {name: (N, dim)}, oracle actions (N,), action mask (N, A))
    with N = layers * batch * kv_heads: the greedy forward's Eq. 6 states
    and Eq. 11 masks, and the oracle's action on each layer's q, k, v."""
    _, aux = tr.forward_dense(
        cfg, params, batch["tokens"], policy_params=agent, greedy=True,
        collect_aux="rl", collect_qkv=True, chunked=chunked,
        power_v0=power_v0)
    la = aux["layers"]
    qkv = la["qkv"]                                 # each (L, b, s, h, d)
    oracle = torch.stack([
        oracle_actions(cfg.rank, qkv["q"][li], qkv["k"][li], qkv["v"][li],
                       chunked=chunked)[0]
        for li in range(cfg.num_layers)])           # (L, b, hkv)
    N = oracle.numel()
    feats = {k: v.reshape(N, -1) for k, v in la["features"].items()}
    return feats, oracle.reshape(N), la["action_mask"].reshape(N, -1)


def value_and_grad(fn: Callable, params, *args):
    """(fn(params, *args) detached, the gradient of its first output, or of
    the output itself, with respect to every leaf of ``params``). A leaf
    the output does not depend on gets a zero gradient, as JAX gives."""
    live = tu.tree_map(lambda x: x.detach().requires_grad_(True), params)
    with torch.enable_grad():
        out = fn(live, *args)
        loss = out[0] if isinstance(out, tuple) else out
        grads = torch.autograd.grad(loss, tu.leaves(live), allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(tu.leaves(params), grads)]
    if isinstance(out, tuple):
        out = (out[0].detach(), {k: v.detach() for k, v in out[1].items()})
    else:
        out = out.detach()
    return out, tu.unflatten(params, grads)


def train_agent(cfg: ModelConfig, params, agent, data, *,
                bc_steps: int = 20, ppo_steps: int = 30, ppo_epochs: int = 2,
                lr: float = 3e-4, seed: int = 0, chunked: bool = False,
                power_v0: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[dict, Dict]:
    """The hybrid pipeline on the device of ``params``: ``bc_steps`` BC
    steps on ``data.batch_at(i, device=...)``, then ``ppo_steps`` rollouts
    on ``data.batch_at(1000 + i, ...)`` of ``ppo_epochs`` PPO updates each,
    one AdamW under one schedule throughout. Actions are sampled from a
    ``torch.Generator`` on that device seeded with ``seed``. Returns
    (trained agent, {'bc_loss': [...], 'ppo': [{'reward', 'rank_mean',
    'fidelity', 'loss'}, ...]})."""
    tc = TrainConfig(lr=lr, total_steps=bc_steps + ppo_steps * ppo_epochs,
                     warmup_steps=5, weight_decay=0.0, grad_clip=1.0)
    lr_fn = make_lr_fn(tc)
    opt = adamw.init(agent)
    device = params["embed"].device
    gen = torch.Generator(device=device).manual_seed(seed)
    history = {"bc_loss": [], "ppo": []}

    # ---- stage 1: behaviour cloning -------------------------------------
    for i in range(bc_steps):
        with torch.no_grad():
            feats, ys, mask = collect_bc_batch(
                cfg, params, agent, data.batch_at(i, device=device),
                chunked=chunked, power_v0=power_v0)
        loss, g = value_and_grad(ppo_mod.bc_loss, agent, feats, ys, mask)
        agent, opt, _ = adamw.update(tc, lr_fn, opt, agent, g)
        history["bc_loss"].append(float(loss))

    # ---- stage 2: PPO ----------------------------------------------------
    for i in range(ppo_steps):
        with torch.no_grad():
            traj, metrics = collect_rollout(
                cfg, params, agent, data.batch_at(1000 + i, device=device),
                gen, chunked=chunked, power_v0=power_v0)
        for _ in range(ppo_epochs):
            (loss, _), g = value_and_grad(ppo_mod.ppo_loss, agent, traj)
            agent, opt, _ = adamw.update(tc, lr_fn, opt, agent, g)
        history["ppo"].append({
            "reward": float(metrics["reward_mean"]),
            "rank_mean": float(metrics["rank_mean"]),
            "fidelity": float(metrics["fidelity_mean"]),
            "loss": float(loss),
        })
    return agent, history
