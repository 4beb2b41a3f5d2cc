"""PPO with GAE for the rank policy (paper 4.5.3, stage 2 of the hybrid
training; ``repro.core.ppo``), and the behaviour-cloning loss of stage 1.

Each (layer, kv-head) decision of a rollout is one MDP step; the layer
index is the time axis (ranks evolve layer to layer through the prev-rank
carry).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.core.policy import policy_apply


class Trajectory(NamedTuple):
    feats: Dict[str, torch.Tensor]  # each (T, B, dim)
    actions: torch.Tensor           # (T, B) grid indices
    logp_old: torch.Tensor          # (T, B)
    values_old: torch.Tensor        # (T, B)
    rewards: torch.Tensor           # (T, B)
    action_mask: torch.Tensor       # (T, B, A) bool: the guardrail mask at collect time


def gae(rewards: torch.Tensor, values: torch.Tensor, gamma: float = 0.99,
        lam: float = 0.95) -> Tuple[torch.Tensor, torch.Tensor]:
    """rewards/values: (T, B). The episode ends after the last layer.
    Returns (advantages, returns), both (T, B)."""
    next_values = torch.cat([values[1:], torch.zeros_like(values[:1])], 0)
    deltas = rewards + gamma * next_values - values
    advs, carry = [], torch.zeros_like(deltas[0])
    for t in range(deltas.shape[0] - 1, -1, -1):
        carry = deltas[t] + gamma * lam * carry
        advs.append(carry)
    advs = torch.stack(advs[::-1])
    return advs, advs + values


def ppo_loss(policy_params: dict, traj: Trajectory, *, clip: float = 0.2,
             vf_coef: float = 0.5, ent_coef: float = 0.01
             ) -> Tuple[torch.Tensor, dict]:
    """Clipped surrogate + value loss - entropy bonus over the whole
    trajectory. Returns (loss, {'pg_loss', 'vf_loss', 'entropy',
    'ratio_mean'})."""
    T, B = traj.actions.shape
    feats = {k: v.reshape(T * B, -1) for k, v in traj.feats.items()}
    logits, values = policy_apply(policy_params, feats)
    logits = torch.where(traj.action_mask.reshape(T * B, -1), logits, -1e30)
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, traj.actions.reshape(T * B, 1).long())[:, 0]

    adv, returns = gae(traj.rewards, traj.values_old)
    # jnp.std has ddof 0
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    adv = adv.reshape(T * B)
    returns = returns.reshape(T * B)

    ratio = torch.exp(logp - traj.logp_old.reshape(T * B))
    pg1 = ratio * adv
    pg2 = torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv
    pg_loss = -torch.minimum(pg1, pg2).mean()

    vf_loss = 0.5 * ((values - returns) ** 2).mean()
    probs = torch.exp(logp_all)
    entropy = -torch.where(probs > 1e-12, probs * logp_all,
                           torch.zeros_like(probs)).sum(-1).mean()

    loss = pg_loss + vf_coef * vf_loss - ent_coef * entropy
    metrics = {"pg_loss": pg_loss, "vf_loss": vf_loss, "entropy": entropy,
               "ratio_mean": ratio.mean()}
    return loss, metrics


def bc_loss(policy_params: dict, feats: Dict[str, torch.Tensor],
            oracle_actions: torch.Tensor,
            action_mask: torch.Tensor) -> torch.Tensor:
    """Behaviour cloning (paper 4.5.3 stage 1): cross-entropy to the greedy
    oracle's actions. feats: (N, dim) each; oracle_actions (N,); action_mask
    (N, A). An oracle action the mask forbids costs about 1e30 (its logit is
    exactly -1e30), with a finite gradient, as in the reference."""
    logits, _ = policy_apply(policy_params, feats)
    logits = torch.where(action_mask, logits, -1e30)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, oracle_actions.long()[:, None])[:, 0]
    return nll.mean()
