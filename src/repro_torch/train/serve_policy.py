"""Offline trainer of the serving rank policy (rank mode 'learned'; the port
of ``repro.train.serve_policy``).

The engine records per-segment rank decisions (``serve.traces``); this
module rebuilds the Eq. 6 policy features from those records the way
serving's decision builds them, and trains the Transformer policy offline:

  stage 1a: BC to the recorded (adaptive-heuristic) actions,
  stage 1b: BC to the constrained greedy oracle: per record, the rank-grid
            argmax of the counterfactual Eq. 13 reward under the Eq. 11
            safety mask, among kept ranks no higher than the recorded one
            (so the oracle never loses reward to the heuristic and never
            reads more factor bytes),
  stage 2:  PPO (core/ppo.py) over per-request trajectories ordered by
            segment clock, the trace's actions re-scored under the current
            policy (deterministic: nothing is sampled).

Serving's 'drrl'/'learned' decision calls ``core.drrl.build_features`` with
``h_t = 0``, ``w_t = 0``, layer 0 and the spectra-only context
``{"k_s2": s2, "q_s2": prev_s2}``; the trainer calls it the same way, so a
checkpoint from here serves through ``Engine(cfg, params,
load_policy(dir))`` unchanged. The trainer runs on ``device`` (the card
unless the caller asks for the CPU); checkpoints are
``checkpoint.manager.CheckpointManager``'s plus a ``policy_meta.json``
sidecar that names the architecture, in the reference's format.
"""
from __future__ import annotations

import json
import pathlib
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import RankConfig, TrainConfig
from repro_torch.core import lowrank as lr
from repro_torch.core import perturbation as pert
from repro_torch.core import ppo as ppo_mod
from repro_torch.core.drrl import build_features, feat_dims, rank_grid_index
from repro_torch.core.policy import POLICY_HEADS, init_policy, policy_apply
from repro_torch.core.rewards import flops_fraction
from repro_torch.core.rewards import reward as eq13_reward
from repro_torch.optim import adamw
from repro_torch.optim.schedules import make_lr_fn
from repro_torch.serve.traces import TraceReader
from repro_torch.train.rl import value_and_grad

__all__ = ["POLICY_ARCH", "build_dataset", "evaluate_policy",
           "greedy_actions", "load_policy", "train_serve_policy"]

# architecture of the serving policy net, recorded in policy_meta.json so
# load_policy can rebuild the checkpoint's template
POLICY_ARCH = {"d_pol": 64, "n_layers": 2, "n_heads": 4, "d_ff": 128}
_H_DIM = 8      # h_t width: serving feeds zeros of this width


def _init(gen: torch.Generator, dims: Dict[str, int], n_actions: int,
          arch: Dict, device) -> dict:
    if arch["n_heads"] != POLICY_HEADS:
        raise ValueError(f"policy with {arch['n_heads']} heads: the port's "
                         f"policy network has {POLICY_HEADS}")
    return init_policy(gen, dims, n_actions, d_pol=arch["d_pol"],
                       n_layers=arch["n_layers"], d_ff=arch["d_ff"],
                       device=device)


def build_dataset(trace, rank_cfg: RankConfig, *, device="cuda") -> Dict:
    """Policy features and counterfactual rewards from a trace (a
    TraceReader or its directory), as tensors on ``device``: per-head-row
    features (the (N*h, dim) layout bc_loss takes), per-record actions,
    safety masks, the (N, G) reward matrix and the oracle, and the
    request/segment bookkeeping PPO trajectories are cut from."""
    reader = trace if isinstance(trace, TraceReader) else TraceReader(trace)
    rec = reader.records
    if not rec or rec["slot"].size == 0:
        raise ValueError(f"trace at {getattr(reader, 'dir', trace)} is empty")

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    s2 = t(rec["s2"], torch.float32)                    # (N, h, d)
    prev_s2 = t(rec["prev_s2"], torch.float32)
    N, h, d = s2.shape
    grid = t(rank_cfg.rank_grid, torch.long)
    G = int(grid.shape[0])

    # features exactly as the decision's drrl/learned branch builds them
    prev = t(rec["prev_rank"], torch.int32)[:, None].expand(N, h)
    feats, (_, _, bounds_rel, _) = build_features(
        rank_cfg, {"k_s2": s2, "q_s2": prev_s2},
        torch.zeros((N, _H_DIM), device=device),
        torch.zeros((9,), device=device), 0, prev)

    # Eq. 11 mask at each record's own segment clock; the decision
    # head-means the masked logits, so one vetoing head row removes the
    # action for the whole slot
    eps_t = pert.annealed_threshold(rank_cfg.epsilon0, rank_cfg.anneal_lambda,
                                    t(rec["seg_t"], torch.float32))
    mask_rows = pert.safety_mask(bounds_rel.reshape(N * h, G),
                                 torch.repeat_interleave(eps_t, h)[:, None])
    mask_rec = mask_rows.reshape(N, h, G).all(dim=1)

    # counterfactual Eq. 13 reward of every grid action at this state
    fid_g = lr.ner_curve(s2)[..., (grid - 1).clamp(0, d - 1)].mean(dim=1)
    rel_g = bounds_rel.mean(dim=1)                      # (N, G)
    rew = eq13_reward(rank_cfg, fid_g, grid[None, :], rel_g, d, d)

    actions = rank_grid_index(rank_cfg, t(rec["chosen_rank"], torch.int32))
    # constrained oracle: best masked reward at a kept rank no higher than
    # the recorded choice, which is always feasible
    feas = mask_rec & (grid[None, :] <= grid[actions][:, None])
    feas[torch.arange(N, device=device), actions] = True
    oracle = torch.argmax(torch.where(feas, rew, -torch.inf), dim=-1)
    return {
        "feats": feats, "mask_rows": mask_rows, "mask_rec": mask_rec,
        "actions": actions, "oracle": oracle, "reward_matrix": rew,
        "fid": fid_g, "grid": grid, "n": N, "h": h, "d": d,
        "rid": np.asarray(rec["rid"]), "seg_t": np.asarray(rec["seg_t"]),
    }


def greedy_actions(policy_params: dict, ds: Dict) -> torch.Tensor:
    """Per-record grid index serving's decision would pick: mask each head
    row, head-mean the logits, argmax."""
    with torch.no_grad():
        logits, _ = policy_apply(policy_params, ds["feats"])
    logits = torch.where(ds["mask_rows"], logits, -1e30)
    return torch.argmax(logits.reshape(ds["n"], ds["h"], -1).mean(dim=1), dim=-1)


def evaluate_policy(ds: Dict, rank_cfg: RankConfig,
                    policy_params: Optional[dict] = None,
                    actions: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """Offline replay on the dataset's own reward matrix: Eq. 13 reward,
    mean kept rank, agreement (retained spectral energy) and factor-read
    fraction of a fixed action stream (``actions``) or of a policy through
    the greedy serving mirror (``policy_params``)."""
    if actions is None:
        if policy_params is None:
            raise ValueError("need policy_params or actions")
        actions = greedy_actions(policy_params, ds)
    actions = torch.as_tensor(actions, device=ds["grid"].device).long()
    idx = torch.arange(ds["n"], device=actions.device)
    ranks = ds["grid"][actions].float()
    return {
        "reward": float(ds["reward_matrix"][idx, actions].mean()),
        "mean_rank": float(ranks.mean()),
        "agreement": float(ds["fid"][idx, actions].mean()),
        "read_frac": float(flops_fraction(ranks, ds["d"], ds["d"]).mean()),
    }


def _windows(ds: Dict, t_win: int) -> np.ndarray:
    """(W, T) record-index windows: each request's records ordered by
    segment clock, cut into length-T trajectories; T = 1 when every
    request is shorter than ``t_win``."""
    rid, seg = ds["rid"], ds["seg_t"]
    order = np.lexsort((seg, rid))
    wins = []
    for r in np.unique(rid):
        seq = order[rid[order] == r]
        for s in range(0, len(seq) - t_win + 1, t_win):
            wins.append(seq[s:s + t_win])
    if not wins:
        return np.arange(ds["n"], dtype=np.int64)[:, None]
    return np.stack(wins)


def _make_traj(agent: dict, ds: Dict, wins: np.ndarray) -> ppo_mod.Trajectory:
    """Offline PPO batch: the trace's actions re-scored under the current
    policy for logp_old / values_old; the clip term then bounds the update
    away from the behaviour data."""
    W, T = wins.shape[0], wins.shape[1]
    h, G = ds["h"], int(ds["grid"].shape[0])
    dev = ds["grid"].device
    rec_sel = torch.as_tensor(wins.T, device=dev)           # (T, W)
    # head-row indices, record-major so each record's h rows stay adjacent
    rows = (rec_sel[..., None] * h + torch.arange(h, device=dev)).reshape(-1)
    feats = {k: v[rows].reshape(T, W * h, -1) for k, v in ds["feats"].items()}
    mask = ds["mask_rows"][rows].reshape(T, W * h, G)
    act_rec = ds["actions"][rec_sel]                        # (T, W)
    acts = act_rec[..., None].expand(T, W, h).reshape(T, W * h)
    rew = ds["reward_matrix"][rec_sel, act_rec]
    rew = rew[..., None].expand(T, W, h).reshape(T, W * h)
    flat = {k: v.reshape(T * W * h, -1) for k, v in feats.items()}
    with torch.no_grad():
        logits, values = policy_apply(agent, flat)
    logits = torch.where(mask.reshape(T * W * h, G), logits, -1e30)
    logp = torch.log_softmax(logits, dim=-1)
    logp_old = logp.gather(-1, acts.reshape(-1, 1))[:, 0].reshape(T, W * h)
    return ppo_mod.Trajectory(
        feats=feats, actions=acts, logp_old=logp_old,
        values_old=values.reshape(T, W * h), rewards=rew, action_mask=mask)


def train_serve_policy(trace, rank_cfg: RankConfig, *, out_dir=None,
                       bc_steps: int = 60, ppo_steps: int = 8,
                       ppo_epochs: int = 2, lr: float = 3e-3, seed: int = 0,
                       t_win: int = 4, eval_every: int = 10,
                       device="cuda") -> Tuple[dict, Dict]:
    """The offline pipeline over a recorded trace, on ``device``. Returns
    ``(policy_params, history)`` and, with ``out_dir``, writes a checkpoint
    and policy_meta.json for :func:`load_policy`. Initial parameters come
    from ``init_policy`` on a ``torch.Generator`` on ``device`` seeded
    ``seed``.

    Selection: snapshots taken every ``eval_every`` BC steps and after
    every PPO step are replayed through :func:`evaluate_policy`; the
    winner is the highest-reward snapshot whose mean kept rank does not
    exceed the recorded heuristic's (the best reward outright if none
    qualifies). ``history["candidates"]`` lists every snapshot's
    evaluation, so near-ties are visible; ``history["stage_s"]`` the wall
    seconds of the dataset, BC and PPO stages (each step's loss is read on
    the host, so each stage ends with its device work)."""
    t0 = time.perf_counter()
    ds = build_dataset(trace, rank_cfg, device=device)
    G = int(ds["grid"].shape[0])
    gen = torch.Generator(device=device).manual_seed(seed)
    agent = _init(gen, feat_dims(rank_cfg), G, POLICY_ARCH, device)
    tc = TrainConfig(lr=lr, total_steps=bc_steps + max(ppo_steps, 1) * ppo_epochs,
                     warmup_steps=5, weight_decay=0.0, grad_clip=1.0)
    lr_fn = make_lr_fn(tc)
    opt = adamw.init(agent)
    history: Dict = {"bc_loss": [], "ppo": [], "eval": {}, "candidates": [],
                     "stage_s": {}}

    adaptive_ev = evaluate_policy(ds, rank_cfg, actions=ds["actions"])
    best_le: Optional[Tuple[dict, Dict, str]] = None
    best_any: Optional[Tuple[dict, Dict, str]] = None

    def consider(label: str, a: dict) -> None:
        nonlocal best_le, best_any
        ev = evaluate_policy(ds, rank_cfg, policy_params=a)
        history["candidates"].append((label, ev))
        if best_any is None or ev["reward"] > best_any[1]["reward"]:
            best_any = (a, ev, label)
        if (ev["mean_rank"] <= adaptive_ev["mean_rank"] + 1e-6
                and (best_le is None or ev["reward"] > best_le[1]["reward"])):
            best_le = (a, ev, label)

    # stage 1: BC, warm start on the recorded actions, then the constrained
    # oracle. The safety mask may veto a target on single head rows (legal
    # at record level, since the decision head-means), so the training mask
    # re-admits each row's own target
    h = ds["h"]
    ys_rec = ds["actions"].repeat_interleave(h)
    ys_orc = ds["oracle"].repeat_interleave(h)
    rows = torch.arange(ys_rec.shape[0], device=ys_rec.device)
    m_rec = ds["mask_rows"].clone()
    m_rec[rows, ys_rec] = True
    m_orc = ds["mask_rows"].clone()
    m_orc[rows, ys_orc] = True
    warm = max(bc_steps // 4, 1)
    step = 0
    t1 = time.perf_counter()
    history["stage_s"]["dataset"] = t1 - t0
    for i in range(bc_steps):
        ys, m = (ys_rec, m_rec) if i < warm else (ys_orc, m_orc)
        loss, g = value_and_grad(ppo_mod.bc_loss, agent, ds["feats"], ys, m)
        agent, opt, _ = adamw.update(tc, lr_fn, opt, agent, g)
        history["bc_loss"].append(float(loss))
        step += 1
        if (i + 1) % eval_every == 0 or i + 1 == bc_steps:
            consider(f"bc@{i + 1}", agent)

    t2 = time.perf_counter()
    history["stage_s"]["bc"] = t2 - t1
    # stage 2: PPO over per-request trajectories (segment clock = T axis)
    wins = _windows(ds, t_win)
    for i in range(ppo_steps):
        traj = _make_traj(agent, ds, wins)
        for _ in range(ppo_epochs):
            (loss, pm), g = value_and_grad(ppo_mod.ppo_loss, agent, traj)
            agent, opt, _ = adamw.update(tc, lr_fn, opt, agent, g)
            step += 1
        history["ppo"].append({"loss": float(loss),
                               **{k: float(v) for k, v in pm.items()}})
        consider(f"ppo@{i + 1}", agent)
    history["stage_s"]["ppo"] = time.perf_counter() - t2

    agent, learned_ev, picked = best_le if best_le is not None else best_any
    history["eval"] = {
        "learned": learned_ev, "picked": picked, "adaptive": adaptive_ev,
        "oracle": evaluate_policy(ds, rank_cfg, actions=ds["oracle"]),
        "n_records": ds["n"],
    }

    if out_dir is not None:
        out = pathlib.Path(out_dir)
        mgr = CheckpointManager(out, async_save=False, keep=2)
        mgr.save(step, agent)
        (out / "policy_meta.json").write_text(json.dumps({
            "n_actions": G, "h_dim": _H_DIM, "arch": POLICY_ARCH,
            "rank_grid": ds["grid"].tolist(), "eval": history["eval"],
        }))
    return agent, history


def load_policy(directory, *, device="cuda") -> dict:
    """A trained serving policy for ``Engine(cfg, params, policy)`` in rank
    mode 'learned', on ``device``; the template tree comes from
    policy_meta.json, so callers need no architecture knobs."""
    out = pathlib.Path(directory)
    mpath = out / "policy_meta.json"
    if not mpath.exists():
        raise FileNotFoundError(
            f"no policy_meta.json in {out}: train with "
            "repro_torch.train.serve_policy.train_serve_policy(out_dir=...)")
    meta = json.loads(mpath.read_text())
    G = int(meta["n_actions"])
    dims = {"h_t": int(meta["h_dim"]), "w_t": 9, "ner": G, "bounds": G,
            "prev_rank": G, "layer_id": 1}
    template = _init(torch.Generator(device=device).manual_seed(0), dims, G,
                     meta["arch"], device)
    tree, _, _ = CheckpointManager(out, async_save=False).load(template)
    return tree
