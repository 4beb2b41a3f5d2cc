"""Per-slot segment-level rank decision (port of
``repro.serve.policy.make_decide_fn``, every rank mode), the drift
trigger's ``basis_drift`` and speculation's ``draft_ranks``.

The eigenbasis comes from the softmax-weighted Gram G = K^T diag(w) K, with
w the slot's accumulated per-key attention mass (zero mass degrades to
uniform weights, i.e. the plain Gram). Decision rules per slot:
  * kv_len < 8            -> r_max (too little signal; no veto)
  * mode == 'fixed'       -> fixed_rank
  * mode == 'adaptive'    -> NER-threshold rank per head, median over heads
                             (the mean of the two middle values for an even
                             head count, as ``jnp.median``), snapped to the
                             grid (ties to the first grid entry)
  * mode == 'drrl'        -> policy logits per head with the Eq. 11 safety
                             mask (masked logits -1e30), argmax of their
                             head mean
  * mode == 'learned'     -> the same inference path as 'drrl' (params
                             trained offline come from the caller)
  * mode == 'random'      -> uniform grid draw keyed by
                             fold_in(fold_in(key(17), t), slot): JAX's
                             randint bits (``core.prng``)
  * transition veto       -> Eq. 9 relative bound at the chosen bucket vs
                             the slot's annealed eps_t, the "before" side
                             taken from the slot's persisted spectra
A decision rewrites the slot's basis, spectra and (in factor form) its
``kt_pool`` rows as K . B_r under the refreshed basis.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import lowrank as lr
from repro_torch.core import perturbation as pert
from repro_torch.core import prng
from repro_torch.core.drrl import build_features
from repro_torch.core.policy import policy_apply


def median_mean(x: torch.Tensor) -> torch.Tensor:
    """Median with ``jnp.median``'s rule: for an even count, the mean of
    the two middle values (``torch.median`` returns the lower one)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    return (s[(n - 1) // 2] + s[n // 2]) / 2


def _at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for a 0-dim device index, as a one-element gather: indexing
    with a 0-dim tensor reads the index on the host, a sync."""
    return x[idx.reshape(1)][0]


def make_decide_fn(cfg: ModelConfig, policy_params=None) -> Callable:
    """Returns ``decide(k_pool, mass_pool, kt_pool, page_table, lens,
    ranks, basis, spectra, slot, has_rank, t) -> (ranks', basis',
    spectra', kt_pool', vetoed)`` re-deciding ONE slot.

    ``page_table``/``lens``/``ranks`` are device tensors, ``slot``/``t``
    host ints, ``has_rank`` a host bool. ``ranks'`` is a new tensor (the
    engine's rank history keeps the old one); basis, spectra and kt_pool
    are rewritten in place and returned (the JAX version donates them,
    policy.py:102, so no caller reads their old values). ``vetoed`` is a
    device bool: True iff the Eq. 9 veto overrode the choice.
    ``policy_params`` (rank modes 'drrl' and 'learned') is the agent's
    tree on the pools' device."""
    rcfg = cfg.rank
    if rcfg.mode == "off":
        raise ValueError("decide fn is undefined for rank mode 'off'")
    if rcfg.mode in ("drrl", "learned") and policy_params is None:
        raise ValueError(
            f"rank mode {rcfg.mode!r} needs policy params: pass them as the "
            "third positional arg (ServeEngine(cfg, params, policy_params) "
            "/ Engine(cfg, params, policy_params, config=...))")
    if rcfg.mode not in ("fixed", "adaptive", "drrl", "learned", "random"):
        raise ValueError(f"rank mode {rcfg.mode!r} has no serving decision")
    g_lo, g_hi = int(rcfg.rank_grid[0]), int(rcfg.rank_grid[-1])
    dh = cfg.resolved_head_dim()
    r_keep = min(g_hi, dh)
    grids = {}          # device -> the rank grid, built at the first decision

    def decide(k_pool, mass_pool, kt_pool, page_table, lens, ranks, basis,
               spectra, slot, has_rank, t):
        slot, has_rank = int(slot), bool(has_rank)
        dev = k_pool.device
        grid = grids.get(dev)
        if grid is None:
            grid = grids[dev] = torch.tensor(rcfg.rank_grid, dtype=torch.int32, device=dev)  # inv-ok-torch[R1]: once per device, at the first decision (warmup's), never again
        kv_len = lens[slot]
        # a recycled slot's first decision must not see the previous
        # occupant's rank: fall back to the fresh-slot default r_max
        prev_rank = (ranks[slot] if has_rank else
                     torch.full((), g_hi, dtype=torch.int32, device=dev))
        gathered = k_pool[:, page_table[slot].long()]   # (L, pages, ps, h, d)
        L = gathered.shape[0]
        kv = gathered.reshape(L, -1, *gathered.shape[3:])
        M = kv.shape[1]
        valid = (torch.arange(M, device=dev) < kv_len).float()
        kk = (kv.transpose(1, 2).float()
              * valid[None, None, :, None])              # (L, h, M, d)
        # softmax-weighted Gram, weights normalised to sum kv_len
        w = mass_pool[:, slot].transpose(1, 2)          # (L, h, M)
        w = w.clamp_min(0.0) * valid
        tot = w.sum(dim=-1, keepdim=True)
        n_valid = kv_len.float().clamp_min(1.0)
        w = torch.where(tot > 0.0, w * n_valid / tot.clamp_min(1e-30),
                        valid.expand_as(w))
        gk = torch.einsum("lhmd,lhm,lhme->lhde", kk, w, kk)
        s2_l, evecs_l = lr.gram_spectrum(gk)            # (L, h, d[, d])
        s2 = s2_l[0]                 # layer-0 spectra drive the decision
        eps_t = pert.annealed_threshold(rcfg.epsilon0, rcfg.anneal_lambda,
                                        t, device=dev)
        prev_s2 = spectra[slot] if has_rank else s2

        if rcfg.mode == "fixed":
            chosen = torch.full((), rcfg.fixed_rank, dtype=torch.int32,
                                device=dev)
        elif rcfg.mode == "adaptive":
            r = lr.rank_for_energy(s2, rcfg.energy_threshold, g_lo, g_hi)
            med = median_mean(r.float())
            chosen = _at(grid, torch.argmin((grid.float() - med).abs()))
        elif rcfg.mode == "random":
            # both the slot and its segment clock fold into the key; the
            # draw's tiny integer ops run on the host, the index moves over
            key = prng.fold_in(prng.fold_in(prng.key(17), t), slot)
            chosen = _at(grid, prng.randint(key, (), 0, grid.shape[0]).to(dev).long())
        else:
            # 'drrl' / 'learned': zero h_t and w_t, layer 0, spectra-only
            # state (the recipe the serving-policy trainer records)
            h = s2.shape[0]
            h_dim = policy_params["embed"]["h_t"]["w"].shape[0]
            feats, (_, _, bounds_rel, _) = build_features(
                rcfg, {"k_s2": s2[None], "q_s2": prev_s2[None]},
                torch.zeros((1, h_dim), device=dev),
                torch.zeros((9,), device=dev), 0,
                prev_rank.expand(1, h))
            logits, _ = policy_apply(policy_params, feats)      # (h, G)
            G = logits.shape[-1]
            ok = pert.safety_mask(bounds_rel.reshape(-1, G), eps_t)
            logits = torch.where(ok, logits, -1e30)
            chosen = _at(grid, torch.argmax(logits.mean(dim=0)))

        # transition veto (Eq. 9): head-mean relative bound at the chosen
        # bucket must clear the slot's annealed threshold
        bounds, norm = pert.guardrail_report(prev_s2, s2, rcfg.rank_grid, dh)
        rel = (bounds / norm.clamp_min(1e-30)[..., None]).mean(dim=0)
        rel_c = _at(rel, torch.argmin((grid - chosen).abs()))
        vetoed = (chosen != prev_rank) & (rel_c > eps_t) & has_rank
        chosen = torch.where(vetoed, prev_rank, chosen)
        short = kv_len < 8
        chosen = torch.where(short, torch.full_like(chosen, g_hi), chosen)
        vetoed = vetoed & ~short     # the short-context override is no veto

        ranks = ranks.clone()
        ranks[slot] = chosen
        basis[:, slot] = evecs_l[..., :r_keep]
        spectra[slot] = s2
        if kt_pool is not None:
            # re-project the slot's whole K run onto the new basis
            kt = torch.einsum("lhmd,lhdr->lmhr", kk, evecs_l[..., :r_keep])
            kt_pool[:, slot] = kt.to(kt_pool.dtype)
        return ranks, basis, spectra, kt_pool, vetoed

    return decide


def draft_ranks(ranks: torch.Tensor, spectra: torch.Tensor, *,
                frac: float, grid_lo: int, r_cap: int,
                energy: float = 0.5) -> torch.Tensor:
    """Per-slot draft rank for self-speculative decoding: (n_slots,) int32.

    The draft reads the factor cache at ``ceil(frac * rank)`` of each
    slot's current rank, floored by the rank that keeps ``energy`` of the
    slot's cached layer-0 spectra (head max) and by the grid's floor
    ``grid_lo``, capped at ``r_cap`` (the static width the engine sliced the
    basis and factor pool to) and at the slot's rank. A slot with all-zero
    spectra (no decision yet) drafts at the grid floor."""
    r_e = lr.rank_for_energy(spectra, energy, 1, r_cap)      # (ns, hkv)
    has_sig = (spectra > 0.0).any(dim=2).any(dim=1)          # (ns,)
    floor = torch.where(has_sig, r_e.amax(dim=1),
                        torch.full_like(r_e[:, 0], grid_lo))
    floor = floor.clamp(grid_lo, r_cap)
    rd = torch.ceil(frac * ranks.float()).to(torch.int32)
    rd = torch.maximum(rd, floor.to(torch.int32))
    return torch.minimum(rd.clamp_max(r_cap), ranks.to(torch.int32))


def basis_drift(k_tok: torch.Tensor, basis: torch.Tensor,
                ranks: torch.Tensor) -> torch.Tensor:
    """Residual energy of the newest K token outside each slot's stored
    layer-0 eigenbasis (its first ``rank`` columns): (n_slots,) in [0, 1].
    High drift means the segment's subspace went stale, and the engine
    re-decides early. k_tok: (n_slots, hkv, dh); basis: (n_slots, hkv, dh,
    r_keep); ranks: (n_slots,)."""
    r_keep = basis.shape[-1]
    col_ok = (torch.arange(r_keep, device=basis.device)[None, :]
              < ranks[:, None].clamp_max(r_keep)).float()
    b = basis * col_ok[:, None, None, :]
    kf = k_tok.float()
    proj = torch.einsum("shd,shdr,sher->she", kf, b, b)
    num = ((kf - proj) ** 2).sum(dim=(1, 2))
    den = (kf ** 2).sum(dim=(1, 2)).clamp_min(1e-30)
    return num / den
