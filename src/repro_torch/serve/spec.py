"""Low-rank self-speculative decoding: the step's helpers (port of
``repro.serve.spec``).

The factor cache is a free draft model. One speculative engine step
(``engine.ServeEngine._step_spec_impl``) runs:

  1. **Draft**: ``draft_k`` single-token forwards that read the basis and
     the factor pool sliced to the static draft width ``r_cap``, at a per-
     row draft rank (``policy.draft_ranks``). Their K/V writes land in the
     live pages and their factor appends in the first ``r_cap`` columns of
     the live kt pool, all at positions [lens, lens + draft_k), every one
     of which the verify pass writes again with its own values before any
     read; the mass pool is not touched.
  2. **Verify**: ONE chunked forward over [t_0, d_1 .. d_k] per row at the
     slot's current rank (``q_lens = draft_k + 1``) with every query's
     logits kept (``return_all_logits``) and the per-query attention mass
     returned instead of added (``mass_defer``). Targets g_0 .. g_k are
     drawn with plain decode's (seed, output position) fold, so each is a
     function of (logits, position) alone.
  3. **Accept / roll back**: ``accept_counts`` keeps the longest prefix of
     drafts equal to their targets plus one, clamped at EOS, at the
     remaining budget and at the next segment boundary. ``lens`` advances
     past accepted tokens only; the mass of accepted queries is added in
     query order (``apply_deferred_mass``), so the next decision sees what
     plain decode would have accumulated.

Greedy and seeded streams are token-identical with speculation on or off.
"""
from __future__ import annotations

import torch


def accept_counts(drafts: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Longest-matching-prefix accept count per row, (ns,) in [1, k + 1].

    drafts: (ns, k) draft tokens d_1 .. d_k; targets: (ns, >= k + 1) verify
    samples g_0 .. g_k. Draft d_{i+1} was proposed for the position g_i
    verifies, so j = #leading matches of d_{i+1} == g_i, and the step emits
    a = j + 1 tokens g_0 .. g_j: the first mismatching position still emits
    its target, the token plain decode would have produced."""
    k = drafts.shape[1]
    match = (drafts == targets[:, :k]).long()
    return torch.cumprod(match, dim=1).sum(dim=1) + 1


def clamp_to_eos(a: torch.Tensor, targets: torch.Tensor,
                 eos_ids: torch.Tensor) -> torch.Tensor:
    """Truncate accepted runs at the first EOS target, inclusive. ``eos_ids``
    is (ns,) with -1 for requests without an EOS."""
    iseos = (targets == eos_ids[:, None]) & (eos_ids >= 0)[:, None]
    # argmax over ints returns the first maximum, as jnp.argmax
    first = torch.argmax(iseos.long(), dim=1).to(a.dtype)
    cap = torch.where(iseos.any(dim=1), first + 1,
                      torch.full_like(first, targets.shape[1]))
    return torch.minimum(a, cap)


def apply_deferred_mass(mass_pool: torch.Tensor, contrib: torch.Tensor,
                        lens: torch.Tensor, n_q: torch.Tensor) -> torch.Tensor:
    """Fold the verify pass's per-query mass contributions into the pool,
    accepted queries only, IN PLACE; returns ``mass_pool``.

    mass_pool: (L, ns, M, hkv); contrib: (L, ns, C, M, hkv) per-query
    contributions (zero for dead lanes and padding queries); lens: (ns,)
    lengths before the step; n_q: (ns,) queries to apply per row (the
    accept count of a speculative row, the chunk of a mid-prefill row, 0
    for dead rows).

    Cells [lens, lens + n_q) are reset first (the append-step reset of the
    fused step), then each query's contribution is added in query order:
    the same sequence of f32 adds as n_q single-token steps. A query at or
    past a row's n_q adds an exact 0, which leaves every cell as it was, so
    a caller may pass only the first max(n_q) queries of ``contrib``."""
    M = mass_pool.shape[2]
    pos = torch.arange(M, device=mass_pool.device)[None, :]
    new_cell = (pos >= lens[:, None]) & (pos < (lens + n_q)[:, None])
    mass_pool.masked_fill_(new_cell[None, :, :, None], 0.0)
    C = contrib.shape[2]
    q_ok = (torch.arange(C, device=mass_pool.device)[None, :]
            < n_q[:, None]).to(mass_pool.dtype)                  # (ns, C)
    for q in range(C):
        mass_pool.add_(contrib[:, :, q].to(mass_pool.dtype)
                       * q_ok[None, :, q, None, None])
    return mass_pool


def host_accept_stats(acc_h, caps, decoding, draft_k):
    """Per-step accounting over the fetched accept counts: ``(tokens,
    accepted, drafted)`` over the ``decoding`` rows: tokens emitted (the
    accepted run with its bonus token), drafts accepted, and drafts that
    could have been accepted (caps clamp near max_new and segment
    boundaries)."""
    tokens = sum(int(acc_h[i]) for i in decoding)
    accepted = sum(int(acc_h[i]) - 1 for i in decoding)
    drafted = sum(min(draft_k, int(caps[i]) - 1) for i in decoding)
    return tokens, accepted, drafted
