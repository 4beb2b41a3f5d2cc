"""Dense decoder-only transformer of the port: stacked-layer init and the
fused paged decode step of the continuous-batching engine
(``repro.models.transformer.init_dense`` / ``decode_step_paged``)."""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch import nn
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import decode_attention
from repro_torch.models.attention import attend
from repro_torch.models.common import apply_rope, kv_group_mean, repeat_kv


def init_dense(cfg: ModelConfig, gen: torch.Generator, *,
               device="cuda") -> Dict[str, Any]:
    """Seeded random parameters with the shapes and scales of the JAX
    ``init_dense``: layers stacked on a leading L axis, matrices (in, out),
    truncated-normal fan-in init with the ``wo``/``w_down`` depth scaling.
    ``gen`` must live on ``device``."""
    dtype = nn.dt(cfg.param_dtype)
    d, dh, f = cfg.d_model, cfg.resolved_head_dim(), cfg.d_ff
    hq, hkv, L = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers
    kw = dict(device=device, dtype=dtype, batch=(L,))

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    attn = {
        "wq": nn.dense_init(gen, d, hq * dh, **kw),
        "wk": nn.dense_init(gen, d, hkv * dh, **kw),
        "wv": nn.dense_init(gen, d, hkv * dh, **kw),
        "wo": nn.dense_init(gen, hq * dh, d,
                            scale=(hq * dh) ** -0.5 / (2 * L) ** 0.5, **kw),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", hq * dh), ("bk", hkv * dh), ("bv", hkv * dh)):
            attn[name] = torch.zeros((L, width), dtype=dtype, device=device)
    layers = {
        "attn": attn,
        "ln1": ones(L, d),
        "ln2": ones(L, d),
        "ffn": {
            "w_gate": nn.dense_init(gen, d, f, **kw),
            "w_up": nn.dense_init(gen, d, f, **kw),
            "w_down": nn.dense_init(gen, f, d,
                                    scale=f ** -0.5 / (2 * L) ** 0.5, **kw),
        },
    }
    params = {
        "embed": nn.embed_init(gen, cfg.vocab_size, d, device=device,
                               dtype=dtype),
        "layers": layers,
        "ln_f": ones(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = nn.dense_init(gen, d, cfg.vocab_size,
                                          device=device, dtype=dtype)
    return params


def decode_step_paged(cfg: ModelConfig, params, pool_k, pool_v, page_table,
                      tokens, *, slot_lens, slot_ranks=None, basis=None,
                      active=None, use_kernel: bool = False,
                      kt_pool=None, mass_pool=None,
                      q_lens=None, prefill_rows=None):
    """One fused decode step over every serving slot of a slot-paged cache.

    Same arguments and semantics as the JAX ``decode_step_paged``:
    pool_k/pool_v (L, P, page_size, hkv, dh); page_table (n_slots, pages)
    with page 0 the scratch page; tokens (n_slots, C); slot_lens
    (n_slots,) valid prefix length BEFORE this step; slot_ranks (n_slots,)
    with basis (L, n_slots, hkv, dh, r_keep) (both None for rank mode
    'off'); active (n_slots,) bool. ``q_lens``/``prefill_rows`` select the
    mixed step (chunked prefill rows attend full-rank dense, decode rows
    read the factor-projected rank path); ``kt_pool`` (L, n_slots + 1, M,
    hkv, r_keep) is the factor-form K cache; ``mass_pool`` (L, n_slots, M,
    hkv) accumulates per-key attention mass with the in-graph cell reset.
    ``use_kernel`` routes every attention through
    :func:`repro_torch.kernels.ops.decode_attention`.

    The pools are updated IN PLACE and returned in the ``pools`` dict. The
    JAX engine donates these buffers to the step (engine.py:218), so no
    caller holds their old values; in place is the same contract without
    the copy. Dead lanes and padding columns write to scratch page 0 and
    scratch kt row n_slots, in no defined order.

    Returns (logits (n_slots, 1, V), pools): for C > 1 only each row's
    last valid query feeds the LM head."""
    if cfg.mrope:
        raise ValueError("paged decode does not support M-RoPE streams")
    if (slot_ranks is None) != (basis is None):
        raise ValueError("slot_ranks and basis must be given together")
    if (kt_pool is not None or mass_pool is not None) and slot_ranks is None:
        raise ValueError("kt_pool/mass_pool require the rank path")
    dev = tokens.device
    dtype = nn.dt(cfg.dtype)
    tokens = tokens.long()
    page_table = page_table.long()
    slot_lens = slot_lens.long()
    x = params["embed"][tokens].to(dtype)                    # (ns, C, d)
    ns, C = tokens.shape
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    dh = cfg.resolved_head_dim()
    d = cfg.d_model
    n_rep = hq // hkv
    ps = pool_k.shape[2]
    n_pp = page_table.shape[1]
    M = n_pp * ps
    rank_path = cfg.rank.mode != "off" and slot_ranks is not None
    # the pure-decode form keeps the lean factor-only read; the mixed form
    # builds both score reads and selects per row
    mixed = prefill_rows is not None
    if active is None:
        active = torch.ones((ns,), dtype=torch.bool, device=dev)
    q_lens = (torch.ones((ns,), dtype=torch.long, device=dev) if q_lens is None
              else q_lens.long())
    is_pf = (torch.zeros((ns,), dtype=torch.bool, device=dev)
             if prefill_rows is None else prefill_rows & active)
    j_idx = torch.arange(C, device=dev)[None, :]              # (1, C)
    m_idx = torch.arange(M, device=dev)[None, :]              # (1, M)
    positions = slot_lens[:, None] + j_idx                    # (ns, C)
    # physical write coordinates (scratch for dead lanes and padding)
    write_ok = (j_idx < q_lens[:, None]) & active[:, None]
    pg = torch.clamp(positions // ps, max=n_pp - 1)
    zero = torch.zeros_like(positions)
    phys = torch.where(write_ok, page_table.gather(1, pg), zero)
    off = torch.where(write_ok, positions % ps, zero)
    kv_end = slot_lens + q_lens                               # keys after write
    # per-(row, query) visible length; padding queries clamp to the last
    # valid query's window
    kv_len_q = (slot_lens[:, None]
                + torch.minimum(j_idx, q_lens[:, None] - 1) + 1)  # (ns, C)
    valid = m_idx < kv_end[:, None]                           # (ns, M)
    vmask = valid[:, :, None, None]
    # slot-indexed factor rows: padding / dead lanes land on scratch row ns
    slot_rows = torch.where(write_ok, torch.arange(ns, device=dev)[:, None],
                            torch.full_like(positions, ns))
    slot_pos = torch.where(write_ok, torch.clamp(positions, max=M - 1), zero)
    # a position's mass cell is reset exactly once: in the step appending it
    new_cell = valid & (m_idx >= slot_lens[:, None]) & active[:, None]
    score_dtype = nn.dt(cfg.softmax_dtype)
    scale = dh ** -0.5
    if rank_path:
        r_keep = basis.shape[-1]
        col_ok = (torch.arange(r_keep, device=dev)[None, :]
                  < torch.clamp(slot_ranks.long(), max=r_keep)[:, None]
                  ).float()                                   # (ns, r_keep)
    lay = params["layers"]
    for li in range(cfg.num_layers):
        p = {name: t[li] for name, t in lay["attn"].items()}
        h = nn.rms_norm(x, lay["ln1"][li], cfg.rms_eps)
        q = (h @ p["wq"].to(x.dtype)).reshape(ns, C, hq, dh)
        k = (h @ p["wk"].to(x.dtype)).reshape(ns, C, hkv, dh)
        v = (h @ p["wv"].to(x.dtype)).reshape(ns, C, hkv, dh)
        if cfg.qkv_bias:
            q = q + p["bq"].reshape(hq, dh).to(x.dtype)
            k = k + p["bk"].reshape(hkv, dh).to(x.dtype)
            v = v + p["bv"].reshape(hkv, dh).to(x.dtype)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        kp, vp = pool_k[li], pool_v[li]                       # views: in place
        kp[phys, off] = k.to(kp.dtype)
        vp[phys, off] = v.to(vp.dtype)
        vg = vp[page_table].reshape(ns, M, hkv, dh)
        if not rank_path:
            kg = kp[page_table].reshape(ns, M, hkv, dh)
            q_use, k_use = q, kg * vmask.to(kg.dtype)
        else:
            # project q onto the slot's segment eigenbasis; per-row rank =
            # zeroed q columns beyond the slot's bucket
            basis_l = basis[li]                               # (ns, hkv, dh, r)
            b_q = basis_l.repeat_interleave(n_rep, dim=1) if n_rep > 1 else basis_l
            q_proj = (torch.einsum("bshd,bhdr->bshr", q.float(), b_q)
                      * col_ok[:, None, None, :]).to(x.dtype)
            if kt_pool is not None:
                # factor-form cache: append the new tokens' factors, read
                # the slot-indexed factors (r/d of the dense K bytes)
                ktp = kt_pool[li]
                kt_new = torch.einsum("bshd,bhdr->bshr", k.float(), basis_l)
                ktp[slot_rows, slot_pos] = kt_new.to(ktp.dtype)
                ktg = ktp[:ns]                                # (ns, M, hkv, r)
                k_fac = (ktg * vmask.to(ktg.dtype)).to(x.dtype)
            else:
                kg = kp[page_table].reshape(ns, M, hkv, dh)
                k_masked = kg * vmask.to(kg.dtype)
                k_fac = torch.einsum("bmhd,bhdr->bmhr", k_masked.float(),
                                     basis_l).to(x.dtype)
            if not mixed:
                q_use, k_use = q_proj, k_fac
            else:
                # mid-prefill rows attend full-rank dense; decode rows keep
                # the factor read, zero-padded to head-dim width
                kg = kp[page_table].reshape(ns, M, hkv, dh)
                k_dense = kg * vmask.to(kg.dtype)
                pf = is_pf[:, None, None, None]
                q_use = torch.where(pf, q, F.pad(q_proj, (0, dh - r_keep)))
                k_use = torch.where(pf, k_dense, F.pad(k_fac, (0, dh - r_keep)))
        want_probs = mass_pool is not None
        if use_kernel:
            qk = q_use.transpose(1, 2)                        # (ns, hq, C, r)
            res = decode_attention(
                (qk if mixed or C > 1 else qk[:, :, 0]).contiguous(),
                k_use.transpose(1, 2).contiguous(),           # (ns, hkv, M, r)
                vg.transpose(1, 2).contiguous(),              # (ns, hkv, M, dh)
                kv_end, scale=scale, q_start=slot_lens,
                return_probs=want_probs)
            o, probs = res if want_probs else (res, None)
            if o.dim() == 3:
                o = o[:, :, None]
                probs = None if probs is None else probs[:, :, None]
            o = o.transpose(1, 2)                             # (ns, C, hq, dh)
        else:
            res = attend(q_use, repeat_kv(k_use, n_rep), repeat_kv(vg, n_rep),
                         scale=scale, causal=False,
                         kv_len=kv_len_q[:, None, :, None],
                         score_dtype=score_dtype, return_probs=want_probs)
            o, probs = res if want_probs else (res, None)
        if mass_pool is not None:
            # per-key attention mass: group-mean over each kv head's q
            # heads, masked to live lanes and valid queries; cells appended
            # this step are reset before the add
            w = (probs.float() * write_ok[:, None, :, None]).sum(dim=2)
            w_tok = kv_group_mean(w, hkv)                     # (ns, hkv, M)
            mp = mass_pool[li]
            mass_pool[li] = (mp.masked_fill(new_cell[:, :, None], 0.0)
                             + w_tok.transpose(1, 2).to(mp.dtype))
        x = x + o.reshape(ns, C, hq * dh) @ p["wo"].to(x.dtype)
        f = nn.swiglu(nn.rms_norm(x, lay["ln2"][li], cfg.rms_eps),
                      lay["ffn"]["w_gate"][li], lay["ffn"]["w_up"][li],
                      lay["ffn"]["w_down"][li])
        x = x + f
    if C > 1:
        # only each row's last valid query feeds the LM head
        x = x.gather(1, (q_lens - 1)[:, None, None].expand(ns, 1, d))
    x = nn.rms_norm(x, params["ln_f"], cfg.rms_eps)
    head = params.get("lm_head")
    logits = (x @ head.to(x.dtype) if head is not None
              else x @ params["embed"].to(x.dtype).T)
    pools = {"k": pool_k, "v": pool_v}
    if kt_pool is not None:
        pools["kt"] = kt_pool
    if mass_pool is not None:
        pools["mass"] = mass_pool
    return logits, pools
