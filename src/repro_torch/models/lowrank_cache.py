"""A rank-r KV cache (``repro.models.lowrank_cache``): the cache itself in
factor form,

    k~ = K . E_r   (b, M, hkv, r)   instead of   K (b, M, hkv, d),

with E_r the top-r eigenbasis of the prompt's (attention-mass weighted) K
Gram per (layer, batch row, kv head). Decode projects q and each new k
onto the stored basis, so the score contraction runs over r. V stays full.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import nn
from repro_torch.configs.base import ModelConfig
from repro_torch.core import lowrank as lr
from repro_torch.core import prng
from repro_torch.models.attention import attend
from repro_torch.models.common import apply_rope, kv_group_mean
from repro_torch.models.transformer import _layer, _logits, forward_dense


def init_lowrank_cache(cfg: ModelConfig, batch: int, max_len: int, rank: int,
                       *, device="cuda") -> Dict:
    """{'kt': (L, b, max_len, hkv, rank), 'v': (L, b, max_len, hkv, dh),
    'basis': (L, b, hkv, dh, rank) f32, 'len': 0}."""
    dtype = nn.dt(cfg.dtype)
    dh = cfg.resolved_head_dim()
    L, hkv = cfg.num_layers, cfg.num_kv_heads

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return {"kt": zeros(L, batch, max_len, hkv, rank),
            "v": zeros(L, batch, max_len, hkv, dh),
            "basis": zeros(L, batch, hkv, dh, rank, dt=torch.float32),
            "len": 0}


def attention_mass(q: torch.Tensor, k: torch.Tensor,
                   q_len=None) -> torch.Tensor:
    """Per-key attention mass of the prompt's causal self-attention,
    summed over queries (those < ``q_len`` when given) and averaged over
    the q heads of each kv group. q: (L, b, s, hq, d); k: (L, b, s, hkv,
    d). Returns (L, b, hkv, s), normalised to sum to the number of
    contributing queries. One layer at a time, so the peak score tensor is
    one layer's (b, hq, s, s)."""
    L, b, s, hq, dh = q.shape
    hkv = k.shape[3]
    dev = q.device
    causal = torch.arange(s, device=dev)[:, None] >= torch.arange(s, device=dev)[None, :]
    n_q = float(s if q_len is None else q_len)
    q_ok = (None if q_len is None
            else (torch.arange(s, device=dev) < q_len).float())
    out = []
    for li in range(L):
        kr = k[li].repeat_interleave(hq // hkv, dim=2) if hq != hkv else k[li]
        sc = torch.einsum("bqhd,bkhd->bhqk", q[li].float(), kr.float()) * dh ** -0.5
        sc = torch.where(causal, sc, torch.tensor(-1e30, device=dev))
        p = torch.softmax(sc, dim=-1)
        if q_ok is not None:
            p = p * q_ok[None, None, :, None]
        out.append(kv_group_mean(p.sum(dim=2), hkv))
    w = torch.stack(out)                                  # (L, b, hkv, s)
    return w * n_q / w.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def prefill_lowrank(cfg: ModelConfig, params, tokens: torch.Tensor,
                    cache: Dict, rank: int, *,
                    weighted: bool = True) -> Tuple[torch.Tensor, Dict]:
    """Run the prompt through the model, build per-(layer, row, head)
    bases from the prompt's K Grams and store the truncated cache.

    The forward runs in rank mode 'adaptive' with energy threshold 1
    (unchunked, ``rank_rng`` key 0, as the reference) to capture q/k/v.
    ``weighted=True`` takes the Gram K^T diag(w) K with w the prompt's
    per-key attention mass (:func:`attention_mass`), else the plain Gram.
    Returns (the last token's logits (b, 1, V), the filled cache)."""
    cfg_cap = cfg.with_(rank=cfg.rank.__class__(
        mode="adaptive", rank_grid=cfg.rank.rank_grid or (rank,),
        energy_threshold=1.0))
    logits, aux = forward_dense(cfg_cap, params, tokens, collect_aux="rl",
                                collect_qkv=True,
                                rank_rng=prng.key(0))
    qkv = aux["layers"]["qkv"]                     # k, v: (L, b, s, hkv, d)
    k, v = qkv["k"], qkv["v"]
    L, b, s, hkv, dh = k.shape
    if weighted:
        w = attention_mass(qkv["q"], k)            # (L, b, hkv, s)
        kf = k.float()
        gk = torch.einsum("lbshd,lbhs,lbshe->lbhde", kf, w, kf)
    else:
        gk = lr.gram(k.permute(0, 1, 3, 2, 4))     # (L, b, hkv, d, d)
    _, evecs = lr.gram_spectrum(gk)
    basis = evecs[..., :rank].contiguous()         # (L, b, hkv, d, r)
    kt = torch.einsum("lbshd,lbhdr->lbshr", k.float(), basis)
    cache["kt"][:, :, :s] = kt.to(cache["kt"].dtype)
    cache["v"][:, :, :s] = v.to(cache["v"].dtype)
    return logits[:, -1:], {"kt": cache["kt"], "v": cache["v"],
                            "basis": basis, "len": s}


def decode_step_lowrank(cfg: ModelConfig, params, cache: Dict,
                        tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """One decode step against the rank-r cache: q and the new k are
    projected onto the stored basis, the score contraction runs over r.
    tokens (b, s_new); returns (logits (b, s_new, V), the cache, its
    tensors written in place)."""
    dtype = nn.dt(cfg.dtype)
    x = params["embed"][tokens.long()].to(dtype)
    b, s, d = x.shape
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    dh = cfg.resolved_head_dim()
    n_rep = hq // hkv
    idx = int(cache["len"])
    positions = (idx + torch.arange(s, device=x.device))[None].expand(b, s)
    for li in range(cfg.num_layers):
        lp = _layer(params, li)
        p = lp["attn"]
        kt_l, v_l, basis_l = cache["kt"][li], cache["v"][li], cache["basis"][li]
        h = nn.rms_norm(x, lp["ln1"], cfg.rms_eps)
        q = (h @ p["wq"].to(x.dtype)).reshape(b, s, hq, dh)
        k = (h @ p["wk"].to(x.dtype)).reshape(b, s, hkv, dh)
        v = (h @ p["wv"].to(x.dtype)).reshape(b, s, hkv, dh)
        if cfg.qkv_bias:
            q = q + p["bq"].reshape(hq, dh).to(x.dtype)
            k = k + p["bk"].reshape(hkv, dh).to(x.dtype)
            v = v + p["bv"].reshape(hkv, dh).to(x.dtype)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        basis_q = basis_l.repeat_interleave(n_rep, dim=1) if n_rep > 1 else basis_l
        qt = torch.einsum("bshf,bhfr->bshr", q.float(), basis_q)
        kt_new = torch.einsum("bshf,bhfr->bshr", k.float(), basis_l)
        kt_l[:, idx:idx + s] = kt_new.to(kt_l.dtype)
        v_l[:, idx:idx + s] = v.to(v_l.dtype)
        o = attend(qt.to(x.dtype), kt_l, v_l, scale=dh ** -0.5, causal=True,
                   q_offset=idx, kv_len=idx + s)
        x = x + o.reshape(b, s, hq * dh) @ p["wo"].to(x.dtype)
        ffn = lp["ffn"]
        x = x + nn.swiglu(nn.rms_norm(x, lp["ln2"], cfg.rms_eps),
                          ffn["w_gate"], ffn["w_up"], ffn["w_down"])
    x = nn.rms_norm(x, params["ln_f"], cfg.rms_eps)
    return _logits(params, x), dict(cache, len=idx + s)
