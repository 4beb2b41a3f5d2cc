"""RWKV6 'Finch' blocks of the port (``repro.models.rwkv6``): attention-free
time mix with a data-dependent decay, and the channel mix.

DR-RL is inapplicable here (no QK^T score matrix). The sequence mixer is
the wkv6 recurrence
  S_t = diag(w_t) S_{t-1} + k_t v_t^T,      y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
computed in a chunked matmul form (``wkv6_chunked``; ``wkv6_naive`` is the
step-by-step oracle and the single-token decode). Every scan sum runs in f32.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import nn
from repro_torch.configs.base import ModelConfig

# elements of one (b, chunks, q, q, h, hd) decay block of wkv6_chunked: the
# chunks are taken in groups that keep it under this (512 MB in f32)
DECAY_BLOCK_ELEMS = 1 << 27


def init_rwkv_block(cfg: ModelConfig, gen: torch.Generator, dtype, *, device,
                    batch=()) -> Dict[str, torch.Tensor]:
    """The JAX ``init_rwkv_block``'s shapes, dtypes and scales, stacked on
    ``batch``: ``w0`` and ``u`` stay f32 whatever ``dtype``."""
    d, r = cfg.d_model, cfg.rwkv.decay_lora
    kw = dict(device=device, dtype=dtype, batch=batch)
    f32 = dict(dtype=torch.float32, device=device)

    def ones():
        return torch.ones((*batch, d), dtype=dtype, device=device)

    def uniform_half(n):
        return (torch.rand((*batch, n, d), generator=gen, **f32) * 0.5).to(dtype)

    return {
        "ln1": ones(), "ln2": ones(),
        # token-shift interpolation weights for (r, k, v, w, g)
        "mu": uniform_half(5),
        "wr": nn.dense_init(gen, d, d, **kw),
        "wk": nn.dense_init(gen, d, d, **kw),
        "wv": nn.dense_init(gen, d, d, **kw),
        "wg": nn.dense_init(gen, d, d, **kw),
        "wo": nn.dense_init(gen, d, d, **kw),
        # data-dependent decay LoRA: w_t = exp(-exp(w0 + tanh(x A) B))
        "w0": torch.full((*batch, d), -2.0, **f32),
        "wA": nn.dense_init(gen, d, r, **kw),
        "wB": nn.dense_init(gen, r, d, scale=0.01, **kw),
        "u": torch.randn((*batch, d), generator=gen, **f32) * 0.1,
        "ln_x": ones(),
        # channel mix
        "mu_c": uniform_half(2),
        "ck": nn.dense_init(gen, d, cfg.d_ff, **kw),
        "cv": nn.dense_init(gen, cfg.d_ff, d, **kw),
        "cr": nn.dense_init(gen, d, d, **kw),
    }


def _token_shift(x, last=None):
    """Shift right by one along the sequence; ``last`` (b, 1, d) supplies
    the boundary token (zeros when None)."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last.to(x.dtype), x[:, :-1]], dim=1)


def wkv6_chunked(r, k, v, w_log, u, head_dim: int, chunk: int,
                 state0=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v: (b, l, d); w_log: (b, l, d) = log w_t in (-inf, 0); u: (d,).
    Multi-head with dk = dv = head_dim. Returns (y (b, l, d) f32, final
    state (b, h, hd, hd) f32); ``state0`` is the state entering position 0.
    ``l`` is padded up to a multiple of ``chunk`` (w_log 0: no decay) and
    the result sliced back.

    The intra-chunk decay exp(cw[i-1] - cw[j]) has a factor per channel, so
    it cannot be split into a product of two exponentials without overflow
    (the log-decays of a chunk sum to -1024 at the clip). It is built for a
    group of chunks at a time, at most ``DECAY_BLOCK_ELEMS`` elements, and
    contracted pairwise with r, then k: a full-width layer (1 x 4096, 32
    heads of 64, chunk 128) would hold 4.3 GB at once."""
    b, l, d = r.shape
    hd = head_dim
    h = d // hd
    pad = (-l) % chunk
    if pad:
        r, k, v, w_log = (F.pad(t, (0, 0, 0, pad)) for t in (r, k, v, w_log))
    L = r.shape[1]
    nc = L // chunk
    shp = (b, nc, chunk, h, hd)
    rc, kc, vc, wc = (t.reshape(shp).float() for t in (r, k, v, w_log))
    uu = u.reshape(h, hd).float()

    # the decay from source j to target i (j < i) is prod_{m=j+1..i-1} w_m:
    # exp(cwi[i] - cw[j]) with cw the inclusive and cwi the exclusive cumsum
    cw = torch.cumsum(wc, dim=2)
    cwi = torch.cat([torch.zeros_like(cw[:, :, :1]), cw[:, :, :-1]], dim=2)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device),
                      diagonal=-1)[None, None, :, :, None, None]
    group = max(1, DECAY_BLOCK_ELEMS // (b * chunk * chunk * h * hd))
    scores = []
    for c0 in range(0, nc, group):
        sl = slice(c0, c0 + group)
        # mask BEFORE exp (see mamba2.ssd_chunked): no inf * 0 in gradients
        dec = torch.exp(torch.where(mask, cwi[:, sl, :, None] - cw[:, sl, None],
                                    float("-inf")))       # (b, g, qi, qj, h, hd)
        dec = dec * rc[:, sl, :, None]
        scores.append(torch.einsum("bcijhd,bcjhd->bcijh", dec, kc[:, sl]))
        del dec
    scores = torch.cat(scores, dim=1)                     # (b, nc, qi, qj, h)
    y = torch.einsum("bcijh,bcjhd->bcihd", scores, vc)
    del scores
    # diagonal u-term: y_t += (r_t . (u * k_t)) v_t
    y = y + (rc * uu * kc).sum(dim=-1, keepdim=True) * vc

    # chunk state: S_chunk = sum_j diag(prod_{m=j+1..Q} w) k_j v_j^T
    sdec = torch.exp(cw[:, :, -1:] - cw)                  # (b, nc, q, h, hd)
    s_chunk = torch.einsum("bcjhd,bcjhe->bchde", kc * sdec, vc)
    chunk_dec = torch.exp(cw[:, :, -1])                   # (b, nc, h, hd)

    S = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float())
    s_in = []
    for c in range(nc):
        s_in.append(S)
        S = S * chunk_dec[:, c, ..., None] + s_chunk[:, c]
    S_in = torch.stack(s_in, dim=1)                       # (b, nc, h, dk, dv)
    y = y + torch.einsum("bcihd,bchde->bcihe", rc * torch.exp(cwi), S_in)
    return y.reshape(b, L, d)[:, :l], S


def wkv6_naive(r, k, v, w_log, u, head_dim: int, state0=None):
    """Step-by-step oracle (and the single-token decode). Returns (y (b, l,
    d) f32, final state (b, h, hd, hd) f32)."""
    b, l, d = r.shape
    h, hd = d // head_dim, head_dim
    rr, kk, vv = (t.reshape(b, l, h, hd).float() for t in (r, k, v))
    ww = torch.exp(w_log.reshape(b, l, h, hd).float())
    uu = u.reshape(h, hd).float()
    S = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float())
    ys = []
    for t in range(l):
        kv = torch.einsum("bhd,bhe->bhde", kk[:, t], vv[:, t])
        ys.append(torch.einsum("bhd,bhde->bhe", rr[:, t], S + uu[None, :, :, None] * kv))
        S = S * ww[:, t, ..., None] + kv
    return torch.stack(ys, dim=1).reshape(b, l, d), S


def rwkv_block(cfg: ModelConfig, p, x, *, state=None, single_step=False):
    """x: (b, l, d). state: (shift1 (b, 1, d), wkv state (b, h, hd, hd),
    shift2 (b, 1, d)) or None. Returns (y, new_state), the new shift states
    being the last *normed* inputs of the time mix and channel mix."""
    rw = cfg.rwkv
    s1, S0, s2 = state if state is not None else (None, None, None)

    h = nn.rms_norm(x, p["ln1"], cfg.rms_eps)
    hs = _token_shift(h, s1)
    mu = p["mu"].to(h.dtype)

    def mix(i):
        return h * (1 - mu[i]) + hs * mu[i]
    r = nn.linear(mix(0), p["wr"])
    k = nn.linear(mix(1), p["wk"])
    v = nn.linear(mix(2), p["wv"])
    g = nn.linear(mix(4), p["wg"])
    w_log = -torch.exp(p["w0"] + nn.linear(torch.tanh(nn.linear(mix(3), p["wA"])),
                                           p["wB"]).float())
    w_log = torch.clamp(w_log, -8.0, -1e-4)

    if single_step:
        y, S = wkv6_naive(r, k, v, w_log, p["u"], rw.head_dim, S0)
    else:
        y, S = wkv6_chunked(r, k, v, w_log, p["u"], rw.head_dim, rw.chunk_size, S0)
    y = nn.rms_norm(y.to(x.dtype), p["ln_x"], cfg.rms_eps)
    x = x + nn.linear(y * F.silu(g), p["wo"])

    # channel mix
    h2 = nn.rms_norm(x, p["ln2"], cfg.rms_eps)
    h2s = _token_shift(h2, s2)
    mc = p["mu_c"].to(h2.dtype)

    def mixc(i):
        return h2 * (1 - mc[i]) + h2s * mc[i]
    kk = torch.square(torch.relu(nn.linear(mixc(0), p["ck"])))
    x = x + torch.sigmoid(nn.linear(mixc(1), p["cr"])) * nn.linear(kk, p["cv"])
    return x, (h[:, -1:], S, h2[:, -1:])


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype, *, device="cuda"):
    """(shift1, wkv state f32, shift2), zeros."""
    d, hd = cfg.d_model, cfg.rwkv.head_dim
    return (torch.zeros((batch, 1, d), dtype=dtype, device=device),
            torch.zeros((batch, d // hd, hd, hd), dtype=torch.float32, device=device),
            torch.zeros((batch, 1, d), dtype=dtype, device=device))
