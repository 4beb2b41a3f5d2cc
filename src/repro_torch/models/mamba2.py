"""Mamba2 (SSD) blocks of the port (``repro.models.mamba2``): the chunked
matmul form of the state-space scan, its O(L) recurrence oracle, and the
block in its chunked and single-step (decode) forms.

The chunked algorithm splits the sequence into chunks of Q tokens; the
intra-chunk term is a (Q x Q) decay-masked matmul and the inter-chunk term
a small state pass, here a Python loop over chunks (the reference's
``lax.scan``). Every scan sum runs in f32.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import nn
from repro_torch.configs.base import ModelConfig


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return d_in, d_in // s.head_dim, s.n_groups, s.d_state


def init_mamba_block(cfg: ModelConfig, gen: torch.Generator, dtype, *, device,
                     batch=()) -> Dict[str, torch.Tensor]:
    """The JAX ``init_mamba_block``'s shapes, dtypes and scales, stacked on
    ``batch``: ``A_log``, ``dt_bias`` and ``D`` stay f32 whatever ``dtype``."""
    s = cfg.ssm
    d = cfg.d_model
    d_in, H, G, N = _dims(cfg)
    conv_dim = d_in + 2 * G * N
    kw = dict(device=device, dtype=dtype, batch=batch)
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = torch.randn((*batch, s.d_conv, conv_dim), generator=gen, **f32)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, **f32))
    return {
        "in_proj": nn.dense_init(gen, d, 2 * d_in + 2 * G * N + H, **kw),
        "conv_w": conv_w.mul_(0.1).to(dtype),
        "conv_b": torch.zeros((*batch, conv_dim), dtype=dtype, device=device),
        "A_log": a_log.expand(*batch, H).clone(),
        "dt_bias": torch.zeros((*batch, H), **f32),
        "D": torch.ones((*batch, H), **f32),
        "norm_g": torch.ones((*batch, d_in), dtype=dtype, device=device),
        "out_proj": nn.dense_init(gen, d_in, d, **kw),
        "ln": torch.ones((*batch, d), dtype=dtype, device=device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (b, l, c), w: (k, c). Returns (y, new_state)
    where the state carries the last k-1 inputs for decoding."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    wx = w.to(x.dtype)
    y = sum(xp[:, i:i + x.shape[1]] * wx[i] for i in range(k))
    return y + b.to(x.dtype), xp[:, -(k - 1):]


def _pad_len(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad dim 1 (the sequence) of ``t`` by ``pad`` at the end."""
    if not pad:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + tuple(t.shape[2:]))], dim=1)


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """SSD: y[t] = C_t^T (sum_{s<=t} prod_{u=s+1..t} exp(dtA_u) dt_s B_s x_s^T).

    x: (b, l, h, p); dt: (b, l, h); A: (h,) negative; B, C: (b, l, g, n).
    Returns (y (b, l, h, p) in x's dtype, final state (b, h, n, p) f32).
    ``l`` is padded up to a multiple of ``chunk`` (zero dt: no decay, no
    input) and the result sliced back."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    pad = (-l) % chunk
    x, dt, B, C = (_pad_len(t, pad) for t in (x, dt, B, C))
    L = x.shape[1]
    nc = L // chunk
    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    # jnp.repeat along the group axis: each group serves rep consecutive heads
    Bh = B.reshape(b, nc, chunk, g, n).float().repeat_interleave(rep, dim=3)
    Ch = C.reshape(b, nc, chunk, g, n).float().repeat_interleave(rep, dim=3)

    a_cs = torch.cumsum(dtc * A.float(), dim=2)     # (b, nc, q, h) inclusive
    a_last = a_cs[:, :, -1:]                        # (b, nc, 1, h)

    # ---- intra-chunk ----
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))[None, None, :, :, None]
    # mask BEFORE exp: exp of the (positive) upper triangle overflows, and
    # inf * 0 would poison the gradients
    delta = a_cs[:, :, :, None, :] - a_cs[:, :, None, :, :]
    decay = torch.exp(torch.where(mask, delta, float("-inf")))
    del delta
    w = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh)
    w = w * decay * dtc[:, :, None, :, :]
    del decay
    y = torch.einsum("bcijh,bcjhp->bcihp", w, xc)
    del w

    # ---- chunk states ----
    sdecay = torch.exp(a_last - a_cs) * dtc         # (b, nc, q, h)
    s_chunk = torch.einsum("bcqhn,bcqhp->bchnp", Bh * sdecay[..., None], xc)
    chunk_decay = torch.exp(a_last[:, :, 0])        # (b, nc, h)

    # ---- inter-chunk pass: the state entering each chunk ----
    S = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    s_in = []
    for c in range(nc):
        s_in.append(S)
        S = S * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    S_in = torch.stack(s_in, dim=1)                 # (b, nc, h, n, p)

    y = y + torch.einsum("bcqhn,bchnp->bcqhp", Ch * torch.exp(a_cs)[..., None], S_in)
    y = y.reshape(b, L, h, p)[:, :l]
    return y.to(x.dtype), S


def ssd_naive(x, dt, A, B, C):
    """O(L) recurrence oracle (tests only)."""
    b, l, h, p = x.shape
    rep = h // B.shape[2]
    Bh = B.float().repeat_interleave(rep, dim=2)
    Ch = C.float().repeat_interleave(rep, dim=2)
    dtf = dt.float()
    S = torch.zeros((b, h, B.shape[3], p), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(l):
        dec = torch.exp(dtf[:, t] * A)[:, :, None, None]
        S = S * dec + torch.einsum("bh,bhn,bhp->bhnp", dtf[:, t], Bh[:, t],
                                   x[:, t].float())
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], S))
    return torch.stack(ys, dim=1).to(x.dtype)


def _split_proj(cfg: ModelConfig, proj):
    d_in, H, G, N = _dims(cfg)
    z, xBC, dt = torch.split(proj, [d_in, d_in + 2 * G * N, H], dim=-1)
    return z, xBC, dt, (d_in, H, G, N)


def mamba_block(cfg: ModelConfig, p, x, *, conv_state=None, ssm_state=None,
                single_step: bool = False):
    """x: (b, l, d) -> (y (b, l, d), new_conv_state, new_ssm_state).

    ``single_step`` (l = 1) advances ``ssm_state`` by one token. The chunked
    form starts its scan from zero whatever ``ssm_state`` holds (the conv
    state IS carried), exactly as the reference: a multi-token call into a
    non-empty cache is not a continuation."""
    s = cfg.ssm
    res = x
    x = nn.rms_norm(x, p["ln"], cfg.rms_eps)
    z, xBC, dt, (d_in, H, G, N) = _split_proj(cfg, nn.linear(x, p["in_proj"]))
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_state)
    xBC = F.silu(xBC)
    xc, B, C = torch.split(xBC, [d_in, G * N, G * N], dim=-1)
    b, l = x.shape[0], x.shape[1]
    xh = xc.reshape(b, l, H, s.head_dim)
    Bh = B.reshape(b, l, G, N)
    Ch = C.reshape(b, l, G, N)
    dtv = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    if single_step:
        rep = H // G
        Bt = Bh[:, 0].float().repeat_interleave(rep, dim=1)
        Ct = Ch[:, 0].float().repeat_interleave(rep, dim=1)
        dtt = dtv[:, 0]
        dec = torch.exp(dtt * A)[:, :, None, None]
        S = ssm_state * dec + torch.einsum("bh,bhn,bhp->bhnp", dtt, Bt,
                                           xh[:, 0].float())
        y = torch.einsum("bhn,bhnp->bhp", Ct, S)[:, None]
        new_ssm = S
    else:
        y, new_ssm = ssd_chunked(xh, dtv, A, Bh, Ch, s.chunk_size)
    y = y.float() + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(b, l, d_in).to(x.dtype)
    y = nn.rms_norm(y * F.silu(z), p["norm_g"], cfg.rms_eps)
    return res + nn.linear(y, p["out_proj"]), new_conv, new_ssm


def init_mamba_state(cfg: ModelConfig, batch: int, dtype, *, device="cuda"):
    """(conv state (batch, d_conv - 1, conv_dim) in ``dtype``, ssm state
    (batch, H, N, head_dim) f32), zeros."""
    s = cfg.ssm
    d_in, H, G, N = _dims(cfg)
    return (torch.zeros((batch, s.d_conv - 1, d_in + 2 * G * N), dtype=dtype,
                        device=device),
            torch.zeros((batch, H, N, s.head_dim), dtype=torch.float32,
                        device=device))
