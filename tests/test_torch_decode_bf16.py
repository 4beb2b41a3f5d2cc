"""The precision contract of the port's bf16 ``flash_decode`` kernel
(``csrc/decode_attn_bf16.cu``), held against the JAX package's Pallas
kernel (``repro.kernels.decode_attn.flash_decode``, interpret mode on the
CPU) on the same bf16 inputs.

The CUDA kernel runs only on the card, so its arithmetic is emulated here in
plain torch, step for step: bf16 q, k and v; S = Q K^T from exact bf16
products summed in f32; the key splits of ``decode_attn.split_plan`` for a
132-SM card (or a smaller one, for longer splits); in each split, one online
softmax per key group of each 64-key tile (4 / MT groups of 16 MT keys, MT
the block's 16-row m-tiles; 2^(fma(s, log2 e, -m log2 e)) as the kernel
takes it), P.V with P split into two bf16 terms, P_hi =
bf16(P) and P_lo = bf16(P - P_hi), summed per tile and joined to the
rescaled output; the key groups merged in order, then the splits, as the
combine does; the output rounded to bf16 once. The emulation must meet the
tolerance ``chip_smoke.py`` holds the kernel to on the card: 2e-5 + 2^-6
|ref| per output, 2e-5 + 2e-5 |ref| per probability. The same emulation with
P rounded once to bf16 must miss it at one case at least, so the suite tells
the two designs apart.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attn import flash_decode as jax_flash_decode  # noqa: E402
from repro_torch.kernels import decode_attn  # noqa: E402

ATOL, RTOL, P_RTOL = 2e-5, 2 ** -6, 2e-5   # chip_smoke.TOL, BF16_REL, TOL
TILE = 64                                  # keys per tile of the CUDA kernel
LOG2E = float(np.float32(math.log2(math.e)))   # the kernel's f32 log2(e)

# b, hq, hkv, C, M, r, dv, kv_len, q_start, q_lens, SMs of the split plan
CASES = [
    (2, 8, 8, 1, 200, 128, 128, (200, 1), None, None, 132),        # group 1, kv_len M and 1
    (2, 6, 2, 1, 160, 128, 128, (97, 160), None, None, 4),         # group 3, 2-tile splits
    (2, 8, 2, 1, 130, 128, 128, (130, 64), None, None, 132),       # group 4
    (2, 10, 2, 1, 192, 128, 128, (1, 150), None, None, 2),         # group 5, 3-tile splits
    (1, 12, 2, 1, 100, 128, 128, (77,), None, None, 132),          # group 6
    (2, 14, 2, 1, 128, 128, 128, (128, 30), None, None, 132),      # group 7
    (2, 10, 2, 1, 160, 64, 128, (160, 33), None, None, 132),       # factor read r = 64
    (2, 6, 3, 5, 96, 24, 16, (30, 96), (25, 60), (5, 3), 132),     # C = 5, odd widths
    (2, 14, 2, 16, 128, 40, 48, (16, 128), (0, 100), (16, 12), 3),  # C = 16: 2 x 64 rows
    (2, 10, 2, 80, 192, 128, 128, (120, 192), (40, 112), (80, 70), 132),  # chunk path
    (3, 4, 2, 80, 160, 128, 128, (80, 160, 50), (0, 80, 10), (80, 80, 0), 1),  # long splits
]
IDS = [str(c[:7]) for c in CASES]


def key_ends(case):
    """(b, C) one past each query's last visible key (0: none)."""
    b, _, _, C, M, _, _, kl, qs, ql, _ = case
    kl = np.asarray(kl, np.int64)
    qs = kl - C if qs is None else np.asarray(qs, np.int64)
    ql = np.full(b, C) if ql is None else np.asarray(ql, np.int64)
    j = np.arange(C)[None, :]
    end = np.clip(np.minimum(kl[:, None], qs[:, None] + j + 1), 0, M)
    return np.where(j < ql[:, None], end, 0)


def emulate(q, k, v, end, *, scale, sms, p_terms):
    """The bf16 kernel's arithmetic in plain torch (f32 but where it rounds
    to bf16): q (b, hq, C, r), k, v (b, hkv, M, .) bf16, end (b, C)."""
    b, hq, C, _ = q.shape
    hkv, M = k.shape[1], k.shape[2]
    group = hq // hkv
    _, split_len, n_split = decode_attn.split_plan(b, hq, hkv, C, M, sms, torch.bfloat16)
    rows = group * C
    mt = 1 if rows <= 16 else 2 if rows <= 32 else 4
    nk = 16 * mt                                   # keys per warp and tile
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    sc = (q.float() @ kf.transpose(-1, -2)) * scale
    visible = torch.arange(M)[None, None, None, :] < torch.from_numpy(end)[:, None, :, None]
    x = sc.masked_fill(~visible, -math.inf)
    shape = q.shape[:3]
    parts = []
    for s in range(n_split):
        groups = []
        for kg in range(4 // mt):
            m = torch.full(shape, -math.inf)
            l = torch.zeros(shape)
            o = torch.zeros(shape + (v.shape[3],))
            for t0 in range(s * split_len, min((s + 1) * split_len, M), TILE):
                lo, hi = t0 + kg * nk, min(t0 + (kg + 1) * nk, M)
                if lo >= hi:
                    continue
                xt, vt = x[..., lo:hi], vf[:, :, lo:hi]
                m_new = torch.maximum(m, xt.amax(-1))
                m2 = torch.where(m_new == -math.inf, 0.0, m_new) * LOG2E
                corr = torch.exp2(_fma_log2e(m, m2))
                p = torch.exp2(_fma_log2e(xt, m2[..., None]))
                l = l * corr + p.sum(-1)
                p_hi = p.bfloat16().float()
                pv = p_hi @ vt
                if p_terms == 2:
                    pv = (p - p_hi).bfloat16().float() @ vt + pv
                o = o * corr[..., None] + pv
                m = m_new
            groups.append((m, l, o))
        parts.append(_merge(groups))
    m, l, o = _merge(parts)
    out = torch.where(l[..., None] > 0, o / l[..., None], 0.0).bfloat16()
    probs = torch.where(visible, torch.exp(sc - m[..., None]) / l[..., None], 0.0)
    return out, probs


def _fma_log2e(x, m2):
    """fmaf(x, log2 e, -m2) in f32: the product exact in f64, one rounding."""
    return (x.double() * LOG2E - m2.double()).float()


def _merge(parts):
    """Partials (m, l, o) merged in order, as the kernel's key groups and the
    combine's splits are: weights exp(m_i - max m), 0 for an empty one."""
    mb = torch.stack([m for m, _, _ in parts]).amax(0)
    ls, os_ = torch.zeros_like(mb), torch.zeros_like(parts[0][2])
    for m, l, o in parts:
        f = torch.where(m == -math.inf, 0.0, torch.exp(m - mb))
        ls = ls + f * l
        os_ = os_ + f[..., None] * o
    return mb, ls, os_


def _misses(got, want, rtol):
    d = (got.float() - want.float()).abs()
    lim = ATOL + rtol * want.float().abs()
    return int((d > lim).sum()), float((d / lim).max())


@pytest.fixture(scope="module")
def runs():
    """case -> (JAX kernel's out and probs, the two emulations, key ends),
    each case once, on one intra-op thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cache = {}

    def run(case):
        if case not in cache:
            b, hq, hkv, C, M, r, dv, kl, qs, ql, sms = case
            rng = np.random.default_rng(sum(case[:7]))
            arrs = [rng.standard_normal(s).astype(np.float32)
                    for s in ((b, hq, C, r), (b, hkv, M, r), (b, hkv, M, dv))]
            tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in arrs)
            jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                          for t in (tq, tk, tv))
            kw = {} if qs is None else {"q_start": jnp.asarray(np.asarray(qs, np.int32)),
                                        "q_lens": jnp.asarray(np.asarray(ql, np.int32))}
            o, p = jax_flash_decode(jq, jk, jv, jnp.asarray(np.asarray(kl, np.int32)),
                                    scale=r ** -0.5, interpret=True, return_probs=True, **kw)
            want = (torch.from_numpy(np.array(o.astype(jnp.float32))),
                    torch.from_numpy(np.array(p)))
            end = key_ends(case)
            em = {n: emulate(tq, tk, tv, end, scale=r ** -0.5, sms=sms, p_terms=n)
                  for n in (1, 2)}
            cache[case] = (want, em[2], em[1], end)
        return cache[case]

    yield run
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_two_bf16_terms_meet_the_contract(runs, case):
    (want_o, want_p), (out, probs), _, _ = runs(case)
    assert out.shape == want_o.shape and out.dtype == torch.bfloat16
    assert probs.shape == want_p.shape
    n, worst = _misses(out, want_o, RTOL)
    assert n == 0, f"{n} outputs miss {ATOL:g} + {RTOL:g}|ref| (worst {worst:.3g}x)"
    n, worst = _misses(probs, want_p, P_RTOL)
    assert n == 0, f"{n} probabilities miss {ATOL:g} + {P_RTOL:g}|ref| (worst {worst:.3g}x)"


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_queries_without_a_visible_key_are_exact_zeros(runs, case):
    """A query with no visible key (past q_lens, or kv_len 0 under it) gives
    an all-zero output and probability row; masked keys give exact zeros."""
    (want_o, want_p), (out, probs), _, end = runs(case)
    empty = torch.from_numpy(end == 0)[:, None, :].expand(out.shape[:3])
    assert torch.all(out[empty] == 0) and torch.all(want_o[empty] == 0)
    M = probs.shape[-1]
    masked = torch.arange(M) >= torch.from_numpy(end)[:, None, :, None]
    assert torch.all(probs.masked_select(masked) == 0)
    assert torch.all(want_p.masked_select(masked) == 0)


def test_one_bf16_term_misses_the_contract(runs):
    """P rounded once to bf16 (FlashAttention's and cuDNN's route) misses the
    output tolerance at one case at least."""
    counts = {}
    for case in CASES:
        (want_o, _), _, (one, _), _ = runs(case)
        counts[str(case[:7])] = _misses(one, want_o, RTOL)
    assert any(n > 0 and worst > 1.0 for n, worst in counts.values()), counts

