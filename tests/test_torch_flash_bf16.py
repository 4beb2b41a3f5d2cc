"""The precision contract of the port's bf16 ``lowrank_flash`` kernel
(``csrc/lowrank_flash_bf16.cu``), held against the JAX package's Pallas
kernel (``repro.kernels.lowrank_flash.lowrank_flash``, interpret mode on the
CPU) on the same bf16 inputs.

The CUDA kernel runs only on the card, so its arithmetic is emulated here in
plain torch, step for step: bf16 q, k and v; S = Q K^T from exact bf16
products summed in f32; an online softmax in base 2 over 64-key tiles; P.V
with P split into two bf16 terms, P_hi = bf16(P) and P_lo = bf16(P - P_hi),
summed per tile and joined to the rescaled output; the output rounded to
bf16 once. The emulation must meet the tolerance ``chip_smoke.py`` holds the
kernel to on the card, 2e-5 + 2^-6 |ref| per element. The same emulation
with P rounded once to bf16 (FlashAttention's and cuDNN's route) must miss
it at every case, so each case tells the two designs apart.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.lowrank_flash import lowrank_flash as jax_lowrank_flash  # noqa: E402

ATOL, RTOL = 2e-5, 2 ** -6          # chip_smoke.TOL, chip_smoke.BF16_REL
TILE = 64                           # keys per tile of the CUDA kernel

# tests/test_torch_flash.py:FLASH_CASES (b, hq, hkv, sq, skv, r, dv, causal)
# and a 256-query causal case
CASES = [
    (2, 4, 2, 64, 64, 16, 32, True),
    (1, 4, 4, 128, 128, 64, 64, True),
    (2, 2, 1, 48, 96, 8, 16, False),
    (1, 8, 2, 37, 37, 24, 16, True),
    (1, 2, 2, 16, 16, 128, 128, True),
    (2, 6, 3, 33, 65, 40, 48, True),
    (1, 4, 2, 40, 40, 12, 16, True),
    (2, 2, 2, 24, 24, 4, 8, True),
    (1, 2, 1, 17, 17, 16, 16, True),
    (1, 8, 2, 40, 40, 128, 128, True),
    (1, 2, 2, 20, 20, 6, 10, True),
    (1, 4, 4, 256, 256, 64, 64, True),
]


def emulate(q, k, v, *, scale, causal, p_terms):
    """The bf16 kernel's arithmetic in plain torch (f32 but where it rounds
    to bf16); q, k, v bf16 tensors (b, h, s, d) with GQA as the kernel's."""
    hq, sq = q.shape[1], q.shape[2]
    hkv, skv = k.shape[1], k.shape[2]
    qf = q.float()
    kf = k.float().repeat_interleave(hq // hkv, dim=1)
    vf = v.float().repeat_interleave(hq // hkv, dim=1)
    c = scale * math.log2(math.e)
    shape = q.shape[:3]
    m = torch.full(shape, -math.inf)
    l = torch.zeros(shape)
    o = torch.zeros(shape + (v.shape[3],))
    q_pos = torch.arange(sq)[:, None]
    for k0 in range(0, skv, TILE):
        s = qf @ kf[:, :, k0:k0 + TILE].transpose(-1, -2)
        if causal:
            k_pos = torch.arange(k0, min(skv, k0 + TILE))[None, :]
            s = s.masked_fill(k_pos > q_pos, -math.inf)
        m_new = torch.maximum(m, s.amax(-1) * c)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s * c - m_new[..., None])
        l = l * corr + p.sum(-1)
        p_hi = p.bfloat16().float()
        if p_terms == 2:
            p_lo = (p - p_hi).bfloat16().float()
            pv = p_lo @ vf[:, :, k0:k0 + TILE] + p_hi @ vf[:, :, k0:k0 + TILE]
        else:
            pv = p_hi @ vf[:, :, k0:k0 + TILE]
        o = o * corr[..., None] + pv
        m = m_new
    return (o / l[..., None]).bfloat16()


def _misses(got, want):
    d = (got.float() - want.float()).abs()
    lim = ATOL + RTOL * want.float().abs()
    return int((d > lim).sum()), float((d / lim).max())


@pytest.fixture(scope="module")
def runs():
    """case -> (JAX kernel's output, the two emulations), each case once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cache = {}

    def run(case):
        if case not in cache:
            b, hq, hkv, sq, skv, r, dv, causal = case
            rng = np.random.default_rng(sum(case[:7]))
            arrs = [rng.standard_normal(s).astype(np.float32)
                    for s in ((b, hq, sq, r), (b, hkv, skv, r), (b, hkv, skv, dv))]
            tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in arrs)
            jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                          for t in (tq, tk, tv))
            want = jax_lowrank_flash(jq, jk, jv, scale=r ** -0.5, causal=causal,
                                     interpret=True)
            want = torch.from_numpy(np.array(want.astype(jnp.float32)))
            kw = dict(scale=r ** -0.5, causal=causal)
            cache[case] = (want, emulate(tq, tk, tv, p_terms=2, **kw),
                           emulate(tq, tk, tv, p_terms=1, **kw))
        return cache[case]

    yield run
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_two_bf16_terms_meet_the_tolerance(runs, case):
    want, two, _ = runs(case)
    assert two.shape == want.shape and two.dtype == torch.bfloat16
    n, worst = _misses(two, want)
    assert n == 0, f"{n} outputs miss {ATOL:g} + {RTOL:g}|ref| (worst {worst:.3g}x)"


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_one_bf16_term_misses_the_tolerance(runs, case):
    want, _, one = runs(case)
    n, worst = _misses(one, want)
    assert n > 0 and worst > 1.0, "P as one bf16 term meets the tolerance here"
