"""The port's low-rank flash attention (``repro_torch.kernels``) against the
JAX package's Pallas kernel (``flash_attention``, interpret mode on the
CPU) and its oracle, on the same numpy inputs.

Tolerances: f32 2e-5 (the JAX kernel tests' own; both sides accumulate in
f32, in different orders); bf16 2e-2 (bf16 inputs and outputs; the oracle
also rounds p to bf16 before P.V, the kernels keep it in f32).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ops import flash_attention as jax_flash_attention  # noqa: E402
from repro.kernels.ref import flash_ref as jax_flash_ref  # noqa: E402
from repro_torch.kernels import decode_attn, lowrank_flash, ref  # noqa: E402
from repro_torch.kernels.ops import flash_attention, few_query, reset_launches  # noqa: E402

F32, BF16 = "float32", "bfloat16"
TOL = {F32: 2e-5, BF16: 2e-2}
_JNP = {F32: jnp.float32, BF16: jnp.bfloat16}
_TORCH = {F32: torch.float32, BF16: torch.bfloat16}

# tests/test_kernels.py:FLASH_CASES (b, hq, hkv, sq, skv, r, dv, causal),
# then shapes the CUDA kernel's tiling meets (16 queries per warp, widths
# padded to a multiple of 8)
FLASH_CASES = [
    (2, 4, 2, 64, 64, 16, 32, True),      # GQA, low rank
    (1, 4, 4, 128, 128, 64, 64, True),    # MHA, r=dv
    (2, 2, 1, 48, 96, 8, 16, False),      # cross-ish, non-causal
    (1, 8, 2, 37, 37, 24, 16, True),      # ragged seq vs block
    (1, 2, 2, 16, 16, 128, 128, True),    # full-rank head_dim 128
    (2, 6, 3, 33, 65, 40, 48, True),      # odd everything
    (1, 4, 2, 40, 40, 12, 16, True),      # r not a multiple of 8
    (2, 2, 2, 24, 24, 4, 8, True),        # r = 4, dv = 8
    (1, 2, 1, 17, 17, 16, 16, True),      # a second warp with one row
    (1, 8, 2, 40, 40, 128, 128, True),    # GQA 4:1 at r = dv = 128
    (1, 2, 2, 20, 20, 6, 10, True),       # widths not a multiple of 4
]
# decode_step_dense's call: one query after a dense cache of more than 1024
# keys (b, hq, hkv, sq, skv, r, dv, causal, q_offset)
DECODE_CASE = (1, 4, 2, 1, 1100, 16, 16, True, 1099)


def _inputs(shapes, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(_JNP[dtype]) for a in arrs],
            [torch.from_numpy(a).to(_TORCH[dtype]) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _shapes(case):
    b, hq, hkv, sq, skv, r, dv, _ = case
    return [(b, hq, sq, r), (b, hkv, skv, r), (b, hkv, skv, dv)]


@pytest.mark.parametrize("case", FLASH_CASES, ids=[str(c) for c in FLASH_CASES])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_flash_matches_jax_kernel(case, dtype):
    r, causal = case[5], case[7]
    (jq, jk, jv), (tq, tk, tv) = _inputs(_shapes(case), dtype)
    out_j = jax_flash_attention(jq, jk, jv, scale=r ** -0.5, causal=causal,
                                block_q=16, block_k=16, interpret=True)
    out_t = flash_attention(tq, tk, tv, scale=r ** -0.5, causal=causal)
    assert out_t.dtype == _TORCH[dtype] and out_t.shape == tuple(out_j.shape)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(out_t), _np(out_j), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", FLASH_CASES, ids=[str(c) for c in FLASH_CASES])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_flash_ref_matches_jax_ref(case, dtype):
    r, causal = case[5], case[7]
    (jq, jk, jv), (tq, tk, tv) = _inputs(_shapes(case), dtype, seed=1)
    want = jax_flash_ref(jq, jk, jv, scale=r ** -0.5, causal=causal)
    got = ref.flash_ref(tq, tk, tv, scale=r ** -0.5, causal=causal)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_flash_q_offset_matches_jax_kernel():
    """Suffix queries at q_offset: the port, the Pallas kernel and the
    suffix rows of the full causal oracle agree."""
    b, h, s, d = 1, 2, 32, 16
    (jq, jk, jv), (tq, tk, tv) = _inputs([(b, h, s, d)] * 3, F32, seed=2)
    out_j = jax_flash_attention(jq[:, :, -4:], jk, jv, scale=d ** -0.5,
                                causal=True, q_offset=s - 4, block_q=8,
                                block_k=8, interpret=True)
    out_t = flash_attention(tq[:, :, -4:], tk, tv, scale=d ** -0.5,
                            causal=True, q_offset=s - 4)
    full = ref.flash_ref(tq, tk, tv, scale=d ** -0.5, causal=True)
    np.testing.assert_allclose(_np(out_t), _np(out_j), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(out_t), _np(full[:, :, -4:]), atol=2e-5,
                               rtol=2e-5)


def test_flash_decode_shaped_matches_jax_kernel():
    """One query at q_offset = skv - 1 over 1100 keys (GQA): the port, the
    Pallas kernel and the last row of the full causal oracle agree."""
    b, hq, hkv, sq, skv, r, dv, _, off = DECODE_CASE
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(b, hq, skv, r), (b, hkv, skv, r), (b, hkv, skv, dv)], F32, seed=3)
    out_j = jax_flash_attention(jq[:, :, -sq:], jk, jv, scale=r ** -0.5,
                                causal=True, q_offset=off, block_q=8,
                                block_k=128, interpret=True)
    out_t = flash_attention(tq[:, :, -sq:], tk, tv, scale=r ** -0.5,
                            causal=True, q_offset=off)
    full = ref.flash_ref(tq, tk, tv, scale=r ** -0.5, causal=True)
    assert out_t.shape == (b, hq, sq, dv)
    np.testing.assert_allclose(_np(out_t), _np(out_j), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(out_t), _np(full[:, :, -sq:]), atol=2e-5,
                               rtol=2e-5)


def test_negative_q_offset_is_refused():
    """With q_offset < 0 a query may see no key, where the Pallas kernel
    and its oracle disagree: both port versions refuse it."""
    _, (tq, tk, tv) = _inputs([(1, 2, 4, 8), (1, 2, 8, 8), (1, 2, 8, 8)], F32)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(tq, tk, tv, scale=1.0, q_offset=-2)
    with pytest.raises(ValueError, match="q_offset"):
        lowrank_flash.lowrank_flash(tq, tk, tv, scale=1.0, q_offset=-2)


def test_cpu_tensors_run_the_plain_version():
    """On CPU tensors the wrapper computes the plain version and launches
    nothing; the kernel entry point refuses CPU tensors (no fallback)."""
    _, (tq, tk, tv) = _inputs(_shapes(FLASH_CASES[0]), F32)
    reset_launches()
    out = flash_attention(tq, tk, tv, scale=0.25)
    want = lowrank_flash.lowrank_flash_plain(tq, tk, tv, scale=0.25)
    assert torch.equal(out, want)
    assert lowrank_flash.LAUNCHES == {"lowrank_flash": 0, "lowrank_flash_bwd": 0}
    with pytest.raises(ValueError, match="CUDA"):
        lowrank_flash.lowrank_flash(tq, tk, tv, scale=0.25)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c + (0,) for c in FLASH_CASES]
                         + [(2, 12, 12, 1040, 1040, 32, 64, True, 0), DECODE_CASE],
                         ids=[str(c) for c in FLASH_CASES] + ["path-1040", "decode-1100"])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_cuda_kernel_matches_plain(case, dtype):
    """The CUDA kernel against its plain version on the card: the one the
    wrapper routes the call to (flash_decode for at most 16 queries)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: pytest -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    r, causal, off = case[5], case[7], case[8]
    b, hq, hkv, sq, skv, _, dv = case[:7]
    _, (tq, tk, tv) = _inputs([(b, hq, sq, r), (b, hkv, skv, r), (b, hkv, skv, dv)], dtype)
    q, k, v = tq.cuda(), tk.cuda(), tv.cuda()
    counts, kernel = ((decode_attn.LAUNCHES, "flash_decode") if few_query(sq, r, dv)
                      else (lowrank_flash.LAUNCHES, "lowrank_flash"))
    before = counts[kernel]
    out = flash_attention(q, k, v, scale=r ** -0.5, causal=causal, q_offset=off)
    torch.cuda.synchronize()
    assert counts[kernel] == before + 1
    want = lowrank_flash.lowrank_flash_plain(q, k, v, scale=r ** -0.5,
                                             causal=causal, q_offset=off)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(out.cpu()), _np(want.cpu()), atol=tol,
                               rtol=tol)
