"""Both kernels' plain versions at the shapes the dense configs, granite,
DeepSeek-V3, Zamba2, Seamless and Qwen2-VL give them, against the JAX
package's Pallas kernels in interpret mode on the same numpy inputs:
``lowrank_flash`` at MLA's r = qk_nope + qk_rope = 192 with dv = 128 (MHA
and GQA), at zamba2's shared attention (32 heads of 112: r = dv = 112,
between the kernel's padded widths), seamless's decoder self-attention
(16 heads of 64) and qwen2-vl's (28/4 heads of 128), at reduced lengths
(and at full width, 2 x 4096, on the card), and ``flash_decode``
at r = dv = 128 with GQA groups of 3, 5 and 7 (the groups of 4-7 of the
dense configs meet the CUDA kernel's row tile of 4 unevenly), a decode row
and a query chunk with per-row starts; the same shapes on the card against
the CUDA kernels (``cuda`` marker), where ``lowrank_flash`` now takes
r <= 192 and ``flash_decode`` still refuses r > 128.

Tolerances: f32 2e-5 (the JAX kernel tests' own); bf16 2e-2 (bf16 inputs
and outputs).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attn import flash_decode as jax_flash_decode  # noqa: E402
from repro.kernels.ops import flash_attention as jax_flash_attention  # noqa: E402
from repro_torch.kernels import decode_attn, lowrank_flash  # noqa: E402
from repro_torch.kernels.ops import decode_attention, flash_attention  # noqa: E402

F32, BF16 = "float32", "bfloat16"
TOL = {F32: 2e-5, BF16: 2e-2}
_JNP = {F32: jnp.float32, BF16: jnp.bfloat16}
_TORCH = {F32: torch.float32, BF16: torch.bfloat16}

# b, hq, hkv, sq, skv, r, dv, causal, q_offset
FLASH_CASES = [
    (1, 4, 4, 40, 40, 192, 128, True, 0),      # MLA: 128 heads of q.k 192, v 128
    (1, 6, 2, 33, 70, 192, 128, True, 37),     # GQA 3, a dense cache ahead
    (2, 10, 2, 24, 24, 192, 128, False, 0),    # GQA 5, non-causal
    (1, 14, 2, 17, 17, 160, 128, True, 0),     # GQA 7, r between 128 and 192
]
# the chunked forwards of zamba2-7b, seamless-m4t-medium and qwen2-vl-7b:
# their heads and widths at reduced lengths
FAMILY_CASES = [
    (1, 32, 32, 40, 40, 112, 112, True, 0),    # zamba2's shared attention
    (1, 16, 16, 40, 40, 64, 64, True, 0),      # seamless's decoder
    (1, 28, 4, 40, 40, 128, 128, True, 0),     # qwen2-vl, GQA 7
]
# the same at full width: b = 2, 4096 tokens
FAMILY_FULL = [(2,) + c[1:3] + (4096, 4096) + c[5:] for c in FAMILY_CASES]
# b, hq, hkv, C, M, r, dv, kv_len, q_start
DECODE_CASES = [
    (2, 6, 2, 1, 96, 128, 128, (96, 41), None),               # GQA 3
    (3, 10, 2, 1, 80, 128, 128, (1, 80, 57), None),           # GQA 5
    (2, 14, 2, 1, 64, 128, 128, (64, 30), None),              # GQA 7
    (2, 14, 2, 6, 64, 128, 128, (40, 6), (34, 0)),            # GQA 7, a chunk
    (2, 10, 2, 5, 48, 64, 128, (30, 48), (25, 43)),           # GQA 5, factor read r 64
]


def _inputs(shapes, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(_JNP[dtype]) for a in arrs],
            [torch.from_numpy(a).to(_TORCH[dtype]) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _flash_shapes(case):
    b, hq, hkv, sq, skv, r, dv = case[:7]
    return [(b, hq, sq, r), (b, hkv, skv, r), (b, hkv, skv, dv)]


def _decode_shapes(case):
    b, hq, hkv, C, M, r, dv = case[:7]
    return [(b, hq, C, r) if C > 1 else (b, hq, r), (b, hkv, M, r), (b, hkv, M, dv)]


@pytest.mark.parametrize("case", FLASH_CASES + FAMILY_CASES,
                         ids=[str(c) for c in FLASH_CASES + FAMILY_CASES])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_flash_wide_rank_matches_jax_kernel(case, dtype):
    r, causal, off = case[5], case[7], case[8]
    (jq, jk, jv), (tq, tk, tv) = _inputs(_flash_shapes(case), dtype)
    out_j = jax_flash_attention(jq, jk, jv, scale=r ** -0.5, causal=causal,
                                block_q=16, block_k=16, q_offset=off, interpret=True)
    out_t = flash_attention(tq, tk, tv, scale=r ** -0.5, causal=causal, q_offset=off)
    assert out_t.dtype == _TORCH[dtype] and out_t.shape == tuple(out_j.shape)
    np.testing.assert_allclose(_np(out_t), _np(out_j), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("case", DECODE_CASES, ids=[str(c) for c in DECODE_CASES])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_decode_gqa_groups_match_jax_kernel(case, dtype):
    b, hq, hkv, C, M, r, dv, kl, qs = case
    (jq, jk, jv), (tq, tk, tv) = _inputs(_decode_shapes(case), dtype, seed=1)
    lens = np.asarray(kl, np.int32)
    kw_j = {} if qs is None else {"q_start": jnp.asarray(np.asarray(qs, np.int32))}
    kw_t = {} if qs is None else {"q_start": torch.tensor(qs, dtype=torch.int32)}
    out_j, p_j = jax_flash_decode(jq, jk, jv, jnp.asarray(lens), scale=r ** -0.5,
                                  block_k=32, interpret=True, return_probs=True, **kw_j)
    out_t, p_t = decode_attention(tq, tk, tv, torch.from_numpy(lens.copy()),
                                  scale=r ** -0.5, return_probs=True, **kw_t)
    assert out_t.shape == tuple(out_j.shape) and p_t.shape == tuple(p_j.shape)
    np.testing.assert_allclose(_np(out_t), _np(out_j), atol=TOL[dtype], rtol=TOL[dtype])
    np.testing.assert_allclose(_np(p_t), _np(p_j), atol=2e-5, rtol=2e-5)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """The kernels' limits: lowrank_flash takes r <= 192 and dv <= 128,
    flash_decode r, dv <= 128; the kernel entry point refuses CPU tensors
    (no fallback). The limits themselves are checked on the card."""
    assert lowrank_flash.MAX_RANK == 192 and lowrank_flash.MAX_DIM == 128
    assert decode_attn.MAX_DIM == 128
    with pytest.raises(ValueError, match="CUDA"):
        lowrank_flash.lowrank_flash(*_inputs(_flash_shapes(FLASH_CASES[0]), F32)[1],
                                    scale=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES + FAMILY_FULL,
                         ids=[str(c) for c in FLASH_CASES + FAMILY_FULL])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_cuda_flash_wide_rank_matches_plain(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: pytest -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    r, causal, off = case[5], case[7], case[8]
    _, (tq, tk, tv) = _inputs(_flash_shapes(case), dtype)
    q, k, v = tq.cuda(), tk.cuda(), tv.cuda()
    before = lowrank_flash.LAUNCHES["lowrank_flash"]
    out = flash_attention(q, k, v, scale=r ** -0.5, causal=causal, q_offset=off)
    torch.cuda.synchronize()
    assert lowrank_flash.LAUNCHES["lowrank_flash"] == before + 1
    want = lowrank_flash.lowrank_flash_plain(q, k, v, scale=r ** -0.5, causal=causal,
                                             q_offset=off)
    np.testing.assert_allclose(_np(out.cpu()), _np(want.cpu()), atol=TOL[dtype],
                               rtol=TOL[dtype])
    with pytest.raises(ValueError, match="192"):
        lowrank_flash.lowrank_flash(torch.zeros(1, 1, 4, 200, device="cuda"),
                                    torch.zeros(1, 1, 4, 200, device="cuda"),
                                    torch.zeros(1, 1, 4, 8, device="cuda"), scale=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_CASES, ids=[str(c) for c in DECODE_CASES])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_cuda_decode_gqa_groups_match_plain(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: pytest -m cuda)")
    b, hq, hkv, C, M, r, dv, kl, qs = case
    _, (tq, tk, tv) = _inputs(_decode_shapes(case), dtype, seed=1)
    q, k, v = tq.cuda(), tk.cuda(), tv.cuda()
    lens = torch.tensor(kl, dtype=torch.int32).cuda()
    kw = {} if qs is None else {"q_start": torch.tensor(qs, dtype=torch.int32).cuda()}
    before = decode_attn.LAUNCHES["flash_decode"]
    out, p = decode_attention(q, k, v, lens, scale=r ** -0.5, return_probs=True, **kw)
    torch.cuda.synchronize()
    assert decode_attn.LAUNCHES["flash_decode"] == before + 1
    ro, rp = decode_attn.flash_decode_plain(q, k, v, lens, scale=r ** -0.5,
                                            return_probs=True, **kw)
    np.testing.assert_allclose(_np(out.cpu()), _np(ro.cpu()), atol=TOL[dtype],
                               rtol=TOL[dtype])
    np.testing.assert_allclose(_np(p.cpu()), _np(rp.cpu()), atol=2e-5, rtol=2e-5)
