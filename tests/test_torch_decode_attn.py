"""The port's flash decode (``repro_torch.kernels``) against the JAX
package's Pallas kernel (``flash_decode``, interpret mode on the CPU) and
its oracles, on the same numpy inputs.

Tolerances: f32 2e-5 (the JAX kernel tests' own; both sides accumulate in
f32, in different orders); bf16 2e-2 (bf16 inputs and outputs).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attn import flash_decode as jax_flash_decode  # noqa: E402
from repro.kernels.ref import decode_chunk_ref as jax_chunk_ref  # noqa: E402
from repro.kernels.ref import decode_ref as jax_decode_ref  # noqa: E402
from repro_torch.kernels import decode_attn, ref  # noqa: E402
from repro_torch.kernels.ops import decode_attention  # noqa: E402

F32, BF16 = "float32", "bfloat16"
TOL = {F32: 2e-5, BF16: 2e-2}
_JNP = {F32: jnp.float32, BF16: jnp.bfloat16}
_TORCH = {F32: torch.float32, BF16: torch.bfloat16}

# tests/test_kernels.py:DECODE_CASES (b, hq, hkv, M, r, dv, kv_len), plus
# two ragged ranks (r = 24, 40) with GQA and per-row lengths
DECODE_CASES = [
    (2, 4, 2, 128, 16, 32, 100),
    (1, 8, 8, 256, 64, 64, 256),
    (2, 2, 1, 64, 8, 16, 1),
    (1, 4, 1, 96, 128, 128, 50),
    (1, 8, 2, 37, 24, 16, 30),
    (2, 6, 3, 65, 40, 48, (33, 65)),
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


@pytest.mark.parametrize("case", DECODE_CASES, ids=[str(c) for c in DECODE_CASES])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_decode_matches_jax_kernel(case, dtype):
    b, hq, hkv, M, r, dv, klen = case
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(b, hq, r), (b, hkv, M, r), (b, hkv, M, dv)], dtype)
    lens = np.broadcast_to(np.asarray(klen, np.int32), (b,))
    out_j = jax_flash_decode(jq, jk, jv, jnp.asarray(lens), scale=r ** -0.5,
                             block_k=32, interpret=True)
    out_t = decode_attention(tq, tk, tv, torch.from_numpy(lens.copy()),
                             scale=r ** -0.5)
    assert out_t.dtype == tv.dtype and out_t.shape == (b, hq, dv)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(out_t), _np(out_j), atol=tol, rtol=tol)
    # the port's oracle against the JAX oracle
    np.testing.assert_allclose(
        _np(ref.decode_ref(tq, tk, tv, torch.from_numpy(lens.copy()),
                           scale=r ** -0.5)),
        _np(jax_decode_ref(jq, jk, jv, jnp.asarray(lens), scale=r ** -0.5)),
        atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_decode_per_row_kv_len_and_rank(dtype):
    """Continuous-batching form: per-row kv_len, per-row rank as zeroed
    factor columns (tests/test_kernels.py:test_decode_per_row_kv_len)."""
    b, hq, hkv, M, r, dv = 4, 4, 2, 96, 16, 32
    rng = np.random.default_rng(1)
    q = rng.standard_normal((b, hq, r)).astype(np.float32)
    k = rng.standard_normal((b, hkv, M, r)).astype(np.float32)
    v = rng.standard_normal((b, hkv, M, dv)).astype(np.float32)
    lens = np.asarray([1, 17, 96, 40], np.int32)
    col_ok = np.arange(r)[None, :] < np.asarray([4, 8, 16, 12])[:, None]
    q = q * col_ok[:, None, :]
    k = k * col_ok[:, None, None, :]
    dj, dt = _JNP[dtype], _TORCH[dtype]
    out_j = jax_flash_decode(jnp.asarray(q).astype(dj), jnp.asarray(k).astype(dj),
                             jnp.asarray(v).astype(dj), jnp.asarray(lens),
                             scale=r ** -0.5, block_k=32, interpret=True)
    out_t = decode_attention(torch.from_numpy(q).to(dt),
                             torch.from_numpy(k).to(dt),
                             torch.from_numpy(v).to(dt),
                             torch.from_numpy(lens), scale=r ** -0.5)
    np.testing.assert_allclose(_np(out_t), _np(out_j), atol=TOL[dtype],
                               rtol=TOL[dtype])


CHUNK_CASES = [
    # b, hq, hkv, C, M, r, dv, q_start, valid queries per row
    (4, 4, 2, 6, 96, 16, 32, (0, 17, 29, 64), (6, 6, 6, 1)),
    (3, 6, 3, 5, 70, 24, 16, (0, 40, 3), (5, 2, 1)),
    (2, 4, 4, 7, 40, 40, 8, (0, 30), (7, 7)),
]


@pytest.mark.parametrize("case", CHUNK_CASES, ids=[str(c[:7]) for c in CHUNK_CASES])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_chunked_queries_with_probs(case, dtype):
    """Chunked-prefill form: per-row q_start, causal within the chunk,
    kv_len = q_start + valid queries, normalised probability rows. The
    whole output is compared, padding queries included (both versions see
    the same clamped window there)."""
    b, hq, hkv, C, M, r, dv, q_start, n_valid = case
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(b, hq, C, r), (b, hkv, M, r), (b, hkv, M, dv)], dtype, seed=2)
    qs = np.asarray(q_start, np.int32)
    kv_len = qs + np.asarray(n_valid, np.int32)
    out_j, p_j = jax_flash_decode(jq, jk, jv, jnp.asarray(kv_len),
                                  scale=r ** -0.5, block_k=32, interpret=True,
                                  return_probs=True, q_start=jnp.asarray(qs))
    out_t, p_t = decode_attention(tq, tk, tv, torch.from_numpy(kv_len),
                                  scale=r ** -0.5, return_probs=True,
                                  q_start=torch.from_numpy(qs))
    assert p_t.dtype == torch.float32 and p_t.shape == (b, hq, C, M)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(out_t), _np(out_j), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(p_t), _np(p_j), atol=tol, rtol=tol)
    p = p_t.numpy()
    for i in range(b):
        for j in range(n_valid[i]):
            np.testing.assert_allclose(p[i, :, j].sum(-1), 1.0, atol=1e-5)
            # exactly zero beyond the causal window
            assert np.all(p[i, :, j, qs[i] + j + 1:] == 0.0)
    # the port's oracle agrees on the valid queries
    ro, rp = ref.decode_chunk_ref(tq, tk, tv, torch.from_numpy(kv_len),
                                  torch.from_numpy(qs), scale=r ** -0.5)
    jo, jp = jax_chunk_ref(jq, jk, jv, jnp.asarray(kv_len), jnp.asarray(qs),
                           scale=r ** -0.5)
    for i in range(b):
        n = n_valid[i]
        np.testing.assert_allclose(_np(ro)[i, :, :n], _np(jo)[i, :, :n],
                                   atol=tol, rtol=tol)
        np.testing.assert_allclose(_np(rp)[i, :, :n], _np(jp)[i, :, :n],
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_q_lens_padding_is_exact_zero(dtype):
    """Queries at j >= q_lens[b] give exact-zero outputs and probability
    rows, in the port as in the Pallas kernel."""
    b, hq, hkv, C, M, r, dv = 3, 4, 2, 6, 64, 24, 16
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(b, hq, C, r), (b, hkv, M, r), (b, hkv, M, dv)], dtype, seed=3)
    qs = np.asarray([0, 10, 50], np.int32)
    ql = np.asarray([6, 2, 0], np.int32)
    kv_len = qs + ql
    out_j, p_j = jax_flash_decode(jq, jk, jv, jnp.asarray(kv_len),
                                  scale=r ** -0.5, block_k=16, interpret=True,
                                  return_probs=True, q_start=jnp.asarray(qs),
                                  q_lens=jnp.asarray(ql))
    out_t, p_t = decode_attention(tq, tk, tv, torch.from_numpy(kv_len),
                                  scale=r ** -0.5, return_probs=True,
                                  q_start=torch.from_numpy(qs),
                                  q_lens=torch.from_numpy(ql))
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(out_t), _np(out_j), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(p_t), _np(p_j), atol=tol, rtol=tol)
    for i in range(b):
        assert np.all(_np(out_t)[i, :, ql[i]:] == 0.0)
        assert np.all(_np(p_t)[i, :, ql[i]:] == 0.0)
        assert np.all(_np(out_j)[i, :, ql[i]:] == 0.0)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never falls back: CPU tensors are refused, and only
    ``decode_attention`` routes them to the plain version."""
    q, k, v = torch.zeros(1, 2, 8), torch.zeros(1, 2, 16, 8), torch.zeros(1, 2, 16, 8)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attn.flash_decode(q, k, v, 4, scale=1.0)
    before = dict(decode_attn.LAUNCHES)
    decode_attention(q, k, v, 4, scale=1.0)
    assert decode_attn.LAUNCHES == before        # the plain path is no launch


KERNEL_CASES = [
    # b, hq, hkv, C, M, r, dv, kv_len, q_start, q_lens
    (2, 4, 2, 1, 128, 16, 32, (100, 100), None, None),
    (3, 6, 3, 37, 130, 24, 40, (37, 130, 60), (0, 93, 10), (37, 20, 0)),
    (8, 12, 12, 128, 2048, 64, 64, (128, 2048, 300, 1000, 129, 700, 1500, 64),
     (0, 1920, 172, 872, 1, 572, 1372, 63), (128,) * 7 + (1,)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", KERNEL_CASES, ids=[str(c[:7]) for c in KERNEL_CASES])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_cuda_kernel_matches_plain(case, dtype):
    """On the card: the CUDA kernel against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    b, hq, hkv, C, M, r, dv, kl, qs, ql = case
    _, (q, k, v) = _inputs([(b, hq, C, r), (b, hkv, M, r), (b, hkv, M, dv)],
                           dtype, seed=4)
    q, k, v = q.cuda(), k.cuda(), v.cuda()

    def ints(x):
        return None if x is None else torch.tensor(x, dtype=torch.int32).cuda()

    args = dict(scale=r ** -0.5, return_probs=True, q_start=ints(qs),
                q_lens=ints(ql))
    o, p = decode_attn.flash_decode(q, k, v, ints(kl), **args)
    torch.cuda.synchronize()
    ro, rp = decode_attn.flash_decode_plain(q, k, v, ints(kl), **args)
    tol = TOL[dtype]
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(p, rp, atol=tol, rtol=tol)
    assert torch.equal(p == 0, rp == 0)


# (b, hq, hkv, C, M) swept by the split-plan tests: decode and chunk paths,
# GQA, M not a multiple of the split unit, one row and many
PLAN_SHAPES = [(b, hq, hkv, C, M)
               for b in (1, 3, 8) for hq, hkv in ((12, 12), (16, 4), (8, 1))
               for C in (1, 5, 16, 17, 128) for M in (1, 37, 64, 1000, 2048, 4099)]


@pytest.mark.parametrize("sm_count", [1, 8, 132])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_split_plan_covers_every_key_once(sm_count, dtype):
    """Split s covers [s * split_len, min((s + 1) * split_len, M)): across
    the sweep, every key position of a row lies in exactly one split, and
    each split is a whole number of the path's units (the bf16 kernel's
    64-key tile on both of its paths)."""
    for b, hq, hkv, C, M in PLAN_SHAPES:
        path, split_len, n_split = decode_attn.split_plan(b, hq, hkv, C, M, sm_count,
                                                          _TORCH[dtype])
        assert path == ("decode" if C <= decode_attn.DECODE_MAX_C else "chunk")
        unit = (decode_attn.BF16_SPLIT_UNIT if dtype == BF16
                else decode_attn.SPLIT_UNIT[path])
        assert split_len % unit == 0 and n_split >= 1
        hits = np.zeros(M, np.int64)
        for s in range(n_split):
            lo, hi = s * split_len, min((s + 1) * split_len, M)
            assert lo < hi, f"split {s} of {(b, hq, hkv, C, M)} is empty"
            hits[lo:hi] += 1
        assert np.all(hits == 1), (b, hq, hkv, C, M, split_len, n_split)


def test_split_plan_aims_at_blocks_per_sm():
    """At the serving shapes the grid holds about BLOCKS_PER_SM = 8 blocks
    per SM of a 132-SM card: 11 key splits at C = 1, 6 at C = 128. In bf16
    one block holds a kv head's rows (64 at most): qwen2.5-14b (40/8 heads)
    takes 16 splits of two tiles at C = 1 and, at C = 128, ten row tiles of
    64 (5 heads x 128 queries) and 2 splits."""
    assert decode_attn.BLOCKS_PER_SM == 8
    assert decode_attn.split_plan(8, 12, 12, 1, 2048, 132) == ("decode", 192, 11)
    assert decode_attn.split_plan(8, 12, 12, 128, 2048, 132) == ("chunk", 384, 6)
    bf16 = torch.bfloat16
    assert decode_attn.split_plan(8, 40, 8, 1, 2048, 132, bf16) == ("decode", 128, 16)
    assert decode_attn.split_plan(8, 40, 8, 128, 2048, 132, bf16) == ("chunk", 1024, 2)
    # more rows than the card can hold at once: no split
    assert decode_attn.split_plan(64, 32, 8, 128, 512, 132)[2] == 1
    assert decode_attn.split_plan(64, 32, 8, 128, 512, 132, bf16)[2] == 1


@pytest.mark.parametrize("C", [1, 6, 40])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_launch_plan_reads_nothing_on_the_host(C, dtype):
    """The wrapper's preparation works on tensors that cannot be read on the
    host (the meta device): it depends on shapes alone, so it never syncs
    with the device to read kv_len, q_start or q_lens."""
    b, hq, hkv, M, r, dv = 3, 8, 2, 300, 24, 40
    meta = torch.device("meta")
    q = torch.empty((b, hq, C, r), device=meta, dtype=_TORCH[dtype])
    k = torch.empty((b, hkv, M, r), device=meta, dtype=_TORCH[dtype])
    v = torch.empty((b, hkv, M, dv), device=meta, dtype=_TORCH[dtype])
    lens = torch.empty((b,), dtype=torch.int32, device=meta)
    with pytest.raises(Exception):
        lens.tolist()                  # what a host read of kv_len would do
    (kl, qs, ql), out, probs, work, plan = decode_attn._prepare(
        q, k, v, lens, None, torch.empty((b,), dtype=torch.int64, device=meta),
        True, 132)
    assert plan == decode_attn.split_plan(b, hq, hkv, C, M, 132, _TORCH[dtype])
    assert out.dtype == _TORCH[dtype]
    assert all(t.dtype == torch.int32 and t.shape == (b,) for t in (kl, qs, ql))
    assert out.shape == (b, hq, C, dv) and probs.shape == (b, hq, C, M)
    assert work.numel() == b * hq * C * plan[2] * (dv + 2)


def split_boundary_cases(sm_count, dtype=torch.float32):
    """Cases at the key splits of the card's plan for the kernel of
    ``dtype``: kv_len equal to a split's size, one less and one more, rows of
    kv_len 1 and M, a GQA group of 4, and chunks in which some queries see no
    key of a whole split (decode and chunk paths). Rows: b, hq, hkv, C, M, r,
    dv, kv_len, q_start, q_lens."""
    def split(b, hq, hkv, C, M):
        return decode_attn.split_plan(b, hq, hkv, C, M, sm_count, dtype)[1]

    L = split(6, 8, 8, 1, 2048)
    G = split(4, 16, 4, 1, 1024)
    D = split(3, 4, 2, 8, 1024)
    K = split(3, 4, 2, 80, 1024)
    return [
        (6, 8, 8, 1, 2048, 64, 64, (L, L - 1, L + 1, 1, 2048, min(2 * L + 3, 2048)),
         None, None),
        (4, 16, 4, 1, 1024, 64, 64, (G, G - 1, G + 1, 1024), None, None),
        (3, 4, 2, 8, 1024, 40, 24, (D + 4, D + 8, 8), (D - 4, D, 0), (8, 8, 5)),
        (3, 4, 2, 80, 1024, 32, 48, (K + 40, min(2 * K + 80, 1024), 80),
         (K - 40, min(2 * K, 944), 0), (80, 80, 70)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("case_index", range(4))
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_cuda_kernel_at_split_boundaries(case_index, dtype):
    """On the card: the split-boundary cases of each kernel's plan against
    the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    b, hq, hkv, C, M, r, dv, kl, qs, ql = split_boundary_cases(sms, _TORCH[dtype])[case_index]
    _, (q, k, v) = _inputs([(b, hq, C, r), (b, hkv, M, r), (b, hkv, M, dv)],
                           dtype, seed=5)
    q, k, v = q.cuda(), k.cuda(), v.cuda()

    def ints(x):
        return None if x is None else torch.tensor(x, dtype=torch.int32).cuda()

    args = dict(scale=r ** -0.5, return_probs=True, q_start=ints(qs),
                q_lens=ints(ql))
    o, p = decode_attn.flash_decode(q, k, v, ints(kl), **args)
    torch.cuda.synchronize()
    ro, rp = decode_attn.flash_decode_plain(q, k, v, ints(kl), **args)
    tol = TOL[dtype]
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(p, rp, atol=TOL[F32], rtol=TOL[F32])
    assert torch.equal(p == 0, rp == 0)
    assert torch.isfinite(o.float()).all()
