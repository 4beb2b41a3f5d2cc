"""Few-query flash attention: ``ops.flash_attention`` sends a call of at most
16 queries (r, dv <= 128) to flash_decode's function with kv_len = skv and
q_start = q_offset (causal) or skv - 1 (not), K/V read in place. On the
CPU the same calls go to ``flash_decode_plain``; here they are held against
the JAX package's Pallas ``lowrank_flash`` (interpret mode, jitted) and the
dense-cache decodes against the JAX package's.

The route's cases: sq in {1, 3, 16}, causal or not, q_offset in {0, a
middle value, skv - sq}, GQA groups of 1 and 7, r != dv, f32 and bf16. The
Pallas kernel runs once per (dtype, group, causal) with every position as
a query (q_offset 0); query i of a case at q_offset sits at position
q_offset + i, so its rows are rows q_offset .. q_offset + sq - 1 of that
run. Three cases also run the Pallas kernel at their own q_offset.

Tolerances: f32 2e-5 and bf16 2e-2 (``tests/test_torch_flash.py``'s);
decoded logits 1e-4 absolute (``tests/test_torch_hybrid.py``'s and
``tests/test_torch_encdec_vlm.py``'s); views against copies exactly.
"""
import functools
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import RankConfig  # noqa: E402
from repro.kernels.lowrank_flash import lowrank_flash as jax_lowrank_flash  # noqa: E402
from repro.models.api import get_model as jax_get_model  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import decode_attn, lowrank_flash, ops  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from torch_parity import torch_config  # noqa: E402

F32, BF16 = "float32", "bfloat16"
TOL = {F32: 2e-5, BF16: 2e-2}
_JNP = {F32: jnp.float32, BF16: jnp.bfloat16}
_TORCH = {F32: torch.float32, BF16: torch.bfloat16}

B, HKV, SKV, R, DV = 2, 2, 40, 24, 16          # r != dv
SQS = (1, 3, 16)
OFFSETS = {"zero": lambda sq: 0, "middle": lambda sq: 11, "last": lambda sq: SKV - sq}
GROUPS = (1, 7)
ROUTE_CASES = list(itertools.product((F32, BF16), GROUPS, (True, False), SQS, OFFSETS))
CACHE_LEN = 1040                               # more than 1024 rows: the flash branch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _arrays(group, seed):
    """q over every position (b, hq, SKV, r), k, v as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    hq = HKV * group
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, hq, SKV, R), (B, HKV, SKV, R), (B, HKV, SKV, DV))]


@functools.lru_cache(maxsize=None)
def _jax_all_positions(dtype, group, causal):
    """The Pallas kernel with every position a query (q_offset 0)."""
    q, k, v = (jnp.asarray(a).astype(_JNP[dtype]) for a in _arrays(group, seed=group))
    out = jax_lowrank_flash(q, k, v, scale=R ** -0.5, causal=causal, q_offset=0,
                            block_q=16, block_k=64, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _torch_case(dtype, group, sq, off):
    q, k, v = (torch.from_numpy(a).to(_TORCH[dtype]) for a in _arrays(group, seed=group))
    return q[:, :, off:off + sq], k, v


@pytest.mark.parametrize("dtype,group,causal,sq,offset", ROUTE_CASES,
                         ids=["-".join(map(str, c)) for c in ROUTE_CASES])
def test_route_matches_jax_kernel(dtype, group, causal, sq, offset):
    off = OFFSETS[offset](sq)
    q, k, v = _torch_case(dtype, group, sq, off)
    assert ops.few_query(sq, R, DV)
    out = ops.flash_attention(q, k, v, scale=R ** -0.5, causal=causal, q_offset=off)
    assert out.dtype == _TORCH[dtype] and out.shape == (B, HKV * group, sq, DV)
    want = _jax_all_positions(dtype, group, causal)[:, :, off:off + sq]
    np.testing.assert_allclose(_np(out), want, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("sq", SQS)
def test_route_matches_jax_kernel_at_its_offset(sq):
    """The Pallas kernel at the case's own sq and q_offset (skv - sq, GQA 7)."""
    off = SKV - sq
    q, k, v = _torch_case(F32, 7, sq, off)
    out = ops.flash_attention(q, k, v, scale=R ** -0.5, causal=True, q_offset=off)
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    want = jax_lowrank_flash(jq, jk, jv, scale=R ** -0.5, causal=True, q_offset=off,
                             block_q=8, block_k=64, interpret=True)
    np.testing.assert_allclose(_np(out), _np(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_cpu_route_is_flash_decode_plain(causal):
    """On the CPU a few-query call is exactly flash_decode_plain with the
    mapped lengths; 17 queries, or r = 192 (MLA), stay lowrank_flash_plain."""
    q, k, v = _torch_case(F32, 7, 3, 11)
    got = ops.flash_attention(q, k, v, scale=0.3, causal=causal, q_offset=11)
    start = 11 if causal else SKV - 1
    want = decode_attn.flash_decode_plain(q, k, v, torch.full((B,), SKV), scale=0.3,
                                          q_start=torch.full((B,), start))
    assert torch.equal(got, want)
    q17, k, v = _torch_case(F32, 7, 17, 11)
    assert not ops.few_query(17, R, DV)
    assert torch.equal(ops.flash_attention(q17, k, v, scale=0.3, causal=causal, q_offset=11),
                       lowrank_flash.lowrank_flash_plain(q17, k, v, scale=0.3, causal=causal,
                                                         q_offset=11))
    assert not ops.few_query(1, 192, 128) and ops.few_query(16, 128, 128)
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(q, k, v, scale=0.3, causal=causal, q_offset=-1)


def _cache_views(dtype, seed=3, kv_len=37, M=50, hq=6, hkv=2, C=3, r=24, dv=40, pad=0):
    """q (b, hq, C, r) and (b, hkv, kv_len, d) views of a (b, M, hkv, d +
    pad) cache buffer, with kv_len < M."""
    g = torch.Generator().manual_seed(seed)
    kc = torch.randn((B, M, hkv, r + pad), generator=g).to(dtype)[..., :r]
    vc = torch.randn((B, M, hkv, dv + pad), generator=g).to(dtype)[..., :dv]
    q = torch.randn((B, hq, C, r), generator=g).to(dtype)
    return q, kc[:, :kv_len].transpose(1, 2), vc[:, :kv_len].transpose(1, 2)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_plain_on_cache_views_equals_copies(dtype):
    """flash_decode_plain on strided views of a cache buffer equals the call
    on contiguous copies exactly (outputs and probabilities), and so does
    the routed flash_attention."""
    q, k, v = _cache_views(_TORCH[dtype])
    assert not k.is_contiguous() and not v.is_contiguous()
    lens, qs = torch.tensor([37, 20]), torch.tensor([30, 5])
    got = decode_attn.flash_decode_plain(q, k, v, lens, scale=0.2, q_start=qs,
                                         return_probs=True)
    want = decode_attn.flash_decode_plain(q, k.contiguous(), v.contiguous(), lens,
                                          scale=0.2, q_start=qs, return_probs=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = ops.flash_attention(q, k, v, scale=0.2, causal=True, q_offset=34)
    want = ops.flash_attention(q, k.contiguous(), v.contiguous(), scale=0.2, causal=True,
                               q_offset=34)
    assert torch.equal(got, want)


_MODELS = {}


def _model(arch):
    """(JAX config, the port's, JAX params, the port's), rank mode 'off'."""
    if arch not in _MODELS:
        cfg = get_config(arch, reduced=True).with_(
            rank=RankConfig(mode="off", rank_grid=(4, 8, 12, 16), segment_len=8))
        jp = jax.jit(jax_get_model(cfg).init)(jax.random.PRNGKey(0))
        _MODELS[arch] = (cfg, torch_config(cfg), jp,
                         params_from_jax(jax.device_get(jp), device="cpu"))
    return _MODELS[arch]


@pytest.mark.parametrize("arch", ["zamba2-7b", "qwen2-vl-7b"])
def test_dense_cache_decode_matches_jax(arch, monkeypatch):
    """A one-token prompt into a cache of CACHE_LEN rows, then three single
    tokens, through ``decode_step(chunked=True)`` (``mhsa``'s flash branch:
    more than 1024 cache rows) on both packages: each step's logits against
    JAX's. Every attention call of the four steps takes the few-query
    route, on views of the cache."""
    cfg, tcfg, jp, tp = _model(arch)
    calls = []
    routed = ops.decode_attention

    def counting(q, k, v, *args, **kw):
        calls.append(k.is_contiguous())
        return routed(q, k, v, *args, **kw)
    monkeypatch.setattr(ops, "decode_attention", counting)
    toks = np.random.default_rng(13).integers(0, 256, (2, 4)).astype(np.int32)
    fj, ft = jax_get_model(cfg), get_model(tcfg)
    cache_j = fj.init_cache(2, CACHE_LEN)
    cache_t = ft.init_cache(2, CACHE_LEN, device="cpu")
    step_j = jax.jit(functools.partial(fj.decode_step, chunked=True))
    for i in range(4):
        d_j, cache_j = step_j(jp, cache_j, jnp.asarray(toks[:, i:i + 1]))
        d_t, cache_t = ft.decode_step(tp, cache_t, torch.from_numpy(toks[:, i:i + 1]),
                                      chunked=True)
        np.testing.assert_allclose(_np(d_t), np.asarray(d_j, np.float32), atol=1e-4,
                                   rtol=0)
    per_step = len(calls) // 4
    assert per_step > 0 and len(calls) == 4 * per_step
    assert not any(calls)          # K/V reach the route as views of the cache


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("shape", [dict(), dict(hq=7, hkv=1, C=1, r=112, dv=112, M=1100,
                                                kv_len=1090),
                                   dict(hq=28, hkv=4, C=16, r=128, dv=128, M=300, kv_len=260),
                                   dict(hq=4, hkv=4, C=1, r=20, dv=12, M=90, kv_len=77),
                                   dict(hq=3, hkv=1, C=2, r=24, dv=16, M=70, kv_len=66, pad=3)],
                         ids=["gqa3-r24", "zamba-like", "qwen-vl-like", "odd-widths",
                              "rows-off-16-bytes"])
def test_cuda_kernel_on_cache_views_matches_plain(dtype, shape):
    """flash_decode on strided views of a cache buffer: within the bf16 or
    f32 tolerance of its plain version, and bitwise the kernel on
    contiguous copies; a last dimension that is not unit-stride is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: pytest -m cuda)")
    q, k, v = (t.cuda() for t in _cache_views(_TORCH[dtype], **shape))
    kl = k.shape[2]
    lens = torch.tensor([kl, kl // 2], dtype=torch.int32, device="cuda")
    kw = dict(scale=q.shape[-1] ** -0.5, return_probs=True)
    o, p = decode_attn.flash_decode(q, k, v, lens, **kw)
    oc, pc = decode_attn.flash_decode(q, k.contiguous(), v.contiguous(), lens, **kw)
    ro, rp = decode_attn.flash_decode_plain(q, k, v, lens, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, oc) and torch.equal(p, pc)
    rel = 2e-5 if dtype == F32 else 2 ** -6
    assert ((o.float() - ro.float()).abs() <= 2e-5 + rel * ro.float().abs()).all()
    assert ((p - rp).abs() <= 2e-5 + 2e-5 * rp.abs()).all()
    with pytest.raises(ValueError, match="unit-stride"):
        decode_attn.flash_decode(q, k, v[..., ::2], lens, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_cuda_route_counts_flash_decode(dtype):
    """On the card the route launches flash_decode (one count), not
    lowrank_flash, and agrees with lowrank_flash_plain; 17 queries launch
    lowrank_flash."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: pytest -m cuda)")
    _, k, v = (t.cuda() for t in _torch_case(dtype, 7, 16, 0))
    for sq, kernel in ((1, "flash_decode"), (16, "flash_decode"), (17, "lowrank_flash")):
        qq = torch.randn((B, HKV * 7, sq, R), device="cuda").to(_TORCH[dtype])
        ops.reset_launches()
        out = ops.flash_attention(qq, k, v, scale=R ** -0.5, causal=True, q_offset=SKV - sq)
        torch.cuda.synchronize()
        counts = {**decode_attn.LAUNCHES, **lowrank_flash.LAUNCHES}
        assert counts == {"flash_decode": int(kernel == "flash_decode"),
                          "lowrank_flash": int(kernel == "lowrank_flash"),
                          "lowrank_flash_bwd": 0}
        want = lowrank_flash.lowrank_flash_plain(qq, k, v, scale=R ** -0.5, causal=True,
                                                 q_offset=SKV - sq)
        np.testing.assert_allclose(_np(out.cpu()), _np(want.cpu()), atol=TOL[dtype],
                                   rtol=TOL[dtype])
