"""The flash branch's gradient in bf16: the precision contract of the port's
bf16 backward kernel (``csrc/lowrank_flash_bwd_bf16.cu``) and the bf16
training slice it serves, against the JAX package.

(a) The CUDA kernel runs only on the card, so its arithmetic is emulated
    here in plain torch, step for step: bf16 q, k, v, out and dout, f32 lse;
    S = Q K^T and dP = dout V^T from exact bf16 products summed in f32;
    P = exp2(S scale log2 e - lse log2 e), D = rowsum(dout o out) and
    dS = P o (dP - D) in f32; P and dS entering dv = P^T dout,
    dk = dS^T Q and dq = dS K as two bf16 terms, x_hi = bf16(x) and x_lo =
    bf16(x - x_hi), in the kernel's order: each tile of 64 queries (dk, dv:
    the dK/dV kernel's query tiles, the GQA group's heads one after
    another) or 64 keys (dq) summed in a partial of its own, k-step by
    k-step (16 queries or keys, the lo term and then the hi term added in
    f32), and joined to its gradient with one f32 add; the scale applied
    last and each gradient rounded to bf16 once. Inside a k-step and in the
    partial the tensor cores sum in their own way, not f32
    round-to-nearest, which cannot be emulated here: the partial holds 8
    such sums of 16 terms, and phase 6 of ``chip_smoke.py`` holds the
    kernel to the same tolerance on the card, at a 16384-key case with
    131,072 summands per dk / dv row among its cases (summed over all
    tiles on the tensor cores, the gradients missed it there 2.3-fold).
    It is held against the float64 backward on the same inputs (q, k, v,
    the forward's bf16 out, dout) at the tolerance
    ``chip_smoke.py`` holds the kernel to against ``lowrank_flash_bwd_plain``
    on the card: ``BWD_BF16_ATOL`` of each gradient's largest magnitude
    plus ``BWD_BF16_RTOL`` of each element. Two bf16 steps of the element
    cover the one rounding to bf16 on both sides; the f32 sums lie within
    about 2e-6 of the largest magnitude (a float64 check of the f32 path),
    ten times inside the absolute term. The same emulation with P and dS rounded once
    to bf16 (FlashAttention's route) must miss that tolerance at every
    case, and the plain backward must meet it: the tolerance tells the two
    designs apart and holds the kernel's reference to it.
(b) ``attend(chunked=True)`` gradients of the port in bf16 (through
    ``LowrankFlash``'s plain passes) against ``jax.vjp`` of the reference's
    ``attend(chunked=True)`` on the same bf16 inputs, at 1040-1100 keys,
    GQA included, both against the float64 gradient of the function on
    those inputs: the port no farther from it than JAX (``ATTEND_FACTOR``;
    JAX rounds S to bf16 and P to one bf16 term: the port read 0.35-0.6 of
    JAX's distance), and the two within ``ATTEND_STEPS`` bf16 steps of
    JAX's largest magnitude (read: at most 1.5).
(c) One ``make_train_step`` step of reduced qwen2.5-14b made bf16 at
    2 x 1040 tokens with ``loss(chunked=True)``, against the JAX package's
    step on the same converted weights and batch: loss and grad norm within
    ``TRAIN_REL`` relative (both sides sum bf16 activations in other
    orders and round at other places; read 4e-6 and 3.2e-5), the learning
    rate exactly, and every
    parameter within 2 lr (AdamW normalises each element's first step, so
    a gradient element near zero may move its parameter by lr either way)
    plus two bf16 steps of its value (each side rounds the updated
    parameter to bf16 once).

The JAX side is imported in a fixture. The file runs torch on one intra-op
thread.
"""
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs.base import TrainConfig as TTrainConfig  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels import lowrank_flash  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402

# chip_smoke.BWD_BF16_ATOL, chip_smoke.BWD_BF16_RTOL
BWD_BF16_ATOL, BWD_BF16_RTOL = 2e-5, 2 ** -6
TILE = 64                       # queries (dK/dV) or keys (dQ) per partial of the kernel
K_STEP = 16                     # rows per wgmma k-step
ATTEND_FACTOR = 1.0
ATTEND_STEPS = 2
TRAIN_REL = 2 ** -12
SEQ, BATCH, LR = 1040, 2, 1e-2  # > the 1024-key chunk: the flash branch

# (a): b, hq, hkv, sq, skv, r, dv, causal, q_offset: GQA 2 and 3, q_offset > 0
# with sq < skv, non-causal, MLA's r = 192 with dv = 128, odd r and dv,
# qwen's r = dv = 128 at GQA 4
EMU_CASES = [
    (1, 4, 2, 256, 256, 64, 64, True, 0),
    (2, 4, 4, 130, 200, 32, 64, True, 70),
    (1, 2, 2, 100, 150, 16, 16, False, 0),
    (1, 2, 1, 64, 64, 192, 128, True, 0),
    (1, 3, 1, 77, 77, 20, 12, True, 0),
    (1, 4, 1, 64, 300, 128, 128, True, 236),
]
# (b): b, hq, hkv, sq, skv, d_qk, d_v, causal, q_offset
ATTEND_CASES = [
    (1, 2, 2, 1040, 1040, 16, 16, True, 0),
    (1, 6, 2, 1100, 1100, 24, 16, True, 0),
    (1, 4, 1, 40, 1060, 16, 8, True, 1020),
]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: beside other test workers OpenMP's waiting
    threads slow the port's small products severalfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """The JAX package and the parity helpers."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import torch_parity
    from repro.configs import get_config
    from repro.configs.base import TrainConfig
    from repro.data.synthetic import SyntheticLM
    from repro.models import attention
    from repro.models.api import get_model as jget_model
    from repro.optim import adamw
    from repro.train import loop
    return types.SimpleNamespace(jax=jax, jnp=jnp, tp=torch_parity, get_config=get_config,
                                 TrainConfig=TrainConfig, SyntheticLM=SyntheticLM,
                                 attention=attention, get_model=jget_model, adamw=adamw,
                                 loop=loop)


def _bf16_inputs(case, seed):
    """q, k, v, dout as bf16 tensors from seeded numpy, (b, h, s, d)."""
    b, hq, hkv, sq, skv, r, dv = case[:7]
    g = np.random.default_rng(seed)
    return [torch.from_numpy(g.standard_normal(s).astype(np.float32)).bfloat16()
            for s in ((b, hq, sq, r), (b, hkv, skv, r), (b, hkv, skv, dv), (b, hq, sq, dv))]


def _visible(sq, skv, causal, q_offset):
    if not causal:
        return torch.ones(sq, skv, dtype=torch.bool)
    return torch.arange(skv)[None, :] <= torch.arange(sq)[:, None] + q_offset


def _terms(x, terms):
    """x as the kernel hands it to a product: bf16(x) and bf16(x - bf16(x))
    (or nothing) as f32 values."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float() if terms == 2 else torch.zeros_like(x)


def emulate_bwd(q, k, v, o, lse, do, *, scale, causal, q_offset, terms):
    """The bf16 backward kernel's arithmetic in plain torch (f32 but where
    it rounds to bf16), P and dS as ``terms`` bf16 terms."""
    b, hq, sq, r = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    g = hq // hkv
    qf, dof = q.float(), do.float()
    kr = k.float().repeat_interleave(g, dim=1)
    vr = v.float().repeat_interleave(g, dim=1)
    dsum = (dof * o.float()).sum(-1)
    c = scale * math.log2(math.e)
    s = qf @ kr.transpose(-1, -2)                       # exact products, f32 sums
    p = torch.where(_visible(sq, skv, causal, q_offset),
                    torch.exp2(s * c - (lse * math.log2(math.e))[..., None]), 0.0)
    ds = p * (dof @ vr.transpose(-1, -2) - dsum[..., None])
    p_hi, p_lo = _terms(p, terms)
    ds_hi, ds_lo = _terms(ds, terms)

    def tiles(n, product):
        """sum over tiles of TILE rows of the contraction (n of them) of
        the tile's partial: its k-steps' products (lo term, then hi term)
        added in f32 in turn, the partial then joined with one f32 add"""
        acc = 0.0
        for t0 in range(0, n, TILE):
            part = 0.0
            for s0 in range(t0, min(t0 + TILE, n), K_STEP):
                lo, hi = product(slice(s0, s0 + K_STEP))
                part = part + lo
                part = part + hi
            acc = acc + part
        return acc

    def by_head(x):                                     # (b, hq, ...) -> (b, hkv, g, ...)
        return x.reshape(b, hkv, g, *x.shape[2:])
    pq_hi, pq_lo, dst_hi, dst_lo = (by_head(x).transpose(-1, -2)
                                  for x in (p_hi, p_lo, ds_hi, ds_lo))
    qg, dog = by_head(qf), by_head(dof)
    dk, dvv = 0.0, 0.0
    for h in range(g):                                  # the dK/dV kernel's heads, then tiles
        dvv = dvv + tiles(sq, lambda w: (pq_lo[:, :, h, :, w] @ dog[:, :, h, w],
                                         pq_hi[:, :, h, :, w] @ dog[:, :, h, w]))
        dk = dk + tiles(sq, lambda w: (dst_lo[:, :, h, :, w] @ qg[:, :, h, w],
                                       dst_hi[:, :, h, :, w] @ qg[:, :, h, w]))
    dq = tiles(skv, lambda w: (ds_lo[..., w] @ kr[..., w, :], ds_hi[..., w] @ kr[..., w, :]))
    return (scale * dq).bfloat16(), (scale * dk).bfloat16(), dvv.bfloat16()


def backward_f64(q, k, v, o, do, *, scale, causal, q_offset):
    """The backward in float64 on the same inputs (D from the given out)."""
    b, hq, sq, r = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    g = hq // hkv
    qd, od, dod = q.double(), o.double(), do.double()
    kr = k.double().repeat_interleave(g, dim=1)
    vr = v.double().repeat_interleave(g, dim=1)
    s = (scale * qd @ kr.transpose(-1, -2)).masked_fill(
        ~_visible(sq, skv, causal, q_offset), -math.inf)
    p = torch.softmax(s, dim=-1)
    ds = p * (dod @ vr.transpose(-1, -2) - (dod * od).sum(-1, keepdim=True))
    dk = (scale * ds.transpose(-1, -2) @ qd).reshape(b, hkv, g, skv, r).sum(2)
    dvv = (p.transpose(-1, -2) @ dod).reshape(b, hkv, g, skv, dv).sum(2)
    return scale * ds @ kr, dk, dvv


def _misses(got, want):
    """Elements past BWD_BF16_ATOL x max|want| + BWD_BF16_RTOL |want|, and
    the worst error over its limit."""
    d = (got.double() - want).abs()
    lim = BWD_BF16_ATOL * want.abs().max() + BWD_BF16_RTOL * want.abs()
    return int((d > lim).sum()), float((d / lim).max())


@pytest.fixture(scope="module")
def emu_runs():
    """case -> (float64 gradients, plain backward, two-term and one-term
    emulations), each case once."""
    cache = {}

    def run(case):
        if case not in cache:
            q, k, v, do = _bf16_inputs(case, sum(case[:7]))
            kw = dict(scale=case[5] ** -0.5, causal=case[7], q_offset=case[8])
            o, lse = lowrank_flash.lowrank_flash_plain(q, k, v, return_lse=True, **kw)
            assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
            cache[case] = (backward_f64(q, k, v, o, do, **kw),
                           lowrank_flash.lowrank_flash_bwd_plain(q, k, v, o, lse, do, **kw),
                           emulate_bwd(q, k, v, o, lse, do, terms=2, **kw),
                           emulate_bwd(q, k, v, o, lse, do, terms=1, **kw))
        return cache[case]
    return run


@pytest.mark.parametrize("case", EMU_CASES, ids=[str(c) for c in EMU_CASES])
def test_two_bf16_terms_meet_the_tolerance(emu_runs, case):
    """(a) The emulated kernel and the plain backward (bf16 outputs) within
    the tolerance of the float64 gradient, every element."""
    want, plain, two, _ = emu_runs(case)
    for name, w, p, t in zip(("dq", "dk", "dv"), want, plain, two):
        assert t.dtype == p.dtype == torch.bfloat16 and t.shape == p.shape == w.shape
        for label, got in (("emulation", t), ("plain", p)):
            n, worst = _misses(got, w)
            assert n == 0, f"{label} {name}: {n} elements miss (worst {worst:.3g}x)"


@pytest.mark.parametrize("case", EMU_CASES, ids=[str(c) for c in EMU_CASES])
def test_one_bf16_term_misses_the_tolerance(emu_runs, case):
    """(a) P and dS rounded once to bf16 miss the tolerance in each gradient."""
    want, _, _, one = emu_runs(case)
    for name, w, o in zip(("dq", "dk", "dv"), want, one):
        n, worst = _misses(o, w)
        assert n > 0 and worst > 1.0, f"{name}: one bf16 term meets the tolerance here"


def _err(got, want64):
    return float(np.abs(np.asarray(got, np.float64) - want64).max())


@pytest.mark.parametrize("case", ATTEND_CASES, ids=[str(c) for c in ATTEND_CASES])
def test_attend_chunked_bf16_grads_match_jax(ref, case):
    """(b) attend(chunked=True) in bf16: the port's gradients (LowrankFlash's
    plain passes) and jax.vjp of the reference's, each against the float64
    gradient of the function on the same bf16 inputs."""
    b, hq, hkv, sq, skv, r, dv, causal, off = case
    scale = r ** -0.5
    kw = dict(scale=scale, causal=causal, q_offset=off, chunked=True)
    q, k, v, do = (t.transpose(1, 2).contiguous() for t in _bf16_inputs(case, 1))
    g = hq // hkv
    jnp = ref.jnp

    def fwd(q_, k_, v_):
        return ref.attention.attend(q_, jnp.repeat(k_, g, axis=2), jnp.repeat(v_, g, axis=2),
                                    **kw)

    @ref.jax.jit
    def fwd_vjp(q_, k_, v_, do_):
        out, vjp = ref.jax.vjp(fwd, q_, k_, v_)
        return out, vjp(do_)
    _, want = fwd_vjp(*(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                        for t in (q, k, v, do)))
    want = [np.asarray(w.astype(jnp.float32)) for w in want]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    lowrank_flash.LAUNCHES["lowrank_flash"] = 0
    out = tattn.attend(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, do)
    assert lowrank_flash.LAUNCHES["lowrank_flash"] == 0       # the plain passes here
    assert out.dtype == torch.bfloat16 and all(t.dtype == torch.bfloat16 for t in got)
    # the float64 gradient of softmax(scale q k^T) v on these inputs
    leaves64 = [t.double().transpose(1, 2).requires_grad_(True) for t in (q, k, v)]
    q64, k64, v64 = leaves64
    s = scale * q64 @ k64.repeat_interleave(g, 1).transpose(-1, -2)
    s = s.masked_fill(~_visible(sq, skv, causal, off), -math.inf)
    o64 = torch.softmax(s, -1) @ v64.repeat_interleave(g, 1)
    exact = [t.transpose(1, 2).numpy() for t in torch.autograd.grad(
        o64, leaves64, do.double().transpose(1, 2))]
    for name, t, j, e in zip(("dq", "dk", "dv"), got, want, exact):
        assert t.shape == j.shape == e.shape
        e_port, e_jax = _err(t.float().numpy(), e), _err(j, e)
        assert e_port <= ATTEND_FACTOR * e_jax, (name, e_port, e_jax)
        top = float(np.abs(j).max())
        step = 2.0 ** (math.floor(math.log2(top)) - 7)
        assert np.abs(t.float().numpy() - j).max() <= ATTEND_STEPS * step, (name, top)


@pytest.fixture(scope="module")
def qwen_bf16(ref):
    """Reduced qwen2.5-14b in bf16 (params and activations) on both sides:
    configs, JAX init(PRNGKey(0)) and its converted params, one 2 x 1040
    batch."""
    cfg = ref.get_config("qwen2.5-14b", reduced=True).with_(
        dtype="bfloat16", param_dtype="bfloat16", max_seq_len=SEQ)
    pj, pt = ref.tp.jax_and_torch_params(cfg)
    data = ref.SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=0)
    return dict(cfg=cfg, tcfg=ref.tp.torch_config(cfg), pj=pj, pt=pt,
                batch_j=data.batch_at(0), batch_t=ref.tp.JaxBatches(data).batch_at(0))


def test_bf16_chunked_train_step_matches_jax(ref, qwen_bf16):
    """(c) One step of make_train_step with loss(chunked=True) on reduced
    qwen2.5-14b in bf16: loss, grad norm, lr and every parameter after
    AdamW against the JAX package's step."""
    s = qwen_bf16
    cfg, tcfg = s["cfg"], s["tcfg"]
    assert s["pt"]["embed"].dtype == torch.bfloat16
    fj, ft = ref.get_model(cfg), get_model(tcfg)
    tc = dict(global_batch=BATCH, seq_len=SEQ, lr=LR, warmup_steps=1, total_steps=1)
    step_j = ref.jax.jit(ref.loop.make_train_step(
        cfg, ref.TrainConfig(**tc), lambda p, b, rng: fj.loss(p, b, chunked=True)))
    step_t = tloop.make_train_step(tcfg, TTrainConfig(**tc),
                                   lambda p, b, rng: ft.loss(p, b, chunked=True))
    pj, _, mj = step_j(s["pj"], ref.adamw.init(s["pj"]), s["batch_j"],
                       ref.jax.random.fold_in(ref.jax.random.PRNGKey(0), 0))
    lowrank_flash.LAUNCHES["lowrank_flash"] = 0
    pt, st, mt = step_t(s["pt"], tadamw.init(s["pt"]), s["batch_t"],
                        prng.fold_in(prng.key(0), 0))
    assert lowrank_flash.LAUNCHES["lowrank_flash"] == 0
    assert int(st.step) == 1
    for name, rtol in (("loss", TRAIN_REL), ("grad_norm", TRAIN_REL), ("lr", 0.0)):
        np.testing.assert_allclose(float(mt[name]), float(mj[name]), rtol=rtol, err_msg=name)
    lr = float(mj["lr"])
    flat_j = ref.jax.tree_util.tree_flatten_with_path(pj)[0]
    flat_t = tu.leaves_with_path(pt)
    assert len(flat_j) == len(flat_t)
    for (path, j), (name, t) in zip(flat_j, flat_t):
        assert ref.jax.tree_util.keystr(path).replace("']['", "/")[2:-2] == name
        assert t.dtype == torch.bfloat16, name
        j = np.asarray(j.astype(ref.jnp.float32), np.float64)
        d = np.abs(t.float().numpy() - j)
        assert (d <= 2 * lr + 2.0 ** -6 * np.abs(j)).all(), (name, d.max())
