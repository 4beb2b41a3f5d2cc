"""Gradients through the port's flash branch: ``lowrank_flash``'s backward
(``lowrank_flash.LowrankFlash``: the kernels on CUDA tensors, their plain
versions here) and the slice it serves, ``make_train_step`` with
``loss(chunked=True)``, against the JAX package, whose flash branch
(``attention._attend_chunked``, a ``lax.scan``) ``jax.grad`` differentiates.

(a) ``lowrank_flash_bwd_plain`` against ``torch.autograd.grad`` through
    ``lowrank_flash_plain``: GQA 1, 2 and 4, causal or not, q_offset > 0
    with sq < skv, r != dv, r = 192 with dv = 128, sq and skv off a
    multiple of 64;
(b) the port's ``attend(chunked=True)`` gradients (through
    ``LowrankFlash``'s plain passes) against ``jax.vjp`` of the reference's
    ``attend(chunked=True)`` at 1040-1100 keys, GQA included (JAX takes K/V
    repeated over each group; its dK/dV are summed over the group first);
(c) one ``make_train_step`` step of reduced drrl-paper at 2 x 1040 tokens
    with ``loss(chunked=True)``, rank modes 'off' and 'drrl' (and 'drrl'
    with ``remat`` 'full' and 'dots' on both sides), against the JAX
    package's step on the same converted weights and batch;
(d) the route on the CPU: a call of 1 or 16 queries that requires grad goes
    to ``LowrankFlash`` (exactly the plain backward's gradients), a
    grad-free one keeps flash_decode's plain version;
(e) ``cuda``-marked, skipped without a card: the backward kernels against
    their plain version through ``ops.flash_attention`` with grad, f32 and
    bf16, and two runs of each bitwise.

Tolerances (f32 throughout):
  * (a): both sides are f32 sums over at most 300 terms in another order:
    max |diff| within 1e-5 x the gradient's largest magnitude;
  * (b): JAX's online softmax over 1024-key chunks and its XLA gradient
    against one exact softmax and the plain backward: 2e-5 x the largest
    magnitude (each side lies within about 2e-6 of it of a float64
    backward at 4096 keys);
  * (c): ``tests/test_torch_train_loop.py``'s: loss 1e-6 / 2e-5 and grad
    norm 3e-6 / 1e-4 relative ('off' / 'drrl': gradients through ``eigh``),
    every parameter within 2 x lr, 99 % of each leaf within 1e-6 / 5e-5
    (AdamW normalises each element's first step).

The JAX side is imported in a fixture, not at the top: the ``cuda`` tests
run on the card's machine, which has no JAX.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs.base import TrainConfig as TTrainConfig  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels import decode_attn, lowrank_flash, ops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train.rl import value_and_grad  # noqa: E402

SEQ, BATCH, LR = 1040, 2, 1e-2           # > the 1024-key chunk: the flash branch
TRAIN_TOL = {"off": dict(loss=1e-6, grad_norm=3e-6, p99=1e-6),
             "drrl": dict(loss=2e-5, grad_norm=1e-4, p99=5e-5)}

# (a): b, hq, hkv, sq, skv, r, dv, causal, q_offset
PLAIN_CASES = [
    (2, 2, 2, 70, 70, 16, 16, True, 0),
    (1, 4, 2, 100, 100, 24, 40, True, 0),
    (1, 8, 2, 65, 129, 32, 32, True, 64),
    (2, 4, 1, 33, 33, 12, 20, False, 0),
    (1, 6, 3, 40, 300, 16, 24, True, 260),
    (1, 2, 2, 90, 150, 8, 8, False, 0),
    (1, 2, 1, 64, 64, 192, 128, True, 0),
    (1, 4, 4, 1, 77, 16, 16, True, 76),
]
# (b): b, hq, hkv, sq, skv, d_qk, d_v, causal, q_offset
ATTEND_CASES = [
    (1, 2, 2, 1040, 1040, 16, 16, True, 0),
    (2, 6, 2, 1100, 1100, 24, 16, True, 0),
    (1, 4, 1, 40, 1060, 16, 8, True, 1020),
    (1, 2, 2, 1050, 1050, 8, 12, False, 0),
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
    from repro.configs.base import RankConfig, TrainConfig
    from repro.data.synthetic import SyntheticLM
    from repro.models import attention
    from repro.models.api import get_model as jget_model
    from repro.optim import adamw
    from repro.train import loop
    return types.SimpleNamespace(jax=jax, jnp=jnp, tp=torch_parity, get_config=get_config,
                                 RankConfig=RankConfig, TrainConfig=TrainConfig,
                                 SyntheticLM=SyntheticLM, attention=attention,
                                 get_model=jget_model, adamw=adamw, loop=loop)


def _arrays(case, seed):
    """q, k, v, dout as float32 numpy arrays, (b, h, s, d) layouts."""
    b, hq, hkv, sq, skv, r, dv = case[:7]
    g = np.random.default_rng(seed)
    return [g.standard_normal(shape).astype(np.float32)
            for shape in ((b, hq, sq, r), (b, hkv, skv, r), (b, hkv, skv, dv), (b, hq, sq, dv))]


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    top = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * top, (np.abs(got - want).max(), top)


def _plain_grads(q, k, v, do, **kw):
    out, lse = lowrank_flash.lowrank_flash_plain(q, k, v, return_lse=True, **kw)
    return lowrank_flash.lowrank_flash_bwd_plain(q, k, v, out, lse, do, **kw)


@pytest.mark.parametrize("case", PLAIN_CASES, ids=[str(c) for c in PLAIN_CASES])
def test_plain_backward_matches_autograd(case):
    """(a) The plain backward (P from the LSE, D, the GQA sums) against
    autograd through the plain forward; LowrankFlash's CPU passes give the
    plain backward exactly."""
    causal, off = case[7], case[8]
    kw = dict(scale=case[5] ** -0.5, causal=causal, q_offset=off)
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(case, 0))
    got = _plain_grads(q, k, v, do, **kw)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(lowrank_flash.lowrank_flash_plain(*leaves, **kw), leaves, do)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        _close(g, w, 1e-5)
    out = lowrank_flash.LowrankFlash.apply(*leaves, kw["scale"], causal, off)
    via_fn = torch.autograd.grad(out, leaves, do)
    assert all(torch.equal(a, b) for a, b in zip(via_fn, got))


@pytest.mark.parametrize("case", ATTEND_CASES, ids=[str(c) for c in ATTEND_CASES])
def test_attend_chunked_grads_match_jax(ref, case):
    """(b) attend(chunked=True)'s gradients against jax.vjp of the
    reference's, K/V repeated on JAX's side and its dK/dV summed back over
    each group."""
    b, hq, hkv, sq, skv, r, dv, causal, off = case
    kw = dict(scale=r ** -0.5, causal=causal, q_offset=off, chunked=True)
    q, k, v, do = (np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in _arrays(case, 1))
    g = hq // hkv
    jnp = ref.jnp

    def fwd(q_, k_, v_):
        return ref.attention.attend(q_, jnp.repeat(k_, g, axis=2), jnp.repeat(v_, g, axis=2),
                                    **kw)

    @ref.jax.jit
    def fwd_vjp(q_, k_, v_, do_):
        out, vjp = ref.jax.vjp(fwd, q_, k_, v_)
        return out, vjp(do_)
    want_out, want = fwd_vjp(*(jnp.asarray(a) for a in (q, k, v, do)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    lowrank_flash.LAUNCHES["lowrank_flash"] = 0
    out = tattn.attend(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    assert lowrank_flash.LAUNCHES["lowrank_flash"] == 0       # the plain passes here
    _close(out.detach(), want_out, 2e-5)
    for t, j in zip(got, want):
        assert t.shape == tuple(j.shape)
        _close(t, j, 2e-5)


def _train_cfgs(ref, mode, remat="none"):
    cfg = ref.get_config("drrl-paper", reduced=True).with_(remat=remat)  # rank mode 'drrl'
    if mode != "drrl":
        cfg = cfg.with_(rank=ref.RankConfig(mode=mode, rank_grid=(4, 8, 12, 16),
                                            fixed_rank=8))
    return cfg, ref.tp.torch_config(cfg)


@pytest.fixture(scope="module")
def train_setup(ref):
    """JAX and port params (the rank config does not enter init), the
    agent, w_t's start vectors and one 2 x 1040 batch."""
    cfg, _ = _train_cfgs(ref, "drrl")
    pj, pt = ref.tp.jax_and_torch_params(cfg)
    aj, at = ref.tp.jax_and_torch_agent(cfg)
    data = ref.SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=0)
    return dict(pj=pj, pt=pt, aj=aj, at=at, v0=ref.tp.jax_power_v0(cfg),
                batch_j=data.batch_at(0), batch_t=ref.tp.JaxBatches(data).batch_at(0))


def _port_chunked_loss(ref, s, mode, remat):
    """The port's ``loss_fn(p, b, rng)`` with ``loss(chunked=True)``."""
    _, tcfg = _train_cfgs(ref, mode, remat)
    ft = get_model(tcfg)
    kt = {"policy_params": s["at"], "power_v0": s["v0"]} if mode == "drrl" else {}

    def lt(p, b, rng):
        return ft.loss(p, b, chunked=True, **({"rank_rng": rng, **kt} if mode != "off" else {}))
    return lt


def _port_grads(ref, s, mode, remat):
    """The port's loss and gradients of step 0's chunked loss."""
    lt = _port_chunked_loss(ref, s, mode, remat)
    rng = prng.fold_in(prng.key(0), 0)
    loss, grads = value_and_grad(lambda p, b: lt(p, b, rng)[0], s["pt"], s["batch_t"])
    return loss, tu.leaves(grads)


CHUNKED_CASES = [("off", "none"), ("drrl", "none"), ("drrl", "full"), ("drrl", "dots")]


@pytest.mark.parametrize("mode,remat", CHUNKED_CASES,
                         ids=[m if r == "none" else f"{m}-remat_{r}" for m, r in CHUNKED_CASES])
def test_chunked_train_step_matches_jax(ref, train_setup, monkeypatch, mode, remat):
    """(c) One step of make_train_step with loss(chunked=True) on both
    sides: loss, grad norm, lr and every parameter after AdamW. Each layer
    calls LowrankFlash's forward once, or, checkpointed (``remat`` 'full'
    or 'dots' on both sides), twice: its recompute runs the forward again
    (the kernel is opaque to selective checkpointing). The checkpointed
    step's loss and gradients are the port's plain step's bitwise."""
    s = train_setup
    cfg, tcfg = _train_cfgs(ref, mode, remat)
    kj = {"policy_params": s["aj"]} if mode == "drrl" else {}
    fj = ref.get_model(cfg)

    def lj(p, b, rng):
        return fj.loss(p, b, chunked=True, **({"rank_rng": rng, **kj} if mode != "off" else {}))
    lt = _port_chunked_loss(ref, s, mode, remat)
    tc = dict(global_batch=BATCH, seq_len=SEQ, lr=LR, warmup_steps=1, total_steps=1)
    step_j = ref.jax.jit(ref.loop.make_train_step(cfg, ref.TrainConfig(**tc), lj))
    step_t = tloop.make_train_step(tcfg, TTrainConfig(**tc), lt)
    pj, _, mj = step_j(s["pj"], ref.adamw.init(s["pj"]), s["batch_j"],
                       ref.jax.random.fold_in(ref.jax.random.PRNGKey(0), 0))
    forwards = []
    plain = lowrank_flash.lowrank_flash_plain
    monkeypatch.setattr(lowrank_flash, "lowrank_flash_plain",
                        lambda *a, **k: forwards.append(None) or plain(*a, **k))
    lowrank_flash.LAUNCHES["lowrank_flash"] = 0
    pt, st, mt = step_t(s["pt"], tadamw.init(s["pt"]), s["batch_t"],
                        prng.fold_in(prng.key(0), 0))
    assert lowrank_flash.LAUNCHES["lowrank_flash"] == 0
    assert len(forwards) == tcfg.num_layers * (1 if remat == "none" else 2)
    assert int(st.step) == 1
    if remat != "none":
        (loss_r, g_r), (loss_n, g_n) = (_port_grads(ref, s, mode, r) for r in (remat, "none"))
        assert torch.equal(loss_r, loss_n)
        assert all(torch.equal(a, b) for a, b in zip(g_r, g_n))
    tol = TRAIN_TOL[mode]
    for name, rtol in (("loss", tol["loss"]), ("grad_norm", tol["grad_norm"]), ("lr", 1e-6)):
        np.testing.assert_allclose(float(mt[name]), float(mj[name]), rtol=rtol, err_msg=name)
    flat_j = ref.jax.tree_util.tree_flatten_with_path(pj)[0]
    flat_t = tu.leaves_with_path(pt)
    assert len(flat_j) == len(flat_t)
    for (path, j), (name, t) in zip(flat_j, flat_t):
        assert ref.jax.tree_util.keystr(path).replace("']['", "/")[2:-2] == name
        d = np.abs(t.numpy() - np.asarray(j))
        assert d.max() <= 2 * float(mj["lr"]), (name, d.max())
        assert np.quantile(d, 0.99) <= tol["p99"], (name, np.quantile(d, 0.99))


@pytest.mark.parametrize("sq", [1, 16])
def test_cpu_route_with_grad_is_lowrank_flash(sq):
    """(d) 1 or 16 queries that require grad: LowrankFlash's plain passes
    (gradients exactly the plain backward's of the plain forward), no
    launch; the same call without grad stays flash_decode's plain
    version, as before."""
    case = (2, 6, 2, sq, 1100, 16, 24, True, 1100 - sq)
    kw = dict(scale=0.25, causal=True, q_offset=1100 - sq)
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(case, 2))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ops.reset_launches()
    out = ops.flash_attention(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, do)
    assert all(torch.equal(a, b) for a, b in zip(got, _plain_grads(q, k, v, do, **kw)))
    assert torch.equal(out.detach(), lowrank_flash.lowrank_flash_plain(q, k, v, **kw))
    want = decode_attn.flash_decode_plain(q, k, v, torch.full((2,), 1100), scale=0.25,
                                          q_start=torch.full((2,), 1100 - sq))
    with torch.no_grad():
        assert torch.equal(ops.flash_attention(*leaves, **kw), want)
    assert torch.equal(ops.flash_attention(q, k, v, **kw), want)
    assert set(decode_attn.LAUNCHES.values()) | set(lowrank_flash.LAUNCHES.values()) == {0}


def test_cpu_recorded_call_checks_q_offset():
    """A recorded call refuses a negative q_offset, as the grad-free ones do."""
    q, k, v, _ = (torch.from_numpy(a) for a in _arrays((1, 2, 2, 20, 20, 8, 8), 3))
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(q.requires_grad_(True), k, v, scale=0.3, q_offset=-1)


def test_second_derivative_raises():
    """The backward is differentiated no further: create_graph=True and a
    second grad raise instead of dropping the second-order terms."""
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in _arrays((1, 2, 2, 20, 20, 8, 8), 4)[:3]]
    out = lowrank_flash.LowrankFlash.apply(*leaves, 0.3, True, 0)
    (dq,) = torch.autograd.grad(out.square().sum(), leaves[0], create_graph=True)
    with pytest.raises(RuntimeError, match="differentiate twice"):
        dq.sum().backward()


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: pytest -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False


# (e): b, hq, hkv, sq, skv, r, dv, causal, q_offset
CUDA_CASES = [(2, 4, 2, 300, 300, 64, 64, True, 0),
              (1, 7, 1, 130, 400, 32, 64, True, 270),
              (2, 2, 2, 77, 140, 20, 12, False, 0),
              (1, 4, 4, 150, 150, 192, 128, True, 0),
              (1, 28, 4, 4096, 4096, 128, 128, True, 0)]
CUDA_IDS = ["gqa2", "gqa7-offset", "odd-noncausal", "mla-192", "gqa7-4096-r128"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES, ids=CUDA_IDS)
def test_cuda_backward_matches_plain(case):
    """(e) Through ops.flash_attention with grad on the card: one forward
    and one backward launch, gradients within 2e-5 x their largest
    magnitude of the plain backward (f32 sums in another order)."""
    _cuda()
    kw = dict(scale=case[5] ** -0.5, causal=case[7], q_offset=case[8])
    q, k, v, do = (torch.from_numpy(a).cuda() for a in _arrays(case, 4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ops.reset_launches()
    got = torch.autograd.grad(ops.flash_attention(*leaves, **kw), leaves, do)
    torch.cuda.synchronize()
    assert lowrank_flash.LAUNCHES == {"lowrank_flash": 1, "lowrank_flash_bwd": 1}
    assert decode_attn.LAUNCHES == {"flash_decode": 0}
    for g, w in zip(got, _plain_grads(q, k, v, do, **kw)):
        _close(g.cpu(), w.cpu(), 2e-5)


@pytest.mark.cuda
def test_cuda_backward_is_deterministic():
    """(e) Two backward runs give the same bits (no atomics)."""
    _cuda()
    case = (2, 6, 2, 500, 500, 64, 64, True, 0)
    kw = dict(scale=0.125, causal=True, q_offset=0)
    q, k, v, do = (torch.from_numpy(a).cuda() for a in _arrays(case, 5))
    out, lse = lowrank_flash.lowrank_flash(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, lowrank_flash.lowrank_flash(q, k, v, **kw))
    a, b = (lowrank_flash.lowrank_flash_bwd(q, k, v, out, lse, do, **kw) for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# the bf16 backward kernel against its plain version on the same inputs (the
# kernel forward's out, the plain log-sum-exp): tests/test_torch_flash_bf16_grad.py
# fixes this tolerance, 2e-5 of each gradient's largest magnitude + two bf16
# steps of each element (both sides round their f32 gradient to bf16 once)
BF16_ATOL, BF16_RTOL = 2e-5, 2 ** -6


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES, ids=CUDA_IDS)
def test_cuda_bf16_backward_matches_plain(case):
    """(e) bf16 through ops.flash_attention with grad on the card: one
    forward and one backward launch (csrc/lowrank_flash_bwd_bf16.cu), bf16
    gradients within BF16_ATOL x their largest magnitude + BF16_RTOL of
    each element of the plain backward's."""
    _cuda()
    kw = dict(scale=case[5] ** -0.5, causal=case[7], q_offset=case[8])
    q, k, v, do = (torch.from_numpy(a).cuda().bfloat16() for a in _arrays(case, 6))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ops.reset_launches()
    out = ops.flash_attention(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert lowrank_flash.LAUNCHES == {"lowrank_flash": 1, "lowrank_flash_bwd": 1}
    assert decode_attn.LAUNCHES == {"flash_decode": 0}
    ro, lse = lowrank_flash.lowrank_flash_plain(q, k, v, return_lse=True, **kw)
    assert ((out.detach().float() - ro.float()).abs()
            <= 2e-5 + BF16_RTOL * ro.float().abs()).all()
    want = lowrank_flash.lowrank_flash_bwd_plain(q, k, v, out.detach(), lse, do, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.bfloat16
        g, w = g.float(), w.float()
        assert ((g - w).abs() <= BF16_ATOL * w.abs().max() + BF16_RTOL * w.abs()).all()


@pytest.mark.cuda
def test_cuda_bf16_backward_is_deterministic():
    """(e) Two bf16 backward runs give the same bits (no atomics); the bf16
    forward's out is the same with and without its log-sum-exp."""
    _cuda()
    case = (2, 6, 2, 500, 500, 64, 64, True, 0)
    kw = dict(scale=0.125, causal=True, q_offset=0)
    q, k, v, do = (torch.from_numpy(a).cuda().bfloat16() for a in _arrays(case, 7))
    out, lse = lowrank_flash.lowrank_flash(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, lowrank_flash.lowrank_flash(q, k, v, **kw))
    a, b = (lowrank_flash.lowrank_flash_bwd(q, k, v, out, lse, do, **kw) for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
