"""Zamba2 (Mamba2 blocks and the shared attention with per-invocation LoRA)
and RWKV6 on the port against the JAX package, reduced, on JAX's
``init(PRNGKey(0))`` parameters carried across by ``params_from_jax`` and
the same numpy tokens: zamba2's ``forward_zamba`` in rank modes 'off',
'adaptive' and 'drrl' (the agent of ``init_agent(PRNGKey(7))`` and JAX's
power-iteration start vectors: logits and ranks per invocation), its chunked
forward at s = 1040 (more than 1024 keys: JAX ``_attend_chunked`` against
the port's ``ops.flash_attention``, the plain ``lowrank_flash`` on the CPU)
in 'off' and 'adaptive'; rwkv6's ``forward_rwkv``; each family's ``loss``;
the cached decode (a 10-token prompt into an empty cache, then single
tokens) step by step against JAX's; and one ``make_train_step`` step of
each against the reference's jitted one (loss, gradient norm).

Tolerances: f32 logits 1e-4 absolute, losses 1e-5, ranks identical; the
train step's loss 1e-5 and gradient norm 1e-5 relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import RankConfig, TrainConfig  # noqa: E402
from repro.models import rwkv_lm as jrl  # noqa: E402
from repro.models import zamba2 as jz  # noqa: E402
from repro.models.api import get_model as jax_get_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch.configs.base import TrainConfig as TTrainConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.models import rwkv_lm as trl  # noqa: E402
from repro_torch.models import zamba2 as tz  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from torch_parity import jax_and_torch_agent, jax_power_v0, torch_config  # noqa: E402

GRID = (4, 8, 12, 16)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PARAMS = {}


def _model(arch, mode="off"):
    """(JAX config, the port's, JAX params, the port's): the parameters of
    an arch are drawn once (JAX ``init``, jitted), whatever the rank mode."""
    cfg = get_config(arch, reduced=True).with_(
        rank=RankConfig(mode=mode, rank_grid=GRID, segment_len=8))
    if arch not in _PARAMS:
        jp = jax.jit(jax_get_model(cfg).init)(jax.random.PRNGKey(0))
        _PARAMS[arch] = (jp, params_from_jax(jax.device_get(jp), device="cpu"))
    return (cfg, torch_config(cfg)) + _PARAMS[arch]


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


def _close(t, j, atol=1e-4):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("mode", ["off", "adaptive", "drrl"])
def test_zamba_forward_matches_jax(mode):
    cfg, tcfg, jp, tp = _model("zamba2-7b", mode)
    toks = _tokens(2, 24)
    kw_j, kw_t = {}, {}
    if mode == "drrl":
        ja, ta = jax_and_torch_agent(cfg)
        kw_j, kw_t = {"policy_params": ja}, {"policy_params": ta,
                                            "power_v0": jax_power_v0(cfg)}
    lg_j, aux_j = jax.jit(lambda p, t, kw: jz.forward_zamba(
        cfg, p, t, collect_aux="ranks", **kw))(jp, jnp.asarray(toks), kw_j)
    lg_t, aux_t = tz.forward_zamba(tcfg, tp, torch.from_numpy(toks), collect_aux="ranks",
                                   **kw_t)
    _close(lg_t, lg_j)
    if mode == "off":
        assert aux_t["ranks"] is None and aux_j["ranks"] is None
    else:
        assert aux_t["ranks"].shape == (2, 2, 4)          # (n_inv, b, hkv)
        np.testing.assert_array_equal(aux_t["ranks"].numpy(), np.asarray(aux_j["ranks"]))
        r = aux_t["ranks"]
        assert GRID[0] <= r.min().item() and r.max().item() <= GRID[-1]


@pytest.mark.parametrize("mode", ["off", "adaptive"])
def test_zamba_chunked_forward_at_1040_matches_jax(mode):
    cfg, tcfg, jp, tp = _model("zamba2-7b", mode)
    toks = _tokens(1, 1040, seed=1)
    lg_j, aux_j = jax.jit(lambda p, t: jz.forward_zamba(
        cfg, p, t, collect_aux="ranks", chunked=True))(jp, jnp.asarray(toks))
    lg_t, aux_t = tz.forward_zamba(tcfg, tp, torch.from_numpy(toks), collect_aux="ranks",
                                   chunked=True)
    _close(lg_t, lg_j)
    if mode != "off":
        np.testing.assert_array_equal(aux_t["ranks"].numpy(), np.asarray(aux_j["ranks"]))


def test_rwkv_forward_matches_jax():
    cfg, tcfg, jp, tp = _model("rwkv6-1.6b")
    toks = _tokens(2, 37, seed=2)
    lg_j, st_j = jax.jit(lambda p, t: jrl.forward_rwkv(cfg, p, t))(jp, jnp.asarray(toks))
    lg_t, st_t = trl.forward_rwkv(tcfg, tp, torch.from_numpy(toks))
    _close(lg_t, lg_j)
    for a, b in zip(st_t, st_j):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b)


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b"])
def test_loss_matches_jax(arch):
    cfg, tcfg, jp, tp = _model(arch, "adaptive" if arch == "zamba2-7b" else "off")
    toks = _tokens(2, 40, seed=3)
    mask = (np.arange(40)[None] < np.array([[40], [31]])).astype(np.float32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1), "mask": mask}
    l_j, _ = jax.jit(jax_get_model(cfg).loss)(jp, {k: jnp.asarray(v)
                                                   for k, v in batch.items()})
    l_t, aux = get_model(tcfg).loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert aux == {}
    np.testing.assert_allclose(l_t.item(), float(l_j), atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch,mode", [("zamba2-7b", "off"), ("zamba2-7b", "adaptive"),
                                       ("rwkv6-1.6b", "off")])
def test_cached_decode_matches_jax(arch, mode):
    """A 10-token prompt into an empty cache, then four single tokens, each
    step's logits against JAX's decode step, zamba2's cache (conv and SSM
    states, the shared attention's K/V) against JAX's after the last; in
    rank mode 'off' the decode's last logits also against the cache-free
    forward over the same 14 tokens (an 'adaptive' step decides its rank
    over the whole cache buffer, so it is no continuation of the forward,
    in either package)."""
    cfg, tcfg, jp, tp = _model(arch, mode)
    toks = _tokens(2, 14, seed=4)
    fj, ft = jax_get_model(cfg), get_model(tcfg)
    cache_j = fj.init_cache(2, 16)
    cache_t = ft.init_cache(2, 16, device="cpu")
    step_j = jax.jit(fj.decode_step)
    for a, b in ((0, 10), (10, 11), (11, 12), (12, 13), (13, 14)):
        d_j, cache_j = step_j(jp, cache_j, jnp.asarray(toks[:, a:b]))
        d_t, cache_t = ft.decode_step(tp, cache_t, torch.from_numpy(toks[:, a:b]))
        _close(d_t, d_j)
    if arch == "zamba2-7b":
        assert cache_t["len"] == 14 == int(cache_j["len"])
        for name in ("conv", "ssm", "k", "v"):
            _close(cache_t[name], cache_j[name])
    if mode == "off":
        fwd = tz.forward_zamba if arch == "zamba2-7b" else trl.forward_rwkv
        full, _ = fwd(tcfg, tp, torch.from_numpy(toks))
        _close(d_t[:, -1], full[:, -1].numpy())


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b"])
def test_one_train_step_matches_jax(arch):
    """``make_train_step`` (AdamW, lr 1e-3, as tests/test_archs_smoke.py's
    one step) on a 2 x 32 batch: loss and gradient norm against the
    reference's jitted step; every parameter moved and finite."""
    cfg, tcfg, jp, tp = _model(arch)
    kw = dict(global_batch=2, seq_len=32, total_steps=2, warmup_steps=1, lr=1e-3)
    fj, ft = jax_get_model(cfg), get_model(tcfg)
    step_j = jax.jit(jloop.make_train_step(cfg, TrainConfig(**kw),
                                           lambda p, b, r: fj.loss(p, b)))
    step_t = tloop.make_train_step(tcfg, TTrainConfig(**kw), lambda p, b, r: ft.loss(p, b))
    toks = _tokens(2, 32, seed=5)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    _, _, mj = step_j(jp, jadamw.init(jp), {k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.PRNGKey(0))
    pt, _, mt = step_t(tp, tadamw.init(tp), {k: torch.from_numpy(v)
                                             for k, v in batch.items()}, prng.key(0))
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]), rtol=1e-5)
    assert all(torch.isfinite(v).all() for v in jax.tree_util.tree_leaves(pt))
