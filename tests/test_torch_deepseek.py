"""The port's MLA and DeepSeek-V3 (``repro_torch.models.mla``,
``deepseek_v3``) against the JAX package's on the same parameters (JAX
``init(PRNGKey(0))`` of the reduced deepseek-v3-671b through
``params_from_jax``) and the same numpy tokens: ``mla_train`` in rank modes
'off', 'adaptive' and 'fixed' (masked: the 24-wide q.k Grams' projectors,
never their bases), the absorbed ``mla_decode`` on a filled latent cache,
``forward_deepseek`` with the MTP logits and the auxiliary loss,
``loss_deepseek`` (with ``mtp_weight``) and its gradients (with
DeepSeek-V3's ``remat="full"`` too), ``decode_step_deepseek`` against
JAX's and teacher-forced against the port's own forward, and the chunked
branch at s = 1040 > 1024 keys (JAX ``_attend_chunked``; the port
``ops.flash_attention``, the ``lowrank_flash`` kernel's plain version at
r = qk_nope + qk_rope = 24).

The JAX side is jitted (eager JAX spends most of a first call
dispatching). Tolerances: outputs and logits 1e-5 absolute at s <= 40 and 1e-4 at
s = 1040 (f32 summed in other orders over longer rows); losses 1e-5;
gradients 1e-5 of each leaf's largest magnitude (1.5e-6 measured); ranks
identical; the K spectra 1e-5 of each Gram's largest eigenvalue; the
decode step teacher-forced against the forward 1e-5 (the
reduced config's capacity factor 2 never drops a pair, so both route the
same).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import RankConfig  # noqa: E402
from repro.models import deepseek_v3 as jds  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models.api import get_model as jax_get_model  # noqa: E402
from repro_torch.kernels import lowrank_flash  # noqa: E402
from repro_torch.kernels.ops import reset_launches  # noqa: E402
from repro_torch.models import deepseek_v3 as tds  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.train.rl import value_and_grad  # noqa: E402
from torch_parity import torch_config  # noqa: E402

GRID = (4, 8, 12, 16)
GRAD_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mode="off"):
    return get_config("deepseek-v3-671b", reduced=True).with_(
        rank=RankConfig(mode=mode, rank_grid=GRID, fixed_rank=8))


@pytest.fixture(scope="module")
def model():
    """JAX ``init(PRNGKey(0))``, jitted (the same values as eager, in half
    the time), and the same values as the port's CPU tensors."""
    cfg = _cfg()
    jp = jax.device_get(jax.jit(jax_get_model(cfg).init)(jax.random.PRNGKey(0)))
    return cfg, jp, params_from_jax(jp, device="cpu")


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


def _ce(logits, labels):
    """Per-token cross-entropy of JAX logits, in numpy (f64)."""
    lg = np.asarray(logits, np.float64)
    m = lg.max(-1, keepdims=True)
    logz = (m + np.log(np.exp(lg - m).sum(-1, keepdims=True)))[..., 0]
    return logz - np.take_along_axis(lg, labels[..., None], -1)[..., 0]


def _close(t, j, atol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("mode", ["off", "adaptive", "fixed"])
def test_mla_train_matches_jax(model, mode):
    cfg, jp, tp = model
    cfg = cfg.with_(rank=RankConfig(mode=mode, rank_grid=GRID, fixed_rank=8))
    tcfg = torch_config(cfg)
    lp_j = jp["dense_layers"][0]["attn"]
    lp_t = tp["dense_layers"][0]["attn"]
    x = np.random.default_rng(1).standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40), (2, 40))
    ctx = None if mode == "off" else {"cfg": cfg.rank}
    out_j, aux_j = jmla.mla_train(cfg, lp_j, jnp.asarray(x), jnp.asarray(pos), rank_ctx=ctx)
    ctx_t = None if mode == "off" else {"cfg": tcfg.rank}
    out_t, aux_t = tmla.mla_train(tcfg, lp_t, torch.from_numpy(x),
                                  torch.from_numpy(pos.copy()), rank_ctx=ctx_t)
    _close(out_t, out_j, 1e-5)
    if mode != "off":
        np.testing.assert_array_equal(aux_t["rank"].numpy(), np.asarray(aux_j["rank"]))
        # eigenvalues to 1e-5 of each Gram's largest (the eigensolvers'
        # error scale is f32's epsilon times the Gram's norm)
        k_s2 = np.asarray(aux_j["k_s2"])
        np.testing.assert_allclose(aux_t["k_s2"].numpy(), k_s2, rtol=0,
                                   atol=1e-5 * k_s2.max())


def test_mla_decode_matches_jax(model):
    """A 12-token prefill into the latent cache, then one token, absorbed,
    on both sides (the port writes its cache in place)."""
    cfg, jp, tp = model
    tcfg = torch_config(cfg)
    lp_j, lp_t = jp["moe_layers"], tp["moe_layers"]
    lp_j = jax.tree_util.tree_map(lambda a: a[1], lp_j)["attn"]
    lp_t = {k: v[1] for k, v in lp_t["attn"].items()}
    rng = np.random.default_rng(2)
    cache_j = {k: v[0] if k != "len" else v
               for k, v in jmla.init_mla_cache(cfg, 2, 16, 1, jnp.float32).items()}
    cache_t = {k: v[0] if k != "len" else v
               for k, v in tmla.init_mla_cache(tcfg, 2, 16, 1, torch.float32,
                                               device="cpu").items()}
    for s in (12, 1):
        x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
        start = int(cache_t["len"])
        pos = np.broadcast_to(start + np.arange(s), (2, s)).copy()
        out_j, cache_j = jmla.mla_decode(cfg, lp_j, jnp.asarray(x), jnp.asarray(pos), cache_j)
        out_t, cache_t = tmla.mla_decode(tcfg, lp_t, torch.from_numpy(x),
                                         torch.from_numpy(pos), cache_t)
        _close(out_t, out_j, 1e-5)
        _close(cache_t["ckv"], cache_j["ckv"], 1e-5)
        _close(cache_t["krope"], cache_j["krope"], 1e-5)
        assert cache_t["len"] == int(cache_j["len"])


@pytest.mark.parametrize("mode", ["off", "adaptive"])
def test_forward_and_loss_match_jax(model, mode):
    cfg, jp, tp = model
    cfg = cfg.with_(rank=RankConfig(mode=mode, rank_grid=GRID))
    tcfg = torch_config(cfg)
    toks = _tokens(2, 40)
    ctx_j = None if mode == "off" else {"cfg": cfg.rank}
    ctx_t = None if mode == "off" else {"cfg": tcfg.rank}
    lg_j, aux_j = jax.jit(lambda p, t: jds.forward_deepseek(cfg, p, t, rank_ctx0=ctx_j))(
        jp, jnp.asarray(toks))
    lg_t, aux_t = tds.forward_deepseek(tcfg, tp, torch.from_numpy(toks), rank_ctx0=ctx_t)
    _close(lg_t, lg_j, 1e-5)
    assert aux_t["mtp_logits"].shape == (2, 39, cfg.vocab_size)
    _close(aux_t["mtp_logits"], aux_j["mtp_logits"], 1e-5)
    np.testing.assert_allclose(aux_t["aux_loss"].item(), float(aux_j["aux_loss"]), atol=1e-6)
    labels = np.roll(toks, -1, axis=1)
    mask = (np.arange(40) < 36)[None].repeat(2, 0).astype(np.float32)
    batch_j = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
               "mask": jnp.asarray(mask)}
    batch_t = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels),
               "mask": torch.from_numpy(mask)}
    loss_j, _ = jax.jit(lambda p, b: jax_get_model(cfg).loss(p, b, rank_ctx0=ctx_j,
                                                             mtp_weight=0.7))(jp, batch_j)
    loss_t, _ = get_model(tcfg).loss(tp, batch_t, rank_ctx0=ctx_t, mtp_weight=0.7)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), atol=1e-5)
    # the default MTP weight, 0.3, on the port: the same terms reweighted
    loss_d, _ = get_model(tcfg).loss(tp, batch_t, rank_ctx0=ctx_t)
    mtp_ce = (loss_t.item() - loss_d.item()) / 0.4
    np.testing.assert_allclose(mtp_ce, float(np.mean(_ce(aux_j["mtp_logits"], labels[:, 1:]))),
                               atol=1e-4)


def test_decode_step_matches_jax_and_forward(model):
    """``decode_step_deepseek``: a 10-token prompt, then 3 single tokens, on
    both sides; and the port's steps teacher-forced against its own
    forward over the 13 tokens."""
    cfg, jp, tp = model
    tcfg = torch_config(cfg)
    toks = _tokens(2, 13, seed=3)
    cache_j = jax_get_model(cfg).init_cache(2, 16)
    cache_t = get_model(tcfg).init_cache(2, 16, device="cpu")
    step_j = jax.jit(jax_get_model(cfg).decode_step)
    steps_t = []
    for a, b in ((0, 10), (10, 11), (11, 12), (12, 13)):
        lg_j, cache_j = step_j(jp, cache_j, jnp.asarray(toks[:, a:b]))
        lg_t, cache_t = get_model(tcfg).decode_step(tp, cache_t,
                                                    torch.from_numpy(toks[:, a:b]))
        _close(lg_t, lg_j, 1e-5)
        steps_t.append(lg_t)
    assert cache_t["len"] == 13 == int(cache_j["len"])
    full, _ = tds.forward_deepseek(tcfg, tp, torch.from_numpy(toks))
    fwd = full[:, :13]
    # the forward's MTP block is not on the decode path; its main logits are
    _close(torch.cat(steps_t, dim=1), fwd.numpy(), 1e-5)


@pytest.mark.parametrize("mode", ["off", "adaptive"])
def test_chunked_forward_at_1040_matches_jax(model, mode):
    """s = 1040 > 1024 keys: JAX ``_attend_chunked`` against the port's
    ``ops.flash_attention`` (the plain ``lowrank_flash`` at r = 24, dv =
    16); one flash call per attention block, MTP's included, and no
    launch of the CUDA kernel on the CPU."""
    cfg, jp, tp = model
    cfg = cfg.with_(rank=RankConfig(mode=mode, rank_grid=GRID))
    tcfg = torch_config(cfg)
    toks = _tokens(1, 1040, seed=4)
    ctx_j = None if mode == "off" else {"cfg": cfg.rank}
    ctx_t = None if mode == "off" else {"cfg": tcfg.rank}
    lg_j, aux_j = jax.jit(lambda p, t: jds.forward_deepseek(cfg, p, t, rank_ctx0=ctx_j,
                                                            chunked=True))(jp, jnp.asarray(toks))
    calls = []
    real = lowrank_flash.lowrank_flash_plain

    def counted(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(v.shape)))
        return real(q, k, v, **kw)
    lowrank_flash.lowrank_flash_plain = counted
    reset_launches()
    try:
        lg_t, aux_t = tds.forward_deepseek(tcfg, tp, torch.from_numpy(toks),
                                           rank_ctx0=ctx_t, chunked=True)
    finally:
        lowrank_flash.lowrank_flash_plain = real
    assert lowrank_flash.LAUNCHES["lowrank_flash"] == 0
    assert len(calls) == cfg.num_layers + 1
    assert calls[0] == ((1, 4, 1040, 24), (1, 4, 1040, 16))
    _close(lg_t, lg_j, 1e-4)
    _close(aux_t["mtp_logits"], aux_j["mtp_logits"], 1e-4)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_grads_match_jax(model, remat):
    """The gradients of ``loss_deepseek`` (MTP and auxiliary loss
    included) on both sides, each with ``remat``: DeepSeek-V3's own 'full'
    checkpoints every MoE layer (JAX's jax.checkpoint, the port's
    remat_layer), the dense layers and the MTP block not. Loss 1e-5, each
    gradient leaf within GRAD_TOL of its largest magnitude; the port's
    checkpointed gradients are its plain ones bitwise."""
    cfg, jp, tp = model
    cfg = cfg.with_(remat=remat)
    tcfg = torch_config(cfg)
    toks = _tokens(2, 40, seed=5)
    labels = np.roll(toks, -1, axis=1)
    batch_j = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    batch_t = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    loss_j, g_j = jax.jit(jax.value_and_grad(
        lambda p, b: jax_get_model(cfg).loss(p, b)[0]))(jp, batch_j)
    grads = {}
    for r in {"none", remat}:
        fns = get_model(tcfg.with_(remat=r))
        grads[r] = value_and_grad(lambda p, b: fns.loss(p, b)[0], tp, batch_t)
    loss_t, g_t = grads[remat]
    np.testing.assert_allclose(loss_t.item(), float(loss_j), atol=1e-5)
    flat_j = jax.tree_util.tree_flatten_with_path(g_j)[0]
    flat_t = tu.leaves_with_path(g_t)
    assert len(flat_j) == len(flat_t)
    for (path, j), (name, t) in zip(flat_j, flat_t):
        j = np.asarray(j)
        err = np.abs(t.numpy() - j).max()
        assert err <= GRAD_TOL * max(np.abs(j).max(), 1e-30), (name, err, np.abs(j).max())
    assert torch.equal(loss_t, grads["none"][0])
    assert all(torch.equal(a, b) for a, b in zip(tu.leaves(g_t), tu.leaves(grads["none"][1])))
