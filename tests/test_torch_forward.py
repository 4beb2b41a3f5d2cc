"""The port's cache-free forward, its loss and the dense-cache decode step
against the JAX package on the same parameters (JAX ``init(PRNGKey(0))``
through ``params_from_jax``) and the same numpy tokens.

The forward runs at s = 1040 > 1024 keys with ``chunked=True``, so both
sides take their flash-semantics branch: JAX its XLA ``_attend_chunked``,
the port ``ops.flash_attention`` (the ``lowrank_flash`` kernel's plain
version on the CPU). Rank modes 'off', 'fixed', 'adaptive' and 'drrl' in
the 'masked' and 'static' realisations, and 'random', 'performer' and
'nystrom' (the paper's comparison set), on the reduced drrl-paper model and
on reduced qwen2.5-14b (GQA, qkv bias). In 'drrl' the agent is JAX
``init_agent(PRNGKey(7))`` through ``agent_from_jax``, and w_t's power
iterations start from JAX's own start vectors (``jax_power_v0``); the
paper's eps0 = 1 leaves only r_max legal at init, so eps0 = 1.5 is run too,
where the policy's argmax picks among several legal ranks.

Tolerances: logits 1e-4 absolute (two layers of f32 matmuls and softmax
chains, summed in different orders); ranks identical; fidelity 1e-5
absolute; the Eq. 9 bounds and the K spectra 1e-5 relative (f32 eigen-
values of Grams summed over 1040 rows, LAPACK through XLA vs through
torch); loss 1e-5; the agent's logits and values 1e-5 absolute, its
features 1e-6 + 1e-5 relative, delta_a_rel 1e-5 relative. Raw eigenvectors and static factors are never compared:
their signs are not portable.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import RankConfig  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.api import get_model as jax_get_model  # noqa: E402
from repro.core import baselines as jbaselines  # noqa: E402
from repro_torch.convert import proj_from_jax  # noqa: E402
from repro_torch.core import lowrank as tlr  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels import lowrank_flash  # noqa: E402
from repro_torch.kernels.ops import reset_launches  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from torch_parity import (jax_and_torch_agent, jax_and_torch_params,  # noqa: E402
                          jax_power_v0, torch_config)

S = 1040            # > the 1024-key chunk: the flash branch on both sides
SEED = 0
GRID = (4, 8, 12, 16)

# (arch, rank mode, realisation, truncate_values[, guardrail eps0])
CASES = [
    ("drrl-paper", "off", "masked", False),
    ("drrl-paper", "fixed", "masked", False),
    ("drrl-paper", "fixed", "static", False),
    ("drrl-paper", "adaptive", "masked", False),
    ("drrl-paper", "adaptive", "static", False),
    ("drrl-paper", "adaptive", "masked", True),
    ("qwen2.5-14b", "adaptive", "masked", False),
    ("qwen2.5-14b", "fixed", "static", False),
    ("drrl-paper", "drrl", "masked", False),
    ("drrl-paper", "drrl", "masked", False, 1.5),
    ("qwen2.5-14b", "drrl", "masked", False, 1.5),
]
IDS = ["%s-%s-%s%s%s" % (c[0], c[1], c[2], "-truncv" if c[3] else "",
                         "-eps%g" % c[4] if len(c) > 4 else "") for c in CASES]


def _cfg(arch, mode, realisation="masked", truncate=False, eps0=1.0):
    return get_config(arch, reduced=True).with_(rank=RankConfig(
        mode=mode, realisation=realisation, rank_grid=GRID, fixed_rank=8,
        static_rank=8, truncate_values=truncate, segment_len=8,
        epsilon0=eps0))


_MODELS = {}


def _model(arch, mode, realisation, truncate, eps0=1.0):
    """(jax cfg, torch cfg, jax params, torch params), built once per key."""
    key = (arch, mode, realisation, truncate, eps0)
    if key not in _MODELS:
        cfg = _cfg(*key)
        _MODELS[key] = (cfg, torch_config(cfg)) + jax_and_torch_params(cfg)
    return _MODELS[key]


def _agent_kw(cfg):
    """(JAX kwargs, port kwargs) that hand the agent to a rank-mode 'drrl'
    call ({} for the other modes)."""
    if cfg.rank.mode != "drrl":
        return {}, {}
    ja, ta = jax_and_torch_agent(cfg)
    return {"policy_params": ja}, {"policy_params": ta,
                                   "power_v0": jax_power_v0(cfg)}


def _drrl_margins(aux_j, eps0):
    """Smallest top-two gap of the legal logits and smallest margin of the
    Eq. 11 mask (eps_t = eps0 at rl_t = 0): how near a tie the ranks are."""
    lg = np.sort(np.asarray(aux_j["logits"]), axis=-1)
    legal = lg[..., -2] > -1e29
    gap = (lg[..., -1] - lg[..., -2])[legal].min() if legal.any() else np.inf
    margin = np.abs(np.asarray(aux_j["features"]["bounds"]) - eps0).min()
    return gap, margin


def _tokens(b, s, seed=SEED):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


def _close(t, j, atol, rtol=0.0):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_dense_chunked_matches_jax(case):
    cfg, tcfg, jparams, tparams = _model(*case)
    jkw, tkw = _agent_kw(cfg)
    toks = _tokens(2, S)
    fwd = jax.jit(lambda p, t, kw: jtr.forward_dense(
        cfg, p, t, chunked=True, collect_aux="rl", compute_fidelity=True, **kw))
    logits_j, aux_j = fwd(jparams, jnp.asarray(toks), jkw)
    reset_launches()
    logits_t, aux_t = ttr.forward_dense(tcfg, tparams, torch.from_numpy(toks),
                                        chunked=True, collect_aux="rl",
                                        compute_fidelity=True, **tkw)
    assert lowrank_flash.LAUNCHES["lowrank_flash"] == 0   # CPU: plain version
    assert logits_t.shape == (2, S, cfg.vocab_size)
    _close(logits_t, logits_j, 1e-4)
    lj, lt = aux_j["layers"], aux_t["layers"]
    assert sorted(lt) == sorted(lj)
    if case[1] == "off":
        return
    if case[1] == "drrl":
        gap, margin = _drrl_margins(lj, cfg.rank.epsilon0)
        print(f"smallest top-two logit gap {gap:.3g}, smallest mask margin "
              f"{margin:.3g}, ranks {sorted(set(np.asarray(lj['rank']).ravel()))}")
        assert gap > 1e-5 and margin > 1e-5
        for name in ("action_idx", "action_mask"):
            np.testing.assert_array_equal(lt[name].numpy(), np.asarray(lj[name]))
        _close(lt["logits"], lj["logits"], 1e-5)
        _close(lt["value"], lj["value"], 1e-5)
        _close(lt["delta_a_rel"], lj["delta_a_rel"], 0.0, 1e-5)
        for name, f in lt["features"].items():
            _close(f, lj["features"][name], 1e-6, 1e-5)
    else:
        # no head may sit within 1e-6 of the energy threshold, or an honest
        # eigen-solver difference could flip its rank (SEED chosen so none
        # does)
        ner = tlr.ner_curve(lt["k_s2"])
        assert (ner - cfg.rank.energy_threshold).abs().min() > 1e-6
    np.testing.assert_array_equal(lt["rank"].numpy(), np.asarray(lj["rank"]))
    _close(lt["fidelity"], lj["fidelity"], 1e-5)
    _close(lt["delta_a_grid"], lj["delta_a_grid"], 0.0, 1e-5)
    _close(lt["delta_a_norm"], lj["delta_a_norm"], 0.0, 1e-5)
    _close(lt["k_s2"], lj["k_s2"], 1e-3, 1e-5)


@pytest.mark.parametrize("mode", ["off", "fixed", "adaptive", "drrl"])
@pytest.mark.parametrize("realisation", ["masked", "static"])
def test_loss_matches_jax(mode, realisation):
    """``ModelFns.loss`` (the scoring entry point) with the chunked forward,
    rank aux and fidelity; a mask on the second half of the labels."""
    cfg, tcfg, jparams, tparams = _model("drrl-paper", mode, realisation, False)
    jkw, tkw = _agent_kw(cfg)
    toks = _tokens(2, S + 1, seed=SEED + 1)
    mask = np.zeros((2, S), np.float32)
    mask[:, S // 2:] = 1.0
    kw = dict(chunked=True, collect_aux="ranks", compute_fidelity=True)
    loss_j, aux_j = jax.jit(lambda p, bt, a: jax_get_model(cfg).loss(
        p, bt, **kw, **a))(
        jparams, {"tokens": jnp.asarray(toks[:, :-1]),
                  "labels": jnp.asarray(toks[:, 1:]), "mask": jnp.asarray(mask)},
        jkw)
    loss_t, aux_t = get_model(tcfg).loss(
        tparams, {"tokens": torch.from_numpy(toks[:, :-1]),
                  "labels": torch.from_numpy(toks[:, 1:]),
                  "mask": torch.from_numpy(mask)}, **kw, **tkw)
    assert abs(float(loss_t) - float(loss_j)) < 1e-5
    assert sorted(aux_t["layers"]) == sorted(aux_j["layers"])
    if mode != "off":
        np.testing.assert_array_equal(aux_t["layers"]["rank"].numpy(),
                                      np.asarray(aux_j["layers"]["rank"]))
        _close(aux_t["layers"]["fidelity"], aux_j["layers"]["fidelity"], 1e-5)
    if mode == "drrl":
        _close(aux_t["layers"]["delta_a_rel"], aux_j["layers"]["delta_a_rel"],
               0.0, 1e-5)


@pytest.mark.parametrize("mode", ["off", "fixed", "adaptive"])
def test_unchunked_forward_collects_qkv_and_mass(mode):
    """The one-shot prefill's forward: full probabilities, qkv capture and
    the padded-bucket mass (queries past ``mass_q_len`` excluded)."""
    cfg, tcfg, jparams, tparams = _model("qwen2.5-14b", mode, "masked", False)
    toks = _tokens(1, 24, seed=3)
    kw = dict(collect_aux="rl", collect_qkv=True, collect_mass=True)
    lj, aj = jtr.forward_dense(cfg, jparams, jnp.asarray(toks), mass_q_len=19, **kw)
    lt, at = ttr.forward_dense(tcfg, tparams, torch.from_numpy(toks), mass_q_len=19, **kw)
    _close(lt, lj, 1e-4)
    for name in ("q", "k", "v"):
        _close(at["layers"]["qkv"][name], aj["layers"]["qkv"][name], 1e-5)
    _close(at["layers"]["mass"], aj["layers"]["mass"], 1e-5)


def _decode_parity(mode, max_len, chunked, n_steps):
    """Token by token through the dense cache: a 6-token prompt, then
    ``n_steps`` single-token steps, logits compared at every step."""
    cfg, tcfg, jparams, tparams = _model("drrl-paper", mode, "masked", False)
    jkw, tkw = _agent_kw(cfg)
    toks = _tokens(2, 6 + n_steps, seed=4)
    jcache = jax_get_model(cfg).init_cache(2, max_len)
    fns = get_model(tcfg)
    tcache = fns.init_cache(2, max_len, device="cpu")
    jstep = jax.jit(lambda p, c, t, a: jtr.decode_step_dense(
        cfg, p, c, t, chunked=chunked, **a))
    for lo, hi in [(0, 6)] + [(i, i + 1) for i in range(6, 6 + n_steps)]:
        lj, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, lo:hi]), jkw)
        lt, tcache = fns.decode_step(tparams, tcache,
                                     torch.from_numpy(toks[:, lo:hi]),
                                     chunked=chunked, **tkw)
        assert tcache["len"] == int(jcache["len"]) == hi
        _close(lt, lj, 1e-4)
    _close(tcache["k"], jcache["k"], 1e-5)


@pytest.mark.parametrize("mode", ["off", "fixed", "adaptive", "drrl"])
def test_decode_step_dense_matches_jax(mode):
    _decode_parity(mode, max_len=32, chunked=False, n_steps=5)


@pytest.mark.parametrize("mode", ["off", "adaptive"])
def test_decode_step_dense_chunked_matches_jax(mode, monkeypatch):
    """A cache of S > 1024 positions with ``chunked``: every attention of
    every step takes the flash branch on the cache's valid prefix (JAX
    ``_attend_chunked``, the port ``ops.flash_attention``)."""
    calls = []

    def counted(*a, **kw):
        calls.append(kw["q_offset"])
        return lowrank_flash.lowrank_flash_plain(*a, **kw)
    monkeypatch.setattr(tattn.ops, "flash_attention", counted)
    _decode_parity(mode, max_len=S, chunked=True, n_steps=3)
    assert calls == [off for off in (0, 6, 7, 8) for _ in range(2)]


def test_attend_chunked_with_cache_matches_jax():
    """The cache form of the flash branch (``kv_len`` given): the port's
    ``ops.flash_attention`` on the valid prefix with ``q_offset`` against
    JAX's ``_attend_chunked``, GQA."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 40, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 40, 2, 8)).astype(np.float32)
    want = jattn.attend(jnp.asarray(q), jnp.asarray(np.repeat(k, 2, axis=2)),
                        jnp.asarray(np.repeat(v, 2, axis=2)), scale=0.3,
                        causal=True, q_offset=25, kv_len=28, chunked=True,
                        chunk=16)
    got = tattn.attend(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), scale=0.3, causal=True,
                       q_offset=25, kv_len=28, chunked=True, chunk=16)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("fn", ["gram", "singular_values", "project_masked",
                                "project_static", "mixing_matrix"])
def test_lowrank_helpers_match_jax(fn):
    """Shapes and values of the spectral helpers; bases come from one JAX
    eigh on both sides, so even the sign-dependent outputs are comparable."""
    from repro.core import lowrank as jlr
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 30, 8)).astype(np.float32)
    _, e = jlr.gram_spectrum(jlr.gram(jnp.asarray(x)))
    e = np.array(e)
    mask = (np.arange(8) < np.array([[3], [5]])[:, :, None]).astype(np.float32)
    mask = np.broadcast_to(mask, (2, 3, 8)).copy()
    args_j = {"gram": (x,), "singular_values": (x,),
              "project_masked": (x, e, mask), "project_static": (x, e, 5),
              "mixing_matrix": (e, e[:, ::-1].copy(), 5)}[fn]
    want = getattr(jlr, fn)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                              for a in args_j))
    got = getattr(tlr, fn)(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                             for a in args_j))
    _close(got, want, 1e-4, 1e-5)


def _comparison_kw(cfg, mode):
    """(JAX kwargs, port kwargs) of rank modes 'random' (the same key on
    both sides) and 'performer' (JAX's own ``orthogonal_proj`` at
    ``PRNGKey(42)`` carried across)."""
    if mode == "random":
        return {"rank_rng": jax.random.PRNGKey(3)}, {"rank_rng": prng.key(3)}
    if mode == "performer":
        dh = cfg.resolved_head_dim()
        proj = jbaselines.orthogonal_proj(
            jax.random.PRNGKey(42), cfg.num_heads,
            max(2 * dh, 4 * cfg.rank.fixed_rank), dh)
        return {}, {"proj": proj_from_jax(jax.device_get(proj), device="cpu")}
    return {}, {}


@pytest.mark.parametrize("mode", ["random", "performer", "nystrom"])
def test_comparison_modes_match_jax(mode):
    """The forward in rank modes 'random' (masked, with fidelity: ranks
    from the same ``rank_rng``, split once per layer on both sides) and
    the static baselines 'performer' / 'nystrom' (fixed rank 8: 8
    landmarks, max(2 dh, 4 * 8) = 32 features) at s = 1040 with
    ``chunked``: logits 1e-4 absolute; 'random' ranks identical and
    fidelity 1e-5."""
    cfg, tcfg, jparams, tparams = _model("drrl-paper", mode, "masked", False)
    jkw, tkw = _comparison_kw(cfg, mode)
    toks = _tokens(2, S)
    fid = mode == "random"
    logits_j, aux_j = jtr.forward_dense(cfg, jparams, jnp.asarray(toks),
                                        chunked=True, collect_aux="rl",
                                        compute_fidelity=fid, **jkw)
    logits_t, aux_t = ttr.forward_dense(tcfg, tparams, torch.from_numpy(toks),
                                        chunked=True, collect_aux="rl",
                                        compute_fidelity=fid, **tkw)
    _close(logits_t, logits_j, 1e-4)
    lj, lt = aux_j["layers"], aux_t["layers"]
    assert sorted(lt) == sorted(lj)
    if fid:
        np.testing.assert_array_equal(lt["rank"].numpy(), np.asarray(lj["rank"]))
        assert len(set(np.asarray(lj["rank"]).ravel())) >= 3
        _close(lt["fidelity"], lj["fidelity"], 1e-5)
        _close(lt["delta_a_grid"], lj["delta_a_grid"], 0.0, 1e-5)


@pytest.mark.parametrize("mode", ["random", "performer", "nystrom"])
def test_comparison_modes_decode_matches_jax(mode):
    """``decode_step_dense`` in the same modes (the reference's decode
    step gives every layer the unsplit ``rank_rng``, and runs the
    baselines' non-causal form over the whole cache buffer): logits at
    every step 1e-4."""
    cfg, tcfg, jparams, tparams = _model("drrl-paper", mode, "masked", False)
    jkw, tkw = _comparison_kw(cfg, mode)
    toks = _tokens(2, 10, seed=4)
    jcache = jax_get_model(cfg).init_cache(2, 32)
    fns = get_model(tcfg)
    tcache = fns.init_cache(2, 32, device="cpu")
    for lo, hi in [(0, 6)] + [(i, i + 1) for i in range(6, 10)]:
        lj, jcache = jtr.decode_step_dense(cfg, jparams, jcache,
                                           jnp.asarray(toks[:, lo:hi]), **jkw)
        lt, tcache = fns.decode_step(tparams, tcache, torch.from_numpy(toks[:, lo:hi]),
                                     **tkw)
        _close(lt, lj, 1e-4)


@pytest.mark.parametrize("entry", ["forward_dense", "decode_step_dense"])
def test_drrl_without_policy_params_raises(entry):
    """As the reference, rank mode 'drrl' with no agent is an error, not a
    quiet fallback to another rank rule."""
    _, tcfg, _, tparams = _model("drrl-paper", "drrl", "masked", False)
    toks = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="policy params"):
        if entry == "forward_dense":
            ttr.forward_dense(tcfg, tparams, toks)
        else:
            ttr.decode_step_dense(tcfg, tparams, get_model(tcfg).init_cache(
                1, 16, device="cpu"), toks)
