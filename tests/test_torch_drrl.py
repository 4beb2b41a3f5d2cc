"""The port's DR-RL agent (``repro_torch.core.drrl``, ``core.policy``) and
the rest of its spectral machinery (Eq. 3-5 bounds, Eq. 11 safety mask,
subspace / power iteration) against the JAX package on the same inputs:
numpy draws from a seed, and the agent of JAX ``init_agent(PRNGKey(7))``
carried across by ``convert.agent_from_jax``.

The iterations start from random draws; the JAX start draw (its fixed
``PRNGKey``) is drawn here and passed into the port. Eigenvector signs are
not portable, so subspace results are held on eigenvalues and projectors
B B^T. Greedy ranks are held exactly; where they come from an argmax the
test also prints the smallest top-two logit gap and the smallest margin of
the Eq. 11 mask, so a near-tie shows as itself. Sampled actions are held
on distribution.

Tolerances (f32 on both sides, summed in different orders): elementwise
bounds and masks 1e-6 relative; power iteration 1e-5 relative; subspace
eigenvalues 1e-4 of the top one and projectors 1e-4; policy logits and
values 1e-6 absolute (logits are O(0.01) at init); features 1e-5 relative
(spectra through eigh on both sides feed them).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import drrl as jdrrl  # noqa: E402
from repro.core import lowrank as jlr  # noqa: E402
from repro.core import perturbation as jpert  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro_torch.convert import agent_from_jax  # noqa: E402
from repro_torch.core import drrl as tdrrl  # noqa: E402
from repro_torch.core import lowrank as tlr  # noqa: E402
from repro_torch.core import perturbation as tpert  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from torch_parity import jax_and_torch_params, jax_power_v0, torch_config  # noqa: E402

RNG_SEED = 0
CFG = get_config("drrl-paper", reduced=True)          # grid (4, 8, 12, 16)
JAGENT = jdrrl.init_agent(jax.random.PRNGKey(7), CFG.rank, CFG.d_model)
TAGENT = agent_from_jax(jax.device_get(JAGENT), device="cpu")


def _rng(k=0):
    return np.random.default_rng(RNG_SEED + k)


def _close(t, j, atol, rtol=0.0):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=rtol)


def _spectra(rng, *shape, decay=0.8):
    """Descending squared singular values (..., d) with a decaying profile."""
    d = shape[-1]
    s2 = np.abs(rng.standard_normal(shape)) * decay ** np.arange(d)
    return np.sort(s2, axis=-1)[..., ::-1].astype(np.float32).copy()


def _jax_normal(key, shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(key), shape,
                                        jnp.float32))


# -- perturbation ------------------------------------------------------------

@pytest.mark.parametrize("r", [0, 5, 16])
def test_eckart_young_and_transition_norms_match_jax(r):
    s2 = _spectra(_rng(1), 3, 4, 16)
    _close(tpert.eckart_young_tail(torch.from_numpy(s2), r),
           jpert.eckart_young_tail(jnp.asarray(s2), r), 0.0, 1e-6)
    for r_new in (0, 3, 9, 16):
        _close(tpert.rank_transition_norm(torch.from_numpy(s2), r, r_new),
               jpert.rank_transition_norm(jnp.asarray(s2), r, r_new), 0.0, 1e-6)


def test_output_sensitivity_matches_jax():
    rng = _rng(2)
    s2 = _spectra(rng, 3, 4, 16)
    v_fro = np.abs(rng.standard_normal((3, 4))).astype(np.float32)
    per_head = rng.integers(0, 17, (3, 4))
    for r in (0, 7, 15, 16, per_head):
        r_t = torch.from_numpy(r) if isinstance(r, np.ndarray) else r
        r_j = jnp.asarray(r) if isinstance(r, np.ndarray) else r
        _close(tpert.output_sensitivity(torch.from_numpy(s2), r_t,
                                        torch.from_numpy(v_fro)),
               jpert.output_sensitivity(jnp.asarray(s2), r_j,
                                        jnp.asarray(v_fro)), 0.0, 1e-6)


@pytest.mark.parametrize("normalised", [False, True])
def test_safety_mask_matches_jax(normalised):
    rng = _rng(3)
    bounds = np.abs(rng.standard_normal((5, 4, 7))).astype(np.float32) * 2
    norm = (np.abs(rng.standard_normal((5, 4))).astype(np.float32) + 0.5
            if normalised else None)
    for t in (0, 300, 5000):
        eps_t = 0.9 * np.exp(-1e-3 * t)
        got = tpert.safety_mask(torch.from_numpy(bounds), eps_t,
                                None if norm is None else torch.from_numpy(norm))
        want = jpert.safety_mask(jnp.asarray(bounds), eps_t,
                                 None if norm is None else jnp.asarray(norm))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got[..., -1].all() and not got.all()


# -- subspace / power iteration -------------------------------------------------

@pytest.mark.parametrize("iters", [1, 3, 20])
def test_power_iteration_specnorm_matches_jax(iters):
    # columns scaled down the line: a clear gap under the top singular value
    m = (_rng(4).standard_normal((3, 40, 24)) * 0.8 ** np.arange(24)).astype(np.float32)
    v0 = _jax_normal(2, (3, 24))               # the reference's own start
    want = jlr.power_iteration_specnorm(jnp.asarray(m), iters)
    got = tlr.power_iteration_specnorm(torch.from_numpy(m), iters,
                                       v0=torch.from_numpy(v0))
    _close(got, want, 0.0, 1e-5)
    if iters == 20:                            # converged: the top singular value
        _close(got, np.linalg.svd(m, compute_uv=False)[:, 0], 0.0, 1e-3)


def _proj(b):
    b = np.asarray(b, np.float64)
    return b @ np.swapaxes(b, -1, -2)


def _gram(seed, batch=(2,), n=64, d=16):
    x = _rng(seed).standard_normal((*batch, n, d)) * 0.85 ** np.arange(d)
    return np.asarray(jlr.gram(jnp.asarray(x.astype(np.float32))))


@pytest.mark.parametrize("r,iters", [(4, 3), (6, 10), (12, 3)])
def test_subspace_iteration_matches_jax(r, iters):
    g = _gram(5)
    p = min(4, 16 - r)
    q0 = _jax_normal(0, (2, 16, r + p))        # PRNGKey(0), as the reference
    ev_j, b_j = jlr.subspace_iteration(jnp.asarray(g), r, iters)
    ev_t, b_t = tlr.subspace_iteration(torch.from_numpy(g), r, iters,
                                       q0=torch.from_numpy(q0))
    assert b_t.shape == (2, 16, r)
    top = np.asarray(ev_j)[..., :1]
    np.testing.assert_allclose(ev_t.numpy() / top, np.asarray(ev_j) / top,
                               atol=1e-4)
    np.testing.assert_allclose(_proj(b_t.numpy()), _proj(b_j), atol=1e-4)


@pytest.mark.parametrize("extra", [2, 4])
def test_incremental_extend_matches_jax(extra):
    g = _gram(6)
    _, e = jlr.gram_spectrum(jnp.asarray(g))
    basis4 = np.asarray(e)[..., :4].copy()     # one cached basis for both
    q0 = _jax_normal(1, (2, 16, extra))        # PRNGKey(1), as the reference
    ev_j, b_j = jlr.incremental_extend(jnp.asarray(g), jnp.asarray(basis4),
                                       extra, iters=5)
    ev_t, b_t = tlr.incremental_extend(torch.from_numpy(g),
                                       torch.from_numpy(basis4), extra,
                                       iters=5, q0=torch.from_numpy(q0))
    assert b_t.shape == (2, 16, 4 + extra)
    np.testing.assert_array_equal(b_t[..., :4].numpy(), basis4)
    top = np.asarray(ev_j)[..., :1]
    np.testing.assert_allclose(ev_t.numpy() / top, np.asarray(ev_j) / top,
                               atol=1e-4)
    np.testing.assert_allclose(_proj(b_t.numpy()), _proj(b_j), atol=1e-4)


def test_spectral_routines_draw_from_a_generator():
    """Without a start draw each routine draws from the caller's
    generator (same seed, same result) and refuses to run without one."""
    g = torch.from_numpy(_gram(7))
    runs = [tlr.subspace_iteration(g, 4, 3, generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    with pytest.raises(ValueError, match="Generator"):
        tlr.power_iteration_specnorm(g, 3)
    ev, b = tlr.incremental_extend(g, runs[0][1], 2, 3,
                                   generator=torch.Generator().manual_seed(4))
    assert b.shape == (2, 16, 6) and (ev >= 0).all()


# -- policy network ----------------------------------------------------------------

def _feats(B, seed):
    rng = _rng(seed)
    dims = jdrrl.feat_dims(CFG.rank)
    return {k: rng.standard_normal((B, n)).astype(np.float32)
            for k, n in dims.items()}


@pytest.mark.parametrize("B", [1, 7])
def test_policy_apply_matches_jax(B):
    f = _feats(B, 8)
    lj, vj = jpolicy.policy_apply(JAGENT, {k: jnp.asarray(v) for k, v in f.items()})
    lt, vt = tpolicy.policy_apply(TAGENT, {k: torch.from_numpy(v) for k, v in f.items()})
    assert lt.shape == (B, len(CFG.rank.rank_grid)) and vt.shape == (B,)
    _close(lt, lj, 1e-6)
    _close(vt, vj, 1e-6)


def test_init_agent_matches_jax_tree():
    """The port's seeded agent has the JAX agent's tree, shapes and scales;
    the converter carries JAX values across leaf for leaf, the conv kernel
    in JAX's (k, d, f) layout."""
    own = tdrrl.init_agent(torch.Generator().manual_seed(0), CFG.rank,
                           CFG.d_model, device="cpu")
    leaves = jax.tree_util.tree_leaves_with_path(JAGENT)
    assert len(leaves) == len(jax.tree_util.tree_leaves(own))
    for path, leaf in leaves:
        t_own, t_conv = own, TAGENT
        for p in path:
            key = p.key if hasattr(p, "key") else p.idx
            t_own, t_conv = t_own[key], t_conv[key]
        a = np.asarray(leaf)
        assert tuple(t_own.shape) == a.shape == tuple(t_conv.shape), path
        assert t_conv.dtype == t_own.dtype == torch.float32
        np.testing.assert_array_equal(t_conv.numpy(), a)
        if a.size >= 1000 and a.std() > 0:    # same scale within sampling noise
            assert abs(t_own.std().item() / a.std() - 1) < 0.1, path
    assert TAGENT["conv"].shape == (5, CFG.d_model, 8)
    assert isinstance(TAGENT["layers"], list) and len(TAGENT["layers"]) == 2
    with pytest.raises(ValueError, match="agent"):
        agent_from_jax({"conv": np.zeros((5, 4, 8))}, device="cpu")


# -- features -------------------------------------------------------------------

@pytest.mark.parametrize("width", [5, 4, 1])
def test_conv_features_matches_jax(width):
    """A full 1-D convolution over all input channels, SAME padding (an
    even width pads one more after than before), mean over s, tanh."""
    rng = _rng(9)
    x = rng.standard_normal((2, 37, CFG.d_model)).astype(np.float32)
    kern = (rng.standard_normal((width, CFG.d_model, 8)) * 0.1).astype(np.float32)
    _close(tdrrl.conv_features(torch.from_numpy(x), torch.from_numpy(kern)),
           jdrrl.conv_features(jnp.asarray(x), jnp.asarray(kern)), 1e-6)


@pytest.mark.parametrize("arch", ["drrl-paper", "qwen2.5-14b"])
def test_weight_stats_matches_jax(arch):
    """Mean, ddof-0 variance and 3-iteration spectral norms of W_Q, W_K,
    W_V, from the reference's start vector (PRNGKey(2) at each width)."""
    cfg = get_config(arch, reduced=True)
    jp, tp = jax_and_torch_params(cfg)
    for li in range(cfg.num_layers):
        jl = {k: v[li] for k, v in jp["layers"]["attn"].items()}
        tl = {k: v[li] for k, v in tp["layers"]["attn"].items()}
        _close(tdrrl.weight_stats(tl, 3, v0=jax_power_v0(cfg)),
               jdrrl.weight_stats(jl, 3), 0.0, 1e-5)
    # the port's own start vectors: fixed draws, the same on every call
    a, b = tdrrl.power_starts(tl), tdrrl.power_starts(tl)
    assert all(torch.equal(a[n], b[n]) for n in tdrrl.W_NAMES)
    assert torch.equal(tdrrl.weight_stats(tl), tdrrl.weight_stats(tl, v0=a))


def _ctx(b, hq, h, d=16, seed=10, decay=0.8):
    rng = _rng(seed)
    return {"k_s2": _spectra(rng, b, h, d, decay=decay),
            "q_s2": _spectra(rng, b, hq, d, decay=decay)}


CTX_CASES = [(2, 4, 4), (3, 8, 2)]          # (b, hq, hkv): MHA and GQA


@pytest.mark.parametrize("b,hq,h", CTX_CASES)
def test_build_features_matches_jax(b, hq, h):
    ctx = _ctx(b, hq, h)
    rng = _rng(11)
    h_t = rng.standard_normal((b, 8)).astype(np.float32)
    w_t = rng.standard_normal((9,)).astype(np.float32)
    prev = rng.choice([4, 8, 12, 16, 6, 10], (b, h)).astype(np.int32)
    fj, (_, _, brj, nj) = jdrrl.build_features(
        CFG.rank, {k: jnp.asarray(v) for k, v in ctx.items()}, jnp.asarray(h_t),
        jnp.asarray(w_t), 1, jnp.asarray(prev))
    ft, (bb, hh, brt, nt) = tdrrl.build_features(
        CFG.rank, {k: torch.from_numpy(v) for k, v in ctx.items()},
        torch.from_numpy(h_t), torch.from_numpy(w_t), 1, torch.from_numpy(prev))
    assert (bb, hh) == (b, h) and sorted(ft) == sorted(fj)
    for name in ft:
        assert tuple(ft[name].shape) == fj[name].shape, name
        _close(ft[name], fj[name], 1e-7, 1e-5)
    _close(brt, brj, 0.0, 1e-5)
    _close(nt, nj, 0.0, 1e-5)


def _action_case(b, hq, h, eps0, t):
    rcfg = dataclasses.replace(CFG.rank, epsilon0=eps0)
    ctx = _ctx(b, hq, h, seed=12, decay=0.6)
    rng = _rng(13)
    h_t = rng.standard_normal((b, 8)).astype(np.float32)
    w_t = rng.standard_normal((9,)).astype(np.float32)
    prev = rng.choice([4, 8, 12, 16], (b, h)).astype(np.int32)
    return rcfg, ctx, h_t, {"prev_rank": prev, "w_t": w_t, "layer_id": 1, "t": t}


@pytest.mark.parametrize("eps0,t", [(1.0, 0), (0.6, 0), (0.6, 400), (4.0, 0)])
@pytest.mark.parametrize("b,hq,h", CTX_CASES)
def test_make_action_fn_matches_jax(b, hq, h, eps0, t):
    """Greedy ranks exactly, the masked logits, the Eq. 11 mask, value,
    log-prob and delta_a_rel; the smallest top-two gap among the allowed
    logits and the mask's smallest margin |bounds_rel - eps_t| are
    printed beside them."""
    rcfg, ctx, h_t, rc = _action_case(b, hq, h, eps0, t)
    fn_j = jdrrl.make_action_fn(JAGENT, rcfg, h_t=jnp.asarray(h_t))
    fn_t = tdrrl.make_action_fn(TAGENT, torch_config(CFG.with_(rank=rcfg)).rank,
                                h_t=torch.from_numpy(h_t))
    rk_j, aj = fn_j({k: jnp.asarray(v) for k, v in ctx.items()},
                    {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                     for k, v in rc.items()})
    rk_t, at = fn_t({k: torch.from_numpy(v) for k, v in ctx.items()},
                    {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
                     for k, v in rc.items()})
    np.testing.assert_array_equal(rk_t.numpy(), np.asarray(rk_j))
    np.testing.assert_array_equal(at["action_idx"].numpy(), np.asarray(aj["action_idx"]))
    np.testing.assert_array_equal(at["action_mask"].numpy(), np.asarray(aj["action_mask"]))
    _close(at["logits"], aj["logits"], 1e-6)
    for name in ("value", "logp"):
        _close(at[name], aj[name], 1e-6)
    _close(at["delta_a_rel"], aj["delta_a_rel"], 0.0, 1e-5)
    lj = np.sort(np.asarray(aj["logits"]), axis=-1)
    allowed = lj[..., -2] > -1e29
    gap = (lj[..., -1] - lj[..., -2])[allowed].min() if allowed.any() else np.inf
    eps_t = eps0 * np.exp(-rcfg.anneal_lambda * t)
    margin = np.abs(np.asarray(aj["features"]["bounds"]) - eps_t).min()
    print(f"eps_t {eps_t:.4f}: {np.asarray(aj['action_mask']).sum()} of "
          f"{np.asarray(aj['action_mask']).size} actions allowed, smallest top-two "
          f"gap {gap:.3g}, smallest mask margin {margin:.3g}")
    assert gap > 1e-5 and margin > 1e-5      # no near-tie decides these ranks


def test_sampled_actions_follow_softmax():
    """greedy=False: frequencies of the sampled grid indices over many
    draws from fixed logits (one batch of identical rows) against
    softmax(logits) of the JAX agent; the logits head is scaled up so the
    distribution is far from uniform. Tolerance 0.02 absolute (at 20,000
    draws per head the binomial standard deviation is at most 0.0036)."""
    agent_j = jax.tree_util.tree_map(lambda x: x, JAGENT)
    agent_j["head"]["w_logits"] = JAGENT["head"]["w_logits"] * 300.0
    agent_t = agent_from_jax(jax.device_get(agent_j), device="cpu")
    rcfg, ctx, h_t, rc = _action_case(1, 4, 4, 4.0, 0)
    n = 20000
    ctx_n = {k: np.repeat(v, n, axis=0) for k, v in ctx.items()}
    rc_n = dict(rc, prev_rank=np.repeat(rc["prev_rank"], n, axis=0))
    h_n = np.repeat(h_t, n, axis=0)
    _, aj = jdrrl.make_action_fn(agent_j, rcfg, h_t=jnp.asarray(h_t))(
        {k: jnp.asarray(v) for k, v in ctx.items()},
        {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in rc.items()})
    want = np.asarray(jax.nn.softmax(aj["logits"][0], axis=-1))       # (h, G)
    fn = tdrrl.make_action_fn(agent_t, torch_config(CFG).rank, h_t=torch.from_numpy(h_n),
                              greedy=False, generator=torch.Generator().manual_seed(5))
    _, at = fn({k: torch.from_numpy(v) for k, v in ctx_n.items()},
               {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
                for k, v in rc_n.items()})
    idx = at["action_idx"].numpy()                                  # (n, h)
    G = want.shape[-1]
    freq = np.stack([(idx == g).mean(axis=0) for g in range(G)], axis=-1)
    assert want.max() > 0.4 and want.min() < 0.1                    # not uniform
    np.testing.assert_allclose(freq, want, atol=0.02)
    with pytest.raises(ValueError, match="Generator"):
        tdrrl.make_action_fn(agent_t, torch_config(CFG).rank,
                             h_t=torch.from_numpy(h_t), greedy=False)
