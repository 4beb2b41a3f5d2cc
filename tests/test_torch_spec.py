"""Low-rank self-speculative decoding of the port against the JAX package.

Units on seeded inputs: ``serve.spec`` (``accept_counts``,
``clamp_to_eos``, ``apply_deferred_mass`` bitwise against JAX and against
sequential adds), ``policy.draft_ranks`` and ``decode_step_paged(
return_all_logits=True, mass_defer=True)`` (logits of valid queries and
``mass_q`` within 1e-4 / 1e-5, the tolerances of
``test_torch_paged_step.py``). Then the engine on the reduced drrl-paper
model at the sizes of ``tests/test_serve_spec.py`` (``n_slots=4,
max_len=64, page_size=8, prefill_chunk=8, draft_k=3,
draft_rank_frac=0.5``): greedy tokens and ``ranks_per_step()`` IDENTICAL to
the JAX speculative engine's and the tokens identical to the port's own
plain engine, in rank modes 'adaptive', 'fixed', 'drrl' (and 'off') x
factor cache x ``use_kernel``; sampled streams; EOS cut-off; a cancel
mid-stream (no page leak); accept-length stats; the adaptive draft
window's collapse and recovery; the drift trigger under speculation; and
a check that the drafts' factor appends into the live kt pool change
nothing a transient copy would not.

The JAX runs are cached per module (``_jax_run``), each built once.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import RankConfig  # noqa: E402
from repro.models.transformer import decode_step_paged as jax_step  # noqa: E402
from repro.serve import spec as jspec  # noqa: E402
from repro.serve.api import Engine as JaxEngine  # noqa: E402
from repro.serve.api import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve.api import SamplingParams as JaxSamplingParams  # noqa: E402
from repro.serve.policy import draft_ranks as jax_draft_ranks  # noqa: E402
from repro_torch.models.transformer import decode_step_paged as torch_step  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, SamplingParams  # noqa: E402
from repro_torch.serve import spec  # noqa: E402
from repro_torch.serve.policy import draft_ranks  # noqa: E402
from torch_parity import (jax_and_torch_agent, jax_and_torch_params,  # noqa: E402
                          torch_config)

pytestmark = pytest.mark.serve

KNOBS = dict(n_slots=4, max_len=64, page_size=8, segment_len=8, max_new_cap=32,
             prefill_chunk=8, draft_k=3, draft_rank_frac=0.5)


# -- units -------------------------------------------------------------------

def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_accept_counts_and_clamp_to_eos_match_jax():
    rng = np.random.default_rng(0)
    drafts = rng.integers(0, 3, (64, 4))
    targets = rng.integers(0, 3, (64, 5))
    targets[:8, :4] = drafts[:8]                       # all drafts accepted
    eos = rng.integers(-1, 3, 64)
    want = np.asarray(jspec.accept_counts(jnp.asarray(drafts), jnp.asarray(targets)))
    got = spec.accept_counts(_t(drafts), _t(targets))
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(want.tolist()) == {1, 2, 3, 4, 5}
    want_c = np.asarray(jspec.clamp_to_eos(jnp.asarray(want, jnp.int32),
                                           jnp.asarray(targets), jnp.asarray(eos)))
    got_c = spec.clamp_to_eos(got, _t(targets), _t(eos))
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    assert (want_c < want).any()


def test_apply_deferred_mass_bitwise():
    """In place, bitwise the JAX function's result and the sequential
    per-query accumulation, for every accept count; a contrib cut to
    max(n_q) queries gives the same bits."""
    rng = np.random.default_rng(0)
    L, ns, C, M, hkv = 2, 4, 6, 16, 2
    pool = rng.random((L, ns, M, hkv), np.float32)
    contrib = rng.random((L, ns, C, M, hkv), np.float32)
    lens = np.array([3, 7, 0, 10], np.int64)
    n_q = np.array([2, 4, 0, 3], np.int64)
    want = np.asarray(jspec.apply_deferred_mass(
        jnp.asarray(pool), jnp.asarray(contrib), jnp.asarray(lens), jnp.asarray(n_q)))
    seq = pool.copy()
    for r, (l0, nq) in enumerate(zip(lens, n_q)):
        seq[:, r, l0:l0 + nq] = 0.0
        for q in range(nq):
            seq[:, r] = seq[:, r] + contrib[:, r, q]
    np.testing.assert_array_equal(want, seq)
    mp = _t(pool.copy())
    out = spec.apply_deferred_mass(mp, _t(contrib), _t(lens), _t(n_q))
    assert out is mp
    np.testing.assert_array_equal(out.numpy(), want)
    cut = spec.apply_deferred_mass(_t(pool.copy()), _t(contrib)[:, :, :4],
                                   _t(lens), _t(n_q))
    np.testing.assert_array_equal(cut.numpy(), want)


def test_host_accept_stats_matches_jax():
    acc, caps = [4, 1, 3, 2], [4, 4, 2, 3]
    assert (spec.host_accept_stats(acc, caps, [0, 2, 3], 3)
            == jspec.host_accept_stats(acc, caps, [0, 2, 3], 3))


@pytest.mark.parametrize("frac,r_cap", [(0.5, 8), (0.25, 4), (0.25, 16), (1.0, 16)])
def test_draft_ranks_matches_jax(frac, r_cap):
    """Concentrated, flat and all-zero spectra over every grid rank."""
    rng = np.random.default_rng(1)
    ns, hkv, dh = 12, 2, 16
    decay = np.exp(-rng.uniform(0.05, 2.0, (ns, hkv, 1)) * np.arange(dh))
    spectra = (rng.uniform(0.5, 2, (ns, hkv, dh)) * decay).astype(np.float32)
    spectra = -np.sort(-spectra, axis=-1)
    spectra[3] = 0.0
    ranks = np.array([4, 8, 12, 16] * 3, np.int32)
    want = np.asarray(jax_draft_ranks(jnp.asarray(ranks), jnp.asarray(spectra),
                                      frac=frac, grid_lo=4, r_cap=r_cap))
    got = draft_ranks(_t(ranks), _t(spectra), frac=frac, grid_lo=4, r_cap=r_cap)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _verify_state(cfg, kt, seed=0):
    """The verify block's state: slot 0 verifies a 4-query draft run at
    length 5, slot 1 prefills a 6-token chunk at 12, slot 2 verifies at 20
    with 4 queries, slot 3 is idle; C = 6."""
    rng = np.random.default_rng(seed)
    L, hkv, dh = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim()
    ns, ps, M, C = 4, 8, 32, 6
    pps = M // ps
    r_keep = min(cfg.rank.rank_grid[-1], dh)
    pt = np.zeros((ns, pps), np.int32)
    pt[0] = [3, 7, 1, 10]
    pt[1] = [2, 12, 5, 4]
    pt[2] = [6, 8, 9, 11]
    basis = np.linalg.qr(rng.standard_normal((L, ns, hkv, dh, dh)))[0]
    st = {
        "pool_k": rng.standard_normal((L, ns * pps + 1, ps, hkv, dh)).astype(np.float32),
        "pool_v": rng.standard_normal((L, ns * pps + 1, ps, hkv, dh)).astype(np.float32),
        "page_table": pt,
        "tokens": rng.integers(0, cfg.vocab_size, (ns, C)).astype(np.int32),
        "slot_lens": np.array([5, 12, 20, 0], np.int32),
        "active": np.array([True, True, True, False]),
        "q_lens": np.array([4, 6, 4, 4], np.int32),
        "prefill_rows": np.array([False, True, False, False]),
        "basis": basis[..., :r_keep].astype(np.float32),
        "slot_ranks": np.array([8, 16, 12, 16], np.int32),
    }
    if kt:
        st["kt_pool"] = rng.standard_normal(
            (L, ns + 1, M, hkv, r_keep)).astype(np.float32)
    return st


VERIFY = [(kt, uk) for kt in (False, True) for uk in (False, True)]


@pytest.mark.parametrize("case", VERIFY, ids=["factor%s-kernel%s" % c for c in VERIFY])
def test_verify_step_matches_jax(case):
    """``return_all_logits`` and ``mass_defer``: every valid query's logits
    (1e-4), ``mass_q`` (1e-5, zero outside valid queries of live rows) and
    the pools (1e-5) against JAX's verify call; with the kernel a padding
    query gives zeros, so only valid queries' logits are compared."""
    kt, use_kernel = case
    cfg = get_config("drrl-paper", reduced=True).with_(
        rank=RankConfig(mode="adaptive", rank_grid=(4, 8, 12, 16)))
    jparams, tparams = jax_and_torch_params(cfg)
    st = _verify_state(cfg, kt)
    lg_j, pools_j = jax_step(cfg, jparams, **{k: jnp.asarray(v) for k, v in st.items()},
                             use_kernel=use_kernel, return_all_logits=True,
                             mass_defer=True)
    tst = {k: torch.from_numpy(np.array(v)) for k, v in st.items()}
    lg_t, pools_t = torch_step(torch_config(cfg), tparams, **tst, use_kernel=use_kernel,
                               return_all_logits=True, mass_defer=True)
    assert lg_t.shape == lg_j.shape == (4, 6, cfg.vocab_size)
    assert set(pools_t) == set(pools_j)
    ok = (np.arange(6)[None, :] < st["q_lens"][:, None]) & st["active"][:, None]
    np.testing.assert_allclose(lg_t.numpy()[ok], np.asarray(lg_j)[ok],
                               atol=1e-4, rtol=1e-4)
    mq_t, mq_j = pools_t["mass_q"].numpy(), np.asarray(pools_j["mass_q"])
    assert mq_t.shape == (cfg.num_layers, 4, 6, 32, cfg.num_kv_heads)
    np.testing.assert_allclose(mq_t, mq_j, atol=1e-5, rtol=1e-5)
    assert (mq_t[:, ~ok] == 0).all() and (mq_t[:, ok].sum(axis=-2) > 0).all()
    for key in ("k", "v") + (("kt",) if kt else ()):
        got, want = pools_t[key].numpy(), np.asarray(pools_j[key])
        got, want = (got[:, 1:], want[:, 1:]) if key != "kt" else (got[:, :4], want[:, :4])
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5, err_msg=key)
    with pytest.raises(ValueError, match="mutually exclusive"):
        torch_step(torch_config(cfg), tparams, **tst, mass_defer=True,
                   mass_pool=torch.zeros((2, 4, 32, cfg.num_kv_heads)))


# -- the engine ----------------------------------------------------------------

_MODELS = {}
_JAX = {}


def _model(mode):
    if mode not in _MODELS:
        cfg = get_config("drrl-paper", reduced=True).with_(rank=RankConfig(
            mode=mode, rank_grid=(4, 8, 12, 16), fixed_rank=16, segment_len=8))
        agents = jax_and_torch_agent(cfg) if mode == "drrl" else (None, None)
        _MODELS[mode] = (cfg, torch_config(cfg)) + jax_and_torch_params(cfg) + agents
    return _MODELS[mode]


def _prompts(cfg, sizes=(9, 17, 12), seed=0):
    rnd = np.random.default_rng(seed)
    return [rnd.integers(1, cfg.vocab_size, s).astype(np.int32) for s in sizes]


def _serve(side, mode, knobs, reqs, driver=None, seed=0, sizes=(9, 17, 12)):
    """One engine run: ``reqs`` the SamplingParams keywords per request.
    Returns (tokens per request, ranks per step, engine, handles, what the
    driver returned)."""
    cfg, tcfg, jparams, tparams, jagent, tagent = _model(mode)
    if side == "jax":
        eng = JaxEngine(cfg, jparams, jagent, config=JaxEngineConfig(**{**KNOBS, **knobs}))
        S = JaxSamplingParams
    else:
        eng = Engine(tcfg, tparams, tagent, device="cpu",
                     config=EngineConfig(**{**KNOBS, **knobs}))
        S = SamplingParams
    hs = [eng.submit(p, S(**{"max_new": 12, **r}))
          for p, r in zip(_prompts(cfg, sizes, seed), reqs)]
    eng.warmup()
    extra = driver(eng, hs) if driver else eng.run()
    return [h.result() for h in hs], eng.core.ranks_per_step(), eng, hs, extra


def _jax_run(mode, knobs, reqs=({},) * 3, **kw):
    key = (mode, tuple(sorted(knobs.items())), repr(reqs), repr(sorted(kw.items())))
    if key not in _JAX:
        toks, ranks, eng, _, _ = _serve("jax", mode, knobs, reqs, **kw)
        _JAX[key] = (toks, ranks, dict(eng.stats), eng.accept_lens())
    return _JAX[key]


def _same(a, b, what):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"{what} {i}")


SPEC_STATS = ("spec_steps", "spec_drafted", "spec_accepted", "spec_tokens",
              "tokens_decoded", "steps", "mixed_steps", "decides", "eff_draft_k")
CASES = ([(m, f, k) for m in ("adaptive", "fixed", "drrl") for f in (False, True)
          for k in (False, True)] + [("off", False, False), ("off", False, True)])


@pytest.mark.parametrize("case", CASES, ids=["%s-factor%s-kernel%s" % c for c in CASES])
def test_spec_engine_matches_jax(case):
    """Greedy tokens and ranks identical to JAX's speculative engine, the
    tokens identical to the port's plain engine; the same accept runs and
    stats; every page back, refcounts exact."""
    mode, factor, use_kernel = case
    knobs = dict(speculative=True, use_kernel=use_kernel,
                 factor_cache=factor if mode != "off" else None)
    jt, jr, jstats, jacc = _jax_run(mode, knobs)
    tt, tr, eng, _, _ = _serve("torch", mode, knobs, ({},) * 3)
    plain, _, _, _, _ = _serve("torch", mode, {**knobs, "speculative": False}, ({},) * 3)
    _same(tt, jt, "request")
    _same(tr, jr, "step")
    _same(tt, plain, "plain request")
    for k in SPEC_STATS:
        assert eng.stats[k] == jstats[k], k
    assert eng.accept_lens() == jacc
    assert eng.stats["spec_steps"] > 0 and eng.stats["spec_accepted"] > 0
    core = eng.core
    assert core.cache.free_pages == core.cache.n_pages - 1
    assert (core.cache.page_table == 0).all()
    core.cache.check_refs()


def test_spec_sampled_streams_match_jax():
    """Seeded top-k and top-p streams beside a greedy one: JAX's tokens, and
    the port's plain engine's."""
    reqs = (dict(temperature=0.9, top_k=8, seed=11),
            dict(temperature=0.7, top_p=0.85, seed=12), {})
    knobs = dict(speculative=True, sampling=True, nucleus=True)
    jt, jr, jstats, _ = _jax_run("adaptive", knobs, reqs, seed=3)
    tt, tr, eng, _, _ = _serve("torch", "adaptive", knobs, reqs, seed=3)
    plain, _, _, _, _ = _serve("torch", "adaptive", {**knobs, "speculative": False},
                               reqs, seed=3)
    _same(tt, jt, "request")
    _same(tr, jr, "step")
    _same(tt, plain, "plain request")
    assert eng.stats["spec_accepted"] == jstats["spec_accepted"] > 0


def test_spec_eos_cutoff_matches_jax():
    """Each stream's own third greedy token as its EOS: a draft run crossing
    it stops there, as plain decode and the JAX engine do."""
    plain, _, _, _, _ = _serve("torch", "off", {}, ({},) * 2, seed=5, sizes=(9, 13))
    reqs = tuple(dict(eos_id=int(p[2])) for p in plain)
    knobs = dict(speculative=True)
    jt, _, _, _ = _jax_run("off", knobs, reqs, seed=5, sizes=(9, 13))
    tt, _, eng, _, _ = _serve("torch", "off", knobs, reqs, seed=5, sizes=(9, 13))
    cut, _, _, _, _ = _serve("torch", "off", {}, reqs, seed=5, sizes=(9, 13))
    _same(tt, jt, "request")
    _same(tt, cut, "plain request")
    for t, r in zip(tt, reqs):
        assert t[-1] == r["eos_id"] and r["eos_id"] not in t[:-1] and len(t) <= 3
    assert eng.core.cache.free_pages == eng.core.cache.n_pages - 1


def test_spec_cancel_mid_stream_matches_jax():
    """A cancel after 4 steps, drafts in flight: the survivor's tokens are
    JAX's and a plain run's, every page comes back, and the cancelled
    stream's accept runs were harvested."""
    knobs = dict(n_slots=2, speculative=True)

    def driver(eng, hs):
        for _ in range(4):
            eng.step()
        assert hs[0].cancel()
        eng.run()
        core = eng.core
        return (core.cache.free_pages == core.cache.n_pages - 1,
                bool((core.cache.page_table == 0).all()), hs[0].cancelled,
                list(hs[0].result()), eng.accept_lens())

    _, _, _, _, xj = _serve("jax", "adaptive", knobs, ({},) * 2, driver, seed=7,
                            sizes=(9, 17))
    tt, _, eng, hs, xt = _serve("torch", "adaptive", knobs, ({},) * 2, driver, seed=7,
                                sizes=(9, 17))
    plain, _, _, _, _ = _serve("torch", "adaptive", dict(n_slots=2), ({},) * 2,
                               seed=7, sizes=(9, 17))
    assert xt[:4] == xj[:4] and xt[0] and xt[1] and xt[2]
    assert xt[4] == xj[4] and 0 in xt[4]
    np.testing.assert_array_equal(tt[1], plain[1])
    eng.core.cache.check_refs()


def test_accept_lens_account_for_every_token():
    """Accept runs in [1, draft_k + 1] summing to each request's tokens less
    token 0; the stats count the same tokens (JAX's runs)."""
    knobs = dict(speculative=True)
    _, _, _, jacc = _jax_run("adaptive", {**knobs, "use_kernel": False,
                                          "factor_cache": False})
    tt, _, eng, hs, _ = _serve("torch", "adaptive", knobs, ({},) * 3, seed=9)
    acc = eng.accept_lens()
    assert set(acc) == {h.rid for h in hs}
    for h, t in zip(hs, tt):
        assert all(1 <= a <= 4 for a in acc[h.rid]) and sum(acc[h.rid]) == len(t) - 1
    s = eng.stats
    assert s["spec_drafted"] >= s["spec_accepted"] >= 0
    assert s["spec_tokens"] == s["tokens_decoded"] == sum(sum(v) for v in acc.values())
    assert set(jacc) == {0, 1, 2}


ADAPTIVE_DRAFT = {
    "parity": dict(adaptive_draft=True),
    "collapse": dict(adaptive_draft=True, draft_shrink_below=1.01),
    "recovery": dict(adaptive_draft=True, draft_shrink_below=-1.0,
                     draft_grow_above=-1.0),
}


@pytest.mark.parametrize("name", list(ADAPTIVE_DRAFT))
def test_adaptive_draft_matches_jax(name):
    """The EWMA draft window: tokens equal plain decode's and JAX's, and so
    do ``eff_draft_k`` and the spec / mixed step counts. 'collapse' shrinks
    every spec step (eff_k 3 -> 1 -> 0, then probe steps only);
    'recovery' starts collapsed and grows back to draft_k on the probes."""
    knobs = dict(speculative=True, **ADAPTIVE_DRAFT[name])
    reqs = (dict(max_new=24),) * 3

    def driver(eng, hs):
        if name == "recovery":
            eng.core._eff_k = 0
            eng.core.stats["eff_draft_k"] = 0
        return eng.run()

    jt, jr, js, _ = _jax_run("adaptive", knobs, reqs, driver=driver)
    tt, tr, eng, _, _ = _serve("torch", "adaptive", knobs, reqs, driver)
    plain, _, _, _, _ = _serve("torch", "adaptive", {}, reqs)
    _same(tt, jt, "request")
    _same(tr, jr, "step")
    _same(tt, plain, "plain request")
    for k in SPEC_STATS:
        assert eng.stats[k] == js[k], k
    want_k = {"parity": None, "collapse": 0, "recovery": 3}[name]
    if want_k is not None:
        assert eng.stats["eff_draft_k"] == want_k
    if name == "collapse":
        assert eng.stats["spec_steps"] < eng.stats["steps"]


def test_drift_trigger_under_speculation_matches_jax():
    """``drift_threshold=0`` re-decides after every accepted run: the same
    forced decisions, tokens and ranks as JAX's speculative engine; the
    check runs once per speculative step, at the post-accept length."""
    knobs = dict(speculative=True, drift_threshold=0.0)

    def driver(eng, hs):
        core, calls = eng.core, []
        inner = core._check_drift

        def spy(live):
            for i in live:
                st = core.sched.slots[i]
                assert core.cache.lens[i] == len(st.req.tokens) + st.n_out - 1
            calls.append(len(live))
            return inner(live)
        core._check_drift = spy
        eng.run()
        return len(calls)

    jt, jr, js, _ = _jax_run("adaptive", knobs, driver=driver)
    tt, tr, eng, _, n_calls = _serve("torch", "adaptive", knobs, ({},) * 3, driver)
    _, _, base, _, _ = _serve("torch", "adaptive", dict(speculative=True), ({},) * 3)
    _same(tt, jt, "request")
    _same(tr, jr, "step")
    assert eng.stats["decides"] == js["decides"] > base.stats["decides"]
    assert n_calls == eng.stats["spec_steps"] < eng.stats["tokens_decoded"]


def test_draft_factor_appends_change_nothing():
    """The drafts append their factors into the live kt pool's first r_cap
    columns (JAX: into a transient copy). A run whose drafts append into a
    clone instead gives bitwise the same tokens, ranks and final kt pool,
    (its scratch row n_slots aside, which takes dead lanes' writes in no
    defined order), and after every speculative step the kt pool differs
    from its state before only at positions the verify wrote: [lens, lens +
    draft_k + 1) of decoding rows and the chunk of prefilling rows."""
    knobs = dict(speculative=True, factor_cache=True)
    runs = {}
    for transient in (False, True):
        def driver(eng, hs, transient=transient):
            core = eng.core
            inner = core.fns.decode_step_paged
            cap = core._draft_cap
            copy = {}

            def step(*a, **kw):
                # one transient copy per speculative step, which its drafts
                # append into in turn (the reference's d_kt)
                kt = kw.get("kt_pool")
                if transient and kt is not None and kt.shape[-1] == cap < core.cache.r_keep:
                    kw["kt_pool"] = copy.setdefault("kt", kt.clone())
                return inner(*a, **kw)
            core.fns = SimpleNamespace(decode_step_paged=step)
            spec_inner, checked = core._step_spec, []

            def spec_step(*a):
                copy.clear()
                before = core.cache.kt_pool.clone()
                lens, active, plen = a[7].clone(), a[10], a[12]
                out = spec_inner(*a)
                moved = (out[0]["kt"] != before).any(dim=(0, 3, 4))   # (ns + 1, M)
                pos = torch.arange(moved.shape[1])
                width = torch.where(lens < plen, torch.clamp(plen - lens, max=core.spec_chunk),
                                    torch.full_like(lens, core.draft_k + 1))
                wrote = (active[:, None] & (pos >= lens[:, None])
                         & (pos < (lens + width)[:, None]))
                assert not (moved[:-1] & ~wrote).any()
                checked.append(int(moved[:-1].sum()))
                return out
            core._step_spec = spec_step
            eng.run()
            return core.cache.kt_pool.clone(), checked
        tt, tr, eng, _, (kt, checked) = _serve("torch", "adaptive", knobs, ({},) * 3, driver)
        runs[transient] = (tt, tr, kt, checked)
    (ta, ra, kta, ca), (tb, rb, ktb, _) = runs[False], runs[True]
    _same(ta, tb, "request")
    _same(ra, rb, "step")
    assert torch.equal(kta[:, :-1], ktb[:, :-1])
    assert len(ca) > 0 and sum(ca) > 0


def test_spec_config_validation():
    cfg, tcfg, _, tparams, _, _ = _model("adaptive")
    with pytest.raises(ValueError, match="speculative"):
        EngineConfig(prefill_chunk=None, speculative=True)
    with pytest.raises(ValueError, match="draft_k"):
        EngineConfig(speculative=True, draft_k=0)
    with pytest.raises(ValueError, match="draft_rank_frac"):
        EngineConfig(draft_rank_frac=0.0)
    with pytest.raises(ValueError, match="snapshot_every"):
        EngineConfig(snapshot_every=0)
    with pytest.raises(ValueError, match="adaptive_draft"):
        EngineConfig(adaptive_draft=True)
    from repro_torch.serve.engine import ServeEngine
    with pytest.raises(ValueError, match="speculative"):
        ServeEngine(tcfg, tparams, prefill_chunk=None, speculative=True, device="cpu")
    with pytest.raises(ValueError, match="adaptive_draft"):
        ServeEngine(tcfg, tparams, adaptive_draft=True, device="cpu")
    eng = ServeEngine(tcfg, tparams, prefill_chunk=8, speculative=True,
                      draft_rank_frac=0.25, device="cpu")
    assert eng._draft_cap == 4 and eng.spec_chunk == 8
