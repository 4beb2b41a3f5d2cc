"""The port's serving engine end to end against the JAX engine:
reduced drrl-paper on ``benchmarks/serve_bench.py``'s mixed staggered
workload (prompts 8..32 tokens, arrivals every 2 steps, 6 requests through
3 slots so slots recycle), chunked prefill (chunk 8), rank modes
'adaptive', 'fixed' and 'drrl', factor cache on and off, ``use_kernel`` off
and on, and 'learned' through the same decision path; and one-shot prefill
(``prefill_chunk=None``). Greedy tokens and ``ranks_per_step()`` must be
IDENTICAL. The agent of 'drrl' / 'learned' is JAX ``init_agent(PRNGKey(7))``
through ``agent_from_jax``.

The JAX runs are shared through a module-scoped cache so the file stays
well under a minute on a CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro.configs.base import RankConfig  # noqa: E402
from repro.serve.api import Engine as JaxEngine  # noqa: E402
from repro.serve.api import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve.api import SamplingParams as JaxSamplingParams  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, SamplingParams  # noqa: E402
from torch_parity import (build_workload, jax_and_torch_agent,  # noqa: E402
                          jax_and_torch_params, torch_config)

pytestmark = pytest.mark.serve

KNOBS = dict(n_slots=3, max_len=64, page_size=16, segment_len=8,
             max_new_cap=12, prefill_chunk=8)
WORKLOAD = build_workload(6, 12)


def _cfg(mode):
    return get_config("drrl-paper", reduced=True).with_(
        rank=RankConfig(mode=mode, rank_grid=(4, 8, 12, 16), segment_len=8))


MODES = ("adaptive", "fixed", "drrl", "learned", "random")


@pytest.fixture(scope="module")
def models():
    """mode -> (jax cfg, torch cfg, jax params, torch params, jax agent,
    torch agent); the agent is None in the modes without one."""
    out = {}
    for mode in MODES:
        cfg = _cfg(mode)
        agents = (jax_and_torch_agent(cfg) if mode in ("drrl", "learned")
                  else (None, None))
        out[mode] = (cfg, torch_config(cfg)) + jax_and_torch_params(cfg) + agents
    return out


@pytest.fixture(scope="module")
def jax_runs(models):
    """(mode, factor_cache, use_kernel, prefill_chunk) -> (tokens per
    request, ranks per step) of the JAX engine, computed once per module."""
    cache = {}

    def run(mode, factor, use_kernel, chunk=KNOBS["prefill_chunk"]):
        key = (mode, factor, use_kernel, chunk)
        if key not in cache:
            cfg, _, jparams, _, jagent, _ = models[mode]
            eng = JaxEngine(cfg, jparams, jagent, config=JaxEngineConfig(
                **{**KNOBS, "prefill_chunk": chunk}, factor_cache=factor,
                use_kernel=use_kernel))
            hs = [eng.submit(w["tokens"], JaxSamplingParams(max_new=w["max_new"]),
                             arrival=w["arrival"]) for w in WORKLOAD]
            eng.warmup()
            eng.run()
            cache[key] = ([h.result() for h in hs], eng.core.ranks_per_step())
        return cache[key]
    return run


CASES = [(m, f, k) for m in ("adaptive", "fixed", "drrl") for f in (False, True)
         for k in (False, True)] + [("learned", True, True)]


@pytest.mark.parametrize("case", CASES, ids=["%s-factor%s-kernel%s" % c for c in CASES])
def test_engine_matches_jax(case, models, jax_runs):
    mode, factor, use_kernel = case
    _, tcfg, _, tparams, _, tagent = models[mode]
    want_toks, want_ranks = jax_runs(mode, factor, use_kernel)
    eng = Engine(tcfg, tparams, tagent, device="cpu", config=EngineConfig(
        **KNOBS, factor_cache=factor, use_kernel=use_kernel))
    hs = [eng.submit(w["tokens"], SamplingParams(max_new=w["max_new"]),
                     arrival=w["arrival"]) for w in WORKLOAD]
    eng.warmup()
    eng.run()
    for i, (h, want) in enumerate(zip(hs, want_toks)):
        np.testing.assert_array_equal(h.result(), want,
                                      err_msg=f"request {i} diverged")
    got_ranks = eng.ranks_per_step()
    assert len(got_ranks) == len(want_ranks)
    for t, (g, w) in enumerate(zip(got_ranks, want_ranks)):
        np.testing.assert_array_equal(g, w, err_msg=f"step {t}")
    stats = eng.stats
    assert stats["mixed_steps"] > 0 and stats["decides"] >= len(WORKLOAD)
    assert eng.core.cache.free_pages == eng.core.cache.n_pages - 1
    eng.core.cache.check_refs()


def _serve(tcfg, tparams, agent=None, **knobs):
    eng = Engine(tcfg, tparams, agent, device="cpu",
                 config=EngineConfig(**{**KNOBS, **knobs}))
    hs = [eng.submit(w["tokens"], SamplingParams(max_new=w["max_new"]),
                     arrival=w["arrival"]) for w in WORKLOAD]
    eng.warmup()
    eng.run()
    return eng, [h.result() for h in hs]


ONESHOT = [(m, f) for m in ("adaptive", "fixed", "drrl") for f in (False, True)]


@pytest.mark.parametrize("case", ONESHOT, ids=["%s-factor%s" % c for c in ONESHOT])
def test_oneshot_engine_matches_jax(case, models, jax_runs):
    """One-shot prefill (``prefill_chunk=None``): each prompt is prefilled
    at admission by a full-rank ``forward_dense`` over its length bucket;
    tokens and rank history must equal the JAX engine's."""
    mode, factor = case
    _, tcfg, _, tparams, _, tagent = models[mode]
    want_toks, want_ranks = jax_runs(mode, factor, False, None)
    eng, outs = _serve(tcfg, tparams, tagent, prefill_chunk=None,
                       factor_cache=factor)
    for i, (got, want) in enumerate(zip(outs, want_toks)):
        np.testing.assert_array_equal(got, want, err_msg=f"request {i} diverged")
    got_ranks = eng.ranks_per_step()
    assert len(got_ranks) == len(want_ranks)
    for t, (g, w) in enumerate(zip(got_ranks, want_ranks)):
        np.testing.assert_array_equal(g, w, err_msg=f"step {t}")
    stats = eng.stats
    assert stats["mixed_steps"] == 0 and stats["prefills"] == len(WORKLOAD)
    assert stats["prefill_tokens"] == sum(len(w["tokens"]) for w in WORKLOAD)
    assert stats["stall_s"] > 0      # staggered arrivals: admissions block decode
    assert eng.core.cache.free_pages == eng.core.cache.n_pages - 1
    eng.core.cache.check_refs()


@pytest.mark.parametrize("mode", ["adaptive", "fixed", "drrl"])
def test_oneshot_and_chunked_give_the_same_tokens(mode, models):
    _, tcfg, _, tparams, _, tagent = models[mode]
    _, oneshot = _serve(tcfg, tparams, tagent, prefill_chunk=None)
    _, chunked = _serve(tcfg, tparams, tagent)
    for i, (a, b) in enumerate(zip(oneshot, chunked)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i} diverged")


def test_oneshot_streams_token_zero_in_order(models):
    """One-shot admission emits token 0 outside the fused step; a streaming
    consumer still sees every token in order, ending at EOS."""
    _, tcfg, _, tparams, _, _ = models["adaptive"]
    eng = Engine(tcfg, tparams, device="cpu",
                 config=EngineConfig(**{**KNOBS, "prefill_chunk": None}))
    w = WORKLOAD[1]
    h = eng.submit(w["tokens"], SamplingParams(max_new=10))
    streamed = list(h.tokens())
    np.testing.assert_array_equal(streamed, h.result())
    assert h.ttft_s is not None
    eos = int(streamed[0])
    h2 = eng.submit(w["tokens"], SamplingParams(max_new=10, eos_id=eos))
    assert list(h2.result()) == [eos]


def test_streaming_tokens_match_result(models):
    """The handle iterator streams the same tokens ``result()`` returns,
    and an EOS id stops a stream early."""
    _, tcfg, _, tparams, _, _ = models["adaptive"]
    eng = Engine(tcfg, tparams, device="cpu", config=EngineConfig(**KNOBS))
    w = WORKLOAD[0]
    h = eng.submit(w["tokens"], SamplingParams(max_new=10))
    streamed = list(h.tokens())
    np.testing.assert_array_equal(streamed, h.result())
    eos = int(streamed[3])
    h2 = eng.submit(w["tokens"], SamplingParams(max_new=10, eos_id=eos))
    out = h2.result()
    assert out[-1] == eos and len(out) == streamed.index(eos) + 1


def _both(mode, knobs, params=None, driver=None):
    """Serve WORKLOAD on the JAX engine and on the port's, ``params``
    (SamplingParams kwargs) for every request, each with its own seed;
    ``driver(eng, handles)`` steps the engine instead of ``run()``.
    Returns {'jax'|'torch': (tokens per request, ranks per step, what the
    driver returned)}."""
    cfg, tcfg, jparams, tparams, _, _ = models_cache[mode]
    out = {}
    for side, E, C, S, p, dev in (
            ("jax", JaxEngine, JaxEngineConfig, JaxSamplingParams, jparams, {}),
            ("torch", Engine, EngineConfig, SamplingParams, tparams, {"device": "cpu"})):
        eng = E(cfg if side == "jax" else tcfg, p, config=C(**{**KNOBS, **knobs}), **dev)
        hs = [eng.submit(w["tokens"], S(max_new=w["max_new"], seed=i, **(params or {})),
                         arrival=w["arrival"]) for i, w in enumerate(WORKLOAD)]
        eng.warmup()
        extra = driver(eng, hs) if driver else eng.run()
        out[side] = ([h.result() for h in hs], eng.core.ranks_per_step(), extra)
    return out


models_cache = {}
_PLAIN = {}


def _plain(mode):
    """``_both(mode, {})``: the greedy run without a driver, computed once
    per module."""
    if mode not in _PLAIN:
        _PLAIN[mode] = _both(mode, {})
    return _PLAIN[mode]


def _assert_same(out):
    (tj, rj, _), (tt, rt, _) = out["jax"], out["torch"]
    for i, (a, b) in enumerate(zip(tt, tj)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i} diverged")
    assert len(rt) == len(rj)
    for t, (a, b) in enumerate(zip(rt, rj)):
        np.testing.assert_array_equal(a, b, err_msg=f"step {t}")


@pytest.mark.parametrize("params", [dict(temperature=0.7), dict(top_k=5),
                                    dict(top_p=0.9)])
def test_sampling_requests_match_jax(params, models):
    """Every request sampled (temperature, or top-k / top-p at temperature
    1), each with its own seed: the JAX engine's tokens."""
    models_cache.update(models)
    if "temperature" not in params:
        params = dict(params, temperature=1.0)
    _assert_same(_both("adaptive", dict(nucleus=True), params))


def _forced_steps(eng, hs):
    """Step to the end; the force_decide flags the drift trigger left
    after each step."""
    forced = []
    while eng.step():
        forced.append(eng.core.force_decide.copy())
    return forced


@pytest.mark.parametrize("knobs", [dict(drift_threshold=0.5), dict(nucleus=True)],
                         ids=["drift_threshold", "nucleus"])
def test_ported_knobs_match_jax(knobs, models):
    """The drift trigger forces re-decisions at the same steps as JAX's
    engine (and fires on this workload); a nucleus engine serves greedy
    requests bitwise the greedy tokens."""
    models_cache.update(models)
    out = _both("adaptive", knobs, driver=_forced_steps)
    _assert_same(out)
    fj, ft = out["jax"][2], out["torch"][2]
    assert len(ft) == len(fj)
    for t, (a, b) in enumerate(zip(ft, fj)):
        np.testing.assert_array_equal(a, b, err_msg=f"forced flags after step {t}")
    if "drift_threshold" in knobs:
        assert sum(int(f.sum()) for f in fj) > 0
    else:
        _assert_same({"jax": _plain("adaptive")["jax"], "torch": out["torch"]})


@pytest.mark.parametrize("mode", ["random"])
def test_random_rank_mode_matches_jax(mode, models):
    """Rank mode 'random': each decision draws grid[randint(fold_in(
    fold_in(key(17), t), slot))], JAX's bits; greedy tokens and ranks
    equal, and the draws visit several buckets."""
    models_cache.update(models)
    out = _both(mode, {})
    _assert_same(out)
    ranks = {int(r) for step in out["torch"][1] for r in step if r >= 0}
    assert len(ranks) >= 3, ranks


def test_random_mode_drift_trigger_matches_jax(models):
    """'random' with the drift trigger, where decisions come often. A
    decision whose rank exceeds the keys the slot holds (kv_len 8 to 15
    here, buckets up to 16) keeps eigenvectors of the weighted Gram's null
    space, which eigensolvers choose freely (LAPACK through XLA and through
    torch differ), so those requests' later tokens are not comparable. All
    other requests' tokens, and every slot's ranks and forced flags while
    it serves one of them, equal JAX's."""
    models_cache.update(models)
    null_rids = set()

    def driver(eng, hs):
        if isinstance(eng, JaxEngine):
            decide = eng.core._decide

            def logged(*a):
                out = decide(*a)
                slot = int(a[8])
                if int(np.asarray(out[0])[slot]) > int(np.asarray(a[4])[slot]):
                    null_rids.add(eng.core.sched.slots[slot].req.rid)
                return out
            eng.core._decide = logged
        rows = []
        while eng.step():
            rows.append((eng.core.force_decide.copy(),
                         [s.req.rid if s.active else -1 for s in eng.core.sched.slots]))
        return rows

    out = _both("random", dict(drift_threshold=0.05), driver=driver)
    (tj, rj, sj), (tt, rt, st) = out["jax"], out["torch"]
    print(f"requests with a rank above their kv_len: {sorted(null_rids)}")
    assert len(null_rids) < len(WORKLOAD)
    for i, (a, b) in enumerate(zip(tt, tj)):
        if i not in null_rids:
            np.testing.assert_array_equal(a, b, err_msg=f"request {i} diverged")
    assert len(st) == len(sj) and len(rt) == len(rj)
    n_forced = 0
    for t, ((fa, ra), (fb, rb), ka, kb) in enumerate(zip(st, sj, rt[1:], rj[1:])):
        assert ra == rb
        ok = np.array([r >= 0 and r not in null_rids for r in ra])
        np.testing.assert_array_equal(fa[ok], fb[ok], err_msg=f"forced, step {t}")
        np.testing.assert_array_equal(ka[ok], kb[ok], err_msg=f"ranks, step {t + 1}")
        n_forced += int(fb[ok].sum())
    assert n_forced > 0


@pytest.mark.parametrize("where", ["queued", "mid_prefill", "mid_decode"])
def test_cancel_matches_jax(where, models):
    """Cancel request 3 while it waits in the queue, while its prompt is
    half prefilled, or after 3 decoded tokens: ``cancel`` returns what
    JAX's does (True, then False), the handle is sealed with the tokens
    delivered to it (none: nothing streams), the core's record of the
    evicted stream holds JAX's tokens, every page comes back, and the
    other streams' tokens are those of a run without the cancel."""
    models_cache.update(models)
    victim = 3

    def driver(eng, hs):
        core, h = eng.core, hs[victim]
        ret = None
        while eng.step():
            live = [s for s in core.sched.slots if s.active and s.req.rid == victim]
            st = live[0] if live else None
            hit = {"queued": st is None and eng.core.now == WORKLOAD[victim]["arrival"] + 1,
                   "mid_prefill": st is not None and 0 < st.prefilled < st.prompt_len,
                   "mid_decode": st is not None and st.n_out == 3}[where]
            if ret is None and hit:
                ret = (h.cancel(), h.cancel(), eng.cancel(victim))
        free = core.cache.free_pages == core.cache.n_pages - 1
        rec = core.results().get(victim)
        return (ret, free, h.cancelled, list(h.tokens()),
                None if rec is None else rec.tolist())

    out = _both("adaptive", {}, driver=driver)
    (tj, _, xj), (tt, _, xt) = out["jax"], out["torch"]
    assert xj[0] == (True, False, False) and xt == xj, (xt, xj)
    assert xt[1] and xt[2]
    assert len(tt[victim]) == 0 and xt[3] == []
    assert xt[4] == {"queued": None, "mid_prefill": []}.get(where, xt[4])
    if where == "mid_decode":
        assert len(xt[4]) == 3
    plain = _plain("adaptive")
    for i in range(len(WORKLOAD)):
        if i != victim:
            np.testing.assert_array_equal(tt[i], plain["torch"][0][i])
            np.testing.assert_array_equal(tt[i], tj[i])


@pytest.mark.parametrize("mode", ["drrl", "learned"])
def test_policy_modes_without_params_raise(mode, models):
    """As the JAX engine: a policy engine with no agent fails at
    construction instead of serving another rank rule."""
    _, tcfg, _, tparams, _, _ = models[mode]
    with pytest.raises(ValueError, match="policy params"):
        Engine(tcfg, tparams, device="cpu", config=EngineConfig(**KNOBS))


def test_cancel_ends_a_stream_cleanly(models):
    """A consumer iterating ``tokens()`` cancels after 3 tokens: the
    iteration ends, ``result()`` is those 3 tokens (JAX's), later tokens
    are never delivered, and the pages come back once the rest finish."""
    models_cache.update(models)
    got = {}
    for side, E, C, S, (cfg, p), dev in (
            ("jax", JaxEngine, JaxEngineConfig, JaxSamplingParams,
             (models["adaptive"][0], models["adaptive"][2]), {}),
            ("torch", Engine, EngineConfig, SamplingParams,
             (models["adaptive"][1], models["adaptive"][3]), {"device": "cpu"})):
        eng = E(cfg, p, config=C(**KNOBS), **dev)
        hs = [eng.submit(w["tokens"], S(max_new=w["max_new"]), arrival=w["arrival"])
              for w in WORKLOAD[:3]]
        seen = []
        for tok in hs[1].tokens():
            seen.append(int(tok))
            if len(seen) == 3:
                assert hs[1].cancel()
        eng.run()
        assert hs[1].cancelled and list(hs[1].result()) == seen
        assert eng.core.cache.free_pages == eng.core.cache.n_pages - 1
        got[side] = (seen, [h.result().tolist() for h in (hs[0], hs[2])])
    assert got["torch"] == got["jax"] and len(got["torch"][0]) == 3
