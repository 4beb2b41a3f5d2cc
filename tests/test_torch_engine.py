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


MODES = ("adaptive", "fixed", "drrl", "learned")


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


UNPORTED = [
    dict(speculative=True), dict(prefix_cache=True),
    dict(drift_threshold=0.5), dict(record_traces="traces"), dict(obs_trace=True),
    dict(flight_dir="flight"), dict(nucleus=True),
]


@pytest.mark.parametrize("knobs", UNPORTED, ids=[next(iter(k)) for k in UNPORTED])
def test_unported_knobs_fail_loudly(knobs, models):
    _, tcfg, _, tparams, _, _ = models["adaptive"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(tcfg, tparams, device="cpu",
               config=EngineConfig(**{**KNOBS, **knobs}))


@pytest.mark.parametrize("params", [dict(temperature=0.7), dict(top_k=5),
                                    dict(top_p=0.9)])
def test_sampling_requests_fail_loudly(params, models):
    _, tcfg, _, tparams, _, _ = models["adaptive"]
    eng = Engine(tcfg, tparams, device="cpu", config=EngineConfig(**KNOBS))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.submit(WORKLOAD[0]["tokens"], SamplingParams(max_new=4, **params))


@pytest.mark.parametrize("mode", ["random"])
def test_unported_rank_modes_fail_loudly(mode, models):
    _, tcfg, _, tparams, _, _ = models["adaptive"]
    cfg = tcfg.with_(rank=tcfg.rank.__class__(mode=mode))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(cfg, tparams, device="cpu", config=EngineConfig(**KNOBS))


@pytest.mark.parametrize("mode", ["drrl", "learned"])
def test_policy_modes_without_params_raise(mode, models):
    """As the JAX engine: a policy engine with no agent fails at
    construction instead of serving another rank rule."""
    _, tcfg, _, tparams, _, _ = models[mode]
    with pytest.raises(ValueError, match="policy params"):
        Engine(tcfg, tparams, device="cpu", config=EngineConfig(**KNOBS))
