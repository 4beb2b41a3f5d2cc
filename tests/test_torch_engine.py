"""The port's serving engine end to end against the JAX engine:
reduced drrl-paper on ``benchmarks/serve_bench.py``'s mixed staggered
workload (prompts 8..32 tokens, arrivals every 2 steps, 6 requests through
3 slots so slots recycle), chunked prefill (chunk 8), rank modes
'adaptive' and 'fixed', factor cache on and off, ``use_kernel`` off and
on. Greedy tokens and ``ranks_per_step()`` must be IDENTICAL.

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
from torch_parity import build_workload, jax_and_torch_params, torch_config  # noqa: E402

pytestmark = pytest.mark.serve

KNOBS = dict(n_slots=3, max_len=64, page_size=16, segment_len=8,
             max_new_cap=12, prefill_chunk=8)
WORKLOAD = build_workload(6, 12)


def _cfg(mode):
    return get_config("drrl-paper", reduced=True).with_(
        rank=RankConfig(mode=mode, rank_grid=(4, 8, 12, 16), segment_len=8))


@pytest.fixture(scope="module")
def models():
    out = {}
    for mode in ("adaptive", "fixed"):
        cfg = _cfg(mode)
        out[mode] = (cfg, torch_config(cfg)) + jax_and_torch_params(cfg)
    return out


@pytest.fixture(scope="module")
def jax_runs(models):
    """(mode, factor_cache, use_kernel) -> (tokens per request, ranks per
    step) of the JAX engine, computed once per module."""
    cache = {}

    def run(mode, factor, use_kernel):
        key = (mode, factor, use_kernel)
        if key not in cache:
            cfg, _, jparams, _ = models[mode]
            eng = JaxEngine(cfg, jparams, config=JaxEngineConfig(
                **KNOBS, factor_cache=factor, use_kernel=use_kernel))
            hs = [eng.submit(w["tokens"], JaxSamplingParams(max_new=w["max_new"]),
                             arrival=w["arrival"]) for w in WORKLOAD]
            eng.warmup()
            eng.run()
            cache[key] = ([h.result() for h in hs], eng.core.ranks_per_step())
        return cache[key]
    return run


CASES = [(m, f, k) for m in ("adaptive", "fixed") for f in (False, True)
         for k in (False, True)]


@pytest.mark.parametrize("case", CASES, ids=["%s-factor%s-kernel%s" % c for c in CASES])
def test_engine_matches_jax(case, models, jax_runs):
    mode, factor, use_kernel = case
    _, tcfg, _, tparams = models[mode]
    want_toks, want_ranks = jax_runs(mode, factor, use_kernel)
    eng = Engine(tcfg, tparams, device="cpu", config=EngineConfig(
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


def test_streaming_tokens_match_result(models):
    """The handle iterator streams the same tokens ``result()`` returns,
    and an EOS id stops a stream early."""
    _, tcfg, _, tparams = models["adaptive"]
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
    dict(prefill_chunk=None), dict(speculative=True), dict(prefix_cache=True),
    dict(drift_threshold=0.5), dict(record_traces="traces"), dict(obs_trace=True),
    dict(flight_dir="flight"), dict(nucleus=True),
]


@pytest.mark.parametrize("knobs", UNPORTED, ids=[next(iter(k)) for k in UNPORTED])
def test_unported_knobs_fail_loudly(knobs, models):
    _, tcfg, _, tparams = models["adaptive"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(tcfg, tparams, device="cpu",
               config=EngineConfig(**{**KNOBS, **knobs}))


@pytest.mark.parametrize("params", [dict(temperature=0.7), dict(top_k=5),
                                    dict(top_p=0.9)])
def test_sampling_requests_fail_loudly(params, models):
    _, tcfg, _, tparams = models["adaptive"]
    eng = Engine(tcfg, tparams, device="cpu", config=EngineConfig(**KNOBS))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.submit(WORKLOAD[0]["tokens"], SamplingParams(max_new=4, **params))


@pytest.mark.parametrize("mode", ["drrl", "learned", "random"])
def test_unported_rank_modes_fail_loudly(mode, models):
    _, tcfg, _, tparams = models["adaptive"]
    cfg = tcfg.with_(rank=tcfg.rank.__class__(mode=mode))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(cfg, tparams, device="cpu", config=EngineConfig(**KNOBS))
