"""The port's observability (``repro_torch.obs``) against ``repro.obs``, on
the CPU:

* the same operations on both registries give equal ``snapshot()`` dicts,
  byte-equal Prometheus text, equal histogram percentiles and equal fleet
  aggregates (exactly: the same float operations in the same order);
* ``validate_chrome_trace`` gives the same verdict on valid and malformed
  documents;
* obs tracing on or off gives the same tokens;
* the port engine's ``stats`` has the JAX engine's keys, and its
  deterministic counters (steps, tokens, decisions, prefills, mixed steps,
  prefill tokens, ``prefix_*``, ``spec_*``), the registry's request and
  rank counters and ``rank_telemetry``'s integer fields equal the JAX
  engine's on the same workload (reduced drrl-paper, adaptive): plain,
  speculative with the prefix cache, and with the drift trigger and a
  cancel.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.obs as jobs  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.configs.base import RankConfig  # noqa: E402
from repro.serve.api import Engine as JaxEngine  # noqa: E402
from repro.serve.api import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve.api import SamplingParams as JaxSamplingParams  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, SamplingParams  # noqa: E402
from torch_parity import jax_and_torch_params, torch_config  # noqa: E402

pytestmark = pytest.mark.serve

CFG = get_config("drrl-paper", reduced=True).with_(
    rank=RankConfig(mode="adaptive", rank_grid=(4, 8, 12, 16), fixed_rank=8,
                    segment_len=8))
KNOBS = dict(n_slots=2, max_len=64, page_size=8, segment_len=8, max_new_cap=8,
             prefill_chunk=8)


def _ops(pkg, seed):
    """A seeded sequence of metric operations on a fresh registry (plus a
    second shard for the rollup); returns (registry, other shard)."""
    rnd = np.random.default_rng(seed)
    r, r2 = pkg.MetricsRegistry(), pkg.MetricsRegistry()
    view = pkg.StatsView(r, {"steps": 0, "decode_s": 0.0, "eff_k": 4},
                         gauges=("eff_k",))
    for reg in (r, r2):
        h = reg.histogram("lat_s")
        hc = reg.histogram("accept", bounds=[float(i) for i in range(9)])
        c = reg.counter("toks")
        g = reg.gauge("depth")
        for _ in range(int(rnd.integers(20, 60))):
            h.observe(float(rnd.lognormal(-6, 2)))
            hc.observe(float(rnd.integers(0, 12)))
            c.inc(int(rnd.integers(0, 5)))
            g.set(int(rnd.integers(0, 9)))
    view["steps"] += 7
    view["decode_s"] += 0.125
    view["eff_k"] = 2
    return r, r2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_matches_jax(seed):
    rj, rj2 = _ops(jobs, seed)
    rt, rt2 = _ops(tobs, seed)
    assert rt.snapshot() == rj.snapshot()
    assert rt.prometheus_text() == rj.prometheus_text()
    assert rt.prometheus_text("x") == rj.prometheus_text("x")
    for name in ("lat_s", "accept"):
        for q in (0, 1, 25, 50, 90, 95, 99, 100):
            assert rt.get(name).percentile(q) == rj.get(name).percentile(q)
    assert tobs.aggregate([rt, rt2]) == jobs.aggregate([rj, rj2])
    assert (tobs.aggregate_registry([rt, rt2]).prometheus_text()
            == jobs.aggregate_registry([rj, rj2]).prometheus_text())


def test_registry_errors_match_jax():
    for pkg in (jobs, tobs):
        r = pkg.MetricsRegistry()
        r.counter("a")
        with pytest.raises(TypeError):
            r.gauge("a")
        h1, h2 = pkg.MetricsRegistry(), pkg.MetricsRegistry()
        h1.histogram("h", bounds=[1.0])
        h2.histogram("h", bounds=[2.0])
        with pytest.raises(TypeError, match="bounds differ"):
            pkg.aggregate([h1, h2])
        with pytest.raises(ValueError):
            pkg.Histogram("e", bounds=[])
        assert pkg.Stopwatch(enabled=False).stop() is None
        assert pkg.FLIGHT_SCHEMA_VERSION == 1


_GOOD = {"traceEvents": [
    {"name": "step", "ph": "X", "pid": 0, "tid": 1, "ts": 1.0, "dur": 2.0},
    {"name": "request", "ph": "b", "cat": "request", "id": "3", "pid": 0,
     "tid": 0, "ts": 1.0},
    {"name": "request", "ph": "e", "cat": "request", "id": "3", "pid": 0,
     "tid": 0, "ts": 4.0},
    {"name": "depth", "ph": "C", "pid": 0, "tid": 0, "ts": 2.0, "args": {"v": 1}},
    {"name": "meta", "ph": "M", "pid": 0, "tid": 0}]}
TRACE_DOCS = {
    "valid": _GOOD,
    "not_object": [1, 2],
    "no_events": {"displayTimeUnit": "ms"},
    "bad_ph": {"traceEvents": [{"name": "a", "ph": "Q", "pid": 0, "tid": 0, "ts": 0}]},
    "no_name_pid": {"traceEvents": [{"ph": "i", "tid": 0, "ts": 0}]},
    "neg_dur": {"traceEvents": [{"name": "a", "ph": "X", "pid": 0, "tid": 0,
                                 "ts": 0, "dur": -1}]},
    "end_no_begin": {"traceEvents": [{"name": "r", "ph": "e", "id": 1, "pid": 0,
                                      "tid": 0, "ts": 0}]},
    "async_no_id": {"traceEvents": [{"name": "r", "ph": "b", "pid": 0, "tid": 0,
                                     "ts": 0}]},
    "counter_no_args": {"traceEvents": [{"name": "c", "ph": "C", "pid": 0,
                                         "tid": 0, "ts": 0}]},
    "event_not_object": {"traceEvents": ["x", _GOOD["traceEvents"][0]]},
}


@pytest.mark.parametrize("name", list(TRACE_DOCS))
def test_validate_chrome_trace_matches_jax(name):
    doc = TRACE_DOCS[name]
    got = tobs.validate_chrome_trace(doc)
    assert got == jobs.validate_chrome_trace(doc)
    assert (got == []) == (name == "valid")


def test_tracer_and_flight_documents(tmp_path):
    """A span tracer and a flight recorder fed the same events give JAX's
    documents, timestamps aside."""
    docs = []
    for pkg in (jobs, tobs):
        tr = pkg.SpanTracer(pid=3, capacity=4)
        tr.async_begin("request", 7, args={"rid": 7})
        tr.instant("first_token", tid=1, args={"rid": 7})
        tr.complete("step", 1.0, 2.5, tid=1000, args={"step": 0})
        tr.counter("depth", {"q": 2.0})
        tr.async_end("request", 7)          # beyond capacity: dropped
        doc = tr.chrome_trace({"engine_id": 3})
        assert pkg.validate_chrome_trace(doc) == []
        fr = pkg.FlightRecorder(2, str(tmp_path / pkg.__name__), name="e")
        for k in range(3):
            fr.record("admit", rid=k)
        path = fr.dump("test", metrics={"a": 1}, error=RuntimeError("x"))
        with open(path) as f:
            fdoc = json.load(f)
        for ev in doc["traceEvents"]:
            ev.pop("ts")
        for ev in fdoc["events"]:
            ev.pop("t_s")
        fdoc.pop("wall_time")
        docs.append((doc, fdoc))
    assert docs[0] == docs[1]
    assert docs[1][0]["otherData"]["dropped_events"] == 1


def _prompts(n, seed, lo=8, hi=20):
    rnd = np.random.default_rng(seed)
    return [rnd.integers(0, 256, int(rnd.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("factor,sampling", [(True, False), (False, True)],
                         ids=["factor-greedy", "dense-sampled"])
def test_obs_on_off_same_tokens(factor, sampling, tmp_path):
    _, tparams = jax_and_torch_params(CFG)
    tcfg = torch_config(CFG)
    prompts = _prompts(3, seed=1)
    sps = [SamplingParams(max_new=6, temperature=0.8 if sampling else 0.0,
                          top_k=8 if sampling else 0, seed=i) for i in range(3)]
    outs = {}
    for on in (False, True):
        eng = Engine(tcfg, tparams, device="cpu", config=EngineConfig(
            **KNOBS, factor_cache=factor, sampling=sampling, obs_trace=on,
            flight_dir=str(tmp_path) if on else None))
        hs = [eng.submit(p, sp) for p, sp in zip(prompts, sps)]
        eng.run()
        outs[on] = [h.result().tolist() for h in hs]
    assert outs[True] == outs[False]
    snap = eng.obs.snapshot()
    m = snap["metrics"]
    assert m["requests.admitted"] == m["requests.finished"] == 3
    assert m["serve.ttft_s"]["count"] == 3 and snap["trace"]["enabled"]
    doc = eng.obs.chrome_trace()
    assert tobs.validate_chrome_trace(doc) == []
    assert json.loads(json.dumps(doc)) == doc
    evs = doc["traceEvents"]
    assert sum(e["ph"] == "b" for e in evs) == sum(e["ph"] == "e" for e in evs) == 3
    assert {e["name"] for e in evs if e.get("cat") == "phase"} == set(tobs.PHASES)
    assert 'repro_serve_ttft_s_bucket{le="+Inf"} 3' in eng.obs.prometheus()


# stats the two engines must count alike (times and eff_draft_k's gauge
# aside); the registry's own request and rank counters
DETERMINISTIC = ("steps", "tokens_decoded", "decides", "prefills", "mixed_steps",
                 "prefill_tokens", "prefix_hits", "prefix_misses",
                 "prefix_reused_tokens", "prefix_cow", "prefix_evictions",
                 "spec_steps", "spec_drafted", "spec_accepted", "spec_tokens")
REGISTRY = ("requests.admitted", "requests.finished", "requests.cancelled",
            "rank.decisions", "rank.basis_refreshes", "rank.forced_decides",
            "rank.drift_triggers", "prefix.nodes", "prefix.pages",
            "serve.ttft_s", "serve.accept_len")
TELEMETRY = ("steps_recorded", "per_layer_uniform", "kept_rank", "rank_switches",
             "veto_fires", "basis_refreshes", "drift_triggers", "decisions")
WORKLOADS = {
    "plain": dict(),
    "spec_prefix": dict(speculative=True, draft_k=3, prefix_cache=True),
    "drift_cancel": dict(drift_threshold=0.05),
}


def _serve(engine_cls, cfg_cls, sp_cls, cfg, params, knobs, **kw):
    eng = engine_cls(cfg, params, config=cfg_cls(**{**KNOBS, "n_slots": 3},
                                                 **knobs), **kw)
    # prompts end on a page boundary: the reference's speculative floor
    # assert fires on a prompt that ends inside a cached page
    shared = np.arange(16) % 256
    prompts = [np.concatenate([shared, p]) for p in _prompts(4, seed=9, lo=8, hi=9)]
    hs = [eng.submit(p, sp_cls(max_new=8), arrival=4 * i)
          for i, p in enumerate(prompts)]
    if "drift_threshold" in knobs:
        for _ in range(6):
            eng.step()
        assert hs[1].cancel()
    eng.run()
    return eng, [h.result().tolist() for h in hs]


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_counters_and_telemetry_match_jax(name):
    jparams, tparams = jax_and_torch_params(CFG)
    knobs = WORKLOADS[name]
    je, jt = _serve(JaxEngine, JaxEngineConfig, JaxSamplingParams, CFG, jparams, knobs)
    te, tt = _serve(Engine, EngineConfig, SamplingParams, torch_config(CFG),
                    tparams, knobs, device="cpu")
    assert tt == jt
    assert list(te.stats) == list(je.stats)
    for k in DETERMINISTIC:
        assert te.stats[k] == je.stats[k], k
    mj, mt = je.obs.snapshot()["metrics"], te.obs.snapshot()["metrics"]
    assert sorted(mt) == sorted(mj)
    for k in REGISTRY:
        got, want = mt[k], mj[k]
        if isinstance(want, dict):            # histograms: sample counts
            got, want = got["count"], want["count"]
        assert got == want, k
    tj = je.obs.rank_telemetry(je.core)
    tt_ = te.obs.rank_telemetry(te.core)
    for k in TELEMETRY:
        assert tt_[k] == tj[k], k
    assert tt_["read_bytes_per_token"] == tj["read_bytes_per_token"]
    if name == "drift_cancel":
        assert mt["requests.cancelled"] == 1 and mt["rank.drift_triggers"] > 0
    if name == "spec_prefix":
        assert mt["serve.accept_len"]["count"] > 0 and mt["prefix.nodes"] > 0
