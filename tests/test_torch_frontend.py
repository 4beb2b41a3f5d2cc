"""The port's front door and router (``repro_torch.serve.frontend``) on the
CPU, as ``tests/test_serve_frontend.py`` holds the reference's:

* tokens delivered through the background stepping thread (iterator,
  ``async for``, ``result()``) equal an explicit step loop's, with the
  dense and factor caches and ``use_kernel`` off and on;
* a consumer of a handle with a live driver never steps the engine;
* cancel mid-stream (the stepping thread held at a gate until the cancel
  returns, so the request cannot finish first) and in the queue, reset and
  shutdown with a live thread, and a raising step: consumers get
  ``EngineStopped`` (never a hang), the flight ring is dumped, ``drain()``
  re-raises;
* the exporters read from other threads while the stepping thread writes,
  with a shortened switch interval: no error, and the counters add up;
* ``FleetConfig`` validation; prefix affinity sticks to the warm replica,
  beats round-robin's hit rate and falls back under overload; a 2-replica
  fleet drains a burst.

Every wait is bounded: results and iterations go through helpers with a
deadline, drains and joins take a timeout and are asserted.
"""
import asyncio
import json
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import RankConfig  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.serve import (Engine, EngineConfig, EngineStopped,  # noqa: E402
                               FleetConfig, FrontEnd, Router, SamplingParams)

pytestmark = pytest.mark.serve

WAIT_S = 60.0


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("drrl-paper", reduced=True).with_(
        rank=RankConfig(mode="adaptive", rank_grid=(4, 8, 12, 16), fixed_rank=8,
                        segment_len=8))
    return cfg, get_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")


def _engine(cfg, params, **over):
    kw = dict(n_slots=2, max_len=48, page_size=8, segment_len=8, max_new_cap=8,
              prefill_chunk=8)
    kw.update(over)
    return Engine(cfg, params, device="cpu", config=EngineConfig(**kw))


def _prompts(n, lo=8, hi=14, seed=0):
    rnd = np.random.default_rng(seed)
    return [rnd.integers(0, 256, int(rnd.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


def result(h, timeout=WAIT_S):
    """``h.result()`` with a deadline: the same waits, bounded."""
    deadline = time.monotonic() + timeout
    while not h.done:
        h._check_stopped()
        assert time.monotonic() < deadline, f"request {h.rid} timed out"
        h._advance(len(h._toks))
    return h._result


def collect(it, timeout=WAIT_S):
    """``list(it)`` of a handle's token iterator, with a deadline."""
    out, deadline = [], time.monotonic() + timeout
    for tok in it:
        out.append(tok)
        assert time.monotonic() < deadline, "token stream timed out"
    return out


@pytest.mark.parametrize("factor,use_kernel", [
    (False, False), (True, False), (False, True), (True, True)],
    ids=["dense-plain", "factor-plain", "dense-kernel", "factor-kernel"])
def test_frontend_parity(setup, factor, use_kernel):
    cfg, params = setup
    prompts = _prompts(3, seed=1)
    sp = SamplingParams(max_new=6)
    ref_eng = _engine(cfg, params, factor_cache=factor, use_kernel=use_kernel)
    ref_hs = [ref_eng.submit(p, sp) for p in prompts]
    ref_eng.run()
    ref = [h.result().tolist() for h in ref_hs]

    eng = _engine(cfg, params, factor_cache=factor, use_kernel=use_kernel)
    with FrontEnd(eng, idle_poll_s=0.01) as fe:
        h0, h1, h2 = (fe.submit(p, sp) for p in prompts)
        sync_toks = collect(h0.tokens())

        async def consume(h):
            return [t async for t in h]

        async_toks = asyncio.run(asyncio.wait_for(consume(h1), WAIT_S))
        batch = result(h2).tolist()
        assert fe.drain(WAIT_S)
    assert [sync_toks, async_toks, batch] == ref
    for h in (h0, h1, h2):
        assert h.done and h.ttft_s is not None and h.done_s is not None
    assert set(eng.ttft()) == {h.rid for h in (h0, h1, h2)}


def test_passive_iteration_never_steps(setup):
    cfg, params = setup
    eng = _engine(cfg, params)
    calls = []
    orig = eng.step

    def counting_step():
        calls.append(threading.current_thread().name)
        return orig()

    eng.step = counting_step
    with FrontEnd(eng, idle_poll_s=0.01) as fe:
        assert eng.driver_alive
        h = fe.submit(_prompts(1, seed=2)[0], SamplingParams(max_new=6))
        toks = collect(h.tokens())
    assert len(toks) == 6 and calls
    assert all(name.startswith("serve-frontend") for name in calls), set(calls)
    assert not eng.driver_alive


def test_cancel_mid_stream_releases_pages(setup):
    """The stepping thread waits at a gate once token 0 is out, until the
    consumer's cancel has returned: the cancel always lands mid-stream."""
    cfg, params = setup
    eng = _engine(cfg, params, prefix_cache=True)
    gate, held = threading.Event(), []
    orig = eng.step

    def gated_step():
        if held and len(held[0]._toks) >= 1:
            assert gate.wait(WAIT_S), "gate never opened"
        return orig()

    eng.step = gated_step
    with FrontEnd(eng, idle_poll_s=0.01) as fe:
        h = fe.submit(_prompts(1, seed=3)[0], SamplingParams(max_new=8))
        held.append(h)
        it = h.tokens()
        first = next(it)
        assert h.cancel()
        gate.set()
        rest = collect(it)
        res = result(h)
        assert h.cancelled and h.done and len(res) < 8
        assert res.tolist() == [first] + rest
        assert not h.cancel()
        assert fe.drain(WAIT_S)
        assert len(result(h)) == len(res)
    eng.core.cache.check_refs(eng.core.prefix.all_pages())
    assert eng.obs.snapshot()["metrics"]["requests.cancelled"] == 1


def test_cancel_pending_request(setup):
    cfg, params = setup
    eng = _engine(cfg, params)
    sp = SamplingParams(max_new=8)
    with FrontEnd(eng, idle_poll_s=0.01) as fe:
        live = [fe.submit(p, sp) for p in _prompts(2, seed=4)]
        queued = fe.submit(_prompts(1, seed=5)[0], sp, arrival=10_000)
        assert queued.cancel()
        assert queued.cancelled and queued.done and result(queued).size == 0
        assert fe.drain(WAIT_S)
        assert [len(result(h)) for h in live] == [8, 8]
    eng.core.cache.check_refs()


def test_reset_strands_consumers_then_engine_reusable(setup):
    cfg, params = setup
    eng = _engine(cfg, params)
    fe = FrontEnd(eng, idle_poll_s=0.01)
    try:
        h = fe.submit(_prompts(1, seed=6)[0], SamplingParams(max_new=8),
                      arrival=10_000)
        eng.reset()
        with pytest.raises(EngineStopped):
            result(h)
        h2 = fe.submit(_prompts(1, seed=7)[0], SamplingParams(max_new=4))
        assert len(result(h2)) == 4
    finally:
        fe.shutdown(drain=False)
    assert not fe._thread.is_alive()


def test_shutdown_marks_handles_stopped(setup):
    cfg, params = setup
    eng = _engine(cfg, params)
    fe = FrontEnd(eng, idle_poll_s=0.01)
    h = fe.submit(_prompts(1, seed=8)[0], SamplingParams(max_new=8),
                  arrival=10_000)
    fe.shutdown(drain=False, timeout=WAIT_S)
    assert not fe._thread.is_alive()
    with pytest.raises(EngineStopped):
        collect(h.tokens())
    with pytest.raises(EngineStopped):
        fe.submit(_prompts(1, seed=9)[0], SamplingParams(max_new=4))
    fe.shutdown()                            # idempotent


def test_step_error_propagates_and_dumps_flight(setup, tmp_path):
    cfg, params = setup
    eng = _engine(cfg, params, flight_dir=str(tmp_path))
    orig = eng.core.step

    def boom():
        # idle steps pass, so the submit below meets a live thread
        if eng.core.sched.depth():
            raise RuntimeError("injected step failure")
        return orig()

    eng.core.step = boom
    fe = FrontEnd(eng, idle_poll_s=0.01, warmup=False)
    try:
        h = fe.submit(_prompts(1, seed=10)[0], SamplingParams(max_new=4))
        with pytest.raises(EngineStopped):
            result(h)
        with pytest.raises(EngineStopped) as info:
            fe.drain(WAIT_S)
        assert isinstance(info.value.__cause__, RuntimeError)
    finally:
        fe.shutdown(drain=False)
    dumps = sorted(tmp_path.glob("flight_*.json"))
    assert dumps, "no flight dump on the step exception"
    doc = json.loads(dumps[0].read_text())
    assert doc["reason"] == "step_exception"
    assert "injected step failure" in doc["error"] and "metrics" in doc


def test_exporters_under_background_stepping(setup):
    cfg, params = setup
    eng = _engine(cfg, params, obs_trace=True)
    stop, errors, reads = threading.Event(), [], [0]

    def reader():
        try:
            while not stop.is_set():
                assert eng.obs.snapshot()["metrics"]["requests.admitted"] >= 0
                eng.obs.prometheus()
                eng.obs.chrome_trace()
                dict(eng.stats)
                reads[0] += 1
        except Exception as e:          # reported by the assert below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    readers = [threading.Thread(target=reader) for _ in range(4)]
    try:
        for t in readers:
            t.start()
        with FrontEnd(eng, idle_poll_s=0.01) as fe:
            hs = [fe.submit(p, SamplingParams(max_new=6)) for p in _prompts(5, seed=14)]
            assert fe.drain(WAIT_S)
            assert [len(result(h)) for h in hs] == [6] * 5
    finally:
        stop.set()
        for t in readers:
            t.join(WAIT_S)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in readers)
    assert not errors, errors
    assert reads[0] > 0
    m = eng.obs.snapshot()["metrics"]
    assert m["requests.admitted"] == m["requests.finished"] == 5
    assert m["serve.tokens_decoded"] == eng.stats["tokens_decoded"] == 5 * 5


@pytest.mark.parametrize("bad,match", [
    (dict(n_replicas=0), "n_replicas"), (dict(routing="random"), "routing"),
    (dict(affinity_min_tokens=0), "affinity_min_tokens"),
    (dict(depth_slack=-1), "depth_slack"), (dict(idle_poll_s=0.0), "idle_poll_s")],
    ids=["n_replicas", "routing", "affinity_min_tokens", "depth_slack", "idle_poll_s"])
def test_fleet_config_validation(bad, match):
    with pytest.raises(ValueError, match=match):
        FleetConfig(**bad)


def _fleet(**over):
    ekw = dict(n_slots=2, max_len=64, page_size=8, segment_len=8, max_new_cap=8,
               prefill_chunk=8, prefix_cache=True)
    fkw = dict(n_replicas=2, affinity_min_tokens=8, idle_poll_s=0.01)
    fkw.update(over)
    return FleetConfig(engine=EngineConfig(**ekw), **fkw)


def test_router_affinity_sticks_to_warm_replica(setup):
    cfg, params = setup
    rnd = np.random.default_rng(11)
    shared = rnd.integers(0, 256, 16).astype(np.int32)
    with Router(cfg, params, fleet=_fleet(), device="cpu") as router:
        lead = router.submit(np.concatenate([shared, [1, 2, 3, 4]]),
                             SamplingParams(max_new=4))
        result(lead)
        hs = [router.submit(np.concatenate([shared, rnd.integers(0, 256, 4)]),
                            SamplingParams(max_new=4)) for _ in range(4)]
        assert router.drain(WAIT_S)
        st = router.stats()
        assert all(h.replica == lead.replica for h in hs), [h.replica for h in hs]
        assert st["route_kinds"]["affinity"] >= 4
        assert st["aggregate"]["hit_rate"] > 0.5
        fleet = router.obs_snapshot()["fleet"]
        assert fleet["requests.admitted"] == 5
        assert "repro_requests_admitted 5" in router.prometheus()


def test_router_affinity_beats_round_robin_hit_rate(setup):
    cfg, params = setup

    def drive(routing):
        rnd = np.random.default_rng(11)
        groups = [rnd.integers(0, 256, 16).astype(np.int32) for _ in range(2)]
        with Router(cfg, params, fleet=_fleet(routing=routing),
                    device="cpu") as router:
            sp = SamplingParams(max_new=4)
            leads = [router.submit(np.concatenate([g, rnd.integers(0, 256, 4)]), sp)
                     for g in groups]
            for h in leads:
                result(h)
            # [0, 0, 1, 1] misaligns a 2-replica rotation
            for g in (0, 0, 1, 1):
                router.submit(np.concatenate([groups[g], rnd.integers(0, 256, 4)]),
                              sp)
            assert router.drain(WAIT_S)
            return router.stats()["aggregate"]["hit_rate"]

    assert drive("affinity") > drive("round_robin")


def test_router_overload_falls_back_to_least_loaded(setup):
    cfg, params = setup
    rnd = np.random.default_rng(12)
    shared = rnd.integers(0, 256, 16).astype(np.int32)
    with Router(cfg, params, fleet=_fleet(depth_slack=0), device="cpu") as router:
        lead = router.submit(np.concatenate([shared, [1, 2, 3]]),
                             SamplingParams(max_new=4))
        result(lead)
        warm = lead.replica
        # depth on the warm replica only, bypassing the router; held in the
        # queue (a late arrival step) so the depth is there at dispatch
        backlog = [router.replicas[warm].submit(
            rnd.integers(0, 256, 12).astype(np.int32), SamplingParams(max_new=8),
            arrival=20) for _ in range(4)]
        h = router.submit(np.concatenate([shared, [7, 8, 9]]),
                          SamplingParams(max_new=4))
        assert h.replica != warm, "routed into the convoy"
        assert router.stats()["route_kinds"]["least_loaded"] >= 1
        assert router.drain(WAIT_S)
        assert [len(result(b)) for b in backlog] == [8] * 4


def test_fleet_drains_bursty_workload(setup):
    cfg, params = setup
    with Router(cfg, params, fleet=_fleet(), device="cpu") as router:
        rnd = np.random.default_rng(13)
        hs = [router.submit(p, SamplingParams(max_new=int(rnd.integers(2, 8))))
              for p in _prompts(10, seed=13)]
        assert router.drain(WAIT_S)
        total = sum(len(result(h)) for h in hs)
        st = router.stats()
        # each first token comes from a prefill chunk, not a decode row
        assert st["aggregate"]["tokens_decoded"] == total - len(hs)
        assert st["aggregate"]["depth"] == 0
        assert sorted(st["routed"]) != [0, sum(st["routed"])]
        for fe in router.replicas:
            fe.engine.core.cache.check_refs(fe.engine.core.prefix.all_pages())
    assert all(not fe._thread.is_alive() for fe in router.replicas)
