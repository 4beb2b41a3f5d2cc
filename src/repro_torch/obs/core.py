"""Observability facade of the port (``repro.obs.core``): one object per
engine bundling the metrics registry shard, the optional span tracer, and
the flight recorder.

The engine calls the ``on_*`` hooks from its step loop with values it
**already holds on host** (slot ids, host token counts, wall-clock
deltas): every hook is pure host Python (dict lookups, int/float adds,
deque appends) with no torch call, so observability can stay ON in
steady state without adding device syncs.

Rank telemetry is the one place device values are involved, and it is
**export-time only**: :meth:`Observability.rank_telemetry` derives the
kept-rank series, switch counts and factor-read bytes/token from the
engine's ``rank_history`` and fetches the per-decision Eq. 9 veto flags,
device booleans the decision returns and the engine banks unfetched, in
one ``torch.stack(...).cpu()`` when a report is actually requested.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, Optional

from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.metrics import (DEFAULT_COUNT_BUCKETS, MetricsRegistry,
                               StatsView)
from repro_torch.obs.tracing import (NULL_PHASES, PHASES, SpanTracer, StepPhases,
                               Stopwatch)

__all__ = ["Observability", "Stopwatch"]

_ENGINE_SEQ = itertools.count()


class Observability:
    """Per-engine observability bundle. Always constructed (the registry
    and flight ring are cheap and always on); span/phase tracing is
    opt-in via ``trace=True`` because it allocates an event per step
    phase and per request milestone."""

    def __init__(self, *, trace: bool = False, trace_capacity: int = 200_000,
                 flight_dir: Optional[str] = None,
                 flight_capacity: int = 256,
                 engine_id: Optional[int] = None):
        self.engine_id = (next(_ENGINE_SEQ) if engine_id is None
                          else engine_id)
        self.registry = MetricsRegistry()
        self.tracer = (SpanTracer(pid=self.engine_id,
                                  capacity=trace_capacity)
                       if trace else None)
        self.flight = FlightRecorder(flight_capacity, flight_dir,
                                     name=f"engine{self.engine_id}")
        r = self.registry
        # histograms: TTFT and per-token decode latency feed the bench
        # percentiles; accept-run lengths are small discrete counts
        self.ttft_hist = r.histogram("serve.ttft_s")
        self.latency_hist = r.histogram("serve.token_latency_s")
        self.accept_hist = r.histogram("serve.accept_len",
                                       bounds=DEFAULT_COUNT_BUCKETS)
        self._phase_hists = ({p: r.histogram(f"serve.phase.{p}_s")
                              for p in PHASES} if trace else None)
        # request + rank control-plane counters (the per-step token/stat
        # counters live behind the engine's StatsView — same registry)
        self._c_admitted = r.counter("requests.admitted")
        self._c_finished = r.counter("requests.finished")
        self._c_cancelled = r.counter("requests.cancelled")
        self._c_decisions = r.counter("rank.decisions")
        self._c_refreshes = r.counter("rank.basis_refreshes")
        self._c_forced = r.counter("rank.forced_decides")
        self._c_drift = r.counter("rank.drift_triggers")
        self._c_veto = r.counter("rank.veto_fires")
        self._g_queue = r.gauge("queue.depth")
        self._g_live = r.gauge("slots.live")
        self._g_prefix_nodes = r.gauge("prefix.nodes")
        self._g_prefix_pages = r.gauge("prefix.pages")

    # -- engine wiring ----------------------------------------------------

    def stats_view(self, init: Dict[str, Any],
                   gauges=("eff_draft_k",)) -> StatsView:
        """The engine's legacy ``stats`` surface as a registry view (and
        the reset path: re-binding zeroes the backing metrics)."""
        return StatsView(self.registry, init, prefix="serve", gauges=gauges)

    def reset_run(self) -> None:
        """Engine reset: clear the per-run trace buffer (the flight ring
        deliberately survives — it exists for post-mortems)."""
        if self.tracer is not None:
            self.tracer.clear()

    def step_phases(self, step: int):
        """Phase recorder for one step; a shared no-op when tracing is
        off so the loop pays one attribute check per step."""
        if self.tracer is None:
            return NULL_PHASES
        return StepPhases(self.tracer, step, self._phase_hists)

    # -- hooks (host values only; called from the step loop) --------------

    def on_admit(self, rid: int, slot: int, prompt_len: int, *,
                 reused: int = 0, queued: int = 0, live: int = 0) -> None:
        self._c_admitted.inc()
        self._g_queue.set(queued)
        self._g_live.set(live)
        self.flight.record("admit", rid=rid, slot=slot,
                           prompt_len=prompt_len, reused=reused)
        if self.tracer is not None:
            self.tracer.async_begin("request", rid,
                                    args={"rid": rid, "slot": slot,
                                          "prompt_len": prompt_len,
                                          "prefix_reused": reused})

    def on_first_token(self, rid: int, slot: int, ttft_s: float) -> None:
        self.ttft_hist.observe(ttft_s)
        if self.tracer is not None:
            self.tracer.instant("first_token", tid=slot, cat="request",
                                args={"rid": rid,
                                      "ttft_ms": ttft_s * 1e3})

    def on_finish(self, rid: int, slot: int, n_out: int,
                  reason: str) -> None:
        (self._c_cancelled if reason == "cancel"
         else self._c_finished).inc()
        self.flight.record("finish", rid=rid, slot=slot, n_out=n_out,
                           reason=reason)
        if self.tracer is not None:
            self.tracer.async_end("request", rid,
                                  args={"rid": rid, "n_out": n_out,
                                        "reason": reason})

    def on_decide(self, slot: int, seg_t: int, *,
                  forced: bool = False) -> None:
        self._c_decisions.inc()
        self._c_refreshes.inc()   # every decision refreshes the basis
        if forced:
            self._c_forced.inc()
        self.flight.record("decide", slot=slot, seg_t=seg_t,
                           forced=forced)
        if self.tracer is not None:
            self.tracer.instant("rank_decide", tid=slot, cat="rank",
                                args={"slot": slot, "seg_t": seg_t,
                                      "forced": forced})

    def on_drift(self, slot: int, drift: float) -> None:
        self._c_drift.inc()
        self.flight.record("drift", slot=slot, drift=drift)
        if self.tracer is not None:
            self.tracer.instant("basis_drift", tid=slot, cat="rank",
                                args={"slot": slot, "drift": drift})

    def on_prefill_chunk(self, slot: int, rid: int, q: int,
                         prefilled: int) -> None:
        if self.tracer is not None:
            self.tracer.instant("prefill_chunk", tid=slot, cat="request",
                                args={"rid": rid, "q": q,
                                      "prefilled": prefilled})

    def on_spec_accept(self, slot: int, accepted: int,
                       drafted: int) -> None:
        self.accept_hist.observe(float(accepted))
        if self.tracer is not None:
            self.tracer.instant("spec_accept", tid=slot, cat="spec",
                                args={"slot": slot, "accepted": accepted,
                                      "drafted": drafted})

    def on_token_latency(self, dt_s: float) -> None:
        self.latency_hist.observe(dt_s)

    def set_prefix_size(self, nodes: int, pages: int) -> None:
        self._g_prefix_nodes.set(nodes)
        self._g_prefix_pages.set(pages)

    def record_event(self, kind: str, **fields: Any) -> None:
        """Free-form flight-ring event (cancellations, evictions,
        exceptions)."""
        self.flight.record(kind, **fields)

    # -- exporters (read side; any thread) --------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready point-in-time export of this engine's shard."""
        return {
            "engine_id": self.engine_id,
            "metrics": self.registry.snapshot(),
            "trace": {
                "enabled": self.tracer is not None,
                "events": len(self.tracer.events) if self.tracer else 0,
                "dropped": self.tracer.dropped if self.tracer else 0,
            },
            "flight": {
                "events": len(self.flight.events),
                "recorded": self.flight.n_recorded,
                "dumps": self.flight.n_dumps,
            },
        }

    def prometheus(self, namespace: str = "repro") -> str:
        return self.registry.prometheus_text(namespace)

    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event document (empty when tracing is off)."""
        if self.tracer is None:
            return {"traceEvents": [], "displayTimeUnit": "ms",
                    "otherData": {"dropped_events": 0}}
        return self.tracer.chrome_trace(
            metadata={"engine_id": self.engine_id})

    def flight_dump(self, reason: str, *,
                    error: Optional[BaseException] = None,
                    path: Optional[str] = None) -> Optional[str]:
        """Dump the flight ring + a registry snapshot. Host-only — safe
        from exception handlers on any thread."""
        return self.flight.dump(reason, metrics=self.registry.snapshot(),
                                error=error, path=path)

    def rank_telemetry(self, engine) -> Dict[str, Any]:
        """Export-time rank report for ``engine`` (a ServeEngine): the
        kept-rank time series, switch counts, Eq. 9 veto fires and
        factor-read bytes/token, derived from device state the loop
        already banked (``rank_history`` and the unfetched per-decision
        veto flags). The only host transfers happen here, at read time,
        never inside the step loop."""
        import numpy as np
        import torch

        series = engine.ranks_per_step()          # host: -1 = off/dead
        switches = 0
        mean_rank = 0.0
        if series:
            mat = np.stack(series)                # (steps, n_slots)
            live = mat >= 0
            mean_rank = float(mat[live].mean()) if live.any() else 0.0
            for j in range(mat.shape[1]):
                col = mat[live[:, j], j]
                if col.size > 1:
                    switches += int((np.diff(col) != 0).sum())
        pend = getattr(engine, "_veto_pending", ())
        veto = 0
        if len(pend):
            veto = int(torch.stack(list(pend)).cpu().sum())
        self._c_veto.set(veto)
        # analytic factor-read bytes/token for currently-live slots
        # (same formula as serve.traces: L * kv_len * hkv * r * 4)
        cfg = engine.cfg
        hkv = cfg.num_kv_heads
        read_bpt = []
        if series:
            last = series[-1]
            for j, r in enumerate(last):
                if r >= 0:
                    read_bpt.append(float(cfg.num_layers)
                                    * float(engine.cache.lens[j])
                                    * hkv * float(r) * 4.0)
        return {
            "steps_recorded": len(series),
            # rank is uniform across layers in this engine (the decision
            # is driven by layer-0 spectra and applied to every layer),
            # so one series per slot IS the per-layer series
            "per_layer_uniform": True,
            "kept_rank": [[int(v) for v in row] for row in series],
            "mean_kept_rank": mean_rank,
            "rank_switches": switches,
            "veto_fires": veto,
            "basis_refreshes": self._c_refreshes.value,
            "drift_triggers": self._c_drift.value,
            "decisions": self._c_decisions.value,
            "read_bytes_per_token": (float(np.mean(read_bpt))
                                     if read_bpt else 0.0),
        }
