"""Span tracing for the port's serving loop (``repro.obs.tracing``):
Chrome trace-event JSON.

Two timelines share one event buffer:

* **Per-request spans** — an async track per request id spanning
  admission -> finish/cancel, with instant events for prefill chunks,
  rank decisions, first token and speculative accept runs pinned to the
  slot's thread lane.
* **Per-step phase timeline** — each engine step is sliced into named
  phases (``schedule`` / ``admit`` / ``decide`` / ``dispatch`` /
  ``fetch`` / ``deliver``) emitted as complete ("X") events, so the gap
  between "the fused step was dispatched" and "tokens were delivered"
  is visible per step in Perfetto.

The output of :meth:`SpanTracer.chrome_trace` is the stable Chrome
trace-event format (``{"traceEvents": [...]}``): load it at
https://ui.perfetto.dev or chrome://tracing. :func:`validate_chrome_trace`
checks a document against the subset of the schema this module emits —
the bench/CI path validates every emitted trace before upload.

Everything here is host-side Python over ``time.perf_counter``, with no
torch calls, so tracing cannot introduce device syncs.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

# step phases, in loop order. "schedule" covers eviction + slot harvest,
# "admit" the admission/prefill work, "decide" rank re-decisions +
# control-state sync, "dispatch" the fused step call, "fetch" the
# sanctioned host fetches, "deliver" per-slot host bookkeeping/streaming.
PHASES = ("schedule", "admit", "decide", "dispatch", "fetch", "deliver")

_VALID_PH = {"X", "B", "E", "b", "e", "n", "i", "I", "C", "M"}


class Stopwatch:
    """One wall-clock interval, optionally disabled: the shared shape of
    every timing block in the engine (compile, one-shot prefill,
    per-step token latency, run wall). ``stop()`` returns the elapsed
    seconds, or None when constructed disabled — matching the engine's
    historical ``t0 = perf_counter() if enabled else None`` idiom."""

    __slots__ = ("t0", "dt")

    def __init__(self, enabled: bool = True):
        self.t0 = time.perf_counter() if enabled else None
        self.dt: Optional[float] = None

    def stop(self) -> Optional[float]:
        if self.t0 is not None:
            self.dt = time.perf_counter() - self.t0
        return self.dt

    def __enter__(self) -> "Stopwatch":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


class SpanTracer:
    """Bounded in-memory Chrome trace-event collector. Events beyond
    ``capacity`` are dropped (counted in ``dropped``) rather than grown
    without bound — a serving process is long-lived."""

    def __init__(self, *, pid: int = 0, capacity: int = 200_000):
        self.pid = pid
        self.capacity = capacity
        self.events: List[Dict[str, Any]] = []
        self.dropped = 0
        self._t0 = time.perf_counter()

    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def clear(self) -> None:
        self.events = []
        self.dropped = 0
        self._t0 = time.perf_counter()

    def _push(self, ev: Dict[str, Any]) -> None:
        if len(self.events) >= self.capacity:
            self.dropped += 1
            return
        self.events.append(ev)

    def complete(self, name: str, ts_us: float, dur_us: float, *,
                 tid: int = 0, cat: str = "step",
                 args: Optional[Dict[str, Any]] = None) -> None:
        ev = {"name": name, "ph": "X", "cat": cat, "pid": self.pid,
              "tid": tid, "ts": ts_us, "dur": max(dur_us, 0.0)}
        if args:
            ev["args"] = args
        self._push(ev)

    def instant(self, name: str, *, tid: int = 0, cat: str = "step",
                args: Optional[Dict[str, Any]] = None,
                ts_us: Optional[float] = None) -> None:
        ev = {"name": name, "ph": "i", "s": "t", "cat": cat,
              "pid": self.pid, "tid": tid,
              "ts": self.now_us() if ts_us is None else ts_us}
        if args:
            ev["args"] = args
        self._push(ev)

    def async_begin(self, name: str, aid, *, cat: str = "request",
                    args: Optional[Dict[str, Any]] = None) -> None:
        ev = {"name": name, "ph": "b", "cat": cat, "id": str(aid),
              "pid": self.pid, "tid": 0, "ts": self.now_us()}
        if args:
            ev["args"] = args
        self._push(ev)

    def async_end(self, name: str, aid, *, cat: str = "request",
                  args: Optional[Dict[str, Any]] = None) -> None:
        ev = {"name": name, "ph": "e", "cat": cat, "id": str(aid),
              "pid": self.pid, "tid": 0, "ts": self.now_us()}
        if args:
            ev["args"] = args
        self._push(ev)

    def counter(self, name: str, values: Dict[str, float],
                *, ts_us: Optional[float] = None) -> None:
        self._push({"name": name, "ph": "C", "cat": "metric",
                    "pid": self.pid, "tid": 0,
                    "ts": self.now_us() if ts_us is None else ts_us,
                    "args": dict(values)})

    def chrome_trace(self,
                     metadata: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """The full trace document (JSON-serialisable, schema-valid)."""
        doc: Dict[str, Any] = {
            "traceEvents": list(self.events),
            "displayTimeUnit": "ms",
        }
        meta = {"dropped_events": self.dropped}
        if metadata:
            meta.update(metadata)
        doc["otherData"] = meta
        return doc


def validate_chrome_trace(doc: Any) -> List[str]:
    """Validate ``doc`` against the trace-event schema subset this module
    emits. Returns a list of problems — empty means valid. Used by the
    exporter tests and by examples/serve_observe.py before CI uploads
    the artifact."""
    errs: List[str] = []
    if not isinstance(doc, dict):
        return ["document is not a JSON object"]
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    open_async: Dict[tuple, int] = {}
    for n, ev in enumerate(evs):
        where = f"traceEvents[{n}]"
        if not isinstance(ev, dict):
            errs.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _VALID_PH:
            errs.append(f"{where}: bad ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errs.append(f"{where}: missing name")
        for k in ("pid", "tid"):
            if not isinstance(ev.get(k), int):
                errs.append(f"{where}: missing int {k}")
        if ph != "M" and not isinstance(ev.get("ts"), (int, float)):
            errs.append(f"{where}: missing ts")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"{where}: X event needs dur >= 0")
        if ph in ("b", "e", "n"):
            if "id" not in ev:
                errs.append(f"{where}: async event needs id")
            else:
                key = (ev.get("cat"), ev.get("name"), str(ev["id"]))
                if ph == "b":
                    open_async[key] = open_async.get(key, 0) + 1
                elif ph == "e":
                    if open_async.get(key, 0) <= 0:
                        errs.append(f"{where}: async end without begin {key}")
                    else:
                        open_async[key] -= 1
        if ph == "C" and not isinstance(ev.get("args"), dict):
            errs.append(f"{where}: counter event needs args")
    return errs


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _NullPhases:
    """Phase recorder used when tracing is off: ``ph("decide")`` costs
    one attribute call and returns a shared no-op context manager — the
    engine's hot loop pays nothing measurable for the instrumentation
    points."""

    __slots__ = ()
    _ctx = _NullCtx()

    def __call__(self, name: str) -> _NullCtx:
        return self._ctx


NULL_PHASES = _NullPhases()


class _PhaseCtx:
    __slots__ = ("sp", "name", "t0")

    def __init__(self, sp: "StepPhases", name: str):
        self.sp = sp
        self.name = name
        self.t0 = 0.0

    def __enter__(self):
        self.t0 = self.sp.tracer.now_us()
        return self

    def __exit__(self, *exc):
        sp, t1 = self.sp, self.sp.tracer.now_us()
        dur = t1 - self.t0
        sp.tracer.complete(self.name, self.t0, dur, tid=sp.tid,
                           cat="phase", args={"step": sp.step})
        h = sp.hists.get(self.name) if sp.hists else None
        if h is not None:
            h.observe(dur * 1e-6)
        return False


class StepPhases:
    """Live phase recorder for ONE engine step: each ``with ph(name):``
    block becomes a complete event on the step lane plus an observation
    in that phase's duration histogram."""

    __slots__ = ("tracer", "step", "hists", "tid")

    def __init__(self, tracer: SpanTracer, step: int,
                 hists: Optional[Dict[str, Any]] = None, *, tid: int = 1000):
        self.tracer = tracer
        self.step = step
        self.hists = hists
        self.tid = tid

    def __call__(self, name: str) -> _PhaseCtx:
        return _PhaseCtx(self, name)
