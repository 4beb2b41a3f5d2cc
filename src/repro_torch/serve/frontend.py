"""Async serving front door + multi-replica router of the port
(``repro.serve.frontend``).

- :class:`FrontEnd` — one background **stepping thread** per
  :class:`repro_torch.serve.api.Engine`, driving ``step()`` continuously so
  the card never idles while the host admits, streams, or simply
  has no consumer attached. Handles returned by ``submit`` are the
  ordinary :class:`repro_torch.serve.api.RequestHandle` — with a front end
  attached their iterators (``for tok in h.tokens()``,
  ``async for tok in h``) and ``result()`` *wait for delivery* instead
  of stepping the engine themselves. The thread parks on an event when
  the engine runs dry and wakes on the next submit; ``shutdown()``
  stops, drains in-flight device work and joins, marking unfinished
  handles stopped so no consumer blocks forever
  (:class:`repro_torch.serve.api.EngineStopped`). On the card the thread
  launches on the engine's device (it calls ``torch.cuda.set_device``), and
  a kernel error it meets is re-raised from ``drain()`` / ``submit()``.

- :class:`Router` — owns N engine replicas (one :class:`FrontEnd`
  each) and dispatches every ``submit()`` with **prefix-cache
  affinity**: the prompt is probed (read-only) against every replica's
  radix tree and routes to the replica already holding its longest
  cached prefix, so shared-system-prompt traffic keeps landing where
  the prefix is warm instead of being sprayed across the fleet and
  re-prefilled N times. Prompts with no useful prefix — and affinity
  hits whose replica is overloaded beyond ``depth_slack`` — fall back
  to least-loaded by queue depth. Per-replica and aggregate stats
  (``depth``, ``hit_rate``, ``stall_s``, ``tok_per_s``) come from
  :meth:`Router.stats`. All replicas are built on the caller's device:
  on the card that is N engines sharing one GPU in one process, each with
  its own stepping thread (they share the GIL and the device).

- :class:`FleetConfig` — the one runtime-options surface for a fleet
  (engine knobs x replica count x routing knobs), after Alpa's
  ``GlobalConfig`` idiom: every option lives in one flat, documented
  object that is validated up front and threaded through construction,
  instead of a kwarg pile per layer.

    fleet = FleetConfig(engine=EngineConfig(n_slots=4, prefix_cache=True),
                        n_replicas=2)
    router = Router(cfg, params, fleet=fleet)          # device="cuda"
    h = router.submit(prompt_ids, SamplingParams(max_new=64))
    async for tok in h:          # or: for tok in h.tokens()
        ...
    router.shutdown()
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.obs import aggregate, aggregate_registry
from repro_torch.serve.api import (Engine, EngineConfig, EngineStopped,
                                   RequestHandle, SamplingParams)

ROUTING_MODES = ("affinity", "least_loaded", "round_robin")


@dataclass(frozen=True)
class FleetConfig:
    """Runtime options for an engine fleet (Alpa ``GlobalConfig`` idiom:
    one validated options object instead of per-layer kwarg piles).

    ``engine`` is the per-replica :class:`EngineConfig` (every replica
    is identical — heterogeneous fleets would break token parity across
    routing decisions). ``routing`` picks the dispatch policy:

    - ``"affinity"`` (default): longest cached-prefix match wins when it
      reuses at least ``affinity_min_tokens`` tokens AND that replica's
      queue depth is within ``depth_slack`` of the shallowest — cache
      locality is worth a short wait, not a convoy; otherwise fall back
      to least-loaded. Without ``engine.prefix_cache`` this degrades to
      least-loaded.
    - ``"least_loaded"``: minimum queue depth (pending + admitted),
      first-index tiebreak (bursts self-spread: every dispatch deepens
      its replica).
    - ``"round_robin"``: strict rotation (the affinity baseline).

    ``idle_poll_s`` bounds how long a parked stepping thread sleeps
    between wake checks; ``warmup`` compiles each replica's executables
    at construction (before its thread starts) so first tokens are not
    billed compile time."""
    engine: EngineConfig = field(default_factory=EngineConfig)
    n_replicas: int = 2
    routing: str = "affinity"
    affinity_min_tokens: int = 8
    depth_slack: int = 4
    idle_poll_s: float = 0.05
    warmup: bool = True

    def __post_init__(self):
        if self.n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {self.n_replicas}")
        if self.routing not in ROUTING_MODES:
            raise ValueError(f"routing must be one of {ROUTING_MODES}, "
                             f"got {self.routing!r}")
        if self.affinity_min_tokens < 1:
            raise ValueError("affinity_min_tokens must be >= 1")
        if self.depth_slack < 0:
            raise ValueError("depth_slack must be >= 0")
        if self.idle_poll_s <= 0:
            raise ValueError("idle_poll_s must be > 0")


class FrontEnd:
    """Background stepping thread over one :class:`Engine`.

    The thread loops ``engine.step()`` while work remains, then parks on
    a wake event; ``submit()`` (and ``Engine.submit`` directly — the
    engine wakes its driver) unparks it. All handle consumption becomes
    passive: iterators and ``result()`` wait on the per-handle delivery
    condition instead of stepping.

    Lifecycle: the thread starts in the constructor (after an optional
    warmup compile) and runs until ``shutdown()``. A step that raises
    stores the error, marks every unfinished handle stopped (consumers
    get :class:`EngineStopped`, never a silent hang) and exits the
    thread; ``drain()``/``submit()`` re-raise the stored error."""

    _SEQ = 0

    def __init__(self, engine: Engine, *, idle_poll_s: float = 0.05,
                 warmup: bool = True, name: Optional[str] = None):
        self.engine = engine
        self.idle_poll_s = idle_poll_s
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._idle_cv = threading.Condition()
        self._error: Optional[BaseException] = None
        # the card the stepping thread launches on: the engine's, or for a
        # bare "cuda" the constructing thread's current one
        dev = engine.core.device
        self._cuda_index = (None if dev.type != "cuda" else dev.index
                            if dev.index is not None else torch.cuda.current_device())
        if warmup:
            engine.warmup()          # thread not started yet: no race
        FrontEnd._SEQ += 1
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=name or f"serve-frontend-{FrontEnd._SEQ}")
        engine._driver = self
        self._thread.start()

    # -- stepping thread -------------------------------------------------

    def _loop(self) -> None:
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)
        while not self._stop.is_set():
            self._wake.clear()
            try:
                busy = self.engine.step()
            # deliberately BaseException, not Exception: the loop must
            # never die silently — record the error, strand no consumer
            except BaseException as e:
                self._error = e
                # dump the flight ring first: the crash context (the
                # events leading up to the failing step) must land on
                # disk before handles observe EngineStopped
                self.engine.core.obs.flight_dump("step_exception", error=e)
                self._abort_handles()
                with self._idle_cv:
                    self._idle_cv.notify_all()
                return
            if not busy:
                with self._idle_cv:
                    self._idle_cv.notify_all()
                # park until the next submit (the timed wait re-checks
                # stop so shutdown never waits a full poll interval)
                self._wake.wait(timeout=self.idle_poll_s)
        with self._idle_cv:
            self._idle_cv.notify_all()

    def wake(self) -> None:
        """Unpark the stepping thread (called on every submit)."""
        self._wake.set()

    @property
    def alive(self) -> bool:
        return self._thread.is_alive() and not self._stop.is_set()

    def _raise_if_dead(self) -> None:
        if self._error is not None:
            raise EngineStopped(
                "front-end stepping thread died") from self._error
        if not self.alive:
            raise EngineStopped("front end is shut down")

    # -- request plane ---------------------------------------------------

    def submit(self, prompt, params: Optional[SamplingParams] = None, *,
               arrival: int = 0,
               on_token: Optional[Callable[[int, int], None]] = None
               ) -> RequestHandle:
        """Enqueue a prompt and wake the stepping thread. Same contract
        (and fail-fast validation) as :meth:`Engine.submit`."""
        self._raise_if_dead()
        return self.engine.submit(prompt, params, arrival=arrival,
                                  on_token=on_token)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until the engine has no queued or admitted request.
        Returns False on timeout; raises :class:`EngineStopped` if the
        stepping thread died (or was shut down) with work in flight."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._idle_cv:
            while not self.engine.core.sched.done():
                self._raise_if_dead()
                left = (None if deadline is None
                        else deadline - time.perf_counter())
                if left is not None and left <= 0:
                    return False
                self._idle_cv.wait(min(self.idle_poll_s,
                                       left or self.idle_poll_s))
        return True

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop the stepping thread: optionally drain first, then signal
        stop, join, and mark every unfinished handle stopped so blocked
        consumers raise :class:`EngineStopped` instead of hanging.
        Idempotent."""
        if drain and self.alive:
            try:
                self.drain(timeout)
            except EngineStopped:
                pass                       # already dead: still join below
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=30.0)
        # last-breath state (only when a dump dir is configured; a step
        # exception already dumped — this records the shutdown marker)
        self.engine.core.obs.record_event("shutdown")
        self.engine.core.obs.flight_dump("shutdown")
        self._abort_handles()

    def _abort_handles(self) -> None:
        with self.engine._submit_lock:
            handles = list(self.engine._handles.values())
        for h in handles:
            h._mark_stopped()

    def __enter__(self) -> "FrontEnd":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=exc == (None, None, None))

    # -- introspection ---------------------------------------------------

    def stats(self) -> Dict:
        """Live serving stats: queue ``depth``, prefix ``hit_rate``,
        admission ``stall_s``, decode ``tok_per_s``, speculative
        ``spec_accept_rate`` / ``spec_mean_accept`` (0 on a
        non-speculative engine), plus the raw engine counters under
        ``"engine"``."""
        s = dict(self.engine.stats)
        looked = s["prefix_hits"] + s["prefix_misses"]
        return {
            "depth": self.engine.depth,
            "hit_rate": s["prefix_hits"] / max(looked, 1),
            "stall_s": s["stall_s"],
            "tok_per_s": s["tokens_decoded"] / max(s["decode_s"], 1e-9),
            "tokens_decoded": s["tokens_decoded"],
            "spec_accept_rate":
                s["spec_accepted"] / max(s["spec_drafted"], 1),
            "spec_mean_accept":
                s["spec_tokens"]
                / max(s["spec_tokens"] - s["spec_accepted"], 1),
            "alive": self.alive,
            "engine": s,
        }


class Router:
    """N engine replicas behind one ``submit()``.

    Dispatch is by queue depth with prefix-cache affinity (see
    :class:`FleetConfig.routing`): each submit probes every replica's
    radix tree read-only for the prompt's longest cached prefix and
    routes to the warm replica when the reuse is worth it, otherwise to
    the least-loaded. Replicas are data-parallel and independent — one
    process here, but nothing in the dispatch path reads replica
    internals other than ``depth`` and the prefix probe, both cheap and
    lock-protected, so replicas can move behind a device/process
    boundary without touching the fused step."""

    def __init__(self, cfg: ModelConfig, params, policy_params=None, *,
                 fleet: Optional[FleetConfig] = None, device="cuda"):
        self.fleet = fleet or FleetConfig()
        f = self.fleet
        self.replicas: List[FrontEnd] = [
            FrontEnd(Engine(cfg, params, policy_params, config=f.engine,
                            device=device),
                     idle_poll_s=f.idle_poll_s, warmup=f.warmup,
                     name=f"serve-replica-{i}")
            for i in range(f.n_replicas)]
        self._rr = 0                      # round-robin cursor
        self._lock = threading.Lock()     # dispatch decision is atomic
        self.routed: List[int] = [0] * f.n_replicas
        self.route_kinds = {"affinity": 0, "least_loaded": 0,
                            "round_robin": 0}

    # -- dispatch --------------------------------------------------------

    def _pick(self, prompt) -> tuple:
        f = self.fleet
        depths = [fe.engine.depth for fe in self.replicas]
        if f.routing == "round_robin":
            i = self._rr
            self._rr = (self._rr + 1) % len(self.replicas)
            return i, "round_robin"
        if f.routing == "affinity" and f.engine.prefix_cache:
            best, best_len = -1, 0
            for i, fe in enumerate(self.replicas):
                n = fe.engine.prefix_probe(prompt)
                # longer prefix wins; equal prefixes go to the shallower
                # queue
                if n > best_len or (n == best_len and n > 0
                                    and depths[i] < depths[best]):
                    best, best_len = i, n
            if (best_len >= f.affinity_min_tokens
                    and depths[best] <= min(depths) + f.depth_slack):
                return best, "affinity"
        return int(np.argmin(depths)), "least_loaded"

    def submit(self, prompt, params: Optional[SamplingParams] = None, *,
               arrival: int = 0,
               on_token: Optional[Callable[[int, int], None]] = None
               ) -> RequestHandle:
        """Route ``prompt`` to a replica and submit it there. The handle
        remembers its replica index (``handle.replica``)."""
        with self._lock:
            idx, kind = self._pick(prompt)
            self.routed[idx] += 1
            self.route_kinds[kind] += 1
        h = self.replicas[idx].submit(prompt, params, arrival=arrival,
                                      on_token=on_token)
        h.replica = idx
        return h

    # -- lifecycle -------------------------------------------------------

    def drain(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.perf_counter() + timeout
        for fe in self.replicas:
            left = (None if deadline is None
                    else max(deadline - time.perf_counter(), 0.0))
            if not fe.drain(left):
                return False
        return True

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        for fe in self.replicas:
            fe.shutdown(drain=drain, timeout=timeout)

    def reset(self) -> None:
        """Reset every replica (handles stopped, prefix trees cleared);
        the stepping threads stay up and park until the next submit."""
        for fe in self.replicas:
            fe.engine.reset()
        with self._lock:
            self._rr = 0
            self.routed = [0] * len(self.replicas)
            for k in self.route_kinds:
                self.route_kinds[k] = 0

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=exc == (None, None, None))

    # -- introspection ---------------------------------------------------

    def stats(self) -> Dict:
        """Per-replica stats plus fleet aggregates. ``tok_per_s`` sums
        replica decode rates (each replica's decode clock runs only while
        it steps); wall-clock fleet throughput is total tokens over the
        caller's own wall interval."""
        per = [fe.stats() for fe in self.replicas]
        tokens = sum(p["tokens_decoded"] for p in per)
        looked = sum(p["engine"]["prefix_hits"] + p["engine"]["prefix_misses"]
                     for p in per)
        hits = sum(p["engine"]["prefix_hits"] for p in per)
        return {
            "replicas": per,
            "aggregate": {
                "depth": sum(p["depth"] for p in per),
                "tokens_decoded": tokens,
                "hit_rate": hits / max(looked, 1),
                "stall_s": sum(p["stall_s"] for p in per),
                "tok_per_s": sum(p["tok_per_s"] for p in per),
            },
            "routed": list(self.routed),
            "route_kinds": dict(self.route_kinds),
        }

    def obs_snapshot(self) -> Dict:
        """Fleet-level metrics rollup: every replica's registry shard
        merged at read time (counters/gauges sum, histograms merge
        bucket-wise), plus the per-replica snapshots. Read-side only —
        no replica lock is taken and no step loop is touched."""
        per = [fe.engine.obs.snapshot() for fe in self.replicas]
        return {
            "fleet": aggregate([fe.engine.obs.registry
                                for fe in self.replicas]),
            "replicas": per,
        }

    def prometheus(self, namespace: str = "repro") -> str:
        """Prometheus text exposition for the whole fleet (merged
        registries; one scrape endpoint per router)."""
        merged = aggregate_registry([fe.engine.obs.registry
                                     for fe in self.replicas])
        return merged.prometheus_text(namespace)
