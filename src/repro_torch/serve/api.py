"""Streaming serving API of the port (``repro.serve.api``): EngineConfig,
SamplingParams, ``Engine.submit() -> RequestHandle``.

    cfg = EngineConfig(n_slots=8, max_len=2048, prefill_chunk=128,
                       use_kernel=True)
    eng = Engine(model_cfg, params, config=cfg)          # device="cuda"
    h = eng.submit(prompt_ids, SamplingParams(max_new=64))
    for tok in h.tokens():          # drives eng.step() as needed
        ...
    # or: eng.run(); h.result()

    h2 = eng.submit(prompt_ids, SamplingParams(temperature=0.8, top_k=40,
                                               seed=7, max_new=64))
    h2.cancel()                     # queued: dropped; admitted: evicted

    spec = EngineConfig(n_slots=8, max_len=2048, prefill_chunk=128,
                        use_kernel=True, speculative=True, draft_k=4,
                        prefix_cache=True)      # both: tokens unchanged

    obs = EngineConfig(n_slots=8, max_len=2048, prefill_chunk=128,
                       use_kernel=True, record_traces="traces/",
                       obs_trace=True, flight_dir="flight/")
    eng = Engine(model_cfg, params, config=obs)
    ...; eng.run(); eng.core.trace.flush()          # commit the trace
    eng.obs.prometheus(); eng.obs.chrome_trace(); eng.obs.rank_telemetry(eng.core)

``EngineConfig`` keeps the JAX field names and defaults; both chunked
prefill and one-shot prefill (``prefill_chunk=None``) are served, and so
are seeded sampling (temperature, top-k, and top-p with ``nucleus=True``:
the JAX engine's tokens for the same seed), ``cancel``, the drift trigger
(``drift_threshold``), low-rank self-speculative decoding
(``speculative``, ``draft_k``, ``draft_rank_frac``, ``adaptive_draft``),
the shared-prefix radix cache (``prefix_cache``, ``prefix_pages``,
``snapshot_every``), serving traces (``record_traces``, read by
``train.serve_policy``), span and phase tracing (``obs_trace``) and
flight dumps (``flight_dir``). A greedy row is the argmax whether or not
sampling is on. With a ``serve.frontend.FrontEnd`` attached, a background
thread steps the engine and handles wait for delivery instead of stepping.
"""
from __future__ import annotations

import asyncio
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import Request


@dataclass(frozen=True)
class SamplingParams:
    """Per-request generation knobs (greedy by default). ``seed`` keys the
    request's draws: a sampled stream is a pure function of the request."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    max_new: int = 64
    eos_id: Optional[int] = None

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"negative temperature {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"negative top_k {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {self.max_new}")


@dataclass(frozen=True)
class EngineConfig:
    """Engine-level serving knobs (see ``repro.serve.api.EngineConfig``)."""
    n_slots: int = 4
    max_len: int = 256
    page_size: int = 16
    segment_len: Optional[int] = None
    max_new_cap: int = 256
    prefill_chunk: Optional[int] = 16
    use_kernel: bool = False
    drift_threshold: Optional[float] = None
    factor_cache: Optional[bool] = None
    prefix_cache: bool = False
    prefix_pages: Optional[int] = None
    time_per_token: bool = False
    sampling: bool = True
    nucleus: bool = False
    top_k_cap: int = 64
    buckets: Optional[Sequence[int]] = None
    speculative: bool = False
    draft_k: int = 4
    draft_rank_frac: float = 0.25
    snapshot_every: int = 1
    adaptive_draft: bool = False
    draft_shrink_below: float = 0.35
    draft_grow_above: float = 0.6
    record_traces: Optional[str] = None
    obs_trace: bool = False
    flight_dir: Optional[str] = None
    flight_capacity: int = 256

    def __post_init__(self):
        if self.flight_capacity < 1:
            raise ValueError(f"flight_capacity must be >= 1, got "
                             f"{self.flight_capacity}")
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {self.prefill_chunk}")
        if self.max_len < 1 or self.n_slots < 1 or self.page_size < 1:
            raise ValueError("n_slots/max_len/page_size must be >= 1")
        if self.prefix_cache and self.prefill_chunk is None:
            raise ValueError("prefix_cache requires chunked prefill "
                             "(set prefill_chunk)")
        if self.speculative and self.prefill_chunk is None:
            raise ValueError("speculative decode requires chunked prefill "
                             "(set prefill_chunk)")
        if self.speculative and self.draft_k < 1:
            raise ValueError(f"draft_k must be >= 1, got {self.draft_k}")
        if not 0.0 < self.draft_rank_frac <= 1.0:
            raise ValueError(f"draft_rank_frac must be in (0, 1], got "
                             f"{self.draft_rank_frac}")
        if self.snapshot_every < 1:
            raise ValueError(f"snapshot_every must be >= 1, got "
                             f"{self.snapshot_every}")
        if self.adaptive_draft and not self.speculative:
            raise ValueError("adaptive_draft requires speculative=True")


class EngineStopped(RuntimeError):
    """The engine serving a handle died, was shut down or was reset
    mid-stream: raised from a handle's iterators and ``result()`` instead of
    blocking forever."""


@dataclass
class RequestHandle:
    """One submitted request: incremental tokens + completion state. With a
    front-end stepping thread attached, consumers wait on the delivery
    condition; without one they drive ``engine.step()`` themselves. The
    same handle supports ``for tok in h.tokens()``, ``async for tok in h``,
    ``h.result()`` and the ``on_token`` callback."""
    rid: int
    prompt_len: int
    params: SamplingParams
    _engine: "Engine"
    _submit_s: float
    on_token: Optional[Callable[[int, int], None]] = None
    _toks: List[int] = field(default_factory=list)
    _result: Optional[np.ndarray] = None
    ttft_s: Optional[float] = None   # submit() -> first-token wall time
    done_s: Optional[float] = None   # submit() -> completion wall time
    replica: Optional[int] = None    # set by Router.submit
    cancelled: bool = False
    _stopped: bool = False
    _cv: threading.Condition = field(default_factory=threading.Condition)

    @property
    def done(self) -> bool:
        return self._result is not None

    def _check_stopped(self) -> None:
        if self._stopped:
            raise EngineStopped(
                f"request {self.rid}: engine stopped after "
                f"{len(self._toks)} token(s)")

    def _advance(self, i: int, poll_s: float = 0.05) -> None:
        """Block until token ``i`` exists (or the stream ended): wait on the
        delivery condition while a background thread steps the engine,
        drive ``engine.step()`` here otherwise."""
        if self._engine.driver_alive:
            with self._cv:
                if i >= len(self._toks) and not self.done \
                        and not self._stopped:
                    # timed: a driver that dies without marking its handles
                    # still unblocks this wait for a re-check
                    self._cv.wait(poll_s)
        else:
            self._check_stopped()
            self._engine.step()

    def tokens(self):
        """Generator of generated token ids, in order: it drives
        ``engine.step()`` whenever it runs dry, or, with a front-end
        stepping thread, waits for delivery. Attaching a consumer makes the
        engine fetch emitted token values each step. Raises
        :class:`EngineStopped` if the engine dies mid-stream; a
        ``cancel()`` ends the iteration cleanly."""
        self._engine._ensure_streaming(self)
        i = 0
        while True:
            while i < len(self._toks):
                yield self._toks[i]
                i += 1
            if self.done or self.cancelled:
                return
            self._check_stopped()
            self._advance(i)

    def __aiter__(self):
        """``async for tok in handle``: the blocking wait runs in a worker
        thread (``asyncio.to_thread``), so the event loop stays free to
        consume other handles."""
        self._engine._ensure_streaming(self)
        return self._agen()

    async def _agen(self):
        i = 0
        while True:
            tok = await asyncio.to_thread(self._next_blocking, i)
            if tok is None:
                return
            yield tok
            i += 1

    def _next_blocking(self, i: int) -> Optional[int]:
        """Token ``i`` (blocking), or None when the stream is over."""
        while True:
            if i < len(self._toks):
                return self._toks[i]
            if self.done or self.cancelled:
                return None
            self._check_stopped()
            self._advance(i)

    def result(self) -> np.ndarray:
        """Block until this request finishes; returns its generated ids
        (the ones delivered before a cancel). Raises
        :class:`EngineStopped` if the engine dies first."""
        while not self.done:
            self._check_stopped()
            self._advance(len(self._toks))
        return self._result

    def cancel(self) -> bool:
        """Abort this request: queued -> dropped, decoding or mid-prefill
        -> slot evicted and pages released. ``result()`` then returns the
        tokens delivered so far and iterators end; no token is delivered
        after cancel() returns. False if the request had already
        finished."""
        return self._engine.cancel(self.rid)

    # -- called by Engine ------------------------------------------------

    def _feed(self, idx: int, tok: int) -> None:
        """Deliver token ``idx``, strictly in order; a cancelled or stopped
        handle takes no more."""
        if idx != len(self._toks) or self.cancelled or self._stopped:
            return
        with self._cv:
            self._toks.append(tok)
            if self.ttft_s is None and idx == 0:
                self.ttft_s = time.perf_counter() - self._submit_s
            self._cv.notify_all()
        if self.on_token is not None:
            self.on_token(idx, tok)

    def _finish(self, out: np.ndarray, first_tok_t: Optional[float]) -> None:
        if first_tok_t is not None:
            with self._cv:
                if self.ttft_s is None:
                    self.ttft_s = first_tok_t - self._submit_s
        for i in range(len(self._toks), len(out)):
            self._feed(i, int(out[i]))
        with self._cv:
            self._result = np.asarray(out, np.int32)
            self.done_s = time.perf_counter() - self._submit_s
            self._cv.notify_all()

    def _mark_cancelled(self) -> None:
        """Seal the handle after an engine-level cancel: the result is
        whatever was delivered before the cut."""
        with self._cv:
            self.cancelled = True
            self._result = np.asarray(self._toks, np.int32)
            self.done_s = time.perf_counter() - self._submit_s
            self._cv.notify_all()

    def _mark_stopped(self) -> None:
        if self.done:
            return
        with self._cv:
            self._stopped = True
            self._cv.notify_all()


class Engine:
    """Request/response front end over :class:`ServeEngine`. Runs on
    ``device`` ("cuda" unless the caller asks for "cpu")."""

    def __init__(self, cfg: ModelConfig, params, policy_params=None, *,
                 config: Optional[EngineConfig] = None, device="cuda"):
        self.config = config or EngineConfig()
        c = self.config
        self.core = ServeEngine(
            cfg, params, policy_params,
            n_slots=c.n_slots, max_len=c.max_len, page_size=c.page_size,
            segment_len=c.segment_len, buckets=c.buckets,
            max_new_cap=c.max_new_cap, use_kernel=c.use_kernel,
            drift_threshold=c.drift_threshold,
            time_per_token=c.time_per_token, factor_cache=c.factor_cache,
            prefill_chunk=c.prefill_chunk, sampling=c.sampling,
            nucleus=c.nucleus, top_k_cap=c.top_k_cap,
            prefix_cache=c.prefix_cache, prefix_pages=c.prefix_pages,
            speculative=c.speculative, draft_k=c.draft_k,
            draft_rank_frac=c.draft_rank_frac,
            snapshot_every=c.snapshot_every,
            adaptive_draft=c.adaptive_draft,
            draft_shrink_below=c.draft_shrink_below,
            draft_grow_above=c.draft_grow_above,
            record_traces=c.record_traces,
            obs_trace=c.obs_trace, flight_dir=c.flight_dir,
            flight_capacity=c.flight_capacity, device=device)
        self._handles: Dict[int, RequestHandle] = {}
        self._next_rid = 0
        self._finished_seen = 0
        self._streaming: set = set()     # rids with an attached consumer
        # the background stepping thread (serve.frontend.FrontEnd) driving
        # this engine, if any: handles then wait for delivery
        self._driver = None
        # rid assignment, handle registration and the core queue append
        # form one critical section
        self._submit_lock = threading.Lock()
        # whole engine iterations are serialised; reentrant so an on_token
        # callback may drive the engine itself
        self._step_lock = threading.RLock()

    # -- request plane ---------------------------------------------------

    def submit(self, prompt, params: Optional[SamplingParams] = None, *,
               arrival: int = 0,
               on_token: Optional[Callable[[int, int], None]] = None
               ) -> RequestHandle:
        """Enqueue ``prompt`` (1-D int ids); fail-fast validation."""
        params = params or SamplingParams()
        with self._submit_lock:
            rid = self._next_rid
            req = Request(rid=rid, tokens=np.asarray(prompt, np.int32),
                          max_new=params.max_new, arrival=arrival,
                          eos_id=params.eos_id,
                          temperature=params.temperature,
                          top_k=params.top_k, top_p=params.top_p,
                          seed=params.seed)
            self.core.submit(req)             # may raise: rid not consumed
            self._next_rid += 1
            h = RequestHandle(rid=rid, prompt_len=len(req.tokens),
                              params=params, _engine=self,
                              _submit_s=time.perf_counter(),
                              on_token=on_token)
            self._handles[rid] = h
            if on_token is not None:
                self._streaming.add(rid)
                self.core._stream_sync = True
        drv = self._driver
        if drv is not None:
            drv.wake()                   # a parked stepping thread resumes
        return h

    @property
    def driver_alive(self) -> bool:
        """True while a background stepping thread owns the step loop."""
        drv = self._driver
        return drv is not None and drv.alive

    def cancel(self, rid: int) -> bool:
        """Abort a submitted request (see :meth:`RequestHandle.cancel`),
        under the step lock: no step is in flight while the slot is
        evicted, and no token is delivered after the handle is sealed.
        False if already finished or cancelled."""
        with self._step_lock:
            h = self._handles.get(rid)
            if h is None or h.done:
                return False
            self.core.cancel(rid)
            h._mark_cancelled()
            self._streaming.discard(rid)
            if not self._streaming:
                self.core._stream_sync = False
            return True

    def _ensure_streaming(self, handle: RequestHandle) -> None:
        if handle.done:
            return
        with self._step_lock:
            self._streaming.add(handle.rid)
            self.core._stream_sync = True
            self._backfill(handle)

    def _backfill(self, handle: RequestHandle) -> None:
        """Deliver tokens this handle's slot emitted before a consumer
        attached, straight from the device output buffer."""
        for i, st in enumerate(self.core.sched.slots):
            if st.active and st.req.rid == handle.rid:
                if st.n_out > len(handle._toks):
                    out = self.core.out_buf[i, :st.n_out].tolist()  # inv-ok-torch[R1]: one-off gap closure when a consumer attaches mid-stream, not on the step path
                    for j in range(len(handle._toks), st.n_out):
                        handle._feed(j, out[j])
                return

    # -- step loop -------------------------------------------------------

    def warmup(self) -> float:
        with self._step_lock:
            dt = self.core.warmup()
            # compile time is reported separately (stats['compile_s'])
            now = time.perf_counter()
            for h in self._handles.values():
                if not h.done and h.ttft_s is None:
                    h._submit_s = max(h._submit_s, now)
            return dt

    def step(self) -> bool:
        """One engine iteration; returns True while work remains. Each
        step's wall time, less the one-shot prefill that accrued inside it
        (``stats['prefill_s']``), accrues into ``stats['decode_s']``."""
        with self._step_lock:
            stats = self.core.stats
            p0 = stats["prefill_s"]
            t0 = time.perf_counter()
            self.core.step()
            stats["decode_s"] += max(
                time.perf_counter() - t0 - (stats["prefill_s"] - p0), 0.0)
            for rid, idx, tok in self.core.last_emitted:
                h = self._handles.get(rid)
                if h is not None:
                    if idx > len(h._toks):
                        self._backfill(h)
                    h._feed(idx, tok)
            finished = self.core.sched.finished
            for req, out in finished[self._finished_seen:]:
                h = self._handles.get(req.rid)
                if h is not None and not h.done:
                    h._finish(np.asarray(out, np.int32),
                              self.core.request_first_tok_t.get(req.rid))
                self._streaming.discard(req.rid)
            self._finished_seen = len(finished)
            if not self._streaming:
                self.core._stream_sync = False
            return not self.core.sched.done()

    def run(self, max_steps: Optional[int] = None) -> Dict[int, np.ndarray]:
        """Drive the loop until every submitted request finished."""
        steps = 0
        while self.step():
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        # attribute the tail of in-flight device work to decode time
        t0 = time.perf_counter()
        self.core._sync_device()  # inv-ok-torch[R1]: end-of-run drain before wall-clock accounting
        self.core.stats["decode_s"] += time.perf_counter() - t0
        with self._submit_lock:
            handles = list(self._handles.items())
        return {rid: h._result for rid, h in handles if h.done}

    def reset(self) -> None:
        """Drop all requests/handles; unfinished handles raise
        :class:`EngineStopped`. Safe with a live stepping thread: it is
        between iterations while the step lock is held, and its next
        step() sees an empty engine and parks."""
        with self._step_lock, self._submit_lock:
            if any(not h.done for h in self._handles.values()):
                # post-mortem record before the state is torn down
                self.core.obs.flight_dump("reset_with_live_requests")
            for h in self._handles.values():
                h._mark_stopped()
            self.core.reset()
            self._handles.clear()
            self._finished_seen = 0
            self._streaming.clear()

    def drain(self) -> None:
        """Block until every submitted request has finished (driving the
        loop here only when no stepping thread owns it)."""
        with self._submit_lock:
            handles = list(self._handles.values())
        for h in handles:
            if not h.cancelled:
                h.result()

    # -- introspection ---------------------------------------------------

    @property
    def stats(self) -> Dict:
        return self.core.stats

    @property
    def obs(self):
        """The core engine's ``repro_torch.obs.Observability`` bundle
        (metrics registry, span tracer, flight recorder, exporters)."""
        return self.core.obs

    @property
    def depth(self) -> int:
        """Queued + admitted requests: the router's load signal."""
        return self.core.depth

    def ranks_per_step(self) -> List[np.ndarray]:
        return self.core.ranks_per_step()

    def prefix_probe(self, prompt) -> int:
        """Longest cached-prefix length this engine could reuse for
        ``prompt`` now (0 without a prefix cache); read-only."""
        return self.core.prefix_probe(prompt)

    def accept_lens(self) -> Dict[int, List[int]]:
        """Per-request speculative accept runs: rid -> accepted tokens per
        speculative step (1 = every draft rejected, draft_k + 1 = all
        kept). Finished or cancelled requests only; empty without
        speculation."""
        return {rid: list(v)
                for rid, v in self.core.request_accept_lens.items()}

    def ttft(self) -> Dict[int, float]:
        """Per-request submit() -> first-token wall seconds (finished or
        streaming requests only)."""
        with self._submit_lock:
            handles = list(self._handles.items())
        return {rid: h.ttft_s for rid, h in handles if h.ttft_s is not None}


def make_engine(cfg: ModelConfig, params, policy_params=None, *,
                device="cuda", **knobs) -> Engine:
    """``make_engine(cfg, params, n_slots=8, max_len=512)``: the
    EngineConfig from keyword overrides."""
    return Engine(cfg, params, policy_params, config=EngineConfig(**knobs),
                  device=device)


class AdaptiveServer:
    """DEPRECATED lock-step front end over :class:`Engine`, kept as the
    reference keeps it: a (b, s0) prompt batch becomes b streams admitted
    at step 0 and decoded greedily for ``n_tokens`` each through one-shot
    prefill. New code builds an :class:`Engine` from an
    :class:`EngineConfig` and uses ``submit``/``RequestHandle``."""

    def __init__(self, cfg: ModelConfig, params, policy_params=None,
                 max_len: int = 2048, page_size: int = 16,
                 use_kernel: bool = False, time_per_token: bool = False,
                 factor_cache: Optional[bool] = None, *, device="cuda"):
        warnings.warn(
            "AdaptiveServer is deprecated; use repro_torch.serve.api.Engine "
            "(EngineConfig + submit/RequestHandle) instead",
            DeprecationWarning, stacklevel=2)
        self.cfg = cfg
        self.params = params
        self.policy = policy_params
        self.max_len = max_len
        self.page_size = page_size
        self.use_kernel = use_kernel
        self.time_per_token = time_per_token
        self.factor_cache = factor_cache
        self.device = device
        self._engines: Dict[tuple, Engine] = {}

    def _engine(self, n_slots: int, seg: int, max_new: int) -> Engine:
        key = (n_slots, seg, max_new)
        eng = self._engines.get(key)
        if eng is None:
            eng = Engine(self.cfg, self.params, self.policy,
                         config=EngineConfig(
                             n_slots=n_slots, max_len=self.max_len,
                             page_size=self.page_size, segment_len=seg,
                             max_new_cap=max_new, prefill_chunk=None,
                             sampling=False, use_kernel=self.use_kernel,
                             time_per_token=self.time_per_token,
                             factor_cache=self.factor_cache),
                         device=self.device)
            self._engines[key] = eng
        else:
            eng.reset()
        return eng

    def generate(self, prompts, n_tokens: int,
                 segment_len: Optional[int] = None) -> Dict:
        """prompts: (b, s0) ints. Greedy decode of n_tokens per stream.
        Returns tokens (b, n_tokens), the per-step per-stream ranks,
        warm-decode ``tok_per_s`` and the separate ``compile_s`` /
        ``prefill_s``."""
        seg = segment_len or self.cfg.rank.segment_len
        prompts_np = np.asarray(prompts, np.int32)
        b = prompts_np.shape[0]
        eng = self._engine(b, seg, n_tokens)
        handles = [eng.submit(prompts_np[i], SamplingParams(max_new=n_tokens))
                   for i in range(b)]
        eng.warmup()
        eng.run()
        tokens = np.stack([h.result() for h in handles])
        core = eng.core
        s = core.stats
        return {
            "tokens": tokens,
            "ranks": [r.tolist() for r in core.ranks_per_step()],
            "tok_per_s": s["tokens_decoded"] / max(s["decode_s"], 1e-9),
            "compile_s": s["compile_s"],
            "prefill_s": s["prefill_s"],
            "token_lat_s": list(core.token_latencies),
            "ttft_s": [h.ttft_s for h in handles],
            "stats": dict(s),
        }
