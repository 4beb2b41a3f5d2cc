"""Streaming serving API of the port (``repro.serve.api``): EngineConfig,
SamplingParams, ``Engine.submit() -> RequestHandle``.

    cfg = EngineConfig(n_slots=8, max_len=2048, prefill_chunk=128,
                       use_kernel=True)
    eng = Engine(model_cfg, params, config=cfg)          # device="cuda"
    h = eng.submit(prompt_ids, SamplingParams(max_new=64))
    for tok in h.tokens():          # drives eng.step() as needed
        ...
    # or: eng.run(); h.result()

``EngineConfig`` keeps the JAX field names and defaults; both chunked
prefill and one-shot prefill (``prefill_chunk=None``) are served. Knobs
this port does not serve yet raise ``NotImplementedError`` naming the
ROADMAP item: speculation, the prefix cache, the drift trigger, traces,
obs tracing, flight dumps, nucleus sampling, and any request with
temperature, top-k or top-p set. Greedy serving is
exact: a greedy row is the argmax whether or not sampling is compiled in.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import Request


@dataclass(frozen=True)
class SamplingParams:
    """Per-request generation knobs (greedy by default; only greedy is
    served by this port)."""
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
        if self.adaptive_draft and not self.speculative:
            raise ValueError("adaptive_draft requires speculative=True")


class EngineStopped(RuntimeError):
    """The engine serving a handle was reset mid-stream."""


@dataclass
class RequestHandle:
    """One submitted request: incremental tokens + completion state."""
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

    def tokens(self):
        """Generator of generated token ids, in order; drives
        ``engine.step()`` whenever it runs dry. Attaching a consumer makes
        the engine fetch emitted token values each step."""
        self._engine._ensure_streaming(self)
        i = 0
        while True:
            while i < len(self._toks):
                yield self._toks[i]
                i += 1
            if self.done:
                return
            self._check_stopped()
            self._engine.step()

    def result(self) -> np.ndarray:
        """Drive the engine until this request finishes; returns its
        generated ids."""
        while not self.done:
            self._check_stopped()
            self._engine.step()
        return self._result

    # -- called by Engine ------------------------------------------------

    def _feed(self, idx: int, tok: int) -> None:
        """Deliver token ``idx``, strictly in order."""
        if idx != len(self._toks) or self._stopped:
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
            nucleus=c.nucleus, prefix_cache=c.prefix_cache,
            speculative=c.speculative, record_traces=c.record_traces,
            obs_trace=c.obs_trace, flight_dir=c.flight_dir, device=device)
        self._handles: Dict[int, RequestHandle] = {}
        self._next_rid = 0
        self._finished_seen = 0
        self._streaming: set = set()     # rids with an attached consumer
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
        return h

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
                    out = self.core.out_buf[i, :st.n_out].tolist()
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
        step's wall time accrues into ``stats['decode_s']``."""
        with self._step_lock:
            stats = self.core.stats
            t0 = time.perf_counter()
            self.core.step()
            stats["decode_s"] += time.perf_counter() - t0
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
        self.core._sync_device()
        self.core.stats["decode_s"] += time.perf_counter() - t0
        with self._submit_lock:
            handles = list(self._handles.items())
        return {rid: h._result for rid, h in handles if h.done}

    def reset(self) -> None:
        """Drop all requests/handles; unfinished handles raise
        :class:`EngineStopped`."""
        with self._step_lock, self._submit_lock:
            for h in self._handles.values():
                h._mark_stopped()
            self.core.reset()
            self._handles.clear()
            self._finished_seen = 0
            self._streaming.clear()

    # -- introspection ---------------------------------------------------

    @property
    def stats(self) -> Dict:
        return self.core.stats

    def ranks_per_step(self) -> List[np.ndarray]:
        return self.core.ranks_per_step()
