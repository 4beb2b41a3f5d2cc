"""Request queue + slot admission/eviction for the serving engine (a copy
of ``repro.serve.scheduler``, which is numpy only).

Control plane only: everything here is host-side Python over tiny arrays.
The data plane (pools, fused step) lives in kv_cache.py / engine.py.

Admission is FIFO over *arrived* requests: a request joins a free slot as
soon as one exists, its arrival step has passed, and the page pool can
cover ``prompt_len + max_new`` tokens (under prefix caching the
``can_allocate`` hook also matches the prompt against the radix tree and
shares the hit's pages). Prefill lengths are bucketed (powers of two by
default) so the prefill executable compiles once per bucket, not once per
prompt length. Eviction happens on EOS or when ``max_new`` tokens have
been decoded; releasing a slot *decrements* its pages' refcounts — a page
returns to the pool when its last reference (sharing slot or cached
prefix) drops.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Request:
    """One generation request. ``tokens`` is the prompt (1-D int array).

    ``temperature``/``top_k``/``top_p``/``seed`` are the in-graph sampling
    knobs (serve.api.SamplingParams maps onto them): temperature 0
    is greedy argmax; top_k 0 samples the full vocabulary; top_p 1
    disables the nucleus cut; the seed keys a per-token PRNG fold so a
    stream's draw sequence is reproducible regardless of engine
    batching."""
    rid: int
    tokens: np.ndarray
    max_new: int
    arrival: int = 0                 # engine step at which it may be admitted
    eos_id: Optional[int] = None
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32).reshape(-1)
        if self.tokens.size == 0:
            raise ValueError("empty prompt")
        if self.max_new < 1:
            raise ValueError("max_new must be >= 1")
        if self.arrival < 0:
            raise ValueError(f"negative arrival step {self.arrival}")
        if self.temperature < 0.0:
            raise ValueError(f"negative temperature {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"negative top_k {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")


@dataclass
class SlotState:
    req: Optional[Request] = None
    prompt_len: int = 0
    prefilled: int = 0     # prompt tokens written so far (chunked prefill)
    decode_i: int = 0      # fused decode steps taken for this stream
    t: int = 0             # segment counter (annealed-threshold clock)
    n_out: int = 0         # tokens produced so far (prefill token included)
    last_tok: Optional[int] = None   # synced from device only when eos_id set
    # wall-clock per-token latencies (filled by the engine when timing)
    latencies: List[float] = field(default_factory=list)
    admit_s: float = 0.0   # perf_counter at admission (TTFT reference)
    # speculative decode: accepted run length (incl. the free verify
    # token) of each fused step this stream decoded in — 1 means every
    # draft was rejected, draft_k + 1 means all survived
    accept_lens: List[int] = field(default_factory=list)

    @property
    def active(self) -> bool:
        return self.req is not None

    @property
    def mid_prefill(self) -> bool:
        """True while a chunked prompt is still being consumed. A slot in
        this state owns its pages and its queue identity: it must never be
        double-admitted (``active`` covers that) nor evicted early — it has
        produced no token yet, so neither EOS nor max_new can apply."""
        return self.req is not None and self.prefilled < self.prompt_len


def prefill_buckets(max_prompt: int, floor: int = 8) -> Tuple[int, ...]:
    """Power-of-two length buckets covering [1, max_prompt].

    The top bucket is clamped to ``max_prompt``: for non-power-of-two
    maxima (e.g. 100) the unclamped doubling would emit a bucket (128)
    larger than any slot can hold, compiling a prefill executable and
    cache no request is ever allowed to fill."""
    out, b = [], floor
    while b < max_prompt:
        out.append(b)
        b *= 2
    out.append(min(b, max_prompt))
    return tuple(out)


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    raise ValueError(f"prompt length {length} exceeds largest bucket "
                     f"{buckets[-1]}")


class Scheduler:
    """FIFO admission over n_slots decode lanes."""

    def __init__(self, n_slots: int, buckets: Sequence[int]):
        self.n_slots = n_slots
        self.buckets = tuple(buckets)
        self.pending: Deque[Request] = deque()
        self.slots = [SlotState() for _ in range(n_slots)]
        self.finished: List[Tuple[Request, List[int]]] = []

    def submit(self, req: Request) -> None:
        bucket_for(len(req.tokens), self.buckets)   # validate early
        self.pending.append(req)

    # -- admission -------------------------------------------------------

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if not s.active]

    def admit(self, now: int, can_allocate) -> List[Tuple[int, Request, int]]:
        """Assign arrived requests to free slots, FIFO. ``can_allocate(slot,
        total_len) -> bool`` is the page-pool reservation hook. Returns
        [(slot, request, padded_prefill_bucket)]. A head-of-queue request
        that cannot be placed (pages exhausted) blocks the queue — FIFO, no
        starvation via overtaking."""
        placed = []
        free = self.free_slots()
        while free and self.pending and self.pending[0].arrival <= now:
            req = self.pending[0]
            slot = free[0]
            if not can_allocate(slot, len(req.tokens) + req.max_new):
                break
            self.pending.popleft()
            free.pop(0)
            st = self.slots[slot]
            st.req, st.prompt_len = req, len(req.tokens)
            st.prefilled = 0
            st.decode_i, st.t = 0, 0
            st.n_out, st.last_tok = 0, None
            st.latencies = []
            st.accept_lens = []
            placed.append((slot, req, bucket_for(len(req.tokens), self.buckets)))
        return placed

    def cancel_pending(self, rid: int) -> bool:
        """Drop a not-yet-admitted request from the queue. Returns True
        if it was found (and removed); an admitted request is the
        engine's to cancel — its slot and pages must be released too."""
        for i, req in enumerate(self.pending):
            if req.rid == rid:
                del self.pending[i]
                return True
        return False

    def depth(self) -> int:
        """Requests in the system: queued + admitted (live slots). The
        router's load signal."""
        return len(self.pending) + self.n_live()

    # -- eviction --------------------------------------------------------

    def should_evict(self, slot: int) -> bool:
        st = self.slots[slot]
        if not st.active:
            return False
        if st.mid_prefill:
            # a chunked prompt still in flight: no token exists yet, so
            # EOS / max_new cannot have fired — and a stale ``last_tok``
            # from a previous occupant must never evict the new stream
            return False
        if st.n_out >= st.req.max_new:
            return True
        eos = st.req.eos_id
        return eos is not None and st.last_tok == eos

    def evict(self, slot: int, release, outputs: List[int]) -> Request:
        """Finish the stream in ``slot``; ``release(slot)`` frees pages."""
        st = self.slots[slot]
        req = st.req
        self.finished.append((req, list(outputs)))
        release(slot)
        st.req = None
        return req

    def n_live(self) -> int:
        return sum(s.active for s in self.slots)

    def done(self) -> bool:
        return not self.pending and self.n_live() == 0
