"""Deterministic scenario workload suite for the port's serving stack
(``repro.serve.workloads``, plain numpy: the same requests for the same
seed).

Named, seeded generators covering the traffic shapes the trace subsystem
trains and evaluates on: **bursty** arrival clumps, **long_context**
prompts near the slot capacity, **shared_prefix** chat turns over a
handful of system prompts, and **mixed_sampling** batches interleaving
greedy / top-k / nucleus rows. Every generator is a pure function of
``(seed, scale knobs)``; arrivals are scheduler ticks, never wall clock,
so a workload replays bit-identically across runs and across the two
packages (tests/test_torch_traces.py). The suite feeds trace generation
(``repro_torch.serve.traces.TraceRecorder`` records the per-segment rank
decisions the offline trainer learns from) and replay.

Each spec is a list of request dicts (the kwargs of
``repro_torch.serve.Request`` minus ``rid``) plus the engine knob overrides the
scenario needs (e.g. shared_prefix wants a prefix cache); ``build()``
turns one into submit-ready ``Request`` objects.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Tuple

import numpy as np

from repro_torch.serve.scheduler import Request

__all__ = ["WorkloadSpec", "WORKLOADS", "make_workload", "workload_names"]


class WorkloadSpec(NamedTuple):
    """One named scenario: request kwargs + engine knob overrides."""
    name: str
    requests: List[dict]
    engine_overrides: Dict


def _bursty(seed: int, n: int, max_new: int, vocab: int,
            max_prompt: int) -> Tuple[List[dict], Dict]:
    """Arrival clumps: requests land in bursts of 2-4 at the same tick
    with idle gaps between bursts — the admission/queue-pressure shape."""
    rnd = np.random.default_rng(seed)
    out, tick, i = [], 0, 0
    while i < n:
        burst = int(rnd.integers(2, 5))
        for _ in range(min(burst, n - i)):
            ln = int(rnd.integers(8, max(min(max_prompt, 40), 9)))
            out.append(dict(
                tokens=rnd.integers(0, vocab, ln).astype(np.int32),
                max_new=max_new, arrival=tick))
            i += 1
        tick += int(rnd.integers(4, 10))
    return out, {}


def _long_context(seed: int, n: int, max_new: int, vocab: int,
                  max_prompt: int) -> Tuple[List[dict], Dict]:
    """Prompts near the slot capacity: the regime where the factor cache's
    r/d read cut matters and spectra carry real signal."""
    rnd = np.random.default_rng(seed)
    lo = max(max_prompt // 2, 8)
    out = []
    for i in range(n):
        ln = int(rnd.integers(lo, max_prompt + 1))
        out.append(dict(tokens=rnd.integers(0, vocab, ln).astype(np.int32),
                        max_new=max_new, arrival=2 * i))
    return out, {}


def _shared_prefix(seed: int, n: int, max_new: int, vocab: int,
                   max_prompt: int) -> Tuple[List[dict], Dict]:
    """Chat-style turns over a few shared system prompts: most requests
    start with one of 2 cached prefixes plus a short unique tail."""
    rnd = np.random.default_rng(seed)
    pfx_len = max(min(max_prompt - 8, 24), 8)
    prefixes = [rnd.integers(0, vocab, pfx_len).astype(np.int32)
                for _ in range(2)]
    out = []
    for i in range(n):
        tail = rnd.integers(0, vocab, int(rnd.integers(4, 9)))
        p = prefixes[int(rnd.integers(0, len(prefixes)))]
        toks = np.concatenate([p, tail.astype(np.int32)])[:max_prompt]
        out.append(dict(tokens=toks, max_new=max_new, arrival=i))
    return out, {"prefix_cache": True}


def _mixed_sampling(seed: int, n: int, max_new: int, vocab: int,
                    max_prompt: int) -> Tuple[List[dict], Dict]:
    """Greedy / top-k / nucleus rows interleaved in one batch (the
    sampler-mix scenario the sanitizer also guards)."""
    rnd = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ln = int(rnd.integers(8, max(min(max_prompt, 32), 9)))
        req = dict(tokens=rnd.integers(0, vocab, ln).astype(np.int32),
                   max_new=max_new, arrival=2 * i)
        kind = i % 3
        if kind == 1:
            req.update(temperature=0.8, top_k=8, seed=seed + i)
        elif kind == 2:
            req.update(temperature=0.9, top_p=0.9, seed=seed + i)
        out.append(req)
    return out, {"sampling": True, "nucleus": True}


_GENERATORS: Dict[str, Callable] = {
    "bursty": _bursty,
    "long_context": _long_context,
    "shared_prefix": _shared_prefix,
    "mixed_sampling": _mixed_sampling,
}


def workload_names() -> List[str]:
    return list(_GENERATORS)


def make_workload(name: str, *, seed: int = 0, n_requests: int = 6,
                  max_new: int = 12, vocab: int = 256,
                  max_prompt: int = 48) -> WorkloadSpec:
    """Build one named scenario. Deterministic in all arguments; rids are
    assigned 0..n-1 in submission order."""
    gen = _GENERATORS.get(name)
    if gen is None:
        raise ValueError(f"unknown workload {name!r}; "
                         f"have {sorted(_GENERATORS)}")
    reqs, overrides = gen(seed, n_requests, max_new, vocab, max_prompt)
    for i, r in enumerate(reqs):
        r["rid"] = i
    return WorkloadSpec(name=name, requests=reqs,
                        engine_overrides=overrides)


def build(spec: WorkloadSpec) -> List[Request]:
    """Submit-ready Request objects for a spec."""
    return [Request(**r) for r in spec.requests]


WORKLOADS = tuple(_GENERATORS)
