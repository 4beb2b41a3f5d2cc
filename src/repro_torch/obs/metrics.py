"""Metrics primitives for the port's serving stack (``repro.obs.metrics``): counters, gauges,
fixed-bucket histograms, and a per-engine registry.

Design constraints (they shape everything here):

* **Lock-free hot path.** The engine's step loop is the only writer of
  its registry shard, and every mutation is a single Python int/float
  attribute update — atomic under the GIL — so recording a metric never
  takes a lock and never touches the device. Readers (exporters, the
  front-end stats thread, the fleet rollup) see a consistent-enough
  snapshot without stopping the writer: a counter read races at worst
  one increment behind. Only metric *creation* is locked, because two
  threads may get-or-create the same name.
* **Per-engine shards, rolled up on read.** Each ``ServeEngine`` owns
  one :class:`MetricsRegistry`. A fleet view (``Router``) does not share
  a registry across replicas — it calls :func:`aggregate` over the
  replica shards at read time, so replicas never contend.
* **Fixed buckets.** Histograms bucket at observe time (a bisect into a
  static bound table) instead of keeping raw sample lists, so memory is
  O(buckets) regardless of traffic and percentiles are O(buckets) reads.
  Percentiles are interpolated within the containing bucket and clamped
  to the observed min/max, which keeps smoke-scale estimates (a handful
  of samples) honest.

``StatsView`` is the compatibility shim: the engine's historical
``stats`` dict (``eng.stats["tokens_decoded"]`` reads, and external
``stats["decode_s"] += dt`` writes from ``repro_torch.serve.api``) becomes a
``MutableMapping`` view over registry metrics, so every existing test,
bench key and example keeps working while the registry becomes the
single source of truth.
"""
from __future__ import annotations

import re
import threading
from bisect import bisect_left
from collections.abc import MutableMapping
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

Number = Union[int, float]

# geometric time buckets, 50 us .. ~104 s at factor sqrt(2): wide enough
# for compile stalls, fine enough that a p50 interpolation error is
# bounded by ~1.41x — and the regression gate compares like-for-like
# estimates against a baseline produced by this same table
DEFAULT_TIME_BUCKETS_S: Tuple[float, ...] = tuple(
    50e-6 * (2.0 ** (i / 2.0)) for i in range(43))

# small-integer buckets for discrete sizes (speculative accept runs,
# queue depths): exact counts up to 32, one overflow bucket beyond
DEFAULT_COUNT_BUCKETS: Tuple[float, ...] = tuple(float(i) for i in range(33))


class Counter:
    """Single-writer accumulator. ``value`` is a plain int or float —
    the type follows the ``init`` value, and mixed int+float arithmetic
    degrades exactly like the dict-of-numbers it replaces."""

    kind = "counter"
    __slots__ = ("name", "init", "value")

    def __init__(self, name: str, init: Number = 0):
        self.name = name
        self.init = init
        self.value = init

    def inc(self, n: Number = 1) -> None:
        self.value += n

    def set(self, v: Number) -> None:
        self.value = v

    def get(self) -> Number:
        return self.value

    def zero(self) -> None:
        self.value = self.init

    def export(self) -> Number:
        return self.value


class Gauge(Counter):
    """A value that is *set*, not accumulated (queue depth, live slots,
    effective draft window). Same storage as Counter; the distinction
    drives the Prometheus TYPE line and the fleet rollup."""

    kind = "gauge"
    __slots__ = ()


class Histogram:
    """Fixed-bucket histogram. ``bounds`` are upper bucket edges; values
    above the last bound land in one overflow bucket. Tracks count, sum,
    min and max exactly; percentiles are estimated by linear
    interpolation inside the containing bucket."""

    kind = "histogram"
    __slots__ = ("name", "bounds", "counts", "count", "total",
                 "vmin", "vmax")

    def __init__(self, name: str,
                 bounds: Optional[Sequence[float]] = None):
        self.name = name
        self.bounds: Tuple[float, ...] = tuple(
            sorted(bounds if bounds is not None else DEFAULT_TIME_BUCKETS_S))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Estimated q-th percentile (q in [0, 100]); 0.0 when empty."""
        if self.count == 0:
            return 0.0
        target = (q / 100.0) * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            lo = self.bounds[i - 1] if i > 0 else min(self.vmin, self.bounds[0])
            hi = self.bounds[i] if i < len(self.bounds) else self.vmax
            lo = max(lo, self.vmin)
            hi = min(hi, self.vmax)
            if hi < lo:
                lo = hi = (self.vmin if i == 0 else self.vmax)
            if cum + c >= target:
                frac = (target - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return self.vmax

    def zero(self) -> None:
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")

    def export(self) -> Dict[str, Any]:
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.vmin if self.count else None,
            "max": self.vmax if self.count else None,
            "mean": self.mean(),
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


Metric = Union[Counter, Gauge, Histogram]

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(namespace: str, name: str) -> str:
    return _PROM_BAD.sub("_", f"{namespace}_{name}")


class MetricsRegistry:
    """One engine's metric shard: name -> metric, get-or-create under a
    lock, every subsequent mutation lock-free (see module docstring)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    def _get_or_make(self, cls, name: str, **kw) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(name, **kw)
                    self._metrics[name] = m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}")
        return m

    def counter(self, name: str, init: Number = 0) -> Counter:
        return self._get_or_make(Counter, name, init=init)

    def gauge(self, name: str, init: Number = 0) -> Gauge:
        return self._get_or_make(Gauge, name, init=init)

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_make(Histogram, name, bounds=bounds)

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def metrics(self) -> List[Metric]:
        with self._lock:
            return list(self._metrics.values())

    def zero(self) -> None:
        for m in self.metrics():
            m.zero()

    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time export: plain numbers for counters/gauges, a
        summary dict for histograms. Pure host Python — safe to call
        from any thread, any time, including crash paths."""
        return {m.name: m.export() for m in self.metrics()}

    def prometheus_text(self, namespace: str = "repro") -> str:
        """Prometheus text exposition (one scrape body)."""
        lines: List[str] = []
        for m in sorted(self.metrics(), key=lambda m: m.name):
            pname = _prom_name(namespace, m.name)
            if isinstance(m, Histogram):
                lines.append(f"# TYPE {pname} histogram")
                cum = 0
                for bound, c in zip(m.bounds, m.counts):
                    cum += c
                    lines.append(f'{pname}_bucket{{le="{bound:g}"}} {cum}')
                lines.append(f'{pname}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{pname}_sum {m.total:g}")
                lines.append(f"{pname}_count {m.count}")
            else:
                lines.append(f"# TYPE {pname} {m.kind}")
                lines.append(f"{pname} {m.value:g}")
        return "\n".join(lines) + "\n"


def aggregate_registry(
        registries: Sequence[MetricsRegistry]) -> MetricsRegistry:
    """Merge per-replica shards into a fresh registry at read time:
    counters and gauges sum; histograms with identical bounds merge
    bucket-wise (count/sum/min/max exact, percentiles re-estimated over
    the merged buckets). Metrics absent from some replicas contribute
    only where present. The result is a detached copy — exporting or
    mutating it never touches the source shards."""
    out = MetricsRegistry()
    merged = out._metrics
    for reg in registries:
        for m in reg.metrics():
            have = merged.get(m.name)
            if have is None:
                if isinstance(m, Histogram):
                    h = Histogram(m.name, m.bounds)
                    h.counts = list(m.counts)
                    h.count, h.total = m.count, m.total
                    h.vmin, h.vmax = m.vmin, m.vmax
                    merged[m.name] = h
                else:
                    c = type(m)(m.name, init=m.init)
                    c.value = m.value
                    merged[m.name] = c
            elif isinstance(m, Histogram):
                if not isinstance(have, Histogram) or have.bounds != m.bounds:
                    raise TypeError(
                        f"cannot merge histogram {m.name!r}: bounds differ")
                have.counts = [a + b for a, b in zip(have.counts, m.counts)]
                have.count += m.count
                have.total += m.total
                have.vmin = min(have.vmin, m.vmin)
                have.vmax = max(have.vmax, m.vmax)
            else:
                have.value += m.value
    return out


def aggregate(registries: Sequence[MetricsRegistry]) -> Dict[str, Any]:
    """Fleet rollup snapshot (see :func:`aggregate_registry`)."""
    return aggregate_registry(registries).snapshot()


class StatsView(MutableMapping):
    """Dict-compatible view over registry metrics: the engine's legacy
    ``stats`` surface. Keys are fixed at construction (the historical
    stat names); reads and ``stats[k] = v`` / ``stats[k] += v`` writes
    go straight to the backing Counter/Gauge. Re-binding the same keys
    on an existing registry (engine reset) re-zeroes them to their init
    values — exactly the semantics of rebuilding the old dict."""

    __slots__ = ("_metrics",)

    def __init__(self, registry: MetricsRegistry, init: Mapping[str, Number],
                 *, prefix: str = "serve", gauges: Sequence[str] = ()):
        metrics: Dict[str, Counter] = {}
        for k, v in init.items():
            cls = Gauge if k in gauges else Counter
            m = registry._get_or_make(cls, f"{prefix}.{k}", init=v)
            m.init = v
            m.value = v
            metrics[k] = m
        object.__setattr__(self, "_metrics", metrics)

    def __getitem__(self, k: str) -> Number:
        return self._metrics[k].value

    def __setitem__(self, k: str, v: Number) -> None:
        self._metrics[k].value = v

    def __delitem__(self, k: str) -> None:
        raise TypeError("StatsView keys are fixed at construction")

    def __iter__(self) -> Iterator[str]:
        return iter(self._metrics)

    def __len__(self) -> int:
        return len(self._metrics)

    def __repr__(self) -> str:
        return f"StatsView({dict(self)!r})"

    def reset(self) -> None:
        for m in self._metrics.values():
            m.zero()
