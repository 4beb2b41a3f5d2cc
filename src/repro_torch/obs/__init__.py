"""repro_torch.obs: low-overhead observability for the port's serving stack
(``repro.obs``).

Four pieces, one facade:

* :mod:`repro_torch.obs.metrics` — counters / gauges / fixed-bucket
  histograms in a lock-free per-engine :class:`MetricsRegistry` shard,
  rolled up across replicas on read (:func:`aggregate`), with
  Prometheus-text and JSON-snapshot exporters. ``StatsView`` keeps the
  engine's historical ``stats`` dict surface alive as a view over the
  registry.
* :mod:`repro_torch.obs.tracing` — per-request span traces and the per-step
  phase timeline as Chrome trace-event JSON (Perfetto-loadable), plus
  the schema validator and the shared ``Stopwatch`` timing helper.
* :mod:`repro_torch.obs.flight` — a bounded ring of recent events dumped to
  disk on step exceptions / ``EngineStopped`` / front-end shutdown.
* :mod:`repro_torch.obs.core` — :class:`Observability`, the per-engine bundle
  the serving loop talks to. All hooks are host-side Python over values
  the loop already fetched: metrics/tracing ON adds no device sync.
"""
from repro_torch.obs.core import Observability
from repro_torch.obs.flight import FLIGHT_SCHEMA_VERSION, FlightRecorder
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               StatsView, aggregate, aggregate_registry)
from repro_torch.obs.tracing import (NULL_PHASES, PHASES, SpanTracer, StepPhases,
                               Stopwatch, validate_chrome_trace)

__all__ = [
    "Observability",
    "FlightRecorder",
    "FLIGHT_SCHEMA_VERSION",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "StatsView",
    "aggregate",
    "aggregate_registry",
    "NULL_PHASES",
    "PHASES",
    "SpanTracer",
    "StepPhases",
    "Stopwatch",
    "validate_chrome_trace",
]
