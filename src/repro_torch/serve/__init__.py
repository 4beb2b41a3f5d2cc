"""Continuous-batching serving engine of the port.

- api:       EngineConfig + SamplingParams + Engine.submit -> RequestHandle.
- kv_cache:  slot-paged KV cache (device pools, host page tables).
- scheduler: request queue, admission, eviction (numpy only).
- policy:    slot-indexed segment-level rank decision ('fixed', 'adaptive',
             'drrl', 'learned', 'random'), the drift measure and draft ranks.
- engine:    the step loop core: one fused step over all live slots with
             chunked prefill interleaved, or its speculative form.
- spec:      low-rank self-speculative decoding's accept / rollback helpers.
- prefix:    the shared-prefix radix tree (numpy only) over refcounted pages.
- frontend:  FrontEnd (a background stepping thread per engine) and Router
             (N replicas with prefix-cache affinity), under one FleetConfig.
- traces:    serving-trace recording (per-segment decision features and
             outcomes in versioned npz shards) and the replay reader the
             offline policy trainer (repro_torch.train.serve_policy) reads.
- workloads: deterministic named scenario generators (numpy only).
"""
from repro_torch.serve.api import (Engine, EngineConfig, EngineStopped,
                                   RequestHandle, SamplingParams, make_engine)
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.frontend import FleetConfig, FrontEnd, Router
from repro_torch.serve.kv_cache import PagedKVCache
from repro_torch.serve.prefix import PrefixCache, RadixNode
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.serve.traces import (TRACE_SCHEMA_VERSION, TraceReader,
                                      TraceRecorder)
from repro_torch.serve.workloads import WorkloadSpec, make_workload, workload_names

__all__ = ["Engine", "EngineConfig", "EngineStopped", "RequestHandle",
           "SamplingParams", "make_engine", "ServeEngine", "FleetConfig",
           "FrontEnd", "Router", "PagedKVCache", "PrefixCache", "RadixNode",
           "Request", "Scheduler", "TRACE_SCHEMA_VERSION", "TraceReader",
           "TraceRecorder", "WorkloadSpec", "make_workload", "workload_names"]
