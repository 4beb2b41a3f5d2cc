"""Continuous-batching serving engine of the port.

- api:       EngineConfig + SamplingParams + Engine.submit -> RequestHandle.
- kv_cache:  slot-paged KV cache (device pools, host page tables).
- scheduler: request queue, admission, eviction (numpy only).
- policy:    slot-indexed segment-level rank decision ('fixed', 'adaptive',
             'drrl', 'learned').
- engine:    the step loop core: one fused step over all live slots with
             chunked prefill interleaved.
"""
from repro_torch.serve.api import (Engine, EngineConfig, EngineStopped,
                                   RequestHandle, SamplingParams)
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kv_cache import PagedKVCache
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["Engine", "EngineConfig", "EngineStopped", "RequestHandle",
           "SamplingParams", "ServeEngine", "PagedKVCache", "Request",
           "Scheduler"]
