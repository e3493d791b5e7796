"""Serving stack of the port: request queue, slot and paged KV caches,
engine, metrics, the SLO control loop (sparsity tiers, hysteresis
ladder), seeded fault injection and the typed serve errors."""

from repro_torch.serve.cache import PagedKVCache, SlotKVCache, \
    gather_slots, paged_commit, paged_view, reset_slot
from repro_torch.serve.engine import ServeEngine, compare_dense_sparse, \
    sparsify_for_serving, warmup_engine
from repro_torch.serve.errors import DeadlineExceededError, \
    EngineOverloadError, InjectedFaultError, PromptTooLongError, \
    ServeError, raise_for_output
from repro_torch.serve.faults import FaultConfig, FaultInjector, \
    burst_arrivals
from repro_torch.serve.metrics import ServeMetrics, summarize
from repro_torch.serve.queue import PageAllocator, Request, \
    RequestOutput, RequestQueue, SamplingParams, prefix_hashes, sample_token
from repro_torch.serve.slo import CadenceWatchdog, LatencyModel, \
    SLOConfig, SLOController, Tier, TierSpec, build_tiers
from repro_torch.serve.tracecount import note_trace, reset_trace_events, \
    trace_events

__all__ = ["SlotKVCache", "PagedKVCache", "PromptTooLongError",
           "gather_slots", "reset_slot", "paged_view", "paged_commit",
           "PageAllocator", "prefix_hashes", "ServeEngine",
           "compare_dense_sparse", "sparsify_for_serving", "warmup_engine",
           "ServeError", "DeadlineExceededError", "EngineOverloadError",
           "InjectedFaultError", "raise_for_output", "FaultConfig",
           "FaultInjector", "burst_arrivals", "SLOConfig", "SLOController",
           "CadenceWatchdog", "LatencyModel", "Tier", "TierSpec",
           "build_tiers", "ServeMetrics", "summarize", "Request",
           "RequestOutput", "RequestQueue", "SamplingParams", "sample_token",
           "note_trace", "trace_events", "reset_trace_events"]
