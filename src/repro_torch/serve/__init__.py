"""Serving stack of the port: request queue, slot and paged KV caches,
engine, metrics."""

from repro_torch.serve.cache import PagedKVCache, PromptTooLongError, \
    SlotKVCache, gather_slots, paged_commit, paged_view, reset_slot
from repro_torch.serve.engine import ServeEngine, compare_dense_sparse, \
    sparsify_for_serving, warmup_engine
from repro_torch.serve.metrics import ServeMetrics, summarize
from repro_torch.serve.queue import PageAllocator, Request, \
    RequestOutput, RequestQueue, SamplingParams, prefix_hashes, sample_token

__all__ = ["SlotKVCache", "PagedKVCache", "PromptTooLongError",
           "gather_slots", "reset_slot", "paged_view", "paged_commit",
           "PageAllocator", "prefix_hashes", "ServeEngine",
           "compare_dense_sparse", "sparsify_for_serving", "warmup_engine",
           "ServeMetrics", "summarize", "Request", "RequestOutput",
           "RequestQueue", "SamplingParams", "sample_token"]
