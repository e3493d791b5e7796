"""Serving stack of the port: request queue, slot KV cache, engine,
metrics."""

from repro_torch.serve.cache import SlotKVCache, gather_slots, reset_slot
from repro_torch.serve.engine import ServeEngine, compare_dense_sparse, \
    sparsify_for_serving, warmup_engine
from repro_torch.serve.metrics import ServeMetrics, summarize
from repro_torch.serve.queue import Request, RequestOutput, RequestQueue, \
    SamplingParams, sample_token

__all__ = ["SlotKVCache", "gather_slots", "reset_slot", "ServeEngine",
           "compare_dense_sparse", "sparsify_for_serving", "warmup_engine",
           "ServeMetrics", "summarize", "Request", "RequestOutput",
           "RequestQueue", "SamplingParams", "sample_token"]
