"""The engine's decode programs replayed as CUDA graphs: the port's
counterpart of the reference's jitted ``_jit_decode`` and
``_jit_decode_chunk`` (``repro/serve/engine.py``).

A :class:`DecodeGraph` holds one decode program ``fn(params, tok, cache,
pos) -> tensor`` over static buffers: ``tok`` [B, 1] and ``pos`` [B]
int32, the engine's own KV cache tensors (updated in place, never
reallocated) and a static output (the [T, B] token block of a chunk, the
[B, V] logits of one step).  On the card its first :meth:`run` runs the
program eagerly on the capture stream (which builds and loads the kernel
libraries and makes their one-time ``cudaFuncSetAttribute`` calls, so no
capture is the first to raise a shared-memory limit), then captures it;
every later run copies the inputs in and replays.  Capture records and
executes nothing, so the launch counters (``kernels/ops.py``) are put
back after it and the captured delta is added at every replay: they keep
counting launches executed.  A capture or replay error raises; nothing
drops back to the eager program.  On the CPU, or with ``capture=False``,
the same object runs the program eagerly into the same buffers.

Capture freezes what the program reads from the host, so the program
must not sync or copy from the host, and every n:m:g weight must carry
its gather plan (:func:`check_capturable`): one without it would rebuild
the plan, with host copies, inside the capture.  Never capture while the
kernel wrappers are swapped for their plain versions: replay would run
whatever was captured.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.layouts import GroupedNMTensor
from repro_torch.kernels import ops as kops

__all__ = ["DecodeGraph", "check_capturable"]


def check_capturable(params, path: str = "params") -> None:
    """Raise ValueError for an n:m:g weight without its gather plan."""
    if isinstance(params, dict):
        for k, v in params.items():
            check_capturable(v, f"{path}.{k}")
    elif isinstance(params, GroupedNMTensor) and params.plan is None:
        raise ValueError(
            f"{path} has no gather plan (plan=None): the program would "
            f"rebuild it with host copies on every call, and a capture "
            f"would freeze a temporary; build the plan first")


class DecodeGraph:
    """One decode program over static buffers, replayed as a CUDA graph
    when ``capture`` is true and the cache lies on the card.  ``pool``
    (a ``torch.cuda.graph_pool_handle()``) lets an engine's two programs
    share one memory pool: they never run at once."""

    def __init__(self, fn: Callable, params, cache: dict, batch: int, *,
                 capture: bool = True, pool=None):
        self.fn = fn
        self.params = params
        self.cache = cache
        self.device = cache["k"].device
        self.capture_on = capture and self.device.type == "cuda"
        # tok and pos share one buffer, so each run copies in once
        self._io = torch.zeros((2, batch), dtype=torch.int32,
                               device=self.device)
        self.tok = self._io[0].view(batch, 1)
        self.pos = self._io[1]
        self.out = None
        self.graph = None
        self.pool = pool
        self._delta = None
        #: capture cost (host ms of capture and of instantiation, bytes the
        #: capture added to the reserved pool) and the replays so far
        self.info = {"captured": False, "replays": 0}

    def _program(self) -> torch.Tensor:
        return self.fn(self.params, self.tok, self.cache, self.pos)

    def run(self, tok, pos) -> torch.Tensor:
        """Copy ``tok`` [B] and ``pos`` [B] (host ints) in, run the program
        and return the static output (valid until the next run)."""
        self._io.copy_(torch.from_numpy(np.stack([
            np.asarray(tok, np.int32).reshape(-1),
            np.asarray(pos, np.int32).reshape(-1)])))
        if self.graph is not None:
            self.graph.replay()
            kops.add_counters(self._delta)
            self.info["replays"] += 1
        elif not self.capture_on:
            res = self._program()
            if self.out is None:
                self.out = torch.empty_like(res)
            self.out.copy_(res)
        else:
            self._run_then_capture()
        return self.out

    def _run_then_capture(self) -> None:
        """The first run on the card: eagerly on the capture stream (its
        result is this run's), then the capture.  Records the capture's
        counter delta and puts the counters back; raises on any capture
        error."""
        check_capturable(self.params)
        cur = torch.cuda.current_stream(self.device)
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            res = self._program()
        cur.wait_stream(stream)
        res.record_stream(cur)
        self.out = torch.empty_like(res)
        self.out.copy_(res)
        before = kops.counter_snapshot()
        g = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(g, pool=self.pool, stream=stream):
                t0 = time.perf_counter()
                reserved = torch.cuda.memory_reserved(self.device)
                self.out.copy_(self._program())
                t1 = time.perf_counter()
            t2 = time.perf_counter()
        finally:
            after = kops.counter_snapshot()
            kops.restore_counters(before)
            # a failed capture_end leaves the capture stream current
            torch.cuda.set_stream(cur)
        self._delta = kops.counter_delta(before, after)
        self.graph = g
        self.info.update(
            captured=True, capture_ms=(t1 - t0) * 1e3,
            instantiate_ms=(t2 - t1) * 1e3,
            pool_bytes=torch.cuda.memory_reserved(self.device) - reserved)
