"""The engine's serve programs replayed as CUDA graphs: the port's
counterpart of the reference's jitted ``_jit_decode``,
``_jit_decode_chunk``, ``_jit_paged_decode``, ``_jit_paged_decode_chunk``
(``repro/serve/engine.py``), ``_jit_slot_prefill`` and
``_jit_paged_prefill`` (``repro/serve/cache.py``).

A :class:`DecodeGraph` holds one decode program ``fn(params, tok, cache,
pos) -> tensor`` over static buffers: ``tok`` [B, 1] and ``pos`` [B]
int32, the engine's own KV cache tensors (every leaf of a flat or a
pair layout's nested cache, updated in place, never reallocated) and a
static output (the [T, B] token block of a chunk, the [B, V] logits of
one step).  A :class:`PrefillGraph` holds the admission
program for one prompt length S: a static [1, S] prompt, the slot and
seq offset as device scalars (so one graph writes any slot), the same
cache, and the [1, V] logits as its output.  On the card the first run
of either runs the program eagerly on the capture stream (which builds
and loads the kernel libraries and makes their one-time
``cudaFuncSetAttribute`` calls and cuBLAS's per-stream workspace, so no
capture is the first to raise a shared-memory limit), then captures it;
every later run copies the inputs in and replays.  Capture records and
executes nothing, so the launch counters (``kernels/ops.py``) are put
back after it and the captured delta is added at every replay: they keep
counting launches executed.  A capture or replay error raises; nothing
drops back to the eager program.  On the CPU, or with ``capture=False``,
the same object runs the program eagerly into the same buffers.  Each
build (a capture, or the first eager run where capture is off) is one
trace event (``serve/tracecount.py``).  The paged programs
(:class:`PagedDecodeGraph`, :class:`PagedPrefillGraph`) also hold the
page table in their static buffer (the whole ``[max_slots,
pages_per_slot]`` table, or the admitted slot's row), copied in with the
tokens before each run: the reference uploads it with every call.

Capture freezes what the program reads from the host, so the program
must not sync or copy from the host, and every n:m:g weight must carry
its gather plan (:func:`check_capturable`): one without it would rebuild
the plan, with host copies, inside the capture.  Never capture while the
kernel wrappers are swapped for their plain versions: replay would run
whatever was captured.

Capture freezes the routing too.  Each n:m:g projection reads its route
and kernel config from the active tuning table (``tune/routing.py``)
when it is called, and a capture records the launches of that call: a
table activated after a program's capture changes nothing that replays,
as a table swapped in the reference retraces nothing.  Activate a table
before the programs are built (``serve/engine.py:warmup_engine(tune=
True)`` tunes, then builds).
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.layouts import GroupedNMTensor
from repro_torch.kernels import ops as kops
from repro_torch.models.transformer import cache_leaves
from repro_torch.serve.tracecount import note_trace

__all__ = ["DecodeGraph", "PrefillGraph", "PagedDecodeGraph",
           "PagedPrefillGraph", "check_capturable"]


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


class _ProgramGraph:
    """One serve program over static buffers, replayed as a CUDA graph
    when ``capture`` is true and the program's tensors lie on the card.
    ``pool`` (a ``torch.cuda.graph_pool_handle()``) lets an engine's
    programs share one memory pool: they never run at once, and each copies
    its result into a static output allocated outside the pool and held
    for the program's life, so no later capture takes its memory.
    Subclasses define :meth:`_program` over their buffers."""

    def __init__(self, name: str, params, device: torch.device, *,
                 capture: bool, pool):
        self.name = name
        self.params = params
        self.device = device
        self.capture_on = capture and device.type == "cuda"
        self.out = None
        self.graph = None
        self.pool = pool
        self._delta = None
        #: capture cost (host ms of capture and of instantiation, bytes the
        #: capture added to the reserved pool) and the replays so far
        self.info = {"captured": False, "replays": 0}

    def _program(self) -> torch.Tensor:
        raise NotImplementedError

    def _execute(self) -> torch.Tensor:
        """Run the program on the buffers as they stand: replay, or the
        first run and capture, or eagerly; returns the static output."""
        if self.graph is not None:
            self.graph.replay()
            kops.add_counters(self._delta)
            self.info["replays"] += 1
        elif not self.capture_on:
            res = self._program()
            if self.out is None:
                note_trace(self.name)
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
        note_trace(self.name)
        self.info.update(
            captured=True, capture_ms=(t1 - t0) * 1e3,
            instantiate_ms=(t2 - t1) * 1e3,
            pool_bytes=torch.cuda.memory_reserved(self.device) - reserved)


class DecodeGraph(_ProgramGraph):
    """One decode program ``fn(params, tok, cache, pos) -> tensor`` over
    static ``tok`` [B, 1] / ``pos`` [B] int32 buffers and the engine's KV
    cache; ``name`` is its trace-event name (``decode`` or
    ``decode_chunk``)."""

    def __init__(self, fn: Callable, params, cache: dict, batch: int, *,
                 name: str = "decode", capture: bool = True, pool=None):
        super().__init__(name, params, cache_leaves(cache)[0].device,
                         capture=capture, pool=pool)
        self.fn = fn
        self.cache = cache
        # tok and pos share one buffer, so each run copies in once
        self._io = torch.zeros((2, batch), dtype=torch.int32,
                               device=self.device)
        self.tok = self._io[0].view(batch, 1)
        self.pos = self._io[1]

    def _program(self) -> torch.Tensor:
        return self.fn(self.params, self.tok, self.cache, self.pos)

    def run(self, tok, pos) -> torch.Tensor:
        """Copy ``tok`` [B] and ``pos`` [B] (host ints) in, run the program
        and return the static output (valid until the next run)."""
        self._io.copy_(torch.from_numpy(np.stack([
            np.asarray(tok, np.int32).reshape(-1),
            np.asarray(pos, np.int32).reshape(-1)])))
        return self._execute()


class PrefillGraph(_ProgramGraph):
    """The admission program for one prompt length ``S``: ``fn(params,
    tokens, cache, slot, offset) -> logits [1, V]`` over a static tokens
    [1, S] buffer, the (slot, offset) pair as 0-dim int32 device tensors
    and the engine's KV cache, written in place.  One graph serves every
    slot and offset; a prompt of another length needs its own (prompts
    are not padded: padding would write pad-token K/V into the slot)."""

    def __init__(self, fn: Callable, params, cache: dict, S: int, *,
                 capture: bool = True, pool=None):
        super().__init__("slot_prefill", params,
                         cache_leaves(cache)[0].device, capture=capture,
                         pool=pool)
        self.fn = fn
        self.cache = cache
        self.S = S
        # the prompt, slot and offset share one buffer: one copy a run
        self._io = torch.zeros(S + 2, dtype=torch.int32, device=self.device)
        self.tokens = self._io[:S].view(1, S)
        self.slot = self._io[S]
        self.offset = self._io[S + 1]

    def _program(self) -> torch.Tensor:
        return self.fn(self.params, self.tokens, self.cache, self.slot,
                       self.offset)

    def run(self, tokens, slot: int, offset: int = 0) -> torch.Tensor:
        """Copy ``tokens`` (S host ints) and ``slot``, ``offset`` in, run
        the program and return the static logits [1, V] (valid until the
        next run)."""
        host = np.empty(self.S + 2, np.int32)
        toks = np.asarray(tokens).reshape(-1)
        if toks.size != self.S:
            raise ValueError(f"the program takes {self.S} tokens, got "
                             f"{toks.size}")
        host[:self.S] = toks
        host[self.S:] = (slot, offset)
        self._io.copy_(torch.from_numpy(host))
        return self._execute()


class PagedDecodeGraph(_ProgramGraph):
    """A paged decode program ``fn(params, tok, pool, table, pos) ->
    tensor`` over static ``tok`` [B, 1], ``pos`` [B] and ``table`` [B,
    pps] int32 buffers (one buffer, one copy a run) and the page pool,
    updated in place; ``name`` is ``paged_decode`` or
    ``paged_decode_chunk``."""

    def __init__(self, fn: Callable, params, pool: dict, batch: int,
                 pages_per_slot: int, *, name: str = "paged_decode",
                 capture: bool = True, graph_pool=None):
        super().__init__(name, params, cache_leaves(pool)[0].device,
                         capture=capture, pool=graph_pool)
        self.fn = fn
        self.cache = pool
        self._io = torch.zeros(batch * (2 + pages_per_slot),
                               dtype=torch.int32, device=self.device)
        self.tok = self._io[:batch].view(batch, 1)
        self.pos = self._io[batch:2 * batch]
        self.table = self._io[2 * batch:].view(batch, pages_per_slot)

    def _program(self) -> torch.Tensor:
        return self.fn(self.params, self.tok, self.cache, self.table,
                       self.pos)

    def run(self, tok, pos, table) -> torch.Tensor:
        """Copy ``tok`` [B], ``pos`` [B] and ``table`` [B, pps] (host
        ints) in, run the program and return the static output."""
        self._io.copy_(torch.from_numpy(np.concatenate([
            np.asarray(tok, np.int32).reshape(-1),
            np.asarray(pos, np.int32).reshape(-1),
            np.asarray(table, np.int32).reshape(-1)])))
        return self._execute()


class PagedPrefillGraph(_ProgramGraph):
    """The paged admission program for one prompt length ``S``:
    ``fn(params, tokens, pool, table_row, slot, start) -> logits [1,
    V]`` over a static tokens [1, S], the slot's table row [pps] and the
    (slot, shared-prefix length) pair in one int32 buffer, and the page
    pool, written in place."""

    def __init__(self, fn: Callable, params, pool: dict, S: int,
                 pages_per_slot: int, *, capture: bool = True,
                 graph_pool=None):
        super().__init__("paged_prefill", params,
                         cache_leaves(pool)[0].device, capture=capture,
                         pool=graph_pool)
        self.fn = fn
        self.cache = pool
        self.S = S
        self._io = torch.zeros(S + pages_per_slot + 2, dtype=torch.int32,
                               device=self.device)
        self.tokens = self._io[:S].view(1, S)
        self.table_row = self._io[S:S + pages_per_slot]
        self.slot = self._io[S + pages_per_slot]
        self.start = self._io[S + pages_per_slot + 1]

    def _program(self) -> torch.Tensor:
        return self.fn(self.params, self.tokens, self.cache, self.table_row,
                       self.slot, self.start)

    def run(self, tokens, table_row, slot: int, start: int) -> torch.Tensor:
        """Copy ``tokens`` (S host ints), the slot's ``table_row``,
        ``slot`` and ``start`` in, run the program and return the static
        logits [1, V] (valid until the next run)."""
        toks = np.asarray(tokens).reshape(-1)
        if toks.size != self.S:
            raise ValueError(f"the program takes {self.S} tokens, got "
                             f"{toks.size}")
        self._io.copy_(torch.from_numpy(np.concatenate([
            toks.astype(np.int32), np.asarray(table_row, np.int32),
            np.asarray([slot, start], np.int32)])))
        return self._execute()
