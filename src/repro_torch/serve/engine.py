"""Continuous-batching serving engine, slot mode (port of
``repro/serve/engine.py``; the paged cache, SLO control loop, sparsity
tiers and fault injection are not ported yet).

The engine holds a static batch of ``max_slots`` sequences.  Between
decode steps it admits queued requests into free slots (prefill writes a
request's K/V straight into its slot) and every decode step advances all
occupied slots at their own positions.  When every active request is
greedy, ``decode_chunk`` steps run back to back on the device with
on-device argmax and the token block reaches the host in one sync per
chunk; otherwise one step at a time with host-side sampling.

The engine holds its programs as the reference's holds its jitted ones
(``_jit_decode``, ``_jit_decode_chunk``, and ``_jit_slot_prefill`` once
per prompt length): on the card each decode program is a
:class:`~repro_torch.serve.graphs.DecodeGraph` and each prompt length's
admission a :class:`~repro_torch.serve.graphs.PrefillGraph` (held by the
:class:`SlotKVCache`), run eagerly once and captured at its first use,
then replayed; all of them share one graph pool.  ``graphs=False`` runs
every program eagerly on the card; a CPU engine always does.
:func:`warmup_engine` builds in the engine to be measured every program a
trace needs before the trace is timed, and :func:`serve_programs` lists
the programs with example arguments, as the reference's does.

``sparsify_for_serving`` converts weights to :class:`GroupedNMTensor`
through the ordinary :class:`SparsityBuilder`; the engine serves dense and
n:m:g params alike.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch.core.builder import SparsityBuilder
from repro_torch.core.layouts import GroupedNMTensor
from repro_torch.core.sparsifiers import GroupedNMSparsifier
from repro_torch.device import resolve_device
from repro_torch.models import decode_step, init_cache, prefill
from repro_torch.models.common import ModelConfig
from repro_torch.serve.cache import PromptTooLongError, SlotKVCache
from repro_torch.serve.graphs import DecodeGraph
from repro_torch.serve.metrics import ServeMetrics, summarize
from repro_torch.serve.queue import Request, RequestOutput, RequestQueue, \
    sample_token

__all__ = ["ServeEngine", "sparsify_for_serving", "compare_dense_sparse",
           "warmup_engine", "decode_chunk", "serve_programs"]

DEFAULT_MAX_SLOTS = 8


def sparsify_for_serving(params, n: int = 1, m: int = 4, g: int = 16,
                         gr: int = 64, *, attn: bool = False):
    """Convert the FFN weights (and with ``attn=True`` also wq/wk/wv/wo) to
    the n:m:g serving layout, ``gr`` rows sharing each chunk permutation.
    With ``attn=True`` q/k/v share one format over one contraction axis and
    decode routes them through the fused QKV launch.  A gated MLP's packed
    [D, 2F] ``wi`` converts as one weight; when 2F needs no row padding
    and F is a multiple of ``gr`` (qwen1.5-4b: 2F = 13824 = 216 x 64; its
    SMOKE: 256 = 16 x 16), decode routes it through the fused FFN launch
    (``fusable_ffn``), else through the GEMV and a separate gate."""
    sb = SparsityBuilder()
    sp = GroupedNMSparsifier(n, m, g, gr, sparse_dim=0)   # [K, N] weights
    sb.set_weight("*mlp.wi", sp, GroupedNMTensor)
    sb.set_weight("*mlp.wo", sp, GroupedNMTensor)
    if attn:
        for name in ("*attn.wq", "*attn.wk", "*attn.wv", "*attn.wo"):
            sb.set_weight(name, sp, GroupedNMTensor)
    return sb.sparsify_params(params)


def decode_chunk(params, cfg: ModelConfig, tok, cache, pos, n_steps: int):
    """``n_steps`` greedy decode steps with on-device argmax.  Returns the
    [n_steps, B] token matrix (still on the device) and the cache."""
    toks = []
    for _ in range(n_steps):
        logits, cache = decode_step(params, cfg, tok, cache, pos)
        nxt = torch.argmax(logits, -1).to(torch.int32)
        toks.append(nxt)
        tok, pos = nxt[:, None], pos + 1
    return torch.stack(toks), cache


def _decode_fn(cfg: ModelConfig):
    """The one-step program: logits [B, V], the cache updated in place."""

    def step(p, tok, cache, pos):
        return decode_step(p, cfg, tok, cache, pos)[0]

    return step


def _decode_chunk_fn(cfg: ModelConfig, n_steps: int):
    """The chunk program: the [n_steps, B] greedy token block."""

    def chunk(p, tok, cache, pos):
        return decode_chunk(p, cfg, tok, cache, pos, n_steps)[0]

    return chunk


def serve_programs(params, cfg: ModelConfig, *, max_slots: int = 4,
                   max_seq_len: int = 64, decode_chunk: int = 4,
                   prompt_len: int = 8) -> dict:
    """The engine's programs as ``{name: (fn, example_args)}``, with
    example arguments on the params' device shaped as a running engine
    shapes them (the reference's ``serve_programs``): ``decode`` and
    ``decode_chunk`` are the callables the engine's decode graphs run
    (logits [B, V] and the [T, B] token block; the cache is updated in
    place, so each gets its own example cache), ``prefill`` the classic
    prefill of a fresh ``max_seq_len`` cache, as in the reference."""
    dev = _param_device(params)

    def decode_args():
        return (params, torch.zeros((max_slots, 1), dtype=torch.int32,
                                    device=dev),
                init_cache(cfg, max_slots, max_seq_len, device=dev),
                torch.full((max_slots,), prompt_len, dtype=torch.int32,
                           device=dev))

    progs = {
        "decode": (_decode_fn(cfg), decode_args()),
        "prefill": (
            lambda p, toks: prefill(p, cfg, toks, cache_len=max_seq_len),
            (params, torch.zeros((1, prompt_len), dtype=torch.int32,
                                 device=dev))),
    }
    if decode_chunk > 1:
        progs["decode_chunk"] = (_decode_chunk_fn(cfg, decode_chunk),
                                 decode_args())
    return progs


@dataclasses.dataclass
class _SlotState:
    """Host-side bookkeeping for one occupied slot."""

    req: Request
    tokens: list
    token_times: list
    admitted_time: float
    rng: np.random.Generator
    max_new: int  # request budget clamped to the slot's cache capacity


def _param_device(params) -> torch.device:
    return params["embedding"].device


class ServeEngine:
    """Slot-based continuous-batching engine.

    ``params`` may hold dense or n:m:g weights and must lie on ``device``
    (default ``"cuda"``; pass ``device="cpu"`` for the plain versions).
    ``decode_chunk`` is the number of device-resident greedy steps per
    host sync (1 = the per-token reference loop).  ``graphs=False`` runs
    the decode and admission programs eagerly on the card instead of
    replaying them."""

    def __init__(self, params, cfg: ModelConfig, *,
                 max_slots: int = DEFAULT_MAX_SLOTS,
                 max_seq_len: int = 256, decode_chunk: int = 8,
                 clock: Callable[[], float] = time.perf_counter,
                 device="cuda", graphs: bool = True):
        cfg.check_ported()
        self.device = resolve_device(device)
        if _param_device(params).type != self.device.type:
            raise ValueError(f"params lie on {_param_device(params)}, the "
                             f"engine was asked for {self.device}")
        self.params = params
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self.decode_chunk = max(1, decode_chunk)
        self.queue = RequestQueue()
        capture = graphs and self.device.type == "cuda"
        # every program of the engine (decode, chunk, each prompt length's
        # admission) captures into this one pool: they never run at once
        pool = torch.cuda.graph_pool_handle() if capture else None
        self.kv = SlotKVCache(cfg, max_slots, max_seq_len,
                              device=self.device, graphs=capture, pool=pool)
        self._decode = DecodeGraph(_decode_fn(cfg), params, self.kv.data,
                                   max_slots, name="decode",
                                   capture=capture, pool=pool)
        self._decode_chunk = DecodeGraph(
            _decode_chunk_fn(cfg, self.decode_chunk), params, self.kv.data,
            max_slots, name="decode_chunk", capture=capture, pool=pool) \
            if self.decode_chunk > 1 else None
        self.stats = {"rejected": 0, "peak_active": 0, "decode_steps": 0}
        self._slots: list[Optional[_SlotState]] = [None] * max_slots
        self._pos = np.zeros(max_slots, np.int32)   # next write position
        self._tok = np.zeros(max_slots, np.int32)   # last sampled token
        self._outputs: list[RequestOutput] = []
        self._clock = clock
        self._t0: Optional[float] = None

    # -- introspection ----------------------------------------------------
    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self._slots)

    def free_slots(self) -> list:
        return [i for i, s in enumerate(self._slots) if s is None]

    def reset_metrics(self) -> None:
        """Forget the finished outputs, the stats and the clock (the
        programs, and what they captured, stay)."""
        assert not self.num_active and not len(self.queue), \
            "reset_metrics with requests in flight"
        self._outputs = []
        self._t0 = None
        self.stats = {"rejected": 0, "peak_active": 0, "decode_steps": 0}

    def _now(self) -> float:
        if self._t0 is None:
            self._t0 = self._clock()
        return self._clock() - self._t0

    # -- request lifecycle ------------------------------------------------
    def submit(self, req: Request) -> None:
        """Enqueue a request; a prompt longer than the per-slot capacity
        raises :class:`PromptTooLongError`."""
        S = int(req.prompt.size)
        if S > self.max_seq_len:
            raise PromptTooLongError(
                f"request {req.uid}: prompt length {S} exceeds the "
                f"per-slot capacity {self.max_seq_len}")
        self.queue.push(req)

    def _reject(self, req: Request, now: float) -> None:
        self._outputs.append(RequestOutput(
            uid=req.uid, prompt_len=int(req.prompt.size), tokens=[],
            finish_reason="rejected", arrival_time=req.arrival_time,
            admitted_time=now, finish_time=self._now(), token_times=[],
            deadline=req.deadline))
        self.stats["rejected"] += 1

    def _admit(self, slot: int, req: Request, now: float) -> None:
        """Prefill ``req`` into ``slot`` (its prompt length's admission
        program) and sample its first token."""
        logits = self.kv.write_prefill(self.params, req.prompt[None], slot)
        S = int(req.prompt.size)
        # token i (1-based) is written at position S + i - 1, so N tokens
        # need S + N - 1 <= max_seq_len
        max_new = min(req.max_new_tokens, self.max_seq_len - S + 1)
        st = _SlotState(req=req, tokens=[], token_times=[],
                        admitted_time=now,
                        rng=np.random.default_rng(req.sampling.seed),
                        max_new=max_new)
        tok = sample_token(logits[0].float().cpu().numpy(), req.sampling,
                           st.rng)
        st.tokens.append(tok)
        st.token_times.append(self._now())
        self._slots[slot] = st
        self._pos[slot] = S
        self._tok[slot] = tok
        if self._stopped(st, tok):
            self._finish(slot)

    def _stopped(self, st: _SlotState, tok: int) -> bool:
        return tok in st.req.stop_tokens or len(st.tokens) >= st.max_new

    def _finish(self, slot: int) -> None:
        st = self._slots[slot]
        reason = "stop" if st.tokens[-1] in st.req.stop_tokens else "length"
        self._outputs.append(RequestOutput(
            uid=st.req.uid, prompt_len=int(st.req.prompt.size),
            tokens=list(st.tokens), finish_reason=reason,
            arrival_time=st.req.arrival_time,
            admitted_time=st.admitted_time, finish_time=self._now(),
            token_times=list(st.token_times), deadline=st.req.deadline))
        self._slots[slot] = None
        self._pos[slot] = 0
        self._tok[slot] = 0

    # -- the engine loop --------------------------------------------------
    def step(self) -> int:
        """One scheduler iteration: admit ready requests into free slots,
        then run one decode chunk over the batch.  Returns the number of
        tokens produced."""
        now = self._now()
        produced = 0
        free = self.free_slots()
        while free:
            req = self.queue.pop_ready(now)
            if req is None:
                break
            try:
                self._admit(free[0], req, now)
            except PromptTooLongError:
                self._reject(req, now)
                continue
            free.pop(0)
            produced += 1  # the first token, sampled from prefill logits
        active = [i for i, s in enumerate(self._slots) if s is not None]
        self.stats["peak_active"] = max(self.stats["peak_active"],
                                        len(active))
        if not active:
            return produced
        if self.decode_chunk > 1 and all(
                self._slots[s].req.sampling.greedy for s in active):
            return produced + self._step_chunked(active)
        return produced + self._step_single(active)

    def _step_single(self, active) -> int:
        """Per-token path: one decode step, host-side sampling."""
        logits = self._decode.run(self._tok, self._pos)
        self.stats["decode_steps"] += 1
        logits_np = logits.float().cpu().numpy()
        t = self._now()
        produced = 0
        for slot in active:
            st = self._slots[slot]
            nxt = sample_token(logits_np[slot], st.req.sampling, st.rng)
            st.tokens.append(nxt)
            st.token_times.append(t)
            self._pos[slot] += 1
            self._tok[slot] = nxt
            produced += 1
            if self._stopped(st, nxt):
                self._finish(slot)
        return produced

    def _step_chunked(self, active) -> int:
        """Greedy fast path: ``decode_chunk`` steps on the device, then one
        host fetch of the [T, max_slots] token block.  The chunk always
        runs its full length; tokens past a request's stop are discarded
        on the host.  Per-token timestamps spread the chunk's measured
        latency evenly over its tokens."""
        T = self.decode_chunk
        t0 = self._now()
        toks = self._decode_chunk.run(self._tok, self._pos)
        self.stats["decode_steps"] += T
        toks_np = toks.cpu().numpy()        # the one host sync per chunk
        t1 = self._now()
        produced = 0
        for slot in active:
            st = self._slots[slot]
            for t in range(T):
                nxt = int(toks_np[t, slot])
                st.tokens.append(nxt)
                st.token_times.append(t0 + (t + 1) * (t1 - t0) / T)
                self._pos[slot] += 1
                self._tok[slot] = nxt
                produced += 1
                if self._stopped(st, nxt):
                    self._finish(slot)
                    break
        return produced

    def run(self, requests: Iterable[Request] = (),
            max_steps: int = 1_000_000) -> list:
        """Serve until the queue drains and every slot finishes; returns
        the outputs finished during this call, in uid order."""
        first_new = len(self._outputs)
        for req in requests:
            try:
                self.submit(req)
            except PromptTooLongError:
                self._reject(req, self._now())
        if self._t0 is None:
            self._t0 = self._clock()
        steps = 0
        while (len(self.queue) or self.num_active) and steps < max_steps:
            before = self.num_active
            self.step()
            steps += 1
            if not before and not self.num_active and len(self.queue):
                # idle with traffic still due: wait for the next arrival,
                # warping a clock that does not advance by itself
                nxt = self.queue.next_arrival()
                remaining = nxt - self._now()
                if remaining > 0:
                    t_before = self._clock()
                    time.sleep(min(remaining, 0.05))
                    if self._clock() <= t_before:
                        self._t0 -= remaining
        return sorted(self._outputs[first_new:], key=lambda o: o.uid)

    def metrics(self, *, label: str = "serve") -> ServeMetrics:
        wall = self._now() if self._t0 is not None else 0.0
        return summarize(self._outputs, wall, label=label)


def _has_nmg(tree) -> bool:
    if isinstance(tree, dict):
        return any(_has_nmg(v) for v in tree.values())
    return isinstance(tree, GroupedNMTensor)


def warmup_engine(engine: ServeEngine, requests, *, tune: bool = False,
                  tune_reps: int = 3) -> ServeEngine:
    """Serve a tiny trace through ``engine`` (the one to be measured), so
    a measured run of ``requests`` does not include first-call costs
    (kernel builds, allocator growth, program builds): one greedy request
    per distinct prompt length, two tokens each, builds every length's
    admission program and the greedy decode program; when ``requests``
    hold a sampled request, one more run of it alone builds the
    single-step program.  Then clears the engine's outputs, stats and
    clock.  Returns ``engine``.

    With ``tune=True`` it first tunes the kernel routing for the engine's
    n:m:g weights (``tune/bench.py:autotune_for_serving``: each weight's
    GEMV/SpMM crossover at ``max_slots`` and the trace's prompt lengths,
    on the card the kernels' configs, the fused groups' decisions) and
    activates the table, merged into any already active.  The order is the
    point: a CUDA graph freezes the routes active at its capture, so the
    table must be active before the programs this warmup builds; tuning
    an engine whose programs are built changes none of them."""
    if tune and _has_nmg(engine.params):
        from repro_torch.tune.bench import autotune_for_serving

        cfg = engine.cfg
        autotune_for_serving(
            engine.params, max_slots=engine.max_slots,
            prompt_lens=sorted({int(r.prompt.size) for r in requests})
            or [8], dtype=cfg.tdtype, reps=tune_reps,
            gated_act=cfg.act if cfg.gated_mlp else None)
    seen, greedy, sampled = set(), [], None
    for r in requests:
        if r.prompt.size not in seen:
            seen.add(r.prompt.size)
            greedy.append(Request(uid=-1 - len(greedy), prompt=r.prompt,
                                  max_new_tokens=2))
        if sampled is None and not r.sampling.greedy:
            sampled = Request(uid=-1 - len(seen), prompt=r.prompt,
                              max_new_tokens=2, sampling=r.sampling)
    engine.run(greedy)
    if sampled is not None:
        engine.run([sampled])
    engine.reset_metrics()
    return engine


def compare_dense_sparse(params, cfg: ModelConfig, requests, *,
                         nm: tuple = (1, 4, 16), gr: int = 64,
                         engine_kwargs: Optional[dict] = None,
                         warmup: bool = False, tune: bool = False) -> dict:
    """Serve the same trace with dense and n:m:g weights: returns
    {'dense': (outputs, metrics), 'sparse': (outputs, metrics)}.
    ``warmup`` warms each engine first; ``tune`` also tunes the sparse
    variant's routing in its warmup (:func:`warmup_engine`; the dense
    variant has no n:m:g weight to tune)."""
    engine_kwargs = dict(engine_kwargs or {})
    requests = list(requests)
    results = {}
    for label, p in (
        ("dense", params),
        ("sparse", sparsify_for_serving(params, *nm, gr=gr)),
    ):
        eng = ServeEngine(p, cfg, **engine_kwargs)
        if warmup:
            warmup_engine(eng, requests, tune=tune)
        outs = eng.run(requests)
        results[label] = (outs, eng.metrics(label=label))
    return results
