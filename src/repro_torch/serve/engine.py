"""Continuous-batching serving engine (port of ``repro/serve/engine.py``,
with its slot and paged KV caches, the SLO control loop, resident
sparsity tiers, seeded fault injection and the bounded queue).

The engine holds a static batch of ``max_slots`` sequences.  Between
decode steps it admits queued requests into free slots (prefill writes a
request's K/V straight into its slot) and every decode step advances all
occupied slots at their own positions.  When every active request is
greedy, ``decode_chunk`` steps run back to back on the device with
on-device argmax and the token block reaches the host in one sync per
chunk; otherwise one step at a time with host-side sampling.

With ``paged=True`` the KV cache is a
:class:`~repro_torch.serve.cache.PagedKVCache`: decode runs the same
``decode_step`` over a gathered slot-major view of the page pool and
commits the rows it wrote, so the tokens are the slot engine's; what
changes is capacity.  An admission that cannot get its pages is deferred
(the request returns to the queue head, live slots untouched), and a
decode that cannot get its pages preempts the youngest slot, whose
request is served again from scratch (the same tokens: greedy decoding,
and a sampled request restarts its seeded stream).

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

**The SLO loop** (``slo=``, ``tiers=``, ``faults=``, ``max_queue=``) is
the reference's: between decode calls the engine expires and sheds queued
work, asks :class:`~repro_torch.serve.slo.SLOController` for a level (an
admission budget, a decode chunk of ``decode_chunk`` or ``decode_chunk //
chunk_shrink`` steps, a weight tier), and runs the fault injector's
host-side hooks around each decode call, retrying injected errors with
capped exponential backoff.  The reference's tier switch is a pytree
pointer swap into compiled programs; a CUDA graph holds the addresses of
the params it captured, so here each tier owns its programs: one decode
program per chunk length (the base chunk, the shrunk chunk, the single
step) and one admission per prompt length (in the cache), keyed by tier
index.  :meth:`ServeEngine.set_tier` only changes which of them run, and
:meth:`ServeEngine.warm_tiers` builds every one of them on this engine's
own cache, so serving builds nothing after it.  A fault hook raises or
sleeps before the program's inputs are copied in or after its output is
read, never in between, so a retried call replays the same program on the
same static inputs.  Without ``slo``, ``tiers`` and ``faults`` the engine
runs exactly the programs and launches it ran before the loop existed.

An enc-dec model (whisper) is refused at construction
(:func:`check_servable`): requests carry no encoder frames, so the
reference's engine fails at its first admission.  Its requests are
admitted by ``prefill_into_slot(enc_embeds=)`` into a
``SlotKVCache(enc_len=)`` and decoded by this module's decode programs
(``_decode_fn`` / ``_decode_chunk_fn`` in a ``DecodeGraph``) over that
cache.
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
from repro_torch.kernels import ops as kops
from repro_torch.models import decode_step, init_cache, prefill
from repro_torch.models.common import ModelConfig
from repro_torch.obs import trace as obs
from repro_torch.obs.registry import REGISTRY, MirroredCounters
from repro_torch.serve.cache import PagedKVCache, SlotKVCache, \
    paged_commit, paged_view
from repro_torch.serve.errors import EngineOverloadError, \
    InjectedFaultError, PromptTooLongError, ServeError
from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.graphs import DecodeGraph, PagedDecodeGraph
from repro_torch.serve.metrics import ServeMetrics, summarize
from repro_torch.serve.queue import Request, RequestOutput, RequestQueue, \
    sample_token
from repro_torch.serve.slo import LatencyModel, SLOConfig, SLOController, \
    build_tiers

__all__ = ["ServeEngine", "sparsify_for_serving", "compare_dense_sparse",
           "warmup_engine", "decode_chunk", "serve_programs",
           "check_servable"]

DEFAULT_MAX_SLOTS = 8


def sparsify_for_serving(params, n: int = 1, m: int = 4, g: int = 16,
                         gr: int = 64, *, attn: bool = False):
    """Convert the FFN weights (and with ``attn=True`` also wq/wk/wv/wo) to
    the n:m:g serving layout, ``gr`` rows sharing each chunk permutation
    (the globs match a pair layout's ``layers.local.*`` and
    ``layers.global.*`` too; ``*attn.wq`` matches an enc-dec decoder's
    ``layers.xattn.wq`` as well, and the encoder's ``enc_layers.*``).  With ``attn=True`` q/k/v share one format over one contraction axis and
    decode routes them through the fused QKV launch.  A gated MLP's packed
    [D, 2F] ``wi`` converts as one weight; when 2F needs no row padding
    and F is a multiple of ``gr`` (qwen1.5-4b: 2F = 13824 = 216 x 64; its
    SMOKE: 256 = 16 x 16), decode routes it through the fused FFN launch
    (``fusable_ffn``), else through the GEMV and a separate gate.  The
    globs are the reference's and match no ``moe.*`` leaf: in a MoE model
    (moonshot, arctic) the experts, router and dense residual stay dense
    and are shared with ``params``, so n:m:g converts attention alone,
    with ``attn=True``, and nothing without it.  Nor do they match an
    SSM mixer's ``ssm.*`` leaves: hymba's stay dense and nothing of
    mamba2 is converted (a ``SparsityBuilder`` plan on ``*ssm.in_proj``
    / ``*ssm.out_proj`` converts those)."""
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


def _paged_decode_fn(cfg: ModelConfig, page_size: int, num_pages: int):
    """The paged one-step program (the reference's ``_jit_paged_decode``):
    gather the view through the table, one ``decode_step`` on it, commit
    the written row; logits [B, V], the pool updated in place."""

    def step(p, tok, pool, table, pos):
        view = paged_view(cfg, pool, table, page_size)
        logits = decode_step(p, cfg, tok, view, pos)[0]
        paged_commit(cfg, pool, view, table, pos, 1, page_size, num_pages)
        return logits

    return step


def _paged_decode_chunk_fn(cfg: ModelConfig, page_size: int,
                           num_pages: int, n_steps: int):
    """The paged chunk program (the reference's
    ``_jit_paged_decode_chunk``): one gather, ``n_steps`` greedy steps
    over the view (the slot engine's loop, so tokens match it bitwise),
    one commit of the ``n_steps`` written rows; the [n_steps, B] token
    block."""

    def chunk(p, tok, pool, table, pos):
        view = paged_view(cfg, pool, table, page_size)
        toks = decode_chunk(p, cfg, tok, view, pos, n_steps)[0]
        paged_commit(cfg, pool, view, table, pos, n_steps, page_size,
                     num_pages)
        return toks

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


def check_servable(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a model the engine cannot serve: an
    enc-dec model, whose requests would need encoder frames."""
    if cfg.n_enc_layers > 0:
        raise ValueError(
            f"{cfg.name!r} is an enc-dec model and the engine takes no "
            f"encoder inputs: admit each request with "
            f"`prefill_into_slot(enc_embeds=)` into a "
            f"`SlotKVCache(enc_len=)` and decode with the engine's decode "
            f"programs")


def _param_device(params) -> torch.device:
    return params["embedding"].device


class ServeEngine:
    """Continuous-batching engine over a slot or a paged KV cache.

    ``params`` may hold dense or n:m:g weights and must lie on ``device``
    (default ``"cuda"``; pass ``device="cpu"`` for the plain versions).
    ``decode_chunk`` is the number of device-resident greedy steps per
    host sync (1 = the per-token reference loop).  ``graphs=False`` runs
    the decode and admission programs eagerly on the card instead of
    replaying them.  ``reset_freed_slots`` zeroes a finished request's
    cache (its slot row, or the pages its release frees): admission
    overwrites what it reads and decode masks each slot to its prefix,
    so it is off by default; tests use it for slot isolation.  ``paged``
    backs the cache with :class:`PagedKVCache` (``page_size``,
    ``num_pages`` and ``prefix_sharing`` are forwarded to it).  An
    enc-dec model raises ``ValueError`` (:func:`check_servable`).

    ``slo`` (:class:`~repro_torch.serve.slo.SLOConfig`) turns on the SLO
    control loop; ``tiers`` (specs densest first: ``"dense"``, ``"2:4"``,
    ``"1:4:8-gr64"`` or :class:`~repro_torch.serve.slo.TierSpec`) converts
    ``params``, which must then be the dense weights, once per tier and
    keeps every copy resident (call :meth:`warm_tiers` before serving);
    ``faults`` (:class:`~repro_torch.serve.faults.FaultInjector`) wraps
    the decode and admission paths; ``max_queue`` bounds the queue
    (``submit`` past it raises
    :class:`~repro_torch.serve.errors.EngineOverloadError`)."""

    def __init__(self, params, cfg: ModelConfig, *,
                 max_slots: int = DEFAULT_MAX_SLOTS,
                 max_seq_len: int = 256, reset_freed_slots: bool = False,
                 decode_chunk: int = 8,
                 clock: Callable[[], float] = time.perf_counter,
                 paged: bool = False, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 prefix_sharing: bool = True,
                 slo: Optional[SLOConfig] = None,
                 tiers: Optional[Iterable] = None,
                 faults: Optional[FaultInjector] = None,
                 max_queue: Optional[int] = None,
                 device="cuda", graphs: bool = True):
        cfg.check_ported()
        check_servable(cfg)
        self.device = resolve_device(device)
        if _param_device(params).type != self.device.type:
            raise ValueError(f"params lie on {_param_device(params)}, the "
                             f"engine was asked for {self.device}")
        self.params = params
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self.reset_freed_slots = reset_freed_slots
        self.decode_chunk = max(1, decode_chunk)
        self.paged = paged
        self.queue = RequestQueue()
        self.faults = faults
        self.max_queue = max_queue
        self.tiers = build_tiers(params, list(tiers)) if tiers else None
        self.tier_idx = 0
        if self.tiers:
            self.params = self.tiers[0].params
        self.tokens_by_tier = (
            {t.spec.name: 0 for t in self.tiers} if self.tiers else None)
        self.slo = slo
        if slo is not None:
            self._latency = LatencyModel(self.params, cfg,
                                         max_slots=max_slots)
            self._controller: Optional[SLOController] = SLOController(
                slo, n_tiers=len(self.tiers) if self.tiers else 1,
                max_slots=max_slots, latency=self._latency)
        else:
            self._latency = None
            self._controller = None
        #: decode lengths this engine may run: the base chunk, the
        #: controller's shrunk chunk, and 1 (the single step: sampled
        #: requests, a paged pool short of a chunk's pages)
        self._chunk_sizes = sorted({self.decode_chunk, 1} | (
            {max(1, self.decode_chunk // max(1, slo.chunk_shrink))}
            if slo is not None else set()))
        self._decode_calls = 0  # global decode-call index (fault schedule)
        capture = graphs and self.device.type == "cuda"
        # every program of the engine (each tier's decode programs and
        # admissions) captures into this one pool: they never run at once
        pool = torch.cuda.graph_pool_handle() if capture else None
        if paged:
            self.kv = PagedKVCache(
                cfg, max_slots, max_seq_len, page_size=page_size,
                num_pages=num_pages, prefix_sharing=prefix_sharing,
                device=self.device, graphs=capture, pool=pool)
        else:
            self.kv = SlotKVCache(cfg, max_slots, max_seq_len,
                                  device=self.device, graphs=capture,
                                  pool=pool)
        #: {(tier, steps): decode program}; steps 1 is the single step
        #: (logits), more a greedy chunk (the token block)
        self._programs = {
            (t, T): self._decode_program(p, T, capture, pool)
            for t, p in enumerate(
                [t.params for t in self.tiers] if self.tiers else [params])
            for T in self._chunk_sizes}
        self.stats = self._fresh_stats()
        # chunked decode falls back to single steps once a lone slot
        # cannot get a whole chunk's pages; cleared when a request
        # finishes and frees pages (_ensure_decode_pages)
        self._force_single = False
        self._slots: list[Optional[_SlotState]] = [None] * max_slots
        self._pos = np.zeros(max_slots, np.int32)   # next write position
        self._tok = np.zeros(max_slots, np.int32)   # last sampled token
        self._outputs: list[RequestOutput] = []
        self._clock = clock
        self._t0: Optional[float] = None

    def _decode_program(self, params, T: int, capture: bool, pool):
        """The decode program of ``T`` steps over ``params`` (the
        reference's ``_jit_decode`` for 1, ``_jit_decode_chunk`` for
        more, or their paged counterparts)."""
        cfg = self.cfg
        if self.paged:
            ps, npg = self.kv.page_size, self.kv.num_pages
            fn = (_paged_decode_fn(cfg, ps, npg) if T == 1 else
                  _paged_decode_chunk_fn(cfg, ps, npg, T))
            return PagedDecodeGraph(
                fn, params, self.kv.data, self.max_slots,
                self.kv.pages_per_slot,
                name="paged_decode" if T == 1 else "paged_decode_chunk",
                capture=capture, graph_pool=pool)
        fn = _decode_fn(cfg) if T == 1 else _decode_chunk_fn(cfg, T)
        return DecodeGraph(fn, params, self.kv.data, self.max_slots,
                           name="decode" if T == 1 else "decode_chunk",
                           capture=capture, pool=pool)

    @property
    def _decode(self):
        """The current tier's single-step program."""
        return self._programs[(self.tier_idx, 1)]

    @property
    def _decode_chunk(self):
        """The current tier's base-chunk program (None at chunk 1)."""
        return self._chunk_fn(self.decode_chunk) \
            if self.decode_chunk > 1 else None

    def _chunk_fn(self, T: int):
        """The current tier's decode program of ``T`` steps."""
        return self._programs[(self.tier_idx, T)]

    # -- introspection ----------------------------------------------------
    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self._slots)

    def free_slots(self) -> list:
        return [i for i, s in enumerate(self._slots) if s is None]

    def reset_metrics(self) -> None:
        """Forget the finished outputs, the stats (a paged cache's too),
        the tokens by tier, the clock and the decode-call index the fault
        schedule reads (the programs, and what they captured, stay)."""
        assert not self.num_active and not len(self.queue), \
            "reset_metrics with requests in flight"
        self._outputs = []
        self._t0 = None
        self._decode_calls = 0
        self.stats = self._fresh_stats()
        if self.tokens_by_tier is not None:
            self.tokens_by_tier = dict.fromkeys(self.tokens_by_tier, 0)
        if self.paged:
            self.kv.reset_stats()

    @staticmethod
    def _fresh_stats() -> dict:
        """Scheduler counters: deferred admissions and preemptions (paged
        only), rejected requests, peak active slots, decode steps, and the
        SLO loop's shed, timed-out, fault-retried and tier-switch counts.
        A plain dict to read and write; increases are mirrored into the
        registry's ``engine_stats`` family."""
        return MirroredCounters(
            {"deferred_admissions": 0, "preemptions": 0, "rejected": 0,
             "peak_active": 0, "decode_steps": 0, "shed": 0, "timeout": 0,
             "fault_retries": 0, "tier_switches": 0},
            REGISTRY.family("engine_stats",
                            help="engine scheduler counters"))

    def _now(self) -> float:
        if self._t0 is None:
            self._t0 = self._clock()
        return self._clock() - self._t0

    def _abs(self, rel: float) -> float:
        """Engine-relative seconds back to the clock's absolute domain,
        what the flight recorder's retroactive spans take."""
        return (self._t0 or 0.0) + rel

    # -- request lifecycle ------------------------------------------------
    def submit(self, req: Request) -> None:
        """Enqueue a request.  A prompt longer than the per-slot capacity
        raises :class:`PromptTooLongError`; a full bounded queue raises
        :class:`EngineOverloadError` (after dumping the flight recorder,
        when it is on).  :meth:`run` turns both into ``"rejected"``
        outputs."""
        S = int(req.prompt.size)
        if S > self.max_seq_len:
            raise PromptTooLongError(
                f"request {req.uid}: prompt length {S} exceeds the "
                f"per-slot capacity {self.max_seq_len}")
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            obs.event("overload_reject", "engine", uid=req.uid,
                      queue_depth=len(self.queue))
            obs.postmortem("EngineOverloadError")
            raise EngineOverloadError(
                f"request {req.uid}: queue is at its bound "
                f"({self.max_queue}); retry later or raise max_queue")
        self.queue.push(req)

    def _reject(self, req: Request, now: float) -> None:
        self._outputs.append(RequestOutput(
            uid=req.uid, prompt_len=int(req.prompt.size), tokens=[],
            finish_reason="rejected", arrival_time=req.arrival_time,
            admitted_time=now, finish_time=self._now(), token_times=[],
            deadline=req.deadline))
        self.stats["rejected"] += 1
        obs.event("rejected", f"req:{req.uid}", uid=req.uid)

    def _finish_unserved(self, req: Request, now: float,
                         reason: str) -> None:
        """Terminal outcome of a request that never held a slot:
        ``"timeout"`` (its deadline passed while queued, or its predicted
        finish would) or ``"shed"`` (the controller dropped it)."""
        self._outputs.append(RequestOutput(
            uid=req.uid, prompt_len=int(req.prompt.size), tokens=[],
            finish_reason=reason, arrival_time=req.arrival_time,
            admitted_time=now, finish_time=self._now(), token_times=[],
            deadline=req.deadline))
        self.stats[reason] += 1
        if obs.enabled():
            obs.complete("queued", self._abs(req.arrival_time),
                         self._abs(self._now()), f"req:{req.uid}",
                         uid=req.uid, outcome=reason)
            obs.event(reason, f"req:{req.uid}", uid=req.uid)

    def _admit(self, slot: int, req: Request, now: float) -> bool:
        """Prefill ``req`` into ``slot`` (its prompt length's admission
        program) and sample its first token.  Returns False, leaving the
        slot free and the cache untouched, when the paged pool cannot
        supply the prompt's pages."""
        if self.faults is not None:
            self.faults.admission_delay()
        t_pre = self._now()
        if self.paged:
            logits = self.kv.admit(self.params, req.prompt[None], slot,
                                   tier=self.tier_idx)
            if logits is None:
                return False
        else:
            logits = self.kv.write_prefill(self.params, req.prompt[None],
                                           slot, tier=self.tier_idx)
        S = int(req.prompt.size)
        logits_np = logits[0].float().cpu().numpy()   # the admission's end
        if self._latency is not None:
            self._latency.observe_prefill(S, self._now() - t_pre)
        if obs.enabled():
            # the request's row: queued (arrival to admission), then the
            # admission's prefill
            obs.complete("queued", self._abs(req.arrival_time),
                         self._abs(now), f"req:{req.uid}", uid=req.uid)
            obs.complete("prefill", self._abs(t_pre),
                         self._abs(self._now()), f"req:{req.uid}",
                         uid=req.uid, slot=slot, prompt_len=S,
                         tier=self.tier_idx)
        # token i (1-based) is written at position S + i - 1, so N tokens
        # need S + N - 1 <= max_seq_len
        max_new = min(req.max_new_tokens, self.max_seq_len - S + 1)
        st = _SlotState(req=req, tokens=[], token_times=[],
                        admitted_time=now,
                        rng=np.random.default_rng(req.sampling.seed),
                        max_new=max_new)
        tok = sample_token(logits_np, req.sampling, st.rng)
        st.tokens.append(tok)
        st.token_times.append(self._now())
        self._slots[slot] = st
        self._pos[slot] = S
        self._tok[slot] = tok
        if self._stopped(st, tok):
            self._finish(slot)
        return True

    def _stopped(self, st: _SlotState, tok: int) -> bool:
        return tok in st.req.stop_tokens or len(st.tokens) >= st.max_new

    def _finish(self, slot: int) -> None:
        st = self._slots[slot]
        reason = "stop" if st.tokens[-1] in st.req.stop_tokens else "length"
        obs.event("finish", f"req:{st.req.uid}", uid=st.req.uid,
                  reason=reason, tokens=len(st.tokens))
        self._outputs.append(RequestOutput(
            uid=st.req.uid, prompt_len=int(st.req.prompt.size),
            tokens=list(st.tokens), finish_reason=reason,
            arrival_time=st.req.arrival_time,
            admitted_time=st.admitted_time, finish_time=self._now(),
            token_times=list(st.token_times), deadline=st.req.deadline))
        self._vacate(slot)
        if self.paged:
            self.kv.release_slot(slot, zero=self.reset_freed_slots)
            self._force_single = False  # pages freed: chunks may fit again
        elif self.reset_freed_slots:
            self.kv.reset(slot)

    def _vacate(self, slot: int) -> None:
        self._slots[slot] = None
        self._pos[slot] = 0
        self._tok[slot] = 0

    def _preempt(self, slot: int) -> None:
        """Evict an active slot mid-stream: free its pages and return its
        request to the queue head.  Its tokens are discarded; served
        again, the request reproduces them (greedy decoding, or its
        seeded sampling stream restarted)."""
        st = self._slots[slot]
        self.kv.release_slot(slot)
        self._vacate(slot)
        self.queue.push_front(st.req)
        self.stats["preemptions"] += 1
        obs.event("preempt", f"req:{st.req.uid}", uid=st.req.uid, slot=slot,
                  tokens_discarded=len(st.tokens))

    def _ensure_decode_pages(self, active, n_steps: int):
        """Before a paged decode of ``n_steps``, make every active slot's
        write range mapped and private.  When the pool runs dry the
        youngest active slot is preempted and the rest retry (the oldest
        keep their pages).  Returns the surviving slots, or None when a
        lone slot cannot fit a multi-step chunk (the caller then decodes
        single steps, which need at most one new page).  A lone slot
        that cannot get even one page is rejected: its prompt fits, but
        with nothing left to preempt it would requeue forever."""
        pending = sorted(active,
                         key=lambda s: (self._slots[s].admitted_time, s))
        ok: list = []
        while pending:
            slot = pending[0]
            if self.kv.ensure_writable_range(slot, int(self._pos[slot]),
                                             n_steps):
                ok.append(pending.pop(0))
                continue
            if not ok and len(pending) == 1:
                if n_steps > 1:
                    return None  # retry as single steps before evicting
                st = self._slots[slot]
                self.kv.release_slot(slot)
                self._vacate(slot)
                self._reject(st.req, st.admitted_time)
                break
            self._preempt(pending.pop())
        return sorted(ok)

    # -- sparsity tiers ---------------------------------------------------
    def set_tier(self, idx: int, reason: Optional[str] = None) -> None:
        """Serve from tier ``idx``'s resident weight copy: its decode
        programs and admissions run from now on (after :meth:`warm_tiers`
        none is built).  ``reason`` annotates the timeline event."""
        if self.tiers is None:
            raise ValueError("engine was built without tiers")
        if idx == self.tier_idx:
            return
        obs.event("tier_switch", "controller",
                  tier_from=self.tiers[self.tier_idx].spec.name,
                  tier_to=self.tiers[idx].spec.name,
                  reason=reason or "manual")
        self.params = self.tiers[idx].params
        self.tier_idx = idx
        self.stats["tier_switches"] += 1

    def warm_tiers(self, prompt_lens: Iterable[int] = (8,)) -> None:
        """Build every program the controller may run, on this engine's
        own cache: for each tier (one, without tiers) each decode length
        of ``_chunk_sizes`` and each prompt length's admission.  Each
        program runs once (on the card: eagerly, then it is captured),
        on an idle engine: the admissions write slot 0 (the paged ones
        the sink page), the decode programs every slot at position 0,
        rows the next admission overwrites.  After it, tier switches and
        chunk shrinks build nothing (``trace_events()`` stays flat).
        Launch counters are put back: warming serves nothing."""
        assert not self.num_active, "warm_tiers with requests in flight"
        plens = sorted({int(p) for p in prompt_lens}) or [8]
        snap = kops.counter_snapshot()
        tiers = [t.params for t in self.tiers] if self.tiers else \
            [self.params]
        try:
            for t, params in enumerate(tiers):
                for S in plens:
                    self.kv.warm(params, S, t)
                for T in self._chunk_sizes:
                    self._run(self._programs[(t, T)])
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            kops.restore_counters(snap)

    # -- fault hooks -------------------------------------------------------
    def _fault_gate(self, step_idx: int) -> None:
        """The injector's pre-decode gate, injected transient faults
        retried with capped exponential backoff.  A burst outlasting
        ``max_retries`` propagates (a real outage, not jitter).  It runs
        before the decode program's inputs are copied in, so a retry
        replays the same program on the same inputs."""
        f = self.faults
        if f is None:
            return
        attempt = 0
        while True:
            try:
                f.pre_decode(step_idx)
                return
            except InjectedFaultError:
                if attempt >= f.cfg.max_retries:
                    obs.event("fault_retries_exhausted", "faults",
                              step=step_idx, attempts=attempt)
                    raise
                self.stats["fault_retries"] += 1
                obs.event("fault_retry", "faults", step=step_idx,
                          attempt=attempt)
                f.sleep(min(f.cfg.backoff_s * (2 ** attempt),
                            f.cfg.backoff_cap_s))
                attempt += 1

    def _fault_post(self, step_idx: int, measured_s: float) -> None:
        if self.faults is not None:
            self.faults.post_decode(step_idx, measured_s)

    def _count_tokens(self, produced: int) -> None:
        if self.tokens_by_tier is not None and produced:
            self.tokens_by_tier[
                self.tiers[self.tier_idx].spec.name] += produced

    # -- the engine loop --------------------------------------------------
    def step(self) -> int:
        """One scheduler iteration: expire and shed queued work, let the
        SLO controller pick its level (and the tier), admit ready
        requests into free slots (all of them when steady, a rationed
        budget when degraded; a paged admission that cannot get its pages
        returns the request to the queue head and ends admission for this
        step), then run one decode call over the batch (a chunk when every
        active request is greedy, one host-paced step otherwise).  Returns
        the number of tokens produced."""
        now = self._now()
        produced = 0
        for req in self.queue.expired(now):
            self._finish_unserved(req, now, "timeout")
        ctrl = self._controller
        if ctrl is not None:
            # only requests that have arrived count as queued work: a trace
            # submitted whole holds future arrivals (ROADMAP C14)
            arrived = self.queue.num_arrived(now)
            ctrl.begin_step(now, arrived)
            if self.tiers is not None:
                self.set_tier(ctrl.tier_index,
                              reason=f"slo:{ctrl.last_reason}")
            if ctrl.should_shed(arrived):
                for req in self.queue.shed(ctrl.shed_keep(), now):
                    self._finish_unserved(req, now, "shed")
        free = self.free_slots()
        budget = len(free) if ctrl is None \
            else ctrl.admission_budget(len(free))
        while free and budget > 0:
            req = self.queue.pop_ready(now)
            if req is None:
                break
            if req.deadline is not None and self._latency is not None:
                # a request that cannot finish inside its deadline times
                # out now, without taking a slot
                est = self._latency.request_s(
                    int(req.prompt.size),
                    min(req.max_new_tokens,
                        self.max_seq_len - int(req.prompt.size) + 1))
                if est == est and now + est > req.deadline:
                    self._finish_unserved(req, now, "timeout")
                    continue
            try:
                admitted = self._admit(free[0], req, now)
            except PromptTooLongError:
                self._reject(req, now)
                continue
            if not admitted:
                self.queue.push_front(req)
                self.stats["deferred_admissions"] += 1
                break
            free.pop(0)
            budget -= 1
            produced += 1  # the first token, sampled from prefill logits
        active = [i for i, s in enumerate(self._slots) if s is not None]
        self.stats["peak_active"] = max(self.stats["peak_active"],
                                        len(active))
        if not active:
            self._count_tokens(produced)
            return produced
        T = self.decode_chunk if ctrl is None \
            else ctrl.decode_chunk(self.decode_chunk)
        if T > 1 and not self._force_single and all(
                self._slots[s].req.sampling.greedy for s in active):
            produced += self._step_chunked(active, T)
        else:
            produced += self._step_single(active)
        self._count_tokens(produced)
        return produced

    def _run(self, program):
        """Run a decode program on the engine's tokens and positions (and
        the page table, paged)."""
        if self.paged:
            return program.run(self._tok, self._pos, self.kv.table)
        return program.run(self._tok, self._pos)

    def _step_single(self, active) -> int:
        """Per-token path: one decode step, host-side sampling."""
        if self.paged:
            active = self._ensure_decode_pages(active, 1)
            if not active:
                return 0
        step_idx = self._decode_calls
        self._decode_calls += 1
        self._fault_gate(step_idx)
        t0 = self._now()
        logits = self._run(self._decode)
        self.stats["decode_steps"] += 1
        logits_np = logits.float().cpu().numpy()
        self._fault_post(step_idx, self._now() - t0)
        t = self._now()
        if self._controller is not None:
            self._controller.observe_decode(t - t0, 1)
        if obs.enabled():
            obs.complete("decode_call", self._abs(t0), self._abs(t),
                         "engine", call=step_idx, steps=1,
                         n_active=len(active), tier=self.tier_idx)
            for slot in active:
                obs.complete("decode_step", self._abs(t0), self._abs(t),
                             f"req:{self._slots[slot].req.uid}",
                             call=step_idx, tier=self.tier_idx)
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

    def _step_chunked(self, active, T: Optional[int] = None) -> int:
        """Greedy fast path: ``T`` (default ``decode_chunk``) steps on the
        device, then one host fetch of the [T, max_slots] token block.
        The chunk always runs its full length; tokens past a request's
        stop are discarded on the host.  Per-token timestamps spread the
        chunk's measured latency evenly over its tokens."""
        T = self.decode_chunk if T is None else T
        if self.paged:
            active = self._ensure_decode_pages(active, T)
            if active is None:
                # a lone slot cannot fit a whole chunk's pages: single
                # steps until a finish frees pages
                self._force_single = True
                active = [i for i, s in enumerate(self._slots)
                          if s is not None]
                return self._step_single(active) if active else 0
            if not active:
                return 0
        step_idx = self._decode_calls
        self._decode_calls += 1
        self._fault_gate(step_idx)
        t0 = self._now()
        toks = self._run(self._chunk_fn(T))
        self.stats["decode_steps"] += T
        toks_np = toks.cpu().numpy()        # the one host sync per chunk
        self._fault_post(step_idx, self._now() - t0)
        t1 = self._now()
        if self._controller is not None:
            self._controller.observe_decode(t1 - t0, T)
        if obs.enabled():
            obs.complete("decode_call", self._abs(t0), self._abs(t1),
                         "engine", call=step_idx, steps=T,
                         n_active=len(active), tier=self.tier_idx)
            for slot in active:
                obs.complete("decode_chunk", self._abs(t0), self._abs(t1),
                             f"req:{self._slots[slot].req.uid}",
                             call=step_idx, steps=T, tier=self.tier_idx)
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
            except ServeError:
                # one bad request (over-long prompt, full bounded queue)
                # must not end the trace: it finishes as rejected
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
        slo = self.slo
        return summarize(
            self._outputs, wall, label=label,
            slo_tpot_s=None if slo is None else slo.tpot_ms * 1e-3,
            slo_ttft_s=None if slo is None or slo.ttft_ms is None
            else slo.ttft_ms * 1e-3,
            tokens_by_tier=self.tokens_by_tier)


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
