"""Serving KV caches: the static-shape state behind continuous batching
(port of ``repro/serve/cache.py``).  Two implementations share one
contract (static shapes, per-slot positions, admission by prefill, decode
by ``decode_step``).

:class:`SlotKVCache`: one ``init_cache(cfg, max_slots, max_seq_len)`` tree
whose batch axis is a pool of slots.  A request owns a slot from admission to completion;
admission writes its prefill K/V (and an SSM's recurrent state, whole)
into the slot through ``prefill_into_slot``, decode advances every slot
at its own position, and a freed slot is overwritten by the next
admission.  ``decode_attention`` masks each slot to its own valid prefix,
so stale rows are never read; ``reset`` and ``compact`` walk every leaf,
the state leaves too (their slot axis is axis 1 like every leaf's).
With ``enc_len`` an enc-dec model's cache also holds each slot's cross
K/V (``xk`` / ``xv``, the reference's ``SlotKVCache(enc_len=)``); such a
request is admitted by ``prefill_into_slot(enc_embeds=)`` into
``data``, eagerly: the admission program takes no frames, as the
reference's takes none, so :meth:`SlotKVCache.write_prefill` refuses an
enc-dec model.

The cache tensors are updated in place and never reallocated: the
engine's graphs (``serve/graphs.py``) read and write this very storage,
so ``reset`` and ``compact`` write in place too.  Admission runs one
:class:`~repro_torch.serve.graphs.PrefillGraph` per distinct prompt
length (and weight tier), the counterpart of the reference's
``_jit_slot_prefill``, whose jit keeps one executable per traced length
and param structure.

:class:`PagedKVCache`: sequence leaves stored as ``[L, num_pages + 1,
page_size, ...]`` and each slot owning an int32 row of a ``[max_slots,
pages_per_slot]`` host page table that maps its logical pages to physical
ones (``num_pages`` = unmapped).  Decode gathers a slot-major view through
the table (:func:`paged_view`), runs the unchanged ``decode_step`` on it
and commits only the token rows it wrote (:func:`paged_commit`).
Requests admitted with a common prompt prefix share refcounted pages,
copied on write (host bookkeeping in
:class:`~repro_torch.serve.queue.PageAllocator`).

**The sink page.**  Every write the reference drops (XLA discards an
out-of-range scatter: unmapped table entries, decode overshoot past
``pages_per_slot * page_size``, the shared-prefix rows at admission, the
zero program's padding) goes to page ``num_pages``, the one spare page
each sequence leaf holds and nothing reads: PyTorch raises on an index
past the end (on the card a device-side assert that ends the context),
and a boolean filter would give the dynamic shape a CUDA graph cannot
capture.  Reads clamp to ``num_pages - 1`` as the reference's do; every
row a clamped read yields lies past the slot's valid prefix and is masked
by ``decode_attention``.  The first ``num_pages`` pages are the
reference's pool (ROADMAP C2).

**In place.**  The engine's graphs read the pool tensors they captured,
so the commit, copy-on-write, page zeroing and compaction write into the
pool's storage (``index_copy_``, or ``copy_`` of a gathered temporary)
and never rebind a leaf.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import forward, init_cache, logits_of, \
    prefill_into_slot
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import _seq_leaf_kinds, \
    _write_slot_leaf, cache_leaves, map_cache
from repro_torch.models.common import ModelConfig
# PromptTooLongError belongs to the typed serve error family; re-exported
# here, where it was first defined
from repro_torch.serve.errors import PromptTooLongError
from repro_torch.serve.graphs import PagedPrefillGraph, PrefillGraph
from repro_torch.serve.queue import PageAllocator, prefix_hashes

__all__ = ["SlotKVCache", "PagedKVCache", "PromptTooLongError",
           "reset_slot", "gather_slots", "paged_view", "paged_commit"]


def _slot_prefill_fn(cfg: ModelConfig):
    """The admission program (the body of the reference's
    ``_jit_slot_prefill``): logits [1, V], the cache written in place."""

    def _prefill(p, toks, cache, slot, off):
        return prefill_into_slot(p, cfg, toks, cache, slot,
                                 write_offset=off)[0]

    return _prefill


def reset_slot(cache: dict, slot) -> dict:
    """Zero batch row ``slot`` (an int or a 0-dim device tensor) of every
    cache leaf (a flat or a pair layout's nested cache), in place."""
    for leaf in cache_leaves(cache):
        idx = torch.as_tensor(slot, device=leaf.device).reshape(1).long()
        leaf.index_fill_(1, idx, 0)
    return cache


def gather_slots(cache: dict, perm) -> dict:
    """Reorder the slot axis by ``perm`` ([max_slots] ints), in place:
    row i becomes old row ``perm[i]`` (slot compaction), in every leaf."""
    for leaf in cache_leaves(cache):
        idx = torch.as_tensor(perm, device=leaf.device).long()
        leaf.copy_(leaf.index_select(1, idx))
    return cache


class SlotKVCache:
    """Owns the slot-pool cache tensors and the admission programs.
    ``graphs`` captures each program on the card (``pool``, a
    ``torch.cuda.graph_pool_handle()``, shares one memory pool with the
    engine's decode graphs); a CPU cache, or ``graphs=False``, runs them
    eagerly."""

    def __init__(self, cfg: ModelConfig, max_slots: int, max_seq_len: int,
                 *, enc_len: int = 0, device="cuda", graphs: bool = True,
                 pool=None):
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self.data = init_cache(cfg, max_slots, max_seq_len, enc_len=enc_len,
                               device=device)
        self.graphs = graphs
        self.pool = pool
        self._fn = _slot_prefill_fn(cfg)
        #: one admission program per (weight tier, prompt length)
        self.programs: dict[tuple, PrefillGraph] = {}

    @property
    def prefill_graphs(self) -> dict:
        """{prompt length: admission program} of tier 0 (an engine without
        tiers has no other)."""
        return {S: g for (t, S), g in self.programs.items() if t == 0}

    def program(self, params, S: int, tier: int = 0) -> PrefillGraph:
        """The admission program for prompt length ``S`` at weight tier
        ``tier``.  A program holds the params it was built with; other
        params for the same key build it anew (a tiered engine keys each
        tier's params apart, so switching tiers builds nothing)."""
        g = self.programs.get((tier, S))
        if g is None or g.params is not params:
            g = self.programs[(tier, S)] = PrefillGraph(
                self._fn, params, self.data, S, capture=self.graphs,
                pool=self.pool)
        return g

    def write_prefill(self, params, tokens, slot: int, *,
                      write_offset: int = 0, tier: int = 0):
        """Admit one request: prefill ``tokens`` [1, S] (host ints) into
        ``slot`` at seq offset ``write_offset`` with the program of
        (``tier``, S).  Returns the last-position logits [1, V]: the
        program's static output, valid until its next run.  An enc-dec
        model raises ``ValueError``: the program takes no frames."""
        if self.cfg.n_enc_layers > 0:
            raise ValueError(
                f"{self.cfg.name!r} is an enc-dec model and the admission "
                f"program takes no encoder frames: admit with "
                f"`prefill_into_slot(enc_embeds=)` into this cache's data")
        assert tokens.ndim == 2 and tokens.shape[0] == 1
        S = int(tokens.shape[1])
        if S > self.max_seq_len:
            raise PromptTooLongError(
                f"prompt ({S}) exceeds max_seq_len ({self.max_seq_len})")
        return self.program(params, S, tier).run(tokens, slot, write_offset)

    def warm(self, params, S: int, tier: int = 0) -> None:
        """Build the admission program of (``tier``, ``S``) by running it
        once into slot 0 (an idle engine's slot: the next admission there
        overwrites its rows and state)."""
        self.program(params, S, tier).run(np.zeros(S, np.int32), 0, 0)

    def reset(self, slot: int) -> None:
        reset_slot(self.data, slot)

    def compact(self, perm) -> None:
        gather_slots(self.data, perm)


# ---------------------------------------------------------------------------
# paged cache: device programs (every write in place)
# ---------------------------------------------------------------------------


def _seq_leaves(cfg: ModelConfig, pool) -> list:
    """The pool's sequence leaves [L, num_pages + 1, page_size, ...]."""
    return [leaf for leaf, is_seq in zip(
        cache_leaves(pool), cache_leaves(_seq_leaf_kinds(cfg, 0))) if is_seq]


def _page_rows(leaf: torch.Tensor) -> torch.Tensor:
    """A pool leaf [L, P, page_size, ...] as [L, P * page_size, ...]."""
    return leaf.view(leaf.shape[0], -1, *leaf.shape[3:])


def paged_view(cfg: ModelConfig, pool, table, page_size: int):
    """The slot-major logical cache gathered out of the paged pool: each
    sequence leaf [L, num_pages + 1, page_size, ...] becomes [L,
    max_slots, pages_per_slot * page_size, ...] through ``table`` [B,
    pps] (int32, on the pool's device), unmapped entries clamped to page
    ``num_pages - 1`` (their rows lie past the slot's valid prefix).  A
    state leaf is slot-indexed already: the view holds the pool's own
    tensor, so a decode step's in-place state update lands in the pool."""
    B, pps = table.shape

    def leaf(pl, is_seq):
        if not is_seq:
            return pl
        flat = table.reshape(-1).clamp(0, pl.shape[1] - 2).long()
        v = pl.index_select(1, flat)            # [L, B * pps, page_size, ...]
        return v.view(pl.shape[0], B, pps * page_size, *pl.shape[3:])

    return map_cache(leaf, pool, _seq_leaf_kinds(cfg, 0))


def paged_commit(cfg: ModelConfig, pool, view, table, pos, n_steps: int,
                 page_size: int, num_pages: int) -> None:
    """Write back what a decode of ``n_steps`` changed, in place: for each
    slot the token rows at positions ``pos .. pos + n_steps - 1`` of the
    view go to their physical pages.  Unmapped slots and positions past
    ``pages_per_slot * page_size`` go to the sink page ``num_pages``
    (the reference drops them).  The engine makes every mapped page in
    the range private first, so no two slots write one page."""
    B, pps = table.shape
    S = pps * page_size
    t = torch.arange(n_steps, dtype=torch.int32, device=pos.device)
    wpos = pos[:, None] + t[None, :]                          # [B, T]
    safe = wpos.clamp(0, S - 1).long()
    phys = torch.gather(table, 1, safe // page_size)
    phys = torch.where(wpos < S, phys, torch.full_like(phys, num_pages))
    dest = (phys.long() * page_size + safe % page_size).reshape(-1)
    bidx = torch.arange(B, device=pos.device)[:, None]
    for pl, vl, is_seq in zip(cache_leaves(pool), cache_leaves(view),
                              cache_leaves(_seq_leaf_kinds(cfg, 0))):
        if is_seq:
            rows = vl[:, bidx, safe]                          # [L, B, T, ...]
            _page_rows(pl).index_copy_(
                1, dest, rows.reshape(pl.shape[0], B * n_steps,
                                      *pl.shape[3:]))


def copy_page(cfg: ModelConfig, pool, src: int, dst: int) -> None:
    """Copy-on-write: physical page ``src`` into ``dst`` on every
    sequence leaf, in place (state leaves are per slot, not paged)."""
    for leaf in _seq_leaves(cfg, pool):
        leaf[:, dst].copy_(leaf[:, src])


def zero_pages(cfg: ModelConfig, pool, pages) -> None:
    """Zero the physical pages ``pages`` (ints; ``num_pages`` entries pad
    a fixed-size batch and zero the sink), in place: the paged analogue
    of :func:`reset_slot`."""
    for leaf in _seq_leaves(cfg, pool):
        leaf.index_fill_(1, torch.as_tensor(pages, device=leaf.device).long(),
                         0)


def gather_pages(cfg: ModelConfig, pool, perm) -> None:
    """Compaction: page i of the first ``num_pages`` becomes old page
    ``perm[i]``, in place (a gathered temporary copied back); the sink
    page stays."""
    for leaf in _seq_leaves(cfg, pool):
        idx = torch.as_tensor(perm, device=leaf.device).long()
        leaf[:, :idx.numel()].copy_(leaf.index_select(1, idx))


def _paged_prefill_fn(cfg: ModelConfig, page_size: int, num_pages: int):
    """The paged admission program (the reference's
    ``_jit_paged_prefill``): the collecting forward ``prefill_into_slot``
    runs, then each token row of the contributions scattered through the
    slot's table row ``table_row`` [pps]; rows below ``start`` (the
    shared-prefix length, whose pages already hold bitwise-equal K/V)
    go to the sink page.  State leaves write row ``slot`` whole.  Every
    write goes through ``transformer._to_cache_dtype``, looked up on the
    module, so one replacement of it reaches every writer.  Returns the
    last-position logits [1, V]; ``slot`` and ``start`` are 0-dim device
    tensors, so one captured program serves every slot."""

    def run(p, toks, pool, table_row, slot, start):
        hidden, contribs = forward(p, cfg, toks, collect_cache=True)
        logits = logits_of(p, cfg, hidden[:, -1:])[:, 0]
        pos = torch.arange(toks.shape[1], device=toks.device)
        phys = table_row[pos // page_size].long()
        phys = torch.where(pos >= start, phys,
                           torch.full_like(phys, num_pages))
        dest = phys * page_size + pos % page_size

        def leaf(pl, cl, is_seq):
            if not is_seq:
                return _write_slot_leaf(pl, cl, slot, 0, False)
            _page_rows(pl).index_copy_(1, dest,
                                       tf._to_cache_dtype(cl[:, 0],
                                                          pl.dtype))
            return pl

        map_cache(leaf, pool, contribs, _seq_leaf_kinds(cfg, 0))
        return logits

    return run


class PagedKVCache:
    """Paged KV pool + page table + host-side allocator and sharing state
    (the reference's ``PagedKVCache``).

    ``max_seq_len`` is the per-slot logical capacity (table width x
    ``page_size``, which must divide it); ``num_pages`` the physical pool
    (default ``max_slots * max_seq_len / page_size``, the slot cache's
    memory; with prefix sharing and mixed prompt lengths a smaller pool
    serves as many slots).  ``prefix_sharing`` admits a request with a
    known prompt prefix onto the existing pages (refcounted,
    copy-on-write).  Local layers are stored full length
    (``init_cache(local_window_cache=False)``): a ring would alias
    positions onto one row, which a page table cannot express.  Each
    sequence leaf holds one spare sink page (module docstring).  An
    enc-dec model raises ``ValueError``: the admission program takes no
    frames.  ``graphs`` and ``pool`` are :class:`SlotKVCache`'s: one
    :class:`~repro_torch.serve.graphs.PagedPrefillGraph` per distinct
    prompt length."""

    def __init__(self, cfg: ModelConfig, max_slots: int, max_seq_len: int,
                 *, page_size: int = 16, num_pages: Optional[int] = None,
                 prefix_sharing: bool = True, device="cuda",
                 graphs: bool = True, pool=None):
        if cfg.n_enc_layers > 0:
            raise ValueError(
                f"{cfg.name!r} is an enc-dec model and the paged admission "
                f"program takes no encoder frames: serve it from a "
                f"`SlotKVCache(enc_len=)`")
        if max_seq_len % page_size:
            raise ValueError(
                f"max_seq_len ({max_seq_len}) must be a multiple of "
                f"page_size ({page_size})")
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self.page_size = page_size
        self.pages_per_slot = max_seq_len // page_size
        self.num_pages = (max_slots * self.pages_per_slot
                          if num_pages is None else int(num_pages))
        self.prefix_sharing = prefix_sharing
        self.alloc = PageAllocator(self.num_pages)
        #: the host page table; the decode programs copy it into their
        #: static buffer before each run
        self.table = np.full((max_slots, self.pages_per_slot),
                             self.num_pages, np.int32)
        self.data = self._init_pool(resolve_device(device))
        self.graphs = graphs
        self.pool = pool
        self._fn = _paged_prefill_fn(cfg, page_size, self.num_pages)
        #: one admission program per (weight tier, prompt length)
        self.programs: dict[tuple, PagedPrefillGraph] = {}
        self.reset_stats()

    @property
    def prefill_graphs(self) -> dict:
        """{prompt length: admission program} of tier 0."""
        return {S: g for (t, S), g in self.programs.items() if t == 0}

    def program(self, params, S: int, tier: int = 0) -> PagedPrefillGraph:
        """The admission program of (``tier``, ``S``), as
        :meth:`SlotKVCache.program`."""
        g = self.programs.get((tier, S))
        if g is None or g.params is not params:
            g = self.programs[(tier, S)] = PagedPrefillGraph(
                self._fn, params, self.data, S, self.pages_per_slot,
                capture=self.graphs, graph_pool=self.pool)
        return g

    def warm(self, params, S: int, tier: int = 0) -> None:
        """Build the admission program of (``tier``, ``S``) by running it
        once through an unmapped table row: every row goes to the sink
        page, nothing is allocated, and slot 0's state leaves (an idle
        engine's) are overwritten by its next admission."""
        row = np.full(self.pages_per_slot, self.num_pages, np.int32)
        self.program(params, S, tier).run(np.zeros(S, np.int32), row, 0, 0)

    def reset_stats(self) -> None:
        """Zero the counters: prompt tokens shared and prefilled, pages
        copied on write, the peak of pages in use."""
        self.stats = {"shared_tokens": 0, "prefilled_tokens": 0,
                      "cow_copies": 0, "peak_pages_in_use": 0}

    def _init_pool(self, dev):
        """Sequence leaves [L, num_pages + 1, page_size, ...] (the last
        page the sink); state leaves keep the slot cache's [L, max_slots,
        ...], each allocated once from the shapes ``init_cache`` gives on
        the meta device."""
        shapes = init_cache(self.cfg, self.num_pages + 1, self.page_size,
                            local_window_cache=False, device="meta")

        def alloc(t, is_seq):
            shape = t.shape if is_seq else (t.shape[0], self.max_slots,
                                             *t.shape[2:])
            return torch.zeros(shape, dtype=t.dtype, device=dev)

        return map_cache(alloc, shapes, _seq_leaf_kinds(self.cfg, 0))

    # -- introspection ----------------------------------------------------
    def device_table(self) -> torch.Tensor:
        return torch.from_numpy(self.table).to(
            cache_leaves(self.data)[0].device)

    def slot_pages(self, slot: int) -> list:
        """Mapped (logical_page, physical_page) pairs for a slot."""
        row = self.table[slot]
        return [(j, int(p)) for j, p in enumerate(row)
                if p != self.num_pages]

    def logical_view(self):
        """The slot-major logical cache the decode step sees (tests,
        checks)."""
        return paged_view(self.cfg, self.data, self.device_table(),
                          self.page_size)

    def _note_usage(self):
        used = self.alloc.pages_in_use()
        if used > self.stats["peak_pages_in_use"]:
            self.stats["peak_pages_in_use"] = used

    # -- admission --------------------------------------------------------
    def admit(self, params, tokens, slot: int, *, tier: int = 0):
        """Admit one request's prompt ``tokens`` [1, S] (host ints) into
        ``slot``: map shared prefix pages (refcount + 1), allocate private
        pages for the rest, run the admission program of (``tier``, S).
        Returns its last-position logits [1, V] (the program's static
        output, valid until its next run), or None, touching nothing,
        when the pool cannot supply the private pages.  Raises
        :class:`PromptTooLongError` past the logical capacity."""
        toks_np = np.asarray(tokens).reshape(-1)
        S = int(toks_np.size)
        if S > self.max_seq_len:
            raise PromptTooLongError(
                f"prompt ({S}) exceeds max_seq_len ({self.max_seq_len})")
        assert np.all(self.table[slot] == self.num_pages), (
            f"slot {slot} admitted while still mapped")
        chain = (prefix_hashes(toks_np, self.page_size)
                 if self.prefix_sharing else [])
        shared: list = []
        shared_len = 0
        for digest, covered in chain:
            page = self.alloc.lookup_prefix(digest)
            if page is None:
                break
            shared.append((digest, page))
            shared_len = covered
        n_logical = -(-S // self.page_size)
        fresh = self.alloc.alloc(n_logical - len(shared))
        if fresh is None:
            return None  # out of pages; nothing increfed yet
        for _, page in shared:
            self.alloc.incref(page)
        row = self.table[slot]
        for j, (_, page) in enumerate(shared):
            row[j] = page
        for j, page in zip(range(len(shared), n_logical), fresh):
            row[j] = page
        # publish this prompt's prefix chain for future sharers (no-op for
        # digests already registered)
        for digest, covered in chain:
            row_idx = (covered - 1) // self.page_size
            self.alloc.register_prefix(digest, int(row[row_idx]))
        self._note_usage()
        self.stats["shared_tokens"] += shared_len
        self.stats["prefilled_tokens"] += S
        return self.program(params, S, tier).run(toks_np, row, slot,
                                                 shared_len)

    # -- decode-write preparation (allocation growth + copy-on-write) -----
    def ensure_writable_range(self, slot: int, start: int,
                              n_steps: int) -> bool:
        """Make every page that decode positions ``start .. start +
        n_steps - 1`` touch mapped and private (refcount 1): allocate
        unmapped ones, copy shared ones on write (in place).  Returns
        False, leaving what it did in place (mapped pages stay
        refcounted to this slot), when the pool runs dry; the engine then
        preempts a slot and retries."""
        lo = max(0, start)
        hi = min(start + n_steps, self.max_seq_len)
        for lp in sorted({p // self.page_size for p in range(lo, hi)}):
            phys = int(self.table[slot, lp])
            if phys == self.num_pages:
                got = self.alloc.alloc(1)
                if got is None:
                    return False
                self.table[slot, lp] = got[0]
            elif self.alloc.refcount[phys] > 1:
                got = self.alloc.alloc(1)
                if got is None:
                    return False
                copy_page(self.cfg, self.data, phys, got[0])
                self.alloc.decref(phys)
                self.table[slot, lp] = got[0]
                self.stats["cow_copies"] += 1
        self._note_usage()
        return True

    # -- release / compaction ---------------------------------------------
    def release_slot(self, slot: int, *, zero: bool = False) -> list:
        """Unmap a slot and decref its pages; returns the physical pages
        this freed.  With ``zero`` the freed pages are also zeroed on the
        device (the slot-isolation analogue of ``reset_slot``)."""
        freed = []
        for j in range(self.pages_per_slot):
            phys = int(self.table[slot, j])
            if phys == self.num_pages:
                continue
            self.table[slot, j] = self.num_pages
            if self.alloc.decref(phys):
                freed.append(phys)
        if zero and freed:
            pages = np.full(self.pages_per_slot, self.num_pages, np.int32)
            pages[:len(freed)] = freed
            zero_pages(self.cfg, self.data, pages)
        return freed

    def compact(self) -> None:
        """Pack live physical pages to the front of the pool, keeping
        their contents, and rewrite the table and allocator to match."""
        old_to_new = self.alloc.compaction_perm()
        perm = np.arange(self.num_pages, dtype=np.int32)
        for old, new in old_to_new.items():
            perm[new] = old
        gather_pages(self.cfg, self.data, perm)
        self.alloc.apply_compaction(old_to_new)
        for s in range(self.max_slots):
            for j in range(self.pages_per_slot):
                p = int(self.table[s, j])
                if p != self.num_pages:
                    self.table[s, j] = old_to_new[p]
