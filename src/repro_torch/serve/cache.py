"""Slot KV cache: the static-shape state behind continuous batching (port
of ``SlotKVCache``, ``reset_slot`` and ``gather_slots`` in
``repro/serve/cache.py``; the paged cache is not ported yet).

One ``init_cache(cfg, max_slots, max_seq_len)`` tree whose batch axis is a
pool of slots.  A request owns a slot from admission to completion;
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
length, the counterpart of the reference's ``_jit_slot_prefill``, whose
jit keeps one executable per traced length.
"""

from __future__ import annotations

import torch

from repro_torch.models import init_cache, prefill_into_slot
from repro_torch.models.transformer import cache_leaves
from repro_torch.models.common import ModelConfig
from repro_torch.serve.graphs import PrefillGraph

__all__ = ["SlotKVCache", "PromptTooLongError", "reset_slot",
           "gather_slots"]


class PromptTooLongError(ValueError):
    """A prompt does not fit the per-slot cache capacity."""


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
        #: one admission program per distinct prompt length
        self.prefill_graphs: dict[int, PrefillGraph] = {}

    def write_prefill(self, params, tokens, slot: int, *,
                      write_offset: int = 0):
        """Admit one request: prefill ``tokens`` [1, S] (host ints) into
        ``slot`` at seq offset ``write_offset``.  Returns the last-position
        logits [1, V]: the program's static output, valid until its next
        run.  A program holds the params it was built with; other params
        build it anew.  An enc-dec model raises ``ValueError``: the
        program takes no frames."""
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
        g = self.prefill_graphs.get(S)
        if g is None or g.params is not params:
            g = self.prefill_graphs[S] = PrefillGraph(
                self._fn, params, self.data, S, capture=self.graphs,
                pool=self.pool)
        return g.run(tokens, slot, write_offset)

    def reset(self, slot: int) -> None:
        reset_slot(self.data, slot)

    def compact(self, perm) -> None:
        gather_slots(self.data, perm)
