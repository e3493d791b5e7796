"""Slot KV cache: the static-shape state behind continuous batching (port
of ``SlotKVCache`` in ``repro/serve/cache.py``; the paged cache is not
ported yet).

One ``init_cache(cfg, max_slots, max_seq_len)`` tree whose batch axis is a
pool of slots.  A request owns a slot from admission to completion;
admission writes its prefill K/V into the slot through
``prefill_into_slot``, decode advances every slot at its own position, and
a freed slot is overwritten by the next admission.  ``decode_attention``
masks each slot to its own valid prefix, so stale rows are never read.
The cache tensors are updated in place.
"""

from __future__ import annotations

from repro_torch.models import init_cache, prefill_into_slot
from repro_torch.models.common import ModelConfig

__all__ = ["SlotKVCache", "PromptTooLongError"]


class PromptTooLongError(ValueError):
    """A prompt does not fit the per-slot cache capacity."""


class SlotKVCache:
    """Owns the slot-pool cache tensors."""

    def __init__(self, cfg: ModelConfig, max_slots: int, max_seq_len: int,
                 *, device="cuda"):
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self.data = init_cache(cfg, max_slots, max_seq_len, device=device)

    def write_prefill(self, params, tokens, slot: int):
        """Admit one request: prefill ``tokens`` [1, S] into ``slot``.
        Returns the last-position logits [1, V]."""
        assert tokens.ndim == 2 and tokens.shape[0] == 1
        if tokens.shape[1] > self.max_seq_len:
            raise PromptTooLongError(
                f"prompt ({tokens.shape[1]}) exceeds max_seq_len "
                f"({self.max_seq_len})")
        logits, self.data = prefill_into_slot(params, self.cfg, tokens,
                                              self.data, slot)
        return logits
