"""Deterministic, resumable synthetic LM data pipeline (port of
``repro/data/pipeline.py``).

Batches are drawn from numpy's counter-based ``default_rng`` keyed by
(seed, step, host shard), so any host can produce exactly its shard of
any step: resume after preemption is index arithmetic, with no iterator
state to checkpoint, and re-sharding changes only the shard-to-host map.
The token stream is Zipf-distributed with a short Markov repeat
structure, so losses are non-degenerate.  The code is numpy only, as in
the reference, so it gives the reference's batches bit for bit.  The
iterator prefetches on a background thread; the trainers ask for
``batch_at(step)`` directly.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "SyntheticLMPipeline"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    seed: int = 0
    num_shards: int = 1          # usually = number of hosts
    shard_id: int = 0
    zipf_a: float = 1.2
    prefetch: int = 2


class SyntheticLMPipeline:
    """{'tokens', 'labels'} int32 numpy batches of this host's shard,
    addressed by step; iterating prefetches them in order from
    ``start_step``."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        if cfg.global_batch % cfg.num_shards:
            raise ValueError(f"global_batch {cfg.global_batch} is not a "
                             f"multiple of num_shards {cfg.num_shards}")
        self.cfg = cfg
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def batch_at(self, step: int, shard_id: Optional[int] = None) -> dict:
        cfg = self.cfg
        shard = cfg.shard_id if shard_id is None else shard_id
        local = cfg.global_batch // cfg.num_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, shard]))
        # zipf body clipped into vocab, plus a markov-ish repeat structure
        base = rng.zipf(cfg.zipf_a, size=(local, cfg.seq_len + 1))
        toks = (base % (cfg.vocab - 2)) + 2
        repeat = rng.random((local, cfg.seq_len + 1)) < 0.3
        toks[:, 1:] = np.where(repeat[:, 1:], toks[:, :-1], toks[:, 1:])
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[dict]:
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        try:
            while True:
                step, batch = self._q.get()
                self.step = step + 1
                yield batch
        finally:
            self.stop()

    def stop(self):
        """End the prefetch thread (it exits within 0.1 s)."""
        self._stop.set()

    def reshard(self, num_shards: int, shard_id: int) -> "SyntheticLMPipeline":
        """Same stream, new shard map."""
        cfg = dataclasses.replace(self.cfg, num_shards=num_shards,
                                  shard_id=shard_id)
        return SyntheticLMPipeline(cfg, start_step=self.step)
