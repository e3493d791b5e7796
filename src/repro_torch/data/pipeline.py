"""Deterministic synthetic LM batches (port of
``repro/data/pipeline.py``).

A batch is a pure function of (seed, step): numpy's counter-based
``default_rng(SeedSequence([seed, step, 0]))`` draws a Zipf token body
with a short Markov repeat structure, so losses are non-degenerate.  The
code is numpy only, as in the reference, so it gives the reference's
single-shard batches bit for bit.  The reference's data shards, prefetch
thread and elastic re-sharding are not ported: the port trains on one
card and its loop asks for ``batch_at(step)`` directly.
"""

from __future__ import annotations

import dataclasses
import numpy as np

__all__ = ["DataConfig", "SyntheticLMPipeline"]

_ZIPF_A = 1.2    # the reference's DataConfig.zipf_a default


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    seed: int = 0


class SyntheticLMPipeline:
    """{'tokens', 'labels'} int32 numpy batches, addressed by step."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        local = cfg.global_batch
        # shard 0 of the reference's (seed, step, shard) stream
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, 0]))
        # zipf body clipped into vocab, plus a markov-ish repeat structure
        base = rng.zipf(_ZIPF_A, size=(local, cfg.seq_len + 1))
        toks = (base % (cfg.vocab - 2)) + 2
        repeat = rng.random((local, cfg.seq_len + 1)) < 0.3
        toks[:, 1:] = np.where(repeat[:, 1:], toks[:, :-1], toks[:, 1:])
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
