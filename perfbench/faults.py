"""Faults planted under the timed path, to show that the comparison
which decides ``correct`` catches them: each is a context manager that
patches the program for the run inside it and puts it back after.
Used by the tests and by ``readings.py``; the benchmark's own runs plant
nothing.

Serving (the decode programs of ``ServeEngine``):
- ``state_unchanged``: each decode call leaves the KV cache as it found
  it;
- ``half_batch``: the upper half of the slots get the lower half's
  tokens, as if their rows were left out;
- ``token_altered``: the first token of every chunk is changed where the
  chunk produces it.

Training (the trainer of ``launch/train.py``):
- ``state_unchanged``: each trainer call puts the parameters and the
  optimizer state back as they were;
- ``half_batch``: each step sees the first half of its rows, the loss the
  mean over those.

One chip exchanges nothing, so no cell can leave an exchange out.
"""

from __future__ import annotations

import contextlib

SERVE = ("state_unchanged", "half_batch", "token_altered")
TRAIN = ("state_unchanged", "half_batch")


@contextlib.contextmanager
def _patched(cls, name, make):
    orig = getattr(cls, name)
    setattr(cls, name, make(orig))
    try:
        yield
    finally:
        setattr(cls, name, orig)


def serve_fault(kind: str, vocab: int):
    from repro_torch.models.transformer import cache_leaves
    from repro_torch.serve import graphs

    def make(orig):
        def run(self, tok, pos):
            if kind == "state_unchanged":
                saved = [t.clone() for t in cache_leaves(self.cache)]
            out = orig(self, tok, pos)
            if kind == "state_unchanged":
                for t, s in zip(cache_leaves(self.cache), saved):
                    t.copy_(s)
            elif out.ndim == 2 and kind == "half_batch":
                half = out.shape[1] // 2
                out[:, half:2 * half] = out[:, :half]
            elif out.ndim == 2 and kind == "token_altered":
                out[0] = (out[0] + 1) % vocab
            return out
        return run

    if kind not in SERVE:
        raise ValueError(f"no serving fault {kind!r}")
    return _patched(graphs.DecodeGraph, "run", make)


def train_fault(kind: str):
    from repro_torch.launch import train
    from repro_torch.launch.graphs import state_tensors

    def make(orig):
        def call(self, params, opt_state, batches, step0, stop):
            if kind == "half_batch":
                batches = {k: v[:, : v.shape[1] // 2]
                           for k, v in batches.items()}
                return orig(self, params, opt_state, batches, step0, stop)
            saved = [t.clone() for t in state_tensors(params, opt_state)]
            out = orig(self, params, opt_state, batches, step0, stop)
            for t, s in zip(state_tensors(params, opt_state), saved):
                t.copy_(s)
            return out
        return call

    if kind not in TRAIN:
        raise ValueError(f"no training fault {kind!r}")
    return _patched(train.MultiStep, "__call__", make)
