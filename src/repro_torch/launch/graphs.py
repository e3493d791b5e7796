"""The training step replayed as a CUDA graph: the port's counterpart of
the reference's jitted ``lax.scan`` trainer (``repro/launch/train.py:
make_multi_step``), which ``launch/train.py:make_multi_step`` builds on.

A :class:`TrainGraph` holds one step ``step_fn(params, opt_state, batch)
-> (params, opt_state, {"loss", "gnorm"})`` that updates the params, the
moments and the step counter in place (``optim/optimizers.py:
adamw_update``, ``optim/sparse_update.py:resparsify_params_``), over a
static batch buffer; the loss and the gradient norm go to a static [2]
f32 slot.  On the card its first :meth:`run` runs the step eagerly on the
capture stream (which loads the kernel libraries, makes their one-time
``cudaFuncSetAttribute`` calls, creates cuBLAS's workspace for that
stream and lets autograd set up its state), then captures it; every later
run copies the batch in and replays.  That eager run is the step of that
run; capture executes nothing.  The launch counters are put back after
the capture and the captured delta is added at every replay, so they keep
counting launches executed.  A capture or replay error raises; nothing
drops back to the eager step.  On the CPU, or with ``capture=False``, the
same object runs the step eagerly into the same buffers.

Replay reads and writes the storage it captured, so every tensor of the
params and of the optimizer state must stay the same tensor for the life
of the graph: updates and pattern recomputes write in place.
:meth:`TrainGraph.holds` says whether a tree is still the captured one.
The step must not sync with the host (a capture raises on a sync) or read
a host value that changes between steps (capture would freeze it: the
step counter lives on the device for that reason).
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from repro_torch.kernels import ops as kops
from repro_torch.optim.optimizers import tree_leaves

__all__ = ["TrainGraph", "state_tensors"]


def state_tensors(params, opt_state) -> list:
    """Every tensor a training step reads or writes, in a fixed order."""
    out = []
    for leaf in tree_leaves(params) + tree_leaves(opt_state["mu"]) \
            + tree_leaves(opt_state["nu"]) + [opt_state["step"]]:
        if isinstance(leaf, torch.Tensor):
            out.append(leaf)
        elif leaf is not None:            # a layout: its own tensors
            out.extend(v for v in vars(leaf).values()
                       if isinstance(v, torch.Tensor))
    return out


class TrainGraph:
    """One training step over static buffers, replayed as a CUDA graph
    when ``capture`` is true and the params lie on the card.  ``batch``
    gives the static batch buffers' shapes and dtypes."""

    def __init__(self, step_fn: Callable, params, opt_state, batch: dict,
                 *, capture: bool = True):
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.device = opt_state["step"].device
        self.capture_on = capture and self.device.type == "cuda"
        self.batch = {k: torch.zeros(v.shape, dtype=v.dtype,
                                     device=self.device)
                      for k, v in batch.items()}
        self.metrics = torch.zeros(2, dtype=torch.float32,
                                   device=self.device)
        self._tensors = state_tensors(params, opt_state)
        self.graph = None
        self._delta = None
        #: capture cost (host ms of capture and of instantiation, bytes the
        #: capture added to the reserved pool) and the replays so far
        self.info = {"captured": False, "replays": 0}

    def holds(self, params, opt_state) -> bool:
        """Whether ``params`` and ``opt_state`` are the trees this graph
        runs on, tensor for tensor."""
        now = state_tensors(params, opt_state)
        return len(now) == len(self._tensors) and all(
            a is b for a, b in zip(now, self._tensors))

    def _program(self) -> None:
        _, _, m = self.step_fn(self.params, self.opt_state, self.batch)
        torch.stack((m["loss"], m["gnorm"]), out=self.metrics)

    def run(self, batch: dict) -> torch.Tensor:
        """Copy ``batch`` (tensors on the graph's device) into the static
        buffers, run one step and return the static [loss, gnorm] slot
        (valid until the next run)."""
        for k, v in batch.items():
            self.batch[k].copy_(v)
        if self.graph is not None:
            self.graph.replay()
            kops.add_counters(self._delta)
            self.info["replays"] += 1
        elif not self.capture_on:
            self._program()
        else:
            self._run_then_capture()
        return self.metrics

    def _run_then_capture(self) -> None:
        """The first run on the card: eagerly on the capture stream (this
        run's step), then the capture.  Records the capture's counter
        delta and puts the counters back; raises on any capture error."""
        cur = torch.cuda.current_stream(self.device)
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            self._program()
        cur.wait_stream(stream)
        before = kops.counter_snapshot()
        g = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(g, stream=stream):
                t0 = time.perf_counter()
                reserved = torch.cuda.memory_reserved(self.device)
                self._program()
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
