"""Request/response plumbing for the continuous-batching serving engine
(port of ``repro/serve/queue.py``, slot mode: the paged-cache allocator
and prefix hashes are not ported yet).

A :class:`Request` carries a prompt, per-request sampling parameters and
stop conditions; the :class:`RequestQueue` is the arrival side of the
engine (requests become visible once their ``arrival_time`` has passed).
A finished request is returned as a :class:`RequestOutput` with the
wall-clock timestamps the metrics layer aggregates.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np

__all__ = ["SamplingParams", "Request", "RequestOutput", "RequestQueue",
           "sample_token"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding parameters.

    ``greedy`` overrides everything else; otherwise softmax sampling at
    ``temperature`` restricted to the ``top_k`` highest logits
    (``top_k=0`` means the full vocabulary).  ``seed`` makes a request's
    sampling stream reproducible independent of scheduling order.
    """

    greedy: bool = True
    temperature: float = 1.0
    top_k: int = 0
    seed: int = 0


@dataclasses.dataclass
class Request:
    """One serving request: prompt tokens plus generation/stop settings.

    ``priority`` orders admission (higher first) and shields a request
    from load shedding — the SLO controller sheds lowest priority first.
    ``deadline_s`` is an optional completion budget measured from
    ``arrival_time``: a request still queued past its deadline finishes
    as ``"timeout"`` without ever occupying a slot, and one predicted at
    admission time to blow its deadline is timed out instead of admitted.
    """

    uid: int
    prompt: np.ndarray                 # [S] int32 token ids
    max_new_tokens: int = 16
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    stop_tokens: tuple = ()            # any of these ends generation
    arrival_time: float = 0.0          # seconds after engine start
    priority: int = 0                  # higher admits first, sheds last
    deadline_s: Optional[float] = None  # completion budget from arrival

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        assert self.prompt.size > 0, "empty prompt"
        assert self.max_new_tokens >= 1
        assert self.deadline_s is None or self.deadline_s > 0

    @property
    def deadline(self) -> Optional[float]:
        """Absolute deadline (engine clock), or None."""
        return None if self.deadline_s is None \
            else self.arrival_time + self.deadline_s


@dataclasses.dataclass
class RequestOutput:
    """A finished request with its generation and latency timestamps.

    ``token_times`` holds one wall-clock stamp per generated token (the
    first entry is the end of prefill, i.e. time-to-first-token)."""

    uid: int
    prompt_len: int
    tokens: list
    # "length" | "stop" | "rejected" | "timeout" | "shed"
    finish_reason: str
    arrival_time: float
    admitted_time: float
    finish_time: float
    token_times: list
    deadline: Optional[float] = None   # absolute deadline, if the request
    #                                    carried one (for SLO accounting)

    @property
    def ttft(self) -> float:
        # rejected requests finish with no tokens; nan keeps them out of
        # the latency percentiles instead of raising
        if not self.token_times:
            return float("nan")
        return self.token_times[0] - self.arrival_time

    @property
    def latency(self) -> float:
        return self.finish_time - self.arrival_time


class RequestQueue:
    """Arrival queue with simulated arrival times.

    ``pop_ready(now)`` hands out the earliest-submitted request whose
    ``arrival_time`` has passed (submission order need not match arrival
    order); ``next_arrival()`` lets the engine idle-wait precisely when
    every slot is free but traffic is still due."""

    def __init__(self):
        self._q: deque[Request] = deque()

    def push(self, req: Request) -> None:
        self._q.append(req)

    def push_front(self, req: Request) -> None:
        """Return a request to the head of the queue — used when admission
        has to back out (out of pages) or a slot is preempted mid-stream,
        so the request keeps its place ahead of later arrivals."""
        self._q.appendleft(req)

    def pop_ready(self, now: float) -> Optional[Request]:
        """Hand out the best due request: highest ``priority`` first, then
        earliest absolute deadline (no deadline sorts last), then
        submission order.  Requests may be submitted out of arrival
        order; queues are engine-sized, so the O(n) scan is fine."""
        best_i = None
        best_key = None
        inf = float("inf")
        for i, req in enumerate(self._q):
            if req.arrival_time > now:
                continue
            key = (-req.priority,
                   inf if req.deadline is None else req.deadline, i)
            if best_key is None or key < best_key:
                best_i, best_key = i, key
        if best_i is None:
            return None
        req = self._q[best_i]
        del self._q[best_i]
        return req

    def expired(self, now: float) -> list:
        """Remove and return every queued request whose deadline has
        passed — the engine finishes them as ``"timeout"`` without a
        slot ever having been spent on them."""
        out = [r for r in self._q
               if r.deadline is not None and r.deadline < now]
        if out:
            dead = set(id(r) for r in out)
            self._q = deque(r for r in self._q if id(r) not in dead)
        return out

    def shed(self, keep: int) -> list:
        """Remove and return queued requests beyond ``keep``, shedding
        lowest priority first and, within a priority, newest arrivals
        first (the oldest work keeps its place — it has waited longest
        and sheds last)."""
        n_shed = len(self._q) - max(0, int(keep))
        if n_shed <= 0:
            return []
        order = sorted(range(len(self._q)),
                       key=lambda i: (self._q[i].priority,
                                      -self._q[i].arrival_time, -i))
        victims = set(order[:n_shed])
        out = [self._q[i] for i in sorted(victims)]
        self._q = deque(r for i, r in enumerate(self._q)
                        if i not in victims)
        return out

    def next_arrival(self) -> Optional[float]:
        return min(r.arrival_time for r in self._q) if self._q else None

    def __len__(self) -> int:
        return len(self._q)


def sample_token(logits: np.ndarray, sampling: SamplingParams,
                 rng: np.random.Generator) -> int:
    """Sample one token id from a [V] logits row on the host.

    Host-side sampling keeps per-request RNG streams independent of batch
    composition — a slot's output never depends on which other requests
    happen to share the batch."""
    logits = np.asarray(logits, np.float32)
    if sampling.greedy:
        return int(np.argmax(logits))
    t = max(sampling.temperature, 1e-5)
    z = logits / t
    if sampling.top_k and sampling.top_k < z.size:
        kth = np.partition(z, -sampling.top_k)[-sampling.top_k]
        z = np.where(z >= kth, z, -np.inf)
    z = z - np.max(z)
    p = np.exp(z)
    p /= p.sum()
    return int(rng.choice(z.size, p=p))
