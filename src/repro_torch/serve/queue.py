"""Request/response plumbing for the continuous-batching serving engine
(port of ``repro/serve/queue.py``).

A :class:`Request` carries a prompt, per-request sampling parameters and
stop conditions; the :class:`RequestQueue` is the arrival side of the
engine (requests become visible once their ``arrival_time`` has passed).
A finished request is returned as a :class:`RequestOutput` with the
wall-clock timestamps the metrics layer aggregates.  The paged cache's
host bookkeeping, :func:`prefix_hashes` and :class:`PageAllocator`, is
the reference's, line for line (pure Python and numpy).
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import deque
from typing import Optional

import numpy as np

__all__ = ["SamplingParams", "Request", "RequestOutput", "RequestQueue",
           "sample_token", "prefix_hashes", "PageAllocator"]


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

    def num_arrived(self, now: float) -> int:
        """Queued requests whose ``arrival_time`` has passed."""
        return sum(r.arrival_time <= now for r in self._q)

    def shed(self, keep: int, now: float = float("inf")) -> list:
        """Remove and return the requests arrived by ``now`` beyond
        ``keep`` of them, shedding lowest priority first and, within a
        priority, newest arrivals first (the oldest work keeps its place —
        it has waited longest and sheds last).  A request still to arrive
        is never shed: as :meth:`pop_ready` does, the queue holds it
        until its time (the reference counts and sheds it: ROADMAP
        C14)."""
        arrived = [i for i, r in enumerate(self._q) if r.arrival_time <= now]
        n_shed = len(arrived) - max(0, int(keep))
        if n_shed <= 0:
            return []
        order = sorted(arrived,
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


# ---------------------------------------------------------------------------
# paged-cache host bookkeeping: allocator + prefix-sharing index
# ---------------------------------------------------------------------------


def prefix_hashes(tokens: np.ndarray, page_size: int) -> list:
    """Chained digests of every full token page of a prompt, plus (when the
    prompt does not end on a page boundary) a final digest of the *whole*
    prompt for the partial tail page.

    Returns ``[(digest, covered_len), ...]`` where ``covered_len`` is the
    number of prompt tokens the chain covers up to and including that page.
    Chaining (each digest folds in the previous one) encodes that K/V at a
    position depends on *all* earlier tokens under causal attention — page
    j is only shareable if pages 0..j-1 matched too, which the lookup gets
    for free by walking the chain until the first miss."""
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32).reshape(-1))
    out = []
    h = hashlib.blake2b(digest_size=16)
    n_full = toks.size // page_size
    for j in range(n_full):
        h = h.copy()
        h.update(toks[j * page_size:(j + 1) * page_size].tobytes())
        out.append((h.digest(), (j + 1) * page_size))
    tail = toks.size % page_size
    if tail:
        h = h.copy()
        h.update(toks[n_full * page_size:].tobytes())
        out.append((h.digest(), toks.size))
    return out


class PageAllocator:
    """Refcounted physical-page pool + prefix-sharing index (host side).

    Invariants the property tests pin down:

    * a page is never handed out twice while live (``alloc`` only returns
      pages with refcount 0, set to 1),
    * ``decref`` frees a page exactly when its refcount reaches 0 (and
      only then returns it to the free list / invalidates its prefix-hash
      entries),
    * ``num_free + pages_in_use == num_pages`` always.

    The prefix index maps a chained token-prefix digest to the physical
    page holding that prefix's K/V rows.  Entries are invalidated the
    moment their page is freed, so a lookup can never resurrect a recycled
    page.  (Digest collisions — 128-bit blake2b — are assumed absent.)
    """

    def __init__(self, num_pages: int):
        assert num_pages >= 1
        self.num_pages = int(num_pages)
        self.refcount = np.zeros(self.num_pages, np.int64)
        self._free: deque = deque(range(self.num_pages))
        self._by_hash: dict = {}          # digest -> physical page
        self._hashes_of: dict = {}        # physical page -> set of digests

    # -- allocation -------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    def alloc(self, n: int) -> Optional[list]:
        """Take ``n`` fresh pages (refcount 1 each), or None — leaving the
        pool untouched — when fewer than ``n`` are free (the caller then
        queues/preempts instead of partially allocating)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            assert self.refcount[p] == 0, f"page {p} double-allocated"
            self.refcount[p] = 1
        return pages

    def incref(self, page: int) -> None:
        assert self.refcount[page] > 0, f"incref on dead page {page}"
        self.refcount[page] += 1

    def decref(self, page: int) -> bool:
        """Drop one reference; returns True iff this freed the page."""
        assert self.refcount[page] > 0, f"decref on dead page {page}"
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            for h in self._hashes_of.pop(page, ()):
                self._by_hash.pop(h, None)
            self._free.append(page)
            return True
        return False

    # -- prefix sharing ---------------------------------------------------
    def register_prefix(self, digest: bytes, page: int) -> None:
        """Publish ``page`` as holding the K/V rows of the prefix with this
        digest, so later admissions can share it.  First writer wins (the
        existing entry stays authoritative for its sharers)."""
        assert self.refcount[page] > 0
        if digest in self._by_hash:
            return
        self._by_hash[digest] = page
        self._hashes_of.setdefault(page, set()).add(digest)

    def lookup_prefix(self, digest: bytes) -> Optional[int]:
        return self._by_hash.get(digest)

    # -- compaction -------------------------------------------------------
    def compaction_perm(self) -> dict:
        """Plan a compaction: map every live physical page to a new id
        packed at the front of the pool (in increasing old-id order).
        Pure planning — ``apply_compaction`` commits it after the device
        pool has been permuted."""
        live = [p for p in range(self.num_pages) if self.refcount[p] > 0]
        return {old: new for new, old in enumerate(live)}

    def apply_compaction(self, old_to_new: dict) -> None:
        ref = np.zeros_like(self.refcount)
        for old, new in old_to_new.items():
            ref[new] = self.refcount[old]
        self.refcount = ref
        self._free = deque(range(len(old_to_new), self.num_pages))
        self._by_hash = {h: old_to_new[p] for h, p in self._by_hash.items()}
        self._hashes_of = {
            old_to_new[p]: hs for p, hs in self._hashes_of.items()
        }


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
