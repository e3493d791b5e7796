"""Structured tracing core: spans, events, and the flight recorder.

The serving/training stack makes latency-critical decisions on the host —
the SLO controller switches sparsity tiers, the scheduler admits and
preempts, the tuner routes kernels — and until now none of them were
visible on a common timeline.  This module is the timeline:

* :func:`span` — a context manager that records one *complete* interval
  (Chrome ``ph: "X"`` semantics: begin timestamp + duration) on a named
  track, with arbitrary attributes;
* :func:`event` — an instantaneous marker (``ph: "i"``) for decisions
  (tier switch, watchdog trip, kernel route, fault injection);
* :func:`complete` — a retroactive span for intervals whose endpoints the
  caller already timestamped (the engine knows a request's arrival /
  admission / finish times; it emits the "queued" span at admission);
* the **flight recorder** — a bounded ring buffer (``collections.deque``
  with ``maxlen``) holding the most recent ``capacity`` records.  Memory
  is bounded by construction and the oldest records are overwritten
  first, so the recorder can stay on in production and still hold the
  last few seconds of history when something goes wrong.

Cost model: tracing is **off by default** and every recording function
checks the module-level ``_ENABLED`` flag first.  When disabled,
:func:`event` returns immediately and :func:`span` returns a shared
no-op context-manager singleton — no record, no recorder touch, no
allocation beyond the caller's own kwargs.  When enabled, a record is
one small tuple appended to a deque; timestamps come from
``time.perf_counter`` (monotonic), stored as integer microseconds
relative to the recorder epoch set by :func:`enable`.

Records are tuples ``(ph, name, track, ts_us, dur_us, attrs)`` where
``ph`` follows the Chrome trace-event phase vocabulary (``"X"`` complete
span, ``"i"`` instant) — ``repro_torch.obs.export`` turns them into
Chrome/Perfetto JSON, JSONL, or a text summary.

The postmortem hook: :func:`postmortem` dumps the recorder to a JSON
file named after the failure reason.  ``ServeEngine`` calls it when it
raises :class:`~repro_torch.serve.errors.EngineOverloadError` and the
benchmarks call it on gate failures — a perf regression then starts
from a file read instead of a rerun.
"""

from __future__ import annotations

import collections
import time
from typing import Optional

__all__ = [
    "enable", "disable", "enabled", "set_capacity",
    "span", "event", "complete", "counter_event",
    "records", "clear", "dropped", "capacity",
    "dump", "postmortem", "reset",
]

#: default flight-recorder capacity (records).  A record is a 6-tuple of
#: small scalars — ~200 bytes with its attrs dict — so the default bounds
#: the recorder around tens of MB even under pathological event rates.
DEFAULT_CAPACITY = 65536

_ENABLED = False
_EPOCH: float = 0.0          # perf_counter seconds at enable()
_CAPACITY = DEFAULT_CAPACITY
_REC: collections.deque = collections.deque(maxlen=_CAPACITY)
_TOTAL = 0                   # records ever appended (dropped = total - held)
_LAST_US = -1                # the last timestamp handed out


def enabled() -> bool:
    return _ENABLED


def enable(capacity: Optional[int] = None) -> None:
    """Turn tracing on.  Sets the recorder epoch (timestamps are relative
    to this call) when the recorder is empty; re-enabling while records
    are held keeps the original epoch, so a disable/enable cycle (e.g. an
    overhead probe toggling tracing mid-run) stays on one monotonic
    timeline.  When ``capacity`` is given, re-bounds the ring buffer
    (discarding held records)."""
    global _ENABLED, _EPOCH, _LAST_US
    if capacity is not None:
        set_capacity(capacity)
    if not _REC:
        _EPOCH = time.perf_counter()
        _LAST_US = -1
    _ENABLED = True


def disable() -> None:
    """Turn tracing off.  Held records stay readable until :func:`clear`."""
    global _ENABLED
    _ENABLED = False


def set_capacity(capacity: int) -> None:
    """Re-bound the ring buffer.  Discards held records (a resize cannot
    meaningfully preserve overwrite-oldest ordering across bounds)."""
    global _CAPACITY, _REC, _TOTAL
    _CAPACITY = max(1, int(capacity))
    _REC = collections.deque(maxlen=_CAPACITY)
    _TOTAL = 0


def capacity() -> int:
    return _CAPACITY


def reset() -> None:
    """Test hygiene: tracing off, recorder empty, default capacity."""
    global _ENABLED
    _ENABLED = False
    set_capacity(DEFAULT_CAPACITY)


def _now_us() -> int:
    """Microseconds since the epoch, one more than the last stamp where
    the clock has not moved past it: a span entered inside another then
    starts after it, so spans that nest in time nest in start order too
    (with equal starts an exporter sorting by start could put the inner
    span first)."""
    global _LAST_US
    t = int((time.perf_counter() - _EPOCH) * 1e6)
    _LAST_US = t if t > _LAST_US else _LAST_US + 1
    return _LAST_US


def _append(rec: tuple) -> None:
    global _TOTAL
    _REC.append(rec)
    _TOTAL += 1


def event(name: str, track: str = "engine", **attrs) -> None:
    """Record an instantaneous event (``ph: "i"``) on ``track``."""
    if not _ENABLED:
        return
    _append(("i", name, track, _now_us(), 0, attrs or None))


def counter_event(name: str, track: str, attrs: Optional[dict]) -> None:
    """Pre-built-attrs spelling of :func:`event` for callers (the registry
    counter families) that already hold a dict — skips the kwargs pack."""
    if not _ENABLED:
        return
    _append(("i", name, track, _now_us(), 0, attrs))


def complete(name: str, t0_s: float, t1_s: float, track: str = "engine",
             **attrs) -> None:
    """Record a retroactive complete span from absolute ``perf_counter``
    seconds (the engine's ``_t0 + relative`` timestamps)."""
    if not _ENABLED:
        return
    ts = int((t0_s - _EPOCH) * 1e6)
    _append(("X", name, track, ts,
             max(0, int((t1_s - t0_s) * 1e6)), attrs or None))


class _Span:
    """Live span: timestamps on enter, records one complete event on exit.
    Exceptions propagate; the span still records (with ``error`` set)."""

    __slots__ = ("name", "track", "attrs", "t0")

    def __init__(self, name, track, attrs):
        self.name = name
        self.track = track
        self.attrs = attrs

    def __enter__(self):
        self.t0 = _now_us()
        return self

    def __exit__(self, exc_type, exc, tb):
        attrs = self.attrs
        if exc_type is not None:
            attrs = dict(attrs or ())
            attrs["error"] = exc_type.__name__
        if _ENABLED:  # disabled mid-span: drop rather than half-record
            _append(("X", self.name, self.track, self.t0,
                     _now_us() - self.t0, attrs or None))
        return False


class _NullSpan:
    """Shared no-op context manager returned while tracing is disabled —
    the zero-allocation fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


def span(name: str, track: str = "engine", **attrs):
    """Context manager recording one complete span on ``track``.  Returns
    the shared no-op singleton when tracing is disabled."""
    if not _ENABLED:
        return _NULL_SPAN
    return _Span(name, track, attrs)


# -- recorder introspection --------------------------------------------------


def records() -> list:
    """The held records, oldest first (a copy — safe to iterate while
    recording continues)."""
    return list(_REC)


def clear() -> None:
    global _TOTAL
    _REC.clear()
    _TOTAL = 0


def dropped() -> int:
    """Records overwritten by the ring bound since the last clear."""
    return _TOTAL - len(_REC)


def dump(path: str, *, registry_snapshot: Optional[dict] = None) -> str:
    """Write the recorder as Chrome/Perfetto trace JSON (see
    ``repro_torch.obs.export``).  Returns ``path``."""
    from repro_torch.obs.export import to_chrome_trace
    from repro_torch.ioutil import atomic_write_json

    atomic_write_json(path, to_chrome_trace(
        records(), registry_snapshot=registry_snapshot, dropped=dropped()))
    return path


def postmortem(reason: str, path: Optional[str] = None) -> Optional[str]:
    """Dump the flight recorder on a failure.  No-op (returns None) when
    tracing is disabled or nothing was recorded — the hook must be safe
    to leave on every error path."""
    if not _ENABLED or not _REC:
        return None
    from repro_torch.obs.registry import REGISTRY

    safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in reason)
    return dump(path or f"obs_postmortem_{safe}.json",
                registry_snapshot=REGISTRY.snapshot())
