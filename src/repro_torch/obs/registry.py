"""Unified telemetry registry: typed counters, gauges, histograms (the
reference's ``repro/obs/registry.py``, plus :meth:`TelemetryRegistry.register`).

The port's counter stores hang off one registry: ``ServeEngine.stats``,
``core/dispatch.py``'s ``_DISPATCH_COUNTS``, ``kernels/ops.py``'s route
counts ``_KERNEL_COUNTS`` and its wrappers' launch counts, and
``serve/tracecount.py``'s program builds, so one snapshot holds them all
and one :meth:`TelemetryRegistry.reset` clears them:

* **Counter** — monotonically increasing scalar (``inc``);
* **Gauge** — last-write-wins scalar (``set``);
* **Histogram** — fixed-bucket observation counts plus sum/count, enough
  for Prometheus exposition and p50-ish summaries without keeping raws;
* **CounterFamily** — a ``collections.Counter`` subclass keyed by
  tuples/strings.  ``_KERNEL_COUNTS[(kernel, path)] += 1`` call sites
  work verbatim because ``Counter.__iadd__`` on an item is
  ``__setitem__``, which is overridden to (optionally) also emit a
  flight-recorder event, so every kernel route and every program build
  shows up on the timeline.

The registry is pure stdlib with a lazy import of
``repro_torch.obs.trace`` only inside the event hook: ``core/dispatch``
and ``kernels/ops`` import this module at module scope, so it must not
pull in anything heavy or circular.

Snapshots are plain nested dicts (JSON-ready).  ``snapshot_diff`` gives
per-run deltas; :meth:`TelemetryRegistry.reset` clears contents *in
place*, so module-level references held by dispatch, ops and the engine
stay live across it.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, Iterable, Optional, Tuple, Union

__all__ = [
    "Counter", "Gauge", "Histogram", "CounterFamily", "MirroredCounters",
    "TelemetryRegistry", "REGISTRY", "snapshot_diff",
]

MetricKey = Union[str, Tuple]


def _key_str(key: MetricKey) -> str:
    if isinstance(key, tuple):
        return "/".join(_key_str(k) for k in key)
    return str(key)


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0

    def snapshot(self):
        return self.value


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def reset(self) -> None:
        self.value = 0.0

    def snapshot(self):
        return self.value


#: default histogram bucket bounds, in seconds — spans per-token decode
#: latencies (sub-ms) through prefill and full-request walls.
DEFAULT_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1, 1.0, 3.0)


class Histogram:
    """Fixed-bucket histogram with cumulative-style snapshot.

    Buckets hold non-cumulative counts internally; ``snapshot`` reports
    ``le``-labelled cumulative counts plus ``sum``/``count`` so the
    Prometheus exposition can render it directly.
    """

    __slots__ = ("name", "help", "buckets", "counts", "sum", "count")

    def __init__(self, name: str, help: str = "",
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)  # +1 for +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def reset(self) -> None:
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0

    def snapshot(self):
        cum, out = 0, {}
        for b, c in zip(self.buckets, self.counts):
            cum += c
            out[f"{b:g}"] = cum
        out["+Inf"] = cum + self.counts[-1]
        return {"buckets": out, "sum": self.sum, "count": self.count}


class CounterFamily(collections.Counter):
    """Keyed counter compatible with existing ``Counter`` call sites.

    ``fam[key] += 1`` works unchanged (it is ``__getitem__`` then
    ``__setitem__``); on *increase* the family optionally emits a
    flight-recorder instant event named ``trace_as`` on ``track`` with
    the key flattened into attrs.  Decreases and wholesale
    ``clear``/``update``/``copy`` (used by ``predict_route``'s
    snapshot/restore) never emit.
    """

    def __init__(self, *args, name: str = "", help: str = "",
                 trace_as: Optional[str] = None, track: str = "registry",
                 **kwargs):
        self.name = name
        self.help = help
        self.trace_as = trace_as
        self.track = track
        self._muted = 0
        super().__init__(*args, **kwargs)

    def __setitem__(self, key, value):
        if self.trace_as is not None and not self._muted:
            old = super().get(key, 0)
            if value > old:
                from repro_torch.obs import trace as _trace
                if _trace.enabled():
                    _trace.counter_event(
                        self.trace_as, self.track,
                        {"key": _key_str(key), "n": value - old})
        super().__setitem__(key, value)

    # Counter.copy() calls self.__class__(self); our __init__ accepts the
    # mapping positionally, but the copy should be a plain Counter so the
    # checker's snapshot/restore dance never double-emits events.
    def copy(self):
        return collections.Counter(self)

    def update(self, *args, **kwargs):
        # Bulk restore path (predict_route) — not new activity; stay silent.
        self._muted += 1
        try:
            super().update(*args, **kwargs)
        finally:
            self._muted -= 1

    def reset(self) -> None:
        self.clear()

    def snapshot(self):
        return {_key_str(k): v for k, v in self.items()}


class MirroredCounters(dict):
    """A dict of named counters (the engine's ``stats``) that mirrors
    positive deltas into a :class:`CounterFamily` so the registry snapshot
    includes engine stats without the engine changing its accounting.
    Plain-dict reads/iteration behave identically to the original."""

    def __init__(self, initial: dict, family: "CounterFamily"):
        super().__init__(initial)
        self._family = family

    def __setitem__(self, key, value):
        old = self.get(key, 0)
        if isinstance(value, (int, float)) and value > old:
            self._family[key] += value - old
        super().__setitem__(key, value)


class TelemetryRegistry:
    """Registry of named metrics with idempotent constructors.

    ``counter``/``gauge``/``histogram``/``family`` return the existing
    metric when the name is already registered (so repeated imports and
    engine re-instantiation share one instrument).  ``reset`` zeroes
    contents in place — module-level references stay valid.
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get_or_make(self, name, factory, kind):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, kind):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {kind.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_make(name, lambda: Counter(name, help), Counter)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_make(name, lambda: Gauge(name, help), Gauge)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_make(
            name, lambda: Histogram(name, help, buckets), Histogram)

    def family(self, name: str, help: str = "",
               trace_as: Optional[str] = None,
               track: str = "registry") -> CounterFamily:
        return self._get_or_make(
            name,
            lambda: CounterFamily(name=name, help=help,
                                  trace_as=trace_as, track=track),
            CounterFamily)

    def register(self, name: str, metric):
        """Register a metric object of another kind (anything with
        ``snapshot()`` and ``reset()``) under ``name``; returns the one
        already registered under that name, which must be of its type."""
        return self._get_or_make(name, lambda: metric, type(metric))

    def metrics(self) -> Dict[str, object]:
        return dict(self._metrics)

    def snapshot(self) -> dict:
        """JSON-ready nested dict of every registered metric's state."""
        return {name: m.snapshot() for name, m in sorted(self._metrics.items())}

    def reset(self) -> None:
        for m in self._metrics.values():
            m.reset()


def snapshot_diff(before: dict, after: dict) -> dict:
    """Per-run delta of two :meth:`TelemetryRegistry.snapshot` dicts.

    Scalars subtract; family dicts subtract per-key keeping non-zero
    entries; histogram snapshots subtract sum/count (bucket deltas are
    rarely useful per-run, so only the totals diff).  Metrics absent from
    ``before`` diff against zero.
    """
    out = {}
    for name, av in after.items():
        bv = before.get(name)
        if isinstance(av, dict) and "buckets" in av:
            bsum = bv["sum"] if isinstance(bv, dict) else 0.0
            bcnt = bv["count"] if isinstance(bv, dict) else 0
            d = {"sum": av["sum"] - bsum, "count": av["count"] - bcnt}
            if d["count"]:
                out[name] = d
        elif isinstance(av, dict):
            bd = bv if isinstance(bv, dict) else {}
            d = {k: v - bd.get(k, 0) for k, v in av.items()
                 if v - bd.get(k, 0)}
            if d:
                out[name] = d
        else:
            d = av - (bv if isinstance(bv, (int, float)) else 0)
            if d:
                out[name] = d
    return out


#: the process-wide registry.  dispatch/ops/engine/slo/faults all hang
#: their instruments off this instance; the conftest hygiene fixture
#: resets it between tests.
REGISTRY = TelemetryRegistry()
