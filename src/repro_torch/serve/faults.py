"""Deterministic, seeded fault injection for the serving engine (port of
``repro/serve/faults.py``: the schedules are the reference's, value for
value, drawn from the same ``numpy.random.default_rng(seed)``).

The SLO control loop (``serve/slo.py``) claims the engine degrades
*quality* gracefully instead of *latency* catastrophically under overload
and infrastructure misbehavior.  This module is how that claim becomes
testable: a :class:`FaultInjector` wraps host-side hooks around the
engine's decode step and admission path and injects, from a schedule
precomputed entirely from ``FaultConfig.seed``:

* **latency spikes** — a one-off sleep before a decode step (GC pause,
  noisy neighbor, page fault storm),
* **slow-decode windows** — contiguous step ranges whose decode time is
  *multiplied* by a factor (thermal throttling, a co-tenant stealing the
  core).  The injector measures the real step and sleeps the remainder,
  so a sparser weight tier — whose real step is cheaper — proportionally
  shrinks the injected slowdown too, exactly like real throttling would,
* **transient errors** — :class:`InjectedFaultError` raised before the
  decode runs; the engine retries with capped exponential backoff.  The
  schedule bounds consecutive failures below the engine's retry cap, so
  injected faults are always recoverable (a genuine outage is modelled by
  raising the cap breach, which the engine propagates),
* **admission delays** — fixed extra latency on the prefill path.

Everything is derived from the seed up front (``horizon`` steps, reused
modulo beyond it), so two runs with the same seed see byte-identical
fault schedules regardless of wall-clock timing — the property the
fault-storm tests lean on.  All hooks are host-side, before and after a
decode program runs (a replayed CUDA graph on the card): no injected
fault can alter the program or its static inputs, which is why faulted
token streams stay bitwise-identical to fault-free runs at the same
weight tier.

:func:`burst_arrivals` builds the bursty arrival-time traces (background
Poisson plus co-arriving bursts) the overload runs and tests share.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.obs import trace as obs
from repro_torch.obs.registry import REGISTRY, MirroredCounters
from repro_torch.serve.errors import InjectedFaultError

__all__ = ["FaultConfig", "FaultInjector", "InjectedFaultError",
           "burst_arrivals"]


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Seeded fault-schedule parameters (all probabilities per decode
    step; an all-zeros config injects nothing)."""

    seed: int = 0
    #: precomputed schedule length; steps beyond it reuse the schedule
    #: modulo ``horizon`` (keeps long runs faulting, stays deterministic)
    horizon: int = 2048
    #: P(latency spike before a decode step) and its [lo, hi) seconds
    spike_prob: float = 0.0
    spike_s: tuple = (0.005, 0.02)
    #: ((start_step, stop_step, factor), ...) — decode steps in
    #: [start, stop) have their measured duration multiplied by ``factor``
    #: (the injector sleeps the remainder after the real step)
    slow_windows: tuple = ()
    #: P(transient error burst at a decode step) and the max consecutive
    #: raises per burst (drawn uniformly in [1, max]); keep the max below
    #: the engine's ``max_retries`` so injected faults stay recoverable
    error_prob: float = 0.0
    max_consecutive_errors: int = 2
    #: fixed extra seconds injected on every admission (prefill) path
    admission_delay_s: float = 0.0
    # -- retry policy the *engine* applies to transient errors ------------
    max_retries: int = 4
    backoff_s: float = 0.001
    backoff_cap_s: float = 0.02


class FaultInjector:
    """Host-side fault hooks with a fully seeded schedule.

    The engine calls :meth:`pre_decode` (possibly repeatedly, under its
    retry loop) before each decode step and :meth:`post_decode` after it
    with the measured duration; :meth:`admission_delay` rides the prefill
    path.  ``sleep`` is injectable so virtual-clock tests can advance a
    fake clock instead of blocking the process.
    """

    def __init__(self, cfg: FaultConfig = FaultConfig(), *,
                 sleep: Callable[[float], None] = time.sleep):
        self.cfg = cfg
        self.sleep = sleep
        rng = np.random.default_rng(cfg.seed)
        h = max(1, int(cfg.horizon))
        spikes = rng.random(h) < cfg.spike_prob
        self._spike_s = np.where(
            spikes, rng.uniform(cfg.spike_s[0], cfg.spike_s[1], h), 0.0
        )
        errs = rng.random(h) < cfg.error_prob
        self._errors = np.where(
            errs, rng.integers(1, max(1, cfg.max_consecutive_errors) + 1,
                               size=h), 0
        ).astype(np.int64)
        # per-step retry bookkeeping (reset when the engine moves on)
        self._err_step: Optional[int] = None
        self._errs_left = 0
        self._spiked_step: Optional[int] = None
        #: what actually fired, for reports/tests — a plain dict to read,
        #: mirrored into the telemetry registry (and, with the flight
        #: recorder on, each injection below lands on the "faults" track)
        self.injected = MirroredCounters(
            {"spikes": 0, "spike_s": 0.0, "errors": 0,
             "slow_steps": 0, "slow_s": 0.0, "admission_delays": 0},
            REGISTRY.family("faults", help="injected faults, by kind"))

    # -- schedule introspection (deterministic, pure) ---------------------
    def spike_at(self, step: int) -> float:
        return float(self._spike_s[step % len(self._spike_s)])

    def errors_at(self, step: int) -> int:
        return int(self._errors[step % len(self._errors)])

    def slow_factor(self, step: int) -> float:
        for start, stop, factor in self.cfg.slow_windows:
            if start <= step < stop:
                return float(factor)
        return 1.0

    # -- engine hooks -----------------------------------------------------
    def pre_decode(self, step: int) -> None:
        """Fault gate before decode step ``step``.  Raises
        :class:`InjectedFaultError` while the step's scheduled error burst
        has raises left (the engine retries); once clear, injects the
        step's latency spike (exactly once) and returns."""
        if self._err_step != step:
            self._err_step = step
            self._errs_left = self.errors_at(step)
        if self._errs_left > 0:
            self._errs_left -= 1
            self.injected["errors"] += 1
            obs.event("injected_error", "faults", step=step,
                      remaining=self._errs_left)
            raise InjectedFaultError(f"injected transient fault at decode "
                                     f"step {step}")
        if self._spiked_step != step:
            self._spiked_step = step
            s = self.spike_at(step)
            if s > 0:
                self.injected["spikes"] += 1
                self.injected["spike_s"] += s
                obs.event("latency_spike", "faults", step=step,
                          seconds=round(s, 6))
                self.sleep(s)

    def post_decode(self, step: int, measured_s: float) -> None:
        """Apply the slow-window multiplier: the real step took
        ``measured_s``; sleep the remainder up to ``factor * measured_s``."""
        factor = self.slow_factor(step)
        if factor > 1.0 and measured_s > 0:
            extra = (factor - 1.0) * measured_s
            self.injected["slow_steps"] += 1
            self.injected["slow_s"] += extra
            obs.event("slow_window", "faults", step=step, factor=factor,
                      extra_s=round(extra, 6))
            self.sleep(extra)

    def admission_delay(self) -> None:
        if self.cfg.admission_delay_s > 0:
            self.injected["admission_delays"] += 1
            obs.event("admission_delay", "faults",
                      seconds=self.cfg.admission_delay_s)
            self.sleep(self.cfg.admission_delay_s)


def burst_arrivals(*, n_background: int, rate_hz: float,
                   bursts: Sequence[tuple] = (), seed: int = 0) -> list:
    """Arrival times for a bursty overload trace: ``n_background``
    Poisson arrivals at ``rate_hz`` plus, for each ``(t, size)`` in
    ``bursts``, ``size`` co-arriving requests at time ``t`` (a thundering
    herd).  Returns sorted floats; fully determined by ``seed``."""
    rng = np.random.default_rng(seed)
    times = list(np.cumsum(rng.exponential(1.0 / rate_hz, n_background)))
    for t, size in bursts:
        times.extend([float(t)] * int(size))
    return sorted(float(t) for t in times)
