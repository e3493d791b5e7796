"""SLO-aware serving control loop: sparsity tiers, hysteresis ladder
(port of ``repro/serve/slo.py``).

STen's thesis is that sparsity is a *pipeline* — layouts, operators and
sparsifiers composed freely — and the serving consequence is that
"how sparse are the weights" becomes a **runtime degradation axis**: the
same engine can trade a little accuracy for a lot of latency headroom by
swapping to a sparser pre-converted copy of its weights.

* :class:`TierSpec` / :func:`build_tiers` — parse ``"dense"`` /
  ``"2:4"`` / ``"1:4:8-gr64"`` tier specs and pre-convert the model once
  per tier (through the ordinary
  :func:`~repro_torch.serve.engine.sparsify_for_serving` builder
  pipeline, the FFN only).  Every tier stays resident.  The reference's
  switch is a pytree pointer swap into an already-compiled program; a
  CUDA graph holds the addresses of the params it captured, so the
  port's engine keeps one set of programs per tier (decode chunks,
  single step, one admission per prompt length), all captured by
  ``ServeEngine.warm_tiers``, and a switch only changes which set
  replays.
* :class:`LatencyModel` — admission-time cost prediction from the active
  :class:`~repro_torch.tune.table.TuningTable` (per-weight shape-bucket
  latency lookups via :func:`repro_torch.tune.routing.matmul_latency_us`),
  refined online by EWMA over observed decode/prefill times.
* :class:`CadenceWatchdog` — the ``StragglerWatchdog`` leave-one-out
  median idiom from ``dist/elastic.py`` applied to *time*: windows of
  consecutive per-token decode times play the role of hosts, and the
  latest window is flagged when its median exceeds the median of the
  other retained windows by ``ratio`` — persistent cadence collapse,
  not one-token jitter.
* :class:`SLOController` — a dwell-time hysteresis state machine over
  the degradation ladder: (0) steady, (1) defer admissions + shrink the
  decode chunk, (2) drop to a sparser weight tier, (3) shed the
  lowest-priority queued requests (and only when there is a queue worth
  shedding).  Escalation needs ``escalate_dwell`` consecutive hot
  steps, de-escalation ``deescalate_dwell`` consecutive cool steps, and
  the band between the two thresholds holds the current level — so the
  controller cannot flap tiers on noise.

The controller is pure host-side Python consulted by ``ServeEngine``
between decode calls; nothing here touches a device program.
"""

from __future__ import annotations

import dataclasses
import statistics
from collections import deque
from typing import Optional, Sequence

from repro_torch.obs import trace as obs
from repro_torch.obs.registry import REGISTRY, MirroredCounters
from repro_torch.tune import routing
from repro_torch.tune.table import bucket

__all__ = ["TierSpec", "Tier", "build_tiers", "CadenceWatchdog",
           "SLOConfig", "LatencyModel", "SLOController"]


# ---------------------------------------------------------------------------
# sparsity tiers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One rung of the weight-sparsity ladder.

    ``fmt`` is the ``(n, m, g)`` GroupedNM format (None = dense), ``gr``
    the row-sharing width.  Specs are ordered densest-first by the caller:
    tier 0 is what the engine serves when healthy."""

    name: str
    fmt: Optional[tuple] = None
    gr: int = 64

    @classmethod
    def parse(cls, spec: str) -> "TierSpec":
        """``"dense"`` | ``"n:m"`` | ``"n:m:g"``, optionally suffixed
        ``"-grNN"`` (row-sharing width, default 64).  ``g`` defaults to
        ``m`` (plain n:m, no intra-group permutation freedom)."""
        spec = spec.strip()
        if spec.lower() == "dense":
            return cls(name="dense")
        body, gr = spec, 64
        if "-gr" in spec:
            body, gr_s = spec.rsplit("-gr", 1)
            gr = int(gr_s)
        parts = [int(p) for p in body.split(":")]
        if len(parts) == 2:
            n, m = parts
            g = m
        elif len(parts) == 3:
            n, m, g = parts
        else:
            raise ValueError(f"unparseable tier spec {spec!r} "
                             f"(want 'dense', 'n:m' or 'n:m:g[-grNN]')")
        if not (1 <= n < m and g >= m):
            raise ValueError(f"tier spec {spec!r}: need 1 <= n < m <= g")
        return cls(name=f"{n}:{m}:{g}-gr{gr}", fmt=(n, m, g), gr=gr)

    @property
    def density(self) -> float:
        return 1.0 if self.fmt is None else self.fmt[0] / self.fmt[1]


@dataclasses.dataclass(frozen=True)
class Tier:
    """A resident weight copy: its spec plus the pre-converted params."""

    spec: TierSpec
    params: object


def build_tiers(params, specs: Sequence) -> list:
    """Pre-convert ``params`` once per spec (strings are parsed; the FFN
    only, as the reference's).  This is the warm-up cost that buys
    build-free tier switches: every tier stays resident with its own
    programs, so the controller's switch only picks which of the
    already-captured programs replay.  A :class:`Tier` is kept as given
    (another engine's converted copy, shared rather than converted
    again)."""
    from repro_torch.serve.engine import sparsify_for_serving  # no cycle

    specs = [TierSpec.parse(s) if isinstance(s, str) else s for s in specs]
    if not specs:
        raise ValueError("at least one tier is required")
    names = [s.spec.name if isinstance(s, Tier) else s.name for s in specs]
    if len(set(names)) != len(specs):
        raise ValueError("duplicate tier specs")
    tiers = []
    for spec in specs:
        if isinstance(spec, Tier):
            tiers.append(spec)
        elif spec.fmt is None:
            tiers.append(Tier(spec=spec, params=params))
        else:
            n, m, g = spec.fmt
            tiers.append(Tier(spec=spec, params=sparsify_for_serving(
                params, n, m, g, gr=spec.gr)))
    return tiers


# ---------------------------------------------------------------------------
# decode-cadence watchdog
# ---------------------------------------------------------------------------


class CadenceWatchdog:
    """Persistent decode-slowdown detector over per-token decode times.

    The :class:`~repro_torch.dist.elastic.StragglerWatchdog` idiom transplanted
    from space to time: instead of per-host step-time medians compared
    leave-one-out across the fleet, windows of ``window`` consecutive
    per-token decode times are the "hosts", and :meth:`slow` flags the
    *latest* completed window when its median exceeds the median of the
    other retained windows by more than ``ratio`` — a sustained cadence
    collapse relative to this engine's own recent history, immune to
    single-token jitter (medians within windows) and to slow drift
    (the reference window set slides).  Silent until ``min_windows``
    windows completed, so warm-up stalls cannot trip it."""

    def __init__(self, *, window: int = 8, n_windows: int = 8,
                 min_windows: int = 4, ratio: float = 2.0):
        if not (window >= 1 and n_windows >= 2 and min_windows >= 2):
            raise ValueError("CadenceWatchdog needs window >= 1, "
                             "n_windows >= 2 and min_windows >= 2")
        self.window = window
        self.min_windows = min_windows
        self.ratio = ratio
        self._cur: list = []
        self._meds: deque = deque(maxlen=n_windows)

    def observe(self, dt_s: float) -> None:
        """Record one per-token decode time."""
        self._cur.append(float(dt_s))
        if len(self._cur) >= self.window:
            self._meds.append(statistics.median(self._cur))
            self._cur = []

    def recent(self) -> float:
        """Median of the latest completed window (nan before the first)."""
        return self._meds[-1] if self._meds else float("nan")

    def slow(self) -> bool:
        if len(self._meds) < self.min_windows:
            return False
        latest = self._meds[-1]
        ref = statistics.median(list(self._meds)[:-1])
        return latest > self.ratio * ref


# ---------------------------------------------------------------------------
# latency prediction
# ---------------------------------------------------------------------------


class LatencyModel:
    """Admission-time latency prediction, table-seeded and EWMA-refined.

    Before the first decode step runs, predictions come from the active
    :class:`~repro_torch.tune.table.TuningTable`: the model walks ``params`` for
    :class:`~repro_torch.core.layouts.GroupedNMTensor` leaves at construction
    (stacked ``layers`` leaves count ``cfg.n_layers`` times) and
    sums each weight's measured per-matmul latency at the requested width
    (:func:`repro_torch.tune.routing.matmul_latency_us`, recorded by
    ``tune_decode_threshold`` from the same sweep that sets the
    gemv/spmm crossover).  That sum covers only the routed sparse
    matmuls — a floor, not the full step — so once the engine is serving,
    EWMA over *observed* step/prefill times takes over and the table is
    only the cold-start seed."""

    def __init__(self, params, cfg, *, max_slots: int, alpha: float = 0.25):
        from repro_torch.core.layouts import GroupedNMTensor
        from repro_torch.kernels import ops as kops

        self.max_slots = int(max_slots)
        self.alpha = float(alpha)
        dt = cfg.tdtype
        n_layers = int(getattr(cfg, "n_layers", 1))
        self._weights: list = []   # (route ctx, multiplicity)

        def walk(tree, path):
            # the reference's leaf order: a pytree walks dict keys sorted
            if isinstance(tree, dict):
                for k in sorted(tree):
                    walk(tree[k], f"{path}['{k}']")
            elif isinstance(tree, GroupedNMTensor):
                mult = n_layers if "layers" in path else 1
                self._weights.append((kops._route_ctx(tree, dt), mult))

        walk(params, "")
        self._step_ewma: Optional[float] = None
        self._prefill_ewma: dict = {}   # bucket(plen) -> seconds

    # -- table-seeded prediction ------------------------------------------
    def table_step_s(self, M: int) -> Optional[float]:
        """Summed measured latency (seconds) of every routed sparse matmul
        at width ``M``, or None when the active table lacks any of the
        needed buckets (dense params have no routed matmuls: None too)."""
        if not self._weights:
            return None
        total_us = 0.0
        for ctx, mult in self._weights:
            us, _src = routing.matmul_latency_us(M=M, **ctx)
            if us is None:
                return None
            total_us += us * mult
        return total_us * 1e-6

    # -- online refinement -------------------------------------------------
    def _ewma(self, old: Optional[float], x: float) -> float:
        return x if old is None else (1 - self.alpha) * old + self.alpha * x

    def observe_step(self, dt_s: float, n_steps: int = 1) -> None:
        """Record a decode call that advanced every stream ``n_steps``
        tokens in ``dt_s`` seconds (per-step time is the stream TPOT:
        the batch is static, one token per stream per step)."""
        if n_steps > 0 and dt_s >= 0:
            self._step_ewma = self._ewma(self._step_ewma, dt_s / n_steps)

    def observe_prefill(self, plen: int, dt_s: float) -> None:
        b = bucket(plen)
        self._prefill_ewma[b] = self._ewma(self._prefill_ewma.get(b), dt_s)

    # -- estimates ---------------------------------------------------------
    def tpot_s(self) -> float:
        """Current per-token decode-time estimate: observed EWMA, else the
        table prediction at the engine's decode width, else nan."""
        if self._step_ewma is not None:
            return self._step_ewma
        t = self.table_step_s(self.max_slots)
        return float("nan") if t is None else t

    def prefill_s(self, plen: int) -> float:
        hit = self._prefill_ewma.get(bucket(plen))
        if hit is not None:
            return hit
        t = self.table_step_s(plen)
        return float("nan") if t is None else t

    def request_s(self, plen: int, gen_len: int) -> float:
        """Admission-to-finish estimate for a request: prefill plus
        ``gen_len`` decode steps (nan when nothing is known yet — the
        engine then admits rather than guessing)."""
        return self.prefill_s(plen) + gen_len * self.tpot_s()


# ---------------------------------------------------------------------------
# the hysteresis controller
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Service-level objective plus the control loop's hysteresis knobs.

    The controller compares its TPOT estimate against
    ``escalate_frac * tpot_ms`` (hot) and ``deescalate_frac * tpot_ms``
    (cool); the band between holds the current level.  ``*_dwell`` are
    consecutive-step counts a signal must persist before the level moves,
    with de-escalation deliberately much slower than escalation so a
    recovering engine does not oscillate back into overload."""

    tpot_ms: float = 50.0
    ttft_ms: Optional[float] = None
    escalate_frac: float = 0.9
    deescalate_frac: float = 0.6
    escalate_dwell: int = 2
    deescalate_dwell: int = 12
    #: level >= 1 shrinks the decode chunk by this divisor (shorter chunks
    #: = more frequent admission/control points, bounded chunk tail latency)
    chunk_shrink: int = 2
    #: shedding keeps at most this many queued requests per slot...
    queue_keep_per_slot: float = 2.0
    #: ...and a queue deeper than this many per slot is itself a hot signal
    queue_high_per_slot: float = 4.0
    # cadence-watchdog knobs (see CadenceWatchdog)
    watchdog_window: int = 8
    watchdog_n_windows: int = 8
    watchdog_min_windows: int = 4
    watchdog_ratio: float = 2.0


class SLOController:
    """Dwell-time hysteresis over the degradation ladder.

    Levels: 0 steady · 1 defer admissions + shrink decode chunk · 2 drop
    to a sparser weight tier · 3 shed lowest-priority queued requests.
    The engine consults :meth:`begin_step` once per scheduler iteration
    and reads the level back through :attr:`tier_index`,
    :meth:`admission_budget`, :meth:`decode_chunk`, :meth:`should_shed`.
    """

    def __init__(self, cfg: SLOConfig, *, n_tiers: int, max_slots: int,
                 latency: Optional[LatencyModel] = None):
        self.cfg = cfg
        self.n_tiers = max(1, int(n_tiers))
        self.max_slots = int(max_slots)
        self.latency = latency
        self.watchdog = CadenceWatchdog(
            window=cfg.watchdog_window, n_windows=cfg.watchdog_n_windows,
            min_windows=cfg.watchdog_min_windows, ratio=cfg.watchdog_ratio)
        self.level = 0
        self._hot = 0
        self._cool = 0
        #: why the controller last moved the ladder — the engine forwards
        #: this as the tier-switch reason attribute on the timeline
        self.last_reason = "steady"
        self.counters = MirroredCounters(
            {"escalations": 0, "deescalations": 0,
             "hot_steps": 0, "watchdog_trips": 0},
            REGISTRY.family("slo", help="SLO controller decisions"))

    # -- thresholds --------------------------------------------------------
    def shed_keep(self) -> int:
        return max(1, int(self.cfg.queue_keep_per_slot * self.max_slots))

    def queue_high(self) -> int:
        return max(1, int(self.cfg.queue_high_per_slot * self.max_slots))

    # -- signals in, level out --------------------------------------------
    def observe_decode(self, dt_s: float, n_steps: int) -> None:
        """Feed one decode call (``n_steps`` tokens per stream in
        ``dt_s``) into the watchdog and the latency model."""
        if n_steps <= 0:
            return
        per_tok = dt_s / n_steps
        for _ in range(n_steps):
            self.watchdog.observe(per_tok)
        if self.latency is not None:
            self.latency.observe_step(dt_s, n_steps)

    def begin_step(self, now: float, queue_depth: int) -> int:
        """Advance the hysteresis state machine; returns the level.

        Hot = TPOT estimate above ``escalate_frac`` of the SLO, or the
        cadence watchdog tripping, or the queue past ``queue_high``.
        Cool = TPOT comfortably below ``deescalate_frac`` of the SLO (or
        unknown), watchdog quiet, queue drained to the keep level.
        Anything between holds the level (the hysteresis band).
        Escalating into shedding (level 3) additionally requires a queue
        deeper than the keep target — shedding an empty queue buys
        nothing."""
        tpot = self.latency.tpot_s() if self.latency is not None \
            else float("nan")
        slo_s = self.cfg.tpot_ms * 1e-3
        wd = self.watchdog.slow()
        if wd:
            self.counters["watchdog_trips"] += 1
            obs.event("watchdog_trip", "controller", level=self.level,
                      queue_depth=queue_depth)
        hot = (wd or queue_depth > self.queue_high()
               or (tpot == tpot and tpot > self.cfg.escalate_frac * slo_s))
        cool = ((tpot != tpot or tpot < self.cfg.deescalate_frac * slo_s)
                and not wd and queue_depth <= self.shed_keep())
        if hot:
            self.counters["hot_steps"] += 1
            self._hot += 1
            self._cool = 0
            if self._hot >= self.cfg.escalate_dwell and self.level < 3:
                if self.level < 2 or queue_depth > self.shed_keep():
                    self.level += 1
                    self._hot = 0
                    self.counters["escalations"] += 1
                    # which hot signal drove the move, most-specific first
                    self.last_reason = (
                        "watchdog" if wd
                        else "queue_depth" if queue_depth > self.queue_high()
                        else "tpot")
                    obs.event("escalate", "controller",
                              level_from=self.level - 1, level_to=self.level,
                              reason=self.last_reason,
                              queue_depth=queue_depth,
                              tpot_ms=(round(tpot * 1e3, 3)
                                       if tpot == tpot else None))
        elif cool:
            self._cool += 1
            self._hot = 0
            if self._cool >= self.cfg.deescalate_dwell and self.level > 0:
                self.level -= 1
                self._cool = 0
                self.counters["deescalations"] += 1
                self.last_reason = "recovered"
                obs.event("deescalate", "controller",
                          level_from=self.level + 1, level_to=self.level,
                          reason="recovered", queue_depth=queue_depth)
        else:
            self._hot = 0
            self._cool = 0
        return self.level

    # -- what the engine does about it ------------------------------------
    @property
    def tier_index(self) -> int:
        """Which resident weight tier to serve from: tier 0 below level 2,
        one rung sparser per level past that (clamped to the ladder)."""
        if self.level < 2:
            return 0
        return min(self.level - 1, self.n_tiers - 1)

    def admission_budget(self, free_slots: int) -> int:
        """Max admissions this step: all free slots when steady, one per
        step once deferring — admission prefills are the stall the
        degraded engine is rationing."""
        return free_slots if self.level == 0 else min(free_slots, 1)

    def decode_chunk(self, base: int) -> int:
        return base if self.level == 0 else \
            max(1, base // max(1, self.cfg.chunk_shrink))

    def should_shed(self, queue_depth: int) -> bool:
        return self.level >= 3 and queue_depth > self.shed_keep()
