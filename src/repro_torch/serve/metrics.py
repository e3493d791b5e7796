"""Serving metrics: TTFT, per-token latency percentiles, throughput (port
of ``repro/serve/metrics.py``).

Aggregates the timestamps each :class:`~repro_torch.serve.queue.RequestOutput`
carries into the numbers a serving benchmark reports (p50/p99 per-token
latency, time-to-first-token, tok/s), and exports them as JSON for the
benchmark trajectory (``BENCH_serve.json``).

Overload/SLO runs additionally get outcome accounting: shed / timeout
counters, queue-delay percentiles (arrival to admission), per-tier token
counts, deadline misses, and — when the caller supplies its SLO
thresholds — the SLO-attainment fraction.  Requests that never produced
tokens (rejected / shed / timed out) stay out of the latency percentiles
but count against attainment: an answer that never came is the worst
latency of all.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional

from repro_torch.ioutil import atomic_write_json
from repro_torch.statutil import fmt as _fmt, pct as _pct  # shared nan-safe helpers

__all__ = ["ServeMetrics", "summarize"]


@dataclasses.dataclass
class ServeMetrics:
    """Summary statistics over a set of finished requests (seconds)."""

    label: str
    num_requests: int
    num_tokens: int
    num_rejected: int
    wall_time: float
    ttft_p50: float
    ttft_p99: float
    tok_latency_p50: float
    tok_latency_p99: float
    request_latency_p50: float
    throughput_tok_s: float
    # -- overload / SLO accounting (defaults keep old call sites valid) ---
    num_shed: int = 0
    num_timeout: int = 0
    num_deadline_miss: int = 0
    queue_delay_p50: float = float("nan")
    queue_delay_p99: float = float("nan")
    #: fraction of *all* outcomes that met the SLO (nan when the caller
    #: supplied no SLO thresholds)
    slo_attainment: float = float("nan")
    #: {tier name: tokens served from that tier}, when tiers were in play
    tokens_by_tier: Optional[dict] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def dump_json(self, path: str) -> None:
        atomic_write_json(path, self.to_dict())

    def report(self) -> str:
        ms = 1e3
        lines = [
            f"[{self.label}] {self.num_requests} requests, "
            f"{self.num_tokens} tokens in {self.wall_time:.2f}s | "
            f"ttft p50/p99 {_fmt(self.ttft_p50, ms)}/"
            f"{_fmt(self.ttft_p99, ms)} ms | "
            f"per-token p50/p99 {_fmt(self.tok_latency_p50, ms, 2)}/"
            f"{_fmt(self.tok_latency_p99, ms, 2)} ms | "
            f"{_fmt(self.throughput_tok_s)} tok/s",
            f"[{self.label}] outcomes: rejected {self.num_rejected}, "
            f"shed {self.num_shed}, timeout {self.num_timeout}, "
            f"deadline-miss {self.num_deadline_miss} | "
            f"queue delay p50/p99 {_fmt(self.queue_delay_p50, ms)}/"
            f"{_fmt(self.queue_delay_p99, ms)} ms",
        ]
        if not math.isnan(self.slo_attainment):
            lines.append(f"[{self.label}] SLO attainment "
                         f"{self.slo_attainment * 100:.1f}%")
        if self.tokens_by_tier:
            per_tier = ", ".join(f"{k}: {v}"
                                 for k, v in self.tokens_by_tier.items())
            lines.append(f"[{self.label}] tokens by tier: {per_tier}")
        return "\n".join(lines)


#: outcomes that never produced tokens — excluded from latency stats,
#: counted against SLO attainment
_UNSERVED = ("rejected", "shed", "timeout")


def summarize(outputs: Iterable, wall_time: float, *,
              label: str = "serve", slo_tpot_s: Optional[float] = None,
              slo_ttft_s: Optional[float] = None,
              tokens_by_tier: Optional[dict] = None) -> ServeMetrics:
    """Fold finished requests into a :class:`ServeMetrics`.

    Per-token latency is the gap between consecutive token timestamps
    within each request (the decode cadence a user of that stream sees);
    TTFT is first-token time minus arrival.  With ``slo_tpot_s`` /
    ``slo_ttft_s`` set, a served request attains the SLO when its mean
    decode gap and TTFT stay within them (whichever are set); unserved
    outcomes never attain."""
    outputs = list(outputs)
    ttfts, gaps, req_lat, qdelay = [], [], [], []
    n_tok = 0
    n_by_reason = {r: 0 for r in _UNSERVED}
    n_miss = 0
    attained = 0
    has_slo = slo_tpot_s is not None or slo_ttft_s is not None
    for o in outputs:
        if o.finish_reason in n_by_reason:
            n_by_reason[o.finish_reason] += 1
            continue  # no tokens, no timestamps — out of the latency stats
        n_tok += len(o.tokens)
        ttfts.append(o.ttft)
        req_lat.append(o.latency)
        qdelay.append(o.admitted_time - o.arrival_time)
        ts = o.token_times
        mine = [b - a for a, b in zip(ts[:-1], ts[1:])]
        gaps.extend(mine)
        deadline = getattr(o, "deadline", None)
        if deadline is not None and o.finish_time > deadline:
            n_miss += 1
        if has_slo:
            ok = True
            if slo_ttft_s is not None and not o.ttft <= slo_ttft_s:
                ok = False
            if slo_tpot_s is not None and mine and \
                    sum(mine) / len(mine) > slo_tpot_s:
                ok = False
            attained += ok
    n_unserved = sum(n_by_reason.values())
    return ServeMetrics(
        label=label,
        num_requests=len(outputs) - n_unserved,
        num_tokens=n_tok,
        num_rejected=n_by_reason["rejected"],
        wall_time=wall_time,
        ttft_p50=_pct(ttfts, 50),
        ttft_p99=_pct(ttfts, 99),
        tok_latency_p50=_pct(gaps, 50),
        tok_latency_p99=_pct(gaps, 99),
        request_latency_p50=_pct(req_lat, 50),
        # a zero/near-zero wall (no work actually ran) has no meaningful
        # rate — nan here, rendered "--" by report(), like nan-safe ttft
        throughput_tok_s=(n_tok / wall_time if wall_time > 1e-9
                          else float("nan")),
        num_shed=n_by_reason["shed"],
        num_timeout=n_by_reason["timeout"],
        num_deadline_miss=n_miss,
        queue_delay_p50=_pct(qdelay, 50),
        queue_delay_p99=_pct(qdelay, 99),
        slo_attainment=(attained / len(outputs)
                        if has_slo and outputs else float("nan")),
        tokens_by_tier=dict(tokens_by_tier) if tokens_by_tier else None,
    )
