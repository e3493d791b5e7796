"""Exporters for the flight recorder: Chrome/Perfetto, JSONL, Prometheus.

The recorder (``repro_torch.obs.trace``) holds tuples
``(ph, name, track, ts_us, dur_us, attrs)``.  This module turns them
into things tools understand:

* :func:`to_chrome_trace` — the Chrome ``trace_event`` JSON format
  (https://ui.perfetto.dev loads it directly).  Each recorder *track*
  becomes a thread row (``tid``) under one process (``pid=1``), named by
  a ``ph: "M"`` ``thread_name`` metadata event, so the timeline reads:
  one row per request (``req:<uid>``), one engine row, one controller
  row, one faults row, one kernel row, one train row.
* :func:`to_jsonl` — one JSON object per line, for grep/jq pipelines.
* :func:`prometheus_text` — text exposition of a registry snapshot.
* :func:`phase_breakdown` — span-name aggregation (count/total/mean ms),
  the "where did the time go" summary of a run.
* :func:`validate_chrome_trace` — the schema check: required fields on
  every event, and ``"X"`` spans on
  a given row must nest (disjoint or contained, never partially
  overlapping).
"""

from __future__ import annotations

import json
from typing import List, Optional

__all__ = [
    "to_chrome_trace", "to_jsonl", "prometheus_text",
    "phase_breakdown", "validate_chrome_trace", "load_trace",
]

#: stable row order for the well-known tracks; request rows (and any
#: other dynamic tracks) follow in first-appearance order.
_CANON_TRACKS = ("engine", "controller", "faults", "kernel", "train",
                 "registry")


def _tid_map(records) -> dict:
    tids = {}
    for t in _CANON_TRACKS:
        tids[t] = len(tids) + 1
    for rec in records:
        track = rec[2]
        if track not in tids:
            tids[track] = len(tids) + 1
    return tids


def to_chrome_trace(records, *, registry_snapshot: Optional[dict] = None,
                    dropped: int = 0) -> dict:
    """Render recorder tuples as a Chrome ``trace_event`` JSON document."""
    tids = _tid_map(records)
    events: List[dict] = []
    for track, tid in tids.items():
        events.append({"ph": "M", "ts": 0, "pid": 1, "tid": tid,
                       "name": "thread_name", "args": {"name": track}})
    for ph, name, track, ts, dur, attrs in records:
        ev = {"ph": ph, "ts": ts, "pid": 1, "tid": tids[track],
              "name": name}
        if ph == "X":
            ev["dur"] = dur
        elif ph == "i":
            ev["s"] = "t"  # thread-scoped instant
        if attrs:
            ev["args"] = dict(attrs)
        events.append(ev)
    meta = {"tool": "repro_torch.obs", "dropped_records": dropped}
    if registry_snapshot is not None:
        meta["registry"] = registry_snapshot
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "metadata": meta}


def to_jsonl(records) -> str:
    """One JSON object per recorder tuple, oldest first."""
    lines = []
    for ph, name, track, ts, dur, attrs in records:
        obj = {"ph": ph, "name": name, "track": track, "ts_us": ts}
        if ph == "X":
            obj["dur_us"] = dur
        if attrs:
            obj["attrs"] = dict(attrs)
        lines.append(json.dumps(obj, sort_keys=True))
    return "\n".join(lines) + ("\n" if lines else "")


def _prom_name(s: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in s)


def _prom_label(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def prometheus_text(snapshot: dict, prefix: str = "repro") -> str:
    """Text exposition of a ``TelemetryRegistry.snapshot()`` dict.

    Scalars become untyped samples; family dicts become one sample per
    key under a ``key`` label; histogram snapshots expand into
    ``_bucket{le=...}`` / ``_sum`` / ``_count`` series.
    """
    out: List[str] = []
    for name, val in sorted(snapshot.items()):
        metric = f"{prefix}_{_prom_name(name)}"
        if isinstance(val, dict) and "buckets" in val:
            out.append(f"# TYPE {metric} histogram")
            for le, c in val["buckets"].items():
                out.append(f'{metric}_bucket{{le="{_prom_label(le)}"}} {c}')
            out.append(f"{metric}_sum {val['sum']}")
            out.append(f"{metric}_count {val['count']}")
        elif isinstance(val, dict):
            out.append(f"# TYPE {metric} counter")
            for k, v in sorted(val.items()):
                out.append(f'{metric}{{key="{_prom_label(k)}"}} {v}')
        else:
            out.append(f"# TYPE {metric} gauge")
            out.append(f"{metric} {val}")
    return "\n".join(out) + ("\n" if out else "")


def phase_breakdown(records) -> dict:
    """Aggregate ``"X"`` spans by name: count, total ms, mean ms.

    This is the "where did the time go" summary: prefill vs decode_chunk
    vs queued, per span name, sorted by total descending.
    """
    agg = {}
    for ph, name, _track, _ts, dur, _attrs in records:
        if ph != "X":
            continue
        c, t = agg.get(name, (0, 0))
        agg[name] = (c + 1, t + dur)
    out = {}
    for name, (c, t_us) in sorted(agg.items(), key=lambda kv: -kv[1][1]):
        out[name] = {"count": c, "total_ms": round(t_us / 1e3, 3),
                     "mean_ms": round(t_us / 1e3 / c, 4)}
    return out


def load_trace(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def validate_chrome_trace(doc: dict) -> List[str]:
    """Schema-check a Chrome trace document.  Returns a list of problem
    strings — empty means valid.  Checks: top-level shape, required
    fields per event (``ph/ts/pid/tid/name``, ``dur`` on ``"X"``), and
    proper nesting of ``"X"`` spans within each ``tid`` (two spans on one
    row must be disjoint or one must contain the other)."""
    problems: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    spans_by_tid = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event[{i}] not an object")
            continue
        for field in ("ph", "ts", "pid", "tid", "name"):
            if field not in ev:
                problems.append(f"event[{i}] ({ev.get('name')!r}) missing "
                                f"required field {field!r}")
        ph = ev.get("ph")
        if ph == "X":
            if not isinstance(ev.get("dur"), int) or ev["dur"] < 0:
                problems.append(
                    f"event[{i}] ({ev.get('name')!r}) X-span without "
                    "non-negative integer dur")
            else:
                spans_by_tid.setdefault(ev.get("tid"), []).append(
                    (ev["ts"], ev["ts"] + ev["dur"], ev.get("name")))
        elif ph not in ("i", "I", "M", "C", "B", "E"):
            problems.append(f"event[{i}] unknown phase {ph!r}")
    for tid, spans in spans_by_tid.items():
        spans.sort()
        stack = []  # (start, end, name) of open enclosing spans
        for s, e, name in spans:
            while stack and s >= stack[-1][1]:
                stack.pop()
            if stack and e > stack[-1][1]:
                problems.append(
                    f"tid {tid}: span {name!r} [{s},{e}] partially overlaps "
                    f"{stack[-1][2]!r} [{stack[-1][0]},{stack[-1][1]}]")
            stack.append((s, e, name))
    return problems
