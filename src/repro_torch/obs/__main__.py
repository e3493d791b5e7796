"""CLI for recorded traces: ``python -m repro_torch.obs <cmd> trace.json``.

Subcommands:

* ``summarize`` — phase breakdown (span name → count/total/mean ms),
  instant-event counts per track, registry snapshot highlights, and the
  dropped-record count.  The default when you just want to know where
  the time went without opening Perfetto.
* ``validate`` — run the Chrome-trace schema check; exit 1 with the
  problem list on failure.
* ``convert`` — re-export a Chrome trace as JSONL (``--to jsonl``) or a
  Prometheus text exposition of its embedded registry snapshot
  (``--to prom``), to stdout or ``--out PATH``.
"""

from __future__ import annotations

import argparse
import collections
import sys

from repro_torch.obs.export import (
    load_trace, phase_breakdown, prometheus_text, validate_chrome_trace,
)


def _records_from_doc(doc: dict) -> list:
    """Invert ``to_chrome_trace``: Chrome events back to recorder tuples."""
    names = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            names[ev["tid"]] = ev.get("args", {}).get("name", str(ev["tid"]))
    recs = []
    for ev in doc.get("traceEvents", []):
        ph = ev.get("ph")
        if ph not in ("X", "i"):
            continue
        recs.append((ph, ev.get("name"), names.get(ev.get("tid"),
                                                   str(ev.get("tid"))),
                     ev.get("ts", 0), ev.get("dur", 0), ev.get("args")))
    return recs


def _summarize(doc: dict) -> str:
    recs = _records_from_doc(doc)
    lines = []
    meta = doc.get("metadata", {})
    n_spans = sum(1 for r in recs if r[0] == "X")
    n_inst = sum(1 for r in recs if r[0] == "i")
    lines.append(f"events: {n_spans} spans, {n_inst} instants"
                 f" (dropped: {meta.get('dropped_records', 0)})")
    phases = phase_breakdown(recs)
    if phases:
        lines.append("\nphase breakdown (spans):")
        lines.append(f"  {'name':<24} {'count':>7} {'total_ms':>10} "
                     f"{'mean_ms':>9}")
        for name, row in phases.items():
            lines.append(f"  {name:<24} {row['count']:>7} "
                         f"{row['total_ms']:>10.3f} {row['mean_ms']:>9.4f}")
    by_track = collections.Counter()
    for ph, name, track, _ts, _dur, _attrs in recs:
        if ph == "i":
            by_track[(track, name)] += 1
    if by_track:
        lines.append("\ninstant events (track/name):")
        for (track, name), n in sorted(by_track.items()):
            lines.append(f"  {track}/{name}: {n}")
    reg = meta.get("registry")
    if reg:
        lines.append("\nregistry snapshot keys: " + ", ".join(sorted(reg)))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("summarize", "validate"):
        p = sub.add_parser(name)
        p.add_argument("trace", help="Chrome trace JSON from --trace/dump")
    pc = sub.add_parser("convert")
    pc.add_argument("trace")
    pc.add_argument("--to", choices=("jsonl", "prom"), default="jsonl")
    pc.add_argument("--out", default=None, help="output path (default stdout)")
    args = ap.parse_args(argv)

    doc = load_trace(args.trace)
    if args.cmd == "validate":
        problems = validate_chrome_trace(doc)
        if problems:
            for p in problems:
                print(f"INVALID: {p}", file=sys.stderr)
            return 1
        n = sum(1 for e in doc.get("traceEvents", [])
                if e.get("ph") in ("X", "i"))
        print(f"OK: {args.trace} valid ({n} events)")
        return 0
    if args.cmd == "summarize":
        print(_summarize(doc))
        return 0
    # convert
    if args.to == "jsonl":
        from repro_torch.obs.export import to_jsonl
        text = to_jsonl(_records_from_doc(doc))
    else:
        reg = doc.get("metadata", {}).get("registry")
        if reg is None:
            print("trace has no embedded registry snapshot", file=sys.stderr)
            return 1
        text = prometheus_text(reg)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out}")
    else:
        sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
