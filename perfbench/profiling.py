"""The traced window: a device-only profiler session over a stretch of
the cell's own traffic, reduced to what the per-layer metrics read.

The session records device activity alone (kernels, copies, sets) and
reads the profiler's raw events, without ``key_averages()``.  Busy time
is the union of the events' intervals, not the sum of their durations,
so overlapping kernels count once.  The host marks what it is doing in
the same window (``HostMarks``: wall-clock nanoseconds, the profiler's
clock), so each idle gap on the device can be named by the host activity
around it.  The session runs last in its process: a profiler session
slows every later CUDA graph launch.
"""

from __future__ import annotations

import contextlib
import time


class HostMarks:
    """Named host intervals in the profiler's clock (``time.time_ns``);
    nested marks narrow the name."""

    def __init__(self):
        self.marks: list = []

    @contextlib.contextmanager
    def mark(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.marks.append((name, t0, time.time_ns()))

    def name_at(self, t_ns: int) -> str:
        inner = None
        for name, a, b in self.marks:
            if a <= t_ns <= b and (inner is None or b - a < inner[2] - inner[1]):
                inner = (name, a, b)
        return inner[0] if inner else "host outside any marked call"


def union_ns(intervals) -> int:
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _start_ns(e) -> int:
    return e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1e3)


def profile(torch, fn, marks: HostMarks) -> dict:
    """Run ``fn()`` under a device-only profiler session; returns the
    device events [(name, start_ns, end_ns)], the session's host window
    in seconds, and the busy seconds (union of the events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        h0 = time.time_ns()
        fn()
        torch.cuda.synchronize()
        h1 = time.time_ns()
    events = [(e.name(), _start_ns(e), _start_ns(e) + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0]
    busy = union_ns((a, b) for _, a, b in events)
    return {"events": events, "window_s": (h1 - h0) / 1e9,
            "busy_s": busy / 1e9, "host_window_ns": (h0, h1),
            "marks": marks}


def device_time_s(events, names) -> float:
    """Seconds of the events whose name contains any of ``names``."""
    return sum(b - a for n, a, b in events if any(s in n for s in names)) / 1e9


def top_ops(events, k: int = 10) -> list:
    per: dict = {}
    for n, a, b in events:
        per[n] = per.get(n, 0) + (b - a)
    top = sorted(per.items(), key=lambda kv: kv[1], reverse=True)[:k]
    return [[n[:160], ns / 1e9] for n, ns in top]


def idle_gaps(prof: dict, k: int = 10) -> list:
    """The longest idle stretches of the device inside the session, each
    named by the host activity at its middle; where the device clock does
    not fall inside the host window, by its position alone."""
    h0, h1 = prof["host_window_ns"]
    ivs = sorted((a, b) for _, a, b in prof["events"])
    gaps, end = [], h0
    for a, b in ivs:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if h1 > end:
        gaps.append((end, h1))
    aligned = bool(ivs) and h0 - 5e8 <= ivs[0][0] <= h1
    out: dict = {}
    for a, b in gaps:
        name = prof["marks"].name_at((a + b) // 2) if aligned \
            else "idle (device clock not aligned with the host's)"
        out[name] = out.get(name, 0) + (b - a)
    top = sorted(out.items(), key=lambda kv: kv[1], reverse=True)[:k]
    return [[n, ns / 1e9] for n, ns in top]
